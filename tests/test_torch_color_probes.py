"""The port's colour probes (point_slam_tpu_torch/profiling/color_*.py) and
their shared setup (workload.densified_frame0) against the same loops
built here from the JAX package's functions, as profiling/color_*.py
build them, on the host at 48x64.

Both packages start from the same decoders (the JAX ones carried over by
interop) and densify frame 0 with the same candidate pixels and
new-point features (JAX's key draws replayed into the port); every step
draws its pixels (and a render's random fill) from the scripts' key
sequence, and the port is handed the same draws.

Tolerances: the densified cloud and its cell table's coordinates 1e-6 (a
position is one multiply-add), its ids and counts exact; the first loss
1e-4 relative and the loss after 5 Adam steps 2e-3 relative
(tests/test_torch_mapper.py's: decoder Fourier phases, see
test_torch_decoders.py, and sums taken in another order); color_debug's
gradient sums 2e-3 relative; color_blowup's norms before mapping 1e-6
relative, after map_frame(0) at 6 iterations 1e-3 relative (the two
packages draw the mapping rays from their own generators; an Adam step
moves a weight by at most its learning rate, 1e-3 for the decoders, so
the draws' effect on these norms is far below that)."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu import mapper as JM
from point_slam_tpu import pointcloud as jpc
from point_slam_tpu import renderer as JR
from point_slam_tpu.common import camera as jcam
from point_slam_tpu.common import sampling as jsamp
from point_slam_tpu.config import load_config as jload
from point_slam_tpu.datasets import get_dataset
from point_slam_tpu.models import decoders as JD
from point_slam_tpu.ops import adam as jadam
from point_slam_tpu.ops import knn as jk
from point_slam_tpu_torch import interop
from point_slam_tpu_torch.profiling import (
    color_ablate, color_blowup, color_converge, color_debug, color_direct,
    color_train_iso, workload as W)

from torch_parity import CONFIGS, jax_decoders, jax_fill, n, t, to_numpy

H, WD, N_ADD_RAYS, N_PIX, STEPS = 48, 64, 400, 200, 5
CPU = torch.device("cpu")


def jax_color_config():
    """workload.color_config(small=True) for the JAX package."""
    cfg = jload(os.path.join(CONFIGS, "Synthetic", "room.yaml"),
                os.path.join(CONFIGS, "point_slam.yaml"))
    cfg["synthetic"].update({"n_frames": 2, "angular_step": 0.01})
    cfg["cam"].update({"H": H, "W": WD, "fx": 40.0, "fy": 40.0, "cx": 31.5,
                       "cy": 23.5})
    cfg["mapping"].update({"pixels": N_PIX, "pixels_adding": N_ADD_RAYS})
    cfg["tpu"].update({"point_capacity_init": 1 << 13,
                       "grid_table_size": 1 << 14})
    cfg["rendering"]["sample_near_pcl"] = False
    cfg["verbose"] = False
    return cfg


class Jax:
    """The JAX scripts' setup at 48x64: the mapper, frame 0, one
    densification (keys 1 and 2) and the f32 cell table."""

    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params
        self.m = JM.Mapper(cfg, params, 10, np.random.default_rng(0))
        _, color, depth, c2w = get_dataset(cfg)[0]
        self.cd, self.dd, self.cw = (jnp.asarray(a) for a in (color, depth,
                                                              c2w))
        r_add, self.rq, _, _ = self.m.radius_maps(self.cd)
        o, d, dep, col, ra, valid = JM.sample_add_rays(
            self.m.ms, jax.random.key(1), self.cw, self.cd, self.dd, r_add,
            jnp.asarray(N_ADD_RAYS))
        self.m.cloud, _ = jpc.add_points(self.m.cloud, self.m.index, o, d,
                                         dep, col, valid, ra,
                                         jax.random.key(2), 0.98, 1.02)
        self.m.index = jpc.build_index(self.m.cloud, self.m.cell_size,
                                       self.m.table_size,
                                       self.m.max_per_cell)

    def batch(self, k):
        i, j = jsamp.sample_pixels_uniform(k, 0, H, 0, WD, N_PIX)
        return (jsamp.gather_pixels(self.dd, i, j),
                jsamp.gather_pixels(self.cd, i, j),
                jsamp.gather_pixels(self.rq, i, j),
                *jcam.rays_from_uv(i, j, self.cw, 40.0, 40.0, 31.5, 23.5))


def port_draws(add_max):
    """JAX's densification draws (keys 1 and 2) for the port."""
    i, j = jsamp.sample_pixels_uniform(jax.random.key(1), 0, H, 0, WD,
                                       add_max)
    kg, kc = jax.random.split(jax.random.key(2))
    feats = tuple(t(0.1 * jax.random.normal(kk, (add_max * 3, 32),
                                            jnp.float32)) for kk in (kg, kc))
    return t(i), t(j), feats


def step_keys(steps=STEPS, seed=11):
    """The scripts' per-step keys: k, kk = split(k) from key(seed)."""
    k, out = jax.random.key(seed), []
    for _ in range(steps):
        k, kk = jax.random.split(k)
        out.append(kk)
    return out


def replay(keys, fill=False):
    """draws(t) for the port: step t's pixels (and fill) from keys[t-1]."""
    def draws(step):
        kk = keys[step - 1]
        i, j = jsamp.sample_pixels_uniform(kk, 0, H, 0, WD, N_PIX)
        out = {"i": t(i), "j": t(j)}
        if fill:
            out["fill"] = jax_fill(jax.random.fold_in(kk, 1))
        return out
    return draws


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_color_config()
    tcfg = W.color_config(small=True)
    params = jax_decoders(jcfg, 0)
    jx = Jax(jcfg, params)

    def frame():
        dec = interop.decoders_from_numpy(to_numpy(params), tcfg)
        return W.densified_frame0(tcfg, CPU, N_ADD_RAYS,
                                  draws=port_draws(jx.m.ms.add_max),
                                  decoders=dec)
    return jx, frame


def test_densified_frame0_equals_the_scripts_setup(setup):
    jx, frame = setup
    f0 = frame()
    assert f0.mapper.n_points_host == int(jx.m.cloud.n_points) > 0
    np.testing.assert_allclose(n(f0.mapper.cloud.packed),
                               np.asarray(jx.m.cloud.packed), atol=1e-6)
    np.testing.assert_allclose(n(f0.r_query), np.asarray(jx.rq), rtol=1e-6)
    for name in ("pid", "counts"):
        np.testing.assert_array_equal(n(getattr(f0.mapper.index, name)),
                                      np.asarray(getattr(jx.m.index, name)))
    for name in ("px", "py", "pz"):
        np.testing.assert_allclose(n(getattr(f0.mapper.index, name)),
                                   np.asarray(getattr(jx.m.index, name)),
                                   atol=1e-6)


def variant_col(colp, v):
    """profiling/color_ablate.py's run(): the colour decoder of variant
    ``v`` (the embedding's scale or its removal)."""
    colp = dict(colp)
    if v.emb_scale is not None:
        colp["embedder_B"] = (v.emb_scale / 32.0) * colp["embedder_B"]
    if v.zero_emb:
        colp["embedder_B"] = 0.0 * colp["embedder_B"]
    return colp


def direct_loss(jx, use_rel):
    """profiling/color_ablate.py's run(): the loss of one step."""
    m = jx.m

    def color_at(pcol, packed, p, rq):
        dists, idx, vmask = jk.grid_knn(m.index, p, k=8)
        w = JD.interpolation_weights(dists, vmask, rq, "distance")
        nb = packed[idx]
        if use_rel:
            nf = JD.encode_neighbor_feats(
                pcol, jax.lax.stop_gradient(nb[..., jpc.POS_SL]), p,
                nb[..., jpc.COL_SL])
        else:
            nf = nb[..., jpc.COL_SL]
        c = jnp.sum(w[..., None] * nf, axis=1)
        return JD.col_decoder_apply(pcol, p, c)

    def loss_fn(diff, k):
        gt_d, gt_c, rq, ro, rd = jx.batch(k)
        pred = color_at(diff["col"], diff["packed"], ro + rd * gt_d[:, None],
                        rq)
        ok = gt_d > 0
        return jnp.sum(jnp.where(ok[:, None], jnp.abs(gt_c - pred), 0.0))

    return loss_fn


def adam_step(loss_fn, geo):
    """The scripts' jitted step: Adam on the colour (and, with ``geo``, the
    geometry) columns and the colour decoder; lr an argument, so that one
    compiled step serves every learning rate."""
    @jax.jit
    def step(diff, opt, k, tt, lr):
        (l, aux), g = jax.value_and_grad(
            lambda d_, k_: _with_aux(loss_fn(d_, k_)), has_aux=True)(diff, k)
        lrrow = jnp.zeros((jpc.PACK_W,)).at[jpc.COL_SL].set(lr)
        if geo:
            lrrow = lrrow.at[jpc.GEO_SL].set(lr)
        newp, st_p = jadam.update(diff["packed"], g["packed"],
                                  {"m": opt["m"]["packed"],
                                   "v": opt["v"]["packed"]}, tt, lrrow)
        newc, st_c = jadam.update(diff["col"], g["col"],
                                  {"m": opt["m"]["col"], "v": opt["v"]["col"]},
                                  tt, lr)
        return ({"packed": newp, "col": newc},
                {"m": {"packed": st_p["m"], "col": st_c["m"]},
                 "v": {"packed": st_p["v"], "col": st_c["v"]}}, l, aux)
    return step


def run_adam(jx, colp, step, steps, lr):
    """(loss, aux) of each of ``steps`` steps from the densified cloud."""
    diff = {"col": colp, "packed": jx.m.cloud.packed}
    opt = jadam.init_state(diff)
    out = []
    for i, kk in enumerate(step_keys(steps), 1):
        diff, opt, l, aux = step(diff, opt, kk, jnp.asarray(float(i)),
                                 jnp.asarray(lr, jnp.float32))
        out.append((float(l), tuple(float(a) for a in aux)))
    return out


def _with_aux(res):
    return res if isinstance(res, tuple) else (res, ())


def assert_losses(got, want):
    """First loss 1e-4 relative, the loss after 5 steps 2e-3."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[-1], want[-1], rtol=2e-3)
    assert got[-1] != got[0]


@pytest.fixture(scope="module")
def jax_ablate(setup):
    """The script's run() for each variant: {name: the losses of each
    step}; one compiled step with and one without the relative encoder."""
    jx, _ = setup
    steps = {rel: adam_step(direct_loss(jx, rel), geo=False)
             for rel in (True, False)}
    return {v.name: [l for l, _ in run_adam(
        jx, variant_col(jx.params["col"], v), steps[v.use_rel], STEPS,
        v.lr)] for v in color_ablate.VARIANTS}


@pytest.mark.parametrize("variant", color_ablate.VARIANTS,
                         ids=[v.name.strip() for v in color_ablate.VARIANTS])
def test_color_ablate_variants_match_jax(setup, jax_ablate, variant):
    """Each of color_ablate's six variants against the script's run(); the
    baseline is color_direct's fit, held to the same loop."""
    _, frame = setup
    want = jax_ablate[variant.name]
    f0 = frame()
    got = color_ablate.run(f0, STEPS, draws_for=lambda v: replay(
        step_keys()), variants=(variant,))[variant.name]
    assert_losses(got, want)
    if variant is color_ablate.VARIANTS[0]:
        direct = color_direct.fit(frame(), STEPS, draws=replay(step_keys()))
        assert_losses(direct, want)


def test_color_train_iso_matches_jax(setup):
    """geo + 0.1 col through render_rays, Adam on the geometry and colour
    columns and the colour decoder: the total loss and both parts."""
    jx, frame = setup
    m = jx.m

    def loss_fn(diff, k):
        gt_d, gt_c, rq, ro, rd = jx.batch(k)
        ok = gt_d > 0
        depth_r, _, col_r, valid_ray = JR.render_rays(
            {"geo": jx.params["geo"], "col": diff["col"]}, diff["packed"],
            m.cloud.n_points, m.index, ro, rd, gt_d, rq, ok,
            jax.random.fold_in(k, 1), m.rc, stage_color=True)
        mask = ok & valid_ray
        geo_l = jnp.sum(jnp.where(mask, jnp.abs(gt_d - depth_r), 0.0))
        closs = jnp.sum(jnp.where(mask[:, None], jnp.abs(gt_c - col_r), 0.0))
        return geo_l + 0.1 * closs, (geo_l, closs)

    want = run_adam(jx, jx.params["col"], adam_step(loss_fn, geo=True),
                    STEPS, 0.005)
    got = color_train_iso.fit(frame(), STEPS, draws=replay(step_keys(),
                                                           fill=True))
    assert_losses([g[0] for g in got], [w[0] for w in want])
    for part in (0, 1):
        assert_losses([g[1][part] for g in got], [w[1][part] for w in want])


def test_color_debug_gradients_match_jax(setup):
    """The loss, its rays, the rendered statistics and every gradient sum
    against jax.value_and_grad of the script's loss on the same batch."""
    jx, frame = setup
    m = jx.m
    kb, kf = jax.random.key(5), jax.random.key(7)
    i, j = jsamp.sample_pixels_uniform(kb, 0, H, 0, WD, N_PIX)
    gt_d, gt_c, rq, ro, rd = jx.batch(kb)
    ok = gt_d > 0

    def loss_fn(diff):
        _, _, col_r, valid_ray = JR.render_rays(
            {"geo": jx.params["geo"], "col": diff["col"]}, diff["packed"],
            m.cloud.n_points, m.index, ro, rd, gt_d, rq, ok, kf, m.rc,
            stage_color=True)
        mask = ok & valid_ray & (gt_d > 0)
        return jnp.sum(jnp.where(mask[:, None], jnp.abs(gt_c - col_r),
                                 0.0)), (col_r, mask)

    def grads_and_raw(diff):
        """The loss's value and gradient, and the pre-sigmoid render: one
        compilation."""
        raw = JR.render_rays(
            {"geo": jx.params["geo"], "col": diff["col"]}, diff["packed"],
            m.cloud.n_points, m.index, ro, rd, gt_d, rq, ok, kf, m.rc,
            stage_color=True, apply_sigmoid_color=False)[2]
        return jax.value_and_grad(loss_fn, has_aux=True)(diff), raw

    ((closs, (col_r, mask)), g), raw = jax.jit(grads_and_raw)(
        {"col": jx.params["col"], "packed": m.cloud.packed})
    got = color_debug.probe(frame(), {"i": t(i), "j": t(j),
                                      "fill": jax_fill(kf)})
    np.testing.assert_allclose(got["color_loss"], float(closs), rtol=1e-4)
    assert got["rays"] == int(mask.sum()) > 0
    np.testing.assert_allclose(got["rendered"]["mean"],
                               float(col_r.mean()), rtol=1e-4)
    gp = g["packed"]
    want = {"col": gp[:, jpc.COL_SL], "geo": gp[:, jpc.GEO_SL]}
    for name, arr in want.items():
        np.testing.assert_allclose(got["grad_packed"][name],
                                   float(jnp.abs(arr).sum()), rtol=2e-3)
    assert got["grad_packed"]["pos"] == float(
        jnp.abs(gp[:, jpc.POS_SL]).sum()) == 0.0
    gc = g["col"]
    for name, leaf in (("output_linear.w", gc["output_linear"]["w"]),
                       ("pts_linears0.w", gc["pts_linears"][0]["w"]),
                       ("fc_c0.w", gc["fc_c"][0]["w"]),
                       ("mlp_col_neighbor.l1.w",
                        gc["mlp_col_neighbor"]["l1"]["w"])):
        np.testing.assert_allclose(got["grad_col"][name],
                                   float(jnp.abs(leaf).sum()), rtol=2e-3)
    for stat, v in (("min", raw.min()), ("max", raw.max()),
                    ("mean", raw.mean())):
        np.testing.assert_allclose(got["pre_sigmoid"][stat], float(v),
                                   rtol=2e-3, atol=1e-4)


def test_color_blowup_norms_after_map_frame_match_jax():
    """color_blowup on the tiny room config at 6 first-frame iterations
    (3 in the geometry stage) against JAX's map_frame(0) from the same
    decoders: each colour-decoder part's squared norm before mapping and
    after it, the report finite and free of NaN."""
    from torch_parity import tiny_cfgs
    jcfg, tcfg = tiny_cfgs(2)
    for cfg in (jcfg, tcfg):
        cfg["mapping"].update({"iters_first": 6, "geo_iter_first": 3})
    params = jax_decoders(jcfg, 0)
    norm = lambda tree: float(sum(jnp.sum(leaf ** 2) for leaf in
                                  jax.tree_util.tree_leaves(tree)))
    before = {k: norm(v) for k, v in params["col"].items()}
    jm = JM.Mapper(jcfg, params, 10, np.random.default_rng(0))
    _, color, depth, c2w = get_dataset(jcfg)[0]
    jm.map_frame(0, np.asarray(color), np.asarray(depth), np.asarray(c2w),
                 np.asarray(c2w))
    after = {k: norm(v) for k, v in jm.params["col"].items()}

    dec = interop.decoders_from_numpy(to_numpy(params), tcfg)
    mapper = W.make_mapper(tcfg, CPU)
    mapper.decoders = dec
    out = color_blowup.run(tcfg, CPU, mapper=mapper, n_pixels=N_PIX)
    assert set(out["norms_before"]) == set(before)
    for k in before:
        np.testing.assert_allclose(out["norms_before"][k], before[k],
                                   rtol=1e-6)
        np.testing.assert_allclose(out["norms_after"][k], after[k],
                                   rtol=1e-3)
    assert out["norms_after"]["pts_linears"] != out["norms_before"][
        "pts_linears"]
    assert not out["nan_feats"] and not out["nan_col_params"]
    assert np.isfinite([out["color_loss"], *out["features"].values(),
                        *out["pre_sigmoid"].values()]).all()
    assert out["n_points"] > 0


@pytest.mark.parametrize("name, argv", [
    ("color_direct", ["--steps", "2"]), ("color_ablate", ["--steps", "2"]),
    ("color_train_iso", ["--steps", "2"]), ("color_debug", []),
    ("color_blowup", ["--iters-first", "4", "--geo-iter-first", "2"]),
    ("color_converge", ["--iters", "6", "--chunk", "2", "--train_geo"])])
def test_every_color_probe_runs_on_the_host(name, argv, capsys):
    """Each main runs with --device cpu at --small and prints its report;
    color_converge prints a line at the end of every chunk."""
    module = {"color_direct": color_direct, "color_ablate": color_ablate,
              "color_train_iso": color_train_iso, "color_debug": color_debug,
              "color_blowup": color_blowup,
              "color_converge": color_converge}[name]
    assert module.main(argv + ["--small", "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"[{name}]" in text
    if name == "color_converge":
        assert [ln.split(":")[0] for ln in text.splitlines()
                if " it " in ln] == [f"[color_converge] it {i:4d}"
                                     for i in (2, 4, 6)]
