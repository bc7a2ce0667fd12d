"""The port's offline tools against the JAX package's, on the CPU:
convert_pretrained (the fake NICE-SLAM checkpoint of
tests/test_slam_e2e.py), convert_lpips (a stub ``lpips`` module),
pretrain_geo's npz writer and scene randomisation, a one-scene pretraining
run, and the exact kNN oracle brute_knn (tests/test_knn.py's inputs), which
then checks the port's grid kNN as test_knn.py checks JAX's.

Tolerances: the npz files equal array for array; decoders loaded from them
within test_torch_decoders.py's 2e-4 (Fourier phases); brute_knn's ids
equal and its distances within 1e-6 relative (XLA's CPU contracts the
squares into fused multiply-adds, so a distance may lie an f32 ulp
away)."""

import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu.models import decoders as JD
from point_slam_tpu.ops import knn as jknn
from point_slam_tpu_torch import interop
from point_slam_tpu_torch.models import decoders as TD
from point_slam_tpu_torch.ops import knn as tknn
from point_slam_tpu_torch.tools import convert_lpips as t_lpips
from point_slam_tpu_torch.tools import convert_pretrained as t_conv
from point_slam_tpu_torch.tools import pretrain_geo as t_pre

from torch_parity import PRETRAINED, jax_decoders, n, t, tiny_cfgs, to_numpy

PHASE_TOL = dict(rtol=2e-4, atol=2e-4)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_npz(a, b):
    a, b = _npz(a), _npz(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _geo_inputs(seed=0, n_pts=256):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2.5, 2.5, (n_pts, 3)).astype(np.float32),
            rng.normal(0, 0.1, (n_pts, 32)).astype(np.float32))


def test_convert_pretrained_matches_jax(tmp_path):
    from point_slam_tpu.tools.convert_pretrained import convert as jconvert
    jcfg, tcfg = tiny_cfgs(4)
    params0 = JD.init_decoders(jax.random.key(3), jcfg)
    geo = params0["geo"]
    rng = np.random.default_rng(5)
    model = {}

    def fake(dst, name):
        model[f"decoder.coarse.{name}.weight"] = torch.from_numpy(
            rng.normal(0, 0.1, dst["w"].shape[::-1]).astype(np.float32))
        model[f"decoder.coarse.{name}.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, dst["b"].shape).astype(np.float32))

    for name in ("pts_linears", "fc_c"):
        for i in range(len(geo[name])):
            fake(geo[name][i], f"{name}.{i}")
    fake(geo["output_linear"], "output_linear")
    model["decoder.coarse.embedder._B"] = torch.from_numpy(
        rng.normal(0, 25, geo["embedder_B"].shape).astype(np.float32))
    # decoy keys the filter must skip
    model["encoder.coarse.conv.weight"] = torch.zeros(3, 3)
    model["decoder.fine.pts_linears.0.weight"] = torch.zeros(4, 4)
    pt = tmp_path / "middle_fine.pt"
    torch.save({"model": model}, pt)

    n_j = jconvert(str(pt), str(tmp_path / "jax.npz"))
    n_t = t_conv.convert(str(pt), str(tmp_path / "port.npz"))
    assert n_j == n_t == 2 * (len(geo["pts_linears"]) + len(geo["fc_c"])
                              + 1) + 1
    _assert_same_npz(tmp_path / "jax.npz", tmp_path / "port.npz")

    jparams = JD.load_pretrained_geo(params0, str(tmp_path / "jax.npz"))
    dec = TD.load_pretrained_geo(TD.init_decoders(tcfg, 0),
                                 str(tmp_path / "port.npz"))
    p, c = _geo_inputs()
    want = JD.geo_decoder_apply(jparams["geo"], jnp.asarray(p),
                                jnp.asarray(c))
    with torch.no_grad():
        got = dec.geo(t(p), t(c))
    np.testing.assert_allclose(n(got), n(want), **PHASE_TOL)


def _stub_lpips(seed=0):
    """A module standing in for the lpips package: LPIPS(net, spatial) has
    the state-dict keys of the real AlexNet-LPIPS, with random values
    (calibration weights of both signs)."""
    rng = np.random.default_rng(seed)
    shapes = {"scaling_layer.shift": (1, 3, 1, 1),
              "scaling_layer.scale": (1, 3, 1, 1)}
    convs = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3),
             (256, 256, 3)]
    for i, (idx, (co, ci, k)) in enumerate(zip(t_lpips.CONV_AT, convs)):
        shapes[f"net.slice{i + 1}.{idx}.weight"] = (co, ci, k, k)
        shapes[f"net.slice{i + 1}.{idx}.bias"] = (co,)
        shapes[f"lin{i}.model.1.weight"] = (1, co, 1, 1)
    sd = {k: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))
          for k, s in shapes.items()}

    class LPIPS(torch.nn.Module):
        def __init__(self, net="alex", spatial=False):
            super().__init__()
            assert net == "alex" and spatial is False

        def state_dict(self):
            return dict(sd)

    return types.SimpleNamespace(LPIPS=LPIPS)


def test_convert_lpips_matches_jax(tmp_path, monkeypatch):
    from point_slam_tpu.tools import convert_lpips as jlpips
    monkeypatch.setitem(sys.modules, "lpips", _stub_lpips())
    monkeypatch.setattr(sys, "argv", ["convert_lpips", "--out",
                                      str(tmp_path / "jax.npz")])
    jlpips.main()
    assert t_lpips.convert(str(tmp_path / "port.npz")) == "lpips package"
    _assert_same_npz(tmp_path / "jax.npz", tmp_path / "port.npz")
    out = _npz(tmp_path / "port.npz")
    assert all((out[f"lin{i}_w"] >= 0).all() for i in range(5))
    assert (out["lin0_w"] == 0).any()


def test_convert_lpips_without_a_package_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lpips", None)
    monkeypatch.setitem(sys.modules, "torchmetrics", None)
    with pytest.raises(RuntimeError, match="lpips package or torchmetrics"):
        t_lpips.convert(str(tmp_path / "x.npz"))
    assert not (tmp_path / "x.npz").exists()


def test_save_geo_npz_matches_jax_and_round_trips(tmp_path):
    from point_slam_tpu.tools.pretrain_geo import save_geo_npz as jsave
    jcfg, tcfg = tiny_cfgs(4)
    params = jax_decoders(jcfg, seed=1)
    dec = interop.decoders_from_numpy(to_numpy(params), tcfg)
    n_j = jsave(params["geo"], str(tmp_path / "jax.npz"))
    n_t = t_pre.save_geo_npz(dec.geo, str(tmp_path / "port.npz"))
    assert n_j == n_t
    _assert_same_npz(tmp_path / "jax.npz", tmp_path / "port.npz")
    # the committed artefact is in the same layout
    assert sorted(_npz(PRETRAINED)) == sorted(_npz(tmp_path / "port.npz"))
    fresh = TD.load_pretrained_geo(TD.init_decoders(tcfg, 7),
                                   str(tmp_path / "port.npz"))
    for (k, a), b in zip(dec.geo.state_dict().items(),
                         fresh.geo.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


def test_pretrain_scenes_are_the_jax_tools():
    from point_slam_tpu.tools.pretrain_geo import scene_cfg as jscene
    for k in range(4):
        j = jscene(k, 40, "/unused", None)
        p = t_pre.scene_cfg(k, 40, "/unused", None)
        for sec in ("synthetic", "cam", "mapping", "tracking",
                    "pretrained_decoders"):
            assert p[sec] == j[sec], (k, sec)
        assert p["data"]["output"] == j["data"]["output"]


def test_pretrain_geo_runs_on_the_cpu(tmp_path, monkeypatch):
    """One scene of 3 frames at a small camera and depth: the npz is
    written where --out says (the committed one stays), loads through
    load_pretrained_geo and gives a finite, trained decoder."""
    scene_cfg = t_pre.scene_cfg

    def small(*a):
        cfg = scene_cfg(*a)
        cfg["cam"].update({"H": 24, "W": 32, "fx": 20.0, "fy": 20.0,
                           "cx": 15.5, "cy": 11.5})
        cfg["mapping"].update({"pixels": 200, "pixels_adding": 150,
                               "pixels_based_on_color_grad": 30,
                               "iters": 5, "iters_first": 10,
                               "geo_iter_first": 5})
        cfg["cuda"].update({"point_capacity_init": 1 << 12,
                            "grid_table_size": 1 << 12})
        return cfg

    monkeypatch.setattr(t_pre, "scene_cfg", small)
    before = _npz(PRETRAINED)
    out = tmp_path / "geo.npz"
    assert t_pre.main(["--device", "cpu", "--scenes", "1", "--frames", "3",
                       "--out", str(out), "--workdir",
                       str(tmp_path / "work")]) == str(out)
    _assert_same_npz(tmp_path / "work" / "geo_after_scene_0.npz", out)
    for k, v in _npz(PRETRAINED).items():
        np.testing.assert_array_equal(v, before[k])
    _, tcfg = tiny_cfgs(4)
    init = TD.init_decoders(tcfg, 0)
    dec = TD.load_pretrained_geo(TD.init_decoders(tcfg, 0), str(out))
    p, c = _geo_inputs()
    with torch.no_grad():
        occ = dec.geo(t(p), t(c))
        assert torch.isfinite(occ).all()
        assert not torch.equal(occ, init.geo(t(p), t(c)))


def _cloud(n_pts, cap, seed):
    """tests/test_knn.py's make_cloud: the padding rows at 1e6."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((cap, 3), np.float32)
    pts[:n_pts] = rng.uniform(-2, 2, size=(n_pts, 3)).astype(np.float32)
    pts[n_pts:] = 1e6
    return pts, rng


@pytest.mark.parametrize("cap,n_pts,q,tile,seed", [
    (512, 300, 64, 128, 1),            # test_brute_knn_exact
    (64, 3, 8, 4096, 2),               # test_brute_knn_fewer_points_than_k
    (512, 300, 64, 128, 5),            # duplicate points: ties
])
def test_brute_knn_matches_jax(cap, n_pts, q, tile, seed):
    pts, rng = _cloud(n_pts, cap, seed)
    queries = rng.uniform(-2, 2, size=(q, 3)).astype(np.float32)
    if seed == 5:
        pts[100:140] = pts[60:100]     # equal distances at two ids
        queries[:16] = pts[60:76]
    jd, ji, jv = jknn.brute_knn(jnp.asarray(pts), jnp.asarray(n_pts),
                                jnp.asarray(queries), k=8, tile=tile)
    td, ti, tv = tknn.brute_knn(t(pts), n_pts, t(queries), k=8, tile=tile)
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_allclose(n(td), np.asarray(jd), rtol=1e-6, atol=0)
    if n_pts < 8:
        assert n(tv)[:, :n_pts].all() and not n(tv)[:, n_pts:].any()
        assert np.isinf(n(td)[:, n_pts:]).all()
        assert (n(ti)[:, n_pts:] == 0).all()


def test_grid_knn_matches_brute_within_radius():
    """tests/test_knn.py's check on the port's grid kNN, with brute_knn as
    the oracle: every in-radius neighbour found, the counts equal, and the
    returned ids the points whose distances were reported."""
    cap, n_pts, q, radius = 2048, 1500, 256, 0.25
    pts, rng = _cloud(n_pts, cap, 3)
    queries = (pts[rng.integers(0, n_pts, size=q)]
               + rng.normal(scale=0.08, size=(q, 3)).astype(np.float32))
    index = tknn.build_grid_index(t(pts), n_pts, radius, table_size=1 << 14)
    gd, gi, gv = tknn.grid_knn(index, t(queries), k=8)
    rd, _, _ = tknn.brute_knn(t(pts), n_pts, t(queries), k=8)
    gd, rd = n(gd), n(rd)
    inside = rd < radius ** 2
    np.testing.assert_allclose(np.where(inside, gd, 0.0),
                               np.where(inside, rd, 0.0), rtol=1e-4,
                               atol=1e-5)
    counts = n(tknn.neighbor_count(t(gd), gv, torch.tensor(radius)))
    np.testing.assert_array_equal(counts, inside.sum(1))
    again = ((queries[:, None, :] - pts[n(gi)]) ** 2).sum(-1)
    np.testing.assert_allclose(np.where(inside, again, 0.0),
                               np.where(inside, gd, 0.0), rtol=1e-4,
                               atol=1e-5)
