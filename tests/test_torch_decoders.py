"""Port parity, decoders: the JAX decoder tree (with the pretrained geometry
MLP from pretrained/middle_fine.npz) carried into the port's nn.Modules by
interop.decoders_from_numpy, then both evaluated on the same inputs.

Tolerance: the Fourier projections 2*pi*x@B reach ~1e3 rad (|B| ~ 25-32,
room-scale x), where one f32 ulp is ~1e-4 rad; the two libraries sum the
3-term products in different orders, so sin/cos agree to ~1e-4 and the MLP
outputs are compared at 2e-4 (absolute and relative). Weights and the
interpolation weights (no phases) are compared exactly or at 1e-6."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu.models import decoders as JD
from point_slam_tpu_torch import interop
from point_slam_tpu_torch.models import decoders as TD

from torch_parity import PRETRAINED, jax_decoders, n, t, tiny_cfgs, to_numpy

PHASE_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = tiny_cfgs()
    params = jax_decoders(jcfg)
    return params, interop.decoders_from_numpy(to_numpy(params), tcfg)


def _inputs(seed, n_pts=256, k=8):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2.5, 2.5, (n_pts, 3)).astype(np.float32)
    c = rng.normal(0, 0.1, (n_pts, 32)).astype(np.float32)
    nbp = (p[:, None, :] + rng.normal(0, 0.05, (n_pts, k, 3))).astype(
        np.float32)
    nbf = rng.normal(0, 0.1, (n_pts, k, 32)).astype(np.float32)
    return p, c, nbp, nbf


def test_decoder_tree_names_and_orientation(both):
    """JAX _linear is x @ w + b: each nn.Linear holds w.T."""
    params, dec = both
    for name, mod in (("geo", dec.geo), ("col", dec.col)):
        for i, lin in enumerate(mod.pts_linears):
            np.testing.assert_array_equal(
                n(lin.weight), np.asarray(params[name]["pts_linears"][i]["w"]).T)
        for i, lin in enumerate(mod.fc_c):
            np.testing.assert_array_equal(
                n(lin.bias), np.asarray(params[name]["fc_c"][i]["b"]))
        np.testing.assert_array_equal(n(mod.embedder_B),
                                      np.asarray(params[name]["embedder_B"]))
    np.testing.assert_array_equal(
        n(dec.col.mlp_col_neighbor["l1"].weight),
        np.asarray(params["col"]["mlp_col_neighbor"]["l1"]["w"]).T)
    # the colour embedding is fixed; the geometry and relative ones learn
    assert "embedder_B" in dict(dec.col.named_buffers())
    assert dec.geo.embedder_B.requires_grad
    assert dec.col.embedder_rel_B.requires_grad


def test_pretrained_geometry_decoder_loads_like_jax():
    jcfg, tcfg = tiny_cfgs()
    dec = TD.load_pretrained_geo(TD.init_decoders(tcfg, 0), PRETRAINED)
    params = jax_decoders(jcfg)
    data = np.load(PRETRAINED)
    for i in range(TD.N_BLOCKS):
        np.testing.assert_array_equal(n(dec.geo.pts_linears[i].weight),
                                      data[f"pts_linears.{i}.weight"])
        np.testing.assert_array_equal(
            n(dec.geo.fc_c[i].weight),
            np.asarray(params["geo"]["fc_c"][i]["w"]).T)
    np.testing.assert_array_equal(n(dec.geo.embedder_B),
                                  np.asarray(params["geo"]["embedder_B"]))


def test_init_shapes_match_the_jax_tree():
    jcfg, tcfg = tiny_cfgs()
    params = JD.init_decoders(jax.random.key(0), jcfg)
    dec = TD.init_decoders(tcfg, 0)
    for name, mod in (("geo", dec.geo), ("col", dec.col)):
        for i, lin in enumerate(mod.pts_linears):
            assert tuple(lin.weight.shape) == \
                params[name]["pts_linears"][i]["w"].shape[::-1]
        assert tuple(mod.output_linear.weight.shape) == \
            params[name]["output_linear"]["w"].shape[::-1]


@pytest.mark.parametrize("seed", [0, 1])
def test_geo_decoder_matches_jax(both, seed):
    params, dec = both
    p, c, _, _ = _inputs(seed)
    got = dec.geo(t(p), t(c))
    want = JD.geo_decoder_apply(params["geo"], jnp.asarray(p), jnp.asarray(c))
    np.testing.assert_allclose(n(got), n(want), **PHASE_TOL)


@pytest.mark.parametrize("sigmoid", [True, False])
def test_color_decoder_matches_jax(both, sigmoid):
    params, dec = both
    p, c, _, _ = _inputs(2)
    got = dec.col(t(p), t(c), apply_sigmoid=sigmoid)
    want = JD.col_decoder_apply(params["col"], jnp.asarray(p), jnp.asarray(c),
                                apply_sigmoid=sigmoid)
    np.testing.assert_allclose(n(got), n(want), **PHASE_TOL)


def test_neighbor_encoder_f_theta_matches_jax(both):
    params, dec = both
    p, _, nbp, nbf = _inputs(3)
    got = dec.col.encode_neighbor_feats(t(nbp), t(p), t(nbf))
    want = JD.encode_neighbor_feats(params["col"], jnp.asarray(nbp),
                                    jnp.asarray(p), jnp.asarray(nbf))
    np.testing.assert_allclose(n(got), n(want), **PHASE_TOL)


def test_softplus_matches_jax():
    x = np.linspace(-0.5, 0.5, 2001).astype(np.float32)
    np.testing.assert_allclose(n(TD.softplus100(t(x))),
                               n(JD.softplus100(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("weighting", ["distance", "expo"])
def test_interpolation_weights_match_jax(weighting):
    rng = np.random.default_rng(4)
    d = rng.uniform(0, 0.05, (100, 8)).astype(np.float32)
    valid = rng.uniform(size=(100, 8)) < 0.8
    d[~valid] = np.inf
    r = rng.uniform(0.05, 0.2, 100).astype(np.float32)
    np.testing.assert_allclose(
        n(TD.interpolation_weights(t(d), t(valid), t(r), weighting)),
        n(JD.interpolation_weights(jnp.asarray(d), jnp.asarray(valid),
                                   jnp.asarray(r), weighting)),
        rtol=1e-6, atol=1e-7)


def test_random_fill_uses_one_shared_vector():
    c = torch.randn(10, 32)
    has = torch.tensor([True, False] * 5)
    rnd = 0.01 * torch.randn(32)
    out = TD.random_fill_features(c, has, rnd)
    assert torch.equal(out[has], c[has])
    assert torch.equal(out[~has], rnd.expand(5, 32))
    jout = JD.random_fill_features(jax.random.key(0), jnp.asarray(n(c)),
                                   jnp.asarray(n(has)), 32)
    # JAX likewise writes one vector into every masked row
    assert np.unique(np.asarray(jout)[~n(has)], axis=0).shape[0] == 1


def test_out_of_slice_options_raise():
    """Nothing of the colour decoder is refused any more: the exposure MLP
    (encode_exposure) and the view-direction input (use_view_direction) are
    carried, with the JAX tree's names, shapes and orientation."""
    jcfg, tcfg = tiny_cfgs()
    jcfg["model"]["encode_exposure"] = True
    tcfg["model"]["encode_exposure"] = True
    params = JD.init_decoders(jax.random.key(0), jcfg)
    jexp = params["col"]["mlp_exposure"]
    own = TD.init_decoders(tcfg, 0).col.mlp_exposure
    carried = interop.decoders_from_numpy(to_numpy(params), tcfg)
    for k in ("l1", "l2"):
        assert tuple(own[k].weight.shape) == jexp[k]["w"].shape[::-1]
        np.testing.assert_array_equal(n(carried.col.mlp_exposure[k].weight),
                                      np.asarray(jexp[k]["w"]).T)
        np.testing.assert_array_equal(n(carried.col.mlp_exposure[k].bias),
                                      np.asarray(jexp[k]["b"]))
    # the N(0, 0.01) weight init of the JAX package
    assert 0.005 < float(own["l1"].weight.detach().std()) < 0.02
    tcfg["model"]["encode_exposure"] = False
    tcfg["model"]["use_view_direction"] = True
    col = TD.init_decoders(tcfg, 0).col
    assert col.pts_linears[0].in_features == 4 * TD.COL_EMB
    assert "embedder_view_B" in dict(col.named_buffers())


def _viewd_cfgs(encode_viewd):
    jcfg, tcfg = tiny_cfgs()
    for cfg in (jcfg, tcfg):
        cfg["model"].update({"use_view_direction": True,
                             "encode_viewd": encode_viewd})
    return jcfg, tcfg


@pytest.mark.parametrize("encode_viewd", [True, False],
                         ids=["encode_viewd", "raw_viewd"])
def test_color_decoder_with_view_directions_matches_jax(encode_viewd):
    """The view direction joins the point embedding at the input and at the
    skip (its Fourier embedding, or the 3 raw components), normalised with
    the 1e-12 floor; the widths and embedder_view_B follow the JAX tree."""
    jcfg, tcfg = _viewd_cfgs(encode_viewd)
    params = jax_decoders(jcfg)
    dec = interop.decoders_from_numpy(to_numpy(params), tcfg)
    width = 2 * TD.COL_EMB + (2 * TD.COL_EMB if encode_viewd else 3)
    assert dec.col.pts_linears[0].in_features == width
    assert dec.col.pts_linears[TD.SKIP + 1].in_features == \
        TD.COL_HIDDEN + width
    assert ("embedder_view_B" in params["col"]) == encode_viewd
    if encode_viewd:
        np.testing.assert_array_equal(n(dec.col.embedder_view_B),
                                      np.asarray(params["col"]
                                                 ["embedder_view_B"]))
    p, c, _, _ = _inputs(5)
    rng = np.random.default_rng(6)
    views = rng.normal(0, 1.5, (p.shape[0], 3)).astype(np.float32)
    views[0] = 0.0                            # the norm's 1e-12 floor
    for sig in (True, False):
        got = dec.col(t(p), t(c), apply_sigmoid=sig, views_d=t(views))
        want = JD.col_decoder_apply(params["col"], jnp.asarray(p),
                                    jnp.asarray(c), jnp.asarray(views),
                                    apply_sigmoid=sig)
        np.testing.assert_allclose(n(got), n(want), **PHASE_TOL)


@pytest.mark.parametrize("encode_viewd", [True, False],
                         ids=["encode_viewd", "raw_viewd"])
def test_render_rays_with_view_directions_matches_jax(encode_viewd):
    """render_rays hands the colour decoder each ray's direction repeated
    over its samples, as JAX's does; the geometry does not change."""
    from point_slam_tpu import renderer as JR
    from point_slam_tpu.common import camera as jcam
    from point_slam_tpu_torch import renderer as TR
    from torch_parity import Scene, jax_fill
    jcfg, tcfg = _viewd_cfgs(encode_viewd)
    scene = Scene()
    params = jax_decoders(jcfg)
    tdec = interop.decoders_from_numpy(to_numpy(params), tcfg)
    _, _, depth, c2w = scene.frames[1]
    rng = np.random.default_rng(7)
    i = rng.integers(0, 64, 120).astype(np.float32)
    j = rng.integers(0, 48, 120).astype(np.float32)
    o, d = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j),
                             jnp.asarray(c2w), 40.0, 40.0, 31.5, 23.5)
    rays = (np.asarray(o), np.asarray(d),
            depth[j.astype(int), i.astype(int)].copy(),
            np.full(120, 0.14, np.float32), np.ones(120, bool))
    key = jax.random.key(3)
    jrc = JR.make_render_config(jcfg, 0.1)._replace(ray_knn=False)
    trc = TR.make_render_config(tcfg, 0.1, "cpu")
    assert trc.use_view_direction
    jout = JR.render_rays(params, scene.jcloud.packed, scene.jcloud.n_points,
                          scene.jindex, *map(jnp.asarray, rays), key, jrc,
                          stage_color=True)
    tout = TR.render_rays(tdec, scene.tcloud.packed, scene.tindex,
                          *map(t, rays), trc, stage_color=True,
                          fill=jax_fill(key))
    for name, a, b in zip(("depth", "uncertainty", "color"), tout[:3],
                          jout[:3]):
        np.testing.assert_allclose(n(a), np.asarray(b), err_msg=name,
                                   **PHASE_TOL)
    plain = TR.render_rays(tdec, scene.tcloud.packed, scene.tindex,
                           *map(t, rays),
                           trc._replace(use_view_direction=False),
                           stage_color=False, fill=jax_fill(key))
    assert torch.equal(tout[0], plain[0])
