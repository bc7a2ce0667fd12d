"""Port parity, L0 primitives: camera, compositing, image ops, the wire
codec and sampling, against point_slam_tpu on the same numpy inputs.

Tolerances: exact for integer/boolean outputs and for pure re-orderings of
the same f32 operations; 1e-6 (relative) or 1e-5 where a matrix product or
a transcendental may round differently in the two libraries."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu.common import camera as jcam
from point_slam_tpu.common import compositing as jcomp
from point_slam_tpu.common import image as jimg
from point_slam_tpu.common import sampling as jsamp
from point_slam_tpu_torch.common import camera as tcam
from point_slam_tpu_torch.common import compositing as tcomp
from point_slam_tpu_torch.common import image as timg
from point_slam_tpu_torch.common import sampling as tsamp

from torch_parity import n, t


def _rand_pose(rng):
    q = rng.normal(size=4).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :4] = np.asarray(jcam.pose_matrix_from_tensor(
        jnp.asarray(np.concatenate([q, rng.normal(size=3)]).astype(
            np.float32))))
    return c2w


def test_quaternion_pose_matrix_matches_jax():
    rng = np.random.default_rng(0)
    cams = rng.normal(size=(16, 7)).astype(np.float32)   # unnormalised q
    np.testing.assert_allclose(
        n(tcam.pose_matrix_from_tensor(t(cams))),
        n(jcam.pose_matrix_from_tensor(jnp.asarray(cams))), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        n(tcam.pose_matrix_from_tensor(t(cams[0]))),
        n(jcam.pose_matrix_from_tensor(jnp.asarray(cams[0]))), rtol=1e-6,
        atol=1e-6)


def test_tensor_from_pose_matrix_is_the_same_host_code():
    rng = np.random.default_rng(1)
    for _ in range(8):
        c2w = _rand_pose(rng)
        np.testing.assert_array_equal(tcam.tensor_from_pose_matrix(c2w),
                                      jcam.tensor_from_pose_matrix(c2w))
        np.testing.assert_allclose(
            n(tcam.pose_matrix_from_tensor(t(tcam.tensor_from_pose_matrix(
                c2w)))), c2w[:3], atol=1e-5)


def test_host_pose_helpers_match_jax():
    """pose_matrix_from_tensor_np (BA's write-back) and the t-first
    7-vector, as the JAX package's host helpers."""
    rng = np.random.default_rng(2)
    for _ in range(8):
        cam = rng.normal(size=7).astype(np.float32)
        got = tcam.pose_matrix_from_tensor_np(cam)
        assert got.dtype == np.float32 and got.shape == (4, 4)
        np.testing.assert_allclose(got, jcam.pose_matrix_from_tensor_np(cam),
                                   rtol=1e-6, atol=1e-6)
        c2w = _rand_pose(rng)
        np.testing.assert_array_equal(
            tcam.tensor_from_pose_matrix(c2w, t_first=True),
            jcam.tensor_from_pose_matrix(c2w, t_first=True))


def test_rays_match_jax():
    rng = np.random.default_rng(2)
    c2w = _rand_pose(rng)
    i = rng.integers(0, 64, 50).astype(np.float32)
    j = rng.integers(0, 48, 50).astype(np.float32)
    for a, b in zip(tcam.rays_from_uv(t(i), t(j), t(c2w), 40., 41., 31.5, 23.5),
                    jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j),
                                      jnp.asarray(c2w), 40., 41., 31.5, 23.5)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(tcam.rays_full_image(6, 8, 4., 4., 3.5, 2.5, t(c2w)),
                    jcam.rays_full_image(6, 8, 4., 4., 3.5, 2.5,
                                         jnp.asarray(c2w))):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)


def test_project_points_matches_jax():
    rng = np.random.default_rng(3)
    w2c = np.linalg.inv(_rand_pose(rng)).astype(np.float32)
    pts = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    for a, b in zip(tcam.project_points(t(pts), t(w2c), 40., 40., 31.5, 23.5),
                    jcam.project_points(jnp.asarray(pts), jnp.asarray(w2c),
                                        40., 40., 31.5, 23.5)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-4)


def test_raw2outputs_matches_jax():
    rng = np.random.default_rng(4)
    raw = rng.normal(0, 5, (64, 5, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 4, (64, 5)), axis=1).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    for a, b in zip(tcomp.raw2outputs(t(raw), t(z), t(d), coef=0.1),
                    jcomp.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                                      jnp.asarray(d), coef=0.1)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size,frac", [(1, 1.0), (2, 1.0), (7, 0.5),
                                       (64, 0.3), (200, 0.9), (16, 0.0)])
def test_masked_median_is_the_lower_median(size, frac):
    """torch.median semantics, sorted[(n-1)//2], +inf on an empty mask;
    bit-equal to the JAX radix select (incl. negatives and +-0)."""
    rng = np.random.default_rng(size)
    x = rng.normal(0, 3, size).astype(np.float32)
    x[: size // 4] = 0.0
    x[size // 4: size // 3] = -0.0
    mask = rng.uniform(size=size) < frac
    got = n(timg.masked_median(t(x), t(mask)))
    np.testing.assert_array_equal(
        got, np.asarray(jimg.masked_median(jnp.asarray(x), jnp.asarray(mask))))
    if mask.any():
        assert got == torch.median(t(x)[t(mask)]).item()
    else:
        assert np.isposinf(got)


def test_masked_mean_max_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=100).astype(np.float32)
    m = rng.uniform(size=100) < 0.5
    np.testing.assert_allclose(n(timg.masked_mean(t(x), t(m))),
                               n(jimg.masked_mean(jnp.asarray(x),
                                                  jnp.asarray(m))), rtol=1e-6)
    assert n(timg.masked_max(t(x), t(m))) == n(jimg.masked_max(
        jnp.asarray(x), jnp.asarray(m)))


def test_wire_codec_matches_jax_bit_exactly():
    rng = np.random.default_rng(6)
    wire = rng.integers(0, 256, (12, 16, 5)).astype(np.uint8)
    scale = 6553.5
    tc, td = timg.decode_wire_frame(t(wire), 1.0 / scale)
    jc, jd = jimg.decode_wire_frame(jnp.asarray(wire),
                                    jnp.asarray(np.float32(1.0 / scale)))
    np.testing.assert_array_equal(n(tc), n(jc))
    np.testing.assert_array_equal(n(td), n(jd))
    back = timg.encode_wire_frame(tc, td, scale)
    np.testing.assert_array_equal(n(back), wire)
    np.testing.assert_array_equal(
        n(back), n(jimg.encode_wire_frame(jc, jd, jnp.asarray(
            np.float32(scale)))))


def test_sobel_gradient_and_radius_maps_match_jax():
    rng = np.random.default_rng(7)
    color = rng.uniform(size=(20, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(timg.color_gradient_magnitude(t(color))),
        n(jimg.color_gradient_magnitude(jnp.asarray(color))),
        rtol=1e-5, atol=1e-6)
    for a, b in zip(timg.dynamic_radius_maps(t(color), 0.08, 0.02, 2, 0.15),
                    jimg.dynamic_radius_maps(jnp.asarray(color), 0.08, 0.02,
                                             2, 0.15)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-7)


def test_gradient_candidates_and_choice_match_jax():
    """Top-gradient pool (exact on distinct values) and the without-
    replacement pick, fed JAX's own uniform scores."""
    rng = np.random.default_rng(8)
    grad = rng.permutation(48 * 64).reshape(48, 64).astype(np.float32)
    depth = rng.uniform(0, 6, (48, 64)).astype(np.float32)
    ti, tok = tsamp.top_gradient_candidates(t(grad), 5, 43, 5, 59, 300,
                                            depth=t(depth), depth_limit=5.0)
    ji, jok = jsamp.top_gradient_candidates(jnp.asarray(grad), 5, 43, 5, 59,
                                            300, depth=jnp.asarray(depth),
                                            depth_limit=5.0)
    np.testing.assert_array_equal(n(ti), n(ji))
    np.testing.assert_array_equal(n(tok), n(jok))
    key = jax.random.key(3)
    jpos, jok2 = jsamp.choose_without_replacement(key, jok, 50)
    scores = jax.random.uniform(key, jok.shape)
    tpos, tok2 = tsamp.choose_without_replacement(tok, 50, scores=t(scores))
    np.testing.assert_array_equal(n(tpos), n(jpos))
    np.testing.assert_array_equal(n(tok2), n(jok2))
    i, j = tsamp.flat_to_ij(ti, 64)
    ji_, jj_ = jsamp.flat_to_ij(ji, 64)
    np.testing.assert_array_equal(n(i), n(ji_))
    np.testing.assert_array_equal(n(j), n(jj_))


def test_uniform_pixels_stay_in_region():
    g = torch.Generator().manual_seed(0)
    i, j = tsamp.sample_pixels_uniform(5, 43, 7, 57, 1000, g, "cpu")
    assert i.dtype == torch.float32
    assert 7 <= i.min() and i.max() < 57 and 5 <= j.min() and j.max() < 43
    img = torch.arange(48 * 64.).reshape(48, 64)
    np.testing.assert_array_equal(n(tsamp.gather_pixels(img, i, j)),
                                  n(j * 64 + i))
