"""Port parity, ops/knn.py: the cell-table index (both layouts), per-sample
grid_knn and the ray-shared ray_grid_knn against point_slam_tpu.ops.knn.
JAX's ray_grid_knn runs its Pallas kernel in interpret mode on the CPU,
as tests/test_knn.py does; the port runs ray_topk's plain version.

Tolerances: exact for hashes, slot plans, index planes, counts, probes,
keys and validity (integer or selection outputs); winner ids equal on
>= 99.9% of slots; distances recomputed from the winners within 1e-6
(f32 sums of three squares in another order)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from point_slam_tpu.ops import knn as jk
from point_slam_tpu_torch.ops import knn as tk

from torch_parity import n, t


def make_cloud(n_pts, cap, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    pts = np.full((cap, 3), 1e6, np.float32)
    pts[:n_pts] = rng.uniform(-scale, scale, (n_pts, 3)).astype(np.float32)
    return pts, rng


def ray_queries(pts, n_pts, rng, n_rays, ns=5):
    """Ray-structured samples clustered within 0.04*depth."""
    centers = pts[rng.integers(0, n_pts, n_rays)]
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    depth = rng.uniform(1.5, 4.0, n_rays).astype(np.float32)
    z = depth[:, None] * np.linspace(0.98, 1.02, ns).astype(np.float32)
    return ((centers - dirs * depth[:, None])[:, None, :]
            + dirs[:, None, :] * z[..., None]).astype(np.float32)


BUILD = {False: (jk.build_grid_index, tk.build_grid_index),
         True: (jk.build_packed_grid_index, tk.build_packed_grid_index)}


def both_indexes(pts, n_pts, packed, cell=0.2, table=1 << 12):
    jb, tb = BUILD[packed]
    return (jb(jnp.asarray(pts), jnp.asarray(n_pts), jnp.asarray(cell),
               table_size=table, max_per_cell=64),
            tb(t(pts), n_pts, cell, table_size=table, max_per_cell=64))


def assert_index_equal(ji, ti):
    for name in ji._fields:
        np.testing.assert_array_equal(n(getattr(ti, name)),
                                      np.asarray(getattr(ji, name)),
                                      err_msg=name)


def test_hash_matches_jax_bit_for_bit():
    """int32 wraparound products, XOR, uint32 modulo: one different bit
    would give different bucket tables."""
    rng = np.random.default_rng(0)
    cells = rng.integers(-2 ** 30, 2 ** 30, (4096, 3)).astype(np.int32)
    cells[:8] = [[0, 0, 0], [-1, -1, -1], [2 ** 31 - 1, 0, 5],
                 [-2 ** 31, 3, -7], [1, 2, 3], [-5, 0, 9], [7, 7, 7],
                 [2 ** 20, -2 ** 20, 1]]
    for table in (1 << 12, 1 << 16, 1000):
        np.testing.assert_array_equal(
            n(tk._hash_cells(t(cells), table)),
            np.asarray(jk._hash_cells(jnp.asarray(cells), table)))


@pytest.mark.parametrize("base", [False, True])
def test_slot_plan_matches_jax(base):
    rng = np.random.default_rng(1)
    table, c = 64, 4
    h = rng.integers(0, table + 1, 500).astype(np.int32)  # incl. sentinel
    counts = rng.integers(0, 6, table + 1).astype(np.int32) if base else None
    jo, jd = jk._slot_plan(jnp.asarray(h), table, c,
                           None if counts is None else jnp.asarray(counts))
    to, td = tk._slot_plan(t(h, torch.long), table, c,
                           None if counts is None else t(counts, torch.long))
    np.testing.assert_array_equal(n(to), np.asarray(jo))
    np.testing.assert_array_equal(n(td), np.asarray(jd))


@pytest.mark.parametrize("packed", [False, True])
def test_build_and_insert_match_jax(packed):
    """Index planes, ids, counts: exact, for the build and for an insert
    of new points appended after it."""
    pts, _ = make_cloud(3000, 4096, seed=2)
    n0 = 2000
    ji, ti = both_indexes(pts, n0, packed)
    assert_index_equal(ji, ti)
    ids = np.arange(n0, 4096, dtype=np.int32)
    valid = ids < 3000
    ji2 = jk.insert_grid_index(ji, jnp.asarray(pts[n0:]), jnp.asarray(ids),
                               jnp.asarray(valid))
    ti2 = tk.insert_grid_index(ti, t(pts[n0:]), t(ids, torch.long), t(valid))
    assert_index_equal(ji2, ti2)
    # and the port's insert equals its own rebuild over the union
    _, full = both_indexes(pts, 3000, packed)
    assert_index_equal(full, ti2)


@pytest.mark.parametrize("p_ray", [27, 36, 64])
def test_box_probes_match_jax(p_ray):
    pts, rng = make_cloud(3000, 4096, seed=3)
    q = ray_queries(pts, 3000, rng, 200)
    q[:5, :, 0] = np.linspace(-1.5, 1.5, 5)                 # non-compact rays
    jp, jc = jk._box_probes(jnp.asarray(q), jnp.asarray(0.2), 1 << 12, p_ray)
    tp, tc = tk._box_probes(t(q), 0.2, 1 << 12, p_ray)
    np.testing.assert_array_equal(n(tp), np.asarray(jp))
    np.testing.assert_array_equal(n(tc), np.asarray(jc))
    assert not n(tc)[:5].any()
    perms, ok = tk._build_probe_perms(p_ray)
    jperms, jok = jk._build_probe_perms(p_ray)
    np.testing.assert_array_equal(perms, jperms)
    np.testing.assert_array_equal(ok, jok)


@pytest.mark.parametrize("packed", [False, True])
def test_grid_knn_matches_jax(packed):
    pts, rng = make_cloud(3000, 4096, seed=4)
    ji, ti = both_indexes(pts, 3000, packed)
    q = rng.uniform(-2.2, 2.2, (500, 3)).astype(np.float32)
    jd, jidx, jv = jk.grid_knn(ji, jnp.asarray(q), k=8)
    td, tidx, tv = tk.grid_knn(ti, t(q), k=8)
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    np.testing.assert_array_equal(n(tidx), np.asarray(jidx))
    jd, td = np.asarray(jd), n(td)
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(
        n(tk.neighbor_count(t(td), t(n(tv)), t(np.full(500, 0.1, np.float32)))),
        np.asarray(jk.neighbor_count(jnp.asarray(jd), jv, jnp.full(500, 0.1))))


@pytest.mark.parametrize("packed", [False, True])
def test_ray_grid_knn_matches_jax_pallas_kernel(packed):
    """Valid masks equal, winner ids equal on >= 99.9% of slots, exact
    recomputed d^2 within 1e-6, compact flags equal."""
    pts, rng = make_cloud(3000, 4096, seed=5)
    ji, ti = both_indexes(pts, 3000, packed)
    q = ray_queries(pts, 3000, rng, 96)
    jd, jidx, jv, jc = jk.ray_grid_knn(ji, jnp.asarray(q), k=8, probes=27)
    td, tidx, tv, tc = tk.ray_grid_knn(ti, t(q), k=8, probes=27)
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    np.testing.assert_array_equal(n(tc), np.asarray(jc))
    same = n(tidx) == np.asarray(jidx)
    assert same.mean() >= 0.999, same.mean()
    flat = q.reshape(-1, 3)
    exact = lambda idx, v: np.where(
        v, ((flat[:, None, :] - pts[idx]) ** 2).sum(-1), np.inf)
    np.testing.assert_allclose(exact(n(tidx), n(tv)),
                               exact(np.asarray(jidx), np.asarray(jv)),
                               rtol=1e-6, atol=1e-9)
    # the selection-quantised distances: the same key bits on >= 99.9% of
    # slots; elsewhere a 1-ulp difference in the query's lattice coordinate
    # or the d^2 sum (XLA may fuse what torch rounds op by op) can cross a
    # quantisation step, 2^-12 relative with 11 lane bits
    td, jd = n(td), np.asarray(jd)
    assert (td == jd).mean() >= 0.999
    np.testing.assert_allclose(td, jd, rtol=2 ** -11)


def test_grid_knn_subset_equals_grid_knn_on_needed_rays():
    pts, rng = make_cloud(2000, 2048, seed=6)
    ji, ti = both_indexes(pts, 2000, True)
    q = ray_queries(pts, 2000, rng, 40)
    need = np.zeros(40, bool)
    need[::3] = True
    idx, valid = tk.grid_knn_subset(ti, t(q), t(need), k=8)
    _, gi, gv = tk.grid_knn(ti, t(q[need].reshape(-1, 3)), k=8)
    assert torch.equal(idx[t(need)].reshape(-1, 8), gi)
    assert torch.equal(valid[t(need)].reshape(-1, 8), gv)
    assert not valid[t(~need)].any() and not idx[t(~need)].any()
    jidx, jv = jk.grid_knn_subset(ji, jnp.asarray(q), jnp.asarray(need), k=8)
    np.testing.assert_array_equal(n(idx), np.asarray(jidx))
    np.testing.assert_array_equal(n(valid), np.asarray(jv))


def test_ray_topk_on_cpu_runs_the_plain_version_and_counts_nothing():
    pts, rng = make_cloud(1000, 1024, seed=7)
    _, ti = both_indexes(pts, 1000, True)
    q = tk._query_lattice(t(ray_queries(pts, 1000, rng, 8)), ti.cell_size)
    probes, _ = tk._box_probes(t(ray_queries(pts, 1000, rng, 8)), 0.2,
                               ti.table_size, 27)
    before = dict(tk.LAUNCHES)
    got = tk.ray_topk(probes, tk.index_planes(ti), q, 8, 2047)
    want = tk.ray_topk_reference(probes, tk.index_planes(ti), q, 8, 2047)
    assert tk.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # keys are unique per sample and ascending; the lane picks the id
    keys = got[0].reshape(8, 5, 8)
    assert (keys[..., 1:] > keys[..., :-1]).all()


def test_ray_topk_refuses_devices_without_a_kernel():
    probes = torch.zeros((2, 27), dtype=torch.int32, device="meta")
    planes = (torch.zeros((5, 64), dtype=torch.int32, device="meta"),
              torch.zeros((5, 64), device="meta"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        tk.ray_topk(probes, planes, torch.zeros((2, 5, 3), device="meta"),
                    8, 2047)
