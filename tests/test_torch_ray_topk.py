"""Port parity for the raw outputs of the packed (K1) and f32-plane (K2) ray
top-k: JAX's _ray_topk_kernel_packed and _ray_topk_kernel run through
pallas_call in interpret mode on the CPU, as ray_grid_knn launches them,
against the port's ray_topk_reference on the same probes, planes and
queries. The raw keys and ids include the lanes and ids of the +inf
winners of samples with fewer than k points, which ray_grid_knn's masked
outputs hide and which the CUDA kernel (csrc/ray_topk.cu) must reproduce.

Tolerance 0: keys equal, ids equal as int32 bit patterns. The inputs are
dyadic (points and metric queries on a 2^-10 grid, cell 0.25, so the
lattice queries q / 2^-8 lie on a 1/4 grid), so every product in d^2 is
exact and XLA's CPU code, which may contract d^2 into FMAs, rounds as the
port does."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from point_slam_tpu.ops import knn as jk
from point_slam_tpu_torch.ops import knn as tk

from torch_parity import n, t

CELL = 0.25
GRID = 1024.0          # points and queries on a 1/GRID metre grid
R, NS, K, BLK = 64, 5, 8, 32

# case -> (points, table size, C, probes a ray); "full": 12 points in one
# cell of a C=4 table, so probe 0 of the rays there holds C points and the
# +inf winners lie past it; "sentinel": 36 probes over a 64-bucket table,
# so duplicate and out-of-box probes point at the sentinel row; the _c48
# and _c96 cases are the widths the kernels' generic instantiation takes
# (C not a power of two; 96 is the JAX package's default max_per_cell)
CASES = {"dense": (6000, 1 << 12, 64, 27), "sparse": (150, 1 << 12, 64, 27),
         "full": (40, 1 << 12, 4, 27), "sentinel": (5, 1 << 6, 64, 36),
         "dense_c48": (6000, 1 << 12, 48, 27),
         "sparse_c48": (150, 1 << 12, 48, 27),
         "dense_c96": (6000, 1 << 12, 96, 27),
         "sparse_c96": (150, 1 << 12, 96, 27)}


def dyadic(x):
    return (np.round(np.asarray(x, np.float64) * GRID) / GRID).astype(
        np.float32)


def case_inputs(case, seed=31):
    """(points (CAP, 3), n_points, q (R, NS, 3)): a cloud in [-2, 2]^3 and
    ray-structured samples near cloud points, within one cell for "full"."""
    n_pts, _, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    cap = 8192
    pts = np.full((cap, 3), 1e6, np.float32)
    pts[:n_pts] = dyadic(rng.uniform(-2, 2, (n_pts, 3)))
    if case == "full":
        pts[:12] = dyadic(0.125 + rng.uniform(-0.1, 0.1, (12, 3)))
        centers = np.full((R, 3), 0.125)
        spread = 0.08
    else:
        centers = pts[rng.integers(0, n_pts, R)]
        spread = 0.2
    dirs = rng.normal(size=(R, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    z = np.linspace(-0.5, 0.5, NS) * spread
    q = dyadic(centers[:, None, :] + dirs[:, None, :] * z[None, :, None]
               + rng.uniform(-0.02, 0.02, (R, 1, 3)))
    return pts, n_pts, q


def jax_ray_kernel(ji, probes, qk, packed):
    """JAX's K1 (packed) or K2 through pallas_call in interpret mode, with
    ray_grid_knn's blocks and specs. Returns (keys, ids) numpy."""
    p_ray = probes.shape[1]
    c = ji.max_per_cell
    pc = p_ray * c
    lane_mask = (1 << (pc - 1).bit_length()) - 1
    rows = jnp.asarray(probes)
    bs_c = pl.BlockSpec((BLK, pc), lambda i: (i, 0), memory_space=pltpu.VMEM)
    bs_q = pl.BlockSpec((BLK, NS), lambda i: (i, 0), memory_space=pltpu.VMEM)
    bs_o = pl.BlockSpec((BLK, NS * K), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    if packed:
        body = jk._ray_topk_kernel_packed(NS, K, pc, lane_mask)
        blocks = [ji.pxyz[rows].reshape(R, pc), ji.pid[rows].reshape(R, pc)]
    else:
        body = jk._ray_topk_kernel(NS, K, pc, lane_mask)
        blocks = [pl_[rows].reshape(R, pc)
                  for pl_ in (ji.px, ji.py, ji.pz, ji.pid)]
    q = jnp.asarray(qk)
    keys, ids = pl.pallas_call(
        body, grid=(R // BLK,), in_specs=[bs_c] * len(blocks) + [bs_q] * 3,
        out_specs=[bs_o, bs_o],
        out_shape=[jax.ShapeDtypeStruct((R, NS * K), jnp.int32),
                   jax.ShapeDtypeStruct((R, NS * K), jnp.float32)],
        interpret=True)(*blocks, q[..., 0], q[..., 1], q[..., 2])
    return np.asarray(keys), np.asarray(ids), lane_mask


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", ["packed", "planes"])
def test_ray_topk_reference_matches_the_jax_kernels(layout, case):
    """Keys equal and ids equal as int32 bits, for K1 and K2, including
    the winners past a sample's finite candidates: the k lowest-numbered
    empty lanes of the whole ray, which lie past probe 0 where probe 0 is
    full, and on the sentinel row where probes repeat."""
    packed = layout == "packed"
    pts, n_pts, q = case_inputs(case)
    _, table, c, p_ray = CASES[case]
    jb, tb = ((jk.build_packed_grid_index, tk.build_packed_grid_index)
              if packed else (jk.build_grid_index, tk.build_grid_index))
    ji = jb(jnp.asarray(pts), jnp.asarray(n_pts), jnp.asarray(CELL),
            table_size=table, max_per_cell=c)
    ti = tb(t(pts), n_pts, CELL, table_size=table, max_per_cell=c)
    for name in ji._fields:
        np.testing.assert_array_equal(n(getattr(ti, name)),
                                      np.asarray(getattr(ji, name)))
    probes, _ = tk._box_probes(t(q), CELL, table, p_ray)
    qk = (tk._query_lattice(t(q), ti.cell_size) if packed else t(q))
    if packed:   # the lattice queries are exact: q / 2^-8
        np.testing.assert_array_equal(n(qk), np.mod(q * 256.0, 1024.0))
    jkeys, jids, lane_mask = jax_ray_kernel(ji, n(probes), n(qk), packed)
    keys, ids = tk.ray_topk_reference(probes, tk.index_planes(ti), qk, K,
                                      lane_mask)
    np.testing.assert_array_equal(n(keys), jkeys)
    np.testing.assert_array_equal(n(ids).view(np.int32), jids.view(np.int32))

    # each case shows what it is there for
    keys = n(keys)
    short = keys >= 0x7F800000
    win = keys & lane_mask
    if case.startswith("dense"):
        assert short.mean() < 0.05, short.mean()
    else:
        assert short.mean() > 0.3, short.mean()
        # a +inf winner's id is its empty slot's: +inf
        assert np.isinf(n(ids)[short]).all()
    if case == "full":
        assert (n(ti.counts)[n(probes)[:, 0]] > c).all()
        assert (win[short] >= c).all() and short.any()
    if case == "sentinel":
        assert (n(probes) == table).any(axis=1).all()


@pytest.mark.parametrize("name", list(tk.LAUNCHES))
def test_ray_topk_shape_check_takes_every_width_that_fits(name):
    """The wrapper's only shape refusal is a block past the card's shared
    memory: C in {4, 16, 48, 96} fits at every P <= 64 (ns = 5), C = 128
    at P = 27 (56 for K1 and K3; K2, which compacts a lane a point, at
    64), and C = 128 at P = 64 (K2: C = 160) raises with the bytes it
    needs against the 232,448 available. The byte count is
    csrc/ray_topk.cu's block_words (phase A prints the launcher's own:
    55,756 for K1 and K3 and 48,844 for K2 at P = 27, C = 64; 74,296 for
    K1 at P = 36)."""
    assert tk.ray_topk_smem_bytes(name, 27, 64, 5) == (
        48_844 if name == "ray_topk_planes" else 55_756)
    if name == "ray_topk_packed":
        assert tk.ray_topk_smem_bytes(name, 36, 64, 5) == 74_296
    for c in (4, 16, 48, 96):
        for p in (1, 8, 27, 36, 48, 64):
            smem = tk.check_ray_topk_shape(name, p, c, 5)
            assert smem == tk.ray_topk_smem_bytes(name, p, c, 5)
            assert smem <= tk.RAY_TOPK_MAX_SMEM
    assert tk.check_ray_topk_shape(name, 27, 128, 5) < tk.RAY_TOPK_MAX_SMEM
    if name != "ray_topk_planes":
        assert tk.check_ray_topk_shape(name, 56, 128, 5) < 232_448
    else:
        assert tk.check_ray_topk_shape(name, 64, 128, 5) == 230_280
    c_out = 160 if name == "ray_topk_planes" else 128
    need = tk.ray_topk_smem_bytes(name, 64, c_out, 5)
    assert need > 232_448
    with pytest.raises(ValueError, match=f"needs {need} bytes of shared "
                       r"memory; the card gives a block 232448"):
        tk.check_ray_topk_shape(name, 64, c_out, 5)
    with pytest.raises(ValueError, match="C >= 1"):
        tk.check_ray_topk_shape(name, 27, 0, 5)
