"""The port's kNN stage scripts and gather micro-benchmark
(point_slam_tpu_torch/profiling: knn_pallas's and knn_pallas2's stages,
knn_pallas_stages, knn_pallas2_v5, knn_pallas5, knn_chain, knn_split,
knn_prod_stages, knn_packed_ab, profile_gather) against the JAX scripts
and the JAX package on the host at small sizes.

The scripts cannot be imported (they build their scenes at module level,
some read the gone ``GridIndex.table``), so each stage is reached by AST
(tests/test_torch_block_topk.py's ``extract``): the stage functions run
as written, with the script's per-call query jitter replaced by the
queries themselves and its ``mix`` (which folds each stage's outputs
into a PRNG key to chain the timed loop) by one that returns them.

Tolerances: probes, gathered rows, lattice words, keys, ids, validity
and compact flags exact (P1, P2 and P2' keys equal as they are in
test_torch_block_topk.py); exact d^2 from the winners within 1e-6
relative (the script's epilogue and the port's may round the three-term
sum differently), and so knn_split's gathered d^2 (XLA sums the three
squares in another order than torch.sum); knn_pallas5's parity
percentage equal to the script's sums over the JAX package's
ray_grid_knn and grid_knn; knn_chain's and profile_gather's reductions
exact (dyadic inputs: every sum is exact in f32, in any order)."""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu.ops import knn as jk
from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.profiling import (
    knn_chain, knn_packed_ab, knn_pallas as kp1, knn_pallas2 as kp2,
    knn_pallas2_v5, knn_pallas5, knn_pallas_stages, knn_prod_stages,
    knn_split, profile_gather, scene as S)

from test_torch_block_topk import extract
from torch_parity import n, t

TABLE, C, R, NS, K, BLK = 1 << 12, 16, 64, 5, 8, 32
CELL = 0.16


def identity_jitter(k, b):
    return b["q"]


def outputs(k, *xs):
    return xs


@pytest.fixture(scope="module")
def sheet():
    """The scripts' sine sheet at a small size: (scene, points numpy, q
    numpy, the JAX f32 index, the port's)."""
    sc = S.sine_sheet(0, n_points=3000, rays=R, cap=8192)
    ji = jk.build_grid_index(jnp.asarray(sc.points), jnp.asarray(sc.n_points),
                             jnp.asarray(CELL), TABLE, C)
    ti = tk.build_grid_index(t(sc.points), sc.n_points, CELL, TABLE, C)
    return sc, ji, ti


def jax_table(ji):
    """What the JAX GridIndex's ``.table`` was: (TABLE+1, C, 4) rows."""
    return jnp.stack([ji.px, ji.py, ji.pz, ji.pid], -1)


def assert_same(got, want, exact=True):
    got, want = n(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------- knn_pallas (v3, P1)

def test_knn_pallas_stages_equal_the_scripts(sheet):
    """s1 probes, s2 gathered rows, s3 X, Y, Z planes, s4 P1's keys and
    v3's (d^2, ids) equal the script's stages on the same queries."""
    sc, ji, ti = sheet
    p = kp1.P
    ns = extract("knn_pallas.py", {"ray_probes", "_LANE_MASK",
                                   "_topk_kernel", "pallas_topk",
                                   "knn_rays", "v3", "s_probes", "s_gather",
                                   "s_unpack", "s_topk"},
                 jitter=identity_jitter, mix=outputs, R=R, P=p, C=C,
                 TABLE=TABLE, NS=NS, K=K, R_BLK=BLK, _OFFSETS=jk._OFFSETS,
                 _hash_cells=jk._hash_cells)
    b = {"index": types.SimpleNamespace(table=jax_table(ji),
                                        cell_size=ji.cell_size),
         "q": jnp.asarray(sc.q)}
    table, q = S.interleaved_table(ti), t(sc.q)
    assert_same(kp1.s_probes(table, q, CELL), ns["s_probes"](None, b)[0])
    assert_same(kp1.s_gather(table, q, CELL), ns["s_gather"](None, b)[0])
    for got, want in zip(kp1.s_unpack(table, q, CELL),
                         ns["s_unpack"](None, b)):
        assert_same(got, want)
    keys = kp1.s_topk(table, q, CELL)
    assert_same(keys, ns["s_topk"](None, b)[0])
    assert (n(keys) < 0x7F800000).mean() > 0.9
    d2, idx, _ = kp1.knn_rays(table, q, CELL)
    jd2, jidx = ns["v3"](None, b)
    assert_same(idx, jidx)
    assert_same(d2, jd2, exact=False)


# ---------------------------------------------- knn_pallas2 (v4 P2, v5 P2')

def test_knn_pallas2_stages_equal_the_scripts(sheet):
    """v4's box probes, gathered rows and [X|Y|Z|ID] row, P2's (d2q, ids,
    valid); v5's compacted probes, rows and P2''s keys and ids."""
    sc, ji, ti = sheet
    ns = extract("knn_pallas2.py", {"_LANE_MASK", "CELLJ", "_OFF64",
                                    "box_probes", "_kernel", "pallas_topk",
                                    "knn_rays", "s_probes", "s_gather",
                                    "s_trans", "P2", "box_probes_compact",
                                    "_kernel2", "pallas_topk2", "v5",
                                    "s5_probes", "s5_gather"},
                 jitter=identity_jitter, mix=outputs, R=R, P=kp2.P, C=C,
                 TABLE=TABLE, NS=NS, K=K, R_BLK=BLK, CELL=CELL,
                 _hash_cells=jk._hash_cells)
    b = {"table": jax_table(ji), "q": jnp.asarray(sc.q)}
    table, q = S.interleaved_table(ti), t(sc.q)
    for name in ("s_probes", "s_gather", "s_trans", "s5_probes",
                 "s5_gather"):
        assert_same(getattr(kp2, name)(table, q, CELL),
                    ns[name](None, b)[0])
    for got, want in zip(kp2.knn_rays(table, q, CELL),
                         ns["knn_rays"](b["table"], b["q"])):
        assert_same(got, want)
    blk = kp2.block_v5(table, q, CELL)
    keys, ids = kp2.block_topk(blk.views, blk.q, K, blk.lane_mask)
    jkeys, jidx = ns["v5"](None, b)
    assert_same(keys, jkeys)
    valid = n(keys) < 0x7F800000
    np.testing.assert_array_equal(np.where(valid, n(ids), 0.0).astype(
        np.int32), np.asarray(jidx))
    assert valid.mean() > 0.9


# --------------------------------------------------- knn_pallas5 (C-sweep)

def jax_sheet_index(sc, c):
    return jk.build_grid_index(jnp.asarray(sc.points),
                               jnp.asarray(sc.n_points), jnp.asarray(CELL),
                               TABLE, c)


@pytest.fixture(scope="module")
def reference96(sheet):
    """The C = 96 references of both cases: the port's
    (knn_pallas5.reference) and the script's sorted grid_knn d^2."""
    sc, _, _ = sheet
    ref = knn_pallas5.reference(t(sc.points), sc.n_points, t(sc.q), CELL,
                                TABLE)
    d0, _, _ = jk.grid_knn(jax_sheet_index(sc, 96),
                           jnp.asarray(sc.q).reshape(-1, 3), k=K)
    return ref, np.sort(np.asarray(d0), axis=1)


@pytest.mark.parametrize("c", [48, 32])
def test_knn_pallas5_parity_equals_the_scripts_sums(sheet, reference96, c):
    """The parity percentage at C = 48 (the generic kernel's width) and 32
    equals the script's sums over point_slam_tpu's ray_grid_knn (Pallas in
    interpret mode) and grid_knn at C = 96."""
    sc, _, _ = sheet
    pts, q = sc.points, sc.q
    ref, a = reference96
    _, got = knn_pallas5.width_parity(t(pts), sc.n_points, t(q), CELL, c,
                                      ref, TABLE)
    _, i, v, _ = jk.ray_grid_knn(jax_sheet_index(sc, c), jnp.asarray(q), k=K)
    i = np.asarray(i).reshape(-1, K)
    v = np.asarray(v).reshape(-1, K)
    w = pts[i]
    dd = np.where(v, ((w - q.reshape(-1, 1, 3)) ** 2).sum(-1), np.inf)
    bd = np.sort(dd, axis=1)
    ok = np.isclose(a, bd, rtol=1e-5, atol=1e-10) | ~np.isfinite(a)
    assert got == ok.mean() * 100
    assert 90.0 < got < 100.0


# ------------------------------------------------------------- knn_split

def test_knn_split_stages_equal_the_scripts(sheet):
    """The probes, the min and the top-8 of the gathered d^2, and the full
    grid_knn, on the script's queries (the first Q points)."""
    sc, ji, ti = sheet
    qn = 256
    ns = extract("knn_split.py", {"common", "s_probe", "s_dist", "s_topk",
                                  "s_full"},
                 mix=lambda k, x: x, queries=identity_jitter, TABLE=TABLE,
                 Q=qn, K=K, knn=jk, _hash_cells=jk._hash_cells,
                 _OFFSETS=jk._OFFSETS)
    q = sc.points[:qn] + np.float32(0.01)
    b = {"index": types.SimpleNamespace(table=jax_table(ji),
                                        cell_size=ji.cell_size),
         "q": jnp.asarray(q)}
    table, tq = S.interleaved_table(ti), t(q)
    assert_same(knn_split.s_probe(tq, ti, table).float(),
                ns["s_probe"](None, b))
    assert_same(knn_split.s_dist(tq, ti, table), ns["s_dist"](None, b),
                exact=False)
    assert_same(knn_split.s_topk(tq, ti, table), ns["s_topk"](None, b),
                exact=False)
    d = knn_split.s_full(tq, ti, table)[0]
    assert_same(torch.where(torch.isfinite(d), d, 0.0),
                ns["s_full"](None, {"index": ji, "q": b["q"]}), exact=False)


# ------------------------------------------------------- knn_prod_stages

def test_knn_prod_stages_equal_the_scripts():
    """s1 (_box_probes), s2 (the two plane gathers), s3 / s3f (the full
    ray_grid_knn over the packed and the fused tables: K1 and K3 in
    interpret mode on the JAX side) and the calibration's three gathers,
    the fused rows gathered from the script's prototype (pxyz | pid
    bits), which equal the fused table's."""
    sc = S.sine_sheet(0, n_points=2000, rays=R, cap=8192)
    args = (sc.points, sc.n_points, CELL, TABLE, C)
    jargs = (jnp.asarray(sc.points), jnp.asarray(sc.n_points),
             jnp.asarray(CELL), TABLE, C)
    packed = tk.build_packed_grid_index(t(sc.points), *args[1:])
    fused = tk.build_fused_grid_index(t(sc.points), *args[1:])
    jpacked = jk.build_packed_grid_index(*jargs)
    ns = extract("knn_prod_stages.py", {"probe_rows", "s_probes",
                                        "s_gathers", "s_full",
                                        "s_full_fused", "g_one_plane",
                                        "g_two_planes", "g_fused_wide"},
                 jitter=identity_jitter, mix=outputs, TABLE=TABLE,
                 PROBES=knn_prod_stages.PROBES, K=K, knn=jk,
                 _box_probes=jk._box_probes)
    b = {"index": jpacked, "q": jnp.asarray(sc.q),
         "fused": jnp.concatenate([jpacked.pxyz, jax.lax.bitcast_convert_type(
             jpacked.pid, jnp.int32)], axis=1),
         "findex": jk.build_fused_grid_index(*jargs)}
    q = t(sc.q)
    pairs = [(knn_prod_stages.s_probes(packed, q), ns["s_probes"]),
             (knn_prod_stages.s_gathers(packed, q), ns["s_gathers"]),
             (knn_prod_stages.s_full(packed, q), ns["s_full"]),
             (knn_prod_stages.s_full(fused, q), ns["s_full_fused"]),
             ((knn_prod_stages.g_one_plane(packed, q),), ns["g_one_plane"]),
             (knn_prod_stages.g_two_planes(packed, q), ns["g_two_planes"]),
             ((knn_prod_stages.g_fused_wide(fused, q),),
              ns["g_fused_wide"])]
    for got, fn in pairs:
        want = fn(None, b)
        assert len(got) == len(want)
        for a, w in zip(got, want):
            a = a.view(torch.int32) if a.dtype == torch.float32 and \
                np.asarray(w).dtype == np.int32 else a
            assert_same(a, w)
    assert knn_prod_stages.verdict(1.0, 1.1).startswith(
        "g128/g64 = 1.100: bound by rows")
    assert "bound by bytes" in knn_prod_stages.verdict(1.0, 1.9)
    assert knn_prod_stages.verdict(None, 1.0) == "not measured"
    assert knn_prod_stages.verdict(-0.1, 1.0).startswith("undetermined")


# ------------------------------------------------------------- knn_chain

def test_knn_chain_equals_the_scripts_layouts():
    """Both layouts' top-8 d^2 equal the script's knn_T and knn_R on dyadic
    tables and queries (exact sums), and the two layouts agree."""
    rng = np.random.default_rng(3)
    table, c, qn = 1 << 10, 8, 200
    dy = lambda shape: (rng.integers(-64, 64, shape) / 16.0).astype(
        np.float32)
    t_lane = dy((table, 4, c))
    t_row = np.ascontiguousarray(np.transpose(t_lane, (0, 2, 1)))
    q = dy((qn, 3))
    ns = extract("knn_chain.py", {"probes", "knn_T", "knn_R"},
                 cell=jnp.asarray(knn_chain.CELL, jnp.float32), TABLE=table,
                 Q=qn, C=c, K=K, _OFFSETS=jk._OFFSETS,
                 _hash_cells=jk._hash_cells)
    lane = knn_chain.knn_lane_major(t(t_lane), t(q))
    row = knn_chain.knn_row_major(t(t_row), t(q))
    assert_same(lane, ns["knn_T"](jnp.asarray(t_lane), jnp.asarray(q)))
    assert_same(row, ns["knn_R"](jnp.asarray(t_row), jnp.asarray(q)))
    assert torch.equal(lane, row)


# -------------------------------------------------------- profile_gather

def test_profile_gather_reductions_equal_jax():
    """Rows A-H on dyadic inputs equal jnp.take(...).sum(), .at[].add,
    searchsorted, top_k and argsort, exactly."""
    rng = np.random.default_rng(4)
    dy = lambda shape: (rng.integers(-32, 32, shape) / 8.0).astype(
        np.float32)
    cap, table, q = 1 << 10, 1 << 8, 100
    x = {"src3": dy((cap, 3)), "idxA": rng.integers(0, cap, q * 27 * 96),
         "src32": dy((cap, 32)), "idxB": rng.integers(0, cap, q * 8),
         "srcC": dy((table, 384)), "idxC": rng.integers(0, table, q * 27),
         "srcC2": dy((table, 128)), "updB": dy((q * 8, 32)),
         "keys": np.sort(rng.integers(0, 1 << 12, cap)),
         "q": rng.integers(0, 1 << 12, q * 27),
         "d2": dy((q, 2592)), "d3": dy((q, 104))}
    x = {k: v.astype(np.int32) if v.dtype.kind == "i" else v
         for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want = {
        "A": j["src3"][j["idxA"]].sum(), "B": j["src32"][j["idxB"]].sum(),
        "C": j["srcC"][j["idxC"]].sum(), "C2": j["srcC2"][j["idxC"]].sum(),
        "D": jnp.zeros((cap, 32)).at[j["idxB"]].add(j["updB"]).sum(),
        "E": jnp.searchsorted(j["keys"], j["q"]).sum(),
        "F": jax.lax.top_k(j["d2"], 8)[0].sum(),
        "G": jax.lax.top_k(j["d3"], 8)[0].sum(),
        "H": jnp.argsort(j["q"]).sum()}
    rows = profile_gather.rows({k: t(v) for k, v in x.items()})
    assert [r[0] for r in rows] == list(want)
    for tag, _, call, _ in rows:
        assert float(call()) == float(want[tag]), tag


def test_profile_gather_inputs_are_the_scripts_draws():
    """inputs() draws the script's arrays in its order (scaled counts)."""
    x = profile_gather.inputs(torch.device("cpu"), scale=256)
    rng = np.random.default_rng(0)
    cap = (1 << 19) // 256
    np.testing.assert_array_equal(n(x["src3"]), rng.standard_normal(
        (cap, 3)).astype(np.float32))
    np.testing.assert_array_equal(n(x["idxA"]),
                                  rng.integers(0, cap, 97 * 27 * 96))
    assert x["keys"].shape == (cap,) and bool((x["keys"][1:]
                                               >= x["keys"][:-1]).all())


# ------------------------------------------------------- mains on the host

RUNS = {
    "knn_pallas_stages": (knn_pallas_stages, ["--points", "3000", "--rays",
                                              "32"]),
    "knn_pallas2_v5": (knn_pallas2_v5, ["--points", "3000", "--rays", "32"]),
    "knn_pallas5": (knn_pallas5, ["--points", "3000", "--rays", "32"]),
    "knn_chain": (knn_chain, ["--small"]),
    "knn_split": (knn_split, ["--points", "3000", "--queries", "100"]),
    "knn_prod_stages": (knn_prod_stages, ["--points", "2000", "--rays",
                                          "32"]),
    "knn_packed_ab": (knn_packed_ab, ["--small", "--cap", "4096", "--points",
                                      "1000", "--iters", "1", "--repeats",
                                      "1"]),
    "profile_gather": (profile_gather, ["--scale", "256"]),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_every_knn_script_runs_on_the_host(name, capsys):
    """Each main runs with --device cpu at its smallest size and times
    nothing there."""
    module, argv = RUNS[name]
    out = module.main(argv + ["--device", "cpu"])
    assert out
    text = capsys.readouterr().out
    assert "not measured (cpu)" in text
