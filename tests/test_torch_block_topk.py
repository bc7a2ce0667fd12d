"""Port parity for the kNN selection study: the block top-k
(point_slam_tpu_torch/ops/block_topk.py) against the ten Pallas bodies of
profiling/knn_pallas*.py, knn_layout_micro.py, knn_quad_micro.py and K2's
body, and the study's probe generators against the scripts'.

The scripts cannot be imported (they build their scenes, and some run
their benchmarks, at module level, and most read a ``GridIndex.table``
that the JAX package no longer has), so each body is reached by AST: the
named definitions are parsed out of the script and executed alone, in a
namespace that holds jax, jnp and the script's constants at small sizes.
The bodies run through pallas_call in interpret mode, with the scripts'
own BlockSpecs (P1-P4 through the scripts' own pallas_call wrappers).

Tolerance 0: keys equal, ids equal as int32 bit patterns (+inf ids of
empty winners included), probes equal."""

import ast
import functools
import os
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from point_slam_tpu.ops import knn as jk
from point_slam_tpu_torch.ops import block_topk as bt
from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.profiling import knn_pallas as kp1
from point_slam_tpu_torch.profiling import knn_pallas2 as kp2
from point_slam_tpu_torch.profiling import knn_pallas3 as kp3
from point_slam_tpu_torch.profiling import knn_study as ks

from torch_parity import HERE, n, t

PROFILING = os.path.join(HERE, "profiling")
# pallas_call as the scripts call it, in interpret mode on the CPU
PL = types.SimpleNamespace(BlockSpec=pl.BlockSpec,
                           pallas_call=functools.partial(pl.pallas_call,
                                                         interpret=True))


def extract(script, names, **consts):
    """Execute only the module-level definitions of profiling/<script>
    named in ``names`` (functions, assignments, and loops by their loop
    variable), in order, in a namespace of jax, jnp, np, pl (interpret
    mode), pltpu and ``consts``."""
    path = os.path.join(PROFILING, script)
    with open(path) as f:
        tree = ast.parse(f.read(), path)

    def name_of(node):
        if isinstance(node, ast.FunctionDef):
            return node.name
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                        ast.Name):
            return node.targets[0].id
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            return node.target.id
        return None

    body = [node for node in tree.body if name_of(node) in names]
    assert {name_of(node) for node in body} == set(names), names
    ns = {"jax": jax, "jnp": jnp, "np": np, "pl": PL, "pltpu": pltpu,
          **consts}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


# --------------------------------------------------------------- inputs

R, NS, K, P, C = 64, 3, 8, 4, 16
PC = P * C
BLK = 32


def candidate_planes(seed, fill):
    """x, y, z, id planes (R, P, C) of candidates around each ray's
    samples, a share ``fill`` of the slots filled (the rest +inf, as the
    table's empty slots); some filled lanes repeat an earlier lane's
    coordinates, so equal d^2 must break by lane. q (R, NS, 3)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 1, (R, 1, 3)) + rng.normal(0, 0.02, (R, NS, 3))
    pos = q[:, :1, None, :] + rng.normal(0, 0.1, (R, P, C, 3))
    pos[:, :, 1::7] = pos[:, :, 0:1]            # exact repeats
    ids = rng.integers(0, 1 << 20, (R, P, C)).astype(np.float32)
    empty = rng.random((R, P, C)) >= fill
    pos[empty] = np.inf
    ids[empty] = np.inf
    planes = [pos[..., a].astype(np.float32) for a in range(3)] + [ids]
    return planes, q.astype(np.float32)


def in_layout(planes, layout):
    """The planes (each (R, P, C)) as the layout's candidate array."""
    flat = [p.reshape(R, PC) for p in planes]
    if layout == "planes":
        return flat
    if layout == "row":
        return np.concatenate(flat, axis=1)
    if layout == "component":
        return np.stack(flat)
    return np.stack(planes, axis=2).reshape(R, P * len(planes) * C)


def port(cand, layout, nplanes, q, lane_mask, k=K):
    """block_topk_reference (and the CPU dispatcher) on the layout's
    views."""
    cand_t = [t(c) for c in cand] if layout == "planes" else t(cand)
    views = bt.layout_views(cand_t, layout, R, P, C, nplanes)
    qt = t(q)
    want = bt.block_topk_reference(views, qt, k, lane_mask)
    got = bt.block_topk(views, qt.unbind(-1), k, lane_mask)
    for a, b in zip(want, got):
        assert (a is None and b is None) or torch.equal(
            a.view(torch.int32), b.view(torch.int32))
    return want


def specs(width, blk=BLK):
    return pl.BlockSpec((blk, width), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)


def outs(k=K, ids=True):
    shapes = [jax.ShapeDtypeStruct((R, NS * k), jnp.int32)]
    if ids:
        shapes.append(jax.ShapeDtypeStruct((R, NS * k), jnp.float32))
    return shapes


# One case per Pallas body: (layout, planes it reads, lane mask, runner).
# A runner takes (candidate array in the layout, q) and returns the body's
# outputs through pallas_call in interpret mode.

def run_p1(cand, q):
    ns = extract("knn_pallas.py", {"_topk_kernel", "pallas_topk"},
                 NS=NS, K=K, _LANE_MASK=4095, R_BLK=BLK, P=P, C=C)
    x, y, z = (jnp.asarray(c) for c in cand)
    return (ns["pallas_topk"](x, y, z, *(jnp.asarray(q[..., a])
                                         for a in range(3)), R),)


def _row_script(script, kernel, wrapper, **consts):
    def run(cand, q):
        ns = extract(script, {kernel, wrapper}, NS=NS, K=K, R_BLK=BLK,
                     C=C, **consts)
        out = ns[wrapper](jnp.asarray(cand),
                          *(jnp.asarray(q[..., a]) for a in range(3)), R)
        return out if isinstance(out, tuple) else (out,)
    return run


run_p2 = _row_script("knn_pallas2.py", "_kernel", "pallas_topk",
                     P=P, _LANE_MASK=8191)
run_p2b = _row_script("knn_pallas2.py", "_kernel2", "pallas_topk2",
                      P2=P, _LANE_MASK=8191)
run_p3 = _row_script("knn_pallas3.py", "_kernel3", "pallas_topk3",
                     P3=P, _LANE_MASK3=4095)
run_p4 = _row_script("knn_pallas4.py", "_kernel4", "pallas_topk4",
                     PC3=PC, _LANE_MASK3=4095)


def run_p5b(cand, q):
    """knn_layout_micro.py variant_b's call: one (4, BLK, P*C) block."""
    ns = extract("knn_layout_micro.py", {"_kernel4"}, _RAY_BLK=BLK)
    bs_c = pl.BlockSpec((4, BLK, PC), lambda i: (0, i, 0),
                        memory_space=pltpu.VMEM)
    return PL.pallas_call(
        ns["_kernel4"](NS, K, PC, 4095), grid=(R // BLK,),
        in_specs=[bs_c] + [specs(NS)] * 3, out_specs=[specs(NS * K)] * 2,
        out_shape=outs())(jnp.asarray(cand),
                          *(jnp.asarray(q[..., a]) for a in range(3)))


def _four_planes(kernel):
    def run(cand, q):
        return PL.pallas_call(
            kernel, grid=(R // BLK,), in_specs=[specs(PC)] * 4
            + [specs(NS)] * 3, out_specs=[specs(NS * K)] * 2,
            out_shape=outs())(*(jnp.asarray(c) for c in cand),
                              *(jnp.asarray(q[..., a]) for a in range(3)))
    return run


def run_p5c(cand, q):
    ns = extract("knn_layout_micro.py", {"_kernel_sep"})
    return _four_planes(ns["_kernel_sep"](NS, K, PC, 4095))(cand, q)


def run_p6p(cand, q):
    ns = extract("knn_quad_micro.py", {"planes_kernel"}, lane_mask=4095)
    return _four_planes(ns["planes_kernel"](NS, K))(cand, q)


def run_p6q(cand, q):
    ns = extract("knn_quad_micro.py", {"quad_kernel"}, _P_RAY=P, C=C,
                 lane_mask=4095)
    return PL.pallas_call(
        ns["quad_kernel"](NS, K), grid=(R // BLK,),
        in_specs=[specs(P * 4 * C)] + [specs(NS)] * 3,
        out_specs=[specs(NS * K)] * 2, out_shape=outs())(
            jnp.asarray(cand), *(jnp.asarray(q[..., a]) for a in range(3)))


def run_k2_row(cand, q):
    """K2's body (ops/knn.py::_ray_topk_kernel) handed the [X|Y|Z|ID] row
    as four column blocks: what knn_layout_micro.py's variant A meant."""
    planes = [pl.BlockSpec((BLK, PC), lambda i, j=j: (i, j),
                           memory_space=pltpu.VMEM) for j in range(4)]
    c = jnp.asarray(cand)
    return PL.pallas_call(
        jk._ray_topk_kernel(NS, K, PC, 4095), grid=(R // BLK,),
        in_specs=planes + [specs(NS)] * 3, out_specs=[specs(NS * K)] * 2,
        out_shape=outs())(c, c, c, c,
                          *(jnp.asarray(q[..., a]) for a in range(3)))


BODIES = {
    "P1": ("planes", 3, 4095, run_p1),
    "P2": ("row", 4, 8191, run_p2),
    "P2'": ("row", 4, 8191, run_p2b),
    "P3": ("row", 4, 4095, run_p3),
    "P4": ("row", 3, 4095, run_p4),
    "P5b": ("component", 4, 4095, run_p5b),
    "P5c": ("planes", 4, 4095, run_p5c),
    "P6q": ("quad", 4, 4095, run_p6q),
    "P6p": ("planes", 4, 4095, run_p6p),
    "K2-row": ("row", 4, 4095, run_k2_row),
}


@pytest.mark.parametrize("fill", [0.6, 0.03], ids=["dense", "sparse"])
@pytest.mark.parametrize("body", list(BODIES))
def test_block_topk_reference_equals_the_pallas_body(body, fill):
    layout, nplanes, mask, runner = BODIES[body]
    planes, q = candidate_planes(7 if fill > 0.5 else 8, fill)
    cand = in_layout(planes[:nplanes], layout)
    got = runner(cand, q)
    want = port(cand, layout, nplanes, q, mask)
    np.testing.assert_array_equal(n(want[0]), np.asarray(got[0]))
    assert len(got) == (2 if nplanes == 4 else 1)
    if nplanes == 4:
        np.testing.assert_array_equal(n(want[1].view(torch.int32)),
                                      np.asarray(got[1]).view(np.int32))
    short = (np.asarray(got[0]) >= 0x7F800000).mean()
    if fill < 0.5:          # most samples have fewer than k candidates
        assert short > 0.3, short
        if nplanes == 4:    # and their empty winners carry +inf ids
            assert np.isinf(np.asarray(got[1])).mean() > 0.3
    else:
        assert short == 0


def test_p2_prime_runs_under_its_own_mask():
    """knn_pallas2.py::_kernel2 runs P2*C = 2560 lanes under the mask 8191
    of the 4096-lane v4, where the port's _lane_mask(2560) would give 4095
    and other keys: the wrapper takes the mask as given.

    At this width XLA's CPU code contracts some of the body's d^2 into
    FMAs, whose rounding can move a key across a quantisation step, so
    the coordinates are multiples of 2^-10 in [-1, 1): every difference
    is below 2^11 quanta, so d^2 stays below 2^24 quanta^2 and is exact
    in f32 under any contraction."""
    r, p2, c = BLK, 40, 64
    rng = np.random.default_rng(3)
    q = (rng.integers(-1024, 1024, (r, NS, 3)) / 1024).astype(np.float32)
    cand = (rng.integers(-1024, 1024, (r, 4 * p2 * c)) / 1024).astype(
        np.float32)
    cand[:, 3 * p2 * c:] = rng.integers(0, 1000, (r, p2 * c))
    ns = extract("knn_pallas2.py", {"_kernel2", "pallas_topk2"}, NS=NS,
                 K=K, R_BLK=BLK, C=c, P2=p2, _LANE_MASK=8191)
    keys, ids = ns["pallas_topk2"](
        jnp.asarray(cand), *(jnp.asarray(q[..., a]) for a in range(3)), r)
    views = bt.layout_views(t(cand), "row", r, p2, c, 4)
    want = bt.block_topk_reference(views, t(q), K, 8191)
    np.testing.assert_array_equal(n(want[0]), np.asarray(keys))
    np.testing.assert_array_equal(n(want[1]), np.asarray(ids))
    assert tk._lane_mask(p2 * c) == 4095
    other = bt.block_topk_reference(views, t(q), K, 4095)[0]
    assert not torch.equal(other, want[0])


# --------------------------------------------------------------- probes

TABLE, CELL = 1 << 12, 0.2


def probe_queries(seed=3, r=96):
    """Ray samples clustered within 0.04*depth; the first rays spread
    over several cells (non-compact boxes, every extent pattern)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (r, 3))
    dirs = rng.normal(size=(r, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    depth = rng.uniform(1.5, 4.0, r)
    z = depth[:, None] * np.linspace(0.98, 1.02, 5)
    q = (centers - dirs * depth[:, None])[:, None, :] \
        + dirs[:, None, :] * z[..., None]
    q[:6] = centers[:6, None, :] + np.linspace(-0.5, 0.5, 5)[:, None] \
        * np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1],
                    [1, 1, 1]])[:, None, :] * 0.3
    return q.astype(np.float32)


def script_probes():
    common = dict(TABLE=TABLE, CELLJ=jnp.asarray(CELL, jnp.float32),
                  _hash_cells=jk._hash_cells)
    p1 = extract("knn_pallas.py", {"ray_probes"}, _OFFSETS=jk._OFFSETS,
                 **common)
    p2 = extract("knn_pallas2.py", {"_OFF64", "box_probes",
                                    "box_probes_compact"},
                 P=64, P2=40, R=96, **common)
    p3 = extract("knn_pallas3.py", {"OFF_NP", "PERMS", "NVALID", "pat",
                                    "PERMS_J", "SLOT_OK", "box_probes_v6",
                                    "box_probes_v7"},
                 P3=48, _OFF64=p2["_OFF64"], **common)
    return p1, p2, p3


def test_probe_generators_equal_the_scripts():
    q = probe_queries()
    jq, tq = jnp.asarray(q), t(q)
    p1, p2, p3 = script_probes()
    index = types.SimpleNamespace(cell_size=jnp.asarray(CELL, jnp.float32))
    pairs = [
        (kp1.ray_probes(tq, CELL, TABLE, 48),
         p1["ray_probes"](jq, index, 96, 48)),
        (kp2.box_probes(tq, CELL, TABLE), p2["box_probes"](jq)),
        (kp2.box_probes_compact(tq, CELL, TABLE),
         p2["box_probes_compact"](jq)),
        (kp3.box_probes_v6(tq, CELL, TABLE), p3["box_probes_v6"](jq)),
        (kp3.box_probes_v7(tq, CELL, TABLE), p3["box_probes_v7"](jq)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(n(got), np.asarray(want))
    # the spread rays leave the box: sentinels, and several patterns
    assert (n(pairs[2][0]) == TABLE).any()
    # the script's PERMS/SLOT_OK tables are _build_probe_perms(48)
    perms, slot_ok = tk._build_probe_perms(48)
    np.testing.assert_array_equal(p3["PERMS"], perms)
    np.testing.assert_array_equal(np.asarray(p3["SLOT_OK"]), slot_ok)


def test_box_probes_v7_is_the_production_box_probes():
    tq = t(probe_queries(seed=4))
    np.testing.assert_array_equal(
        n(kp3.box_probes_v7(tq, CELL, TABLE)),
        n(tk._box_probes(tq, CELL, TABLE, 48)[0]))


# ------------------------------------------------------ against K1-K3's

def test_block_topk_on_k2s_gathered_planes_equals_ray_topk_reference():
    """Gathering K2's planes and selecting from the block gives what
    ray_topk_reference gives reading the table."""
    rng = np.random.default_rng(5)
    pts = np.full((1 << 15, 3), 1e6, np.float32)
    pts[:20000] = rng.uniform(-2, 2, (20000, 3))
    index = tk.build_grid_index(t(pts), 20000, CELL, TABLE, 64)
    q = t(probe_queries(seed=5))
    probes, _ = tk._box_probes(q, CELL, TABLE, 27)
    r, p = probes.shape
    planes = tk.index_planes(index)
    cand = [pl_[probes.long()].reshape(r, p * 64) for pl_ in planes]
    mask = tk._lane_mask(p * 64)
    got = bt.block_topk_reference(
        bt.layout_views(cand, "planes", r, p, 64, 4), q, 8, mask)
    want = tk.ray_topk_reference(probes, planes, q, 8, mask)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert (got[0] < 0x7F800000).float().mean() > 0.5


# ------------------------------------------------------------ dispatcher

def test_block_topk_on_cpu_is_the_plain_version_and_counts_nothing():
    planes, q = candidate_planes(9, 0.5)
    views = tuple(t(p) for p in planes)
    before = dict(bt.LAUNCHES)
    keys, ids = bt.block_topk(views, t(q), K, 4095)
    assert bt.LAUNCHES == before
    want = bt.block_topk_reference(views, t(q), K, 4095)
    assert torch.equal(keys, want[0]) and torch.equal(ids, want[1])
    assert bt.block_topk(views[:3], t(q), K, 4095)[1] is None
    k3 = keys.reshape(R, NS, K)
    assert (k3[..., 1:] > k3[..., :-1]).all()


def test_block_topk_refuses_meta_tensors_and_k_past_the_lanes():
    views = tuple(torch.zeros((2, 1, 4), device="meta") for _ in range(4))
    with pytest.raises(RuntimeError, match="unsupported device"):
        bt.block_topk(views, torch.zeros((2, 5, 3), device="meta"), 4, 3)
    cpu = tuple(torch.zeros((2, 1, 4)) for _ in range(4))
    with pytest.raises(ValueError, match="k=5"):
        bt.block_topk(cpu, torch.zeros((2, 5, 3)), 5, 3)
    with pytest.raises(ValueError, match="lane_mask"):
        bt.block_topk_reference(cpu, torch.zeros((2, 5, 3)), 4, 2)
    with pytest.raises(ValueError, match="layout"):
        bt.layout_views(torch.zeros(8), "diagonal", 2, 1, 4, 1)


# ----------------------------------------------------------------- study

def test_knn_study_on_cpu_prints_a_line_for_every_variant(capsys):
    rows = ks.main(["--device", "cpu", "--points", "3000", "--rays", "32",
                    "--iters", "1"])
    out = capsys.readouterr().out
    names = ["v0", "v3", "v4", "v5", "v6", "v7", "v8", "v8b", "A", "B", "C",
             "planes", "quad", "ray_grid_knn f32", "ray_grid_knn packed"]
    lines = out.strip().splitlines()
    assert len(lines) == len(rows) == 19
    for name in names:
        assert any(line.startswith(f"[study] {name} ") for line in lines), \
            name
    assert all("pipeline not measured (cpu)" in line for line in lines)
    match = {(r["name"], r["scene"], r["p"]): r["match_pct"] for r in rows}
    # at this size the sheet's ray-shared variants all find the same
    # neighbours (nearly v0's), and the layouts of one scene select the
    # same neighbours
    sheet = {m for (name, scene, _), m in match.items()
             if scene == "sine-sheet" and name not in ("v0",
                                                       "ray_grid_knn packed")}
    assert len(sheet) == 1 and sheet.pop() > 99.0
    assert match[("A", "gaussian-slab", 36)] == match[
        ("B", "gaussian-slab", 36)] == match[("C", "gaussian-slab", 36)]
    assert match[("planes", "random-rays", 36)] == match[
        ("quad", "random-rays", 36)]
