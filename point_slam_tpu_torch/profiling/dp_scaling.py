"""The data-parallel collective audit: what the port's data parallelism
puts on the wire, and how each rank's work falls with the world size.

    python -m point_slam_tpu_torch.profiling.dp_scaling [--bench-shapes]
        [--device cuda|cpu] [--small]

The port of ``profiling/dp_scaling.py``. The JAX script compiles
``map_optimize`` on a forced 8-device CPU mesh and reads the optimized
HLO; eager PyTorch has no HLO, and the port runs one process per rank
(``parallel/dist.py``). So each world size W runs as a gloo group of W
processes over a FileStore of its own, with a finite timeout (on the
card all of them share the one card: NCCL refuses two ranks on one
device); one set of spawned processes serves every W
(``parallel/dist.py``'s ``Ranks``: the first W of them join the group,
then leave it), so they start once. Every rank builds the same mapper
(``build``: the synthetic room mapped at frames 0 and 1, the FIRST
``map_optimize`` call's arguments captured and copied before the call,
as the JAX script's shim does) and then, on that captured call:

1. **The collective audit** (``audit``). A recorder on
   ``torch.distributed``'s collectives (``Recorder``; ``parallel/dist.py``
   calls them through the module attribute) logs the op, dtype, shape and
   bytes of every collective the rank issues during one call. The rule:
   (a) every mapping iteration has exactly one ``all_reduce`` whose flat
   bucket carries the packed leaf's live-prefix gradient, ``n_rows*72 +
   n_params + 3`` elements (the decoders' parameters, the exposure and BA
   leaves where they are on, the 3 logged statistics; ``mapper.py``'s
   ``all_reduce_flat``); (b) no other collective touches a 72-wide
   operand or as many elements as ``n_rows*72``, the fatal pattern (a
   gather of the cloud); (c) the bytes of an iteration are (a)'s count
   times 4, exactly. **The JAX rule differs in (c)**: GSPMD all-reduces
   the whole (CAP, 72) leaf, so its bytes follow CAP; the port reduces
   only the live prefix (kept on purpose, ROADMAP §3), so its bytes
   follow the cloud's points and are the same at every W.
2. **Replicated state**: after the call every rank's packed leaf,
   decoders and statistics are bit-equal (digests gathered after the
   recorder stops, so the check's own collective is not audited). This
   takes the place of the JAX script's sharding summary.
3. **The per-rank FLOP ratio**: ``torch.utils.flop_counter`` over one
   captured iteration, W against W=1, about 1/W at the fixed global
   batch. It counts the matmul-class ops only (the MLPs' GEMMs); JAX's
   ``cost_analysis`` counted every XLA op.
4. **The step-time curve** at W = 1, 2, 4, 8 (not with
   ``--bench-shapes``): the captured call timed once after a warm call.
   The ranks share one card (or the host's cores), so the curve catches
   pathologies only; it is not a scaling result.

Toy shapes: 96x128 frames, CAP 2^15 (max 2^17), a 2^13-bucket table,
2048 global rays, window 3, 4 iterations. ``--bench-shapes``: bench.py's
680x1200, CAP 2^17, 5000 rays, window 12, no near-cloud sampling, at
W = 1 and 8, audit and FLOPs only. ``--small``: the toy cut to a 48x64
camera at W = 1 and 2, for the host. Writes
``output/torch/dp_scaling.json`` or ``output/torch/dp_scaling_benchshape.json``,
prints ``AUDIT PASS`` or ``AUDIT FAIL`` and exits 3 on FAIL.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import os
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch.parallel import dist as pdist
from point_slam_tpu_torch.profiling import workload as W

GLOBAL_PIXELS = 2048        # the fixed global ray batch at every world size
# the world sizes of the toy, of --bench-shapes and of --small
WORLDS = {"toy": (1, 2, 4, 8), "bench": (1, 8), "small": (1, 2)}
# the positions of map_optimize's arguments the report reads
N_ITERS_POS = 13
GEO_BOUND_POS = 12
# each recorded collective -> (the position, the keyword) of its operand:
# the tensor it sends (the input list of the list forms)
COLLECTIVES = {"all_reduce": (0, "tensor"), "broadcast": (0, "tensor"),
               "send": (0, "tensor"), "recv": (0, "tensor"),
               "all_gather": (1, "tensor"),
               "all_gather_into_tensor": (1, "input_tensor"),
               "reduce_scatter": (1, "input_list"),
               "reduce_scatter_tensor": (1, "input"),
               "all_to_all": (1, "input_tensor_list"),
               "all_to_all_single": (1, "input")}
NOTE = ("the ranks share one device (or the host's cores): step_s catches "
        "pathologies only; the audit and the per-rank FLOP ratio carry the "
        "information")
FLOPS_NOTE = ("torch.utils.flop_counter counts matmul-class ops only (the "
              "MLPs' GEMMs); JAX's cost_analysis counted every XLA op")


def config(world: int, bench_shapes: bool = False, small: bool = False):
    """The JAX script's configuration (``dp_scaling.py:80-126``) for the
    port, at ``data_parallel`` = world; ``small``: the toy cut to a 48x64
    camera, 256 rays and 2 iterations (one a stage), CAP 2^13, for a run
    on the host."""
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(W.HERE, "configs", "Synthetic",
                                   "room.yaml"),
                      os.path.join(W.HERE, "configs", "point_slam.yaml"))
    if bench_shapes:
        W.override(cfg, W.bench_widths())
        cfg["synthetic"]["n_frames"] = 4
        cfg["mapping"].update({"iters": 4, "iters_first": 4,
                               "geo_iter_first": 2, "keyframe_every": 2})
        cfg["cuda"].update({"point_capacity_init": 1 << 17,
                            "data_parallel": world})
    else:
        cfg["synthetic"].update({"n_frames": 4, "angular_step": 0.02})
        cfg["cam"].update({"H": 96, "W": 128, "fx": 90.0, "fy": 90.0,
                           "cx": 63.5, "cy": 47.5})
        cfg["mapping"].update({
            "pixels": GLOBAL_PIXELS, "pixels_adding": 2048,
            "pixels_based_on_color_grad": 512, "iters": 4,
            "iters_first": 4, "geo_iter_first": 2,
            "mapping_window_size": 3, "keyframe_every": 2})
        cfg["cuda"].update({"point_capacity_init": 1 << 15,
                            "point_capacity_max": 1 << 17,
                            "grid_table_size": 1 << 13,
                            "data_parallel": world})
    if small:
        cfg["cam"].update(W.SMALL_CAM)
        cfg["mapping"].update({
            "pixels": 256, "pixels_adding": 256,
            "pixels_based_on_color_grad": 64, "iters": 2, "iters_first": 2,
            "geo_iter_first": 0})
        cfg["cuda"].update({"point_capacity_init": 1 << 13,
                            "point_capacity_max": 1 << 15,
                            "grid_table_size": 1 << 12})
    cfg["verbose"] = False
    cfg["data"]["output"] = os.path.join(W.OUTPUT, "torch", "dp_scaling")
    return cfg


# ------------------------------------------------------------ the capture

class Captured(NamedTuple):
    """One ``map_optimize`` call's arguments, copied before the call."""
    args: tuple
    kwargs: Dict[str, Any]


def snapshot(x):
    """A copy of ``x`` that no call can change: tensors cloned, generators
    at the same state, modules deep-copied, containers copied through."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, torch.Generator):
        g = torch.Generator(device=x.device)
        g.set_state(x.get_state())
        return g
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(snapshot(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(snapshot(v) for v in x)
    if isinstance(x, dict):
        return {k: snapshot(v) for k, v in x.items()}
    return x


def build(cfg, device="cuda"):
    """A mapper on ``cfg`` (``config``; its ``data_parallel`` the size of
    the caller's process group, or 1 without one) that mapped frames 0 and
    1, and the first ``map_optimize`` call's arguments (frame 0's).
    Returns (mapper, Captured)."""
    from point_slam_tpu_torch import mapper as M
    from point_slam_tpu_torch.datasets import get_dataset
    from point_slam_tpu_torch.models import decoders as D
    pdist.check_group(cfg)
    dev = torch.device(device)
    ds = get_dataset(cfg)
    mapper = M.Mapper(cfg, D.init_decoders(cfg, 0, dev), len(ds),
                      np.random.default_rng(0), dev)
    captured = []
    inner = M.map_optimize

    def shim(*args, **kwargs):
        if not captured:
            # copied BEFORE the call: it steps the decoders in place and
            # advances the generator (the fused path steps the leaf in
            # place too)
            captured.append(Captured(snapshot(args), snapshot(kwargs)))
        return inner(*args, **kwargs)

    M.map_optimize = shim
    try:
        for idx in (0, 1):
            _, color, depth, c2w = ds[idx]
            mapper.map_frame(idx, color, depth, c2w, c2w)
    finally:
        M.map_optimize = inner
    return mapper, captured[0]


def call(cap: Captured, **over):
    """The captured call on fresh copies of its arguments (``over``
    replaces keyword arguments, e.g. ``n_iters``): (map_optimize's
    outputs, the decoders it stepped)."""
    from point_slam_tpu_torch import mapper as M
    args, kwargs = snapshot(cap.args), snapshot(cap.kwargs)
    names = {"geo_iter_bound": GEO_BOUND_POS, "n_iters": N_ITERS_POS}
    args = list(args)
    for k in list(over):
        if k in names:
            args[names[k]] = over.pop(k)
    return M.map_optimize(*args, **{**kwargs, **over}), args[2]


def bucket_elements(mapper, cap: Captured) -> Dict[str, int]:
    """The parts of the all-reduced bucket of one mapping iteration
    (``mapper.py``'s ``all_reduce_flat``): the packed leaf's live rows,
    the decoders' parameters that take a gradient, the exposure and BA
    leaves where they are on, and the 3 logged statistics."""
    ms, dec = cap.args[0], cap.args[2]
    params = list(dec.col.parameters())
    if not ms.fix_geo_decoder:
        params += list(dec.geo.parameters())
    extra = 0
    if cap.kwargs.get("exposure") is not None:
        extra += cap.kwargs["exposure"].numel()
    if cap.kwargs.get("ba") is not None:
        extra += cap.kwargs["ba"]["cams"].numel()
    n_rows = cap.kwargs.get("n_live")
    n_rows = cap.args[3].shape[0] if n_rows is None else int(n_rows)
    return {"n_rows": n_rows, "n_params": sum(p.numel() for p in params),
            "extra": extra}


# ------------------------------------------------------- the collectives

class Recorder:
    """Records every collective issued through ``torch.distributed``
    while it is entered: op, dtype, shape, element count and bytes of the
    operand it sends (the shape of an input list's first tensor, the
    count and bytes of the whole list)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._saved = []

    def _wrap(self, op, fn):
        pos, key = COLLECTIVES[op]

        def recorded(*args, **kwargs):
            t = args[pos] if len(args) > pos else kwargs[key]
            parts = list(t) if isinstance(t, (list, tuple)) else [t]
            numel = sum(p.numel() for p in parts)
            self.records.append({
                "op": op, "dtype": str(parts[0].dtype).replace("torch.", ""),
                "shape": list(parts[0].shape), "parts": len(parts),
                "numel": int(numel),
                "bytes": int(numel * parts[0].element_size())})
            return fn(*args, **kwargs)
        return recorded

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed import distributed_c10d as c10d
        for op in COLLECTIVES:
            fn = getattr(dist, op, None)
            if fn is None:
                continue
            shim = self._wrap(op, fn)
            for mod in (dist, c10d):
                if getattr(mod, op, None) is fn:
                    self._saved.append((mod, op, fn))
                    setattr(mod, op, shim)
        return self

    def __exit__(self, *exc):
        for mod, op, fn in self._saved:
            setattr(mod, op, fn)
        self._saved = []


def audit(records: Sequence[Dict[str, Any]], n_rows: int, n_params: int,
          n_iters: int, extra: int = 0) -> Dict[str, Any]:
    """The port's collective rule over one ``map_optimize`` call of
    ``n_iters`` iterations (see the module's docstring): (a) exactly one
    all_reduce an iteration of ``n_rows*72 + n_params + extra + 3``
    elements, (b) no other collective with a 72-wide operand or
    ``n_rows*72`` elements or more, (c) the bytes of an iteration equal
    to (a)'s count times 4. A pure function of the records."""
    bucket = n_rows * pc.PACK_W + n_params + extra + 3
    grad = [r for r in records if r["op"] == "all_reduce"
            and r["numel"] == bucket]
    fatal = [r for r in records if r["op"] != "all_reduce"
             and (r["shape"][-1:] == [pc.PACK_W]
                  or r["numel"] >= n_rows * pc.PACK_W)]
    total = sum(r["bytes"] for r in records)
    by_op: Dict[str, int] = {}
    for r in records:
        by_op[r["op"]] = by_op.get(r["op"], 0) + 1
    checks = {"a_one_grad_bucket_an_iteration": len(grad) == n_iters,
              "b_no_cloud_collective": not fatal,
              "c_bytes_equal_the_bucket": total == n_iters * bucket * 4}
    return {"n_collectives": len(records), "by_op": by_op,
            "grad_bucket_all_reduces": len(grad), "fatal": fatal,
            "bucket_elements": bucket,
            "bytes_an_iteration": total / max(n_iters, 1),
            "formula_bytes_an_iteration": bucket * 4, "checks": checks,
            "ok": all(checks.values())}


# ------------------------------------------------------------ the rank

def state_digest(out, dec) -> str:
    """SHA-256 of the packed leaf, the statistics and the decoders."""
    h = hashlib.sha256()
    for t in (out[0], out[1], *dec.state_dict().values()):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def iteration_flops(cap: Captured) -> int:
    """Matmul-class FLOPs of one captured iteration on this rank."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        call(cap, n_iters=1)
    return int(fc.get_total_flops())


def time_step(cap: Captured, dev) -> float:
    """Seconds of the captured call, timed once after a warm call, from
    a barrier to a device sync."""
    call(cap)
    W.sync(dev)
    pdist.barrier()
    t0 = time.perf_counter()
    call(cap)
    W.sync(dev)
    return time.perf_counter() - t0


def rank_job(payload: Dict[str, Any]) -> Dict[str, Any]:
    """One rank's part (under the caller's group of ``payload["world"]``
    ranks, or none at world 1): build, the audited call, the replicas'
    digests, the FLOPs of an iteration and (``timed``) the step time.
    Returns the rank's record, its K1 launches included."""
    import torch.distributed as dist
    from point_slam_tpu_torch.ops import knn
    dev = torch.device(payload["device"])
    world = int(payload["world"])
    for k in knn.LAUNCHES:
        knn.LAUNCHES[k] = 0
    cfg = config(world, payload.get("bench_shapes", False),
                 payload.get("small", False))
    mapper, cap = build(cfg, dev)
    parts = bucket_elements(mapper, cap)
    n_iters = int(cap.args[N_ITERS_POS])
    with Recorder() as rec:
        out, dec = call(cap)
        W.sync(dev)
    verdict = audit(rec.records, parts["n_rows"], parts["n_params"],
                    n_iters, parts["extra"])
    digest = state_digest(out, dec)
    digests = [digest]
    if pdist.active():
        digests = [None] * pdist.world()
        dist.all_gather_object(digests, digest)
    flops = iteration_flops(cap)
    step_s = time_step(cap, dev) if payload.get("timed", True) else None
    return {"rank": pdist.rank(), "world": world, "cap": cap.args[3].shape[0],
            "n_iters": n_iters, "geo_iter_bound": int(cap.args[GEO_BOUND_POS]),
            "r_max": cap.args[0].r_max, "f_max": cap.args[0].f_max,
            **parts, "records": rec.records, "audit": verdict,
            "replicas_equal": len(set(digests)) == 1,
            "flops_an_iteration": flops, "step_s": step_s,
            "launches": dict(knn.LAUNCHES)}


# ------------------------------------------------------------ the report

def summarise(ranks: List[Dict[str, Any]], flops1: Optional[int]):
    """One world size's row from its ranks' records."""
    r0 = ranks[0]
    bytes_it = {rec["audit"]["bytes_an_iteration"] for rec in ranks}
    row = {"world": r0["world"], "cap": r0["cap"], "n_iters": r0["n_iters"],
           "global_pixels": r0["r_max"], "n_rows": r0["n_rows"],
           "n_params": r0["n_params"], "extra": r0["extra"],
           "audit_ok": all(rec["audit"]["ok"] for rec in ranks),
           "bytes_an_iteration": (bytes_it.pop() if len(bytes_it) == 1
                                  else sorted(bytes_it)),
           "formula_bytes_an_iteration":
               r0["audit"]["formula_bytes_an_iteration"],
           "jax_rule_bytes_an_iteration": r0["cap"] * pc.PACK_W * 4,
           "by_op": r0["audit"]["by_op"],
           "fatal": [f for rec in ranks for f in rec["audit"]["fatal"]],
           "checks": {k: all(rec["audit"]["checks"][k] for rec in ranks)
                      for k in r0["audit"]["checks"]},
           "replicas_equal": all(rec["replicas_equal"] for rec in ranks),
           "flops_an_iteration": r0["flops_an_iteration"],
           "flops_ratio_vs_w1": (r0["flops_an_iteration"] / flops1
                                 if flops1 else None),
           "step_s": (max(rec["step_s"] for rec in ranks)
                      if r0["step_s"] is not None else None),
           "launches": {k: sum(rec["launches"][k] for rec in ranks)
                        for k in r0["launches"]},
           "launches_min_rank": {k: min(rec["launches"][k] for rec in ranks)
                                 for k in r0["launches"]}}
    return row


def show(row) -> None:
    ratio = row["flops_ratio_vs_w1"]
    step = ("" if row["step_s"] is None else
            f"; step {row['step_s']:.3f} s / {row['n_iters']} iterations "
            f"(ranks share the device: pathology check only)")
    print(f"[dp_scaling] W={row['world']}: audit "
          f"{'PASS' if row['audit_ok'] else 'FAIL'} {row['checks']}; "
          f"collectives {row['by_op']}; all-reduced "
          f"{row['bytes_an_iteration']} bytes an iteration a rank, formula "
          f"({row['n_rows']}*72 + {row['n_params']} + {row['extra']} + 3)*4 "
          f"= {row['formula_bytes_an_iteration']} (the JAX rule's CAP*72*4 "
          f"at CAP {row['cap']}: {row['jax_rule_bytes_an_iteration']}, not "
          f"a measurement); replicas bit-equal {row['replicas_equal']}; "
          f"matmul FLOPs an iteration a rank {row['flops_an_iteration']}"
          + ("" if ratio is None else f", {ratio:.4f} of W=1's") + step,
          flush=True)


def worlds(bench_shapes: bool, small: bool) -> Sequence[int]:
    return WORLDS["bench" if bench_shapes else "small" if small else "toy"]


def rank_pool(dev: torch.device, n: int) -> pdist.Ranks:
    """``n`` processes for the world sizes up to ``n`` on ``dev``, the
    kernels built first (so that the ranks only load them)."""
    if dev.type == "cuda":
        from point_slam_tpu_torch.ops import _build
        _build.build()
    return pdist.Ranks(n, dev, os.path.join(W.OUTPUT, "torch",
                                            "dp_scaling_ranks"))


def run(bench_shapes: bool, dev: torch.device, small: bool = False,
        pool: Optional[pdist.Ranks] = None) -> Dict[str, Any]:
    """Every world size of the shapes' ``WORLDS`` (W=1 first, for the FLOP
    baseline) as a gloo group of its own, in ``pool`` (``rank_pool``
    when None); the report."""
    if pool is None:
        with rank_pool(dev, max(worlds(bench_shapes, small))) as own:
            return run(bench_shapes, dev, small, own)
    rows, flops1 = [], None
    for world in worlds(bench_shapes, small):
        payload = {"bench_shapes": bench_shapes, "small": small,
                   "timed": not bench_shapes, "world": world,
                   "device": str(dev)}
        recs = pool.run(rank_job, payload, world)
        if world == 1:
            flops1 = recs[0]["flops_an_iteration"]
        rows.append(summarise(recs, flops1))
        show(rows[-1])
    formula = {r["formula_bytes_an_iteration"] for r in rows}
    ok = all(r["audit_ok"] and r["replicas_equal"] for r in rows) \
        and len(formula) == 1
    return {"note": NOTE, "flops_note": FLOPS_NOTE,
            "shapes": ("bench: CAP 2^17, 5000-ray batch, 680x1200 frames"
                       if bench_shapes else
                       "small: CAP 2^13, 256-ray batch, 48x64 frames"
                       if small else
                       "toy: CAP 2^15, 2048-ray batch, 96x128 frames"),
            "device": str(dev), "rows": rows,
            "same_formula_at_every_world": len(formula) == 1, "ok": ok}


def main(argv=None, pool: Optional[pdist.Ranks] = None) -> Dict[str, Any]:
    """The audit at the world sizes of the shapes ``argv`` picks;
    ``pool``: processes to run them in (``rank_pool``; started here
    when None)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--bench-shapes", action="store_true",
                    help="bench.py's shapes, audit and FLOPs only, at W=1 "
                         "and 8")
    ap.add_argument("--small", action="store_true",
                    help="the toy cut to a 48x64 camera, 256 rays and 2 "
                         "iterations, at W=1 and 2 (a run on the host)")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "dp_scaling")
    report = run(args.bench_shapes, dev, args.small, pool)
    name = ("dp_scaling_benchshape.json" if args.bench_shapes
            else "dp_scaling.json")
    report["path"] = W.save_json(os.path.join("torch", name), report)
    print("AUDIT", "PASS" if report["ok"] else "FAIL", flush=True)
    return report


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 3)
