"""Does a colour-stage mapping iteration pay the neighbour gathers twice?

    python -m point_slam_tpu_torch.profiling.cond_dup_probe
        [--device cuda|cpu] [--small]

The port of ``profiling/cond_dup_probe.py``. On the TPU the question was
XLA's: whether conditional code motion hoisted the kNN and feature gathers
out of the per-iteration stage ``lax.cond`` and also kept them inside the
colour branch (the JAX answer: ``output/cond_dup_probe.json``). Eager
PyTorch has no conditional to hoist out of, so the port answers from what
one iteration of each stage actually runs. On the mapper that
``dp_scaling.build`` captures at ``config(1, bench_shapes=True)``
(680x1200, CAP 2^17, 5000 rays, window 12), one geometry-stage and one
colour-stage iteration of the captured ``map_optimize``
(``geo_iter_bound`` 0 and -1; the same rays, from the same generator
state) each run once to warm up and once under ``torch.profiler`` with
``record_shapes``. For each stage it counts
the ops and kernels that carry the JAX probe's signatures, derived from
the configuration (``signatures``):

* the feature gather ``packed[idx]`` (``renderer.py``): ``aten::index`` of
  the (CAP, 72) leaf; its rows, rays x samples x k (200,000 from
  (131072, 72) at bench.py's config), read off the backward's values;
* the backward scatter into (CAP, 72) (``aten::_index_put_impl_``);
* the cell-table gathers outside the kernel: ``aten::index`` of a
  (table+1, C) plane, which on the card come only from the per-sample
  ``grid_knn_subset`` fallback for rays whose samples leave the probed box
  (on the host the plain version of the ray top-k gathers its probe rows
  the same way). JAX's (135648, 64) table gathers have no eager
  counterpart under K1: the kernel reads the table rows itself;
* K1 (``ray_topk_packed``): its wrapper's launches and the trace's
  ``ray_topk`` kernels, in place of JAX's ``tpu_custom_call``.

Writes ``output/torch/cond_dup_probe.json`` (the JAX package's
``output/cond_dup_probe.json`` is its own record) with the per-stage
counts and the answer: whether a colour iteration runs any of them more
often than a geometry iteration. ``--small``: dp_scaling's small toy
(48x64) on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict


from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch.profiling import dp_scaling as DPS
from point_slam_tpu_torch.profiling import workload as W

STAGES = (("geometry", 0), ("colour", -1))   # (stage, geo_iter_bound)
COUNTS = ("feat_gather", "scatter", "table_gather", "k1_launches",
          "k1_kernels")


def signatures(cfg) -> Dict[str, Any]:
    """The JAX probe's signatures for ``cfg`` (one rank): the feature
    gather's rows (rays x samples x k) from the (CAP, 72) leaf, the
    scatter back into it, and the cell-table planes' shape."""
    cu = cfg["cuda"]
    return {"feat_rows": (cfg["mapping"]["pixels"]
                          * cfg["rendering"]["N_surface"]
                          * cfg["pointcloud"]["nn_num"]),
            "leaf": [cu["point_capacity_init"], pc.PACK_W],
            "table": [cu["grid_table_size"] + 1, cu["grid_max_per_cell"]]}


def count(prof, sig, launches: int) -> Dict[str, Any]:
    """The stage's counts from one traced iteration."""
    from torch.autograd import DeviceType
    out = {k: 0 for k in COUNTS}
    out["k1_launches"] = launches
    out["scatter_rows"] = []
    out["device_kernels"] = 0
    us = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out["device_kernels"] += 1
            us += e.device_time_total
            out["k1_kernels"] += "ray_topk" in e.name
            continue
        shapes = e.input_shapes or []
        first = list(shapes[0]) if shapes else None
        if e.name == "aten::index":
            out["feat_gather"] += first == sig["leaf"]
            out["table_gather"] += first == sig["table"]
        elif e.name == "aten::_index_put_impl_" and first == sig["leaf"]:
            out["scatter"] += 1
            vals = list(shapes[2]) if len(shapes) > 2 else []
            rows = 1
            for d in vals[:-1]:
                rows *= d
            out["scatter_rows"].append(rows)
    out["device_ms"] = us / 1e3 if out["device_kernels"] else None
    return out


def trace_stage(cap: DPS.Captured, bound: int, sig, dev) -> Dict[str, Any]:
    """One iteration of the stage that ``bound`` picks: a warm call, then
    a traced one (on the card up to three, until one holds device
    activity)."""
    from torch.profiler import ProfilerActivity, profile
    from point_slam_tpu_torch.ops import knn
    DPS.call(cap, n_iters=1, geo_iter_bound=bound)
    W.sync(dev)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for attempt in range(3 if dev.type == "cuda" else 1):
        k0 = knn.LAUNCHES["ray_topk_packed"]
        with profile(activities=acts, record_shapes=True) as prof:
            DPS.call(cap, n_iters=1, geo_iter_bound=bound)
            W.sync(dev)
        res = count(prof, sig, knn.LAUNCHES["ray_topk_packed"] - k0)
        if res["device_kernels"] or dev.type != "cuda":
            return res
        print(f"[cond_dup_probe] window {attempt + 1}: no device activity "
              "recorded", flush=True)
    return res


def probe(cfg, dev) -> Dict[str, Any]:
    """Both stages' counts on ``cfg``'s captured call, and the answer."""
    _, cap = DPS.build(cfg, dev)
    sig = signatures(cfg)
    stages = {name: trace_stage(cap, bound, sig, dev)
              for name, bound in STAGES}
    more = [k for k in COUNTS if stages["colour"][k] > stages["geometry"][k]]
    answer = (f"yes: a colour iteration runs {', '.join(more)} more often "
              f"than a geometry iteration" if more else
              "no: a colour iteration runs each gather, the scatter and K1 "
              "no more often than a geometry iteration")
    return {"signatures": sig, "stages": stages, "duplicated": more,
            "answer": answer, "device": str(dev),
            "note": ("JAX's (135648, 64) table gathers have no eager "
                     "counterpart under K1, which reads the table rows "
                     "itself; table_gather counts the grid_knn_subset "
                     "fallback's (and, on the host, the plain ray top-k's)")}


def report(res: Dict[str, Any]) -> None:
    sig = res["signatures"]
    print(f"[cond_dup_probe] signatures: feature gather {sig['feat_rows']} "
          f"rows of {sig['leaf'][1]} from {tuple(sig['leaf'])}, scatter "
          f"into it, table planes {tuple(sig['table'])}", flush=True)
    for name, st in res["stages"].items():
        print(f"[cond_dup_probe] {name} iteration: feature gathers "
              f"{st['feat_gather']}, scatters {st['scatter']} (rows "
              f"{st['scatter_rows']}), table gathers outside the kernel "
              f"{st['table_gather']}, K1 launches {st['k1_launches']} "
              f"(kernels in the trace {st['k1_kernels']}); device kernels "
              f"{st['device_kernels']}, device busy "
              f"{W.shown(st['device_ms'])}", flush=True)
    print(f"[cond_dup_probe] {res['answer']}", flush=True)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--small", action="store_true",
                    help="dp_scaling's small toy (48x64) for the host")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "cond_dup_probe")
    cfg = DPS.config(1, bench_shapes=not args.small, small=args.small)
    res = probe(cfg, dev)
    report(res)
    res["path"] = W.save_json(os.path.join("torch", "cond_dup_probe.json"),
                              res)
    print(f"[cond_dup_probe] written: {res['path']}", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
