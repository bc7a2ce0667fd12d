"""Roofline of one mapping iteration on the card's peaks.

    python -m point_slam_tpu_torch.profiling.roofline [--device cuda|cpu]
        [--rays R] [--cap CAP] [--mlp-precision highest|default]
        [--trace ANALYZE_LOG --trace-iters N]

For each rung of a mapping iteration (knn, feat_gather, mlp_fwd, mlp_bwd,
composite_loss, grad_scatter, adam_sweep) ``iteration_model`` counts the
operations and bytes it must do at the bench workload's shapes, with the
TPU script's arithmetic (``profiling/roofline.py:81-168``), the decoder
FLOPs read from the port's ``models/decoders.py`` modules (every
``nn.Linear``: 2 x batch x in x out). The least time of a rung is the
largest of its matmul FLOPs over the MLP peak, its other operations over
the f32 peak, and its streamed plus gathered bytes over HBM.

The peaks are the H100 SXM data sheet's (NVIDIA, dense, at 700 W): HBM
3.35 TB/s; f32 outside the tensor cores 67 TFLOP/s; TF32 tensor cores 495
TFLOP/s; bf16 989 TFLOP/s. The MLP peak follows ``cuda.mlp_precision``:
'highest' (the port's default: IEEE f32 matmuls, TF32 off) uses the f32
peak, 'default' (TF32 blocks) the TF32 one.

Random row touches pay at least one 32-byte sector a row
(``GATHER_GRANULE``). The TPU model also held them to a measured descriptor
rate (``ROW_RATE``, 110M rows/s on the TPU); the card has no descriptor
engine (an SM's loads fetch the sectors), so that term is dropped and the
gather terms are bytes only: a true lower bound. The card's achieved row
rate is what ``gather_scatter_micro.py`` reports; it is not a bound.

The measured side buckets the CUDA kernel names of a ``trace_ops.py
analyze`` listing (``--trace``; ``trace_map_iter.py`` writes one over
``--trace-iters`` mapping iterations) by ``RUNG_SIGS``. Names no signature
takes go to ``other``, printed with their time. ``check`` holds each
measured group to its rungs' bounds: a group below its bound means the
count is wrong. Writes ``output/roofline_torch.json``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, List, Tuple

# ---- the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W) ------
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # CUDA cores, outside the tensor cores
TF32_FLOP_PER_S = 495e12        # tensor cores, dense
BF16_FLOP_PER_S = 989e12        # tensor cores, dense
GATHER_GRANULE = 32.0           # bytes a random touch moves at least

MLP_PEAKS = {"highest": F32_FLOP_PER_S, "default": TF32_FLOP_PER_S}


def _linear_flops(module, batch: int) -> int:
    """2 x batch x in x out over every nn.Linear of ``module``."""
    import torch
    return sum(2 * batch * m.in_features * m.out_features
               for m in module.modules() if isinstance(m, torch.nn.Linear))


def _decoders():
    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.models import decoders as D
    from point_slam_tpu_torch.profiling.workload import HERE
    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", "room.yaml"),
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    return D.init_decoders(cfg, 0)


def iteration_model(R=5000, ns=5, K=8, cap=1 << 17, probes=27, cell_cap=64,
                    geo_iter_ratio=0.4, mlp_precision="highest"):
    """Per-mapping-iteration operations and bytes of each rung, averaged
    over the geometry/colour stage mix (``geo_iter_ratio`` geometry-only).

    Returns ({rung: {flops_mxu, flops_vpu, hbm_bytes, gather, note}},
    mlp_peak): ``flops_mxu`` are the decoder matmuls, ``flops_vpu`` the
    other f32 operations, ``gather`` = (random touches, bytes each). The
    counts are the TPU script's; ``flops_mxu`` run at ``mlp_peak``."""
    if mlp_precision not in MLP_PEAKS:
        raise ValueError(f"iteration_model: mlp_precision {mlp_precision!r}"
                         f" not in {sorted(MLP_PEAKS)}")
    dec = _decoders()
    B = R * ns
    geo_fwd = _linear_flops(dec.geo, B)
    col_fwd = _linear_flops(dec.col, B)
    g = geo_iter_ratio
    mlp_fwd = geo_fwd + (1 - g) * col_fwd
    mlp_bwd = 2 * geo_fwd + (1 - g) * 2 * col_fwd
    row_b = 72 * 4                    # one packed feature row

    rungs = {
        "knn": {
            # per ray: probes x (cell_cap packed i32 coordinates, one
            # contiguous row a probe), d^2 against ns samples (unpack ~10
            # ops + 8 flops each), top-8 by K passes
            "gather": (R * probes, cell_cap * 4),
            "flops_vpu": R * probes * cell_cap * (ns * 18 + K * 2),
            "hbm_bytes": R * (K * 8 + ns * K * 4),   # ids + dists out
            "note": f"{probes} probes x {cell_cap}/cell packed i32",
        },
        "feat_gather": {
            "gather": (B * K, row_b),
            "flops_vpu": B * K * (72 * 2 + 8),       # weighted sum + weights
            "hbm_bytes": B * 72 * 4,                 # interpolated out
            "note": "(R*ns*K, 72) rows",
        },
        "mlp_fwd": {
            "flops_mxu": mlp_fwd,
            "hbm_bytes": B * (93 + 40) * 4,          # embeds in/out (approx)
            "note": f"B={B}, geo 32-hidden always, col 128-hidden "
                    f"{100 * (1 - g):.0f}% of iters",
        },
        "mlp_bwd": {
            "flops_mxu": mlp_bwd,
            "hbm_bytes": B * (93 + 40) * 4,
            "note": "dgrad always; col wgrad on color stage",
        },
        "composite_loss": {
            "flops_vpu": R * ns * 60,
            "hbm_bytes": R * ns * 6 * 4,
            "note": "alpha compositing + L1/L2",
        },
        "grad_scatter": {
            # scatter-add of (R*ns*K, 72) rows into the zeroed (CAP, 72)
            # gradient: a read-modify-write a row + the zeros sweep
            "gather": (2 * B * K, row_b),
            "hbm_bytes": cap * 72 * 4,
            "flops_vpu": B * K * 72,
            "note": "RMW rows + CAP-sized zeros",
        },
        "adam_sweep": {
            # masked full-buffer Adam on the packed leaf: p/m/v/g read,
            # p/m/v written + ~15 flops an element
            "hbm_bytes": 7 * cap * 72 * 4,
            "flops_vpu": 15 * cap * 72,
            "note": f"7 x (CAP={cap}, 72) sweeps",
        },
    }
    for r in rungs.values():
        r.setdefault("flops_mxu", 0)
        r.setdefault("flops_vpu", 0)
        r.setdefault("gather", (0, 1))
        r.setdefault("hbm_bytes", 0)
    return rungs, MLP_PEAKS[mlp_precision]


def gather_bytes_effective(gather) -> float:
    """Random touches below the 32-byte sector pay the whole sector."""
    n, elem = gather
    return n * max(elem, GATHER_GRANULE)


def ideal_ms(rung, mlp_peak) -> Tuple[float, Dict[str, float]]:
    """The least time of one rung: the largest of its matmul, f32 and
    byte terms (streamed + gathered bytes over HBM)."""
    t_mxu = rung["flops_mxu"] / mlp_peak
    t_vpu = rung["flops_vpu"] / F32_FLOP_PER_S
    t_stream = rung["hbm_bytes"] / HBM_BYTES_PER_S
    t_gather = gather_bytes_effective(rung["gather"]) / HBM_BYTES_PER_S
    return 1e3 * max(t_mxu, t_vpu, t_stream + t_gather), {
        "mxu_ms": 1e3 * t_mxu, "vpu_ms": 1e3 * t_vpu,
        "stream_ms": 1e3 * t_stream, "gather_ms": 1e3 * t_gather}


def table(rungs, mlp_peak) -> List[Dict]:
    rows = []
    for name, r in rungs.items():
        t, parts = ideal_ms(r, mlp_peak)
        rows.append({"rung": name, "ideal_ms": t, **parts,
                     "flops_mxu": r["flops_mxu"], "flops_vpu": r["flops_vpu"],
                     "hbm_bytes": r["hbm_bytes"],
                     "gather_bytes": gather_bytes_effective(r["gather"]),
                     "note": r["note"]})
    return rows


# ---- measured side: CUDA kernel names -> rungs ---------------------------
# From the card's traces of the mapping loop (trace_map_iter.py): the ray
# top-k kernel and torch.topk's; cuBLAS/CUTLASS GEMMs (sgemm, xmma, gemv,
# split-K reductions); index_put_'s accumulate (the gather's backward);
# the gathers (advanced indexing, index_select, torch.gather); cub's and
# ATen's sorts (masked_median, index_put_'s key sort); elementwise,
# reduction and scan (compositing's cumprod) kernels; copies and fills.
# cub's select (torch.nonzero) is left to ``other``.
RUNG_SIGS = [
    ("knn", re.compile(r"ray_topk|topk|TopK|radixSelect|radixFindKth", re.I)),
    ("mlp", re.compile(r"gemm|gemv|xmma|cutlass|splitKreduce|cublas", re.I)),
    ("grad_scatter", re.compile(r"indexing_backward|index_put|index_add|"
                                r"indexFunc|scatter_add|atomic", re.I)),
    ("feat_gather", re.compile(r"index_elementwise|indexSelect|gather|"
                               r"index_kernel", re.I)),
    ("sort", re.compile(r"sort|segmented", re.I)),
    ("elementwise", re.compile(r"elementwise|reduce_kernel|Reduce|"
                               r"unrolled|vectorized|fill|cat_|CatArray|"
                               r"softplus|where|copy|scan", re.I)),
    ("memcpy", re.compile(r"^Memcpy|^Memset", re.I)),
]

# Each measured group and the rungs whose bounds it must not beat.
CHECKS = [
    (("knn",), ("knn",)),
    (("mlp",), ("mlp_fwd", "mlp_bwd")),
    (("feat_gather", "grad_scatter", "sort"), ("feat_gather",
                                               "grad_scatter")),
    (("elementwise", "memcpy", "other"), ("composite_loss", "adam_sweep")),
]

# one kernel row of trace_ops.analyze (the TPU script's format)
ROW_RE = re.compile(r"^\s+([\d.]+) ms\s+[\d.]+%\s+x(\d+)\s+(\S+)")


def bucket_of(name: str) -> str:
    for bucket, sig in RUNG_SIGS:
        if sig.search(name):
            return bucket
    return "other"


def parse_trace(path_or_lines) -> Dict[str, List]:
    """A trace_ops.analyze listing (a path or its lines) ->
    {bucket: [ms, count, {kernel name: ms}]}."""
    lines = (open(path_or_lines).read().splitlines()
             if isinstance(path_or_lines, str) else path_or_lines)
    buckets: Dict[str, List] = {}
    for line in lines:
        m = ROW_RE.match(line)
        if not m:
            continue
        ms, cnt, name = float(m.group(1)), int(m.group(2)), m.group(3)
        b = buckets.setdefault(bucket_of(name), [0.0, 0, {}])
        b[0] += ms
        b[1] += cnt
        b[2][name] = b[2].get(name, 0.0) + ms
    return buckets


def check(buckets, rows, n_iters: int) -> List[Dict]:
    """Each CHECKS group's measured ms an iteration against its rungs'
    summed least time; ``ok`` False where the measurement is below."""
    ideal = {r["rung"]: r["ideal_ms"] for r in rows}
    out = []
    for group, rungs in CHECKS:
        measured = sum(buckets.get(b, [0.0])[0] for b in group) / n_iters
        bound = sum(ideal[r] for r in rungs)
        out.append({"buckets": list(group), "rungs": list(rungs),
                    "measured_ms": measured, "bound_ms": bound,
                    "share": bound / measured if measured else None,
                    "ok": measured >= bound})
    return out


def print_table(rows, mlp_peak) -> float:
    print(f"{'rung':<15} {'ideal':>8} {'mlp':>8} {'f32':>8} {'stream':>8} "
          f"{'gather':>8}  note  (peaks: MLP {mlp_peak / 1e12:.0f} TFLOP/s, "
          f"f32 {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s, HBM "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    for r in rows:
        print(f"{r['rung']:<15} {r['ideal_ms']:>8.4f} {r['mxu_ms']:>8.4f} "
              f"{r['vpu_ms']:>8.4f} {r['stream_ms']:>8.4f} "
              f"{r['gather_ms']:>8.4f}  {r['note']}")
    total = sum(r["ideal_ms"] for r in rows)
    print(f"sum of per-rung lower bounds: {total:.4f} ms/iter")
    return total


def print_measured(buckets, checks, n_iters: int) -> None:
    print(f"\nmeasured buckets (device ms an iteration over {n_iters}):")
    for k, v in sorted(buckets.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k:<15} {v[0] / n_iters:>10.4f} ms  x{v[1]}")
    for name, ms in sorted(buckets.get("other", [0, 0, {}])[2].items(),
                           key=lambda kv: -kv[1]):
        print(f"  other: {ms / n_iters:.4f} ms  {name}")
    for c in checks:
        print(f"  {'+'.join(c['buckets']):<32} measured "
              f"{c['measured_ms']:.4f} ms >= bound {c['bound_ms']:.4f} ms "
              f"({'+'.join(c['rungs'])}): {c['ok']}")


def main(argv=None):
    from point_slam_tpu_torch.profiling import workload as W
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--rays", type=int, default=5000)
    ap.add_argument("--cap", type=int, default=1 << 17)
    ap.add_argument("--probes", type=int, default=27)
    ap.add_argument("--geo-iter-ratio", type=float, default=0.4)
    ap.add_argument("--mlp-precision", default="highest",
                    choices=sorted(MLP_PEAKS))
    ap.add_argument("--trace", default=None,
                    help="a trace_ops.analyze listing to bucket")
    ap.add_argument("--trace-iters", type=int, default=1,
                    help="mapping iterations the listing covers")
    args = ap.parse_args(argv)
    W.device(args.device, "roofline")
    rungs, peak = iteration_model(R=args.rays, cap=args.cap,
                                  probes=args.probes,
                                  geo_iter_ratio=args.geo_iter_ratio,
                                  mlp_precision=args.mlp_precision)
    rows = table(rungs, peak)
    total = print_table(rows, peak)
    out = {"model": rows, "total_ideal_ms": total, "mlp_peak_used": peak,
           "peaks": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                     "f32_flop_per_s": F32_FLOP_PER_S,
                     "tf32_flop_per_s": TF32_FLOP_PER_S,
                     "bf16_flop_per_s": BF16_FLOP_PER_S,
                     "gather_granule_B": GATHER_GRANULE}}
    if args.trace:
        buckets = parse_trace(args.trace)
        checks = check(buckets, rows, args.trace_iters)
        print_measured(buckets, checks, args.trace_iters)
        out["trace_buckets_ms"] = {k: {"ms": v[0] / args.trace_iters,
                                       "events": v[1]}
                                   for k, v in buckets.items()}
        out["checks"] = checks
    print(f"\nwritten: {W.save_json('roofline_torch.json', out)}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
