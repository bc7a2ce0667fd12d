"""A/B of the decoder MLPs' matmul precision on the colour-stage mapping
step.

    python -m point_slam_tpu_torch.profiling.mlp_precision_ab
        [--device cuda|cpu] [--cap 524288] [--points 300000]
        [--cloud surface|sheet] [--iters 10] [--repeats 3] [--small]

The full colour-stage step of ``map_optimize`` (rays, the geometry and
colour forward, both gradients, the frustum row mask, Adam over the packed
(CAP, 72) leaf and the colour decoder: ``iter_breakdown``'s rung 7) at
bench.py's widths, on frame 0's keyframe window and a steady-state cloud
(``--cloud surface`` by default: the TPU script's sine sheet lies outside
the room's view), under ``cuda.mlp_precision`` 'highest' (IEEE f32) and
'default' (TF32 on the card; no effect on the host, so the loss delta is
exactly 0 there). Prints the loss of one ray batch under both and its
relative delta, then each variant's wall ms an iteration (CUDA events,
median and range over ``--repeats`` runs of ``--iters``) and device-busy
ms (the profiler's summed kernel time), and what 'default' saves.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from point_slam_tpu_torch.profiling import iter_breakdown as IB
from point_slam_tpu_torch.profiling import workload as W

PRECISIONS = {"highest": None, "default": "default"}


def build(dev, cap: int, points: int, cloud: str = "surface",
          small: bool = False) -> IB.Ladder:
    cfg = W.bench_config(4, small=small)
    cfg["cuda"]["point_capacity_init"] = cap
    return IB.build(cfg, dev, points, "packed", cloud)


def with_rc(b: IB.Ladder, **kw) -> IB.Ladder:
    return b._replace(rc=b.rc._replace(**kw))


def loss_delta(b: IB.Ladder) -> Dict[str, float]:
    """The colour-stage loss of one ray batch (one draw, one fill) under
    both precisions."""
    d = IB.draw(b)
    with torch.no_grad():
        hi = float(IB._loss(with_rc(b, mlp_precision=None), d, b.packed,
                            True))
        lo = float(IB._loss(with_rc(b, mlp_precision="default"), d,
                            b.packed, True))
    rel = abs(hi - lo) / max(abs(hi), 1e-9)
    print(f"loss highest {hi:.6f} | default {lo:.6f} | rel delta {rel:.2e}",
          flush=True)
    return {"highest": hi, "default": lo, "rel_delta": rel}


def run(b: IB.Ladder, iters: int = 10, repeats: int = 3) -> Dict:
    out = {"loss": loss_delta(b)}
    for name, prec in PRECISIONS.items():
        res = out[name] = IB.measure(with_rc(b, mlp_precision=prec),
                                     IB.rung_full, iters, repeats)
        print(f"full step, mlp {name:<8}: wall {W.spread_str(res['wall'])}"
              f"/iter, device busy {W.shown(res['busy_ms'])}/iter",
              flush=True)
    hi, lo = out["highest"], out["default"]
    if hi["wall"]["median"] is not None:
        print(f"\nmlp_precision='default' saves: "
              f"{hi['wall']['median'] - lo['wall']['median']:+.3f} ms/iter "
              f"wall ({hi['wall']['median']:.3f} -> "
              f"{lo['wall']['median']:.3f})", flush=True)
    if None not in (hi["busy_ms"], lo["busy_ms"]):
        print(f"mlp_precision='default' saves: "
              f"{hi['busy_ms'] - lo['busy_ms']:+.4f} ms/iter device busy "
              f"({hi['busy_ms']:.4f} -> {lo['busy_ms']:.4f})", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    W.add_cloud_args(ap)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "mlp_precision_ab")
    b = build(dev, args.cap, args.points, args.cloud, args.small)
    out = run(b, args.iters, args.repeats)
    W.save_json("mlp_precision_ab_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
