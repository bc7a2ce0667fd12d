"""The ``knn_probes`` x ``mlp_precision`` grid on the full mapping step.

    python -m point_slam_tpu_torch.profiling.probes_ab
        [--device cuda|cpu] [--cap 524288] [--points 300000]
        [--cloud surface|sheet] [--iters 10] [--repeats 3] [--small]

Probe slots a ray {36, 27} x the decoder MLPs' precision {'highest',
'default' (TF32 on the card)} on ``mlp_precision_ab``'s step (the
colour-stage step with Adam, ``iter_breakdown``'s rung 7), the same inputs
for every cell: wall ms an iteration (median and range) and device-busy
ms, against probes 36 at 'highest'. Before timing, the ray top-k kernel
(K1 on the packed cell table) is held EQUAL to its plain version
(``ops/knn.py::ray_topk_reference``) at each probe count on the step's
own samples; its block size and shared memory depend on P. Quality is
judged apart, by ``quality_gate`` probes.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

from point_slam_tpu_torch.profiling import iter_breakdown as IB
from point_slam_tpu_torch.profiling import mlp_precision_ab as MP
from point_slam_tpu_torch.profiling import workload as W

PROBES = (36, 27)


def hold(b: IB.Ladder) -> Dict:
    """K1 against its plain version at each probe count; raises when they
    differ."""
    out = {}
    d = IB.draw(b)
    for p in PROBES:
        res = out[p] = IB.hold_ray_topk(MP.with_rc(b, knn_probes=p), d,
                                        "packed")
        print(f"[probes_ab] {res['name']} at P={p}, {res['rays']} rays: "
              f"equal to plain: {res['equal']} (max abs err "
              f"{res['max_abs_err']}, tolerance 0)", flush=True)
        if not res["equal"]:
            raise AssertionError(f"{res['name']} differs from plain at P={p}")
    return out


def run(b: IB.Ladder, iters: int = 10, repeats: int = 3) -> Dict:
    out = {"hold": hold(b), "grid": {}}
    for p in PROBES:
        for name, prec in MP.PRECISIONS.items():
            tag = f"probes={p} mlp={name}"
            res = out["grid"][tag] = IB.measure(
                MP.with_rc(b, knn_probes=p, mlp_precision=prec),
                IB.rung_full, iters, repeats)
            print(f"{tag:<24}: wall {W.spread_str(res['wall'])}/iter, device "
                  f"busy {W.shown(res['busy_ms'])}/iter", flush=True)
    grid = out["grid"]
    base = grid[f"probes={PROBES[0]} mlp=highest"]
    print("\n| probes | mlp | wall ms/iter | vs base | device ms/iter | "
          "vs base |")
    print("|---|---|---|---|---|---|")
    for tag, res in grid.items():
        p, m = tag.split()
        w, bw = res["wall"]["median"], base["wall"]["median"]
        d, bd = res["busy_ms"], base["busy_ms"]
        cells = [f"{w:.3f}" if w is not None else "not measured (cpu)",
                 f"{w - bw:+.3f}" if w is not None else "-",
                 f"{d:.4f}" if d is not None else "not measured",
                 f"{d - bd:+.4f}" if None not in (d, bd) else "-"]
        print(f"| {p[7:]} | {m[4:]} | " + " | ".join(cells) + " |",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    W.add_cloud_args(ap)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "probes_ab")
    b = MP.build(dev, args.cap, args.points, args.cloud, args.small)
    out = run(b, args.iters, args.repeats)
    W.save_json("probes_ab_torch.json",
                {"hold": {str(k): v for k, v in out["hold"].items()},
                 "grid": out["grid"]})
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
