"""CLI entry point of the port:

    python -m point_slam_tpu_torch.run <config.yaml> [--input_folder DIR]
        [--output DIR] [--stop N] [--device cuda|cpu]

Mirrors ``run.py`` for the options the port supports: --stop N truncates
the sequence to N+1 frames (and sets the keyframe cadence to 10, as
``run.py`` does). Prints the run summary and the trajectory error.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description="point_slam_tpu_torch runner")
    parser.add_argument("config", type=str, help="path to scene config yaml")
    parser.add_argument("--input_folder", type=str, default=None)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--stop", type=lambda s: None if s == "None" else int(s),
                        default=None, help="stop after n frames")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda; the run fails "
                        "without CUDA unless --device cpu is given)")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--resume", action="store_true")
    args = parser.parse_args(argv)
    if args.wandb or args.resume:
        raise NotImplementedError(
            "point_slam_tpu_torch does not implement the metrics sink "
            "(--wandb) or checkpoints (--resume) yet")

    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.slam import PointSLAM
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate

    cfg = load_config(args.config,
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    if args.stop:
        cfg["mapping"]["keyframe_every"] = 10
    out = args.output or cfg["data"]["output"]
    if args.stop is None and not args.output:
        out = os.path.join(out, datetime.now().strftime("%Y%m%d_%H%M%S"))

    slam = PointSLAM(cfg, input_folder=args.input_folder, output=out,
                     device=args.device)
    summary = slam.run(stop=args.stop)
    print(f"finished {summary['n_frames']} frames on {slam.device}, "
          f"{summary['n_points']} neural points, timing {summary['timing']}")
    for align in (True, False):
        ate = evaluate_ate(summary["gt_c2w_list"],
                           summary["estimate_c2w_list"], align=align)
        print(f"ATE ({'aligned' if align else 'no-align'}) rmse "
              f"{ate['absolute_translational_error.rmse']:.5f} m")
    return summary


if __name__ == "__main__":
    main()
