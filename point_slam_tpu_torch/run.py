"""CLI entry point of the port:

    python -m point_slam_tpu_torch.run <config.yaml> [--input_folder DIR]
        [--output DIR] [--stop N] [--resume] [--no_eval]
        [--wandb | --no_wandb] [--device cuda|cpu]

Mirrors ``run.py``: --stop N truncates the sequence to N+1 frames and sets
the checkpoint cadence to N and the keyframe cadence to 10; a run without
--stop, --output or --resume writes under a timestamped directory of
``data.output``. --resume continues from the newest ``ckpts/*.npz`` of the
output directory (or of its newest timestamped subdirectory). After the
run it saves a final checkpoint and, unless --no_eval, runs the end-of-run
evaluation (tools/evaluate.py). Runs on CUDA unless --device cpu is given.

Data parallelism: ``cuda.data_parallel: N`` in the config and

    torchrun --nproc_per_node N -m point_slam_tpu_torch.run <config.yaml>

(NCCL, rank r on cuda:r; with --device cpu, gloo on the host). Rank 0
chooses the output directory and alone writes into it; the evaluation runs
on rank 0 after the other ranks have ended.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from datetime import datetime

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def find_resume_checkpoint(out: str):
    """(checkpoint path, output dir) of the newest checkpoint under
    ``out/ckpts``, else under ``out/<timestamp>/ckpts``."""
    ckpts = sorted(glob.glob(os.path.join(out, "ckpts", "*.npz")))
    if ckpts:
        return ckpts[-1], out
    nested = sorted(glob.glob(os.path.join(out, "*", "ckpts", "*.npz")))
    if not nested:
        raise SystemExit(f"--resume: no checkpoint found under {out}")
    return nested[-1], os.path.dirname(os.path.dirname(nested[-1]))


def main(argv=None):
    parser = argparse.ArgumentParser(description="point_slam_tpu_torch runner")
    parser.add_argument("config", type=str, help="path to scene config yaml")
    parser.add_argument("--input_folder", type=str, default=None)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("--stop", type=lambda s: None if s == "None" else int(s),
                        default=None, help="stop after n frames")
    parser.add_argument("--no_eval", action="store_true",
                        help="skip the end-of-run evaluation")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest checkpoint in the "
                             "output dir")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda; the run fails "
                        "without CUDA unless --device cpu is given)")
    args = parser.parse_args(argv)

    import torch.distributed
    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.parallel import dist as pdist

    cfg = load_config(args.config,
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    if args.wandb:
        cfg["wandb"] = True
    if args.no_wandb:
        cfg["wandb"] = False
    if args.stop:
        cfg["mapping"]["ckpt_freq"] = args.stop
        cfg["mapping"]["keyframe_every"] = 10
    device = pdist.init_from_env(args.device)
    try:
        return _run(args, cfg, device)
    finally:
        if pdist.active():
            torch.distributed.destroy_process_group()


def _run(args, cfg, device):
    import torch.distributed
    from point_slam_tpu_torch.parallel import dist as pdist
    from point_slam_tpu_torch.slam import PointSLAM
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate

    out = args.output or cfg["data"]["output"]
    if args.stop is None and not args.output and not args.resume:
        out = os.path.join(out, datetime.now().strftime("%Y%m%d_%H%M%S"))
    if pdist.active():
        # rank 0's clock names the directory of every rank
        sent = [out]
        torch.distributed.broadcast_object_list(sent, src=0)
        out = sent[0]
    resume_from = None
    if args.resume:
        resume_from, out = find_resume_checkpoint(out)

    slam = PointSLAM(cfg, input_folder=args.input_folder, output=out,
                     device=device)
    summary = slam.run(stop=args.stop, resume_from=resume_from)
    print(f"finished {summary['n_frames']} frames on {slam.device}, "
          f"{summary['n_points']} neural points, timing {summary['timing']}")

    t0 = time.perf_counter()
    ckpt_path = os.path.join(out, "ckpts",
                             f"{summary['n_frames'] - 1:05d}.npz")
    slam.checkpoint(ckpt_path, idx=summary["n_frames"] - 1)
    if not slam.writer:
        return {**summary, "eval": {}, "output": out}
    print(f"checkpoint saved to {ckpt_path} "
          f"({time.perf_counter() - t0:.1f}s)")
    slam.mlog.log({"time_ckpt_final": time.perf_counter() - t0})

    for align in (True, False):
        ate = evaluate_ate(summary["gt_c2w_list"],
                           summary["estimate_c2w_list"], align=align)
        print(f"ATE ({'aligned' if align else 'no-align'}) rmse "
              f"{ate['absolute_translational_error.rmse']:.5f} m")
    results = {}
    if not args.no_eval:
        from point_slam_tpu_torch.tools.evaluate import run_end_of_run_eval
        t0 = time.perf_counter()
        results = run_end_of_run_eval(slam, out)
        slam.mlog.log({"time_eval": time.perf_counter() - t0})
    slam.mlog.close()
    return {**summary, "eval": results, "output": out}


if __name__ == "__main__":
    main()
