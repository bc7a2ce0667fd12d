"""Golden-run determinism harness of the port (the JAX package's
test_deterministic.py).

    python -m point_slam_tpu_torch.tools.determinism              # vs golden
    python -m point_slam_tpu_torch.tools.determinism --self_check # run twice
    python -m point_slam_tpu_torch.tools.determinism --gen_ref    # write it
        [--device cpu|cuda] [--n_frames N]

Runs test_deterministic.py's short SLAM sequence (the synthetic room at
48x64, 10 frames, 300 tracking and 400 mapping rays) through the port's
PointSLAM under ``torch.use_deterministic_algorithms(True)`` and compares
the cloud's geometry and colour features, the GT trajectory and the
estimated one bit for bit: against the port's own golden file
``tests/data_torch/determinism_ref.npz`` (the port's bits are not the JAX
package's), or with --self_check (or without a golden file) against a
second run in the same process. Prints a line per array and DETERMINISTIC
or NON-DETERMINISTIC; exits 0 or 1. The golden file also records the torch
version and ``torch.backends.cpu.get_cpu_capability()`` of the host that
wrote it (``host_of``): the CPU's vector kernels, and so the bits, follow
them.

The harness runs on CUDA unless --device cpu is given. The golden file
is the CPU's (written with --device cpu; its ``device`` says so): on
another device the harness self-checks instead, as without a golden
file. On the CPU the runs use CPU_THREADS intra-op threads (the sums'
order follows the thread count). On CUDA the harness sets
``CUBLAS_WORKSPACE_CONFIG`` before the first CUDA call, as deterministic
cuBLAS requires.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Dict

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(HERE, "tests", "data_torch", "determinism_ref.npz")
COMPARE_KEYS = ["geo_feats", "col_feats", "gt_c2w_list", "estimate_c2w_list"]
CUBLAS_WORKSPACE = ":4096:8"
CPU_THREADS = 2


def config(n_frames: int = 10):
    """test_deterministic.py's configuration, with the JAX package's
    ``tpu:`` capacities under ``cuda:``."""
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", "room.yaml"),
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    cfg["synthetic"].update({"n_frames": n_frames, "angular_step": 0.02})
    cfg["cam"].update({"H": 48, "W": 64, "fx": 40.0, "fy": 40.0,
                       "cx": 31.5, "cy": 23.5})
    cfg["tracking"].update({"pixels": 300, "iters": 10,
                            "ignore_edge_W": 5, "ignore_edge_H": 5})
    cfg["mapping"].update({
        "pixels": 400, "pixels_adding": 200, "pixels_based_on_color_grad": 50,
        "iters": 20, "iters_first": 30, "geo_iter_first": 10,
        "mapping_window_size": 4, "keyframe_every": 4, "every_frame": 2,
        "color_refine": False, "vis_freq": 10_000,
    })
    cfg["tracking"]["vis_freq"] = 10_000
    cfg["cuda"].update({"point_capacity_init": 1 << 13,
                        "point_capacity_max": 1 << 16,
                        "grid_table_size": 1 << 14, "grid_max_per_cell": 64})
    cfg["verbose"] = False
    return cfg


def run_once(n_frames: int = 10, device="cpu") -> Dict[str, np.ndarray]:
    """One run under deterministic algorithms (CPU_THREADS intra-op
    threads on the CPU); the arrays of COMPARE_KEYS. Its output tree goes
    to a temporary directory, removed afterwards."""
    from point_slam_tpu_torch import pointcloud as pc
    from point_slam_tpu_torch.slam import PointSLAM
    threads = torch.get_num_threads()
    was = torch.are_deterministic_algorithms_enabled()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(CPU_THREADS)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="determinism_run_") as out:
            slam = PointSLAM(config(n_frames), output=out, device=device)
            summary = slam.run()
            slam.mlog.close()
            m = slam.mapper
            n = m.n_points_host
            return {
                "geo_feats": m.cloud.packed[:n, pc.GEO_SL].cpu().numpy(),
                "col_feats": m.cloud.packed[:n, pc.COL_SL].cpu().numpy(),
                "gt_c2w_list": summary["gt_c2w_list"],
                "estimate_c2w_list": summary["estimate_c2w_list"],
            }
    finally:
        torch.use_deterministic_algorithms(was)
        torch.set_num_threads(threads)


def host_of(device="cpu") -> Dict[str, str]:
    """What a run's bits follow: the device type, the torch version and
    the vector ISA that its CPU kernels dispatch to."""
    return {"device": torch.device(device).type,
            "torch_version": torch.__version__,
            "cpu_capability": torch.backends.cpu.get_cpu_capability()}


def compare(a, b, label_a="run1", label_b="run2") -> bool:
    ok = True
    for k in COMPARE_KEYS:
        if a[k].shape != b[k].shape:
            print(f"MISMATCH {k}: shapes {a[k].shape} vs {b[k].shape}")
            ok = False
        elif not np.array_equal(a[k], b[k]):
            d = np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))
            print(f"MISMATCH {k}: max abs diff {d.max():.3e}")
            ok = False
        else:
            print(f"match    {k}: {a[k].shape} bit-exact")
    print(f"{'DETERMINISTIC' if ok else 'NON-DETERMINISTIC'} "
          f"({label_a} vs {label_b})")
    return ok


def load_golden(path: str = GOLDEN) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gen_ref", action="store_true")
    parser.add_argument("--self_check", action="store_true")
    parser.add_argument("--n_frames", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu, the golden file's")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)

    r1 = run_once(args.n_frames, args.device)
    if args.gen_ref:
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        np.savez_compressed(GOLDEN, **r1, **host_of(args.device))
        print(f"golden reference written to {GOLDEN} "
              f"({host_of(args.device)})")
        return 0
    golden = load_golden() if os.path.exists(GOLDEN) else None
    dev = torch.device(args.device).type
    if args.self_check or golden is None or str(golden["device"]) != dev:
        if not args.self_check:
            print(f"no golden file of the {dev}; falling back to self-check "
                  f"(run twice)")
        r2 = run_once(args.n_frames, args.device)
        return 0 if compare(r1, r2) else 1
    return 0 if compare(r1, golden, "run", "golden") else 1


if __name__ == "__main__":
    sys.exit(main())
