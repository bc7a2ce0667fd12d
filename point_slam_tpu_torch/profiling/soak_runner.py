"""A long run under a stall watchdog, resumed from its newest checkpoint
after every interruption.

    python -m point_slam_tpu_torch.profiling.soak_runner [config]
        [--output output/torch/scannet_scale/run]
        [--log-dir output/torch/soak] [--max-attempts 20]
        [--stall-s 900] [--poll-s 60] [--device cuda|cpu]
        [--kill-after-checkpoint] [-- <more run arguments>]

Runs ``python -m point_slam_tpu_torch.run <config> --output <output>``
(``config`` defaults to ``configs/Synthetic/room_scannet_scale.yaml``,
the 5000-frame soak with a checkpoint every 500 frames) with its output in
``<log-dir>/run_<attempt>.log``. A run whose log stops growing for
``--stall-s`` seconds is killed (terminate, then kill after 10 s) and the
next attempt resumes it with ``--resume`` from its newest checkpoint, up
to ``--max-attempts`` attempts. Before each attempt a health check runs a
256x256 matmul on the device in a child process with a time limit; an
unhealthy card is waited for. Without a card the runner raises: a soak
never falls back to the host (``--device cpu`` asks for the host).
``--kill-after-checkpoint`` kills the first attempt once after its first
checkpoint (an injected stall: the resume path on demand). Every event goes
to ``<log-dir>/soak.log``, whose kill and resume lines ``soak_summary``
collects.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional

from point_slam_tpu_torch.profiling import workload as W

HERE = W.HERE
DEFAULT_CONFIG = os.path.join(HERE, "configs", "Synthetic",
                              "room_scannet_scale.yaml")
DEFAULT_OUTPUT = os.path.join(W.OUTPUT, "torch", "scannet_scale", "run")
DEFAULT_LOG_DIR = os.path.join(W.OUTPUT, "torch", "soak")
HEALTH = ("import sys, torch\n"
          "x = torch.ones((256, 256), device=sys.argv[1])\n"
          "assert float((x @ x)[0, 0]) == 256.0\n")


def health(device: str, timeout_s: float = 180.0) -> bool:
    """A 256x256 matmul on ``device`` in a child process, within
    ``timeout_s`` (start-up and the card's first call included)."""
    try:
        r = subprocess.run([sys.executable, "-c", HEALTH, device],
                           capture_output=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False
    return r.returncode == 0


def checkpoints(out: str) -> List[str]:
    """The run's checkpoints, where ``run --resume`` looks for them."""
    return (sorted(glob.glob(os.path.join(out, "ckpts", "*.npz")))
            or sorted(glob.glob(os.path.join(out, "*", "ckpts", "*.npz"))))


def stop(proc: subprocess.Popen, grace_s: float = 10.0) -> None:
    """Terminate, then kill after ``grace_s``; reaps the child."""
    proc.terminate()
    try:
        proc.wait(grace_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


class Runner:
    """The watchdog loop; ``cmd`` is the run's command without --resume."""

    def __init__(self, cmd: List[str], out: str, log_dir: str,
                 max_attempts: int = 20, stall_s: float = 900.0,
                 poll_s: float = 60.0, pause_s: float = 60.0,
                 wedge_sleep_s: float = 300.0,
                 healthy: Optional[Callable[[], bool]] = None,
                 kill_after_checkpoint: bool = False):
        self.cmd, self.out, self.log_dir = list(cmd), out, log_dir
        self.max_attempts = max_attempts
        self.stall_s, self.poll_s = stall_s, poll_s
        self.pause_s, self.wedge_sleep_s = pause_s, wedge_sleep_s
        self.healthy = healthy or (lambda: True)
        self.inject = kill_after_checkpoint
        os.makedirs(log_dir, exist_ok=True)
        self.log = os.path.join(log_dir, "soak.log")

    def note(self, msg: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        with open(self.log, "a") as f:
            f.write(line + "\n")

    def attempt(self, k: int, resume: bool) -> Optional[int]:
        """One run under the watchdog: its exit code, or None when it was
        killed (a stall, or the injected one)."""
        runlog = os.path.join(self.log_dir, f"run_{k}.log")
        cmd = self.cmd + (["--resume"] if resume else [])
        with open(runlog, "w") as f:
            # unbuffered: the log's growth is the run's heartbeat
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                    cwd=HERE, env={**os.environ,
                                                   "PYTHONUNBUFFERED": "1"})
        try:
            size, since = -1, time.monotonic()
            ckpt_size = None     # the log's size when a checkpoint appeared
            while proc.poll() is None:
                time.sleep(self.poll_s)
                now = time.monotonic()
                cur = os.path.getsize(runlog)
                if cur != size:
                    size, since = cur, now
                elif now - since >= self.stall_s:
                    self.note(f"attempt {k}: no log progress for "
                              f"{self.stall_s:g} s -> kill (stall)")
                    stop(proc)
                    return None
                if self.inject and proc.poll() is None:
                    ck = checkpoints(self.out)
                    if ck and ckpt_size is None:
                        ckpt_size = cur
                    elif ck and cur > ckpt_size:
                        # the run has moved on: the checkpoint is whole
                        self.inject = False
                        self.note(f"attempt {k}: injected stall after "
                                  f"{os.path.basename(ck[-1])} -> kill")
                        stop(proc)
                        return None
            return proc.returncode
        finally:
            if proc.poll() is None:
                stop(proc)

    def run(self) -> int:
        """0 once a run finishes; 1 after max_attempts attempts."""
        for k in range(1, self.max_attempts + 1):
            for _ in range(self.max_attempts):
                if self.healthy():
                    break
                self.note(f"card unhealthy (wedged); sleeping "
                          f"{self.wedge_sleep_s:g} s")
                time.sleep(self.wedge_sleep_s)
            else:
                self.note(f"card unhealthy in {self.max_attempts} checks; "
                          "giving up")
                return 1
            resume = bool(checkpoints(self.out))
            self.note(f"attempt {k} (resume='{'--resume' if resume else ''}"
                      "')")
            rc = self.attempt(k, resume)
            if rc == 0:
                self.note(f"soak COMPLETE on attempt {k}")
                with open(os.path.join(self.log_dir, f"run_{k}.log")) as f:
                    tail = f.readlines()[-20:]
                with open(self.log, "a") as f:
                    f.writelines(tail)
                return 0
            self.note(f"attempt {k} ended without finishing "
                      f"({'killed' if rc is None else f'exit code {rc}'}); "
                      "will resume")
            time.sleep(self.pause_s)
        self.note(f"soak gave up after {self.max_attempts} attempts")
        return 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default=DEFAULT_CONFIG)
    ap.add_argument("--output", default=DEFAULT_OUTPUT)
    ap.add_argument("--log-dir", default=DEFAULT_LOG_DIR)
    ap.add_argument("--max-attempts", type=int, default=20)
    ap.add_argument("--stall-s", type=float, default=900.0)
    ap.add_argument("--poll-s", type=float, default=60.0)
    ap.add_argument("--pause-s", type=float, default=60.0)
    ap.add_argument("--kill-after-checkpoint", action="store_true",
                    help="kill the first attempt once after its first "
                         "checkpoint, to exercise the resume")
    W.add_device_arg(ap)
    argv = list(sys.argv[1:] if argv is None else argv)
    # the arguments after "--" go to the run
    cut = argv.index("--") if "--" in argv else len(argv)
    args = ap.parse_args(argv[:cut])
    extra = argv[cut + 1:]
    W.device(args.device, "soak_runner")
    cmd = [sys.executable, "-m", "point_slam_tpu_torch.run", args.config,
           "--output", args.output, "--device", args.device, *extra]
    runner = Runner(cmd, args.output, args.log_dir, args.max_attempts,
                    args.stall_s, args.poll_s, args.pause_s,
                    healthy=lambda: health(args.device),
                    kill_after_checkpoint=args.kill_after_checkpoint)
    rc = runner.run()
    if rc:
        sys.exit(rc)
    return rc


if __name__ == "__main__":
    main(sys.argv[1:])
