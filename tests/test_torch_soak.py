"""The port's soak runner and the soak summary's active wall time.

soak_runner's watchdog on fake children (small Python scripts, stall
limits in tenths of a second): a child that stalls after writing a
checkpoint is killed and the next attempt runs with --resume; a child that
finishes ends the loop with 0; a child that never finishes exhausts the
attempts and the loop ends with 1; the injected stall kills only after the
checkpoint and the log has moved on; an unhealthy card is waited for,
within bounds. active_wall gives the JAX script's answers on made-up
metrics.jsonl files with gaps. And the slice's smaller tools on the host:
geo_fwd_split and interp_inspect at a small size, track_quality's loop at
a few iterations, recon_validate's choice of mesh.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from point_slam_tpu_torch.profiling import soak_runner as SR
from point_slam_tpu_torch.profiling import soak_summary as SS

from torch_parity import HERE

sys.path.insert(0, os.path.join(HERE, "profiling"))
import soak_summary as jss  # noqa: E402  (the JAX package's script)

# a fake run: "--resume" finishes at once; otherwise it writes a
# checkpoint, prints, and then (per MODE) stalls, fails or finishes
CHILD = r"""
import os, sys, time
out, mode = sys.argv[1], sys.argv[2]
print("start", sys.argv[3:], flush=True)
if "--resume" in sys.argv:
    print("resumed; finished", flush=True)
    sys.exit(0)
os.makedirs(os.path.join(out, "ckpts"), exist_ok=True)
open(os.path.join(out, "ckpts", "00004.npz"), "w").close()
print("checkpoint saved", flush=True)
if mode == "finish":
    sys.exit(0)
if mode == "fail":
    sys.exit(5)
if mode == "chatty":
    for _ in range(400):
        print("frame", flush=True)
        time.sleep(0.02)
    sys.exit(0)
time.sleep(60)
"""


def runner(tmp_path, mode, **kw):
    out = tmp_path / "run"
    cmd = [sys.executable, "-c", CHILD, str(out), mode]
    args = dict(max_attempts=3, stall_s=0.6, poll_s=0.1, pause_s=0.0,
                wedge_sleep_s=0.0)
    args.update(kw)
    return SR.Runner(cmd, str(out), str(tmp_path / "logs"), **args)


def log_lines(tmp_path):
    return (tmp_path / "logs" / "soak.log").read_text().splitlines()


def test_a_stalled_run_is_killed_and_resumed(tmp_path):
    r = runner(tmp_path, "stall")
    assert r.run() == 0
    lines = log_lines(tmp_path)
    assert "attempt 1 (resume='')" in lines[0]
    assert any("attempt 1: no log progress for 0.6 s -> kill (stall)" in x
               for x in lines)
    assert any("attempt 2 (resume='--resume')" in x for x in lines)
    assert any("soak COMPLETE on attempt 2" in x for x in lines)
    assert "--resume" in (tmp_path / "logs" / "run_2.log").read_text()
    assert "--resume" not in (tmp_path / "logs" / "run_1.log").read_text()
    # soak_summary's pattern picks out the kill and the resume
    import re
    hits = [x for x in lines if re.search(SS.RESUME_LINES, x)]
    assert len(hits) == 2


def test_a_finished_run_ends_the_loop(tmp_path):
    r = runner(tmp_path, "finish")
    assert r.run() == 0
    lines = log_lines(tmp_path)
    assert any("soak COMPLETE on attempt 1" in x for x in lines)
    assert not (tmp_path / "logs" / "run_2.log").exists()
    # the run's tail is appended to the soak log
    assert any("checkpoint saved" in x for x in lines)


def test_attempts_are_bounded(tmp_path):
    out = tmp_path / "run"
    # a run that always fails, even resumed
    cmd = [sys.executable, "-c", "import sys; print('x'); sys.exit(4)"]
    r = SR.Runner(cmd, str(out), str(tmp_path / "logs"), max_attempts=3,
                  stall_s=5, poll_s=0.05, pause_s=0.0)
    assert r.run() == 1
    lines = log_lines(tmp_path)
    assert sum("ended without finishing (exit code 4)" in x
               for x in lines) == 3
    assert "soak gave up after 3 attempts" in lines[-1]


def test_a_failed_run_is_resumed(tmp_path):
    r = runner(tmp_path, "fail")
    assert r.run() == 0
    lines = log_lines(tmp_path)
    assert any("attempt 1 ended without finishing (exit code 5)" in x
               for x in lines)
    assert any("attempt 2 (resume='--resume')" in x for x in lines)


def test_the_injected_stall_waits_for_the_checkpoint(tmp_path):
    """A run that keeps printing is killed once, after its checkpoint,
    and resumed; without the injection it would finish on attempt 1."""
    r = runner(tmp_path, "chatty", stall_s=30, kill_after_checkpoint=True)
    assert r.run() == 0
    lines = log_lines(tmp_path)
    assert any("attempt 1: injected stall after 00004.npz -> kill" in x
               for x in lines)
    assert any("soak COMPLETE on attempt 2" in x for x in lines)
    assert not r.inject


def test_an_unhealthy_card_is_waited_for_within_bounds(tmp_path):
    checks = iter([False, False, True])
    r = runner(tmp_path, "finish", healthy=lambda: next(checks))
    assert r.run() == 0
    assert sum("card unhealthy" in x for x in log_lines(tmp_path)) == 2
    r = runner(tmp_path / "never", "finish", healthy=lambda: False,
               max_attempts=2)
    assert r.run() == 1
    assert "giving up" in log_lines(tmp_path / "never")[-1]


def test_health_check_runs_a_matmul_in_a_child():
    assert SR.health("cpu", timeout_s=120)
    assert not SR.health("no_such_device", timeout_s=120)


def test_the_runner_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SR.main(["--output", str(tmp_path / "run"), "--log-dir",
                 str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists()


def _metrics(path, ts, extra=None):
    with open(path, "w") as f:
        for t in ts:
            f.write(json.dumps({"t": t, "idx_track": 1}) + "\n")
        f.write("not json\n")
        f.write(json.dumps({"no_t": 1}) + "\n")
        if extra:
            f.write(json.dumps(extra) + "\n")


@pytest.mark.parametrize("case", ["gaps", "none", "one", "unsorted"])
def test_active_wall_matches_jax(tmp_path, case):
    rng = np.random.default_rng(3)
    ts = {"gaps": list(np.cumsum(rng.uniform(0, 30, 50)))
          + [2000.0, 2001.5, 2500.0, 2620.0, 2739.9],
          "none": [],
          "one": [5.0],
          "unsorted": list(rng.permutation(np.cumsum(
              rng.uniform(0, 200, 40))))}[case]
    path = tmp_path / "metrics.jsonl"
    _metrics(path, [float(t) for t in ts])
    for gap in (120.0, 60.0):
        assert SS.active_wall(str(path), gap) == jss.active_wall(str(path),
                                                                 gap)
    act, gaps = SS.active_wall(str(path))
    if case == "gaps":
        assert gaps == pytest.approx(2000.0 - ts[49] + 498.5 + 120.0)
    if case in ("none", "one"):
        assert (act, gaps) == (0.0, 0.0)


def test_geo_fwd_split_and_interp_inspect_run_on_the_host(capsys):
    """The two diagnostics at a small size on the host: every stage runs,
    nothing is timed, and the neighbour statistics are in range."""
    from point_slam_tpu_torch.profiling import geo_fwd_split, interp_inspect
    out = geo_fwd_split.main(["--device", "cpu", "--small", "--cap", "8192",
                              "--points", "1000", "--iters", "1",
                              "--repeats", "1"])
    assert [n for n, _ in geo_fwd_split.STAGES] == list(out["stages"])
    assert 0 <= out["non_compact"] <= out["rays"] == 400
    assert all(r["busy_ms"] is None for r in out["stages"].values())
    assert "not measured (cpu)" in capsys.readouterr().out
    st = interp_inspect.main(["--device", "cpu"])
    assert st["points"] > 0 and 0 < st["valid_slots"] <= 8
    assert 0 <= st["in_radius_zero"] <= 1 and 0 < st["weight_max_mean"] <= 1
    assert 1 <= st["unique_neighbours"] <= 8


def test_track_quality_runs_on_the_host():
    """The drift probe's loop (map frame 0, track, map every 5th and the
    last) at a small size and a few iterations."""
    from point_slam_tpu_torch.profiling import track_quality as TQ
    cfg = TQ.config(3, small=True)
    cfg["mapping"].update({"iters": 3, "iters_first": 5,
                           "geo_iter_first": 2})
    recs = TQ.run(cfg, "cpu")
    assert [r["idx"] for r in recs] == [0, 1, 2]
    assert "map" in recs[0] and "map" in recs[2] and "map" not in recs[1]
    assert recs[1]["terr_cm"] == 0.0          # frame 1 takes its GT pose
    assert np.isfinite(recs[2]["terr_cm"]) and "best_loss" in recs[2]


def test_recon_validate_scores_the_runs_own_mesh_only(tmp_path):
    from point_slam_tpu_torch.profiling import recon_validate as RV
    mesh = tmp_path / "mesh"
    mesh.mkdir()
    for name in ("final_mesh.ply", "gt_culled.ply", "gt_scene.ply",
                 "gt_scene_culled.ply", "vertices_pos.ply"):
        (mesh / name).write_text("")
    assert RV.run_meshes(str(tmp_path)) == [str(mesh / "final_mesh.ply")]
