"""The port's determinism harness (point_slam_tpu_torch/tools/determinism.py,
the counterpart of test_deterministic.py) on the CPU.

Against the port's golden file tests/data_torch/determinism_ref.npz: bit
for bit when this host has the torch version and the CPU capability that
wrote it; otherwise (another CPU's vector kernels round differently) within
tests/test_torch_slam_e2e.py's tolerances: the same GT trajectory, the
run's ATE without alignment under 10 cm and within 2x the golden's plus
1 cm, and the point count within 15%. And the CLI's short self-check: two
2-frame runs in one process, bit-equal."""

import os
import subprocess
import sys

import numpy as np

from point_slam_tpu_torch.tools import determinism as D
from point_slam_tpu_torch.tools.eval_ate import evaluate_ate

from torch_parity import HERE


def _ate(run):
    return evaluate_ate(run["gt_c2w_list"], run["estimate_c2w_list"],
                        align=False)["absolute_translational_error.rmse"]


def test_run_matches_the_golden_file():
    golden = D.load_golden()
    assert str(golden["device"]) == "cpu"
    run = D.run_once(10, "cpu")
    assert run["estimate_c2w_list"].shape == (10, 4, 4)
    host = D.host_of("cpu")
    if all(str(golden[k]) == host[k] for k in host):
        assert D.compare(run, golden, "run", "golden")
        return
    np.testing.assert_array_equal(run["gt_c2w_list"], golden["gt_c2w_list"])
    assert _ate(run) < 0.10
    assert _ate(run) < 2 * _ate(golden) + 0.01
    n_run, n_gold = len(run["geo_feats"]), len(golden["geo_feats"])
    assert abs(n_run - n_gold) <= 0.15 * n_gold


def test_self_check_cli():
    res = subprocess.run(
        [sys.executable, "-m", "point_slam_tpu_torch.tools.determinism",
         "--self_check", "--device", "cpu", "--n_frames", "2"],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    assert "DETERMINISTIC (run1 vs run2)" in res.stdout
    assert res.stdout.count("bit-exact") == len(D.COMPARE_KEYS)
