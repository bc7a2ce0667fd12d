"""The port's quality gate and soak evaluation against the JAX package's
scripts (profiling/quality_gate.py, soak_summary.py, bf16_ab.py,
geo_decoder_ab.py).

The pure parts get the same inputs and must give the same answers:
product_dirty on a temporary git repository, check_stale over standing,
probe, dirty and changed-product rows, the PASS/FAIL rule (JAX's own
expression, read from its script) over a grid of rows, and soak_summary's
keys and ATE on one checkpoint written by the JAX package's
save_checkpoint (within 1e-6 cm).

The slice as a whole: both gates on tests/test_torch_eval_e2e.py's 48x64
8-frame config (the port on the CPU under deterministic algorithms), each
under a temporary root. The packages draw different random streams, so
outcomes are compared, as that file does: the same row keys but the
renamed ones (backend -> device, tpu_overrides -> cuda_overrides), ATE
without alignment under 10 cm, depth L1 within 2x JAX's plus 1 cm, PSNR
above half JAX's minus 1 dB, a finite F-score; and the tracked
output/quality_gate*.json stay untouched. The port's checkpoint of its
gate run then goes through soak_eval and soak_summary. The A/B scripts'
variants build the JAX scripts' configurations (the runs faked), and the
mapping-step A/Bs at a tiny size show 'default' precision has no effect on
the host.
"""

import ast
import glob
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax

from point_slam_tpu_torch.profiling import bf16_ab as TAB
from point_slam_tpu_torch.profiling import geo_decoder_ab as TGEO
from point_slam_tpu_torch.profiling import mlp_precision_ab as MP
from point_slam_tpu_torch.profiling import probes_ab as PA
from point_slam_tpu_torch.profiling import quality_gate as QG
from point_slam_tpu_torch.profiling import soak_eval as SE
from point_slam_tpu_torch.profiling import soak_summary as SS

from torch_parity import CONFIGS, HERE

sys.path.insert(0, os.path.join(HERE, "profiling"))
import quality_gate as jqg  # noqa: E402  (the JAX package's script)

TINY = f"""inherit_from: {os.path.join(CONFIGS, 'Synthetic', 'room.yaml')}
synthetic: {{n_frames: 8, angular_step: 0.02}}
cam: {{H: 48, W: 64, fx: 40.0, fy: 40.0, cx: 31.5, cy: 23.5}}
tracking: {{pixels: 300, iters: 20, ignore_edge_W: 5, ignore_edge_H: 5}}
mapping: {{pixels: 400, pixels_adding: 200, pixels_based_on_color_grad: 50,
          iters: 15, iters_first: 25, geo_iter_first: 10,
          mapping_window_size: 4, keyframe_every: 4, every_frame: 2,
          lazy_start: false, color_refine: false}}
tpu: {{point_capacity_init: 8192, point_capacity_max: 65536,
      grid_table_size: 16384, grid_max_per_cell: 64}}
meshing: {{voxel: 0.06}}
verbose: false
"""
RENAMED = {"backend": "device", "tpu_overrides": "cuda_overrides"}
JAX_GATE_FILES = sorted(glob.glob(os.path.join(HERE, "output",
                                               "quality_gate*.json")))


def _digests():
    return {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
            for p in JAX_GATE_FILES}


def _git(repo, *args):
    return subprocess.run(["git", *args], cwd=repo, capture_output=True,
                          check=True, text=True).stdout.strip()


def _repo(tmp_path):
    repo = tmp_path / "repo"
    repo.mkdir()
    _git(repo, "init", "-q")
    _git(repo, "config", "user.email", "t@t")
    _git(repo, "config", "user.name", "t")
    for d, f in (("point_slam_tpu_torch", "a.py"), ("point_slam_tpu", "a.py"),
                 ("configs", "c.yaml"), ("output/torch", "gate.json"),
                 ("docs", "d.md")):
        (repo / d).mkdir(parents=True, exist_ok=True)
        (repo / d / f).write_text("x = 1\n")
    _git(repo, "add", "-A")
    _git(repo, "commit", "-qm", "init")
    return repo


def test_product_dirty_matches_jax_on_the_ports_paths(tmp_path, monkeypatch):
    """Evidence churn (output/, docs, the JAX package) leaves the port's
    tree clean; its own package or configs make it dirty. JAX's function
    on the port's paths answers the same."""
    repo = _repo(tmp_path)
    monkeypatch.setattr(jqg, "PRODUCT_PATHS", QG.PRODUCT_PATHS)
    steps = [(None, False),
             ("output/torch/gate.json", False), ("docs/d.md", False),
             ("point_slam_tpu/a.py", False),
             ("configs/c.yaml", True), ("point_slam_tpu_torch/a.py", True)]
    for path, want in steps:
        if path:
            _git(repo, "checkout", "--", ".")
            (repo / path).write_text("x = 2\n")
        assert QG.product_dirty(str(repo)) is want, path
        assert jqg.product_dirty(cwd=str(repo)) is want, path


def _gate_rows(repo, gate_dir):
    head = _git(repo, "rev-parse", "--short", "HEAD")
    rows = {
        "quality_gate.json": {"commit": head, "standing": True},
        "quality_gate_sensor.json": {"commit": head},   # legacy: standing
        "quality_gate_probe.json": {"commit": "deadbee-dirty",
                                    "standing": False, "tag": "probe"},
    }
    for name, row in rows.items():
        (gate_dir / name).write_text(json.dumps(row))
    return head


@pytest.mark.parametrize("case", ["clean", "dirty", "unknown", "changed",
                                  "evidence"])
def test_check_stale_matches_jax(tmp_path, monkeypatch, capsys, case):
    """The port's audit of output/torch/ against JAX's audit of output/
    holding the same rows, on the port's product paths: the same code and
    the same STALE lines."""
    repo = _repo(tmp_path)
    port_dir, jax_dir = repo / "output" / "torch", repo / "output"
    for d in (port_dir, jax_dir):
        head = _gate_rows(repo, d)
        if case == "dirty":
            (d / "quality_gate.json").write_text(json.dumps(
                {"commit": head + "-dirty", "standing": True}))
        elif case == "unknown":
            (d / "quality_gate_sensor.json").write_text(json.dumps(
                {"commit": "unknown"}))
    if case in ("changed", "evidence"):
        path = ("point_slam_tpu_torch/a.py" if case == "changed"
                else "docs/d.md")
        (repo / path).write_text("x = 3\n")
        _git(repo, "commit", "-qam", case)
    monkeypatch.setattr(jqg, "PRODUCT_PATHS", QG.PRODUCT_PATHS)
    monkeypatch.setattr(jqg, "HERE", str(repo))
    capsys.readouterr()
    got = QG.check_stale(str(repo))
    ours = capsys.readouterr().out.splitlines()
    want = jqg.check_stale()
    theirs = capsys.readouterr().out.splitlines()
    assert got == want == (0 if case in ("clean", "evidence") else 2)
    assert [x for x in ours if x.startswith("STALE")] == \
        [x for x in theirs if x.startswith("STALE")]
    assert any("probe (not audited): quality_gate_probe.json" in x
               for x in ours)


def _jax_rule():
    """JAX's PASS/FAIL expression, read from its script."""
    tree = ast.parse(open(jqg.__file__).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "ok":
            return compile(ast.Expression(node.value), "rule", "eval")
    raise AssertionError("no `ok = ...` in the JAX gate")


def test_gate_rule_matches_jax():
    rule = _jax_rule()
    ates = [0.1, 0.2, 0.25, 0.3, 0.407, 0.44, 0.448, 0.4477, 0.45, 0.6, 2.0]
    fs = [86.0, 87.05, 87.06, 87.07, 87.56, 90.0]
    n = 0
    for g_ate in (0.1, 0.2, 0.407, 1.0):
        for g_f in (80.0, 87.56):
            gate = {"ate_noalign_cm": g_ate, "fscore": g_f}
            for ate in ates:
                for f in fs:
                    row = {"ate_noalign_cm": ate, "fscore": f}
                    want = eval(rule, {"max": max}, {"row": row,
                                                     "gate": gate})
                    assert QG.passes(row, gate) is bool(want), (row, gate)
                    n += 1
    assert n == 4 * 2 * len(ates) * len(fs)


def _recorder(module, captured):
    base = module.PointSLAM

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)
    return Recorded


@pytest.fixture(scope="module")
def gates(tmp_path_factory):
    """Both gates on the tiny config, each under its own temporary root;
    the SLAM objects are kept for the checkpoint tests."""
    import point_slam_tpu.slam as jslam_mod
    import point_slam_tpu_torch.slam as tslam_mod
    from point_slam_tpu.utils.logger import save_checkpoint as j_save
    from point_slam_tpu_torch.utils.logger import save_checkpoint as t_save

    base = tmp_path_factory.mktemp("gates")
    yaml = base / "tiny.yaml"
    yaml.write_text(TINY)
    before = _digests()
    root_j, root_t = base / "jax", base / "port"
    root_j.mkdir()
    (root_j / "configs").symlink_to(CONFIGS)
    captured_j, captured_t = [], []
    upd = jax.config.update
    prec = jax.config.jax_default_matmul_precision
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqg, "HERE", str(root_j))
        mp.setattr(sys, "argv", ["quality_gate.py", "8", "tiny", "--config",
                                 str(yaml)])
        mp.setattr(jslam_mod, "PointSLAM", _recorder(jslam_mod, captured_j))
        # the JAX gate's compilation cache stays where it was
        mp.setattr(jax.config, "update", lambda k, v: None if
                   k == "jax_compilation_cache_dir" else upd(k, v))
        try:
            jqg.main()
        finally:
            upd("jax_default_matmul_precision", prec)
        mp.setattr(tslam_mod, "PointSLAM", _recorder(tslam_mod, captured_t))
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            trow, verdict = QG.run_gate(8, "tiny", str(yaml), device="cpu",
                                        root=str(root_t), overrides={})
        finally:
            torch.use_deterministic_algorithms(was)
    jrow = json.load(open(root_j / "output" / "quality_gate_tiny.json"))
    jslam, tslam = captured_j[0], captured_t[0]
    j_save(os.path.join(jslam.output, "ckpts", "00007.npz"), jslam, 7)
    t_save(os.path.join(tslam.output, "ckpts", "00007.npz"), tslam, 7)
    return {"jrow": jrow, "trow": trow, "verdict": verdict, "yaml": str(yaml),
            "root_t": root_t, "jrun": jslam.output, "trun": tslam.output,
            "before": before, "after": _digests()}


def test_gate_rows_have_jaxs_keys(gates):
    jrow, trow = gates["jrow"], gates["trow"]
    assert "failed" not in trow, trow
    assert list(trow) == [RENAMED.get(k, k) for k in jrow]
    assert trow["device"] == "cpu" and trow["cuda_overrides"] == {}
    assert trow["tag"] == "tiny" and trow["standing"] is False
    # outside a git checkout the commit is unknown (never certified)
    assert trow["commit"] == "unknown"
    assert gates["verdict"] is None          # no standing gate to judge by
    assert set(trow["timing_s"]) >= set(jrow["timing_s"]) - {"compile"}


def test_gate_outcomes_against_jax(gates):
    jrow, trow = gates["jrow"], gates["trow"]
    for k in ("ate_cm", "ate_noalign_cm", "fscore", "precision", "recall",
              "psnr", "ms_ssim", "depth_l1_cm"):
        assert np.isfinite(trow[k]), k
    assert trow["ate_noalign_cm"] < 10.0
    assert trow["depth_l1_cm"] <= 2 * jrow["depth_l1_cm"] + 1.0
    assert trow["psnr"] >= jrow["psnr"] / 2 - 1.0
    assert trow["n_frames"] == jrow["n_frames"] == 8
    assert trow["n_points"] > 0


def test_gate_writes_under_its_root_only(gates):
    root = gates["root_t"]
    assert (root / "output" / "torch" / "quality_gate_tiny.json").exists()
    assert (root / "output" / "torch" / "quality_gate_tiny" / "mesh"
            / "final_mesh.ply").exists()
    assert not (root / "output" / "torch" / "quality_gate.json").exists()
    assert gates["before"] == gates["after"]
    assert json.load(open(root / "output" / "torch"
                          / "quality_gate_tiny.json")) == gates["trow"]


def test_probe_is_judged_against_the_standing_gate(gates, tmp_path,
                                                   monkeypatch):
    """A probe beside a standing gate gets JAX's verdict; run_gate's run
    is replaced by the fixture's results."""
    trow = gates["trow"]
    out = tmp_path / "output" / "torch"
    out.mkdir(parents=True)
    res = {"ate_rmse": trow["ate_cm"] / 100,
           "ate_rmse_no_align": trow["ate_noalign_cm"] / 100,
           "recon_F_score": trow["fscore"]}

    class Slam:
        class mapper:
            n_points_host = 1
    monkeypatch.setattr(QG, "run_pipeline", lambda cfg, dev: (
        Slam(), {"timing": {}}, 1.0, res))
    ate, f = trow["ate_noalign_cm"], trow["fscore"]
    for g_ate, g_f, want in ((ate, f, True),              # itself: PASS
                             (0.01, f, ate <= 0.25),      # the 0.25 floor
                             (ate, f + 1.0, False)):      # F 1 below: FAIL
        (out / "quality_gate.json").write_text(json.dumps(
            {"commit": "abc", "ate_noalign_cm": g_ate, "fscore": g_f}))
        _, verdict = QG.run_gate(8, "probe", gates["yaml"], device="cpu",
                                 root=str(tmp_path), overrides={})
        assert verdict is bool(want)


def test_soak_summary_on_a_jax_checkpoint_matches_jax(gates, tmp_path,
                                                      monkeypatch, capsys):
    import soak_summary as jss
    run = gates["jrun"]
    log = tmp_path / "soak.log"
    log.write_text("[10:00:00] attempt 1 (resume='')\n"
                   "[11:00:00] attempt 1: no log progress for 900 s -> kill "
                   "(stall)\n[11:01:00] attempt 2 (resume='--resume')\n")
    monkeypatch.setattr(sys, "argv", ["soak_summary.py", run,
                                      "--wedge-log", str(log)])
    jss.main()
    want = json.load(open(os.path.join(os.path.dirname(run),
                                       "soak_summary.json")))
    got = SS.summarize(run, str(log))
    assert list(got) == list(want)
    for k in ("ate_rmse_cm", "ate_rmse_noalign_cm", "ate_max_noalign_cm"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    for k in ("n_frames", "n_points", "n_keyframes", "point_capacity_final",
              "packed_buffer_mb", "keyframe_ring", "kill_resume_log",
              "checkpoints", "wall_active_s", "wall_excluded_gaps_s"):
        assert got[k] == want[k], k
    # the unrounded ATE too
    from point_slam_tpu.tools.eval_ate import evaluate_ate as j_ate
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate as t_ate
    z = np.load(os.path.join(run, "ckpts", "00007.npz"))
    for align in (True, False):
        a = t_ate(z["gt_c2w_list"], z["estimate_c2w_list"], align=align)
        b = j_ate(z["gt_c2w_list"], z["estimate_c2w_list"], align=align)
        assert abs(a["absolute_translational_error.rmse"]
                   - b["absolute_translational_error.rmse"]) * 100 <= 1e-6


def test_soak_eval_then_summary_on_the_ports_checkpoint(gates, tmp_path):
    run = gates["trun"]
    rr, rec, mem = SE.evaluate(run, 2, gates["yaml"], device="cpu")
    assert rr["render_stride"] == 2 and rr["frame_cnt"] == 2
    for k in ("depth_l1_render", "avg_psnr", "avg_ms_ssim"):
        assert np.isfinite(rr[k]), k
    assert rec["render_stride"] == 2 and rec["n_fused_frames"] == 2
    assert np.isfinite(rec["recon_F_score"])
    assert "host_peak_rss_bytes" in mem
    assert "post_mesh_host_peak_rss_bytes" in mem
    out = SS.summarize(run, str(tmp_path / "none.log"), gates["yaml"])
    assert out["render_metrics"] == json.load(open(os.path.join(
        run, "render_metrics.json")))
    assert out["recon_eval"]["n_fused_frames"] == 2
    assert out["eval_memory"] == mem
    assert out["keyframe_ring"] == "device"     # the tiny config's
    assert out["kill_resume_log"] == []
    assert out["ate_rmse_noalign_cm"] == gates["trow"]["ate_noalign_cm"]
    assert os.path.exists(os.path.join(os.path.dirname(run),
                                       "soak_summary.json"))


class _FakeSlam:
    """Stands in for either package's PointSLAM: records the config."""
    configs = []

    def __init__(self, cfg, *a, **kw):
        self.cfg = cfg
        self.output = cfg["data"]["output"]
        os.makedirs(self.output, exist_ok=True)
        _FakeSlam.configs.append(cfg)

    def run(self):
        return {"timing": {}}


RES = {"ate_rmse": 0.01, "ate_rmse_no_align": 0.012, "recon_F_score": 80.0,
       "avg_psnr": 30.0, "avg_ms_ssim": 0.9, "depth_l1_render": 0.002}


def _fake_jax(monkeypatch):
    import point_slam_tpu.slam as jslam_mod
    import point_slam_tpu.tools.evaluate as jev
    monkeypatch.setattr(jslam_mod, "PointSLAM", _FakeSlam)
    monkeypatch.setattr(jev, "run_end_of_run_eval", lambda s, out: RES)


def _fake_port(monkeypatch):
    monkeypatch.setattr(TAB.QG, "run_pipeline", lambda cfg, dev: (
        _FakeSlam(cfg), {"timing": {}}, 1.0, RES))


def _same_run(jcfg, tcfg):
    """The settings a run reads agree (tpu: against cuda: where shared)."""
    for sec in ("synthetic", "mapping", "tracking", "cam", "rendering",
                "meshing", "pretrained_decoders"):
        assert jcfg[sec] == tcfg[sec], sec
    for k in ("reconstruction_datasets", "render_datasets", "verbose"):
        assert jcfg[k] == tcfg[k], k
    assert jcfg["tpu"]["bf16_features"] == tcfg["cuda"]["bf16_features"]


@pytest.mark.parametrize("variant", ["f32", "bf16"])
def test_bf16_ab_variants_build_jaxs_runs(variant, tmp_path, monkeypatch):
    import bf16_ab as jab
    _fake_jax(monkeypatch)
    _fake_port(monkeypatch)
    _FakeSlam.configs = []
    want = jab.run_variant(variant, 12, variant == "bf16")
    got = TAB.run_variant(variant, 12, "cpu", variant == "bf16",
                          root=str(tmp_path))
    jcfg, tcfg = _FakeSlam.configs
    _same_run(jcfg, {**tcfg, "data": jcfg["data"]})
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "wall_s"} == \
        {k: v for k, v in want.items() if k != "wall_s"}
    assert json.load(open(tmp_path / "output" / "torch" / "bf16_ab"
                          / variant / "row.json")) == got


@pytest.mark.parametrize("variant,fix_after,pretrained", [
    ("train_always", 0, False), ("freeze_after_20", 20, False),
    ("pretrained_frozen", 0, True)])
def test_geo_decoder_ab_variants_build_jaxs_runs(variant, fix_after,
                                                 pretrained, tmp_path,
                                                 monkeypatch):
    import geo_decoder_ab as jgeo
    _fake_jax(monkeypatch)
    _fake_port(monkeypatch)
    _FakeSlam.configs = []
    npz = TGEO.pretrained_npz() if pretrained else ""
    want = jgeo.run_variant(variant, 12, fix_after, pretrained=npz)
    got = TGEO.run_variant(variant, 12, "cpu", fix_after, npz,
                           root=str(tmp_path))
    jcfg, tcfg = _FakeSlam.configs
    _same_run(jcfg, {**tcfg, "data": jcfg["data"]})
    assert tcfg["mapping"]["fix_geo_decoder"] is pretrained
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "wall_s"} == \
        {k: v for k, v in want.items() if k != "wall_s"}


@pytest.fixture(scope="module")
def step():
    return MP.build("cpu", 1 << 13, 1000, "surface", small=True)


def test_mlp_precision_default_has_no_effect_on_the_host(step):
    out = MP.run(step, iters=1, repeats=1)
    assert out["loss"]["rel_delta"] == 0.0
    assert out["loss"]["highest"] == out["loss"]["default"]
    assert np.isfinite(out["loss"]["highest"]) and out["loss"]["highest"] > 0
    for name in ("highest", "default"):
        assert out[name]["wall"]["median"] is None      # nothing timed
        assert out[name]["busy_ms"] is None


def test_probes_ab_holds_the_ray_topk_and_times_nothing(step):
    out = PA.run(step, iters=1, repeats=1)
    assert set(out["hold"]) == set(PA.PROBES)
    assert all(h["equal"] for h in out["hold"].values())
    assert len(out["grid"]) == 4
    assert all(r["wall"]["median"] is None for r in out["grid"].values())
