"""Port parity, what a run leaves behind: the PLY writer and reader, the
metrics sink (JSONL always, the wandb mirror against a stub module, as
tests/test_mlog.py does) and the memory report, against the JAX package's
modules on the same inputs. Tolerance 0: these are byte-level formats."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from point_slam_tpu.utils import ply as jply
from point_slam_tpu.utils.mlog import MetricsLogger as JLogger
from point_slam_tpu_torch.utils import memory as tmemory
from point_slam_tpu_torch.utils import ply as tply
from point_slam_tpu_torch.utils.mlog import MetricsLogger as TLogger


def _mesh(seed=0, nv=50, nf=30):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nv, 3)).astype(np.float32),
            rng.integers(0, nv, size=(nf, 3)).astype(np.int32),
            rng.random((nv, 3)).astype(np.float32))


@pytest.mark.parametrize("faces,colors", [(True, True), (True, False),
                                          (False, True), (False, False)],
                         ids=["mesh+rgb", "mesh", "points+rgb", "points"])
def test_ply_roundtrip_against_jax(tmp_path, faces, colors):
    v, f, c = _mesh()
    f = f if faces else None
    c = c if colors else None
    tp, jp = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tply.write_ply(tp, v, f, c)
    jply.write_ply(jp, v, f, c)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    for got, want in zip(tply.read_ply(tp), jply.read_ply(tp)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    v2, f2, c2 = tply.read_ply(tp)
    np.testing.assert_array_equal(v2, v)
    if faces:
        np.testing.assert_array_equal(f2, f)
    if colors:
        np.testing.assert_allclose(c2 / 255.0, c, atol=1 / 255.0 + 1e-6)


def test_read_ply_ascii_like_jax(tmp_path):
    p = tmp_path / "a.ply"
    p.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                 "property float y\nproperty float z\nproperty uchar red\n"
                 "property uchar green\nproperty uchar blue\n"
                 "element face 1\nproperty list uchar int vertex_indices\n"
                 "end_header\n0 0 0 255 0 0\n1 0 0 0 255 0\n0 1 0 0 0 255\n"
                 "3 0 1 2\n")
    for got, want in zip(tply.read_ply(str(p)), jply.read_ply(str(p))):
        np.testing.assert_array_equal(got, want)


def _stub_wandb(calls):
    w = types.ModuleType("wandb")
    w.init = lambda **kw: calls.append(("init", kw))
    w.log = lambda d, step=None: calls.append(("log", d, step))
    w.finish = lambda: calls.append(("finish",))

    class Image:
        def __init__(self, path):
            self.path = path

    class Object3D:
        def __init__(self, pts):
            self.pts = np.asarray(pts)

    w.Image, w.Object3D = Image, Object3D
    return w


def _drive(logger_cls, out, cfg, img, close):
    m = logger_cls(str(out), cfg=cfg, name="slam_room")
    m.log({"idx_track": 3, "track_first_loss": np.float32(2.5),
           "track_best_loss": 1.25})
    m.log({"idx_map": 4, "n_points": 1200, "ba": False}, step=4)
    m.log_image("mapping_vis", img, step=4)
    m.log_image("mapping_vis", None, step=4)
    m.log_points("input_pc", np.arange(12, dtype=np.float32).reshape(4, 3),
                 np.full((4, 3), 128.0, np.float32), step=4)
    getattr(m, close)()
    recs = [json.loads(ln) for ln in open(out / "metrics.jsonl")]
    for r in recs:
        assert isinstance(r.pop("t"), float)
    return recs


@pytest.mark.parametrize("with_wandb", [False, True],
                         ids=["jsonl", "jsonl+wandb_stub"])
def test_metrics_logger_writes_the_jax_records(tmp_path, monkeypatch,
                                               with_wandb):
    img = tmp_path / "panel.jpg"
    img.write_bytes(b"\xff\xd8\xff")
    runs = {}
    for name, cls, close in (("jax", JLogger, "finish"),
                             ("port", TLogger, "close")):
        calls = []
        if with_wandb:
            monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls))
        out = tmp_path / name
        cfg = {"wandb": with_wandb, "project_name": "p"}
        runs[name] = (_drive(cls, out, cfg, str(img), close), calls)
    (jrecs, jcalls), (trecs, tcalls) = runs["jax"], runs["port"]
    assert trecs == jrecs and len(trecs) == 2
    assert trecs[1]["step"] == 4
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    if with_wandb:
        assert tcalls[0][0] == "init" and tcalls[-1][0] == "finish"
        logs = [c for c in tcalls if c[0] == "log"]
        assert logs[0][1]["idx_track"] == 3
        assert logs[2][1]["mapping_vis"].path == str(img)
        pc = logs[3][1]["input_pc"]
        jpc = [c for c in jcalls if c[0] == "log"][3][1]["input_pc"]
        np.testing.assert_array_equal(pc.pts, jpc.pts)
        assert pc.pts.shape == (4, 6)


def test_metrics_logger_without_wandb_installed(tmp_path, monkeypatch):
    """cfg["wandb"] set but no package: JSONL only, as in the JAX package."""
    monkeypatch.setitem(sys.modules, "wandb", None)    # import fails
    m = TLogger(str(tmp_path), cfg={"wandb": True})
    m.log({"a": 1.0})
    m.log_points("pc", np.zeros((2, 3)))
    m.close()
    assert json.loads(open(tmp_path / "metrics.jsonl").readline())["a"] == 1.0


def test_memory_report_on_the_cpu():
    rep = tmemory.memory_report("cpu")
    assert set(rep) == {"host_peak_rss_bytes"}
    assert rep["host_peak_rss_bytes"] > 10 * 2 ** 20
    assert tmemory.device_memory(torch.device("cpu")) == {}
