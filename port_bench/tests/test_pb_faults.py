"""``correct`` comes out false when the timed path is broken underneath
the harness: the harness runs a cell cut to a small size on the CPU
(skipping its look for a card) with a fault planted in the program.

The cut sequence ends a few frames after the window opens, so its last
frame, which Point-SLAM maps as the colour refinement, would be the
window's last mapped frame; the runs turn the refinement off, but for
one sound run that keeps it, so the check's frames are the steady
schedule's."""

import functools
import json

import numpy as np
import pytest
from conftest import SMALL
from core import manifest
from point_slam_tpu_torch import datasets, renderer
from point_slam_tpu_torch.ops import adam

# the TUM cell, whose configuration and traffic stay under port_bench/
# while BENCHMARK.json leaves it out (its runs spread too widely on the
# card); the tests run it to cover the lens, crop, holes and the
# colour-gradient pixel pool
TUM = ({"name": "tum_fr1", "file": "port_bench/configs/tum_fr1.json"},
       {"name": "tum_fr1.orbit_holes", "config": "tum_fr1",
        "traffic": "orbit_holes", "chips": 1})


@pytest.fixture(autouse=True)
def with_tum(monkeypatch):
    load = manifest.load_benchmark

    def loaded(root):
        bm = load(root)
        if TUM[1]["name"] not in {w["name"] for w in bm["workloads"]}:
            bm["configs"].append(dict(TUM[0]))
            bm["workloads"].append(dict(TUM[1]))
        return bm
    monkeypatch.setattr(manifest, "load_benchmark", loaded)


def _run(harness, capsys, cell="replica.orbit", seed=2 ** 31 + 977,
         device="cpu", extra=(), refine=False):
    cut = dict(json.loads(json.dumps(SMALL)), frames=11)
    cut["mapping"]["color_refine"] = refine
    if cell.startswith("tum"):
        cut["cam"]["crop_edge"] = 2
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "1000", "--trace", "0", *extra],
                      device=device, cut=cut)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _altered(render):
    """An answer altered where it is produced: the colour of every ray."""
    @functools.wraps(render)
    def broken(*a, **k):
        depth, unc, color, valid = render(*a, **k)
        return depth, unc, color + 1e-3, valid
    return broken


def _depth_altered(render):
    """A depth altered where it is produced: every ray's a millionth
    deeper, a depth compositing or normalisation off by that much."""
    @functools.wraps(render)
    def broken(*a, **k):
        depth, unc, color, valid = render(*a, **k)
        return depth * (1 + 1e-6), unc, color, valid
    return broken


def _half_batch(render):
    """Half of the batch left out: the second half of the rays takes the
    first half's answers."""
    @functools.wraps(render)
    def broken(*a, **k):
        out = render(*a, **k)
        half = out[0].shape[0] // 2

        def fold(t):
            t = t.clone()
            t[half:2 * half] = t[:half]
            return t
        return tuple(fold(t) for t in out)
    return broken


def _reader_depth(wire):
    """The reader's depth altered where it is produced: one pixel a
    frame one step deeper."""
    def broken(self, index):
        i, packed, pose = wire(self, index)
        packed = packed.copy()
        d = np.ascontiguousarray(packed[..., 3:5]).view(np.uint16)
        d[7, 9, 0] += 1
        packed[..., 3:5] = d.view(np.uint8)
        return i, packed, pose
    return broken


def _is_map(params):
    return params[0].dim() == 2 and params[0].shape[1] == 72


def _is_pose(params):
    return params[0].numel() == 4


def _unchanged(update, which):
    """A step that returns its state unchanged: Adam hands back the
    mapper's map rows, or the tracker's camera, as it was given them.
    The mapper's step writes its leaves in place, so the map rows are
    kept before the step and written back into the same tensor after."""
    @functools.wraps(update)
    def broken(params, grads, state, *a, **k):
        keep = (params[0].clone() if which == "map" and _is_map(params)
                else None)
        new, st = update(params, grads, state, *a, **k)
        if keep is not None:
            params[0].copy_(keep)
            new = [params[0]] + list(new[1:])
        if which == "pose" and _is_pose(params):
            new = [p.clone() for p in params]
        return new, st
    return broken


def _lr_doubled(update):
    """The mapper's steps at twice the configured learning rates."""
    @functools.wraps(update)
    def broken(params, grads, state, t, lr, *a, **k):
        if _is_map(params):
            lr = [x * 2 for x in lr]
        return update(params, grads, state, t, lr, *a, **k)
    return broken


def _failed(out):
    return [c["name"] for c in out["checks"]
            if c["value"] is None or c["value"] > c["limit"]]


@pytest.mark.parametrize("cell,refine", [
    ("replica.orbit", False), ("replica.orbit", True),
    ("tum_fr1.orbit_holes", False)])
def test_a_sound_run_is_correct(harness, capsys, cell, refine):
    out = _run(harness, capsys, cell=cell, refine=refine)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0
    assert out["attempted"] == (5 if cell.startswith("replica") else 8)
    # the CPU has no device trace: every end-to-end metric but those read
    # from it is reported
    bm = manifest.load_benchmark(harness.ROOT)
    assert set(out["metrics"]) == {
        m["name"] for m in bm["end_to_end"] if m["source"] != "device_trace"}
    names = [c["name"] for c in out["checks"]]
    assert names == list(out["checks"][i]["name"] for i in range(len(names)))
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault,number", [
    ("altered", "color_gap"), ("half_batch", "color_gap"),
    ("depth_altered", "depth_gap")])
def test_a_broken_render_is_caught(harness, capsys, monkeypatch, fault,
                                   number):
    make = {"altered": _altered, "half_batch": _half_batch,
            "depth_altered": _depth_altered}[fault]
    monkeypatch.setattr(renderer, "render_rays",
                        make(renderer.render_rays))
    out = _run(harness, capsys)
    assert out["correct"] is False
    assert any(number in n for n in _failed(out))


@pytest.mark.parametrize("fault,number", [
    ("map_unchanged", "map.step_gap"), ("pose_unchanged", "track.step_gap"),
    ("map_lr_doubled", "map.step_gap")])
def test_a_broken_step_is_caught(harness, capsys, monkeypatch, fault,
                                 number):
    make = {"map_unchanged": lambda u: _unchanged(u, "map"),
            "pose_unchanged": lambda u: _unchanged(u, "pose"),
            "map_lr_doubled": _lr_doubled}[fault]
    monkeypatch.setattr(adam, "update", make(adam.update))
    out = _run(harness, capsys)
    assert out["correct"] is False
    assert number in _failed(out)
    gap = {c["name"]: c["value"] for c in out["checks"]}[number]
    assert gap > 0.3


def test_a_broken_reader_is_caught(harness, capsys, monkeypatch):
    monkeypatch.setattr(datasets.BaseDataset, "wire",
                        _reader_depth(datasets.BaseDataset.wire))
    out = _run(harness, capsys, cell="tum_fr1.orbit_holes")
    assert out["correct"] is False
    bad = {c["name"]: c["value"] for c in out["checks"]}
    assert bad["reader.depth_mismatch"] > 0


@pytest.mark.cuda
def test_the_control_fails_on_the_card(harness, capsys, card):
    """The TF32 control (the decoders' matmuls in TF32) at a small size
    on the card: the sound run passes, the control does not."""
    for cell in ("replica.orbit", "tum_fr1.orbit_holes"):
        assert _run(harness, capsys, cell=cell, device=card)["correct"]
        out = _run(harness, capsys, cell=cell, device=card,
                   extra=("--control", "tf32"))
        assert out["correct"] is False, out["checks"]
