"""Port parity, profiling/cond_dup_probe.py, crash_bisect.py and
crash_bisect2.py, and the four modules of the last profiling slice on the
host.

cond_dup_probe's per-stage counts on the tiny synthetic config over the
ray kNN's path (the packed table, K1's plain version here): one feature
gather and one backward scatter of rays x samples x k rows in each
stage, which at bench.py's config is the JAX probe's literal 200000 rows
from (131072, 72). crash_bisect's radius maps of frame 0 against JAX's
``Mapper.radius_maps`` on the same configuration, within the 1e-5
relative that test_torch_mapper.py holds a window's r_query to (Sobel and
interpolation); its candidate pool exactly. Each module's main runs with
``--device cpu`` at a tiny size and reports finite values."""

import math
import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu_torch.profiling import (cond_dup_probe, crash_bisect,
                                            crash_bisect2, dp_scaling)

from torch_parity import HERE, n, tiny_cfgs


def test_cond_dup_probe_counts_one_gather_and_one_scatter_a_stage():
    _, cfg = tiny_cfgs(4)
    cfg["cuda"].update({"ray_knn": True, "knn_packed_coords": True})
    # the probe runs one iteration a stage: the mapped frames need few
    cfg["mapping"].update({"iters_first": 2, "iters": 2,
                           "geo_iter_first": 0})
    res = cond_dup_probe.probe(cfg, torch.device("cpu"))
    rows = res["signatures"]["feat_rows"]
    assert rows == 400 * 5 * 8
    for name, st in res["stages"].items():
        assert st["feat_gather"] == 1, (name, st)
        assert st["scatter"] == 1 and st["scatter_rows"] == [rows], st
        assert st["k1_launches"] == 0 and st["device_ms"] is None
    assert res["duplicated"] == [] and res["answer"].startswith("no")


def test_cond_dup_probe_signatures_give_the_jax_literals():
    with open(os.path.join(HERE, "profiling", "cond_dup_probe.py")) as f:
        text = f.read()
    literals = {int(v) for v in re.findall(r"f32\\\[(\d+),72\\\]", text)}
    sig = cond_dup_probe.signatures(dp_scaling.config(1, bench_shapes=True))
    assert literals == {sig["feat_rows"], sig["leaf"][0]} == {200000, 131072}
    assert sig["leaf"][1] == 72


def _jax_config(small=True):
    from point_slam_tpu.config import load_config
    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", "room.yaml"),
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    for sec, upd in crash_bisect.overrides(small=small).items():
        cfg["tpu" if sec == "cuda" else sec].update(upd)
    cfg["verbose"] = False
    return cfg


def test_crash_bisect_radius_maps_match_jax():
    from point_slam_tpu import mapper as JM
    from point_slam_tpu.datasets import get_dataset
    from point_slam_tpu.models import decoders as JD
    jcfg = _jax_config()
    jm = JM.Mapper(jcfg, JD.init_decoders(jax.random.key(0), jcfg), 100,
                   np.random.default_rng(0))
    _, color, _, _ = get_dataset(jcfg)[0]
    jmaps = jm.radius_maps(jnp.asarray(color))
    tm = crash_bisect.make_mapper(crash_bisect.config(small=True), "cpu")
    tmaps = tm.radius_maps(torch.as_tensor(np.asarray(color)))
    for a, b in zip(tmaps[:2], jmaps[:2]):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5)
    np.testing.assert_array_equal(n(tmaps[2]), np.asarray(jmaps[2]))
    np.testing.assert_array_equal(n(tmaps[3]), np.asarray(jmaps[3]))


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


RUNS = {
    "dp_scaling": (dp_scaling, ["--small"]),
    "cond_dup_probe": (cond_dup_probe, ["--small"]),
    "crash_bisect": (crash_bisect, ["all", "0", "--small"]),
    "crash_bisect2": (crash_bisect2, ["4", "--small"]),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_every_module_runs_on_the_host(name, capsys):
    module, argv = RUNS[name]
    out = module.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert out and text.strip() and _finite(out)
    assert os.path.exists(out["path"])
    assert out["path"].startswith(os.path.join(HERE, "output", "torch"))
    if name == "dp_scaling":
        assert out["ok"] and "AUDIT PASS" in text
    elif name == "cond_dup_probe":
        assert "not measured (cpu)" in text
    elif name == "crash_bisect":
        assert text.count("OK ") == 12
    else:
        assert out["n_points"] > 0 and "map_frame(0)" in text
