"""Port parity, profiling/dp_scaling.py: the data-parallel collective audit.

The port's ``build(1)`` captures the same static configuration of the
first ``map_optimize`` call as the JAX script's (CAP, iterations, the
global ray batch, the window, the geometry bound); its pure ``audit``
gives the JAX script's ``audit_hlo`` verdicts on the same three patterns
(the gradient bucket present, a fatal gather of the packed rows, the
bucket missing), each written once as HLO text and once as the port's
records; and at world size 2 under gloo (two spawned processes at the
small toy) every rank passes the audit with the bytes equal to the
bucket's formula, the replicas are bit-equal and each rank's matmul FLOPs
are half of world size 1's (within 10%)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "profiling"))

import dp_scaling as jdps  # noqa: E402  (the JAX script; JAX on the CPU)

from point_slam_tpu_torch import pointcloud as pc  # noqa: E402
from point_slam_tpu_torch.profiling import dp_scaling as tdps  # noqa: E402

import torch_dist  # noqa: E402

JAX_GEO_BOUND_POS = 19      # JAX map_optimize's geo_iter_bound position
JAX_N_FRAMES_POS = 11


@pytest.fixture(scope="module")
def builds():
    """Both packages' build(1) at the toy shapes (JAX's takes ~30 s)."""
    from point_slam_tpu.parallel import mesh as pmesh
    try:
        _, jargs, _, _ = jdps.build(1)
    finally:
        pmesh.set_mesh(None)
    _, cap = tdps.build(tdps.config(1), "cpu")
    return jargs, cap


def test_build_captures_the_jax_scripts_static_configuration(builds):
    jargs, cap = builds
    jms, tms = jargs[0], cap.args[0]
    assert jargs[3].shape[0] == cap.args[3].shape[0] == 1 << 15
    assert int(jargs[jdps.N_ITERS_POS]) == cap.args[tdps.N_ITERS_POS] == 4
    assert jms.r_max == tms.r_max == tdps.GLOBAL_PIXELS == jdps.GLOBAL_PIXELS
    assert jms.f_max == tms.f_max
    assert (int(jargs[JAX_GEO_BOUND_POS]) == cap.args[tdps.GEO_BOUND_POS]
            == 2)
    assert int(jargs[JAX_N_FRAMES_POS]) == cap.args[6] == 1
    # the captured arguments are copies: the frames mapped after the
    # capture stepped the mapper's own
    assert cap.kwargs["n_live"] > 0


class _Compiled:
    """What audit_hlo reads of a compiled function."""

    def __init__(self, text):
        self.text = text

    def as_text(self):
        return self.text


CAP, N_ROWS, N_PARAMS = 1024, 300, 500
BUCKET = N_ROWS * pc.PACK_W + N_PARAMS + 3
_GRAD_HLO = (f"  %all-reduce.52 = (f32[], f32[128,32]{{1,0}}, "
             f"f32[{CAP},72]{{1,0}}) all-reduce(%a, %b, %c), channel_id=1, "
             f"to_apply=%add")
_SCALAR_HLO = "  %all-reduce.1 = f32[] all-reduce(%x), to_apply=%add"
_GATHER_HLO = (f"  %all-gather.3 = f32[{CAP},72]{{1,0}} all-gather(%p), "
               f"dimensions={{0}}")


def _rec(op, shape):
    numel = 1
    for d in shape:
        numel *= d
    return {"op": op, "dtype": "float32", "shape": list(shape), "parts": 1,
            "numel": numel, "bytes": 4 * numel}


PATTERNS = {
    "grad bucket present": ([_SCALAR_HLO, _GRAD_HLO],
                            [_rec("all_reduce", (BUCKET,))]),
    "fatal gather of the packed rows": (
        [_GRAD_HLO, _GATHER_HLO],
        [_rec("all_reduce", (BUCKET,)),
         _rec("all_gather", (N_ROWS, pc.PACK_W))]),
    "grad bucket missing": ([_SCALAR_HLO], [_rec("all_reduce", (3,))]),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_audit_gives_the_jax_audits_verdicts(name):
    hlo, records = PATTERNS[name]
    _, grad, fatal, _, _ = jdps.audit_hlo(_Compiled("\n".join(hlo)), CAP)
    jax_ok = bool(grad) and not fatal
    res = tdps.audit(records, N_ROWS, N_PARAMS, n_iters=1)
    assert res["ok"] == jax_ok
    assert bool(res["fatal"]) == bool(fatal)
    assert (res["grad_bucket_all_reduces"] >= 1) == (len(grad) >= 1)
    assert jax_ok == (name == "grad bucket present")


def test_audit_holds_the_bytes_to_the_bucket():
    one = [_rec("all_reduce", (BUCKET,))]
    assert tdps.audit(one * 2, N_ROWS, N_PARAMS, n_iters=2)["ok"]
    # a second, small all-reduce an iteration breaks the byte count
    res = tdps.audit(one + [_rec("all_reduce", (3,))], N_ROWS, N_PARAMS, 1)
    assert res["checks"] == {"a_one_grad_bucket_an_iteration": True,
                             "b_no_cloud_collective": True,
                             "c_bytes_equal_the_bucket": False}
    # a broadcast of as many elements as the live rows is fatal too
    res = tdps.audit(one + [_rec("broadcast", (N_ROWS * pc.PACK_W,))],
                     N_ROWS, N_PARAMS, 1)
    assert not res["checks"]["b_no_cloud_collective"]


def test_world_size_two_under_gloo(tmp_path):
    payload = {"device": "cpu", "small": True, "timed": False}
    one = tdps.rank_job({**payload, "world": 1})
    # without a group the loops issue no collective
    assert one["records"] == []
    ranks = torch_dist.spawn(tdps.rank_job, 2, tmp_path / "w2",
                             {**payload, "world": 2})
    for rec in ranks:
        a = rec["audit"]
        assert a["ok"], a
        assert a["by_op"] == {"all_reduce": rec["n_iters"]}
        assert a["bytes_an_iteration"] == (
            rec["n_rows"] * 72 + rec["n_params"] + rec["extra"] + 3) * 4
        assert rec["replicas_equal"]
        assert rec["n_rows"] == one["n_rows"]
        ratio = rec["flops_an_iteration"] / one["flops_an_iteration"]
        assert abs(ratio - 0.5) <= 0.05, ratio
    row = tdps.summarise(ranks, one["flops_an_iteration"])
    assert row["audit_ok"] and row["replicas_equal"]
    assert row["bytes_an_iteration"] == row["formula_bytes_an_iteration"]
