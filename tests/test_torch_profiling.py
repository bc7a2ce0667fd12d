"""The port's layer-measurement tools (point_slam_tpu_torch/profiling)
against the JAX package and the TPU scripts, on the host at small sizes.

(a) roofline: every rung's operation, byte and gather counts equal to
    profiling/roofline.py's iteration_model at the same arguments (as
    integers); the peaks are the H100's, none of the TPU's.
(b) the mapping-iteration ladder (iter_breakdown) at 48x64, CAP 2^12 and
    ~2,000 points, with JAX's pixel draws and fill replayed: rung 2 against
    knn.ray_grid_knn (test_torch_knn.py's tolerances: valid and compact
    equal, ids equal on >= 99.9% of slots, quantised distances within
    2^-11); rungs 3/4 against mapper._losses (1e-4 relative) and rungs 5/6
    against jax.grad (2e-3 of the largest entry; test_torch_mapper.py's);
    rungs 7, 8, 10 against adam.update and rung 9 against adam.update_rows
    (the Pallas kernel in interpret mode) at t = 1: an Adam step is
    lr x g / (|g| + eps), so where |g| is at least twice the gradient
    tolerance (4e-3 of the largest) its sign is settled and the stepped
    entries agree within 1e-3 of lr; elsewhere within 2 lr, the step's
    whole range.
(c) the sampling stages' median is bit-equal to JAX's masked_median_sort
    and masked_median.
(d) the gather and scatter micros equal jnp.take and .at[].add, exactly
    (dyadic inputs: every sum is exact in f32, in any order).
(e) trace_ops.analyze on a canned Chrome trace gives roofline.parse_trace
    the expected bucket sums; a trace without device activity says so;
    a --small --device cpu capture analyses to a non-empty table.
(f) every script's main runs with --device cpu at its smallest sizes.
"""

import json
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from point_slam_tpu import mapper as JM
from point_slam_tpu import pointcloud as jpc
from point_slam_tpu import renderer as JR
from point_slam_tpu.common import image as jimg
from point_slam_tpu.ops import adam as jadam
from point_slam_tpu.ops import knn as jk
from point_slam_tpu_torch import mapper as TM
from point_slam_tpu_torch import renderer as TR
from point_slam_tpu_torch.common import image as timg
from point_slam_tpu_torch.profiling import (
    feat_adam_micro, frame_overhead, gather_scatter_micro, hw_calibration,
    iter_breakdown, iter_cost, knn8_micro, knn_ray, latency_floor,
    map_frame_overhead, render_breakdown, roofline, sample_stages,
    scatter_micro, step_cost, trace_map_iter, trace_ops,
    track_frame_overhead, tracker_cost, upload_micro)

from torch_parity import HERE, Scene, jax_fill, n, t

sys.path.insert(0, os.path.join(HERE, "profiling"))

LR = iter_breakdown.LR


# ------------------------------------------------------------ (a) roofline

@pytest.mark.parametrize("cap", [1 << 15, 1 << 17])
def test_roofline_counts_equal_the_jax_model(cap):
    import roofline as jroof
    jrungs, jpeak = jroof.iteration_model(R=1000, cap=cap)
    trungs, tpeak = roofline.iteration_model(R=1000, cap=cap)
    assert list(trungs) == list(jrungs)
    for name, j in jrungs.items():
        for key in ("flops_mxu", "flops_vpu", "hbm_bytes"):
            assert trungs[name][key] == j[key], (name, key)
            assert int(trungs[name][key]) == int(j[key]), (name, key)
        assert tuple(trungs[name]["gather"]) == tuple(j["gather"]), name
    tpu = {jroof.PEAK_BF16, jroof.PEAK_F32_HIGHEST, jroof.PEAK_VPU,
           jroof.HBM_BW}
    port = {tpeak, roofline.HBM_BYTES_PER_S, roofline.F32_FLOP_PER_S,
            roofline.TF32_FLOP_PER_S, roofline.BF16_FLOP_PER_S}
    assert not port & tpu
    assert tpeak == roofline.F32_FLOP_PER_S == 67e12
    assert roofline.iteration_model(mlp_precision="default")[1] == 495e12
    assert not hasattr(roofline, "ROW_RATE")


def test_chip_smoke_reads_the_roofline_peaks():
    src = open(os.path.join(HERE, "chip_smoke.py")).read()
    assert "from point_slam_tpu_torch.profiling.roofline import" in src
    assert "HBM_BYTES_PER_S = " not in src and "F32_FLOP_PER_S = " not in src


# ------------------------------------------------------------ (b) the ladder

COMMON = dict(h=48, w=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5, r_max=400,
              f_max=10, w_color_loss=0.1, frustum_edge=-4.0,
              fix_geo_decoder=True, n_add=3, near_end_surface_pc=0.98,
              far_end_surface_pc=1.02, add_max=600, grad_max=50, grad_top=250)
CAP = 1 << 12


@pytest.fixture(scope="module")
def ladder():
    """Frame 0 of the tiny config densified by JAX at CAP 2^12 (~2,000
    points, the packed cell table), in both packages; the port's Ladder
    over it; JAX's draws and its reference of every rung."""
    scene = Scene(packed_coords=True, cap=CAP)
    npts = int(scene.jcloud.n_points)
    jms = JM.MapperStatic(**COMMON, encode_exposure=False, max_iters=200)
    tms = TM.MapperStatic(**COMMON)
    f = COMMON["f_max"]
    _, color0, depth0, c2w0 = scene.frames[0]
    color = np.zeros((f, 48, 64, 3), np.float32)
    depth = np.zeros((f, 48, 64), np.float32)
    rq = np.full((f, 48, 64), 1e6, np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    color[0], depth[0], c2w[0] = color0, depth0, c2w0
    rq[0] = np.asarray(jimg.dynamic_radius_maps(jnp.asarray(color0), 0.08,
                                                0.02, 2, 0.15)[1])
    b = iter_breakdown.ladder_from(
        tms, TR.RenderConfig(ray_knn=True, knn_probes=27), scene.tdec,
        scene.tcloud.packed, scene.tindex, (t(color), t(depth), t(rq)),
        t(c2w), npts)
    key = jax.random.key(7)
    k_rays, k_render = jax.random.split(key)
    ki, kj = jax.random.split(k_rays)
    draw = (t(jax.random.randint(ki, (400,), 0, 64)),
            t(jax.random.randint(kj, (400,), 0, 48)), jax_fill(k_render))
    jwin = dict(color=jnp.asarray(color), depth=jnp.asarray(depth),
                r_query=jnp.asarray(rq))
    jrays = JM._sample_window_rays(jms, k_rays, jwin, jnp.asarray(1),
                                   jnp.asarray(400))
    jrc = JR.RenderConfig(ray_knn=True, knn_probes=27)
    packed = scene.jcloud.packed
    frustum = jnp.arange(CAP) < npts

    def losses(view, stage_color):
        def loss_fn(diff):
            p = {"col": diff["col"], "geo": scene.params["geo"]}
            return JM._losses(jms, jrc, p, view(diff["packed"]),
                              jnp.zeros((f, 8)), scene.jcloud.n_points,
                              scene.jindex, jrays, jnp.asarray(c2w),
                              k_render, stage_color)[0]
        return jax.jit(jax.value_and_grad(loss_fn))

    diff = {"col": scene.params["col"], "packed": packed}
    ident = lambda p: p
    ref = {"geo": losses(ident, False)(diff), "col": losses(ident, True)(diff),
           "bf16": losses(jpc.encode_render, True)(diff)}
    return dict(b=b, draw=draw, jrays=jrays, jc2w=jnp.asarray(c2w), jrc=jrc,
                scene=scene, ref=ref, frustum=frustum, npts=npts)


def _adam(p, g):
    z = jnp.zeros_like(p)
    return np.asarray(jadam.update(p, g, {"m": z, "v": z}, jnp.asarray(1.0),
                                   jnp.asarray(LR))[0])


def assert_step_close(got, want, g):
    """The stepped leaf's tolerance (see the module docstring)."""
    got, want, g = n(got), np.asarray(want), np.asarray(g)
    settled = np.abs(g) >= 4e-3 * np.abs(g).max()
    assert settled.sum() > 100
    np.testing.assert_allclose(got[settled], want[settled], rtol=0,
                               atol=1e-3 * LR)
    assert np.abs(got - want).max() <= 2 * LR * (1 + 1e-6)


def test_ladder_rung2_knn_matches_jax_ray_grid_knn(ladder):
    b = ladder["b"]
    rays = ladder["jrays"]
    o, d = JM._rays_world(rays, ladder["jc2w"])
    z, _ = JR.build_z_vals(ladder["jrc"], ladder["scene"].jindex, o, d,
                           rays["gt_depth"], rays["r_query"], rays["ray_ok"])
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    jd, jidx, jv, jc = jk.ray_grid_knn(ladder["scene"].jindex, pts, k=8,
                                       probes=27)
    td, tidx, tv, tc = iter_breakdown.rung_knn(b, ladder["draw"])
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    np.testing.assert_array_equal(n(tc), np.asarray(jc))
    assert n(tv).mean() > 0.5
    assert (n(tidx) == np.asarray(jidx)).mean() >= 0.999
    np.testing.assert_allclose(n(td), np.asarray(jd), rtol=2 ** -11)


@pytest.mark.parametrize("rung,stage", [(3, "geo"), (4, "col")])
def test_ladder_forward_losses_match_jax(ladder, rung, stage):
    fn = iter_breakdown.RUNGS[rung - 1][1]
    got = fn(ladder["b"], ladder["draw"])
    want = ladder["ref"][stage][0]
    assert float(want) > 0
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-4)


@pytest.mark.parametrize("rung,stage", [(5, "geo"), (6, "col")])
def test_ladder_gradients_match_jax(ladder, rung, stage):
    fn = iter_breakdown.RUNGS[rung - 1][1]
    got = n(fn(ladder["b"], ladder["draw"]))
    want = np.asarray(ladder["ref"][stage][1]["packed"])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("rung", [7, 8, 9, 10])
def test_ladder_steps_match_jax_adam(ladder, rung):
    """7: full buffer, frustum-masked, adam.update; 8: the compacted rows
    (JAX's gradient of packed.at[sel].set(rows) is its packed gradient at
    sel, zero on the padding); 9: adam.update_rows with the frustum;
    10: the bf16 view."""
    b = ladder["b"]
    fn = iter_breakdown.RUNGS[rung - 1][1]
    got = fn(b, ladder["draw"])[0]
    packed = ladder["scene"].jcloud.packed
    mask = ladder["frustum"][:, None]
    g = ladder["ref"]["bf16" if rung == 10 else "col"][1]["packed"]
    if rung in (7, 10):
        assert_step_close(got, _adam(packed, g * mask), g * mask)
    elif rung == 8:
        sel = np.asarray(n(b.sel))
        ok = sel < CAP
        rows = np.where(ok[:, None], np.asarray(packed)[np.minimum(sel,
                                                                   CAP - 1)],
                        0.0)
        g_rows = np.where(ok[:, None], np.asarray(g)[np.minimum(sel,
                                                                CAP - 1)],
                          0.0)
        assert b.n_sel == ladder["npts"] and ok.sum() == b.n_sel
        assert_step_close(got, _adam(jnp.asarray(rows), jnp.asarray(g_rows)),
                          g_rows)
    else:
        z = jnp.zeros_like(packed)
        want, _ = jadam.update_rows(packed, g, {"m": z, "v": z},
                                    jnp.ones(72), jnp.full(72, LR),
                                    ladder["frustum"])
        assert_step_close(got, want, g * mask)


def test_ladder_holds_run_on_the_host(ladder):
    """The smoke's kernel holds reach the plain versions on the host:
    equal to themselves, bit for bit."""
    b, d = ladder["b"], ladder["draw"]
    for res in (iter_breakdown.hold_ray_topk(b, d, "packed"),
                iter_breakdown.hold_row_adam(b, d)):
        assert res["equal"] and res["max_abs_err"] == 0


# ------------------------------------------------------------ (c) medians

@pytest.mark.parametrize("case", ["dense", "sparse", "negative", "empty"])
def test_sampling_median_is_bit_equal_to_jax(case):
    rng = np.random.default_rng({"dense": 0, "sparse": 1, "negative": 2,
                                 "empty": 3}[case])
    for _ in range(3):
        x = rng.uniform(0.0, 8.0, 5000).astype(np.float32)
        if case == "negative":
            x -= 4.0
        p = {"dense": 0.9, "sparse": 0.01, "negative": 0.5, "empty": 0.0}
        m = rng.random(5000) < p[case]
        got = n(timg.masked_median(t(x), t(m)))
        for ref in (jimg.masked_median_sort, jimg.masked_median):
            want = np.asarray(ref(jnp.asarray(x), jnp.asarray(m)))
            assert got.tobytes() == want.tobytes(), (case, ref.__name__)


# ------------------------------------------------------------ (d) gathers

def _dyadic(rng, shape):
    return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)


@pytest.mark.parametrize("fn", ["gather", "gather_backward", "index_add"])
def test_gather_scatter_micro_equals_jax(fn):
    rng = np.random.default_rng(4)
    cap, nq, k, w = 300, 200, 8, 72
    packed = _dyadic(rng, (cap, w))
    idx = rng.integers(0, cap, (nq, k))
    upd = _dyadic(rng, (nq, k, w))
    if fn == "gather":
        got = gather_scatter_micro.gather(t(packed), t(idx))
        want = jnp.take(jnp.asarray(packed), jnp.asarray(idx), axis=0)
    else:
        got = (gather_scatter_micro.gather_backward(t(packed), t(idx),
                                                    t(upd))
               if fn == "gather_backward" else
               gather_scatter_micro.index_add(cap, t(idx), t(upd)))
        want = jnp.zeros((cap, w)).at[jnp.asarray(idx)].add(jnp.asarray(upd))
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("layout", ["packed72", "2x32"])
def test_scatter_micro_gradients_equal_jax(layout):
    rng = np.random.default_rng(5)
    cap, q = 256, 100
    i = rng.integers(0, cap, (q, 8))
    w = _dyadic(rng, (q, 8)) / 4
    if layout == "packed72":
        src = _dyadic(rng, (cap, 72)) / 4
        got = [scatter_micro.grad72(t(src), t(i), t(w))]
        want = [jax.grad(lambda s: jnp.sum(jnp.sum(
            jnp.asarray(w)[..., None] * s[jnp.asarray(i)][..., :64],
            axis=1) ** 2))(jnp.asarray(src))]
    else:
        a, b = _dyadic(rng, (cap, 32)) / 4, _dyadic(rng, (cap, 32)) / 4

        def f(a, b):
            wi = jnp.asarray(w)[..., None]
            oa = jnp.sum(wi * a[jnp.asarray(i)], axis=1)
            ob = jnp.sum(wi * b[jnp.asarray(i)], axis=1)
            return jnp.sum(oa * oa) + jnp.sum(ob * ob)
        got = scatter_micro.grad2x32(t(a), t(b), t(i), t(w))
        want = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    for x, y in zip(got, want):
        assert np.abs(np.asarray(y)).max() > 0
        np.testing.assert_array_equal(n(x), np.asarray(y))


# ------------------------------------------------------------ (e) traces

def _kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": stream, "args": {"stream": stream, "device": 0}}


CANNED = [  # name, microseconds, bucket
    ("void ray_topk_persistent<0, 64>(RayTopkArgs)", 63.0, "knn"),
    ("void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>"
     "(at::cuda::detail::TensorInfo<float, unsigned int>)", 20.0, "knn"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_warpgroupsize"
     "1x1x1_execute_segment_k_off_kernel__5x_cublas", 150.0, "mlp"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>"
     "(cutlass_80_simt_sgemm_128x64_8x5_nn_align1::Params)", 90.0, "mlp"),
    ("void at::native::(anonymous namespace)::indexing_backward_kernel"
     "<float, 4>(long const*, long const*, float const*, float*, long)",
     120.0, "grad_scatter"),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::"
     "gpu_index_kernel<at::native::index_kernel_impl<at::native::"
     "OpaqueType<4> >>(at::TensorIteratorBase&)>(long, auto)", 40.0,
     "feat_gather"),
    ("void cub::CUB_200200_900_NS::DeviceRadixSortOnesweepKernel<cub::"
     "DeviceRadixSortPolicy<long, long, unsigned int>::Policy900, true>()",
     30.0, "sort"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, at::detail::Array<char*, 3> >(int, auto)",
     200.0, "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor>>>()",
     25.0, "elementwise"),
    ("my_unlisted_kernel", 5.0, "other"),
]


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_trace_ops_analyze_feeds_the_roofline_buckets(tmp_path):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
               "dur": 2000.0, "pid": 1, "tid": 1}]
    ts = 10.0
    for rep in range(3):                       # three "iterations"
        for name, dur, _ in CANNED:
            events.append(_kernel(name, ts, dur, stream=7 + (rep == 2)))
            ts += dur + 1.0
    events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD "
                   "(Pageable -> Device)", "ts": ts, "dur": 8.0, "pid": 0,
                   "tid": 7, "args": {"stream": 7}})
    path = str(tmp_path / "trace.json")
    _write_trace(path, events)
    res = trace_ops.analyze(path, top=3)
    assert res["device"] and set(res["streams"]) == {7, 8}
    busy = sum(s["busy_ms"] for s in res["streams"].values())
    assert abs(busy - (3 * sum(d for _, d, _ in CANNED) + 8.0) / 1e3) < 1e-9
    assert res["window_ms"] >= busy
    buckets = roofline.parse_trace(res["listing"])
    want = {}
    for _, dur, bucket in CANNED:
        want[bucket] = want.get(bucket, 0.0) + 3 * dur / 1e3
    want["memcpy"] = 8.0 / 1e3
    assert set(buckets) == set(want)
    for k, v in want.items():
        assert abs(buckets[k][0] - v) < 1e-4, (k, buckets[k][0], v)
    assert buckets["mlp"][1] == 6
    rows = roofline.table(*roofline.iteration_model(R=1000, cap=1 << 15))
    checks = roofline.check(buckets, rows, 3)
    assert [c["buckets"] for c in checks] == [list(g) for g, _ in
                                              roofline.CHECKS]
    by = {tuple(c["buckets"]): c for c in checks}
    assert abs(by[("knn",)]["measured_ms"] - 0.083) < 1e-6


def test_trace_without_device_activity_reports_no_busy_time(tmp_path):
    path = str(tmp_path / "host.json")
    _write_trace(path, [{"ph": "X", "cat": "cpu_op", "name": "aten::add",
                         "ts": 0.0, "dur": 5.0, "pid": 1, "tid": 1}])
    res = trace_ops.analyze(path)
    assert not res["device"] and res["streams"] == {}
    assert res["listing"] and "aten::add" in res["listing"][0]


def test_trace_ops_small_cpu_capture_analyses(tmp_path, capsys):
    res = trace_ops.main(["capture", str(tmp_path), "--small", "--device",
                          "cpu", "--warm", "1", "--traced", "1",
                          "--iters-first", "2", "--iters", "2"])
    assert os.path.exists(tmp_path / "trace.json")
    assert not res["device"] and len(res["listing"]) > 10
    assert "no device activity" in capsys.readouterr().out


# ------------------------------------------------------------ (f) scripts

SMALL = "--small"
RUNS = {
    "roofline": (roofline, ["--rays", "100", "--cap", "4096"]),
    "hw_calibration": (hw_calibration, ["--n", "32", "--copy-mb", "1",
                                        "--iters", "1"]),
    "gather_scatter_micro": (gather_scatter_micro, ["--cap", "512",
                                                    "--samples", "100",
                                                    "--iters", "1"]),
    "scatter_micro": (scatter_micro, ["--cap", "512", "--queries", "100",
                                      "--iters", "1"]),
    "latency_floor": (latency_floor, ["--queries", "50", "--table", "256",
                                      "--c", "8", "--calls", "1", "--n",
                                      "32"]),
    "trace_map_iter": (trace_map_iter, [SMALL, "--cap", "4096", "--points",
                                        "1000", "--iters", "2", "--top",
                                        "3"]),
    "iter_breakdown": (iter_breakdown, [SMALL, "--cap", "4096", "--points",
                                        "1000", "--iters", "1", "--repeats",
                                        "1"]),
    "render_breakdown": (render_breakdown, ["--cap", "2048", "--points",
                                            "1000", "--queries", "100",
                                            "--iters", "1"]),
    "sample_stages": (sample_stages, ["--frames", "2", "--height", "24",
                                      "--width", "32", "--rays", "100",
                                      "--iters", "1"]),
    "step_cost": (step_cost, [SMALL, "--cap", "8192", "--points", "1000",
                              "--budgets", "1,2", "--repeats", "1",
                              "--iters-first", "1"]),
    "iter_cost": (iter_cost, [SMALL, "--cap", "8192", "--budgets", "1,2"]),
    "tracker_cost": (tracker_cost, [SMALL, "--cap", "8192", "--budgets",
                                    "1,2", "--iters-first", "1"]),
    "map_frame_overhead": (map_frame_overhead, [SMALL, "--cap", "8192",
                                                "--points", "1000",
                                                "--reps", "1"]),
    "track_frame_overhead": (track_frame_overhead, [SMALL, "--cap", "8192",
                                                    "--iters-first", "1",
                                                    "--reps", "1"]),
    "frame_overhead": (frame_overhead, [SMALL, "--reps", "1"]),
    "feat_adam_micro": (feat_adam_micro, ["--cap", "512", "--queries",
                                          "100", "--iters", "1"]),
    "upload_micro": (upload_micro, ["--reps", "1", "--max-mb", "0.2"]),
    "knn8_micro": (knn8_micro, ["--queries", "100", "--iters", "1"]),
    "knn_ray": (knn_ray, ["--points", "2000", "--rays", "32", "--iters",
                          "1"]),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_every_script_runs_on_the_host(name, capsys):
    """(trace_ops runs in test_trace_ops_small_cpu_capture_analyses.)"""
    module, argv = RUNS[name]
    out = module.main(argv + ["--device", "cpu"])
    assert out is not None
    text = capsys.readouterr().out
    assert text.strip()
    # nothing the host ran is reported as the card's time
    assert "not measured" in text or name in ("roofline", "step_cost",
                                              "iter_cost", "tracker_cost",
                                              "track_frame_overhead",
                                              "knn_ray")
