"""Process groups for the port's data-parallel tests (test_torch_parallel.py).

``spawn(job, world, tmp_dir, payload)`` runs ``job(payload)`` on
``world`` spawned processes, each a rank of a gloo group over a FileStore
under ``tmp_dir`` with a finite timeout, through the port's own launcher
(``point_slam_tpu_torch.parallel.dist.Ranks``), and returns what each
rank returned. The ranks are joined with a time limit and killed when it
runs out, so a hung collective fails the test instead of holding the run.

The jobs are here, beside the harness, because a spawned child imports
its target by module: this module imports torch and the port only, never
JAX (the JAX side of a comparison runs in the test process). Every job
also runs in one process without a group (``group=False``): the
world-size-1 run without collectives.
"""

import copy
import os

import numpy as np
import torch

from point_slam_tpu_torch.parallel import dist as pdist

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(HERE, "configs")


def spawn(job, world, tmp_dir, payload=None, group=True):
    """``job(payload)`` on each of ``world`` ranks (``group`` False: one
    process without a group); their results in rank order. Raises if a
    rank fails or any still runs after ``pdist.RANKS_TIMEOUT_S``."""
    with pdist.Ranks(world, "cpu", tmp_dir) as ranks:
        return ranks.run(job, payload, world, group)


# --------------------------------------------------------------- the jobs

def suite(payload):
    """The jobs named in ``payload["jobs"]``, one after another."""
    return {name: globals()[name](payload) for name in payload["jobs"]}


def tiny_cfg(dp, ba=False, exposure=False, fused=False):
    """tests/test_parallel.py's tiny config (32x40, CAP 2^11) for the port,
    at a total budget of 512 mapping and tracking rays."""
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(CONFIGS, "Synthetic", "room.yaml"),
                      os.path.join(CONFIGS, "point_slam.yaml"))
    cfg["synthetic"].update({"n_frames": 8, "angular_step": 0.02})
    cfg["cam"].update({"H": 32, "W": 40, "fx": 30.0, "fy": 30.0,
                       "cx": 19.5, "cy": 15.5})
    cfg["mapping"].update({
        "pixels": 512, "pixels_adding": 64, "pixels_based_on_color_grad": 16,
        "iters": 3, "iters_first": 3, "geo_iter_first": 1,
        "mapping_window_size": 3, "keyframe_every": 1, "BA": ba})
    # (test_parallel.py keeps the 20-pixel default edge, which leaves no
    # pixel of a 32x40 frame: jax.random.randint returns values anyway,
    # torch.randint refuses)
    cfg["tracking"].update({"pixels": 512, "iters": 6, "ignore_edge_W": 5,
                            "ignore_edge_H": 5})
    cfg["model"]["encode_exposure"] = exposure
    cfg["cuda"].update({"point_capacity_init": 1 << 11,
                        "point_capacity_max": 1 << 14,
                        "grid_table_size": 1 << 12, "grid_max_per_cell": 32,
                        "data_parallel": dp})
    if fused:
        cfg["cuda"].update({"knn_packed_coords": "fused", "fused_adam": True,
                            "ray_knn": True})
    cfg["verbose"] = False
    return cfg


VARIANTS = {"plain": {}, "ba": {"ba": True}, "exposure": {"exposure": True},
            "fused": {"fused": True}}
# the frames each variant maps in the tests: test_parallel.py's three, and
# six for BA, which starts only past four keyframes (frame 5)
VARIANT_FRAMES = {"plain": 3, "ba": 6, "exposure": 3, "fused": 3}


def _mapper(cfg):
    from point_slam_tpu_torch.datasets import get_dataset
    from point_slam_tpu_torch.mapper import Mapper
    from point_slam_tpu_torch.models import decoders as D
    ds = get_dataset(cfg)
    mapper = Mapper(cfg, D.init_decoders(cfg, cfg["setup_seed"]), len(ds),
                    np.random.default_rng(cfg["setup_seed"]), "cpu")
    return ds, mapper


def _state(mapper):
    n = mapper.n_points_host
    return {"packed": mapper.cloud.packed[:n].numpy().copy(), "n_points": n,
            "decoders": {k: v.numpy().copy() for k, v in
                         mapper.decoders.state_dict().items()}}


def map_frames(payload):
    """Each variant of ``payload["variants"]`` (name: n_map) mapped over
    frames 0..n_map-1 (test_parallel.py's run_frames); the final cloud,
    the decoders, the per-frame stats and the poses (BA moves them)."""
    from point_slam_tpu_torch.parallel import dist as pdist
    out = {}
    for name, n_map in payload["variants"].items():
        cfg = tiny_cfg(pdist.world(), **VARIANTS[name])
        ds, mapper = _mapper(cfg)
        stats = []
        for i in range(n_map):
            _, color, depth, c2w = ds[i]
            st = mapper.map_frame(i, color, depth, c2w, c2w)
            stats.append({k: v for k, v in st.items() if k != "cur_c2w"})
        out[name] = {**_state(mapper), "stats": stats,
                     "kf_c2w": np.stack(mapper.store.est_c2w),
                     "exposure": np.asarray(mapper.exposure_feat)}
    return out


def track_frame(payload):
    """test_parallel.py's run_track: map frames 0-2 with their GT poses,
    then track frame 3 (512 rays, 6 iterations)."""
    from point_slam_tpu_torch.parallel import dist as pdist
    from point_slam_tpu_torch.tracker import Tracker
    cfg = tiny_cfg(pdist.world())
    ds, mapper = _mapper(cfg)
    est = np.zeros((len(ds), 4, 4), np.float32)
    for i in range(3):
        _, color, depth, c2w = ds[i]
        mapper.map_frame(i, color, depth, c2w, c2w)
        est[i] = c2w
    tracker = Tracker(cfg, "cpu")
    _, color, depth, c2w = ds[3]
    color = torch.as_tensor(color)
    r_query = mapper.radius_maps(color)[1]
    return tracker.track_frame(3, color, torch.as_tensor(depth), c2w, est,
                               mapper, r_query)


def replay(payload):
    """On the parity scene that the test saved (``payload["state"]``): the
    mapping loss and packed gradient of one batch, one map_optimize
    iteration of each stage (packed leaf and statistics), a tracking run,
    with JAX's draws replayed; with ``handle_dynamic`` off, the tracking
    loss on the test's pixels whose halves have different error medians."""
    from point_slam_tpu_torch import mapper as TM
    from point_slam_tpu_torch import renderer as TR
    from point_slam_tpu_torch import tracker as TT
    from point_slam_tpu_torch.parallel import dist as pdist
    st = torch.load(payload["state"], weights_only=False)
    dec, cloud, index = st["dec"], st["cloud"], st["index"]
    rays = TM._sample_window_rays(TM.MapperStatic(**st["map_static"]),
                                  st["window"][:3], 2, 200, *st["map_ij"])
    far = TR.ray_far(rays["gt_depth"], rays["ray_ok"])
    rays = {k: pdist.shard(v) for k, v in rays.items()}
    out = {}
    for stage_color in (False, True):
        packed = cloud.packed.clone().requires_grad_(True)
        loss = TM._losses(TM.MapperStatic(**st["map_static"]),
                          TR.RenderConfig(), dec, packed, index, rays,
                          st["window"][3], stage_color, st["map_fill"],
                          far=far)[0]
        (grad,) = torch.autograd.grad(loss, [packed])
        loss = loss.detach()
        pdist.all_reduce_flat([grad, loss])
        out[f"map_{stage_color}"] = (loss, grad)
    for stage_color, draw in st["step_draws"].items():
        lr_geo, lr_col = st["step_lrs"]
        packed, stats, _, _ = TM.map_optimize(
            TM.MapperStatic(**st["map_static"]), TR.RenderConfig(),
            copy.deepcopy(dec), cloud.packed, index, st["window"], 2, 200,
            st["frustum"], lr_geo, lr_col, 1.0, -1 if stage_color else 0, 1,
            draws=[draw])
        out[f"step_{stage_color}"] = (packed, stats)
    ts = TT.TrackerStatic(**st["track_static"])
    color, depth, rq, cam = st["frame"]
    out["track"] = TT.track_optimize(
        ts, TR.RenderConfig(), dec, cloud.packed, index, color, depth, rq,
        cam, 0.002, len(st["track_draws"]), draws=st["track_draws"])
    med_ts = ts._replace(handle_dynamic=False)
    loss = TT.tracking_loss(med_ts, TR.RenderConfig(), dec, cloud.packed,
                            index, color, depth, rq, cam, *st["median_ij"],
                            st["map_fill"])[0].detach()
    pdist.all_reduce_flat([loss])
    out["median_loss"] = loss
    return out


def run_slam(payload):
    """A PointSLAM run on the tiny config (frames 0-4, a checkpoint at
    frame 2, mapping panels at frames 2 and 4 and a tracking panel at
    frame 3) with rank r writing to
    ``payload["out"]/rank{r}``; then PointSLAM with cuda.data_parallel
    one larger than the group, which must raise. Returns the run's poses
    and cloud, and the error's message."""
    from point_slam_tpu_torch.parallel import dist as pdist
    from point_slam_tpu_torch.slam import PointSLAM
    cfg = tiny_cfg(pdist.world())
    cfg["synthetic"]["n_frames"] = 5
    cfg["mapping"].update({"ckpt_freq": 2, "vis_freq": 2, "every_frame": 2,
                           "lazy_start": False, "save_rendered_image": True})
    cfg["tracking"].update({"vis_freq": 3, "iters": 3})
    slam = PointSLAM(cfg, output=os.path.join(payload["out"],
                                              f"rank{pdist.rank()}"),
                     device="cpu")
    summary = slam.run()
    slam.mlog.close()
    bad = tiny_cfg(pdist.world() + 1)
    try:
        PointSLAM(bad, output=os.path.join(payload["out"], "bad"),
                  device="cpu")
        err = None
    except ValueError as e:
        err = str(e)
    return {"est": summary["estimate_c2w_list"], **_state(slam.mapper),
            "error": err}


def map0_snapshots(payload):
    """tests/dp_deviation.py's probe: frame 0 of the synthetic room at
    48x64 (300 mapping rays, 30 iterations, the pretrained frozen geometry
    decoder) mapped by PointSLAM with ``payload["threads"]`` intra-op
    threads; the cloud after iterations 1, 10 and 30."""
    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.parallel import dist as pdist
    from point_slam_tpu_torch.slam import PointSLAM
    torch.set_num_threads(payload["threads"])
    cfg = load_config(os.path.join(CONFIGS, "Synthetic", "room.yaml"),
                      os.path.join(CONFIGS, "point_slam.yaml"))
    cfg["synthetic"]["n_frames"] = 1
    cfg["cam"].update({"H": 48, "W": 64, "fx": 40.0, "fy": 40.0,
                       "cx": 31.5, "cy": 23.5})
    cfg["mapping"].update({"pixels": 300, "pixels_adding": 200,
                           "pixels_based_on_color_grad": 40,
                           "iters_first": 30})
    cfg["cuda"].update({"point_capacity_init": 1 << 13,
                        "grid_table_size": 1 << 14, "max_iters_per_launch": 1,
                        "data_parallel": pdist.world()})
    cfg["verbose"] = False
    slam = PointSLAM(cfg, output=os.path.join(payload["out"],
                                              f"rank{pdist.rank()}"),
                     device="cpu")
    at = {}

    def hook(idx, it_prev, it_now, n_iters, c2w):
        if it_now in (1, 10):
            m = slam.mapper
            at[it_now] = m.cloud.packed[:m.n_points_host].numpy().copy()
    slam.mapper.vis_hook = hook
    slam.run()
    slam.mlog.close()
    m = slam.mapper
    at[30] = m.cloud.packed[:m.n_points_host].numpy().copy()
    return at
