"""PointSLAM orchestrator: the lock-step tracking/mapping schedule.

The port of ``point_slam_tpu.slam``: frame 0 is mapped with its GT pose;
every later frame is tracked (frame 1 takes its GT pose), and every
``every_frame``-th frame and the last one are mapped again; with
``mapping.color_refine`` the sequence's last frame is mapped as the colour
refinement. A prefetch thread reads the next frames in wire form, copies
them to the device and computes their radius maps while the current frame
runs. The port runs on CUDA unless the caller asks for ``device="cpu"``.

Panels (``utils/visualizer.py``): after each mapped frame into
``mapping_vis/`` (with ``mapping.save_rendered_image`` the rendered colour
into ``rendered_image/``), or with ``mapping.vis_inside`` inside the
mapping loop instead; after each tracked, unmapped frame into
``tracking_vis/`` (and inside the loop with ``tracking.vis_inside``).
Frame 0, mapped before the loop, gets none, as in the JAX package.

Spans (``utils/spans.py``): ``slam.spans`` records the program's stages,
a span each (``frame`` > ``reader.wait``, ``track_frame``, ``map_frame``,
``log``; the tracker's and mapper's iterations and their stages inside;
``sync.*`` around each host read of the device), with counters, on the
profiler's clock, once ``slam.spans.enable()`` is called; the records are
``slam.spans.records()`` after the run. Recording is off by default. The
schedule's spans are always timed, and give ``timing`` and
``frame_times``. With ``cuda.profile_dir`` the run is traced by
``torch.profiler`` into a Chrome trace there, with the spans recorded and
each shown as a range of its name.

Under a process group (``parallel/dist.py``; ``cuda.data_parallel`` must
equal its size) every rank runs this schedule on its own replica and the
loops split their rays over the ranks; rank 0 alone writes the output
tree (checkpoints, the metrics sink, panels, point clouds, the trace).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from point_slam_tpu_torch.datasets import get_dataset
from point_slam_tpu_torch.mapper import Mapper
from point_slam_tpu_torch.models import decoders as D
from point_slam_tpu_torch.parallel import dist as pdist
from point_slam_tpu_torch.tracker import Tracker
from point_slam_tpu_torch.utils import spans


def update_cam(cfg) -> None:
    """Apply crop_size / crop_edge to the intrinsics in place."""
    cam = cfg["cam"]
    if "crop_size" in cam and cam["crop_size"] is not None:
        ch, cw = cam["crop_size"]
        sx, sy = cw / cam["W"], ch / cam["H"]
        cam["fx"] *= sx
        cam["fy"] *= sy
        cam["cx"] *= sx
        cam["cy"] *= sy
        cam["W"], cam["H"] = cw, ch
    e = cam.get("crop_edge") or 0
    if e > 0:
        cam["H"] -= 2 * e
        cam["W"] -= 2 * e
        cam["cx"] -= e
        cam["cy"] -= e


def _repo_path(path: str) -> str:
    """Resolve a config-relative artifact path against the repository root
    when it does not exist relative to the working directory."""
    if path and not os.path.isabs(path) and not os.path.exists(path):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        if os.path.exists(os.path.join(root, path)):
            return os.path.join(root, path)
    return path


class PointSLAM:
    def __init__(self, cfg, input_folder: Optional[str] = None,
                 output: Optional[str] = None, device="cuda"):
        """``device``: "cuda" (the default) or another torch device; the
        host runs the plain PyTorch versions of the kernels only when asked
        for with device="cpu"."""
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PointSLAM: CUDA is not available on this host; pass "
                'device="cpu" to run on the host instead')
        pdist.check_group(cfg)
        # rank 0 writes the output tree; the other ranks write nothing
        self.writer = pdist.is_writer()
        update_cam(cfg)
        if output:
            cfg["data"]["output"] = output
        self.output = cfg["data"]["output"]
        if self.writer:
            os.makedirs(os.path.join(self.output, "ckpts"), exist_ok=True)
            os.makedirs(os.path.join(self.output, "mesh"), exist_ok=True)

        self.dataset = get_dataset(cfg, input_folder)
        self.n_img = len(self.dataset)
        self.verbose = cfg.get("verbose", True)

        decoders = D.init_decoders(cfg, cfg["setup_seed"], self.device)
        pretrained = _repo_path(
            cfg.get("pretrained_decoders", {}).get("middle_fine", ""))
        D.load_pretrained_geo(decoders, pretrained)
        if cfg["mapping"].get("fix_geo_decoder") and not (
                pretrained and os.path.exists(pretrained)):
            # the frozen geometry decoder is a PRETRAINED one; a random one
            # is trained instead
            cfg["mapping"]["fix_geo_decoder"] = False
            if self.verbose:
                print("[init] no pretrained geo decoder found -> training it")

        rng = np.random.default_rng(cfg["setup_seed"])
        self.mapper = Mapper(cfg, decoders, self.n_img, rng, self.device)
        if self.verbose:
            print(f"[init] keyframe images on the "
                  f"{'host' if self.mapper.store.host_mode else 'device'} "
                  "ring", flush=True)
        self.tracker = Tracker(cfg, self.device)
        # the program's spans and counters; recording off until enabled
        self.spans = spans.Spans()
        self.estimate_c2w_list = np.zeros((self.n_img, 4, 4), np.float32)
        self.gt_c2w_list = np.zeros((self.n_img, 4, 4), np.float32)
        self.n_done = 0          # frames 0..n_done-1 have poses
        # wall-clock buckets (disjoint; sum to wall_active), each the sum
        # of the walls of the schedule's spans of its name: track/map the
        # two optimisation phases (track_frame, map_frame), wait = blocked
        # on the prefetch thread (reader.wait), io = direct dataset reads
        # on the main thread (reader.io, frame 0), log = the end-of-frame
        # panels, the metrics sink, checkpoints and point-cloud dumps
        # (log), other = the rest of each frame span
        self.timing: Dict[str, float] = {
            "track": 0.0, "map": 0.0, "io": 0.0, "wait": 0.0, "log": 0.0,
            "other": 0.0}
        # per-frame wall times (seconds, ending in a device sync)
        self.frame_times: Dict[int, Dict[str, float]] = {}
        from point_slam_tpu_torch.utils.mlog import MetricsLogger, NullSink
        self.mlog = (MetricsLogger(self.output, cfg,
                                   name=f"slam_{cfg.get('scene', 'scene')}")
                     if self.writer else NullSink())
        self.track_vis = self.map_vis = None
        if self.writer:
            self._init_visualizers()

    def _init_visualizers(self) -> None:
        """The tracking and mapping visualizers, and with vis_inside their
        hooks in the loops, which find the frame's depth and colour in
        ``_track_vis_frame`` / ``_map_vis_frame`` (set per frame)."""
        from point_slam_tpu_torch.utils.visualizer import Visualizer
        cfg, tr, mp = self.cfg, self.cfg["tracking"], self.cfg["mapping"]
        self.track_vis = Visualizer(
            tr["vis_freq"], tr["vis_inside_freq"],
            os.path.join(self.output, "tracking_vis"), verbose=self.verbose,
            vis_inside=bool(tr.get("vis_inside", False)))
        self.map_vis = Visualizer(
            mp["vis_freq"], mp["vis_inside_freq"],
            os.path.join(self.output, "mapping_vis"), verbose=self.verbose,
            vis_inside=bool(mp.get("vis_inside", False)),
            img_dir=os.path.join(self.output, "rendered_image")
            if mp["save_rendered_image"] else None)
        self._track_vis_frame: Dict[int, Any] = {}
        self._map_vis_frame: Dict[int, Any] = {}
        if self.map_vis.vis_inside:
            def map_hook(idx, it_prev, it_now, n_iters, cur_c2w):
                depth, color = self._map_vis_frame.get(idx, (None, None))
                if depth is not None:
                    self.map_vis.vis_chunk(idx, it_prev, it_now, n_iters,
                                           self.mapper, cur_c2w, depth,
                                           color)
            self.mapper.vis_hook = map_hook
        if self.track_vis.vis_inside:
            def track_hook(idx, it, total, cam):
                depth, color = self._track_vis_frame.get(idx, (None, None))
                if depth is None or idx % self.track_vis.freq != 0:
                    return
                from point_slam_tpu_torch.common import camera
                c2w = np.eye(4, dtype=np.float32)
                c2w[:3, :4] = camera.pose_matrix_from_tensor(cam).cpu().numpy()
                self.track_vis.vis(idx, it, total, self.mapper, c2w, depth,
                                   color, freq_override=True)
            self.tracker.vis_hook = track_hook

    def _frame(self, idx):
        with self.spans.timed("reader.io", frame=idx) as sp:
            _, color, depth, c2w = self.dataset[idx]
        self.timing["io"] += sp.s
        return color, depth, c2w

    def run(self, stop: Optional[int] = None,
            resume_from: Optional[str] = None) -> Dict[str, Any]:
        """Track and map frames 0..stop (all of them by default), or, with
        ``resume_from`` (a checkpoint path), the frames after the
        checkpoint's. With ``cuda.profile_dir`` the whole run is traced and
        the trace written there, also when the run fails, with the spans
        recorded and shown as ranges."""
        profile_dir = self.cfg["cuda"].get("profile_dir")
        if not profile_dir or not self.writer:
            return self._run(stop, resume_from)
        self.spans.enable(ranges=True)
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        try:
            return self._run(stop, resume_from)
        finally:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                profile_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"))

    def _run(self, stop: Optional[int], resume_from: Optional[str]
             ) -> Dict[str, Any]:
        from point_slam_tpu_torch.common import image as image_ops
        from point_slam_tpu_torch.utils.logger import (load_checkpoint,
                                                       restore_slam)
        from point_slam_tpu_torch.utils.memory import memory_report
        from point_slam_tpu_torch.utils.prefetch import FramePrefetcher

        t_run0 = time.perf_counter()
        cfg = self.cfg
        n = self.n_img if stop is None else min(stop + 1, self.n_img)
        tm, sp = self.timing, self.spans

        if resume_from:
            start = restore_slam(self, load_checkpoint(resume_from))
            if self.verbose:
                print(f"[resume] from {resume_from}: continuing at frame "
                      f"{start} with {self.mapper.n_points_host} points",
                      flush=True)
        else:
            start = 1
            with sp.span("frame", frame=0):
                color, depth, gt_c2w = self._frame(0)
                self.estimate_c2w_list[0] = gt_c2w
                self.gt_c2w_list[0] = gt_c2w
                with sp.timed("map_frame", frame=0) as m:
                    st = self.mapper.map_frame(0, color, depth, gt_c2w,
                                               gt_c2w)
                tm["map"] += m.s
                self.frame_times[0] = {"track": 0.0, "map": m.s}
            if self.verbose:
                print(f"[map] frame 0: +{st['n_added']} locations, "
                      f"{st['n_iters']} iters, geo {st['geo_loss']:.3f}",
                      flush=True)

        inv_scale = float(self.dataset.depth_inv_scale)
        dev = self.device

        def _stage(item):
            # device copy at wire width, decode and radius maps in the
            # prefetch thread, overlapping the current frame (one CUDA
            # stream orders them before the main thread's later work)
            i, packed, c2w = item
            color_d, depth_d = image_ops.decode_wire_frame(
                torch.from_numpy(packed).to(dev, non_blocking=True),
                inv_scale)
            return (i, color_d, depth_d, self.mapper.radius_maps(color_d),
                    c2w)

        prefetcher = FramePrefetcher(
            self.dataset, depth=int(cfg["cuda"].get("prefetch_depth", 4)),
            start=start, stop=n, stage=_stage, fetch=self.dataset.wire,
            spans=sp)
        pf_iter = iter(prefetcher)
        while True:
            # the last frame span only waits for the reader's end: it has
            # no frame
            with sp.timed("frame") as fr:
                with sp.timed("reader.wait") as wait:
                    item = next(pf_iter, None)
                tm["wait"] += wait.s
                if item is None:
                    break
                idx, color, depth, radius, gt_c2w = item
                fr.set_frame(idx)
                wait.set_frame(idx)
                acc0 = tm["track"] + tm["map"] + tm["log"]
                self._track_and_map(idx, n, color, depth, radius, gt_c2w)
            tm["other"] += (fr.s - wait.s
                            - (tm["track"] + tm["map"] + tm["log"] - acc0))

        self.n_done = n
        with sp.timed("log") as lg:
            self._dump_point_cloud(log_points_step=n - 1)
        tm["log"] += lg.s
        tm["prefetch_fetch"] = prefetcher.time_fetch
        tm["prefetch_stage"] = prefetcher.time_stage
        tm["wall_active"] = time.perf_counter() - t_run0
        self.mlog.log({"final_n_points": self.mapper.n_points_host,
                       **{f"time_{k}": v for k, v in tm.items()},
                       **{f"mem_{k}": v for k, v in
                          memory_report(self.device).items()}})
        return {
            "n_frames": n,
            "n_points": self.mapper.n_points_host,
            "keyframes": list(self.mapper.keyframe_list),
            "timing": dict(self.timing),
            "frame_times": dict(self.frame_times),
            "estimate_c2w_list": self.estimate_c2w_list[:n],
            "gt_c2w_list": self.gt_c2w_list[:n],
        }

    def _track_and_map(self, idx: int, n: int, color, depth, radius,
                       gt_c2w) -> None:
        """Frame ``idx`` of a run of ``n`` frames inside its frame span:
        track it, map it on the schedule's frames, log."""
        cfg, tm, sp = self.cfg, self.timing, self.spans
        mp = cfg["mapping"]
        lazy = mp["lazy_start"] or 0
        ef = 1 if (lazy and idx <= lazy) else mp["every_frame"]
        ckpt_freq = mp.get("ckpt_freq") or 0
        self.gt_c2w_list[idx] = gt_c2w
        if self.writer and self.track_vis.vis_inside:
            self._track_vis_frame = {idx: (depth, color)}
        if self.writer and self.map_vis.vis_inside:
            self._map_vis_frame = {idx: (depth, color)}

        with sp.timed("track_frame", frame=idx) as tr:
            res = self.tracker.track_frame(
                idx, color, depth, gt_c2w, self.estimate_c2w_list,
                self.mapper, radius[1],
                exposure_feat=self.mapper.exposure_feat)
        tm["track"] += tr.s
        self.estimate_c2w_list[idx] = res["c2w"]
        if res.get("tracked"):
            if self.verbose:
                print(f"[track] frame {idx}: loss "
                      f"{res['first_loss']:.2f}->{res['best_loss']:.2f}",
                      flush=True)
            with sp.timed("log", frame=idx) as lg:
                self.mlog.log({"idx_track": idx,
                               "track_first_loss": res["first_loss"],
                               "track_best_loss": res["best_loss"]})
            tm["log"] += lg.s

        t_map = 0.0
        if idx % ef == 0 or idx == n - 1:
            refine = (mp["color_refine"] and idx == n - 1
                      and idx == self.n_img - 1)
            with sp.timed("map_frame", frame=idx) as mf:
                st = self.mapper.map_frame(idx, color, depth, gt_c2w,
                                           self.estimate_c2w_list[idx],
                                           color_refine=refine,
                                           radius=radius)
            t_map = mf.s
            tm["map"] += t_map
            # BA refines the current pose during mapping
            self.estimate_c2w_list[idx] = st["cur_c2w"]
            if self.verbose:
                print(f"[map] frame {idx}: +{st['n_added']} locations, "
                      f"{st['n_iters']} iters, geo {st['geo_loss']:.3f}, "
                      f"col {st['color_loss']:.3f}, "
                      f"pts {st['n_points']}", flush=True)
            with sp.timed("log", frame=idx) as lg:
                self.mlog.log({"idx_map": idx, **{
                    k: v for k, v in st.items() if k != "cur_c2w"}})
                # with vis_inside the panels fired inside the loop
                if self.writer and not self.map_vis.vis_inside:
                    self.mlog.log_image("mapping_vis", self.map_vis.vis(
                        idx, st["n_iters"] - 1, st["n_iters"], self.mapper,
                        self.estimate_c2w_list[idx], depth, color,
                        save_rendered_image=mp["save_rendered_image"],
                        r_query=radius[1]), step=idx)
                if ckpt_freq and idx % ckpt_freq == 0 and idx != n - 1:
                    self.checkpoint(os.path.join(
                        self.output, "ckpts", f"{idx:05d}.npz"), idx)
                # the point-cloud mirror every 300 frames (the files are
                # written only at the end)
                if idx > 0 and idx % 300 == 0 and idx != n - 1:
                    self._dump_point_cloud(log_points_step=idx,
                                           write_files=False)
            tm["log"] += lg.s
        elif res.get("tracked") and self.writer:
            with sp.timed("log", frame=idx) as lg:
                self.mlog.log_image("tracking_vis", self.track_vis.vis(
                    idx, self.tracker.iters - 1, self.tracker.iters,
                    self.mapper, self.estimate_c2w_list[idx], depth, color,
                    r_query=radius[1]), step=idx)
            tm["log"] += lg.s
        self.frame_times[idx] = {"track": tr.s, "map": t_map}

    def checkpoint(self, path: str, idx: Optional[int] = None) -> None:
        """Rank 0 writes the checkpoint ``path``; every rank then waits for
        it at a barrier."""
        if self.writer:
            from point_slam_tpu_torch.utils.logger import save_checkpoint
            save_checkpoint(path, self, idx)
        pdist.barrier()

    def _dump_point_cloud(self, log_points_step: int = -1,
                          write_files: bool = True) -> None:
        """The surface input points with their colours as
        final_point_cloud.{npy,ply} and the neural points' positions as
        npc_cloud.npy (``write_files``), and their mirror to the metrics
        sink at ``log_points_step`` (>= 0); rank 0 only."""
        if not self.writer:
            return
        m = self.mapper
        with spans.span("sync.point_cloud"):
            ni = int(m.cloud.n_inputs)
            cloud_pos = m.cloud.input_pos[:ni].cpu().numpy()
            cloud_rgb = m.cloud.input_rgb[:ni].cpu().numpy()
            npc = (m.cloud.pos[:m.n_points_host].cpu().numpy()
                   if write_files else None)
        if write_files:
            from point_slam_tpu_torch.utils.ply import write_ply
            np.save(os.path.join(self.output, "final_point_cloud"),
                    np.hstack([cloud_pos, cloud_rgb]))
            np.save(os.path.join(self.output, "npc_cloud"), npc)
            ply_path = os.path.join(self.output, "final_point_cloud.ply")
            write_ply(ply_path, cloud_pos, colors=cloud_rgb / 255.0)
            self.mlog.log({"final_point_cloud_ply": ply_path})
        if log_points_step >= 0:
            self.mlog.log_points("input_pc", cloud_pos, cloud_rgb,
                                 step=log_points_step)
