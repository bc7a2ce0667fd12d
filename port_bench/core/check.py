"""How ``correct`` is decided: the timed path's renders and optimiser
steps against the plain reference (``reference/render.py``,
``reference/step.py``).

Inside the window the benchmark keeps, in every tracked and every mapped
frame (the last frame's copy stands), one iteration drawn from the seed:

- the render that iteration made (``Capture``): the map's packed rows and
  the decoders' weights as the program held them, the rays with their
  sensor depth, query radius and validity, the random fill, and what the
  render returned (depth, uncertainty, colour, valid ray);
- the optimiser step that iteration took (``Steps``): the state before
  it (the camera, or the map's rows and the decoders' weights, and Adam's
  moments of each), the batch it drew (the tracker's pixels with the
  frame's depth, colour and query radius images; the mapper's window rays
  with their window poses, the window's size, the frame's iteration count
  and its pose and depth), the gradients the program handed to Adam, and
  the state the next iteration starts from (the step as applied).

Once the window has closed and the program is freed, the reference
renders the same rays from the same map and weights, and takes the same
step from the same state: the loss, its gradient, the frustum of rows the
mapper may move, the learning rates and step counts of the
configuration's schedule, Adam. The configuration's ``limits`` name the
numbers compared:

- ``<track|map>.color_gap``, ``<track|map>.depth_gap``: the 99th
  percentile over the rays of the largest gap of a colour channel, and of
  the depth's gap over the reference's depth;
- ``<track|map>.step_gap``: the worst leaf's gap between the program's
  step and the reference's (``step.step_gaps``): a step left out reads 1;
- ``map.frozen_moved``: the largest move of a leaf the reference does not
  move (the map's positions, a frozen decoder), an exact comparison;
- ``reader.depth_mismatch``: pixels of the reader's depth that differ
  from the depth the benchmark wrote (exact). The reference follows the
  program step by step from the program's state (map, weights, moments,
  the sampled rays); this checks by itself the stage it skips.

The gradients' gaps (``<kind>.grad_gap``) and the rows whose frustum
test differs (``map.frustum_mismatch``) are reported beside them.
"""

from __future__ import annotations

import inspect
import math
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from reference import render as ref
from reference import step as ref_step

QUANTILE = 0.99


class Capture:
    """Wraps the program's ``render_rays``; keeps a copy of the call the
    driver armed for (the ``target``-th render of the current frame)."""

    def __init__(self, renderer_module):
        self._mod = renderer_module
        self._orig = renderer_module.render_rays
        self._sig = inspect.signature(self._orig)
        self.kind: Optional[str] = None
        self.target = -1
        self.count = 0
        self.kept: Dict[str, Dict[str, Any]] = {}
        self.calls: List[Dict[str, Any]] = []   # shapes for the FLOP count
        self.counting = False
        renderer_module.render_rays = self

    def restore(self) -> None:
        self._mod.render_rays = self._orig

    def arm(self, kind: Optional[str], target: int) -> None:
        self.kind, self.target, self.count = kind, target, 0

    def __call__(self, *args, **kwargs):
        out = self._orig(*args, **kwargs)
        if self.kind is None and not self.counting:
            return out
        a = self._sig.bind(*args, **kwargs)
        a.apply_defaults()
        p = a.arguments
        if self.counting:
            self.calls.append({"rays": int(p["rays_o"].shape[0]),
                               "stage_color": bool(p["stage_color"]),
                               "tracker": self.kind == "track"})
        if self.kind is not None and self.count == self.target:
            self.kept[self.kind] = _copy(p, out)
        self.count += 1
        return out


def _bind(fn):
    sig = inspect.signature(fn)

    def args(*a, **k):
        b = sig.bind(*a, **k)
        b.apply_defaults()
        return b.arguments
    return args


class Steps:
    """Wraps the program's tracking loss, mapping loss, mapping loop and
    Adam step; keeps the state around the step of the armed iteration
    (the ``target``-th loss of the current frame) and the state the next
    iteration starts from."""

    def __init__(self, tracker_module, mapper_module, adam_module,
                 refine_frame: int = -1):
        self._patched = []
        self.refine_frame = refine_frame  # mapped as the colour refinement
        self.kind: Optional[str] = None
        self.target = -1
        self.count = 0
        self.frame = -1
        self.cur: Optional[Dict[str, Any]] = None
        self.map_args: Dict[str, Any] = {}
        self.kept: Dict[str, Dict[str, Any]] = {}
        for mod, name, wrap in (
                (tracker_module, "tracking_loss", self._track_loss),
                (mapper_module, "_losses", self._map_loss),
                (mapper_module, "map_optimize", self._map_optimize),
                (adam_module, "update", self._update)):
            orig = getattr(mod, name)
            self._patched.append((mod, name, orig))
            setattr(mod, name, wrap(orig))

    def restore(self) -> None:
        for mod, name, orig in self._patched:
            setattr(mod, name, orig)

    def arm(self, kind: Optional[str], target: int, frame: int) -> None:
        self.kind, self.target, self.count, self.frame = (kind, target, 0,
                                                          frame)
        self.cur = None

    def _track_loss(self, orig):
        args = _bind(orig)

        def wrapped(*a, **k):
            if self.kind == "track":
                p = args(*a, **k)
                if self.count == self.target:
                    self.cur = {
                        "frame": self.frame, "it": self.count,
                        "cam": p["cam"].detach().clone(),
                        "i": p["i"].clone(), "j": p["j"].clone(),
                        "ok": None if p["pix_ok"] is None
                        else p["pix_ok"].clone(),
                        "fill": p["fill"].detach().clone(),
                        # the frame's buffers are the reader's, reused
                        "depth": p["gt_depth"].detach().clone(),
                        "color": p["gt_color"].detach().clone(),
                        "r_query": p["r_query_map"].detach().clone(),
                        "packed": p["packed"].detach().float().clone(),
                        "weights": _weights(p["dec"]),
                        "names": ["quad", "trans"],
                        "exposure": p["exposure_feat"] is not None}
                elif self.count == self.target + 1 and self.cur:
                    cam = p["cam"].detach()
                    self.cur["after"] = {"quad": cam[:4].clone(),
                                         "trans": cam[4:].clone()}
                    self.kept["track"], self.cur = self.cur, None
                self.count += 1
            return orig(*a, **k)
        return wrapped

    def _map_optimize(self, orig):
        args = _bind(orig)

        def wrapped(*a, **k):
            if self.kind == "map":
                p = args(*a, **k)
                _, depth, _, c2w = p["window"]
                slot = int(p["cur_slot"])
                self.map_args = {
                    "n_frames": int(p["n_frames"]),
                    "per_frame": int(p["pixs_per_image"]),
                    "n_iters": int(p["n_iters"]),
                    "frame_depth": depth[slot].detach().clone(),
                    "c2w": c2w[slot].detach().clone(),
                    "frustum_prog": p["frustum"].detach().clone(),
                    "ba": p["ba"] is not None}
            return orig(*a, **k)
        return wrapped

    def _map_loss(self, orig):
        args = _bind(orig)

        def wrapped(*a, **k):
            if self.kind == "map":
                p = args(*a, **k)
                if self.count == self.target:
                    self.cur = dict(
                        self.map_args, frame=self.frame, it=self.count,
                        refine=self.frame == self.refine_frame,
                        packed=p["packed"].detach().float().clone(),
                        weights=_weights(p["dec"]),
                        ptrs={q.data_ptr(): n for n, q in
                              p["dec"].named_parameters()},
                        rays={n: v.detach().clone()
                              for n, v in p["rays"].items()},
                        c2w_window=p["c2w_all"].detach().clone(),
                        fill=p["fill"].detach().clone(),
                        stage_color=bool(p["stage_color"]),
                        exposure=p["window_exposure"] is not None)
                elif self.count == self.target + 1 and self.cur:
                    self.cur["after"] = dict(
                        _weights(p["dec"]),
                        packed=p["packed"].detach().float().clone())
                    self.kept["map"], self.cur = self.cur, None
                self.count += 1
            return orig(*a, **k)
        return wrapped

    def _update(self, orig):
        def wrapped(params, grads, state, *a, **k):
            cur = self.cur
            if cur is not None and "m" not in cur \
                    and self.count == self.target + 1:
                if "names" in cur:
                    names = cur["names"]
                else:
                    names = ["packed"] + [cur["ptrs"].get(q.data_ptr(),
                                                          f"leaf{n}")
                                          for n, q in enumerate(params[1:])]
                for key, vals in (("m", state["m"]), ("v", state["v"]),
                                  ("grads", grads)):
                    cur[key] = {n: t.detach().clone()
                                for n, t in zip(names, vals)}
            return orig(params, grads, state, *a, **k)
        return wrapped


def _weights(dec) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in dec.state_dict().items()}


def compare_step(kept: Dict[str, Any], cfg: Dict[str, Any], kind: str,
                 device) -> Dict[str, float]:
    """The reference's step from a kept step's state, and the gaps to the
    program's step."""
    mv = lambda t: t.to(device) if isinstance(t, torch.Tensor) else t  # noqa
    k = {n: (mv(v) if not isinstance(v, dict)
             else {a: mv(b) for a, b in v.items()})
         for n, v in kept.items()}
    inf = {f"{kind}.step_gap": math.inf}
    if kind == "map":
        inf["map.frozen_moved"] = math.inf
    rc = render_settings(cfg, kind, k["packed"].shape[0])
    if k["exposure"] or k.get("ba") or "after" not in k or "m" not in k:
        return inf
    with torch.enable_grad():
        if kind == "track":
            k["m"] = [k["m"]["quad"], k["m"]["trans"]]
            k["v"] = [k["v"]["quad"], k["v"]["trans"]]
            r = ref_step.track_step(k, cfg, rc)
            before = {"quad": k["cam"][:4], "trans": k["cam"][4:]}
        else:
            mp = cfg["mapping"]
            fga = mp.get("fix_geo_decoder_after") or 0
            fix_geo = mp["fix_geo_decoder"] or (fga and k["frame"] >= fga)
            trained = [n for n in k["ptrs"].values()
                       if n.startswith("col.") or not fix_geo]
            r = ref_step.map_step(k, cfg, rc, trained)
            before = dict(k["weights"], packed=k["packed"])
    ref_after = dict(before, **r["after"])
    gaps = ref_step.step_gaps(before, k["after"], ref_after, k["grads"],
                              r["grads"])
    nums = {f"{kind}.step_gap": max(gaps["step"].values(), default=math.inf),
            f"{kind}.grad_gap": max(gaps["grad"].values(), default=math.inf),
            f"{kind}.left_out": float(len(gaps["left_out"]))}
    worst = max(gaps["step"], key=gaps["step"].get, default="")
    print(f"check: {kind} step at frame {k['frame']} iteration {k['it']}: "
          f"loss {r['loss']!r}; worst leaf {worst}; left out "
          f"{gaps['left_out']}", file=sys.stderr)
    if kind == "map":
        nums["map.frozen_moved"] = gaps["frozen_moved"]
        nums["map.frustum_mismatch"] = float(
            (r["rows"] != k["frustum_prog"]).sum())
    return nums


def _copy(p, out) -> Dict[str, Any]:
    det = lambda t: None if t is None else t.detach().clone()   # noqa: E731
    dec = p["dec"]
    return {
        "packed": p["packed"].detach().float().clone(),
        "weights": {k: v.detach().clone() for k, v in
                    dec.state_dict().items()},
        "rays_o": det(p["rays_o"]), "rays_d": det(p["rays_d"]),
        "gt_depth": det(p["gt_depth"]), "r_query": det(p["r_query"]),
        "ray_valid": det(p["ray_valid"]), "fill": det(p["fill"]),
        "stage_color": bool(p["stage_color"]),
        "apply_sigmoid": bool(p["apply_sigmoid_color"]),
        "exposure": p["exposure_feat"] is not None,
        "table": (int(p["index"].table_size), int(p["index"].max_per_cell)),
        "out": [det(t) for t in out[:4]],
    }


def render_settings(cfg: Dict[str, Any], kind: str, capacity: int):
    """The render settings of the configuration, as the reference reads
    them (the program resolves "auto" to the ray-shared search over the
    lattice-packed table on the card)."""
    r, pcl, cu = cfg["rendering"], cfg["pointcloud"], cfg["cuda"]
    cell = (pcl["radius_query_ratio"] * pcl["radius_add_max"]
            if cfg["use_dynamic_radius"]
            else max(pcl["radius_query"], pcl["radius_add"]))
    return {
        "n_surface": r["N_surface"], "near_end": r["near_end"],
        "near_end_surface": r["near_end_surface"],
        "far_end_surface": r["far_end_surface"],
        "sample_near_pcl": bool(r["sample_near_pcl"]),
        "sigmoid_coef": r["sigmoid_coef_tracker" if kind == "track"
                          else "sigmoid_coef_mapper"],
        "nn_num": pcl["nn_num"], "min_nn_num": pcl["min_nn_num"],
        "weighting": pcl["nn_weighting"],
        "encode_rel_pos_in_col": bool(cfg["model"]["encode_rel_pos_in_col"]),
        "knn_probes": int(cu.get("knn_probes", 0)) or 36,
        "cell_size": float(cell),
        "table_size": ref.table_size(cu["grid_table_size"], capacity),
        "max_per_cell": int(cu["grid_max_per_cell"]),
    }


def _quantile(x: torch.Tensor) -> float:
    x = x.double()
    if not bool(torch.isfinite(x).all()):
        return math.inf
    return float(torch.quantile(x, QUANTILE)) if x.numel() else math.inf


def compare(kept: Dict[str, Any], cfg: Dict[str, Any], kind: str,
            device) -> Dict[str, float]:
    """The reference's render of a kept call and the gaps to the
    program's."""
    mv = lambda t: t.to(device)                                 # noqa: E731
    packed = mv(kept["packed"])
    rc = render_settings(cfg, kind, packed.shape[0])
    nums: Dict[str, float] = {}
    if kept["exposure"] or (rc["table_size"], rc["max_per_cell"]) \
            != kept["table"]:
        # the reference covers neither; the run cannot be judged
        return {f"{kind}.depth_gap": math.inf, f"{kind}.color_gap": math.inf}
    depth, unc, color, valid = ref.render(
        packed, {k: mv(v) for k, v in kept["weights"].items()},
        mv(kept["rays_o"]), mv(kept["rays_d"]), mv(kept["gt_depth"]),
        mv(kept["r_query"]), mv(kept["ray_valid"]), mv(kept["fill"]), rc,
        kept["stage_color"], kept["apply_sigmoid"])
    p_depth, _, p_color, p_valid = (mv(t) for t in kept["out"])
    denom = torch.clamp(depth.abs(), min=1e-3)
    gaps = {"depth_gap": (p_depth - depth).abs() / denom,
            "color_gap": (p_color - color).abs().amax(-1)}
    for name, g in gaps.items():
        nums[f"{kind}.{name}"] = _quantile(g)
        nums[f"{kind}.{name}_max"] = float(g.max()) if g.numel() \
            else math.inf
        nums[f"{kind}.{name}_mean"] = float(g.double().mean()) \
            if g.numel() else math.inf
    nums[f"{kind}.valid_ray_mismatch"] = float((p_valid != valid).float()
                                               .mean())
    return nums


def reader_mismatch(dataset, depth_u16: List[np.ndarray], frames: List[int],
                    crop: int) -> float:
    """Pixels of the reader's depth (its wire form) that differ from the
    depth the benchmark wrote, over ``frames``."""
    bad = 0
    for i in frames:
        _, packed, _ = dataset.wire(i)
        got = np.ascontiguousarray(packed[..., 3:5]).view(np.uint16)[..., 0]
        want = depth_u16[i][crop:-crop, crop:-crop] if crop else depth_u16[i]
        bad += int((got != want).sum()) if got.shape == want.shape \
            else got.size
    return float(bad)


def verdict(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, lines): each compared number beside its limit."""
    ok = True
    lines = []
    for name, limit in limits.items():
        v = nums.get(name, math.inf)
        passed = v <= limit and not math.isnan(v)
        ok &= passed
        lines.append({"name": name, "value": v, "limit": limit,
                      "ok": passed})
    return ok, lines
