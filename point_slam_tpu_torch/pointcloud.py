"""Dynamic neural point cloud as padded fixed-capacity device tensors.

The port of ``point_slam_tpu.pointcloud``. Geometry features, colour
features and positions live in ONE packed (CAP, 72) tensor,
[geo 0:32 | col 32:64 | pos 64:67 | pad 67:72], so the renderer fetches a
neighbour's state with one row gather, its backward is one scatter-add and
the mapper's Adam runs over one leaf with per-column learning rates. Empty
rows sit at 1e6 so they never fall in a query ball.

Densification keeps the JAX package's rules: a ray's surface point is
accepted only where no existing neighbour lies within its (per-ray) add
radius, and each accepted location adds N_add points along the ray with
N(0, 0.1) features. The point count stays a device tensor; callers read it
to the host once per frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from point_slam_tpu_torch.ops import knn
from point_slam_tpu_torch.utils import spans

C_DIM = 32
GEO_SL = slice(0, C_DIM)
COL_SL = slice(C_DIM, 2 * C_DIM)
POS_SL = slice(2 * C_DIM, 2 * C_DIM + 3)
PACK_W = 72


class CloudState(NamedTuple):
    packed: torch.Tensor     # (CAP, PACK_W) geo | col | pos | pad
    n_points: torch.Tensor   # () int64
    input_pos: torch.Tensor  # (CAP // N_add, 3) accepted surface locations
    input_rgb: torch.Tensor  # (CAP // N_add, 3) rgb * 255
    n_inputs: torch.Tensor   # () int64

    @property
    def pos(self) -> torch.Tensor:
        return self.packed[:, POS_SL]


# ------------------------------------------- bf16 render view (cuda.bf16_features)
#
# ``encode_render`` makes a (CAP, 72) bf16 view of the f32 master for the
# render path: the feature columns cast to bf16 (differentiable, so the
# neighbour gather's backward scatter-add runs at bf16 width and arrives
# as an f32 gradient on the master), the positions as a hi+lo bf16 pair a
# component (~1.5e-5 relative error, against 2e-3 for one bf16). hi is the
# TRUNCATED upper half of the f32 bits, as in the JAX package, so f32(hi)
# is exact and lo = pos - f32(hi) loses only its own rounding; a
# round-to-nearest cast would give another hi in about half the lanes.
POS_HI_SL = slice(2 * C_DIM, 2 * C_DIM + 3)
POS_LO_SL = slice(2 * C_DIM + 3, 2 * C_DIM + 6)


def encode_render(packed: torch.Tensor) -> torch.Tensor:
    """(CAP, 72) f32 master -> (CAP, 72) bf16 render view: differentiable
    in the feature columns; the position lanes carry no gradient."""
    feats = packed[:, GEO_SL.start:COL_SL.stop].to(torch.bfloat16)
    pos = packed[:, POS_SL].detach().contiguous()
    bits = pos.view(torch.int32)
    hi = (bits >> 16).to(torch.int16).view(torch.bfloat16)
    hi_f32 = (bits & -65536).view(torch.float32)
    lo = (pos - hi_f32).to(torch.bfloat16)
    pad = torch.zeros((packed.shape[0], PACK_W - POS_LO_SL.stop),
                      dtype=torch.bfloat16, device=packed.device)
    return torch.cat([feats, hi, lo, pad], dim=1)


def neighbor_geo(nb: torch.Tensor) -> torch.Tensor:
    """Geometry-feature columns of gathered rows, as f32 (either layout)."""
    return nb[..., GEO_SL].float()


def neighbor_col(nb: torch.Tensor) -> torch.Tensor:
    """Colour-feature columns of gathered rows, as f32 (either layout)."""
    return nb[..., COL_SL].float()


def neighbor_pos(nb: torch.Tensor) -> torch.Tensor:
    """Positions of gathered rows, as f32 (the hi+lo pair decoded)."""
    if nb.dtype == torch.bfloat16:
        return nb[..., POS_HI_SL].float() + nb[..., POS_LO_SL].float()
    return nb[..., POS_SL]


def _empty_rows(n: int, device) -> torch.Tensor:
    rows = torch.zeros((n, PACK_W), device=device)
    rows[:, POS_SL] = 1e6
    return rows


def init_cloud(capacity: int, c_dim: int, n_add: int,
               device="cpu") -> CloudState:
    if c_dim != C_DIM:
        raise NotImplementedError(f"the packed layout is fixed at c_dim={C_DIM}")
    icap = capacity // n_add
    zero = torch.zeros((), dtype=torch.long, device=device)
    return CloudState(_empty_rows(capacity, device), zero,
                      torch.zeros((icap, 3), device=device),
                      torch.zeros((icap, 3), device=device), zero.clone())


def grow_cloud(state: CloudState, new_capacity: int, n_add: int
               ) -> CloudState:
    """Capacity growth: padded rows appended at the end."""
    dev = state.packed.device
    extra = new_capacity - state.packed.shape[0]
    icap_extra = new_capacity // n_add - state.input_pos.shape[0]
    return CloudState(
        torch.cat([state.packed, _empty_rows(extra, dev)]), state.n_points,
        torch.cat([state.input_pos, torch.zeros((icap_extra, 3), device=dev)]),
        torch.cat([state.input_rgb, torch.zeros((icap_extra, 3), device=dev)]),
        state.n_inputs)


def new_point_features(n: int, generator: Optional[torch.Generator],
                       device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The N(0, 0.1) geometry and colour features of n new points."""
    return (0.1 * torch.randn((n, C_DIM), generator=generator, device=device),
            0.1 * torch.randn((n, C_DIM), generator=generator, device=device))


def add_points(state: CloudState, index, rays_o, rays_d, gt_depth, gt_color,
               ray_valid, dedup_radius, near_end_surface: float,
               far_end_surface: float, n_add: int = 3,
               fix_interval: bool = False,
               generator: Optional[torch.Generator] = None,
               feats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[CloudState, torch.Tensor]:
    """Densify the cloud from a fixed-size candidate ray batch (B rays).

    ``feats``: optional (geo, col) (B*n_add, 32) features for the new
    points; drawn from ``generator`` otherwise. Returns (new_state,
    n_accepted_locations as a device tensor). The caller guarantees
    capacity for B*n_add new points.
    """
    dev = rays_o.device
    cap = state.packed.shape[0]
    icap = state.input_pos.shape[0]
    b = rays_o.shape[0]

    valid = ray_valid & (gt_depth > 0)
    pts_gt = rays_o + rays_d * gt_depth[:, None]
    d, _, v = knn.grid_knn(index, pts_gt, k=8)
    counts = knn.neighbor_count(d, v, dedup_radius)
    # an empty cloud accepts everything
    accept = valid & ((counts == 0) | (state.n_points == 0))

    # input locations, one row per accepted ray (icap = dropped)
    loc_off = torch.cumsum(accept.long(), 0) - 1
    loc_dst = torch.clamp(torch.where(accept, state.n_inputs + loc_off, icap),
                          max=icap)
    trash = torch.zeros((1, 3), device=dev)
    input_pos = torch.cat([state.input_pos, trash])
    input_pos[loc_dst] = pts_gt
    input_rgb = torch.cat([state.input_rgb, trash])
    input_rgb[loc_dst] = gt_color * 255.0
    n_acc = accept.long().sum()

    # neural points: n_add per accepted location along the ray
    t_vals = torch.linspace(0.0, 1.0, n_add, device=dev)
    if fix_interval:
        z_vals = gt_depth[:, None] + torch.linspace(-0.04, 0.04, n_add,
                                                    device=dev)[None, :]
    else:
        z_vals = (near_end_surface * gt_depth[:, None] * (1.0 - t_vals)[None, :]
                  + far_end_surface * gt_depth[:, None] * t_vals[None, :])
    new_pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    pt_dst = torch.where(accept[:, None],
                         state.n_points + loc_off[:, None] * n_add
                         + torch.arange(n_add, device=dev)[None, :], cap)
    pt_dst = torch.clamp(pt_dst, max=cap).reshape(-1)

    geo, col = feats if feats is not None else new_point_features(
        b * n_add, generator, dev)
    rows = torch.cat([geo, col, new_pts.reshape(-1, 3),
                      torch.zeros((b * n_add, PACK_W - POS_SL.stop),
                                  device=dev)], dim=1)
    packed = torch.cat([state.packed, torch.zeros((1, PACK_W), device=dev)])
    packed[pt_dst] = rows
    return CloudState(packed[:-1], state.n_points + n_acc * n_add,
                      input_pos[:-1], input_rgb[:-1],
                      state.n_inputs + n_acc), n_acc


def build_index(state: CloudState, cell_size, table_size: int = 1 << 16,
                max_per_cell: int = 96, packed_coords=False):
    """Cell table over the cloud. ``packed_coords``: False (f32 planes),
    True (lattice-packed coords + id plane) or 'fused' (one coords|ids
    plane)."""
    build = (knn.build_fused_grid_index if packed_coords == "fused"
             else knn.build_packed_grid_index if packed_coords
             else knn.build_grid_index)
    return build(state.pos, state.n_points, cell_size, table_size,
                 max_per_cell)


def insert_index(state: CloudState, index, n_old, m: int):
    """Fold rows [n_old, n_points) (at most ``m`` of them) into the cell
    table; bit-identical to a full build_index over the grown cloud.
    Precondition: n_old + m <= capacity (the mapper guarantees it)."""
    ids = n_old + torch.arange(m, device=state.packed.device)
    rows = state.pos[torch.clamp(ids, max=state.packed.shape[0] - 1)]
    return knn.insert_grid_index(index, rows, ids, ids < state.n_points)


def sample_near_pcl(index, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    near, far, r_query: torch.Tensor, num: int = 5,
                    intervals: int = 25):
    """Depth-free rays: march ``intervals`` coarse samples from ``near`` to
    ``far``, keep rays with >= 2 samples near the cloud, and place ``num``
    z-values between the first two such samples (the segment ends at the
    SECOND near sample, not the last, as in the JAX package and the
    reference). ``far`` and ``r_query`` (per ray or scalar) may be tensors.

    Returns (z_vals (R, num), invalid (R,) True where not near the cloud).
    """
    r = rays_o.shape[0]
    dev = rays_o.device
    with torch.no_grad():
        z_sec = _linspace(near, far, intervals, dev)              # (I,)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_sec[None, :, None]
        d, _, v = knn.grid_knn(index, pts.reshape(-1, 3), k=8)
        rq = torch.as_tensor(r_query, dtype=torch.float32, device=dev)
        if rq.dim() == 1 and rq.shape[0] == r:
            rq = rq.repeat_interleave(intervals)                  # per ray
        has = knn.neighbor_count(d, v, rq).reshape(r, intervals) > 0
        invalid = has.sum(dim=1) < 2
        # near samples first, in order
        order = torch.sort((~has).to(torch.uint8), dim=1, stable=True).indices
        first = z_sec[order[:, 0]]
        second = z_sec[order[:, 1]]
        t = torch.linspace(0.0, 1.0, num, device=dev)
        z_near = first[:, None] * (1 - t)[None, :] + second[:, None] * t[None, :]
        z_uniform = _linspace(near, far, num, dev).expand(r, num)
        z_vals = torch.where(invalid[:, None], z_uniform, z_near)
    return z_vals.float(), invalid


def _linspace(start, stop, n: int, device) -> torch.Tensor:
    """jnp.linspace(start, stop, n) in f32 for scalar or 0-dim tensor
    endpoints, with its rounding: start*(1 - i/(n-1)) + stop*(i/(n-1)),
    and exactly ``stop`` last."""
    start = spans.upload(start, device, torch.float32)
    stop = spans.upload(stop, device, torch.float32)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


def frustum_mask(pos: torch.Tensor, n_points, w2c: torch.Tensor,
                 depth: torch.Tensor, fx, fy, cx, cy, edge) -> torch.Tensor:
    """Which cloud points are optimisable for the current frame: project
    (x flipped), bilinear depth lookup with zero outside the image, zero
    samples replaced by the max sampled depth, then inside the enlarged
    frustum and 0 <= -z <= depth + 0.5."""
    from point_slam_tpu_torch.common.camera import project_points
    h, w = depth.shape
    u, v, z = project_points(pos, w2c, fx, fy, cx, cy)
    x0 = torch.floor(u).long()
    y0 = torch.floor(v).long()
    du = u - x0
    dv = v - y0

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        val = depth[torch.clamp(yy, 0, h - 1), torch.clamp(xx, 0, w - 1)]
        return torch.where(inside, val, 0.0)

    samp = (tap(y0, x0) * (1 - du) * (1 - dv) + tap(y0, x0 + 1) * du * (1 - dv)
            + tap(y0 + 1, x0) * (1 - du) * dv + tap(y0 + 1, x0 + 1) * du * dv)
    samp = torch.where(samp == 0.0, samp.max(), samp)
    mask = (u < w - edge) & (u > edge) & (v < h - edge) & (v > edge)
    mask &= (0 <= -z) & (-z <= samp + 0.5)
    mask &= torch.arange(pos.shape[0], device=pos.device) < n_points
    return mask
