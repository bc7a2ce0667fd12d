"""Plain PyTorch reference of one render of the neural point map.

Given a map (the packed (CAP, 72) rows: geometry features 0:32, colour
features 32:64, position 64:67; empty rows at 1e6), the decoders' weights
and a batch of rays with their sensor depth and query radius, this works
out what Point-SLAM's renderer returns for each ray: the cell table over
the map's points, each ray's neighbour search, the depth-guided samples
(and, for depth-free rays with ``sample_near_pcl``, the samples between
the first two coarse samples near the map), the inverse-distance
interpolation of the neighbours' features, the geometry and colour MLPs,
and alpha compositing.

The neighbour search keeps the selection rules of Point-SLAM's GPU port
(a hashed cell table of ``max_per_cell`` slots a bucket over a
lattice-quantised copy of the positions; per ray the 4x4x4 cell box around
its samples, compacted to ``probes`` buckets, and per sample the top-k by
quantised squared distance, ties to the lower lane; rays whose samples
span more than the box search 27 cells per sample), written here from
those rules. Everything runs in float32 with TF32 off.

Nothing here imports the program under test.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict

import numpy as np
import torch

_P1, _P2, _P3 = 73856093, 19349669, 83492791
_U32 = 0xFFFFFFFF
_QBITS = 10
_QMASK = (1 << _QBITS) - 1
_QPERIOD = float(1 << _QBITS)
_Q_PER_CELL = 64.0
_INF_BITS = 0x7F800000
_BOX = 4
_EMPTY_POS = 1e5                 # rows at or past this are empty (1e6)

GEO = slice(0, 32)
COL = slice(32, 64)
POS = slice(64, 67)


# ------------------------------------------------------------- cell table

def _hash(cells: torch.Tensor, table: int) -> torch.Tensor:
    c = cells.long()
    h = (((c[..., 0] * _P1) & _U32) ^ ((c[..., 1] * _P2) & _U32)
         ^ ((c[..., 2] * _P3) & _U32))
    return h % table


def _cells(p: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    return torch.floor(p / cs).to(torch.int32)


def _quantum(cs: torch.Tensor) -> torch.Tensor:
    return cs / _Q_PER_CELL


def _pack(p: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    q = torch.floor(p / _quantum(cs) + 0.5).to(torch.int32) & _QMASK
    return q[..., 0] | (q[..., 1] << _QBITS) | (q[..., 2] << (2 * _QBITS))


def _lattice(q: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    ql = q / _quantum(cs)
    return ql - torch.floor(ql / _QPERIOD) * _QPERIOD


def _unpack(v: torch.Tensor):
    empty = v < 0
    return tuple(torch.where(empty, torch.inf,
                             ((v >> (a * _QBITS)) & _QMASK).float())
                 for a in range(3))


def _wrap(d: torch.Tensor) -> torch.Tensor:
    d = torch.where(d > _QPERIOD / 2, d - _QPERIOD, d)
    return torch.where(d < -_QPERIOD / 2, d + _QPERIOD, d)


class Table:
    """The hashed cell table over points 0..n-1: per bucket up to ``c``
    slots in id order, each the packed lattice coordinates and the id."""

    def __init__(self, pos: torch.Tensor, n: int, cell_size: float,
                 table: int, c: int):
        dev = pos.device
        self.cs = torch.tensor(cell_size, dtype=torch.float32, device=dev)
        self.table, self.c = table, c
        h = _hash(_cells(pos[:n], self.cs), table)
        order = torch.sort(h, stable=True).indices
        hs = h[order]
        first = torch.searchsorted(hs, hs, right=False)
        rank = torch.arange(n, device=dev) - first
        keep = rank < c
        slot = hs[keep] * c + rank[keep]
        self.coords = torch.full(((table + 1) * c,), -1, dtype=torch.int32,
                                 device=dev)
        self.ids = torch.full(((table + 1) * c,), torch.inf, device=dev)
        self.coords[slot] = _pack(pos[:n], self.cs)[order[keep]]
        self.ids[slot] = order[keep].float()
        self.coords = self.coords.reshape(table + 1, c)
        self.ids = self.ids.reshape(table + 1, c)


def _dedup(hs: torch.Tensor) -> torch.Tensor:
    p = hs.shape[1]
    ar = torch.arange(p, device=hs.device)
    dup = (hs[:, :, None] == hs[:, None, :]) & (ar[:, None] > ar[None, :])
    return ~dup.any(-1)


def grid_knn(t: Table, q: torch.Tensor, k: int = 8, block: int = 8192):
    """Per-sample top-k over the 27 cells around each query: (d2 (Q,k)
    in the lattice's units times its quantum squared, ids (Q,k), valid)."""
    off = torch.tensor([[x, y, z] for x in (-1, 0, 1) for y in (-1, 0, 1)
                        for z in (-1, 0, 1)], dtype=torch.int32,
                       device=q.device)
    g = _quantum(t.cs)
    outs = []
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block].float()
        nq = qb.shape[0]
        hs = _hash(_cells(qb, t.cs)[:, None, :] + off[None], t.table)
        ok = _dedup(hs)
        x, y, z = _unpack(t.coords[hs])
        ql = _lattice(qb, t.cs)
        dx = _wrap(x - ql[:, None, None, 0])
        dy = _wrap(y - ql[:, None, None, 1])
        dz = _wrap(z - ql[:, None, None, 2])
        d2 = (dx * dx + dy * dy + dz * dz) * (g * g)
        d2 = torch.where(ok[:, :, None], d2, torch.inf).reshape(nq, -1)
        width = d2.shape[1]
        shift = (width - 1).bit_length()
        lane = torch.arange(width, device=q.device)
        keys = (d2.view(torch.int32).long() << shift) | lane
        pos = torch.topk(keys, k, dim=1, largest=False, sorted=True)[1]
        dk = torch.gather(d2, 1, pos)
        ids = t.ids[torch.gather(hs, 1, pos // t.c), pos % t.c]
        valid = torch.isfinite(dk)
        outs.append((dk, torch.where(valid, ids, 0.0).long(), valid))
    return tuple(torch.cat(o) for o in zip(*outs))


@functools.lru_cache(maxsize=None)
def _probe_perms(p_ray: int):
    off = np.array([[x, y, z] for x in range(_BOX) for y in range(_BOX)
                    for z in range(_BOX)], np.int64)
    perms = np.zeros((8, p_ray), np.int64)
    n_valid = np.zeros(8, np.int64)
    for pat in range(8):
        ext = np.array([(pat >> 2 & 1) + 3, (pat >> 1 & 1) + 3,
                        (pat & 1) + 3])
        ok = np.all(off < ext, axis=1)
        center = (ext - 1) / 2.0
        d = np.abs(off - center).max(1) + 1e-3 * np.abs(off - center).sum(1)
        order = np.lexsort((np.arange(off.shape[0]), d, ~ok))
        perms[pat] = order[:p_ray]
        n_valid[pat] = min(int(ok.sum()), p_ray)
    return perms, np.arange(p_ray)[None, :] < n_valid[:, None]


def ray_knn(t: Table, q: torch.Tensor, k: int, probes: int,
            block: int = 512):
    """Ray-shared search over (R, ns, 3) samples: (ids (R*ns, k), valid,
    compact (R,)). A ray whose samples span more than the 4-cell box is
    not compact; its samples take ``grid_knn`` instead."""
    dev = q.device
    r, ns, _ = q.shape
    p_ray = min(max(probes, 1), _BOX ** 3)
    perms, slot_ok = _probe_perms(p_ray)
    perms = torch.as_tensor(perms, device=dev)
    slot_ok = torch.as_tensor(slot_ok, device=dev)
    off = torch.tensor([[x, y, z] for x in range(_BOX) for y in range(_BOX)
                        for z in range(_BOX)], dtype=torch.int32, device=dev)
    lanes = p_ray * t.c
    lane_mask = (1 << (lanes - 1).bit_length()) - 1
    ids_all, valid_all, compact_all = [], [], []
    for s in range(0, r, block):
        qb = q[s:s + block].float()
        rb = qb.shape[0]
        qc = _cells(qb, t.cs)
        cmin = qc.amin(1) - 1
        cmax = qc.amax(1) + 1
        start = torch.where(cmax - cmin + 1 > _BOX, cmin + 1, cmin)
        compact = torch.all(cmax - cmin + 1 <= _BOX, dim=-1)
        ext = torch.clamp(cmax - start + 1, 3, 4)
        pat = ((ext[:, 0] - 3) * 4 + (ext[:, 1] - 3) * 2
               + (ext[:, 2] - 3)).long()
        h = _hash(start[:, None, :] + off[None], t.table)
        hp = torch.where(slot_ok[pat], torch.gather(h, 1, perms[pat]),
                         t.table)
        rows = torch.where(_dedup(hp), hp, t.table)
        ql = _lattice(qb, t.cs)
        x, y, z = (a.reshape(rb, 1, lanes) for a in _unpack(t.coords[rows]))
        dx = _wrap(x - ql[:, :, 0:1])
        dy = _wrap(y - ql[:, :, 1:2])
        dz = _wrap(z - ql[:, :, 2:3])
        d2 = dx * dx + dy * dy + dz * dz
        lane = torch.arange(lanes, dtype=torch.int32, device=dev)
        keys = (d2.view(torch.int32) & ~lane_mask) | lane
        top = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
        win = (top & lane_mask).long()
        ids = torch.gather(t.ids[rows].reshape(rb, 1, lanes).expand(
            rb, ns, lanes), 2, win)
        valid = top < _INF_BITS
        ids_all.append(torch.where(valid, ids, 0.0).long().reshape(-1, k))
        valid_all.append(valid.reshape(-1, k))
        compact_all.append(compact)
    ids = torch.cat(ids_all)
    valid = torch.cat(valid_all)
    compact = torch.cat(compact_all)
    rep = compact.repeat_interleave(ns)
    if bool((~rep).any()):
        _, i_f, v_f = grid_knn(t, q.reshape(-1, 3)[~rep], k)
        ids[~rep] = i_f
        valid[~rep] = v_f
    return ids, valid, compact


# --------------------------------------------------------------- decoders

def _fourier(b: torch.Tensor, x: torch.Tensor, concat: bool):
    proj = (2.0 * math.pi * x) @ b
    if concat:
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    return torch.sin(proj)


def _lin(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def _softplus100(x):
    # the exponent is clipped where the linear branch is taken, so that
    # branch's gradient is never inf x 0
    return torch.where(100.0 * x > 20.0, x,
                       torch.log1p(torch.exp(torch.clamp(100.0 * x,
                                                         max=20.0))) / 100.0)


def _mlp(w, prefix, emb, c, act, blocks=5, skip=2):
    h = emb
    for i in range(blocks):
        h = act(_lin(w, f"{prefix}.pts_linears.{i}", h))
        h = h + _lin(w, f"{prefix}.fc_c.{i}", c)
        if i == skip:
            h = torch.cat([emb, h], dim=-1)
    return h


def geo_decoder(w, p, c):
    emb = _fourier(w["geo.embedder_B"], p, concat=False)
    h = _mlp(w, "geo", emb, c, torch.relu)
    return _lin(w, "geo.output_linear", h)[..., 0]


def col_decoder(w, p, c, apply_sigmoid: bool):
    emb = _fourier(w["col.embedder_B"], p, concat=True)
    h = _mlp(w, "col", emb, c, _softplus100)
    out = _lin(w, "col.output_linear", h)
    return torch.sigmoid(out) if apply_sigmoid else out


def neighbour_encoder(w, neigh_pos, p, feats):
    rel = neigh_pos - p[:, None, :]
    emb = _fourier(w["col.embedder_rel_B"], rel.reshape(-1, 3), concat=True)
    emb = emb.reshape(neigh_pos.shape[0], neigh_pos.shape[1], -1)
    x = torch.cat([emb, feats], dim=-1)
    return _lin(w, "col.mlp_col_neighbor.l2",
                _softplus100(_lin(w, "col.mlp_col_neighbor.l1", x)))


# --------------------------------------------------------------- sampling

def _linspace(start, stop, n: int, dev) -> torch.Tensor:
    start = torch.as_tensor(start, dtype=torch.float32, device=dev)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=dev)
    step = torch.arange(n - 1, dtype=torch.float32, device=dev) / (n - 1)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


def ray_far(depth, valid):
    pos = valid & (depth > 0)
    n = torch.clamp(pos.sum(), min=1)
    mean = torch.sum(torch.where(pos, depth, 0.0)) / n
    mx = torch.max(torch.where(pos, depth, -torch.inf))
    return torch.minimum(5.0 * mean, 1.2 * mx)


def near_map_samples(t: Table, ro, rd, near, far, rq, num: int,
                     intervals: int = 25):
    """Depth-free rays: ``num`` depths between the first two of
    ``intervals`` coarse samples that have a map point within the query
    radius, or uniform where fewer than two do. (z (R, num), invalid)."""
    r, dev = ro.shape[0], ro.device
    z_sec = _linspace(near, far, intervals, dev)
    pts = ro[:, None, :] + rd[:, None, :] * z_sec[None, :, None]
    d, _, v = grid_knn(t, pts.reshape(-1, 3), k=8)
    rqs = rq.repeat_interleave(intervals).reshape(-1, 1)
    has = (torch.sum((d < rqs * rqs) & v, -1) > 0).reshape(r, intervals)
    invalid = has.sum(1) < 2
    order = torch.sort((~has).to(torch.uint8), dim=1, stable=True).indices
    first, second = z_sec[order[:, 0]], z_sec[order[:, 1]]
    s = torch.linspace(0.0, 1.0, num, device=dev)
    z_near = first[:, None] * (1 - s)[None] + second[:, None] * s[None]
    z_uni = _linspace(near, far, num, dev).expand(r, num)
    return torch.where(invalid[:, None], z_uni, z_near), invalid


# ----------------------------------------------------------------- render

def render(packed: torch.Tensor, weights: Dict[str, torch.Tensor],
           rays_o, rays_d, gt_depth, r_query, ray_valid, fill,
           rcfg: Dict[str, Any], stage_color: bool,
           apply_sigmoid_color: bool = True):
    """(depth (R,), uncertainty (R,), colour (R,3), valid ray (R,)) of a ray
    batch. ``rcfg``: the render settings (n_surface, near_end,
    near/far_end_surface, sample_near_pcl, sigmoid_coef, nn_num,
    min_nn_num, weighting, encode_rel_pos_in_col, knn_probes, cell_size,
    table_size, max_per_cell). ``fill``: the (2, 32) features of samples
    without neighbours."""
    with ieee_f32(), torch.no_grad():
        return _render(packed, weights, rays_o, rays_d, gt_depth, r_query,
                       ray_valid, fill, rcfg, stage_color,
                       apply_sigmoid_color, False)


def render_train(packed, weights, rays_o, rays_d, gt_depth, r_query,
                 ray_valid, fill, rcfg, stage_color: bool,
                 apply_sigmoid_color: bool = True, pose_grad: bool = False):
    """``render`` with gradients: to the map's feature columns (never to
    its positions, which the optimiser does not move), to the decoders'
    weights, and with ``pose_grad`` to the rays through the sample points'
    distances to their neighbours (the tracker's pose gradient). The
    caller holds ``ieee_f32``."""
    return _render(packed, weights, rays_o, rays_d, gt_depth, r_query,
                   ray_valid, fill, rcfg, stage_color, apply_sigmoid_color,
                   pose_grad)


class ieee_f32:
    """Matmuls in IEEE float32 (TF32 off) inside the block."""

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev


def live_rows(packed: torch.Tensor) -> int:
    """The map's point count: its rows before the first empty one."""
    empty = packed[:, POS.start] >= _EMPTY_POS
    return int(torch.argmax(empty.int())) if bool(empty.any()) \
        else packed.shape[0]


def _render(packed, w, ro, rd, gt_depth, rq, ray_valid, fill, rcfg,
            stage_color, apply_sigmoid_color, pose_grad):
    dev = ro.device
    ns = int(rcfg["n_surface"])
    k = int(rcfg["nn_num"])
    n = live_rows(packed.detach())
    t = Table(packed[:, POS].detach(), n, rcfg["cell_size"], int(rcfg["table_size"]),
              int(rcfg["max_per_cell"]))
    r = ro.shape[0]
    far = ray_far(gt_depth, ray_valid)
    s = torch.linspace(0.0, 1.0, ns, device=dev)
    z_surf = (rcfg["near_end_surface"] * gt_depth[:, None] * (1 - s)[None]
              + rcfg["far_end_surface"] * gt_depth[:, None] * s[None])
    near_ok = torch.ones(r, dtype=torch.bool, device=dev)
    if rcfg["sample_near_pcl"]:
        z_zero = torch.zeros((r, ns), device=dev)
        sub = torch.nonzero(~(gt_depth > 0)).squeeze(1)
        if sub.numel():
            z_sub, inv = near_map_samples(t, ro.detach()[sub],
                                          rd.detach()[sub],
                                          rcfg["near_end"], far, rq[sub], ns)
            z_zero[sub] = z_sub
            near_ok[sub] = ~inv
    else:
        z_zero = rcfg["near_end"] * (1 - s)[None] + far * s[None]
    z = torch.where((gt_depth > 0)[:, None], z_surf, z_zero)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    p = pts.reshape(-1, 3)
    rq_pts = rq.repeat_interleave(ns)
    idx, valid, _ = ray_knn(t, pts.detach(), k, int(rcfg["knn_probes"]))
    nb = packed[idx]
    npos = nb[..., POS].detach()
    diff = npos - (p if pose_grad else p.detach())[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    has = torch.sum((d2 < (rq_pts * rq_pts)[:, None]) & valid, -1) \
        > int(rcfg["min_nn_num"]) - 1
    if rcfg["weighting"] == "distance":
        wt = 1.0 / (d2 + 1e-10)
    else:
        wt = torch.exp(-20.0 * torch.sqrt(d2))
    wt = torch.where((d2 > (rq_pts ** 2)[:, None]) | ~valid, 0.0, wt)
    wt = wt / torch.clamp(torch.sum(torch.abs(wt), 1, keepdim=True),
                          min=1e-12)
    c_geo = torch.sum(wt[..., None] * nb[..., GEO], 1)
    c_geo = torch.where(has[:, None], c_geo, fill[0][None])
    occ = geo_decoder(w, p, c_geo)
    valid_ray = (torch.sum(has.reshape(r, ns), 1) >= ns // 2 + 1) & near_ok
    if stage_color:
        feats = nb[..., COL]
        if rcfg["encode_rel_pos_in_col"]:
            feats = neighbour_encoder(w, npos, p, feats)
        c_col = torch.sum(wt[..., None] * feats, 1)
        c_col = torch.where(has[:, None], c_col, fill[1][None])
        rgb = col_decoder(w, p, c_col, apply_sigmoid_color)
    else:
        rgb = torch.zeros((p.shape[0], 3), device=dev)
    occ = torch.where(has, occ, -100.0)
    raw = torch.cat([rgb, occ[:, None]], -1).reshape(r, ns, 4)
    alpha = torch.sigmoid(rcfg["sigmoid_coef"] * raw[..., 3])
    shifted = torch.cat([torch.ones_like(alpha[:, :1]),
                         1.0 - alpha + 1e-10], -1)
    wts = alpha * torch.cumprod(shifted, -1)[:, :-1]
    wsum = torch.sum(wts, -1, keepdim=True) + 1e-10
    color = torch.sum(wts[..., None] * raw[..., :3], -2) / wsum
    depth = torch.sum(wts * z, -1) / wsum[:, 0]
    tmp = z - depth[:, None]
    unc = torch.sum(wts * tmp * tmp, -1)
    if not rcfg["sample_near_pcl"]:
        depth = torch.where(gt_depth > 0, depth, 0.0)
    return depth, unc, color, valid_ray


def table_size(grid_table_size: int, capacity: int) -> int:
    """The cell table's bucket count for a map of ``capacity`` rows: the
    configured size, doubled while it holds more than 8 rows a bucket."""
    t = int(grid_table_size)
    while t < capacity // 8:
        t *= 2
    return t
