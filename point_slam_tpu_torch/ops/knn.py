"""k-nearest-neighbour search over the padded neural point buffer.

The port of ``point_slam_tpu.ops.knn``: a voxel grid hash stored as a dense
cell table of (TABLE+1, C) planes (one sentinel row at ``table_size`` that
is always empty), per-sample ``grid_knn`` over the 27 neighbour cells, and
the ray-shared ``ray_grid_knn``, whose per-ray top-k selection runs as the
CUDA kernel ``csrc/ray_topk.cu`` on the card and as
``ray_topk_reference`` on the CPU.

Two table layouts, as in the JAX package:

* ``GridIndex``: f32 planes px/py/pz/pid, empty slots +inf.
* ``PackedGridIndex``: one i32 plane of 3x10-bit lattice coordinates
  (quantum cell_size/64, mod 1024, -1 empty) plus the f32 id plane. The
  table coordinates steer selection only: the renderer recomputes exact
  distances from the winners' true coordinates.
* ``FusedGridIndex``: the packed layout in ONE (TABLE+1, 2C) i32 plane,
  each row [C packed coordinates | C ids' f32 bits].

Ids ride in the f32 planes as float VALUES (exact below 2^24; capacity is
capped at 2^22); the fused plane holds the bits of those f32 values in an
int32 plane, where no float arithmetic touches them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

# Large-prime spatial hash (Teschner et al.). The JAX package multiplies in
# int32 with wraparound, XORs, then takes a uint32 modulo; here the products
# run in int64 and keep their low 32 bits, which is the same bit pattern.
_P1, _P2, _P3 = 73856093, 19349669, 83492791
_U32 = 0xFFFFFFFF

_QBITS = 10
_QMASK = (1 << _QBITS) - 1            # 1023
_QPERIOD = float(1 << _QBITS)         # 1024.0
_Q_PER_CELL = 64.0                    # lattice quanta per grid cell
_INF_BITS = 0x7F800000                # f32 +inf bit pattern

_BOX = 4                              # probed cells per axis (ray kNN)
_P_RAY_DEFAULT = 36


def _hash_cells(cells: torch.Tensor, table_size: int) -> torch.Tensor:
    """(.., 3) integer cell coords -> int64 bucket id in [0, table_size)."""
    c = cells.long()
    h = (((c[..., 0] * _P1) & _U32) ^ ((c[..., 1] * _P2) & _U32)
         ^ ((c[..., 2] * _P3) & _U32))
    return h % table_size


def _cells(points: torch.Tensor, cell_size: torch.Tensor) -> torch.Tensor:
    # cell_size is a 0-dim tensor on the points' device: dividing by a CPU
    # scalar would make CUDA multiply by its reciprocal instead
    return torch.floor(points / cell_size).to(torch.int32)


def _slot_plan(h: torch.Tensor, table_size: int, c: int,
               base_counts: torch.Tensor | None = None):
    """Bucket-slot scatter plan shared by the f32-plane and packed builders.

    Returns (order, dst): ``order`` sorts entries by bucket (stable, so
    append order is kept within a bucket) and ``dst`` is the flat plane
    slot of each sorted entry, bucket*c + rank (rank offset by
    ``base_counts`` when appending). Overflow (rank >= c) and invalid
    entries (h == table_size) park at (table_size+1)*c, one past the
    planes, where ``_scatter_drop`` discards them.
    """
    n = h.shape[0]
    order = torch.sort(h, stable=True).indices
    hs = h[order]
    ar = torch.arange(n, device=h.device)
    is_start = torch.ones(n, dtype=torch.bool, device=h.device)
    is_start[1:] = hs[1:] != hs[:-1]
    run_start = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    rank = ar - run_start
    if base_counts is not None:
        rank = rank + base_counts[hs]
    dst = hs * c + rank
    dst = torch.where((rank < c) & (hs < table_size), dst,
                      (table_size + 1) * c)
    return order, dst


def _scatter_drop(plane: torch.Tensor, dst: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """plane.flat[dst] = vals with out-of-range dst dropped (JAX's
    mode="drop"): one trash slot past the end absorbs the parked writes."""
    flat = torch.cat([plane.reshape(-1), plane.new_zeros(1)])
    flat[dst] = vals.to(plane.dtype)
    return flat[:-1].reshape(plane.shape)


def _add_counts(counts: torch.Tensor, h: torch.Tensor, valid: torch.Tensor,
                table_size: int) -> torch.Tensor:
    """counts[h] += 1 over the valid entries (invalid ones are dropped)."""
    pad = torch.cat([counts, counts.new_zeros(1)])
    pad.index_add_(0, torch.where(valid, h, table_size + 1),
                   torch.ones_like(h, dtype=counts.dtype))
    return pad[:-1]


class GridIndex(NamedTuple):
    """Dense cell-table index as f32 component planes (TABLE+1, C); ids
    as float values; empty slots and the sentinel row hold +inf."""
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    pid: torch.Tensor
    cell_size: torch.Tensor   # () f32
    counts: torch.Tensor      # (TABLE+1,) int64 true per-bucket count

    @property
    def table_size(self) -> int:
        return self.px.shape[0] - 1

    @property
    def max_per_cell(self) -> int:
        return self.px.shape[1]


class PackedGridIndex(NamedTuple):
    """Cell table with 3x10-bit lattice-packed coordinates: ``pxyz`` holds
    x|y<<10|z<<20 on the cell_size/64 lattice mod 1024, -1 where empty;
    ``pid`` is the f32-valued id plane, +inf where empty."""
    pxyz: torch.Tensor        # (TABLE+1, C) int32
    pid: torch.Tensor         # (TABLE+1, C) f32
    cell_size: torch.Tensor
    counts: torch.Tensor

    @property
    def table_size(self) -> int:
        return self.pxyz.shape[0] - 1

    @property
    def max_per_cell(self) -> int:
        return self.pxyz.shape[1]


class FusedGridIndex(NamedTuple):
    """PackedGridIndex with coordinates and ids in ONE (TABLE+1, 2C) i32
    plane: row [:C] the packed lattice coordinates (-1 empty), row [C:] the
    f32-valued ids' bits (+inf bits empty). ``pxyz`` and ``pid`` are views
    of the PackedGridIndex planes."""
    plane: torch.Tensor       # (TABLE+1, 2C) int32
    cell_size: torch.Tensor
    counts: torch.Tensor

    @property
    def table_size(self) -> int:
        return self.plane.shape[0] - 1

    @property
    def max_per_cell(self) -> int:
        return self.plane.shape[1] // 2

    @property
    def pxyz(self) -> torch.Tensor:
        return self.plane[:, :self.max_per_cell]

    @property
    def pid(self) -> torch.Tensor:
        return self.plane[:, self.max_per_cell:].view(torch.float32)


def _lattice_quantum(cell_size: torch.Tensor) -> torch.Tensor:
    return cell_size / _Q_PER_CELL


def _pack_lattice(points: torch.Tensor, cell_size: torch.Tensor
                  ) -> torch.Tensor:
    """(.., 3) f32 -> (..,) int32 packed 10-bit lattice coords (mod 1024)."""
    g = _lattice_quantum(cell_size)
    q = torch.floor(points / g + 0.5).to(torch.int32) & _QMASK
    return q[..., 0] | (q[..., 1] << _QBITS) | (q[..., 2] << (2 * _QBITS))


def _query_lattice(q: torch.Tensor, cell_size: torch.Tensor) -> torch.Tensor:
    """(.., 3) f32 -> continuous lattice coords reduced mod 1024."""
    ql = q / _lattice_quantum(cell_size)
    return ql - torch.floor(ql / _QPERIOD) * _QPERIOD


def _unpack_lattice(v: torch.Tensor):
    """int32 packed -> (x, y, z) f32 lattice coords; empty (-1) -> +inf."""
    empty = v < 0
    return tuple(torch.where(empty, torch.inf,
                             ((v >> (a * _QBITS)) & _QMASK).float())
                 for a in range(3))


def _wrap_diff(df: torch.Tensor) -> torch.Tensor:
    """Shortest signed difference on the 1024-periodic lattice (f32)."""
    df = torch.where(df > _QPERIOD / 2, df - _QPERIOD, df)
    return torch.where(df < -_QPERIOD / 2, df + _QPERIOD, df)


def _index_hash(points, n_points, cell_size, table_size):
    cap = points.shape[0]
    valid = torch.arange(cap, device=points.device) < n_points
    h = _hash_cells(_cells(points, cell_size), table_size)
    return torch.where(valid, h, table_size), valid


def _as_cell_size(cell_size, device) -> torch.Tensor:
    return torch.as_tensor(cell_size, dtype=torch.float32, device=device)


def build_grid_index(points: torch.Tensor, n_points, cell_size,
                     table_size: int = 1 << 16,
                     max_per_cell: int = 96) -> GridIndex:
    """Build the f32-plane cell table over the first ``n_points`` rows of
    ``points`` (CAP, 3). Points past ``max_per_cell`` in one bucket are
    dropped."""
    dev = points.device
    cs = _as_cell_size(cell_size, dev)
    c = max_per_cell
    h, valid = _index_hash(points, n_points, cs, table_size)
    order, dst = _slot_plan(h, table_size, c)
    pos = points[order]
    empty = torch.full((table_size + 1, c), torch.inf, device=dev)
    counts = _add_counts(torch.zeros(table_size + 1, dtype=torch.long,
                                     device=dev), h, valid, table_size)
    return GridIndex(*(_scatter_drop(empty, dst, pos[:, a]) for a in range(3)),
                     _scatter_drop(empty, dst, order.float()), cs, counts)


def build_packed_grid_index(points: torch.Tensor, n_points, cell_size,
                            table_size: int = 1 << 16,
                            max_per_cell: int = 96) -> PackedGridIndex:
    """build_grid_index with lattice-packed coordinate storage."""
    dev = points.device
    cs = _as_cell_size(cell_size, dev)
    c = max_per_cell
    h, valid = _index_hash(points, n_points, cs, table_size)
    order, dst = _slot_plan(h, table_size, c)
    pxyz = _scatter_drop(
        torch.full((table_size + 1, c), -1, dtype=torch.int32, device=dev),
        dst, _pack_lattice(points, cs)[order])
    pid = _scatter_drop(torch.full((table_size + 1, c), torch.inf,
                                   device=dev), dst, order.float())
    counts = _add_counts(torch.zeros(table_size + 1, dtype=torch.long,
                                     device=dev), h, valid, table_size)
    return PackedGridIndex(pxyz, pid, cs, counts)


def _fused_dst(dst: torch.Tensor, c: int, table_size: int):
    """A _slot_plan flat slot (bucket*c + rank) in the fused plane's flat
    coordinates: the coordinates at bucket*2c + rank, the id at +c. Parked
    slots move to (table_size+1)*2c, one past the plane, where
    _scatter_drop discards them."""
    parked = dst >= (table_size + 1) * c
    coord = (dst // c) * (2 * c) + dst % c
    oob = (table_size + 1) * (2 * c)
    return (torch.where(parked, oob, coord),
            torch.where(parked, oob, coord + c))


def _id_bits(ids: torch.Tensor) -> torch.Tensor:
    """Integer ids -> the int32 bits of their f32 values."""
    return ids.float().contiguous().view(torch.int32)


def build_fused_grid_index(points: torch.Tensor, n_points, cell_size,
                           table_size: int = 1 << 16,
                           max_per_cell: int = 96) -> FusedGridIndex:
    """build_packed_grid_index with the one-plane fused layout."""
    dev = points.device
    cs = _as_cell_size(cell_size, dev)
    c = max_per_cell
    h, valid = _index_hash(points, n_points, cs, table_size)
    order, dst = _slot_plan(h, table_size, c)
    dst_c, dst_i = _fused_dst(dst, c, table_size)
    empty = torch.cat([
        torch.full((table_size + 1, c), -1, dtype=torch.int32, device=dev),
        torch.full((table_size + 1, c), _INF_BITS, dtype=torch.int32,
                   device=dev)], dim=1)
    plane = _scatter_drop(empty, dst_c, _pack_lattice(points, cs)[order])
    plane = _scatter_drop(plane, dst_i, _id_bits(order))
    counts = _add_counts(torch.zeros(table_size + 1, dtype=torch.long,
                                     device=dev), h, valid, table_size)
    return FusedGridIndex(plane, cs, counts)


def insert_grid_index(index, points: torch.Tensor, ids: torch.Tensor,
                      valid: torch.Tensor):
    """Append a batch of NEW points (every id larger than any id already in
    the table) to any layout. Bit-identical to a rebuild over the union:
    the build's stable sort puts higher ids after lower ones within a
    bucket, which is where slot = counts[bucket] + rank puts them."""
    table_size, c = index.table_size, index.max_per_cell
    h = _hash_cells(_cells(points, index.cell_size), table_size)
    h = torch.where(valid, h, table_size)
    order, dst = _slot_plan(h, table_size, c, base_counts=index.counts)
    counts = _add_counts(index.counts, h, valid, table_size)
    if isinstance(index, FusedGridIndex):
        dst_c, dst_i = _fused_dst(dst, c, table_size)
        plane = _scatter_drop(index.plane, dst_c,
                              _pack_lattice(points, index.cell_size)[order])
        plane = _scatter_drop(plane, dst_i, _id_bits(ids[order]))
        return FusedGridIndex(plane, index.cell_size, counts)
    pid = _scatter_drop(index.pid, dst, ids[order].float())
    if isinstance(index, PackedGridIndex):
        pxyz = _scatter_drop(index.pxyz, dst,
                             _pack_lattice(points, index.cell_size)[order])
        return PackedGridIndex(pxyz, pid, index.cell_size, counts)
    pos = points[order]
    return GridIndex(*(_scatter_drop(pl, dst, pos[:, a]) for a, pl in
                       enumerate((index.px, index.py, index.pz))),
                     pid, index.cell_size, counts)


@functools.lru_cache(maxsize=None)
def _offsets27() -> np.ndarray:
    return np.array([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], np.int32)


def _dedup_probes(hs: torch.Tensor) -> torch.Tensor:
    """(Q, P) bucket ids -> (Q, P) bool, False on a repeat of an earlier
    probe of the same query (it would surface the same candidates twice)."""
    p = hs.shape[1]
    ar = torch.arange(p, device=hs.device)
    dup = (hs[:, :, None] == hs[:, None, :]) & (ar[:, None] > ar[None, :])
    return ~dup.any(-1)


def grid_knn(index, queries: torch.Tensor, k: int = 8):
    """Top-k in-ball neighbours of each query over its 27 neighbour cells.

    Returns dists (Q,k) squared L2 (+inf where no candidate; lattice
    distances times g^2 on the packed layout), idx (Q,k) int64 point ids (0
    where invalid) and valid (Q,k) bool.
    """
    q = queries.float()
    nq = q.shape[0]
    table_size, c = index.table_size, index.max_per_cell
    off = torch.as_tensor(_offsets27(), device=q.device)
    probe_cells = _cells(q, index.cell_size)[:, None, :] + off[None]
    hs = _hash_cells(probe_cells, table_size)                 # (Q,27)
    probe_ok = _dedup_probes(hs)

    if isinstance(index, (PackedGridIndex, FusedGridIndex)):
        x, y, z = _unpack_lattice(index.pxyz[hs])            # (Q,27,C)
        qm = _query_lattice(q, index.cell_size)
        dx = _wrap_diff(x - qm[:, None, None, 0])
        dy = _wrap_diff(y - qm[:, None, None, 1])
        dz = _wrap_diff(z - qm[:, None, None, 2])
        g = _lattice_quantum(index.cell_size)
        d2 = (dx * dx + dy * dy + dz * dz) * (g * g)
    else:
        dx = index.px[hs] - q[:, None, None, 0]
        dy = index.py[hs] - q[:, None, None, 1]
        dz = index.pz[hs] - q[:, None, None, 2]
        d2 = dx * dx + dy * dy + dz * dz
    d2 = torch.where(probe_ok[:, :, None], d2, torch.inf).reshape(nq, 27 * c)

    dists, pos = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    win_h = torch.gather(hs, 1, pos // c)
    win_ids = index.pid[win_h, pos % c]
    valid = torch.isfinite(dists)
    idx = torch.where(valid, win_ids, 0.0).long()
    return dists, idx, valid


def grid_knn_subset(index, q_rays: torch.Tensor, need: torch.Tensor,
                    k: int = 8):
    """Per-sample grid_knn over only the rays where ``need`` is True.

    q_rays (R, ns, 3); returns idx (R, ns, k) int64 and valid (R, ns, k),
    zeros/False on rays where need is False. The rays are picked by boolean
    indexing, so the launch sizes follow the number of needed rays (this
    costs one device->host sync for the count).
    """
    r, ns, _ = q_rays.shape
    idx = torch.zeros((r, ns, k), dtype=torch.long, device=q_rays.device)
    valid = torch.zeros((r, ns, k), dtype=torch.bool, device=q_rays.device)
    sub = q_rays[need]
    if sub.shape[0]:
        _, i_f, v_f = grid_knn(index, sub.reshape(-1, 3), k=k)
        idx[need] = i_f.reshape(-1, ns, k)
        valid[need] = v_f.reshape(-1, ns, k)
    return idx, valid


def neighbor_count(dists: torch.Tensor, valid: torch.Tensor,
                   radius) -> torch.Tensor:
    """Number of returned neighbours within a per-query or scalar radius."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=dists.device)
    if r.dim() >= 1:
        r = r.reshape(-1, 1)
    return torch.sum((dists < r * r) & valid, dim=-1)


# ------------------------------------------------------------------
# Ray-shared kNN: one probe set per ray, top-k by packed keys.
#
# The renderer's ns samples of one ray lie within ~0.04*depth of each
# other, so the ray probes the 4x4x4 cell box around its samples' bbox
# (+1-cell margin) ONCE, compacted to p_ray slots, instead of 27 cells per
# sample. Per sample, the top-k over the ray's P*C candidates is taken by
# k rounds of minimum over int32 keys: the f32 d^2 bits with the low
# bit_length(P*C-1) bits replaced by the candidate's lane, so keys are
# unique and ties break by lane. Rays whose samples span more than the box
# are flagged non-compact and go through per-sample grid_knn instead.
# ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _build_probe_perms(p_ray: int):
    """Static per-pattern compaction tables for a probe budget.

    The validity pattern of the 64 box offsets depends only on the
    per-axis extents in {3, 4}: 8 patterns. For each, a permutation puts
    the valid offsets first, centre-out so truncation drops corner cells;
    slots past the pattern's valid count are masked to the sentinel.
    Returns numpy (perms (8, p_ray) int32, slot_ok (8, p_ray) bool).
    """
    off = np.array([[x, y, z] for x in range(_BOX) for y in range(_BOX)
                    for z in range(_BOX)], np.int64)
    perms = np.zeros((8, p_ray), np.int32)
    n_valid = np.zeros(8, np.int32)
    for pat in range(8):
        ex, ey, ez = (pat >> 2 & 1) + 3, (pat >> 1 & 1) + 3, (pat & 1) + 3
        ok = (off[:, 0] < ex) & (off[:, 1] < ey) & (off[:, 2] < ez)
        center = (np.array([ex, ey, ez]) - 1) / 2.0
        d = np.abs(off - center).max(1) + 1e-3 * np.abs(off - center).sum(1)
        order = np.lexsort((np.arange(off.shape[0]), d, ~ok))
        perms[pat] = order[:p_ray]
        n_valid[pat] = min(int(ok.sum()), p_ray)
    slot_ok = np.arange(p_ray)[None, :] < n_valid[:, None]
    return perms, slot_ok


def _box_probes(q: torch.Tensor, cell_size, table_size: int, p_ray: int):
    """Per-ray probe buckets over the sample bbox +1 margin.

    q (R, ns, 3). Returns (probes (R, p_ray) int32 with sentinel
    table_size for out-of-extent or duplicate buckets, compact (R,) bool).
    """
    dev = q.device
    perms, slot_ok = _build_probe_perms(p_ray)
    cs = _as_cell_size(cell_size, dev)
    qc = _cells(q, cs)                                       # (R,ns,3)
    cmin = qc.amin(1) - 1
    cmax = qc.amax(1) + 1
    # a box wider than _BOX cells drops its near margin first (the sample
    # cells stay covered up to a span of _BOX-2); the ray is non-compact
    start = torch.where(cmax - cmin + 1 > _BOX, cmin + 1, cmin)
    compact = torch.all(cmax - cmin + 1 <= _BOX, dim=-1)
    ext = torch.clamp(cmax - start + 1, 3, 4)
    pattern = ((ext[:, 0] - 3) * 4 + (ext[:, 1] - 3) * 2
               + (ext[:, 2] - 3)).long()
    off = torch.tensor([[x, y, z] for x in range(_BOX) for y in range(_BOX)
                        for z in range(_BOX)], dtype=torch.int32, device=dev)
    h = _hash_cells(start[:, None, :] + off[None], table_size)  # (R,64)
    perm = torch.as_tensor(perms, dtype=torch.long, device=dev)[pattern]
    ok = torch.as_tensor(slot_ok, device=dev)[pattern]
    hp = torch.where(ok, torch.gather(h, 1, perm), table_size)
    hp = torch.where(_dedup_probes(hp), hp, table_size)
    return hp.to(torch.int32), compact


def _lane_mask(pc: int) -> int:
    return (1 << (pc - 1).bit_length()) - 1


def ray_topk_reference(probes: torch.Tensor, planes: Tuple[torch.Tensor, ...],
                       q: torch.Tensor, k: int, lane_mask: int):
    """Plain PyTorch version of the ray top-k kernels (all three layouts).

    probes (R, P) int32 bucket ids; ``planes`` is (plane,) for the fused
    layout, one (TABLE+1, 2C) i32 plane; (pxyz i32, pid f32) for the packed
    layout; or (px, py, pz, pid) f32 for the f32 planes, each (TABLE+1, C).
    q (R, ns, 3) f32, continuous lattice coordinates for the fused and
    packed layouts and metric for the planes. Returns keys (R, ns*k) int32
    (f32 d^2 bits with the low bits replaced by the lane) and ids
    (R, ns*k) f32 (the winner's id-plane value; 0 past the lanes).

    The fused layout's lanes are p*2C + slot over whole rows: the id lanes
    get d^2 = +inf, so they never beat a finite candidate but do compete,
    by lane number, with empty coordinate lanes. A winner's id is the bits
    at lane win + C, or 0 past the lanes: for an id-lane winner that is
    the next probe's coordinate bits, as the TPU kernel's masked sum reads.
    """
    r, p = probes.shape
    ns = q.shape[1]
    rows = probes.long()
    fused = len(planes) == 1
    c = planes[0].shape[1] // (2 if fused else 1)
    pc = p * planes[0].shape[1]                 # lanes: P * row width
    if len(planes) == 4:
        x, y, z = (pl[rows].reshape(r, 1, pc) for pl in planes[:3])
        diff = lambda a, b: a - b
    else:
        v = planes[0][rows].reshape(r, 1, pc)
        x, y, z = _unpack_lattice(v)
        diff = lambda a, b: _wrap_diff(a - b)
    dx = diff(x, q[:, :, 0:1])
    dy = diff(y, q[:, :, 1:2])
    dz = diff(z, q[:, :, 2:3])
    d2 = dx * dx + dy * dy + dz * dz                         # (R,ns,PC)
    lane = torch.arange(pc, dtype=torch.int32, device=q.device)
    if fused:                                   # id lanes never get a d^2
        d2 = torch.where(lane % (2 * c) < c, d2, torch.inf)
    keys = (d2.view(torch.int32) & ~lane_mask) | lane
    top = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    win = top & lane_mask
    # the id lane: win + C of the fused rows (bits), win of the id plane
    src, at = ((v, win + c) if fused
               else (planes[-1][rows].reshape(r, 1, pc), win))
    ids = torch.gather(src.expand(r, ns, pc), 2,
                       torch.clamp(at, max=pc - 1).long())
    ids = torch.where(at < pc, ids, 0)
    if fused:
        ids = ids.view(torch.float32)
    return top.reshape(r, ns * k), ids.reshape(r, ns * k)


# Launches of each CUDA kernel, counted by ray_topk where it launches one.
LAUNCHES = {"ray_topk_packed": 0, "ray_topk_planes": 0, "ray_topk_fused": 0}

_LAYOUTS = {  # number of planes -> (kernel, dtypes of probes, *planes, q)
    2: ("ray_topk_packed",
        [torch.int32, torch.int32, torch.float32, torch.float32]),
    4: ("ray_topk_planes", [torch.int32] + [torch.float32] * 5),
}

# The row widths C the fused kernel (K3) is built for.
FUSED_WIDTHS = (32, 64)


def fused_occupancy(p: int, c: int, ns: int):
    """(blocks an SM holds, shared-memory bytes a block) of the fused
    kernel at (P, C, ns), as its launcher sizes the persistent grid: the
    card's occupancy calculator, after the kernel asks for the largest
    shared-memory carveout. (0, bytes) for a C it is not built for."""
    import ctypes
    from point_slam_tpu_torch.ops import _build
    smem = ctypes.c_long(0)
    n = _build.kernel("ray_topk_fused_occupancy")(p, c, ns,
                                                  ctypes.byref(smem))
    return n, smem.value


def _ray_topk_fused(probes, plane, q, k, lane_mask):
    """K3 on the card: one (2, R, ns*k) int32 buffer, the keys and the
    winners' id bits (viewed as f32)."""
    from point_slam_tpu_torch.ops import _build
    dev = q.device
    for t, dt in ((probes, torch.int32), (plane, torch.int32),
                  (q, torch.float32)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"ray_topk: probes, plane, q must be contiguous "
                             f"int32, int32, float32 tensors on {dev}; got "
                             f"{[x.dtype for x in (probes, plane, q)]}")
    r, p = probes.shape
    ns = q.shape[1]
    c = plane.shape[1] // 2
    if q.shape != (r, ns, 3) or not 1 <= k <= 8 or not 1 <= ns <= 32:
        raise ValueError(f"ray_topk: q {tuple(q.shape)}, k {k}, ns {ns} "
                         "outside (R, ns<=32, 3), k<=8")
    if plane.data_ptr() % 16 or p * 2 * c > lane_mask + 1:
        raise ValueError("ray_topk: the plane must be 16-byte aligned and "
                         f"lane_mask {lane_mask} must cover P*2C lanes")
    if c not in FUSED_WIDTHS:
        raise ValueError(f"ray_topk: the fused kernel is built for C in "
                         f"{FUSED_WIDTHS}, not C={c}")
    out = torch.empty((2, r, ns * k), dtype=torch.int32, device=dev)
    if r:
        err = _build.kernel("ray_topk_fused")(
            probes.data_ptr(), plane.data_ptr(), q.data_ptr(), out.data_ptr(),
            r, p, c, ns, k, lane_mask, _build.sm_count(dev),
            _build.stream(dev))
        if err:
            _build.check("ray_topk_fused", err)
        LAUNCHES["ray_topk_fused"] += 1
    return out[0], out[1].view(torch.float32)


def ray_topk(probes: torch.Tensor, planes: Tuple[torch.Tensor, ...],
             q: torch.Tensor, k: int, lane_mask: int):
    """Per-ray top-k over the probed candidates: the CUDA kernel for CUDA
    tensors, ``ray_topk_reference`` for CPU tensors. Same signature and
    outputs as ``ray_topk_reference``.

    Replaces point_slam_tpu/ops/knn.py::_ray_topk_kernel_fused (fused
    layout), ::_ray_topk_kernel_packed (packed layout) and
    ::_ray_topk_kernel (f32 planes). The kernels read the probe rows
    themselves (the (R, P*C) candidate block is never materialised). The
    packed and f32-plane kernels are bound by reading each ray's rows and
    run one block a ray. The fused kernel touches ~1.3 MB at R=5000 and is
    bound by issue and latency: it is persistent, brings the next ray's
    rows by cp.async while it selects for this one, compacts each ray's
    points once and keys only those, and keeps each sample's top-8 sorted
    in registers (csrc/ray_topk.cu). It takes C in FUSED_WIDTHS only, and
    raises for any other width on the card.
    """
    if q.device.type == "cpu":
        return ray_topk_reference(probes, planes, q, k, lane_mask)
    if q.device.type != "cuda":
        raise RuntimeError(f"ray_topk: unsupported device {q.device}")
    if len(planes) == 1:
        return _ray_topk_fused(probes, planes[0], q, k, lane_mask)
    from point_slam_tpu_torch.ops import _build
    if len(planes) not in _LAYOUTS:
        raise ValueError(f"ray_topk: {len(planes)} planes; expected 1 "
                         "(fused), 2 (packed) or 4 (f32 planes)")
    name, want = _LAYOUTS[len(planes)]
    r, p = probes.shape
    c = planes[0].shape[1]
    ns = q.shape[1]
    tensors = (probes, *planes, q)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("ray_topk: inputs must be contiguous tensors on "
                             "one CUDA device")
    if [t.dtype for t in tensors] != want:
        raise ValueError(f"ray_topk: dtypes {[t.dtype for t in tensors]}, "
                         f"expected {want}")
    if q.shape != (r, ns, 3) or not 1 <= k <= 8 or not 1 <= ns <= 32:
        raise ValueError(f"ray_topk: q {tuple(q.shape)}, k {k}, ns {ns} "
                         "outside (R, ns<=32, 3), k<=8")
    keys = torch.empty((r, ns * k), dtype=torch.int32, device=q.device)
    ids = torch.empty((r, ns * k), dtype=torch.float32, device=q.device)
    if r == 0:
        return keys, ids
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in tensors]
    err = getattr(lib, name)(*ptrs, keys.data_ptr(), ids.data_ptr(),
                             r, p, c, ns, k, lane_mask, stream)
    _build.check(name, err)
    LAUNCHES[name] += 1
    return keys, ids


def index_planes(index):
    """The planes ray_topk reads, in its argument order."""
    if isinstance(index, FusedGridIndex):
        return (index.plane,)
    if isinstance(index, PackedGridIndex):
        return (index.pxyz, index.pid)
    return (index.px, index.py, index.pz, index.pid)


def ray_grid_knn(index, q_rays: torch.Tensor, k: int = 8, probes: int = 0):
    """Top-k in-ball neighbours for ray-structured queries.

    q_rays (R, ns, 3) sample positions of depth-guided rays; ``probes`` is
    the per-ray probe-slot budget (0: the module default).

    Returns dists (R*ns, k) squared L2 quantised to the key's mantissa bits
    (selection only; recompute exactly from the winners), idx (R*ns, k)
    int64 (0 where invalid), valid (R*ns, k) bool, and compact (R,) bool,
    False where the ray's samples exceeded the probed box (route those
    through grid_knn).
    """
    p_ray = min(max(probes or _P_RAY_DEFAULT, 1), _BOX ** 3)
    with torch.no_grad():
        r, ns, _ = q_rays.shape
        q = q_rays.float()
        c = index.max_per_cell
        probe_rows, compact = _box_probes(q, index.cell_size,
                                          index.table_size, p_ray)
        if isinstance(index, (PackedGridIndex, FusedGridIndex)):
            qk = _query_lattice(q, index.cell_size).contiguous()
            g = _lattice_quantum(index.cell_size)
            d2_scale = g * g                                 # quanta^2 -> m^2
        else:
            qk = q.contiguous()
            d2_scale = 1.0
        # the fused rows hold 2C lanes a probe (one more lane bit)
        lanes = 2 * c if isinstance(index, FusedGridIndex) else c
        lane_mask = _lane_mask(p_ray * lanes)
        keys, ids = ray_topk(probe_rows, index_planes(index), qk, k,
                             lane_mask)
        valid = keys < _INF_BITS
        idx = torch.where(valid, ids, 0.0).long()
        d2q = (keys & ~lane_mask).view(torch.float32) * d2_scale
        d2q = torch.where(valid, d2q, torch.inf)
        return (d2q.reshape(r * ns, k), idx.reshape(r * ns, k),
                valid.reshape(r * ns, k), compact)
