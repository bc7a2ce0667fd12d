"""The port of ``profiling/knn_pallas2.py`` (P2, P2'): box probes.

v4: the 4x4x4 cell box around the ray's samples' bounding box (+1 cell
margin) as P=64 probes (``box_probes``: out-of-extent and repeated buckets
go to the sentinel row); one gather of (R, 64, C, 4) rows; one transpose
to a [X|Y|Z|ID] row of planes (R, 4*P*C); the block top-k with the ids
taken in the kernel (the Pallas ``_kernel``, mask 8191).

v5: the box compacted to P2=40 slots, valid buckets first, by a
cumsum/scatter (``box_probes_compact``); the same block top-k (the Pallas
``_kernel2``), which runs its 2560 lanes under the script's mask 8191.

The stages of ``profiling/knn_pallas2.py:177-190`` and ``:289-295``, as
``knn_pallas2_v5`` times them: ``s_probes`` (the box probes), ``s_gather``
(+ the (R, 64, C, 4) rows), ``s_trans`` (+ the [X|Y|Z|ID] row);
``s5_probes`` (the compacted probes), ``s5_gather`` (+ the (R, 40, C, 4)
rows); ``knn_rays`` (v4) and ``knn_rays_v5`` are the full chains.
"""

from __future__ import annotations

import functools

import torch

from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.ops.block_topk import block_topk, layout_views
from point_slam_tpu_torch.profiling.scene import K, Block, finish

P = 64                        # 4x4x4 box offsets
P2 = 40
LANE_MASK = 8191              # v4: P*C = 4096 < 8192; v5 keeps it


@functools.lru_cache(maxsize=None)
def _off64_list():
    return [[x, y, z] for x in range(4) for y in range(4) for z in range(4)]


def _box(q: torch.Tensor, cell_size, table_size: int):
    """(h (R, 64) the bucket of each box offset, ok (R, 64) the offset
    lies inside the extent)."""
    off = torch.tensor(_off64_list(), dtype=torch.int32, device=q.device)
    qc = tk._cells(q, tk._as_cell_size(cell_size, q.device))
    cmin = qc.amin(1) - 1
    cmax = qc.amax(1) + 1
    start = torch.where(cmax - cmin + 1 > 4, cmin + 1, cmin)
    cells = start[:, None, :] + off[None]
    ok = torch.all(off[None] <= (cmax - start)[:, None, :], dim=-1)
    h = tk._hash_cells(cells, table_size).to(torch.int32)
    return h, ok


def sentinel_repeats(h: torch.Tensor, table_size: int) -> torch.Tensor:
    """Each bucket that an earlier probe of the ray already holds becomes
    the sentinel."""
    return torch.where(tk._dedup_probes(h), h, table_size)


def box_probes(q: torch.Tensor, cell_size, table_size: int) -> torch.Tensor:
    """(R, ns, 3) -> (R, 64) int32 buckets, sentinel for the offsets
    outside the extent and for repeats."""
    h, ok = _box(q, cell_size, table_size)
    return sentinel_repeats(torch.where(ok, h, table_size), table_size)


def box_probes_compact(q: torch.Tensor, cell_size, table_size: int,
                       p2: int = P2) -> torch.Tensor:
    """(R, ns, 3) -> (R, p2) int32: the box's valid, distinct buckets in
    offset order, the first p2 of them, sentinel after."""
    r = q.shape[0]
    h, ok = _box(q, cell_size, table_size)
    ok = ok & tk._dedup_probes(h)
    dst = torch.cumsum(ok, dim=1) - 1
    dst = torch.where(ok & (dst < p2), dst, p2)
    probes = torch.full((r, p2 + 1), table_size, dtype=torch.int32,
                        device=q.device)
    probes.scatter_(1, dst, h)        # the rest all land in the dropped column
    return probes[:, :p2]


def _transpose(blocks: torch.Tensor) -> torch.Tensor:
    """(R, P, C, 4) rows -> the [X|Y|Z|ID] row (R, 4*P*C)."""
    r, p, c, _ = blocks.shape
    return blocks.permute(0, 3, 1, 2).reshape(r, 4 * p * c)


def _row_block(table: torch.Tensor, probes: torch.Tensor, q: torch.Tensor,
               lane_mask: int) -> Block:
    """Gather, transpose to the [X|Y|Z|ID] row (R, 4*P*C), views."""
    r, p = probes.shape
    c = table.shape[1]
    cand = _transpose(table[probes.long()])
    return Block(layout_views(cand, "row", r, p, c, 4), q.unbind(-1),
                 lane_mask)


def s_probes(table: torch.Tensor, q: torch.Tensor, cell_size):
    """v4 stage 1: the (R, 64) box probes."""
    return box_probes(q, cell_size, table.shape[0] - 1)


def s_gather(table: torch.Tensor, q: torch.Tensor, cell_size):
    """v4 stage 2: + the (R, 64, C, 4) rows."""
    return table[s_probes(table, q, cell_size).long()]


def s_trans(table: torch.Tensor, q: torch.Tensor, cell_size):
    """v4 stage 3: + the transpose to the [X|Y|Z|ID] row (R, 4*64*C)."""
    return _transpose(s_gather(table, q, cell_size))


def s5_probes(table: torch.Tensor, q: torch.Tensor, cell_size):
    """v5 stage 1: the (R, 40) compacted box probes."""
    return box_probes_compact(q, cell_size, table.shape[0] - 1)


def s5_gather(table: torch.Tensor, q: torch.Tensor, cell_size):
    """v5 stage 2: + the (R, 40, C, 4) rows."""
    return table[s5_probes(table, q, cell_size).long()]


def block_v4(table, q, cell_size) -> Block:
    return _row_block(table, box_probes(q, cell_size, table.shape[0] - 1), q,
                      LANE_MASK)


def block_v5(table, q, cell_size) -> Block:
    return _row_block(table, box_probes_compact(q, cell_size,
                                                table.shape[0] - 1), q,
                      LANE_MASK)


def _run(b: Block, k: int):
    keys, ids = block_topk(b.views, b.q, k, b.lane_mask)
    return finish(keys, ids, b.lane_mask, k)


def knn_rays(table: torch.Tensor, q: torch.Tensor, cell_size, k: int = K):
    """v4: (d2q, idx, valid) as (R*ns, k); d2q is selection-quantised."""
    return _run(block_v4(table, q, cell_size), k)


def knn_rays_v5(table: torch.Tensor, q: torch.Tensor, cell_size,
                k: int = K):
    """v5: as v4 over the 40 compacted slots."""
    return _run(block_v5(table, q, cell_size), k)
