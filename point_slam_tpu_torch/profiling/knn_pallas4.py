"""The port of ``profiling/knn_pallas4.py`` (P4): positions-only
candidates, ids from an epilogue.

v8 gathers the v7 probes' rows of the interleaved table, keeps x, y, z as
an [X|Y|Z] row of planes (R, 3*P3*C) and runs the keys-only block top-k
(the Pallas ``_kernel4``, mask 4095); the winners' ids come from a gather
of the table's id plane at (probe bucket, slot) of each winner's lane.
v8b gathers the same rows from a position-only table (TABLE+1, 3C)
(``make_pos_table``).
"""

from __future__ import annotations

import torch

from point_slam_tpu_torch.ops.block_topk import block_topk, layout_views
from point_slam_tpu_torch.profiling.knn_pallas3 import (LANE_MASK3, P3,
                                                        box_probes_v7)
from point_slam_tpu_torch.profiling.scene import INF_BITS, K, Block


def make_pos_table(table: torch.Tensor) -> torch.Tensor:
    """(TABLE+1, C, 4) -> (TABLE+1, 3C): each row [x(C)|y(C)|z(C)]."""
    t = table[..., :3]
    return t.permute(0, 2, 1).reshape(t.shape[0], 3 * table.shape[1])


def _block(cand, q, r, c) -> Block:
    return Block(layout_views(cand, "row", r, P3, c, 3), q.unbind(-1),
                 LANE_MASK3)


def block_v8(table, q, cell_size):
    """(Block, probes)."""
    r, c = q.shape[0], table.shape[1]
    probes = box_probes_v7(q, cell_size, table.shape[0] - 1)
    blocks = table[probes.long()]                            # (R,48,C,4)
    cand = blocks[..., :3].permute(0, 3, 1, 2).reshape(r, 3 * P3 * c)
    return _block(cand, q, r, c), probes


def block_v8b(table, pos_tab, q, cell_size):
    """(Block, probes) from the position-only table."""
    r, c = q.shape[0], table.shape[1]
    probes = box_probes_v7(q, cell_size, table.shape[0] - 1)
    rows = pos_tab[probes.long()]                            # (R,48,3C)
    cand = rows.reshape(r, P3, 3, c).permute(0, 2, 1, 3).reshape(
        r, 3 * P3 * c)
    return _block(cand, q, r, c), probes


def _ids_epilogue(table, b: Block, probes, k: int):
    keys, _ = block_topk(b.views, b.q, k, b.lane_mask)
    c = table.shape[1]
    lane = (keys & b.lane_mask).long()                       # (R, ns*k)
    win_h = torch.gather(probes.long(), 1, lane // c)
    ids = table.reshape(-1, 4)[:, 3][win_h * c + lane % c]
    valid = keys < INF_BITS
    idx = torch.where(valid, ids, 0.0).long()
    d2q = torch.where(valid, (keys & ~b.lane_mask).view(torch.float32),
                      torch.inf)
    return d2q.reshape(-1, k), idx.reshape(-1, k), valid.reshape(-1, k)


def knn_rays_v8(table: torch.Tensor, q: torch.Tensor, cell_size,
                k: int = K):
    """v8: (d2q, idx, valid) as (R*ns, k)."""
    b, probes = block_v8(table, q, cell_size)
    return _ids_epilogue(table, b, probes, k)


def knn_rays_v8b(table: torch.Tensor, pos_tab: torch.Tensor,
                 q: torch.Tensor, cell_size, k: int = K):
    """v8b: as v8, the candidates from ``make_pos_table(table)``."""
    b, probes = block_v8b(table, pos_tab, q, cell_size)
    return _ids_epilogue(table, b, probes, k)
