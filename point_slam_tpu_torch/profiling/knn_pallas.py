"""The port of ``profiling/knn_pallas.py`` (P1): v0, per-sample grid_knn,
against v3, ray-shared probes.

v3: the 27-neighbourhoods of a ray's samples, deduplicated by a sort to a
budget of P=48 buckets (``ray_probes``); one gather of the (R, P, C, 4)
rows of the interleaved table; three separate planes X, Y, Z (sentinel
probes' X at +inf); the keys-only block top-k (the Pallas
``_topk_kernel``, mask 4095); then the winners' coordinates and ids from
an epilogue over their lanes, and exact d^2 from the coordinates.

The stages of ``profiling/knn_pallas.py:191-220``, each the chain up to
and including its step, as ``knn_pallas_stages`` times them: ``s_probes``
(the ray probes), ``s_gather`` (+ the (R, P, C, 4) row gather),
``s_unpack`` (+ the X, Y, Z planes), ``s_topk`` (+ P1 through
``block_topk``); ``knn_rays`` (v3) is the full chain.
"""

from __future__ import annotations

import torch

from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.ops.block_topk import block_topk, layout_views
from point_slam_tpu_torch.profiling.scene import INF_BITS, K, Block

P = 48
LANE_MASK = 4095              # P*C = 3072 < 4096


def v0(index, q: torch.Tensor, k: int = K):
    """Per-sample grid_knn over the 27 neighbour cells: (d2, idx, valid)
    as (R*ns, k)."""
    return tk.grid_knn(index, q.reshape(-1, 3), k=k)


def ray_probes(q: torch.Tensor, cell_size, table_size: int,
               m_probe: int = P) -> torch.Tensor:
    """(R, ns, 3) -> (R, m_probe) int32: the distinct buckets of the ray's
    ns*27 neighbour cells in ascending order, the first m_probe of them,
    sentinel ``table_size`` after the last."""
    r = q.shape[0]
    off = torch.as_tensor(tk._offsets27(), device=q.device)
    qcells = tk._cells(q, tk._as_cell_size(cell_size, q.device))
    hs = tk._hash_cells(qcells[:, :, None, :] + off[None, None],
                        table_size).to(torch.int32).reshape(r, -1)
    hs = torch.sort(hs, dim=1).values
    first = torch.ones_like(hs, dtype=torch.bool)
    first[:, 1:] = hs[:, 1:] != hs[:, :-1]
    rank = torch.cumsum(first, dim=1) - 1
    dst = torch.where(first & (rank < m_probe), rank, m_probe)
    probes = torch.full((r, m_probe + 1), table_size, dtype=torch.int32,
                        device=q.device)
    probes.scatter_(1, dst, hs)       # repeats all land in the dropped column
    return probes[:, :m_probe]


def s_probes(table: torch.Tensor, q: torch.Tensor, cell_size,
             p: int = P) -> torch.Tensor:
    """Stage 1: the (R, P) ray probes."""
    return ray_probes(q, cell_size, table.shape[0] - 1, p)


def _gather(table, probes):
    table_size = table.shape[0] - 1
    return table[torch.clamp(probes, 0, table_size - 1).long()]


def s_gather(table: torch.Tensor, q: torch.Tensor, cell_size,
             p: int = P) -> torch.Tensor:
    """Stage 2: + the (R, P, C, 4) rows of the interleaved table;
    sentinel probes read row TABLE-1, as the script clips."""
    return _gather(table, s_probes(table, q, cell_size, p))


def candidates(table: torch.Tensor, q: torch.Tensor, cell_size,
               p: int = P):
    """(probes, X, Y, Z, ids), each plane (R, P*C) contiguous: the
    gathered rows of the interleaved table (TABLE+1, C, 4) unpacked;
    sentinel probes read row TABLE-1, as the script clips, with X at
    +inf."""
    r = q.shape[0]
    table_size, c = table.shape[0] - 1, table.shape[1]
    probes = ray_probes(q, cell_size, table_size, p)
    blocks = _gather(table, probes)
    bad = (probes >= table_size)[:, :, None]
    x = torch.where(bad, torch.inf, blocks[..., 0]).reshape(r, p * c)
    y, z, ids = (blocks[..., a].reshape(r, p * c).contiguous()
                 for a in (1, 2, 3))
    return probes, x, y, z, ids


def s_unpack(table: torch.Tensor, q: torch.Tensor, cell_size,
             p: int = P):
    """Stage 3: + the X, Y, Z planes (R, P*C), X at +inf on sentinel
    probes."""
    return candidates(table, q, cell_size, p)[1:4]


def s_topk(table: torch.Tensor, q: torch.Tensor, cell_size,
           p: int = P) -> torch.Tensor:
    """Stage 4: + the keys-only block top-k (P1), (R, ns*k) keys."""
    r, c = q.shape[0], table.shape[1]
    x, y, z = s_unpack(table, q, cell_size, p)
    return block_topk(layout_views((x, y, z), "planes", r, p, c, 3),
                      q.unbind(-1), K, LANE_MASK)[0]


def block(table, q, cell_size, p: int = P) -> Block:
    _, x, y, z, _ = candidates(table, q, cell_size, p)
    c = table.shape[1]
    return Block(layout_views((x, y, z), "planes", q.shape[0], p, c, 3),
                 q.unbind(-1), LANE_MASK)


def knn_rays(table: torch.Tensor, q: torch.Tensor, cell_size, k: int = K,
             p: int = P):
    """v3: (d2 exact, idx, valid) as (R*ns, k)."""
    r, ns, _ = q.shape
    c = table.shape[1]
    _, x, y, z, ids = candidates(table, q, cell_size, p)
    keys, _ = block_topk(layout_views((x, y, z), "planes", r, p, c, 3),
                         q.unbind(-1), k, LANE_MASK)
    pos = (keys & LANE_MASK).long()                          # (R, ns*k)
    valid = keys < INF_BITS
    wx, wy, wz, wid = (torch.gather(a, 1, pos) for a in (x, y, z, ids))
    qq = q.reshape(r, ns, 1, 3).expand(r, ns, k, 3).reshape(r, ns * k, 3)
    d2 = ((wx - qq[..., 0]) ** 2 + (wy - qq[..., 1]) ** 2
          + (wz - qq[..., 2]) ** 2)
    d2 = torch.where(valid, d2, torch.inf).reshape(r * ns, k)
    idx = torch.where(valid, wid, 0.0).long().reshape(r * ns, k)
    return d2, idx, valid.reshape(r * ns, k)
