"""The port of ``profiling/knn_pallas3.py`` (P3): box probes compacted by
a pattern table.

The box's validity pattern depends only on the per-axis extents in
{3, 4}: 8 patterns, each with a static permutation that puts the valid
offsets first, centre-out, truncated to P3=48 slots. The script's PERMS
and SLOT_OK tables are built by the same algorithm as the port's
``ops/knn._build_probe_perms``, which is reused here (``_build_probe_perms
(48)``). v6 picks each ray's permutation by a gather
(``box_probes_v6``), v7 by one flat row gather from the 8 permuted
stacks (``box_probes_v7``, the design ``ops/knn.py::_box_probes``
adopted). Both feed the [X|Y|Z|ID] row block to the block top-k with the
ids taken in the kernel (the Pallas ``_kernel3``, mask 4095). The
script pads R to a multiple of 32 for its grid; the port needs no
padding.
"""

from __future__ import annotations

import torch

from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.profiling import knn_pallas2 as kp2
from point_slam_tpu_torch.profiling.scene import K, Block

P3 = 48
LANE_MASK3 = 4095             # 48*64 = 3072


def perm_tables(device=None):
    """(PERMS (8, 48) int64, SLOT_OK (8, 48) bool) on ``device``."""
    perms, slot_ok = tk._build_probe_perms(P3)
    return (torch.as_tensor(perms, dtype=torch.long, device=device),
            torch.as_tensor(slot_ok, device=device))


def _pattern_start(q: torch.Tensor, cell_size, table_size: int):
    """(pattern (R,), h (R, 64) the bucket of each box offset)."""
    qc = tk._cells(q, tk._as_cell_size(cell_size, q.device))
    cmin = qc.amin(1) - 1
    cmax = qc.amax(1) + 1
    start = torch.where(cmax - cmin + 1 > 4, cmin + 1, cmin)
    ext = torch.clamp(cmax - start + 1, 3, 4)
    pattern = ((ext[:, 0] - 3) * 4 + (ext[:, 1] - 3) * 2
               + (ext[:, 2] - 3)).long()
    off = torch.tensor(kp2._off64_list(), dtype=torch.int32, device=q.device)
    h = tk._hash_cells(start[:, None, :] + off[None], table_size).to(
        torch.int32)
    return pattern, h


def box_probes_v6(q: torch.Tensor, cell_size, table_size: int
                  ) -> torch.Tensor:
    """(R, ns, 3) -> (R, 48) int32, each ray's permutation by a gather."""
    perms, slot_ok = perm_tables(q.device)
    pattern, h = _pattern_start(q, cell_size, table_size)
    hp = torch.gather(h, 1, perms[pattern])
    hp = torch.where(slot_ok[pattern], hp, table_size)
    return kp2.sentinel_repeats(hp, table_size)


def box_probes_v7(q: torch.Tensor, cell_size, table_size: int
                  ) -> torch.Tensor:
    """(R, ns, 3) -> (R, 48) int32, by one flat row gather from the 8
    permuted stacks."""
    r = q.shape[0]
    perms, slot_ok = perm_tables(q.device)
    pattern, h = _pattern_start(q, cell_size, table_size)
    stack = torch.stack([torch.where(slot_ok[p], h[:, perms[p]], table_size)
                         for p in range(8)])                 # (8, R, 48)
    flat = stack.reshape(8 * r, P3)
    hp = flat[pattern * r + torch.arange(r, device=q.device)]
    return kp2.sentinel_repeats(hp, table_size)


def block_v6(table, q, cell_size) -> Block:
    return kp2._row_block(table, box_probes_v6(q, cell_size,
                                               table.shape[0] - 1), q,
                          LANE_MASK3)


def block_v7(table, q, cell_size) -> Block:
    return kp2._row_block(table, box_probes_v7(q, cell_size,
                                               table.shape[0] - 1), q,
                          LANE_MASK3)


def knn_rays_v6(table: torch.Tensor, q: torch.Tensor, cell_size,
                k: int = K):
    """v6: (d2q, idx, valid) as (R*ns, k)."""
    return kp2._run(block_v6(table, q, cell_size), k)


def knn_rays_v7(table: torch.Tensor, q: torch.Tensor, cell_size,
                k: int = K):
    """v7: (d2q, idx, valid) as (R*ns, k)."""
    return kp2._run(block_v7(table, q, cell_size), k)
