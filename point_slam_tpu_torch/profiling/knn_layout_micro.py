"""The port of ``profiling/knn_layout_micro.py`` (P5): how the gathered
candidates are laid out for the block top-k.

Probes are the production ``_box_probes`` at the default budget of 36
slots (P*C = 2304 lanes, mask 4095); each variant gathers the ids too and
takes them in the kernel:

* A: the interleaved table (TABLE+1, C, 4), gather (R, P, C, 4), transpose
  to an [X|Y|Z|ID] row (R, 4*P*C). The script hands this one block to
  K2's body (``ops/knn.py::_ray_topk_kernel``), which takes four plane
  refs; the port runs that body on the row layout, as the script meant.
* B: a component-major table (4, TABLE+1, C), one gather (4, R, P, C), no
  transpose (the Pallas ``_kernel4``).
* C: four plane tables (TABLE+1, C), four gathers (the Pallas
  ``_kernel_sep``, K2's body).
"""

from __future__ import annotations

import torch

from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.ops.block_topk import layout_views
from point_slam_tpu_torch.profiling import knn_pallas2 as kp2
from point_slam_tpu_torch.profiling.scene import K, Block

P_RAY = 36


def _probes(q, cell_size, table_size):
    return tk._box_probes(q, cell_size, table_size, P_RAY)[0].long()


def component_major(table: torch.Tensor) -> torch.Tensor:
    """(TABLE+1, C, 4) -> (4, TABLE+1, C), contiguous."""
    return table.permute(2, 0, 1).contiguous()


def block_a(table, q, cell_size) -> Block:
    r, c = q.shape[0], table.shape[1]
    blocks = table[_probes(q, cell_size, table.shape[0] - 1)]
    cand = blocks.permute(0, 3, 1, 2).reshape(r, 4 * P_RAY * c)
    return Block(layout_views(cand, "row", r, P_RAY, c, 4), q.unbind(-1),
                 tk._lane_mask(P_RAY * c))


def block_b(table_cm, q, cell_size) -> Block:
    r, c = q.shape[0], table_cm.shape[2]
    blocks = table_cm[:, _probes(q, cell_size, table_cm.shape[1] - 1)]
    cand = blocks.reshape(4, r, P_RAY * c)
    return Block(layout_views(cand, "component", r, P_RAY, c, 4),
                 q.unbind(-1), tk._lane_mask(P_RAY * c))


def block_c(planes, q, cell_size) -> Block:
    """``planes``: (px, py, pz, pid), each (TABLE+1, C)."""
    r, c = q.shape[0], planes[0].shape[1]
    probes = _probes(q, cell_size, planes[0].shape[0] - 1)
    cand = [t[probes].reshape(r, P_RAY * c) for t in planes]
    return Block(layout_views(cand, "planes", r, P_RAY, c, 4), q.unbind(-1),
                 tk._lane_mask(P_RAY * c))


def variant_a(table, q, cell_size, k: int = K):
    """(d2q, idx, valid) as (R*ns, k)."""
    return kp2._run(block_a(table, q, cell_size), k)


def variant_b(table_cm, q, cell_size, k: int = K):
    return kp2._run(block_b(table_cm, q, cell_size), k)


def variant_c(planes, q, cell_size, k: int = K):
    return kp2._run(block_c(planes, q, cell_size), k)
