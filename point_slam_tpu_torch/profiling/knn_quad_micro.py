"""The port of ``profiling/knn_quad_micro.py`` (P6): four plane tables
against one quad-planar table.

Probes are the production ``_box_probes`` at 36 slots (mask 4095).
``planes``: four gathers of (R, P*C) from the (TABLE+1, C) planes and K2's
body over them (the Pallas ``planes_kernel``). ``quad``: one table
(TABLE+1, 4, C) whose row holds x|y|z|id as four contiguous C-vectors,
one gather of (R, P*4*C), and the body reading each component from the
probe's C-lane slices (the Pallas ``quad_kernel``). Both take the ids in
the kernel.
"""

from __future__ import annotations

import torch

from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.ops.block_topk import layout_views
from point_slam_tpu_torch.profiling import knn_layout_micro as klm
from point_slam_tpu_torch.profiling import knn_pallas2 as kp2
from point_slam_tpu_torch.profiling.scene import K, Block

P_RAY = klm.P_RAY


def quad_table(index) -> torch.Tensor:
    """(TABLE+1, 4, C): each row [x(C)|y(C)|z(C)|id(C)]."""
    return torch.stack([index.px, index.py, index.pz, index.pid], dim=1)


def block_quad(quad, q, cell_size) -> Block:
    r, c = q.shape[0], quad.shape[2]
    g = quad[klm._probes(q, cell_size, quad.shape[0] - 1)].reshape(
        r, P_RAY * 4 * c)
    return Block(layout_views(g, "quad", r, P_RAY, c, 4), q.unbind(-1),
                 tk._lane_mask(P_RAY * c))


def ray_knn_planes(planes, q, cell_size, k: int = K):
    """(d2q, idx, valid) as (R*ns, k)."""
    return kp2._run(klm.block_c(planes, q, cell_size), k)


def ray_knn_quad(quad, q, cell_size, k: int = K):
    return kp2._run(block_quad(quad, q, cell_size), k)
