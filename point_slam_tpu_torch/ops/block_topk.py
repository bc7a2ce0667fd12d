"""Per-ray top-k over an already gathered candidate block.

The selection that the TPU kNN study (``profiling/knn_pallas*.py``,
``knn_layout_micro.py``, ``knn_quad_micro.py``) ran as ten Pallas bodies:
for each ray r and each of its ns samples s, over the ray's P*C candidate
lanes l = p*C + slot,

    d^2 = ((dx*dx) + (dy*dy)) + (dz*dz),   key = (bits(d^2) & ~lane_mask) | l,

and the k smallest keys come out ascending, (R, ns*k) int32. With an id
view, each winner's id is the id view's value at lane ``key & lane_mask``
(0.0 past the P*C lanes): the scripts' masked sum
``sum(where(lane == win, ID, 0))``, so an empty or sentinel winner carries
its +inf id.

The candidates are 3 (x, y, z) or 4 (x, y, z, id) f32 views of logical
shape (R, P, C), each with its own base, row stride and probe stride and
slot stride 1; ``layout_views`` makes them for the study's four layouts:

    layout       used by                   row stride   probe stride  base
    planes       P1, P5c, P6p, K2's body   P*C          C             own tensor
    row          P2, P2', P3, P4           n*P*C        C             j*P*C
    component    P5b                       P*C          C             j*R*P*C
    quad         P6q                       P*n*C        n*C           j*C

``block_topk`` launches the CUDA kernel ``csrc/block_topk.cu`` for CUDA
tensors and runs ``block_topk_reference`` for CPU tensors. Unlike
``knn.ray_topk`` (K1-K3), it does not read a cell table: the block has
been gathered by the caller, in whichever layout the variant builds.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

LAYOUTS = ("planes", "row", "component", "quad")

# Launches of the CUDA kernel, counted by block_topk where it launches it.
LAUNCHES = {"block_topk": 0}

_MAX_K = 8
_MAX_NS = 32
_SMEM_BYTES = 232448          # a block's shared-memory limit on Hopper

Queries = Union[torch.Tensor, Sequence[torch.Tensor]]


def layout_views(cand, layout: str, r: int, p: int, c: int,
                 n_planes: int) -> Tuple[torch.Tensor, ...]:
    """The (R, P, C) views of a candidate block in one of the four layouts.

    ``cand`` is a sequence of n_planes (R, P*C) tensors for "planes", an
    (R, n*P*C) tensor for "row" (plane j at lanes j*P*C..), an
    (n, R, P*C) tensor for "component" and an (R, P*n*C) tensor for "quad"
    (probe p's row holds n C-vectors, plane j at p*n*C + j*C).
    """
    if layout == "planes":
        if len(cand) != n_planes:
            raise ValueError(f"layout_views: {len(cand)} planes, expected "
                             f"{n_planes}")
        return tuple(t.reshape(r, p, c) for t in cand)
    if layout == "row":
        v = cand.reshape(r, n_planes, p, c)
        return tuple(v[:, j] for j in range(n_planes))
    if layout == "component":
        v = cand.reshape(n_planes, r, p, c)
        return tuple(v[j] for j in range(n_planes))
    if layout == "quad":
        v = cand.reshape(r, p, n_planes, c)
        return tuple(v[:, :, j] for j in range(n_planes))
    raise ValueError(f"layout_views: unknown layout {layout!r}; expected one "
                     f"of {LAYOUTS}")


def _query_planes(q: Queries) -> Tuple[torch.Tensor, ...]:
    """(R, ns, 3) or three (R, ns) -> three (R, ns) views."""
    if isinstance(q, torch.Tensor):
        if q.dim() != 3 or q.shape[-1] != 3:
            raise ValueError(f"block_topk: q {tuple(q.shape)}, expected "
                             "(R, ns, 3) or three (R, ns) planes")
        return q.unbind(-1)
    if len(q) != 3:
        raise ValueError(f"block_topk: {len(q)} query planes, expected 3")
    return tuple(q)


def _check_shapes(views, qs, k: int, lane_mask: int):
    """(R, P, C, ns) after the checks both versions make."""
    if len(views) not in (3, 4):
        raise ValueError(f"block_topk: {len(views)} views; expected 3 "
                         "(x, y, z) or 4 (x, y, z, id)")
    r, p, c = views[0].shape
    if any(v.shape != (r, p, c) for v in views):
        raise ValueError(f"block_topk: view shapes "
                         f"{[tuple(v.shape) for v in views]} differ")
    ns = qs[0].shape[1] if qs[0].dim() == 2 else -1
    if any(t.shape != (r, ns) for t in qs):
        raise ValueError(f"block_topk: query planes "
                         f"{[tuple(t.shape) for t in qs]}, expected ({r}, ns)")
    pc = p * c
    if lane_mask < 0 or lane_mask & (lane_mask + 1) or pc > lane_mask + 1 \
            or lane_mask >= 1 << 23:
        raise ValueError(f"block_topk: lane_mask {lane_mask} is not 2^b-1 "
                         f"with P*C={pc} <= 2^b <= 2^23")
    if not 1 <= k <= pc:
        raise ValueError(f"block_topk: k={k} outside 1..P*C={pc} (past the "
                         "lanes the TPU bodies emit spent keys)")
    return r, p, c, ns


def block_topk_reference(views: Sequence[torch.Tensor], q: Queries, k: int,
                         lane_mask: int
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the block top-k. Returns keys (R, ns*k)
    int32 and ids (R, ns*k) f32, or None without an id view."""
    qs = _query_planes(q)
    r, p, c, ns = _check_shapes(views, qs, k, lane_mask)
    pc = p * c
    x, y, z = (v.reshape(r, 1, pc) for v in views[:3])
    dx = x - qs[0][:, :, None]
    dy = y - qs[1][:, :, None]
    dz = z - qs[2][:, :, None]
    d2 = dx * dx + dy * dy + dz * dz                         # (R, ns, PC)
    lane = torch.arange(pc, dtype=torch.int32, device=x.device)
    keys = (d2.view(torch.int32) & ~lane_mask) | lane
    top = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    if len(views) == 3:
        return top.reshape(r, ns * k), None
    win = top & lane_mask
    src = views[3].reshape(r, 1, pc).expand(r, ns, pc)
    ids = torch.gather(src, 2, torch.clamp(win, max=pc - 1).long())
    ids = torch.where(win < pc, ids, 0.0)
    return top.reshape(r, ns * k), ids.reshape(r, ns * k)


def block_topk(views: Sequence[torch.Tensor], q: Queries, k: int,
               lane_mask: int
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Block top-k: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; same signature and outputs as
    ``block_topk_reference``.

    Replaces the Pallas bodies of the TPU kNN study (P1-P6, see
    ``csrc/block_topk.cu``). The lane mask is an argument and is never
    derived: ``knn_pallas2.py::_kernel2`` runs P*C=2560 lanes under 8191.
    The inputs are checked against what the kernel takes on either
    device, so a CPU run refuses what the card would.
    """
    qs = _query_planes(q)
    dev = qs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"block_topk: unsupported device {dev}")
    r, p, c, ns = _check_shapes(views, qs, k, lane_mask)
    for t in (*views, *qs):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("block_topk: views and queries must be float32 "
                             f"on {dev}; got {t.dtype} on {t.device}")
    if any(v.stride(2) != 1 or min(v.stride()) < 0
           or max(v.stride()) >= 1 << 31 for v in views):
        raise ValueError("block_topk: each view needs slot stride 1 and "
                         f"int32 strides >= 0; got "
                         f"{[v.stride() for v in views]}")
    if len({t.stride() for t in qs}) != 1:
        raise ValueError("block_topk: the three query planes need equal "
                         f"strides; got {[t.stride() for t in qs]}")
    if k > _MAX_K or ns > _MAX_NS:
        raise ValueError(f"block_topk: k={k}, ns={ns}; the kernel takes "
                         f"k<={_MAX_K}, ns<={_MAX_NS}")
    if 3 * 4 * p * c > _SMEM_BYTES:
        raise ValueError(f"block_topk: P*C={p * c} coordinates do not fit "
                         "in one block's shared memory")
    if dev.type == "cpu":
        return block_topk_reference(views, qs, k, lane_mask)
    from point_slam_tpu_torch.ops import _build
    keys = torch.empty((r, ns * k), dtype=torch.int32, device=dev)
    ids = (torch.empty((r, ns * k), dtype=torch.float32, device=dev)
           if len(views) == 4 else None)
    if r == 0:
        return keys, ids
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    vs = list(views) + [None] * (4 - len(views))
    ptrs = [v.data_ptr() if v is not None else None for v in vs]
    strides = [s for v in vs for s in
               ((v.stride(0), v.stride(1)) if v is not None else (0, 0))]
    err = lib.block_topk(*ptrs, *strides, *(t.data_ptr() for t in qs),
                         qs[0].stride(0), qs[0].stride(1), keys.data_ptr(),
                         ids.data_ptr() if ids is not None else None,
                         r, p, c, ns, k, lane_mask, stream)
    _build.check("block_topk", err)
    LAUNCHES["block_topk"] += 1
    return keys, ids
