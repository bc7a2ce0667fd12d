"""Minimal functional Adam with per-group step counts and learning rates.

The port of ``point_slam_tpu.ops.adam``: torch.optim.Adam's formula
(b1=0.9, b2=0.999, eps=1e-8, bias correction), over lists of tensors, with
the step count ``t`` and learning rate ``lr`` of each tensor given by the
caller: a float, or a tensor that broadcasts against it (the mapper's
packed (CAP, 72) leaf takes a (72,) row of per-column step counts and
learning rates). A tensor whose gradient stays zero keeps zero moments and
never moves.

``update_rows`` is the fused masked Adam over one (N, W) leaf: the CUDA
kernel ``csrc/row_adam.cu`` on the card, ``update_rows_reference`` on the
CPU. ``update(..., in_place=True)`` steps every tensor of the list in
place: on the card in one launch of the same source's ``multi_adam``, on
the CPU by the functional formula copied back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from point_slam_tpu_torch.utils import spans

Scalar = Union[float, torch.Tensor]


def init_state(params: Sequence[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params]}


def bias_corrections(t: Scalar, b1: float, b2: float, device):
    """(1 - b1^t, 1 - b2^t) as f32 tensors (not Python floats): the same
    f32 pow and true division as the JAX package. A Python ``t`` is
    uploaded (on CUDA a host sync)."""
    tt = spans.upload(t, device, torch.float32)
    return 1.0 - b1 ** tt, 1.0 - b2 ** tt


def _per_param(x, n: int):
    return list(x) if isinstance(x, (list, tuple)) else [x] * n


@torch.no_grad()
def update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           state: Dict[str, List[torch.Tensor]],
           t: Union[Scalar, Sequence[Scalar]],
           lr: Union[Scalar, Sequence[Scalar]],
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           in_place: bool = False,
           rows: Optional[Sequence[Optional[int]]] = None
           ) -> Tuple[List[torch.Tensor], Dict[str, List[torch.Tensor]]]:
    """One Adam step. ``t`` (1-based) and ``lr`` are one value for all
    tensors or one per tensor. Returns (new_params, new_state).

    ``in_place``: write p, m and v in place and return those same tensors
    (callers keep no reference to the old values); on CUDA one launch of
    ``multi_adam`` for every tensor (more than one only past the kernel's
    table), elsewhere the functional formula copied back. The tensors are
    f32 on one device, p, m and v contiguous; each ``t`` and ``lr`` is a
    number or a contiguous f32 row of p's last width on that device
    (ValueError otherwise). ``rows`` (in place only): per tensor, None or
    the number of leading rows to step; the rows past it must have zero
    gradient and moments, which Adam leaves bit for bit as they are (the
    mapper's packed leaf past the cloud). Bit-equal to the functional step
    on every device.
    """
    n = len(params)
    if in_place:
        return _update_in_place(params, grads, state, _per_param(t, n),
                                _per_param(lr, n),
                                [None] * n if rows is None else list(rows),
                                b1, b2, eps)
    if rows is not None:
        raise ValueError("update: rows are stepped in place only")
    return _step(params, grads, state["m"], state["v"], _per_param(t, n),
                 _per_param(lr, n), b1, b2, eps)


def _step(params, grads, ms, vs, ts, lrs, b1, b2, eps):
    """The functional step over lists (one t and lr per tensor)."""
    new_p, new_m, new_v = [], [], []
    corr = {}   # bias corrections, computed once per distinct step count
    for p, g, m, v, t_i, lr_i in zip(params, grads, ms, vs, ts, lrs):
        if id(t_i) not in corr:
            corr[id(t_i)] = bias_corrections(t_i, b1, b2, p.device)
        c1, c2 = corr[id(t_i)]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / c1
        vhat = v / c2
        new_p.append(p - lr_i * mhat / (torch.sqrt(vhat) + eps))
        new_m.append(m)
        new_v.append(v)
    return new_p, {"m": new_m, "v": new_v}


def _check_in_place(params, grads, ms, vs, ts, lrs, rows) -> None:
    """Refuse (ValueError) what the in-place step cannot take, on every
    device alike."""
    if not (len(grads) == len(ms) == len(vs) == len(ts) == len(lrs)
            == len(rows) == len(params)):
        raise ValueError("update: params, grads, moments, t, lr and rows "
                         "differ in length")
    dev = params[0].device if params else None
    for k, (p, g, m, v, t_k, lr_k, r) in enumerate(
            zip(params, grads, ms, vs, ts, lrs, rows)):
        for x in (p, g, m, v):
            if x.dtype != torch.float32 or x.device != dev:
                raise ValueError(
                    f"update: tensor {k}: in place takes f32 tensors on one "
                    f"device ({dev}), not {x.dtype} on {x.device}")
            if x.shape != p.shape:
                raise ValueError(f"update: tensor {k}: grads and moments "
                                 f"of shape {tuple(x.shape)}, params "
                                 f"{tuple(p.shape)}")
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError(f"update: tensor {k}: p, m and v must be "
                             "contiguous to be written in place")
        for x in (t_k, lr_k):
            if isinstance(x, torch.Tensor) and not (
                    x.dim() == 1 and p.dim() >= 1
                    and x.shape[0] == p.shape[-1]
                    and x.dtype == torch.float32 and x.device == dev
                    and x.is_contiguous()):
                raise ValueError(
                    f"update: tensor {k}: t and lr must be numbers or "
                    f"contiguous ({p.shape[-1] if p.dim() else 1},) f32 "
                    f"rows on {dev}, not {tuple(x.shape)} {x.dtype} on "
                    f"{x.device}")
        if r is not None and not (p.dim() >= 1 and 0 <= r <= p.shape[0]):
            raise ValueError(f"update: tensor {k}: rows {r} outside "
                             f"{tuple(p.shape)}")


def _update_in_place(params, grads, state, ts, lrs, rows, b1, b2, eps):
    ms, vs = state["m"], state["v"]
    _check_in_place(params, grads, ms, vs, ts, lrs, rows)
    spans.count("adam.tensors", len(params))
    if any(r is not None for r in rows):
        spans.count("adam.rows", sum(r for r in rows if r is not None))
    if params and params[0].device.type == "cuda":
        _multi_adam(params, grads, ms, vs, ts, lrs, rows, b1, b2, eps)
    else:
        ps, gs, m_in, v_in = ([x if r is None else x[:r]
                               for x, r in zip(xs, rows)]
                              for xs in (params, grads, ms, vs))
        new_p, new = _step(ps, gs, m_in, v_in, ts, lrs, b1, b2, eps)
        for dst, src in zip(ps + m_in + v_in, new_p + new["m"] + new["v"]):
            dst.copy_(src)
    return list(params), {"m": list(ms), "v": list(vs)}


def _multi_adam(params, grads, ms, vs, ts, lrs, rows, b1, b2, eps) -> None:
    """The table of every tensor with elements to step, launched in chunks
    of the kernel's table size."""
    from point_slam_tpu_torch.ops import _build
    max_tensors, max_period = _multi_adam_limits()
    entries = []
    keep = []   # contiguous copies of gradients, alive until launched
    for k, (p, g, m, v, t_k, lr_k, r) in enumerate(
            zip(params, grads, ms, vs, ts, lrs, rows)):
        numel = p.numel() if r is None else p[:r].numel()
        if numel == 0:
            continue
        g = g.contiguous()
        keep.append(g)
        ptrs = [x.data_ptr() for x in (p, g, m, v)]
        if any(a % 16 for a in ptrs):
            raise ValueError(f"update: tensor {k}: the kernel takes "
                             "16-byte aligned tensors")
        if numel >= 1 << 31:
            raise ValueError(f"update: tensor {k}: {numel} elements, past "
                             "the kernel's 2^31")
        w = 1
        vals = []
        for x in (t_k, lr_k):
            if isinstance(x, torch.Tensor):
                w = x.shape[0]
                ptrs.append(x.data_ptr())
                vals.append(0.0)
            else:
                ptrs.append(0)
                vals.append(float(x))
        if math.lcm(w, 4) > max_period:
            raise ValueError(f"update: tensor {k}: rows of {w} columns, "
                             "wider than the kernel's shared memory holds")
        entries.append((ptrs, vals, numel, w))
    stream = _build.stream(params[0].device)
    launch = _build.kernel("multi_adam")
    for i in range(0, len(entries), max_tensors):
        chunk = entries[i:i + max_tensors]
        c = len(chunk)
        err = launch(
            c, (ctypes.c_ulonglong * (6 * c))(*(a for e in chunk
                                                for a in e[0])),
            (ctypes.c_float * (2 * c))(*(x for e in chunk for x in e[1])),
            (ctypes.c_int * c)(*(e[2] for e in chunk)),
            (ctypes.c_int * c)(*(e[3] for e in chunk)),
            b1, 1 - b1, b2, 1 - b2, eps, stream)
        if err:
            _build.check("multi_adam", err)
        LAUNCHES["multi_adam"] += 1


@functools.cache
def _multi_adam_limits() -> Tuple[int, int]:
    """multi_adam's tensors a launch and widest column period (asked of
    the library once)."""
    from point_slam_tpu_torch.ops import _build
    a, b = ctypes.c_int(), ctypes.c_int()
    _build.kernel("multi_adam_limits")(ctypes.byref(a), ctypes.byref(b))
    return a.value, b.value


def update_rows_reference(params: torch.Tensor, grads: torch.Tensor,
                          state: Dict[str, torch.Tensor], t_row: Scalar,
                          lr_row: Scalar, row_mask: torch.Tensor,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8):
    """Plain PyTorch version of the fused row-Adam: ``update`` over the one
    (N, W) leaf with its gradient masked per row, per-column ``t_row`` and
    ``lr_row`` ((W,) or scalars). Returns (new_params, {"m", "v"})."""
    (p,), st = update([params], [grads * row_mask.to(grads.dtype)[:, None]],
                      {"m": [state["m"]], "v": [state["v"]]}, [t_row],
                      [lr_row], b1, b2, eps)
    return p, {"m": st["m"][0], "v": st["v"][0]}


# Launches of the CUDA kernels, counted by update_rows and update where
# they launch them.
LAUNCHES = {"row_adam": 0, "multi_adam": 0}


def _row_arg(x: Scalar, w: int, dev: torch.device):
    """A per-column row for the kernel: (pointer, 0.0) for a (W,) f32 CUDA
    tensor, (None, value) for a number."""
    if not isinstance(x, torch.Tensor):
        return None, float(x)
    if (x.shape != (w,) or x.dtype != torch.float32 or x.device != dev
            or not x.is_contiguous()):
        raise ValueError(f"update_rows: t_row and lr_row must be numbers or "
                         f"contiguous ({w},) f32 tensors on {dev}")
    return x.data_ptr(), 0.0


@torch.no_grad()
def update_rows(params: torch.Tensor, grads: torch.Tensor,
                state: Dict[str, torch.Tensor], t_row: Scalar, lr_row: Scalar,
                row_mask: torch.Tensor, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """Adam over one (N, W) f32 leaf with per-COLUMN step counts and
    learning rates and a per-ROW gradient mask, in one pass: the CUDA
    kernel for CUDA tensors, ``update_rows_reference`` for CPU tensors.
    Same signature and results as ``update_rows_reference``; on the card
    ``t_row`` and ``lr_row`` are (W,) f32 tensors or numbers.

    On the card the kernel writes p, m and v IN PLACE and returns those
    same tensors: callers keep no reference to the old values. The mapper
    hands it the live rows only (contiguous prefix views of its buffers).

    Replaces point_slam_tpu/ops/adam.py::_row_adam_kernel / update_rows.
    Bound by memory: 7 (N, W) f32 arrays read or written once plus the
    mask, 36.4 MB at the frame-0 cloud's N = 18,006, W = 72 (~11 us at
    3.35 TB/s). The kernel computes the bias corrections itself, so this
    wrapper runs no tensor op: it checks attributes and launches.
    """
    m, v = state["m"], state["v"]
    spans.count("adam.tensors", 1)
    spans.count("adam.rows", params.shape[0])
    if params.device.type == "cpu":
        return update_rows_reference(params, grads, state, t_row, lr_row,
                                     row_mask, b1, b2, eps)
    if params.device.type != "cuda":
        raise RuntimeError(f"update_rows: unsupported device {params.device}")
    if params.dim() != 2 or params.shape[1] % 4:
        raise ValueError(f"update_rows: params {tuple(params.shape)}, "
                         "expected (N, W) with W a multiple of 4")
    n, w = params.shape
    dev = params.device
    for x in (params, grads, m, v, row_mask):
        if (x.dtype != torch.float32 or x.device != dev
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError("update_rows: inputs must be contiguous, "
                             "16-byte aligned f32 tensors on one CUDA device")
    if (grads.shape != params.shape or m.shape != params.shape
            or v.shape != params.shape or row_mask.shape != (n,)):
        raise ValueError("update_rows: grads, m, v must be (N, W) and "
                         "row_mask (N,)")
    t_ptr, t_val = _row_arg(t_row, w, dev)
    lr_ptr, lr_val = _row_arg(lr_row, w, dev)
    if n == 0:
        return params, {"m": m, "v": v}
    from point_slam_tpu_torch.ops import _build
    err = _build.kernel("row_adam")(
        params.data_ptr(), grads.data_ptr(), m.data_ptr(), v.data_ptr(),
        row_mask.data_ptr(), t_ptr, t_val, lr_ptr, lr_val, n, w, b1, 1 - b1,
        b2, 1 - b2, eps, _build.stream(dev))
    if err:
        _build.check("row_adam", err)
    LAUNCHES["row_adam"] += 1
    return params, {"m": m, "v": v}
