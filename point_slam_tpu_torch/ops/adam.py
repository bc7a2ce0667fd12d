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
CPU.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


def init_state(params: Sequence[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params]}


def bias_corrections(t: Scalar, b1: float, b2: float, device):
    """(1 - b1^t, 1 - b2^t) as f32 tensors (not Python floats): the same
    f32 pow and true division as the JAX package."""
    tt = torch.as_tensor(t, dtype=torch.float32, device=device)
    return 1.0 - b1 ** tt, 1.0 - b2 ** tt


def _per_param(x, n: int):
    return list(x) if isinstance(x, (list, tuple)) else [x] * n


@torch.no_grad()
def update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           state: Dict[str, List[torch.Tensor]],
           t: Union[Scalar, Sequence[Scalar]],
           lr: Union[Scalar, Sequence[Scalar]],
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
           ) -> Tuple[List[torch.Tensor], Dict[str, List[torch.Tensor]]]:
    """One Adam step. ``t`` (1-based) and ``lr`` are one value for all
    tensors or one per tensor. Returns (new_params, new_state)."""
    n = len(params)
    new_p, new_m, new_v = [], [], []
    corr = {}   # bias corrections, computed once per distinct step count
    for p, g, m, v, t_i, lr_i in zip(params, grads, state["m"], state["v"],
                                     _per_param(t, n), _per_param(lr, n)):
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


# Launches of the CUDA kernel, counted by update_rows where it launches it.
LAUNCHES = {"row_adam": 0}


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
