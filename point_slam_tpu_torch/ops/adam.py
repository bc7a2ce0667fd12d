"""Minimal functional Adam with per-group step counts and learning rates.

The port of ``point_slam_tpu.ops.adam.update``: torch.optim.Adam's formula
(b1=0.9, b2=0.999, eps=1e-8, bias correction), over lists of tensors, with
the step count ``t`` and learning rate ``lr`` of each tensor given by the
caller: a float, or a tensor that broadcasts against it (the mapper's
packed (CAP, 72) leaf takes a (72,) row of per-column step counts and
learning rates). A tensor whose gradient stays zero keeps zero moments and
never moves.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


def init_state(params: Sequence[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params]}


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
            # f32 tensors (not Python floats): the same f32 pow and true
            # division as the JAX package
            tt = torch.as_tensor(t_i, dtype=torch.float32, device=p.device)
            corr[id(t_i)] = (1.0 - b1 ** tt, 1.0 - b2 ** tt)
        c1, c2 = corr[id(t_i)]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / c1
        vhat = v / c2
        new_p.append(p - lr_i * mhat / (torch.sqrt(vhat) + eps))
        new_m.append(m)
        new_v.append(v)
    return new_p, {"m": new_m, "v": new_v}
