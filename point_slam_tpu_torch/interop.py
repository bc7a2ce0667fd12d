"""Carry JAX-package state into the port, from numpy arrays.

The JAX package's decoder parameter tree, ``CloudState`` and cell-table
indexes, converted with ``np.asarray`` on the JAX side, become the port's
``Decoders`` modules and tensors here, so both packages can compute on the
same map. This module imports neither ``jax`` nor ``point_slam_tpu``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch.models import decoders as D
from point_slam_tpu_torch.ops import knn


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _load_linear(lin: torch.nn.Linear, p: Mapping[str, Any]) -> None:
    # JAX's _linear is x @ w + b with w (in, out); nn.Linear holds w.T
    with torch.no_grad():
        lin.weight.copy_(_t(np.asarray(p["w"]).T, "cpu"))
        lin.bias.copy_(_t(p["b"], "cpu"))


def decoders_from_numpy(tree: Mapping[str, Any], cfg: Dict[str, Any],
                        device="cpu") -> D.Decoders:
    """The JAX {"geo", "col"} decoder tree (leaves as numpy arrays) as
    the port's Decoders, with the same names."""
    dec = D.Decoders(cfg)
    for name, mod in (("geo", dec.geo), ("col", dec.col)):
        p = tree[name]
        for i, lin in enumerate(mod.pts_linears):
            _load_linear(lin, p["pts_linears"][i])
        for i, lin in enumerate(mod.fc_c):
            _load_linear(lin, p["fc_c"][i])
        _load_linear(mod.output_linear, p["output_linear"])
        with torch.no_grad():
            mod.embedder_B.copy_(_t(p["embedder_B"], "cpu", torch.float32))
    col = tree["col"]
    for k in ("l1", "l2"):
        _load_linear(dec.col.mlp_col_neighbor[k], col["mlp_col_neighbor"][k])
        if "mlp_exposure" in col:
            _load_linear(dec.col.mlp_exposure[k], col["mlp_exposure"][k])
    with torch.no_grad():
        dec.col.embedder_rel_B.copy_(_t(col["embedder_rel_B"], "cpu",
                                        torch.float32))
        if "embedder_view_B" in col:
            dec.col.embedder_view_B.copy_(_t(col["embedder_view_B"], "cpu",
                                             torch.float32))
    return dec.to(device)


def cloud_from_numpy(packed, n_points, input_pos, input_rgb, n_inputs,
                     device="cpu") -> pc.CloudState:
    """A JAX CloudState's fields as a port CloudState."""
    return pc.CloudState(_t(packed, device, torch.float32),
                         _t(n_points, device, torch.long),
                         _t(input_pos, device, torch.float32),
                         _t(input_rgb, device, torch.float32),
                         _t(n_inputs, device, torch.long))


def index_from_numpy(fields: Mapping[str, Any], device="cpu"):
    """A JAX GridIndex (px, py, pz, pid, cell_size, counts),
    PackedGridIndex (pxyz, pid, cell_size, counts) or FusedGridIndex
    (plane, cell_size, counts), as a dict of numpy arrays
    (``index._asdict()``), as the port's index of the same layout."""
    cell_counts = dict(
        cell_size=_t(fields["cell_size"], device, torch.float32),
        counts=_t(fields["counts"], device, torch.long))
    if "plane" in fields:
        return knn.FusedGridIndex(
            plane=_t(fields["plane"], device, torch.int32), **cell_counts)
    common = dict(pid=_t(fields["pid"], device, torch.float32), **cell_counts)
    if "pxyz" in fields:
        return knn.PackedGridIndex(
            pxyz=_t(fields["pxyz"], device, torch.int32), **common)
    return knn.GridIndex(**{a: _t(fields[a], device, torch.float32)
                            for a in ("px", "py", "pz")}, **common)
