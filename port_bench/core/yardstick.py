"""The card's peaks and the operation and byte counts the per-layer
metrics divide by.

Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W: 67 TFLOP/s in f32
outside the tensor cores, 3.35 TB/s of HBM. The decoders run in IEEE f32
(``cuda.mlp_precision: highest``), so their FLOPs are held to the f32
peak.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
KEY_FLOPS = 8          # a candidate-sample key: 3 sub, 3 mul, 2 add


def ray_topk_bound_s(rays: int, ns: int, probes: int, cell: int,
                     k: int) -> float:
    """The least time of one ray top-k selection: the larger of its
    operations (a key per probed candidate and sample) over the f32 peak
    and the bytes it must move (its probes, queries and k winners' ids
    and keys a sample; the probed rows, which the inputs do not fix, are
    left out, so this is a lower bound) over HBM."""
    ops = rays * ns * probes * cell * KEY_FLOPS
    n_bytes = rays * probes * 4 + rays * ns * 3 * 4 + rays * ns * k * 8
    return max(ops / F32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S)


def _mlp_macs(emb: int, hidden: int, c_dim: int, blocks: int, skip: int,
              out: int) -> int:
    dims = [(emb, hidden)] + [(hidden + emb if i == skip else hidden, hidden)
                              for i in range(blocks - 1)]
    return (sum(i * o for i, o in dims) + blocks * c_dim * hidden
            + hidden * out)


def decoder_macs(w: Dict[str, Any], rel_pos: bool) -> Dict[str, int]:
    """Multiply-adds a sample of the geometry decoder, of the colour
    decoder and of its neighbour encoder (all neighbours), from the
    published widths ``w``."""
    geo = _mlp_macs(w["geo_emb"], w["geo_hidden"], w["c_dim"], w["blocks"],
                    w["skip"], 1)
    col = _mlp_macs(w["col_emb"], w["col_hidden"], w["c_dim"], w["blocks"],
                    w["skip"], 3)
    nb = 0
    if rel_pos:
        nb = w["nn_num"] * ((w["c_dim"] + w["rel_emb"]) * w["col_hidden"]
                            + w["col_hidden"] * w["c_dim"])
    return {"geo": geo, "col": col, "neighbour": nb}


def render_flops(calls: Iterable[Dict[str, Any]], widths: Dict[str, Any],
                 ns: int, rel_pos: bool, geo_trained: bool) -> float:
    """The decoders' FLOPs of the window's renders, forward and backward:
    a forward pass is 2 x samples x multiply-adds; the backward pass
    computes the inputs' gradient of every layer (once more) and, in
    mapping, the weights' gradient of the decoders being trained (once
    more); tracking trains no decoder."""
    m = decoder_macs(widths, rel_pos)
    # without a pose gradient the first block's input (the embedding of
    # the sample's position) needs none
    first = {"geo": widths["geo_emb"] * widths["geo_hidden"],
             "col": widths["col_emb"] * widths["col_hidden"]}
    total = 0.0
    for c in calls:
        b = c["rays"] * ns
        geo = m["geo"]
        col = (m["col"] + m["neighbour"]) if c["stage_color"] else 0
        fwd = 2.0 * b * (geo + col)
        if c["tracker"]:
            bwd = fwd
        else:
            dgrad = geo - first["geo"] + (col - first["col"] if col else 0)
            wgrad = (geo if geo_trained else 0) + col
            bwd = 2.0 * b * (dgrad + wgrad)
        total += fwd + bwd
    return total
