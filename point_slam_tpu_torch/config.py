"""Config system: the YAML tree of ``configs/`` with single-parent inheritance.

Same resolution as ``point_slam_tpu.config.load_config``: a scene yaml may
name a parent via ``inherit_from``; parents load first and are overridden by
the child; the CLI supplies ``configs/point_slam.yaml`` as the default root.
GPU knobs live in a ``cuda:`` section (merged from ``CUDA_DEFAULTS``) in
place of the JAX package's ``tpu:`` section, which this package does not
read.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

import yaml

# Only the knobs the port reads.
CUDA_DEFAULTS: Dict[str, Any] = {
    "cuda": {
        "point_capacity_init": 1 << 17,   # initial padded point buffer rows
        "point_capacity_max": 1 << 22,    # hard cap (ids ride as f32 values,
                                          # exact below 2^24)
        "grid_table_size": 1 << 16,       # cell-table buckets
        "grid_max_per_cell": 64,          # candidate slots per bucket (C)
        "knn_probes": 27,                 # probe slots per ray (P) of the
                                          # ray-shared kNN
        "ray_knn": "auto",                # ray-shared kNN in the renderer:
                                          # 'auto' (on CUDA) | True | False
        "knn_packed_coords": "auto",      # lattice-packed cell table:
                                          # 'auto' (on CUDA) | True | False
                                          # | 'fused' (coords|ids in one
                                          # i32 plane)
        "keyframe_device_budget": 1024,   # keyframes held on the device
        "keyframe_host_ring": "auto",     # keyframe images in host memory,
                                          # the window uploaded per mapped
                                          # frame: True | False | 'auto'
                                          # (host when the expected keyframe
                                          # count exceeds the device budget)
        "data_parallel": 1,               # devices a ray batch is split over
        "fused_adam": False,              # the fused row-Adam kernel for
                                          # the packed (CAP, 72) leaf
        "bf16_features": False,           # render from a bf16 view of the
                                          # packed leaf (hi+lo bf16
                                          # positions; Adam steps the f32
                                          # master): 'auto' (on CUDA) |
                                          # True | False
        "mlp_precision": "highest",       # the decoder MLP blocks' matmuls:
                                          # 'highest' (or None, 'global')
                                          # IEEE f32; 'default' TF32 on
                                          # CUDA. The Fourier embeddings stay
                                          # f32; no effect on the CPU
        "max_iters_per_launch": 200,      # the mapping loop's chunk: where
                                          # mapping.vis_inside panels fire
        "prefetch_depth": 4,              # frames staged ahead by the
                                          # prefetch thread
        "profile_dir": None,              # a directory for a torch.profiler
                                          # Chrome trace of the run
    },
}

# ``tpu:`` keys of the JAX package's configs with the same name and meaning
# under ``cuda:`` (``mlp_precision`` is not one: the TPU's 'default' is a
# bf16 MXU pass, the card's TF32)
TPU_SHARED_KEYS = ("point_capacity_init", "point_capacity_max",
                   "grid_table_size", "grid_max_per_cell",
                   "keyframe_device_budget", "keyframe_host_ring",
                   "data_parallel", "bf16_features", "max_iters_per_launch",
                   "prefetch_depth", "profile_dir")


def update_recursive(dict1: Dict[str, Any], dict2: Dict[str, Any]) -> None:
    """Recursively override ``dict1`` with entries from ``dict2`` (in place)."""
    for k, v in dict2.items():
        if isinstance(v, dict):
            if not isinstance(dict1.get(k), dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def _take_tpu_keys(raw: Dict[str, Any]) -> Dict[str, Any]:
    """One yaml's tree with its shared ``tpu:`` keys copied under
    ``cuda:``, below that yaml's own ``cuda:`` keys."""
    tpu = raw.get("tpu") or {}
    shared = {k: tpu[k] for k in TPU_SHARED_KEYS if k in tpu}
    if not shared:
        return raw
    return {**raw, "cuda": {**shared, **(raw.get("cuda") or {})}}


def load_config(path: str, default_path: Optional[str] = None
                ) -> Dict[str, Any]:
    """Load a YAML config, following its ``inherit_from`` chain.

    ``inherit_from`` resolves against the process CWD first, then against
    the repository root, so configs work from any CWD.
    """
    with open(path, "r") as f:
        cfg_special = _take_tpu_keys(yaml.safe_load(f) or {})

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        parent = inherit_from
        if not os.path.exists(parent):
            here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            cand = os.path.join(here, inherit_from)
            if os.path.exists(cand):
                parent = cand
        cfg = load_config(parent, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = _take_tpu_keys(yaml.safe_load(f) or {})
        base = copy.deepcopy(CUDA_DEFAULTS)
        update_recursive(base, cfg)
        cfg = base
    else:
        cfg = copy.deepcopy(CUDA_DEFAULTS)

    update_recursive(cfg, cfg_special)
    return cfg
