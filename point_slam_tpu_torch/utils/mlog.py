"""Experiment metrics sink: JSONL always, wandb when enabled and installed.

The port of ``point_slam_tpu.utils.mlog``: one MetricsLogger writes an
append-only ``metrics.jsonl`` (machine readable, survives crashes) and
mirrors to wandb if ``cfg["wandb"]`` is set and the package imports.
``close()`` is the JAX package's ``finish()``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, output_dir: str, cfg: Optional[Dict[str, Any]] = None,
                 name: str = "run"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._wandb = None
        if cfg and cfg.get("wandb"):
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                wandb.init(project=cfg.get("project_name", "point_slam_tpu"),
                           name=name, config=cfg,
                           dir=cfg.get("wandb_folder", output_dir))
                self._wandb = wandb

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"t": time.time(), **metrics}
        if step is not None:
            rec["step"] = step
        self._fh.write(json.dumps(rec, default=float) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_image(self, name: str, path: Optional[str],
                  step: Optional[int] = None) -> None:
        """Mirror an on-disk image artifact to wandb; the file itself is the
        primary artifact, so this is a no-op without wandb."""
        if self._wandb is not None and path:
            self._wandb.log({name: self._wandb.Image(path)}, step=step)

    def log_points(self, name: str, positions, colors=None,
                   step: Optional[int] = None) -> None:
        """Mirror a point cloud to wandb as Object3D. positions (N,3)
        float; colors (N,3) in [0,255] optional."""
        if self._wandb is None:
            return
        pts = np.asarray(positions, np.float32)
        if colors is not None:
            pts = np.hstack([pts, np.asarray(colors, np.float32)])
        self._wandb.log({name: self._wandb.Object3D(pts)}, step=step)

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


class NullSink:
    """MetricsLogger's interface for a process that writes no files (a
    data-parallel rank other than 0): every record is dropped."""

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        pass

    def log_image(self, name: str, path: Optional[str],
                  step: Optional[int] = None) -> None:
        pass

    def log_points(self, name: str, positions, colors=None,
                   step: Optional[int] = None) -> None:
        pass

    def close(self) -> None:
        pass
