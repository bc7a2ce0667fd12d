"""The modules a run must not load: JAX and the JAX package, compared by
whole top-level name (the part before the first dot), so the port
``point_slam_tpu_torch`` is not the JAX package ``point_slam_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "point_slam_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str]) -> List[str]:
    """The names whose top level is forbidden, sorted."""
    return sorted(n for n in set(names) if top_level(n) in FORBIDDEN)


def loaded() -> List[str]:
    return forbidden(sys.modules)
