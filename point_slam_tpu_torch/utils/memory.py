"""Host and device memory accounting.

The port of ``point_slam_tpu.utils.memory``:

  device — from the CUDA caching allocator: the peak and current bytes
           allocated (``max_memory_allocated``, ``memory_allocated``), the
           bytes it reserves (``memory_reserved``) and the card's free and
           total bytes (``mem_get_info``). None on a CPU run.
  host   — resource.getrusage peak RSS (linux: KiB -> bytes), a true
           process-lifetime peak.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def device_memory(device=None) -> Dict[str, int]:
    """The CUDA device's counters; {} when ``device`` is not a CUDA device
    (or, with no device given, when CUDA is not available)."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    free, total = torch.cuda.mem_get_info(device)
    return {"device_peak_bytes_in_use": int(
                torch.cuda.max_memory_allocated(device)),
            "device_bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "device_bytes_reserved": int(torch.cuda.memory_reserved(device)),
            "device_bytes_free": int(free),
            "device_bytes_limit": int(total)}


def host_memory() -> Dict[str, int]:
    import resource
    import sys
    ru = resource.getrusage(resource.RUSAGE_SELF)
    scale = 1024 if sys.platform.startswith("linux") else 1
    return {"host_peak_rss_bytes": int(ru.ru_maxrss * scale)}


def memory_report(device: Optional[torch.device] = None) -> Dict[str, int]:
    """One dict with both sides; keys are stable for JSON sinks."""
    out = device_memory(device)
    out.update(host_memory())
    return out
