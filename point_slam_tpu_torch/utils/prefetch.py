"""Double-buffered background frame prefetching.

A copy of ``point_slam_tpu.utils.prefetch``: a worker thread fetches the
next frame(s) and stages them on the device while it computes the current
one.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional, Tuple


class FramePrefetcher:
    def __init__(self, dataset, depth: int = 2,
                 start: int = 0, stop: Optional[int] = None,
                 stage=None, fetch=None):
        """``stage``: optional callable applied to each item IN THE WORKER
        THREAD — used to copy the frame to the device so the host->device
        transfer overlaps device compute instead of landing on the critical
        path of the next frame.

        ``fetch``: optional callable ``index -> item`` replacing
        ``dataset[index]`` — used to fetch the compact wire form
        (dataset.wire) so the staged transfer rides at sensor width."""
        self.dataset = dataset
        self._fetch = fetch if fetch is not None else dataset.__getitem__
        self.stop_idx = len(dataset) if stop is None else min(stop, len(dataset))
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stage = stage
        # worker-side wall spent fetching / staging (overlapped with device
        # compute; attributes the consumer's blocked-on-prefetch time)
        self.time_fetch = 0.0
        self.time_stage = 0.0
        self._thread = threading.Thread(
            target=self._worker, args=(start,), daemon=True)
        self._stopped = threading.Event()
        self._thread.start()

    def _worker(self, start: int):
        for i in range(start, self.stop_idx):
            if self._stopped.is_set():
                return
            try:
                t0 = time.perf_counter()
                item = self._fetch(i)
                t1 = time.perf_counter()
                self.time_fetch += t1 - t0
                if self._stage is not None:
                    item = self._stage(item)
                    self.time_stage += time.perf_counter() - t1
            except Exception as e:  # propagate through the queue
                self.q.put(("error", e))
                return
            self.q.put(("ok", item))
        self.q.put(("done", None))

    def __iter__(self) -> Iterator[Tuple]:
        while True:
            kind, item = self.q.get()
            if kind == "done":
                return
            if kind == "error":
                raise item
            yield item

    def close(self):
        self._stopped.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
