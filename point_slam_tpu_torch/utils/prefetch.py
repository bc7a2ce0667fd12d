"""Double-buffered background frame prefetching.

A copy of ``point_slam_tpu.utils.prefetch``: a worker thread fetches the
next frame(s) and stages them on the device while it computes the current
one. The worker times each fetch and stage as a span of the run's
recorder (``utils/spans.py``: ``reader.fetch``, ``reader.stage``, on the
worker's thread, recorded once the recorder is enabled); ``time_fetch``
and ``time_stage`` are their walls' totals, which the metrics sink reads
through ``PointSLAM.timing``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

from point_slam_tpu_torch.utils.spans import Spans


class FramePrefetcher:
    def __init__(self, dataset, depth: int = 2,
                 start: int = 0, stop: Optional[int] = None,
                 stage=None, fetch=None, spans: Optional[Spans] = None):
        """``stage``: optional callable applied to each item IN THE WORKER
        THREAD — used to copy the frame to the device so the host->device
        transfer overlaps device compute instead of landing on the critical
        path of the next frame.

        ``fetch``: optional callable ``index -> item`` replacing
        ``dataset[index]`` — used to fetch the compact wire form
        (dataset.wire) so the staged transfer rides at sensor width.

        ``spans``: the recorder the worker's spans go to (a recorder of
        its own, off, by default)."""
        self.dataset = dataset
        self._fetch = fetch if fetch is not None else dataset.__getitem__
        self.stop_idx = len(dataset) if stop is None else min(stop, len(dataset))
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stage = stage
        self.spans = spans if spans is not None else Spans()
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
                with self.spans.timed("reader.fetch", frame=i) as sp:
                    item = self._fetch(i)
                self.time_fetch += sp.s
                if self._stage is not None:
                    with self.spans.timed("reader.stage", frame=i) as sp:
                        item = self._stage(item)
                    self.time_stage += sp.s
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
