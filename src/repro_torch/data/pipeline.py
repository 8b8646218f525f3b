"""Host-side input pipeline: double-buffered prefetch with straggler
mitigation (a verbatim copy of ``repro/data/pipeline.py``, which is pure
Python).

At fleet scale the data path is the straggler source (slow host, slow
network volume). The loader here:
  * prefetches ``depth`` batches on a background thread (compute never
    waits on a healthy producer);
  * applies a per-batch deadline: if the producer misses it, a BACKUP
    producer generates the batch from the same (step, seed) — possible
    because batches are pure functions of the step (data/synthetic.py),
    so the backup is bitwise identical and determinism survives;
  * counts timeouts for monitoring (a node whose primary keeps missing
    deadlines gets drained by the orchestrator).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional


class PrefetchLoader:
    def __init__(
        self,
        batch_fn: Callable[[int], Any],
        *,
        depth: int = 2,
        deadline_s: Optional[float] = None,
        start_step: int = 0,
    ):
        self.batch_fn = batch_fn
        self.deadline_s = deadline_s
        self.timeouts = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.batch_fn(step)
            except Exception as e:  # surfaced on the consumer side
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        deadline = self.deadline_s
        try:
            step, batch = self._q.get(timeout=deadline) if deadline else self._q.get()
        except queue.Empty:
            # straggler path: the backup producer regenerates the batch
            # deterministically from the step index.
            self.timeouts += 1
            step = self._consumed if hasattr(self, "_consumed") else 0
            batch = self.batch_fn(step)
            self._consumed = step + 1
            return batch
        if isinstance(batch, Exception):
            raise batch
        self._consumed = step + 1
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
