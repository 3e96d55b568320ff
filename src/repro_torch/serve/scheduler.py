"""The part of ``repro/serve/scheduler.py`` the engine needs: the bounded
queue's error.  The continuous-batching ``Scheduler`` waits for ROADMAP
Queue 1 item 16a."""

from __future__ import annotations


class QueueFullError(RuntimeError):
    """Loud backpressure: the bounded request queue is full.  Carries the
    observed depth so producers can log or shed."""

    def __init__(self, rid: int, queue_depth: int, max_queue: int):
        self.rid = rid
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        super().__init__(
            f"request {rid} rejected: queue depth {queue_depth} at "
            f"max_queue={max_queue} (backpressure — retry later or raise "
            f"max_queue)")
