"""Atomic filesystem primitives of the checkpointers (port of
``repro/_atomic_io.py``, a copy: the port imports nothing of ``repro``).

  * **tmp-then-replace**: every durable artifact (a checkpoint directory, a
    manifest, a heartbeat file) is written in full to a sibling temp path
    and moved into place with ``os.replace``, which is atomic on POSIX: a
    reader never sees a half-written checkpoint, and a crash mid-save never
    corrupts the previous one.
  * **async writer**: one daemon thread runs a queue of write thunks, so the
    tile loop overlaps checkpoint IO with compute; the first failure is kept
    and re-raised by ``wait()`` rather than lost on the worker thread.

Departure from the reference: ``AsyncWriter.drain()`` waits for the queue
without raising, for a caller that is already raising (the streamed drivers
drain their writer before a fault reaches their caller).
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Callable, Optional

__all__ = ["atomic_write_dir", "atomic_write_json", "AsyncWriter"]


def atomic_write_json(path: str | Path, doc: dict, *, indent: int = 1,
                      sort_keys: bool = False) -> Path:
    """Atomically write ``doc`` as JSON: a temp file in the same directory,
    then ``os.replace``; readers see the old content or the new, never a
    torn write."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(doc, indent=indent, sort_keys=sort_keys))
    os.replace(tmp, path)
    return path


def atomic_write_dir(final: str | Path, writer: Callable[[Path], None], *,
                     manifest: Optional[dict] = None,
                     manifest_name: str = "manifest.json") -> Path:
    """Atomically materialize a directory: ``writer(tmp)`` fills
    ``<final>.tmp``, the optional ``manifest`` is written last (so its
    presence certifies a complete payload), then the temp directory replaces
    ``final``.  A crash at any point leaves the previous ``final`` intact or
    a stale ``.tmp`` that the next save clears."""
    final = Path(final)
    tmp = final.with_name(final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    writer(tmp)
    if manifest is not None:
        (tmp / manifest_name).write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class AsyncWriter:
    """Single-threaded async executor for checkpoint writes.

    ``submit`` enqueues a zero-arg thunk and returns at once; the daemon
    worker runs the thunks in order.  The first failure is kept and
    re-raised (wrapped) by the next ``wait()``/``close()``."""

    def __init__(self, name: str = "repro-torch-atomic-io"):
        self._q: queue.Queue = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=name)
        self._thread.start()

    def submit(self, fn: Callable[[], None]) -> None:
        self._q.put(fn)

    def drain(self) -> None:
        """Block until every submitted write has run; raise nothing."""
        self._q.join()

    def wait(self) -> None:
        """Block until the queue drains; raise if any write failed."""
        self.drain()
        if self._err:
            raise RuntimeError("async checkpoint writer failed") from self._err

    def close(self) -> None:
        self.wait()

    def _worker(self) -> None:
        while True:
            fn = self._q.get()
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — surfaced by wait()
                self._err = e
            finally:
                self._q.task_done()
