"""Streaming sketches (the part of ``repro.stream`` the serving engine's KV
compression needs): right-sketch ``SketchState`` with ``init``/``update``
and the ``range_basis`` finalizer."""

from repro_torch.stream.finalize import range_basis
from repro_torch.stream.state import SketchState, init, update

__all__ = ["SketchState", "init", "update", "range_basis"]
