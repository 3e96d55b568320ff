"""Streaming sketches (port of ``repro.stream``): single-pass, out-of-core
RandNLA on kernel 2 at lattice offsets.

State and algebra: ``state.py`` (``SketchState``, ``init``, ``update``,
``update_cols``, ``merge``, ``widen`` + ``hstack``; key-based states for
kernel 2 and SRHT, Omega-carrying ones for the other methods and the serving
engine's heads-batched sketches).  Matrix finalizers: ``finalize.py``
(``svd``, ``range_basis``, ``psi_times``).  Streaming Tucker: ``tucker.py``.
Tile IO: ``source.py`` (array / memmap / directory / generator sources, the
``tiles_from`` resume cursor and the pinned-buffer prefetch to the card) and
``objectstore.py`` (the same contract over byte-range reads: local files,
HTTP ``Range:``, ``manifest.json``).  Fault tolerance: ``resilience.py``
(``SketchJobCheckpointer``, the checkpoint and resume of the streamed
drivers; ``FaultySource`` / ``FlakyRangeFetcher`` fault injection;
``elastic_distributed_rsvd_streamed``; ``ResilienceReport``).

Sliding windows: ``rolling.py`` (``RollingSketchState``, a ring of per-row
sketches whose finalize equals a fresh sketch of the current window).
Multi-host: ``merge_across_hosts`` (the collective merge over a
``torch.distributed`` group, ``state.py``).

Consumers: ``core.rsvd.rsvd_streamed``, ``core.hosvd.rp_sthosvd_streamed``,
``core.distributed.distributed_rsvd_streamed`` and ``serve.kv_compress``
(linear and rolling KV sketches).
"""

from repro_torch.stream.state import (SketchState, hstack, init, merge,
                                      merge_across_hosts, update, update_cols)
from repro_torch.stream.finalize import psi_times, range_basis, svd
from repro_torch.stream.rolling import (RollingSketchState, rolling_finalize,
                                        rolling_init, rolling_update)
from repro_torch.stream.source import (ArraySource, DirectorySource,
                                       GeneratorSource, MemmapSource,
                                       TileSource, as_tile_source,
                                       check_shard_name_order,
                                       offset_tiles, prefetch, source_tiles)
from repro_torch.stream.objectstore import (FileRangeFetcher,
                                            HttpRangeFetcher,
                                            ObjectStoreSource, RetryPolicy,
                                            ShortReadError, read_npy_header)
from repro_torch.stream.tucker import (TuckerSketch, tucker, tucker_finalize,
                                       tucker_init, tucker_merge,
                                       tucker_update)
from repro_torch.stream.resilience import (FaultInjected, FaultySource,
                                           FlakyRangeFetcher,
                                           ResilienceReport,
                                           RestoredCheckpoint,
                                           SketchJobCheckpointer,
                                           elastic_distributed_rsvd_streamed,
                                           partition_rows, sketch_row_range)

# ``stream.range(state)`` per the reference; range_basis is the shadow-free
# name.
range = range_basis  # noqa: A001

__all__ = [
    "SketchState", "init", "update", "update_cols", "merge",
    "merge_across_hosts", "hstack", "svd", "range", "range_basis",
    "psi_times", "RollingSketchState", "rolling_init", "rolling_update",
    "rolling_finalize", "TileSource", "ArraySource", "MemmapSource",
    "DirectorySource", "GeneratorSource", "ObjectStoreSource",
    "FileRangeFetcher", "HttpRangeFetcher", "RetryPolicy", "ShortReadError",
    "read_npy_header", "check_shard_name_order",
    "as_tile_source", "offset_tiles", "prefetch", "source_tiles",
    "TuckerSketch", "tucker", "tucker_finalize", "tucker_init",
    "tucker_merge", "tucker_update",
    "SketchJobCheckpointer", "RestoredCheckpoint", "ResilienceReport",
    "FaultySource", "FaultInjected", "FlakyRangeFetcher",
    "partition_rows", "sketch_row_range",
    "elastic_distributed_rsvd_streamed",
]
