"""Tile sources: where out-of-core row tiles come from, and how they reach
the card (port of ``repro/stream/source.py``).

A :class:`TileSource` is a replayable-or-not factory of axis-0 row tiles
over a fixed underlying array:

  * :class:`ArraySource`     -- an in-memory array (numpy or torch), re-tiled;
  * :class:`MemmapSource`    -- an ``.npy`` file opened with
    ``np.load(mmap_mode="r")``: one tile is read at a time, never the matrix;
  * :class:`DirectorySource` -- a directory of ``.npy`` row shards in sorted
    filename order, each memmapped and re-tiled;
  * :class:`GeneratorSource` -- a zero-arg factory of fresh tile iterators
    (replayable) or a bare one-shot iterator (not replayable);
  * ``stream.objectstore.ObjectStoreSource`` -- row shards behind byte-range
    reads (local files or HTTP ``Range:`` requests, ``manifest.json``).

All sources yield tiles in row order, tiling axis 0 exactly.
``TileSource.tiles_from(start_row)`` is the resume cursor of checkpointed
jobs: the suffix of ``tiles()`` from a tile boundary, with the same tile
boundaries; the disk sources seek to it.

:func:`prefetch` reads tiles on a background thread.  On a CUDA device it
copies each one into a pinned host buffer and from there to the card with
``non_blocking=True`` on a side stream, recording an event; the consumer's
stream waits on that event before the tile is used.  There are ``depth + 1``
pinned buffers, and a buffer is refilled only after the event of its last
copy has completed.  On ``device="cpu"`` the copy step is skipped (the caller
asked for the CPU) and tiles are handed over as CPU tensors.

Departure from the reference: ``prefetch``, ``source_tiles`` and
``offset_tiles`` take a ``device`` in place of ``to_device``.
"""

from __future__ import annotations

import math
import queue
import re
import threading
import warnings
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "TileSource", "ArraySource", "MemmapSource", "DirectorySource",
    "GeneratorSource", "as_tile_source", "check_shard_name_order",
    "offset_tiles", "prefetch", "source_tiles",
]

DEFAULT_TILE_ROWS = 256

_NUM_SUFFIX = re.compile(r"^(.*?)(\d+)$")


def check_shard_name_order(names: Sequence[str]) -> None:
    """Guard against lexicographic-vs-numeric shard permutation: shard order
    is row order and directory listings sort lexicographically, so unpadded
    numeric names (``shard_2.npy`` after ``shard_10.npy``) would silently
    permute the matrix's rows.  Any same-prefix adjacent pair of
    ``<prefix><digits>`` names whose numeric order disagrees with the given
    order raises, naming the pair; non-numeric names are left alone."""
    parsed = []
    for name in names:
        m = _NUM_SUFFIX.match(Path(name).stem)
        if m is None:
            continue
        parsed.append((m.group(1), int(m.group(2)), name))
    for (pre1, num1, name1), (pre2, num2, name2) in zip(parsed, parsed[1:]):
        if pre1 == pre2 and num1 > num2:
            raise ValueError(
                f"shard filenames sort lexicographically but their numeric "
                f"suffixes disagree: {name1!r} sorts before {name2!r} yet "
                f"{num1} > {num2} — tiles would silently permute matrix "
                f"rows.  Zero-pad the indices or pass the shards as an "
                f"explicit ordered list")


class TileSource:
    """Base class: a (re)playable stream of axis-0 tiles of one array.

    Subclasses set ``shape`` (the full underlying array's) and implement
    ``tiles()``, a fresh iterator of row tiles.  ``replayable`` says whether
    ``tiles()`` may be called more than once, which multi-pass consumers
    (``rsvd_streamed(passes>=2)``) need.
    """

    shape: tuple[int, ...] = ()

    @property
    def n_rows(self) -> int:
        return int(self.shape[0])

    @property
    def n_cols(self) -> int:
        """Width of the axis-0 unfolding (== shape[1] for matrices)."""
        return int(math.prod(self.shape[1:]))

    @property
    def replayable(self) -> bool:
        return True

    def tiles(self) -> Iterator:
        raise NotImplementedError

    def tiles_from(self, start_row: int) -> Iterator:
        """Tiles from global row ``start_row`` on: exactly the suffix of
        ``tiles()`` that starts there, with the same tile boundaries, so a
        resumed sketch replays bit for bit.  ``start_row`` must be a tile
        boundary of this source's tiling (else ValueError).  This base
        version iterates ``tiles()`` and drops the prefix, paying its IO;
        the disk sources seek."""
        start = self._check_start(start_row)
        if start == 0:
            return self.tiles()

        def gen():
            off = 0
            for tile in self.tiles():
                b = int(tile.shape[0])
                if off < start:
                    if off + b > start:
                        raise ValueError(_not_a_boundary(start, off, b))
                    off += b
                    continue
                yield tile
                off += b
        return gen()

    def _check_start(self, start_row: int) -> int:
        start = int(start_row)
        if not 0 <= start <= self.n_rows:
            raise ValueError(f"start_row={start} out of range for a source "
                             f"with {self.n_rows} rows")
        return start

    def _check_fixed_grid(self, start_row: int) -> int:
        """``start_row`` checked against a ``tile_rows`` grid from row 0."""
        start = self._check_start(start_row)
        if start % self.tile_rows and start != self.n_rows:
            raise ValueError(_not_a_boundary(
                start, start - start % self.tile_rows, self.tile_rows))
        return start

    def __iter__(self) -> Iterator:
        return self.tiles()


def _not_a_boundary(start: int, off: int, width: int) -> str:
    return (f"start_row={start} is not a tile boundary (falls inside the "
            f"tile covering rows [{off}, {off + width})) — resume cursors "
            f"must land exactly between tiles so the replayed suffix keeps "
            f"the original tile boundaries")


def _chunk(array, tile_rows: int) -> Iterator:
    for off in range(0, array.shape[0], tile_rows):
        yield array[off:off + tile_rows]


def _check_tile_rows(tile_rows: int) -> int:
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    return int(tile_rows)


class ArraySource(TileSource):
    """An in-memory array re-tiled into ``tile_rows`` row tiles (ragged last
    tile when ``tile_rows`` does not divide the row count)."""

    def __init__(self, array, tile_rows: int = DEFAULT_TILE_ROWS):
        if array.ndim < 2:
            raise ValueError(f"tile sources need ndim >= 2 arrays, got "
                             f"shape {tuple(array.shape)}")
        self.tile_rows = _check_tile_rows(tile_rows)
        self._array = array
        self.shape = tuple(int(s) for s in array.shape)

    def tiles(self) -> Iterator:
        return _chunk(self._array, self.tile_rows)

    def tiles_from(self, start_row: int) -> Iterator:
        start = self._check_fixed_grid(start_row)
        return _chunk(self._array[start:], self.tile_rows)


def _load_header(path: Path):
    arr = np.load(path, mmap_mode="r")
    if arr.ndim < 2:
        raise ValueError(f"{path}: tile sources need ndim >= 2 arrays, got "
                         f"shape {arr.shape}")
    return arr


class MemmapSource(TileSource):
    """An ``.npy`` file, memory-mapped anew by each ``tiles()`` replay; each
    tile is copied out of the map (``np.array``) so the disk read happens in
    the prefetch thread, not inside the consumer's kernel."""

    def __init__(self, path: Union[str, Path],
                 tile_rows: int = DEFAULT_TILE_ROWS):
        self.path = Path(path)
        self.tile_rows = _check_tile_rows(tile_rows)
        self.shape = tuple(int(s) for s in _load_header(self.path).shape)

    def tiles(self) -> Iterator:
        return self.tiles_from(0)

    def tiles_from(self, start_row: int) -> Iterator:
        start = self._check_fixed_grid(start_row)
        mm = np.load(self.path, mmap_mode="r")
        return (np.array(t) for t in _chunk(mm[start:], self.tile_rows))


class DirectorySource(TileSource):
    """A directory of ``.npy`` row shards concatenated in sorted filename
    order.  Shards may have unequal row counts; trailing dims must agree.
    Tiles never cross shard boundaries, so a shard's last tile may be
    ragged."""

    def __init__(self, path: Union[str, Path],
                 tile_rows: int = DEFAULT_TILE_ROWS, pattern: str = "*.npy"):
        self.path = Path(path)
        self.tile_rows = _check_tile_rows(tile_rows)
        self.files = sorted(self.path.glob(pattern))
        if not self.files:
            raise ValueError(f"no {pattern} shards in {self.path}")
        check_shard_name_order([f.name for f in self.files])
        trailing = None
        self.shard_rows: list[int] = []
        for f in self.files:
            hdr = _load_header(f)
            if trailing is None:
                trailing = hdr.shape[1:]
            elif hdr.shape[1:] != trailing:
                raise ValueError(
                    f"shard {f.name} has trailing shape {hdr.shape[1:]}, "
                    f"expected {trailing} (all shards must agree)")
            self.shard_rows.append(int(hdr.shape[0]))
        self.shape = (sum(self.shard_rows),) + tuple(int(s) for s in trailing)

    def tiles(self) -> Iterator:
        return self.tiles_from(0)

    def tiles_from(self, start_row: int) -> Iterator:
        start = self._check_start(start_row)

        def gen():
            pos = 0
            for f, rows in zip(self.files, self.shard_rows):
                if pos + rows <= start:
                    pos += rows             # a shard before the cursor: no IO
                    continue
                local = max(start - pos, 0)
                if local % self.tile_rows:
                    raise ValueError(_not_a_boundary(
                        start, pos + local - local % self.tile_rows,
                        self.tile_rows))
                mm = np.load(f, mmap_mode="r")
                for t in _chunk(mm[local:], self.tile_rows):
                    yield np.array(t)
                pos += rows
        return gen()


class GeneratorSource(TileSource):
    """Tiles from user code: a zero-arg factory returning a fresh iterator
    per ``tiles()`` call (replayable), or a bare iterator that can be
    consumed once (``replayable`` is False).  ``shape`` must be given: a
    generator cannot be inspected without consuming it."""

    def __init__(self, tiles_or_factory, shape: Sequence[int]):
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) < 2:
            raise ValueError(f"tile sources need ndim >= 2 shapes, got "
                             f"{self.shape}")
        self._factory: Optional[Callable[[], Iterable]] = None
        self._once: Optional[Iterator] = None
        if callable(tiles_or_factory):
            self._factory = tiles_or_factory
        else:
            self._once = iter(tiles_or_factory)

    @property
    def replayable(self) -> bool:
        return self._factory is not None

    def tiles(self) -> Iterator:
        if self._factory is not None:
            return iter(self._factory())
        it, self._once = self._once, None
        if it is None:
            raise ValueError(
                "this GeneratorSource wraps a bare iterator and has already "
                "been consumed; pass a zero-arg factory for replayability")
        return it


def as_tile_source(obj, *, tile_rows: int = DEFAULT_TILE_ROWS,
                   shape: Optional[Sequence[int]] = None) -> TileSource:
    """Coerce ``obj`` into a :class:`TileSource`.

      TileSource            -> itself (tile_rows/shape ignored)
      array/tensor (ndim>=2)-> ArraySource
      http(s) URL           -> ObjectStoreSource (ranged GETs; a prefix URL
                               resolves <prefix>/manifest.json)
      str/Path to a *.json  -> ObjectStoreSource (byte-range reads over the
                               manifest's shards)
      str/Path to a file    -> MemmapSource (.npy)
      str/Path to a dir     -> DirectorySource
      callable              -> GeneratorSource (replayable; needs ``shape``)
      sequence of tiles     -> GeneratorSource (replayable; shape inferred)
      re-iterable container -> GeneratorSource (replayable; needs ``shape``)
      bare iterator         -> GeneratorSource (one-shot; needs ``shape``)
    """
    if isinstance(obj, TileSource):
        return obj
    if isinstance(obj, (str, Path)):
        s = str(obj)
        if s.startswith(("http://", "https://")) or s.endswith(".json"):
            # deferred: objectstore imports this module for TileSource
            from repro_torch.stream.objectstore import ObjectStoreSource
            return ObjectStoreSource(obj, tile_rows)
        p = Path(obj)
        return (DirectorySource(p, tile_rows) if p.is_dir()
                else MemmapSource(p, tile_rows))
    if hasattr(obj, "ndim") and hasattr(obj, "shape"):
        return ArraySource(obj, tile_rows)
    if callable(obj):
        if shape is None:
            raise ValueError("a callable tile factory needs an explicit "
                             "shape=(n_rows, n_cols, ...)")
        return GeneratorSource(obj, shape)
    if isinstance(obj, Sequence):
        if shape is None:
            tiles = list(obj)
            if not tiles:
                raise ValueError("cannot infer shape from an empty tile "
                                 "sequence; pass shape=")
            rows = sum(int(t.shape[0]) for t in tiles)
            shape = (rows,) + tuple(tiles[0].shape[1:])
            obj = tiles
        seq = obj
        return GeneratorSource(lambda: iter(seq), shape)
    if isinstance(obj, (Iterator, Iterable)):
        it = iter(obj)
        if it is not obj:
            # a re-iterable container: replayable, but inferring its shape
            # would cost a full extra pass over out-of-core data
            if shape is None:
                raise ValueError("a re-iterable tile container needs an "
                                 "explicit shape=(n_rows, n_cols, ...) — "
                                 "inferring it would cost a full extra "
                                 "pass over the tiles")
            return GeneratorSource(lambda: iter(obj), shape)
        if shape is None:
            raise ValueError("a bare tile iterator needs an explicit "
                             "shape=(n_rows, n_cols, ...)")
        return GeneratorSource(it, shape)
    raise TypeError(f"cannot build a TileSource from {type(obj).__name__}")


def _as_tensor(tile) -> torch.Tensor:
    return tile if isinstance(tile, torch.Tensor) else torch.as_tensor(tile)


class _Uploader:
    """The reader thread's side of the CUDA prefetch: ``depth + 1`` pinned
    host buffers used in turn, each with the event of its last copy.  A tile
    is staged in the next buffer (after that buffer's previous copy has
    completed) and copied to a fresh device tensor on the side stream."""

    def __init__(self, dev: torch.device, n_buffers: int):
        self.dev = dev
        self.stream = torch.cuda.Stream(dev)
        self.buffers: list[Optional[torch.Tensor]] = [None] * n_buffers
        self.events: list[Optional[torch.cuda.Event]] = [None] * n_buffers
        self.turn = 0

    def upload(self, tile) -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        host = _as_tensor(tile)
        if host.device.type == "cuda":
            return host, None                  # already on the card
        i = self.turn
        self.turn = (i + 1) % len(self.buffers)
        if self.events[i] is not None:
            self.events[i].synchronize()       # its last copy has landed
        buf = self.buffers[i]
        if (buf is None or buf.dtype != host.dtype
                or buf.numel() < host.numel()):
            buf = torch.empty(host.numel(), dtype=host.dtype, pin_memory=True)
            self.buffers[i] = buf
        staged = buf[:host.numel()].view(host.shape)
        staged.copy_(host)
        with torch.cuda.stream(self.stream):
            out = torch.empty(host.shape, dtype=host.dtype, device=self.dev)
            out.copy_(staged, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.events[i] = ev
        return out, ev


_DONE = object()


def prefetch(tiles: Iterable, depth: int = 1, *, device=None,
             join_timeout: float = 5.0) -> Iterator[torch.Tensor]:
    """Async prefetch over a tile iterator: a daemon reader thread pulls
    tiles (host IO: memmap page-in, shard ``np.load``) and, on a CUDA
    ``device``, starts their copy to the card (see the module docstring),
    parking results in a queue of ``depth``.  At most ``depth`` queued tiles
    plus one in the reader's hands exist beyond the one being consumed.

    Reader exceptions are re-raised at the consumer's next pull.  Closing the
    generator early stops the reader, which is joined for up to
    ``join_timeout`` seconds; a reader still alive after that (hung inside
    the source) is reported by a RuntimeWarning.
    """
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    return _prefetch(tiles, depth, resolve_device(device), join_timeout)


def _prefetch(tiles: Iterable, depth: int, dev: torch.device,
              join_timeout: float) -> Iterator[torch.Tensor]:
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    up = _Uploader(dev, depth + 1) if dev.type == "cuda" else None

    def put_or_stop(item) -> bool:
        """Blocking put that gives up once the consumer has gone, so an
        abandoned stream never leaves the reader blocked on a full queue."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            for tile in tiles:
                item = up.upload(tile) if up else (_as_tensor(tile), None)
                if not put_or_stop(item):
                    return
            put_or_stop(_DONE)
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            put_or_stop(e)

    t = threading.Thread(target=reader, daemon=True,
                         name="repro-torch-stream-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            tile, ev = item
            if ev is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ev)
                tile.record_stream(consumer)
            yield tile
    finally:
        stop.set()
        t.join(timeout=join_timeout)
        if t.is_alive():
            warnings.warn(
                f"prefetch reader thread {t.name!r} did not exit within "
                f"{join_timeout}s of the consumer closing — it is likely "
                f"hung inside the tile source and may pin an in-flight tile "
                f"for the process lifetime", RuntimeWarning, stacklevel=2)


def source_tiles(src: TileSource, *, prefetch_depth: Optional[int] = 1,
                 device=None, start_row: int = 0) -> Iterator:
    """One pass over ``src``'s tiles, prefetched to ``device`` unless
    ``prefetch_depth is None`` (then the tiles come as the source yields
    them and the consumer moves each).  ``start_row`` resumes at a tile
    boundary (:meth:`TileSource.tiles_from`), through the same prefetch."""
    it = src.tiles_from(start_row) if start_row else src.tiles()
    if prefetch_depth is None:
        return iter(it)
    return prefetch(it, depth=prefetch_depth, device=device)


def offset_tiles(src: TileSource, *, prefetch_depth: Optional[int] = 1,
                 device=None, start_row: int = 0
                 ) -> Iterator[tuple[int, object]]:
    """One pass over ``src`` from row ``start_row`` as ``(row_offset,
    tile)`` pairs, the tiles as :func:`source_tiles` gives them; raises
    ``ValueError`` after the last tile if the tiles do not reach
    ``src.n_rows``.  The tile loop of every streamed driver (a port helper;
    the reference repeats the loop)."""
    off = int(start_row)
    for tile in source_tiles(src, prefetch_depth=prefetch_depth,
                             device=device, start_row=start_row):
        yield off, tile
        off += int(tile.shape[0])
    if off != src.n_rows:
        raise ValueError(f"tiles cover {off} rows of axis 0, expected "
                         f"{src.n_rows}")
