"""Object-store tile source: byte-range reads over ``.npy`` shards (port of
``repro/stream/objectstore.py``).

S3/GCS-style object stores serve immutable blobs through ranged GETs: no
mmap, no listing, and a real latency a request, so reading a whole shard for
one tile is the wrong default.  :class:`ObjectStoreSource` keeps the
``DirectorySource`` contract (same shard layout, same row order, the same
tiles bit for bit) over a pluggable range fetcher:

  * :class:`FileRangeFetcher`: seek + read over local files, the reference
    backend (header parse, tile slicing and manifest resolution against the
    bits ``DirectorySource`` maps, with no network in the loop);
  * :class:`HttpRangeFetcher`: stdlib ``urllib`` with ``Range:`` headers, one
    ranged GET a tile; a server that ignores ``Range`` (status 200) fails
    loudly instead of sending whole objects.

Shard geometry comes from the ``.npy`` headers (two small ranged reads a
shard, never the data) or from a ``manifest.json``
(``data.pipeline.write_shard_manifest``: rows, dtype and byte
``data_offset`` a shard, no header reads).  Tiles never cross shard
boundaries; each ``tiles()`` call is an independent replay and
``tiles_from`` seeks to a resume cursor.  The bytes of a range read land in
a numpy array, which ``stream.prefetch`` stages into its pinned buffers and
copies to the card like any other tile.

Transient errors (timeouts, connection resets, HTTP 408/429/5xx, short
reads) are retried under a :class:`RetryPolicy` (bounded attempts,
exponential backoff with jitter) and end in a ``RuntimeError`` naming the URL
and the attempt count; errors a retry cannot fix (404 and other 4xx, a 200
in place of 206, bad magic, dtype or Fortran order) raise on the first
occurrence.
"""

from __future__ import annotations

import ast
import json
import math
import posixpath
import random
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np

from repro_torch.stream.source import (DEFAULT_TILE_ROWS, TileSource,
                                       _not_a_boundary,
                                       check_shard_name_order)

__all__ = [
    "ObjectStoreSource", "FileRangeFetcher", "HttpRangeFetcher",
    "read_npy_header", "MANIFEST_NAME",
    "RetryPolicy", "ShortReadError", "call_with_retry",
    "is_transient_fetch_error",
]

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = "repro-shard-manifest"


class ShortReadError(ValueError):
    """A range read returned fewer bytes than requested.

    Subclasses ValueError for backward compatibility with callers that
    caught the old generic error, but is classified TRANSIENT: truncated
    bodies are what a dropped connection looks like, and a retry re-reads
    the full range."""


#: HTTP statuses a retry can plausibly fix: request timeout, throttling,
#: and server-side errors.  4xx other than 408/429 means the request
#: itself is wrong and will stay wrong.
TRANSIENT_HTTP_STATUSES = frozenset({408, 429, 500, 502, 503, 504})


def is_transient_fetch_error(err: BaseException) -> bool:
    """Classify a fetch error: True → worth retrying, False → fail now."""
    if isinstance(err, urllib.error.HTTPError):
        return err.code in TRANSIENT_HTTP_STATUSES
    if isinstance(err, (TimeoutError, ConnectionError, ShortReadError)):
        # socket.timeout is TimeoutError since 3.10
        return True
    if isinstance(err, urllib.error.URLError):
        # connection-level failure (DNS, refused, TLS hiccup); HTTPError
        # is a subclass but was already classified by status above.
        return True
    return False


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with jitter for transient fetch errors.

    Attempt ``k`` (0-based) sleeps ``min(base_delay * 2**k, max_delay)``
    scaled by a uniform jitter in ``[1, 1 + jitter]`` — the jitter
    decorrelates a fleet of workers hammering a throttled store.  After
    ``max_attempts`` total attempts the caller raises a RuntimeError
    naming the URL and the attempt count (see :func:`call_with_retry`).
    """

    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 5.0
    jitter: float = 0.5
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def delay(self, attempt: int) -> float:
        d = min(self.base_delay * (2.0 ** attempt), self.max_delay)
        return d * (1.0 + self.jitter * random.random())


def call_with_retry(fn: Callable[[], "bytes | int"], *, url: str, what: str,
                    policy: Optional[RetryPolicy]):
    """Run ``fn`` under ``policy``: transient errors retry with backoff,
    permanent errors propagate untouched on the first occurrence, and an
    exhausted budget raises a loud RuntimeError naming the URL and the
    attempt count (chained to the last transient error)."""
    if policy is None:
        return fn()
    last: Optional[BaseException] = None
    for attempt in range(max(1, policy.max_attempts)):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            if not is_transient_fetch_error(e):
                raise
            last = e
            if attempt + 1 >= max(1, policy.max_attempts):
                break
            policy.sleep(policy.delay(attempt))
    raise RuntimeError(
        f"{url}: {what} still failing after {max(1, policy.max_attempts)} "
        f"attempts (transient-retry budget exhausted); last error: "
        f"{last!r}") from last


class FileRangeFetcher:
    """Byte-range reads over local files (seek+read) — the reference
    backend for the object-store contract."""

    def size(self, url: str) -> int:
        return Path(url).stat().st_size

    def read(self, url: str, start: int, length: int) -> bytes:
        with open(url, "rb") as f:
            f.seek(start)
            data = f.read(length)
        if len(data) != length:
            raise ShortReadError(f"{url}: short range read — wanted "
                                 f"[{start}, {start + length}) but the file "
                                 f"holds only {start + len(data)} bytes")
        return data


class HttpRangeFetcher:
    """HTTP ``Range:`` reads via stdlib urllib (S3/GCS-style ranged GETs).

    A server that answers a ranged GET with 200 (full body) instead of 206
    does not support ranges; that raises instead of silently downloading
    whole objects and pretending to be out-of-core.

    Every request — ``size()``'s HEAD as much as ``read()``'s ranged GET —
    goes through :meth:`_open`, which applies ``self.timeout`` as
    urllib's connect/read timeout (routing both paths through one helper
    makes that invariant structural rather than per-call-site).  ``retry``
    configures the transient-error policy (attempts / base delay /
    jitter); pass ``retry=None`` to disable retries entirely."""

    def __init__(self, timeout: float = 30.0,
                 retry: Optional[RetryPolicy] = RetryPolicy()):
        self.timeout = float(timeout)
        self.retry = retry

    def _open(self, req: urllib.request.Request):
        return urllib.request.urlopen(req, timeout=self.timeout)

    def size(self, url: str) -> int:
        def attempt() -> int:
            req = urllib.request.Request(url, method="HEAD")
            with self._open(req) as r:
                length = r.headers.get("Content-Length")
            if length is None:
                raise ValueError(f"{url}: HEAD returned no Content-Length "
                                 f"— cannot size the object")
            return int(length)
        return call_with_retry(attempt, url=url, what="HEAD size",
                               policy=self.retry)

    def read(self, url: str, start: int, length: int) -> bytes:
        def attempt() -> bytes:
            req = urllib.request.Request(
                url,
                headers={"Range": f"bytes={start}-{start + length - 1}"})
            with self._open(req) as r:
                status = getattr(r, "status", 206)
                if status != 206:
                    raise ValueError(
                        f"{url}: server ignored the Range header (status "
                        f"{status}) — refusing to download whole objects "
                        f"for tile reads; serve the shards from a "
                        f"range-capable store or use DirectorySource on a "
                        f"local copy")
                data = r.read()
            if len(data) != length:
                raise ShortReadError(
                    f"{url}: short range read — wanted {length} bytes at "
                    f"offset {start}, got {len(data)}")
            return data
        return call_with_retry(
            attempt, url=url,
            what=f"range read [{start}, {start + length})",
            policy=self.retry)


class _RetryingFetcher:
    """Wrap any RangeFetcher with a RetryPolicy + a post-read length check
    (a backend returning short data without raising becomes a transient
    ShortReadError and is retried)."""

    def __init__(self, inner, policy: RetryPolicy):
        self.inner = inner
        self.policy = policy

    def size(self, url: str) -> int:
        return call_with_retry(lambda: self.inner.size(url), url=url,
                               what="size", policy=self.policy)

    def read(self, url: str, start: int, length: int) -> bytes:
        def attempt() -> bytes:
            data = self.inner.read(url, start, length)
            if len(data) != length:
                raise ShortReadError(
                    f"{url}: fetcher returned {len(data)} bytes for a "
                    f"{length}-byte range at offset {start}")
            return data
        return call_with_retry(
            attempt, url=url,
            what=f"range read [{start}, {start + length})",
            policy=self.policy)


def read_npy_header(fetcher, url: str) -> tuple[tuple, np.dtype, int]:
    """``(shape, dtype, data_offset)`` from ranged reads of the header
    alone — two small GETs, never the array data.

    Parses the ``.npy`` format directly (magic, version, header length,
    then the literal header dict): v1/v2/v3 layouts, C order only —
    Fortran-order shards are rejected because their row tiles are not
    contiguous byte ranges."""
    pre = fetcher.read(url, 0, 12)
    if pre[:6] != b"\x93NUMPY":
        raise ValueError(f"{url}: not an .npy object (bad magic "
                         f"{pre[:6]!r})")
    major = pre[6]
    if major == 1:
        hlen, hstart = int.from_bytes(pre[8:10], "little"), 10
    elif major in (2, 3):
        hlen, hstart = int.from_bytes(pre[8:12], "little"), 12
    else:
        raise ValueError(f"{url}: unsupported .npy major version {major}")
    data_offset = hstart + hlen
    txt = pre[hstart:]
    if data_offset > 12:
        txt += fetcher.read(url, 12, data_offset - 12)
    try:
        hdr = ast.literal_eval(txt[:hlen].decode("latin1"))
        shape = tuple(int(s) for s in hdr["shape"])
        fortran = bool(hdr["fortran_order"])
        dtype = np.dtype(hdr["descr"])
    except (ValueError, KeyError, SyntaxError, TypeError) as e:
        raise ValueError(f"{url}: malformed .npy header") from e
    if fortran:
        raise ValueError(
            f"{url}: fortran_order .npy shards are column-major — row "
            f"tiles are not contiguous byte ranges; rewrite in C order")
    return shape, dtype, data_offset


class _Shard(NamedTuple):
    url: str
    rows: int
    trailing: tuple
    dtype: np.dtype
    data_offset: int


def _is_http(s: str) -> bool:
    return s.startswith(("http://", "https://"))


class ObjectStoreSource(TileSource):
    """Row shards behind byte-range reads (see module docstring).

    ``location`` may be:

      * a local shard **directory** — uses its ``manifest.json`` when
        present (zero header reads), else globs ``pattern`` in sorted
        filename order (same numeric-suffix permutation guard as
        ``DirectorySource``) and range-parses each header;
      * a path or http(s) URL to a ``*.json`` manifest — shard byte
        layout comes from the manifest (its entry order IS row order);
        shard URLs resolve relative to the manifest;
      * an http(s) **prefix** URL (no ``.npy``/``.json`` suffix) — the
        manifest is fetched from ``<prefix>/manifest.json`` (object
        stores cannot be globbed);
      * a single ``.npy`` path/URL;
      * an explicit ordered sequence of ``.npy`` paths/URLs (caller owns
        the row order — no name-order guessing).

    ``fetcher`` overrides backend selection; by default http(s) URLs use
    :class:`HttpRangeFetcher` (which retries transient errors with its own
    default :class:`RetryPolicy`) and everything else
    :class:`FileRangeFetcher`.  ``retry`` adds a source-level
    :class:`RetryPolicy` around whatever fetcher is in play — every size
    and range read (manifest, headers, tiles) retried uniformly, plus a
    post-read length check; when set, the internally constructed
    HttpRangeFetcher is created with ``retry=None`` so budgets don't
    nest multiplicatively.
    """

    def __init__(self, location, tile_rows: int = DEFAULT_TILE_ROWS, *,
                 fetcher=None, pattern: str = "*.npy",
                 retry: Optional[RetryPolicy] = None):
        if tile_rows < 1:
            raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
        self.tile_rows = int(tile_rows)
        self._fetcher = fetcher
        self.retry = retry
        self.shards = self._resolve(location, pattern)
        if not self.shards:
            raise ValueError(f"no shards behind {location!r} (empty list "
                             f"or manifest) — a tile source needs at "
                             f"least one .npy object")
        rows, trailing = 0, None
        for sh in self.shards:
            if len(sh.trailing) < 1:
                raise ValueError(f"{sh.url}: tile sources need ndim >= 2 "
                                 f"arrays, got shape {(sh.rows,)}")
            if trailing is None:
                trailing = sh.trailing
            elif sh.trailing != trailing:
                raise ValueError(
                    f"shard {sh.url} has trailing shape {sh.trailing}, "
                    f"expected {trailing} (all shards must agree)")
            rows += sh.rows
        self.shape = (rows,) + tuple(int(s) for s in trailing)

    # -- resolution -------------------------------------------------------

    def _fetcher_for(self, url: str):
        f = self._fetcher
        if f is None:
            # with a source-level retry, disable the http fetcher's own
            # policy — nested budgets would retry max_attempts**2 times
            f = (HttpRangeFetcher(retry=None if self.retry else RetryPolicy())
                 if _is_http(url) else FileRangeFetcher())
        if self.retry is not None:
            f = _RetryingFetcher(f, self.retry)
        return f

    def _shard_from_header(self, url: str) -> _Shard:
        shape, dtype, off = read_npy_header(self._fetcher_for(url), url)
        return _Shard(url=url, rows=int(shape[0]),
                      trailing=tuple(int(s) for s in shape[1:]),
                      dtype=dtype, data_offset=int(off))

    def _resolve(self, location, pattern: str) -> list[_Shard]:
        if isinstance(location, (list, tuple)):
            return [self._shard_from_header(str(u)) for u in location]
        if not isinstance(location, (str, Path)):
            raise TypeError(f"cannot build an ObjectStoreSource from "
                            f"{type(location).__name__}")
        s = str(location)
        if _is_http(s):
            if s.endswith(".npy"):
                return [self._shard_from_header(s)]
            if not s.endswith(".json"):   # prefix URL: stores can't be
                s = s.rstrip("/") + "/" + MANIFEST_NAME  # globbed
            return self._load_manifest(s)
        p = Path(s)
        if p.is_dir():
            mpath = p / MANIFEST_NAME
            if mpath.is_file():
                return self._load_manifest(str(mpath))
            files = sorted(p.glob(pattern))
            if not files:
                raise ValueError(f"no {pattern} shards in {p}")
            check_shard_name_order([f.name for f in files])
            return [self._shard_from_header(str(f)) for f in files]
        if p.name.endswith(".json"):
            return self._load_manifest(str(p))
        return [self._shard_from_header(str(p))]

    def _load_manifest(self, url: str) -> list[_Shard]:
        fetcher = self._fetcher_for(url)
        raw = fetcher.read(url, 0, fetcher.size(url))
        try:
            doc = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(f"{url}: manifest is not valid JSON") from e
        if doc.get("format") != MANIFEST_FORMAT:
            raise ValueError(
                f"{url}: not a {MANIFEST_FORMAT} manifest (format="
                f"{doc.get('format')!r}); write one with "
                f"data.pipeline.write_shard_manifest")
        if _is_http(url):
            base = url.rsplit("/", 1)[0]
            join = lambda name: base + "/" + urllib.parse.quote(name)  # noqa: E731
        else:
            base = Path(url).parent
            join = lambda name: str(base / name)  # noqa: E731
        shards = []
        for e in doc["shards"]:
            name = posixpath.basename(e["name"])  # no path traversal
            shards.append(_Shard(
                url=join(name), rows=int(e["rows"]),
                trailing=tuple(int(s) for s in e["trailing"]),
                dtype=np.dtype(e["dtype"]),
                data_offset=int(e["data_offset"])))
        return shards

    # -- tiles ------------------------------------------------------------

    def tiles(self) -> Iterator:
        return self.tiles_from(0)

    def tiles_from(self, start_row: int) -> Iterator:
        start = self._check_start(start_row)

        def gen():
            pos = 0
            for sh in self.shards:
                if pos + sh.rows <= start:
                    pos += sh.rows  # whole shard before the cursor: 0 GETs
                    continue
                local = max(start - pos, 0)
                if local % self.tile_rows:
                    raise ValueError(_not_a_boundary(
                        start, pos + local - local % self.tile_rows,
                        self.tile_rows))
                fetcher = self._fetcher_for(sh.url)
                row_bytes = sh.dtype.itemsize * math.prod(sh.trailing)
                for off in range(local, sh.rows, self.tile_rows):
                    nrows = min(self.tile_rows, sh.rows - off)
                    raw = fetcher.read(sh.url,
                                       sh.data_offset + off * row_bytes,
                                       nrows * row_bytes)
                    # bytearray: writable, zero extra copy beyond the one
                    # read buffer (frombuffer on bytes is read-only)
                    arr = np.frombuffer(bytearray(raw), dtype=sh.dtype)
                    yield arr.reshape((nrows,) + sh.trailing)
                pos += sh.rows
        return gen()
