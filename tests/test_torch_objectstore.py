"""stream/objectstore.py and data/pipeline.py's shard writers against the
reference, on the same numpy inputs: the same shard layout and manifest, the
same ``.npy`` headers parsed from range reads, the same tiles (bit for bit)
through local range reads and over a loopback HTTP server, the same
transient-error classification, and the loud failures (Fortran order, empty
shard sets, permuted shard names, a server that ignores ``Range``).  The
object-store tiles are held bit for bit against the reference's and against
``DirectorySource``; ``rsvd_streamed`` over them bit for bit against the
directory path."""

import functools
import http.server
import json
import os
import threading
import urllib.error

import numpy as np
import pytest
import torch

from repro import stream as rstream
from repro.data import pipeline as ref_pipeline
from repro.stream import objectstore as ref_os
from repro_torch import stream
from repro_torch.convert import key_from_seed
from repro_torch.core import rsvd
from repro_torch.data import pipeline
from repro_torch.stream import objectstore as osmod
from repro_torch.stream import resilience as resil

torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

KEY = key_from_seed(42)
M, N, RANK = 96, 112, 8
TILE = 28      # does not divide 96: a ragged last tile of 12 rows
SHARD = 56     # a multiple of TILE, so the directory tiling is the flat one
NOSLEEP = osmod.RetryPolicy(max_attempts=3, sleep=lambda s: None)


@pytest.fixture(scope="module")
def matrix():
    return np.random.default_rng(2).standard_normal((M, N)).astype(np.float32)


@pytest.fixture(scope="module")
def disk(tmp_path_factory, matrix):
    td = tmp_path_factory.mktemp("tiles")
    npy = pipeline.write_matrix_npy(td / "a.npy", matrix)
    shards = td / "shards"
    paths = pipeline.write_matrix_shards(shards, matrix, SHARD)
    assert [p.name for p in paths] == ["shard_00000.npy", "shard_00001.npy"]
    return {"npy": npy, "dir": shards}


def _tiles(src):
    return [np.asarray(t) for t in src.tiles()]


def _same_tiles(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Layout: the port's writers against the reference's
# ---------------------------------------------------------------------------

def test_shard_layout_and_manifest_match_reference(tmp_path, matrix):
    """Same names, same bytes, same manifest; a shorter rewrite removes the
    stale shards and manifest of the longer one."""
    for side, writer in (("port", pipeline), ("ref", ref_pipeline)):
        writer.write_matrix_shards(tmp_path / side, matrix, 20)
        writer.write_matrix_shards(tmp_path / side, matrix[:40], 32)
    names = [sorted(p.name for p in (tmp_path / s).iterdir())
             for s in ("port", "ref")]
    assert names[0] == names[1] == ["manifest.json", "shard_00000.npy",
                                    "shard_00001.npy"]
    for name in names[0]:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name
    doc = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert doc["shape"] == [40, N] and [s["rows"] for s in doc["shards"]] == [32, 8]


def test_shard_names_are_zero_padded(tmp_path):
    """Zero-padded indices: lexicographic order is row order."""
    a = np.arange(12, dtype=np.float32).reshape(12, 1)
    paths = pipeline.write_matrix_shards(tmp_path, a, 1, manifest=False)
    assert [p.name for p in paths][:2] == ["shard_00000.npy", "shard_00001.npy"]
    with pytest.raises(ValueError, match="rows_per_shard"):
        pipeline.write_matrix_shards(tmp_path, a, 0)


@pytest.mark.parametrize("shape,dtype,version", [
    ((96, 112), np.float32, (1, 0)), ((7, 3, 5), np.float64, (1, 0)),
    ((4, 2), np.int16, (2, 0)), ((1, 1), np.float16, None)])
def test_read_npy_header_matches_reference(tmp_path, shape, dtype, version):
    path = tmp_path / "x.npy"
    with open(path, "wb") as f:
        np.lib.format.write_array(f, np.zeros(shape, dtype), version=version)
    got = osmod.read_npy_header(osmod.FileRangeFetcher(), str(path))
    want = ref_os.read_npy_header(ref_os.FileRangeFetcher(), str(path))
    assert got == want and got[0] == shape and got[1] == np.dtype(dtype)


def test_read_npy_header_refuses_bad_objects(tmp_path, matrix):
    np.save(tmp_path / "f.npy", np.asfortranarray(matrix[:16]))
    (tmp_path / "bad.npy").write_bytes(b"not an npy object at all")
    fetch = osmod.FileRangeFetcher()
    with pytest.raises(ValueError, match="fortran"):
        osmod.read_npy_header(fetch, str(tmp_path / "f.npy"))
    with pytest.raises(ValueError, match="bad magic"):
        osmod.read_npy_header(fetch, str(tmp_path / "bad.npy"))
    with pytest.raises(osmod.ShortReadError):
        fetch.read(str(tmp_path / "bad.npy"), 0, 1000)


# ---------------------------------------------------------------------------
# Tiles: bit for bit against the reference and the directory source
# ---------------------------------------------------------------------------

def test_objectstore_tiles_match_reference(disk, matrix):
    got = _tiles(stream.ObjectStoreSource(disk["dir"], TILE))
    want = _tiles(rstream.ObjectStoreSource(disk["dir"], tile_rows=TILE))
    assert _same_tiles(got, want)
    assert _same_tiles(got, _tiles(stream.DirectorySource(disk["dir"], TILE)))
    assert [t.shape[0] for t in got] == [28, 28, 28, 12]   # shards of 56 and 40
    np.testing.assert_array_equal(np.concatenate(got), matrix)


def test_objectstore_without_manifest_parses_headers(disk, matrix, tmp_path):
    """Without a manifest: two ranged header reads a shard, the same tiles as
    the manifest path, a single ``.npy`` object and an explicit url list."""
    pipeline.write_matrix_shards(tmp_path, matrix, SHARD, manifest=False)
    assert not (tmp_path / "manifest.json").exists()
    src = stream.ObjectStoreSource(tmp_path, TILE)
    assert src.shape == (M, N) and src.replayable
    ref = _tiles(stream.ObjectStoreSource(disk["dir"], TILE))
    assert _same_tiles(_tiles(src), ref)
    files = sorted(str(p) for p in tmp_path.glob("*.npy"))
    assert _same_tiles(_tiles(stream.ObjectStoreSource(files, TILE)), ref)
    one = _tiles(stream.ObjectStoreSource(str(disk["npy"]), TILE))
    np.testing.assert_array_equal(np.concatenate(one), matrix)


def test_objectstore_coercions_and_rsvd_bitwise(disk):
    src = stream.as_tile_source(disk["dir"] / "manifest.json", tile_rows=TILE)
    assert isinstance(src, stream.ObjectStoreSource)
    res = rsvd.rsvd_streamed(KEY, src, RANK, device="cpu")
    want = rsvd.rsvd_streamed(KEY, stream.DirectorySource(disk["dir"], TILE),
                              RANK, device="cpu")
    for field, got, ref in zip(res._fields, res, want):
        assert torch.equal(got, ref), field


def test_objectstore_tiles_from_seeks_whole_shards(disk, matrix):
    """A cursor past a shard reads none of it: fewer range reads than a
    fresh pass, the same suffix."""
    counting = resil.FlakyRangeFetcher(osmod.FileRangeFetcher())
    src = stream.ObjectStoreSource(disk["dir"], TILE, fetcher=counting)
    before = counting.reads
    full = _tiles(src)
    per_pass = counting.reads - before
    before = counting.reads
    suffix = [np.asarray(t) for t in src.tiles_from(SHARD)]
    assert counting.reads - before == per_pass - SHARD // TILE
    assert _same_tiles(suffix, full[SHARD // TILE:])
    with pytest.raises(ValueError, match="not a tile boundary"):
        list(src.tiles_from(TILE // 2))
    with pytest.raises(ValueError, match="out of range"):
        list(src.tiles_from(M + 1))


def test_numeric_suffix_order_guard(tmp_path, matrix):
    np.save(tmp_path / "shard_2.npy", matrix[:16])
    np.save(tmp_path / "shard_10.npy", matrix[16:32])
    with pytest.raises(ValueError, match=r"shard_10.*shard_2"):
        stream.ObjectStoreSource(tmp_path, TILE)
    with pytest.raises(ValueError, match=r"shard_10.*shard_2"):
        pipeline.write_shard_manifest(tmp_path)


def test_objectstore_empty_shard_sets_raise(tmp_path):
    with pytest.raises(ValueError, match="at least one"):
        stream.ObjectStoreSource([], TILE)
    (tmp_path / "manifest.json").write_text(
        '{"format": "repro-shard-manifest", "version": 1, "shards": []}')
    with pytest.raises(ValueError, match="at least one"):
        stream.ObjectStoreSource(tmp_path, TILE)
    (tmp_path / "other.json").write_text('{"format": "something-else"}')
    with pytest.raises(ValueError, match="not a repro-shard-manifest"):
        stream.ObjectStoreSource(tmp_path / "other.json", TILE)
    with pytest.raises(ValueError, match="no \\*.npy shards"):
        pipeline.write_shard_manifest(tmp_path)


def test_objectstore_rejects_fortran_order(tmp_path, matrix):
    np.save(tmp_path / "shard_0.npy", np.asfortranarray(matrix[:16]))
    with pytest.raises(ValueError, match="fortran"):
        stream.ObjectStoreSource(tmp_path, TILE)
    with pytest.raises(ValueError, match="fortran"):
        pipeline.write_shard_manifest(tmp_path)


# ---------------------------------------------------------------------------
# Retries: transient errors retried, permanent ones raised at once
# ---------------------------------------------------------------------------

def test_transient_classification_matches_reference():
    errors = [TimeoutError(), ConnectionError(), ConnectionResetError(),
              osmod.ShortReadError("short"), ValueError("bad magic"),
              KeyError("x"), urllib.error.URLError("refused")]
    errors += [urllib.error.HTTPError("u", code, "x", None, None)
               for code in (404, 403, 408, 429, 500, 502, 503, 504)]
    for err in errors:
        theirs = (ref_os.ShortReadError("short")
                  if isinstance(err, osmod.ShortReadError) else err)
        assert (osmod.is_transient_fetch_error(err)
                == ref_os.is_transient_fetch_error(theirs)), err


def test_permanent_error_not_retried():
    calls = []

    def fn():
        calls.append(1)
        raise urllib.error.HTTPError("u", 404, "not found", None, None)
    with pytest.raises(urllib.error.HTTPError):
        osmod.call_with_retry(fn, url="u", what="read", policy=NOSLEEP)
    assert len(calls) == 1


@pytest.mark.parametrize("kind", ["timeout", "http503", "truncate"])
def test_flaky_fetcher_retry_then_succeed(disk, matrix, kind):
    flaky = resil.FlakyRangeFetcher(osmod.FileRangeFetcher(), kind=kind)
    src = stream.ObjectStoreSource(disk["dir"], TILE, fetcher=flaky,
                                   retry=NOSLEEP)
    flaky.fail_next(2, kind)           # attempts 0 and 1 fail, 2 succeeds
    np.testing.assert_array_equal(np.concatenate(_tiles(src)), matrix)
    assert flaky.injected == 2


def test_flaky_fetcher_retry_exhausted_raises(disk):
    flaky = resil.FlakyRangeFetcher(osmod.FileRangeFetcher())
    src = stream.ObjectStoreSource(disk["dir"], TILE, fetcher=flaky,
                                   retry=NOSLEEP)
    flaky.fail_next(NOSLEEP.max_attempts)
    with pytest.raises(RuntimeError, match="3 attempts"):
        _tiles(src)


def test_rate_faults_retried_once_each(disk, matrix):
    """i.i.d. faults a read: every injected fault costs one retry (the
    count the card's phase 10 holds), and the tiles stay bit for bit."""
    retries = []
    flaky = resil.FlakyRangeFetcher(osmod.FileRangeFetcher(), rate=0.2, seed=5)
    policy = osmod.RetryPolicy(max_attempts=6, sleep=retries.append)
    src = stream.ObjectStoreSource(disk["dir"] / "manifest.json", TILE,
                                   fetcher=flaky, retry=policy)
    for _ in range(3):
        np.testing.assert_array_equal(np.concatenate(_tiles(src)), matrix)
    assert flaky.injected > 0 and len(retries) == flaky.injected


# ---------------------------------------------------------------------------
# HTTP Range backend over a loopback server
# ---------------------------------------------------------------------------

class _RangeHandler(http.server.SimpleHTTPRequestHandler):
    """A minimal object store: ranged GETs (206) and HEAD sizes."""

    def log_message(self, *args):
        pass

    def do_GET(self):
        path = self.translate_path(self.path)
        if not os.path.isfile(path):
            self.send_error(404)
            return
        with open(path, "rb") as f:
            data = f.read()
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            lo, hi = (int(x) for x in rng[6:].split("-"))
            body = data[lo:hi + 1]
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {lo}-{hi}/{len(data)}")
        else:
            body = data
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_HEAD(self):
        path = self.translate_path(self.path)
        if not os.path.isfile(path):
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(os.path.getsize(path)))
        self.end_headers()


class _NoRangeHandler(_RangeHandler):
    """A server that ignores Range headers (plain 200 full-body GETs)."""

    def do_GET(self):
        if "Range" in self.headers:
            del self.headers["Range"]
        super().do_GET()


def _serve(handler, directory):
    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(handler, directory=str(directory)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_http_range_backend_conformance(disk, matrix):
    """Prefix URL (resolves manifest.json), manifest URL, another *.json
    name: the tiles of the local paths bit for bit, and rsvd_streamed over
    HTTP equals the directory path's."""
    (disk["dir"] / "alt.json").write_bytes(
        (disk["dir"] / "manifest.json").read_bytes())
    srv, url = _serve(_RangeHandler, disk["dir"])
    try:
        want = _tiles(stream.DirectorySource(disk["dir"], TILE))
        for loc in (url, url + "/manifest.json", url + "/alt.json",
                    url + "/shard_00000.npy"):
            src = stream.as_tile_source(loc, tile_rows=TILE)
            assert isinstance(src, stream.ObjectStoreSource)
            got = _tiles(src)
            assert _same_tiles(got, want[:len(got)]), loc
        res = rsvd.rsvd_streamed(KEY, stream.ObjectStoreSource(url, TILE), RANK,
                                 device="cpu")
        ref = rsvd.rsvd_streamed(KEY, stream.DirectorySource(disk["dir"], TILE),
                                 RANK, device="cpu")
        for field, got, ref_ in zip(res._fields, res, ref):
            assert torch.equal(got, ref_), field
        with pytest.raises(urllib.error.HTTPError):     # 404: not retried
            stream.ObjectStoreSource(url + "/missing.npy", TILE)
    finally:
        srv.shutdown()
        srv.server_close()
        (disk["dir"] / "alt.json").unlink()


def test_http_server_ignoring_range_fails_loudly(disk):
    srv, url = _serve(_NoRangeHandler, disk["dir"])
    try:
        with pytest.raises(ValueError, match="ignored the Range header"):
            stream.ObjectStoreSource(url + "/shard_00000.npy", TILE)
    finally:
        srv.shutdown()
        srv.server_close()
