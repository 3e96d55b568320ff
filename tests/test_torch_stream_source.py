"""stream/source.py on the port alone: every source kind yields the same
row tiles (and the same sketch), replayability and its errors, the shard
order guard, ``as_tile_source``'s coercions (manifests and http URLs to the
object-store source, over a loopback server), and ``prefetch`` (order and
values, reader exceptions, early close) on the CPU, where the copy to the
card is skipped.  The pinned-buffer copy to the card is held in
``tests/test_torch_cuda.py``."""

import functools
import http.server
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import stream
from repro_torch.convert import key_from_seed
from repro_torch.stream import source as src_mod

torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

KEY = key_from_seed(3)
M, N, TILE = 100, 48, 32


@pytest.fixture(scope="module")
def matrix():
    return np.random.default_rng(0).standard_normal((M, N)).astype(np.float32)


@pytest.fixture
def disk(tmp_path, matrix):
    npy = tmp_path / "a.npy"
    np.save(npy, matrix)
    shards = tmp_path / "shards"
    shards.mkdir()
    for i, (lo, hi) in enumerate([(0, 30), (30, 64), (64, 100)]):
        np.save(shards / f"shard_{i:03d}.npy", matrix[lo:hi])
    return npy, shards


def _sources(matrix, disk):
    npy, shards = disk
    return {
        "array": stream.ArraySource(matrix, TILE),
        "tensor": stream.ArraySource(torch.from_numpy(matrix), TILE),
        "memmap": stream.MemmapSource(npy, TILE),
        "directory": stream.DirectorySource(shards, TILE),
        "factory": stream.GeneratorSource(
            lambda: (matrix[i:i + TILE] for i in range(0, M, TILE)), (M, N)),
    }


def _sketch(src, method):
    st = stream.init(KEY, N, 8, max_rows=M, method=method, device="cpu")
    for off, tile in stream.offset_tiles(src, device="cpu"):
        stream.update(st, tile, off)
    assert st.rows_seen == M
    return st.y


@pytest.mark.parametrize("kind", ["array", "tensor", "memmap", "directory", "factory"])
def test_every_source_kind_gives_the_matrix_and_its_sketch(matrix, disk, kind):
    src = _sources(matrix, disk)[kind]
    assert src.shape == (M, N) and src.n_rows == M and src.n_cols == N
    assert src.replayable
    for _ in range(2):                                  # replayable
        tiles = [torch.as_tensor(np.asarray(t)) for t in src.tiles()]
        np.testing.assert_array_equal(torch.cat(tiles).numpy(), matrix)
    want = _sketch(stream.ArraySource(matrix, M), "shgemm_fused")
    torch.testing.assert_close(_sketch(src, "shgemm_fused"), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["array", "tensor", "memmap", "directory", "factory",
                                  "objectstore"])
def test_tiles_from_yields_the_suffix(matrix, disk, kind):
    """The resume cursor: from every tile boundary, exactly the suffix of
    ``tiles()`` with its boundaries (the directory's stop at shard ends),
    also through ``offset_tiles``; a cursor inside a tile or out of range
    raises."""
    srcs = _sources(matrix, disk)
    srcs["objectstore"] = stream.ObjectStoreSource(disk[1], TILE)
    src = srcs[kind]
    full = [np.asarray(t) for t in src.tiles()]
    starts = np.cumsum([0] + [t.shape[0] for t in full])
    for k, start in enumerate(starts):
        suffix = [np.asarray(t) for t in src.tiles_from(int(start))]
        assert len(suffix) == len(full) - k, (kind, start)
        assert all(np.array_equal(a, b) for a, b in zip(full[k:], suffix))
    pairs = list(stream.offset_tiles(src, device="cpu", start_row=int(starts[2])))
    assert [off for off, _ in pairs] == list(starts[2:-1])
    inside = int(starts[1]) + 1
    with pytest.raises(ValueError, match="not a tile boundary"):
        list(src.tiles_from(inside))
    for bad in (-1, M + 1):
        with pytest.raises(ValueError, match="out of range"):
            list(src.tiles_from(bad))


def test_directory_tiles_stop_at_shard_boundaries(matrix, disk):
    heights = [t.shape[0] for t in stream.DirectorySource(disk[1], TILE).tiles()]
    assert heights == [30, 32, 2, 32, 4] and sum(heights) == M


def test_memmap_tiles_are_copies(matrix, disk):
    tile = next(stream.MemmapSource(disk[0], TILE).tiles())
    assert isinstance(tile, np.ndarray) and not isinstance(tile, np.memmap)
    assert tile.flags.owndata


def test_generator_source_is_single_pass_only(matrix):
    src = stream.GeneratorSource((matrix[i:i + TILE] for i in range(0, M, TILE)),
                                 (M, N))
    assert not src.replayable
    assert sum(t.shape[0] for t in src.tiles()) == M
    with pytest.raises(ValueError, match="already been consumed"):
        src.tiles()


def test_numeric_suffix_order_guard(tmp_path, matrix):
    stream.check_shard_name_order(["s_001.npy", "s_002.npy", "s_010.npy", "x.npy"])
    with pytest.raises(ValueError, match="permute"):
        stream.check_shard_name_order(["s_10.npy", "s_2.npy"])
    for i in (1, 2, 10):
        np.save(tmp_path / f"part{i}.npy", matrix[:4])
    with pytest.raises(ValueError, match="'part10.npy' sorts before 'part2.npy'"):
        stream.DirectorySource(tmp_path, TILE)


def test_as_tile_source_coercions(matrix, disk):
    npy, shards = disk
    assert isinstance(stream.as_tile_source(matrix), stream.ArraySource)
    assert isinstance(stream.as_tile_source(str(npy)), stream.MemmapSource)
    assert isinstance(stream.as_tile_source(shards), stream.DirectorySource)
    seq = stream.as_tile_source([matrix[:60], matrix[60:]])
    assert seq.shape == (M, N) and seq.replayable
    assert sum(t.shape[0] for t in seq.tiles()) == M == sum(
        t.shape[0] for t in seq.tiles())
    src = stream.ArraySource(matrix)
    assert stream.as_tile_source(src) is src
    with pytest.raises(ValueError, match="callable tile factory"):
        stream.as_tile_source(lambda: iter([matrix]))
    with pytest.raises(ValueError, match="bare tile iterator"):
        stream.as_tile_source(iter([matrix]))
    with pytest.raises(ValueError, match="empty tile sequence"):
        stream.as_tile_source([])
    with pytest.raises(TypeError, match="cannot build"):
        stream.as_tile_source(3.0)
    # a *.json path is an object-store manifest, an http URL an object store
    from repro_torch.data import pipeline
    layout = shards.parent / "layout"
    pipeline.write_matrix_shards(layout, matrix, 64)
    obj = stream.as_tile_source(layout / "manifest.json", tile_rows=TILE)
    assert isinstance(obj, stream.ObjectStoreSource) and obj.shape == (M, N)
    np.testing.assert_array_equal(np.concatenate(list(obj.tiles())), matrix)
    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(
            http.server.SimpleHTTPRequestHandler, directory=str(layout)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:   # a plain file server answers ranged GETs with 200: refused
        with pytest.raises(ValueError, match="ignored the Range header"):
            stream.as_tile_source(f"http://127.0.0.1:{srv.server_address[1]}")
    finally:
        srv.shutdown()
        srv.server_close()


def test_reiterable_container_stays_replayable(matrix):
    class Tiles:
        def __iter__(self):
            return (matrix[i:i + TILE] for i in range(0, M, TILE))
    with pytest.raises(ValueError, match="re-iterable"):
        stream.as_tile_source(Tiles())
    src = stream.as_tile_source(Tiles(), shape=(M, N))
    assert src.replayable
    assert sum(t.shape[0] for t in src.tiles()) == M == sum(
        t.shape[0] for t in src.tiles())


def test_source_validation(tmp_path, matrix):
    with pytest.raises(ValueError, match="ndim >= 2"):
        stream.ArraySource(matrix[0])
    with pytest.raises(ValueError, match="tile_rows"):
        stream.ArraySource(matrix, 0)
    np.save(tmp_path / "v.npy", matrix[0])
    with pytest.raises(ValueError, match="ndim >= 2"):
        stream.MemmapSource(tmp_path / "v.npy")
    with pytest.raises(ValueError, match="no \\*.npy shards"):
        stream.DirectorySource(tmp_path / "nowhere")
    bad = tmp_path / "bad"
    bad.mkdir()
    np.save(bad / "a0.npy", matrix[:4])
    np.save(bad / "a1.npy", matrix[:4, :5])
    with pytest.raises(ValueError, match="trailing shape"):
        stream.DirectorySource(bad)
    with pytest.raises(ValueError, match="ndim >= 2 shapes"):
        stream.GeneratorSource(lambda: iter([]), (4,))


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_preserves_order_and_values(matrix, depth):
    tiles = list(stream.prefetch(stream.ArraySource(matrix, TILE).tiles(),
                                 depth=depth, device="cpu"))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in tiles)
    np.testing.assert_array_equal(torch.cat(tiles).numpy(), matrix)
    with pytest.raises(ValueError, match="depth must be >= 1"):
        next(stream.prefetch(iter([]), depth=0, device="cpu"))


def test_prefetch_propagates_reader_exceptions(matrix):
    def bad():
        yield matrix[:TILE]
        raise OSError("disk went away")
    it = stream.prefetch(bad(), device="cpu")
    assert next(it).shape == (TILE, N)
    with pytest.raises(OSError, match="disk went away"):
        next(it)


def test_prefetch_early_close_stops_reader(matrix):
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield matrix[:TILE]
            i += 1
    before = {t.name for t in threading.enumerate()}
    it = stream.prefetch(endless(), depth=2, device="cpu")
    next(it)
    it.close()
    time.sleep(0.3)
    alive = [t for t in threading.enumerate()
             if t.name == "repro-torch-stream-prefetch" and t.name not in before]
    assert not alive
    assert len(pulled) <= 5        # the reader stopped: a bounded queue


def test_prefetch_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stream.prefetch(iter([]))


def test_source_tiles_without_prefetch_passes_tiles_through(matrix):
    tiles = list(stream.source_tiles(stream.ArraySource(matrix, TILE),
                                     prefetch_depth=None))
    assert all(isinstance(t, np.ndarray) for t in tiles)
    assert src_mod.DEFAULT_TILE_ROWS == 256


def test_offset_tiles_pairs_each_tile_with_its_row_offset(matrix):
    pairs = list(stream.offset_tiles(stream.ArraySource(matrix, TILE),
                                     device="cpu"))
    assert [off for off, _ in pairs] == [0, 32, 64, 96]
    for off, tile in pairs:
        np.testing.assert_array_equal(tile.numpy(), matrix[off:off + TILE])


def test_offset_tiles_refuses_tiles_that_miss_rows(matrix):
    short = stream.GeneratorSource(
        lambda: (matrix[i:i + TILE] for i in range(0, M, TILE)), (M + 1, N))
    with pytest.raises(ValueError, match=f"cover {M} rows of axis 0, "
                                         f"expected {M + 1}"):
        list(stream.offset_tiles(short, device="cpu"))


def test_prefetch_stress_keeps_order_under_frequent_switches():
    """Many small tiles through depth 1-3 with the interpreter switching
    threads every microsecond: every tile arrives once, in order."""
    import sys
    tiles = [np.full((2, 3), i, dtype=np.float32) for i in range(400)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for depth in (1, 2, 3):
            t0 = time.monotonic()
            got = [int(t[0, 0]) for t in stream.prefetch(iter(tiles), depth=depth,
                                                         device="cpu")]
            assert got == list(range(400))
            assert time.monotonic() - t0 < 30
    finally:
        sys.setswitchinterval(old)
