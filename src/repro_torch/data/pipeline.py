"""Token pipelines of the training slice and the out-of-core matrix
layouts of the tile sources (port of ``repro/data/pipeline.py``).

  * :class:`SyntheticLM`: a seeded zipfian token stream (no dataset is
    needed);
  * :class:`MemmapTokens`: windows of a flat int32 token file read through
    ``np.memmap`` (one file per host shard), written by
    :func:`write_token_file`;
  * :func:`write_matrix_npy`: one ``.npy`` file, the ``stream.MemmapSource``
    layout;
  * :func:`write_matrix_shards`: a directory of zero-padded axis-0 ``.npy``
    row shards plus its ``manifest.json`` (:func:`write_shard_manifest`),
    the ``stream.DirectorySource`` / ``stream.ObjectStoreSource`` layout.

Determinism: ``batch(step)`` is a pure function of (seed, step, host_id),
so a run restored at step N continues on the identical stream with no
iterator state to checkpoint, and its batches equal the reference's.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from repro_torch._atomic_io import atomic_write_json
from repro_torch.stream.source import check_shard_name_order

__all__ = ["SyntheticLM", "MemmapTokens", "write_token_file",
           "write_matrix_npy", "write_matrix_shards", "write_shard_manifest"]


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    zipf_a: float = 1.2

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch={self.global_batch} does not "
                             f"split over {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        # zipf over a capped support, shifted into [0, vocab)
        raw = rng.zipf(self.zipf_a, size=(self.host_batch, self.seq_len + 1))
        toks = (raw - 1) % self.vocab
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class MemmapTokens:
    path: str | Path
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self._n_windows = (len(self._data) - 1) // self.seq_len
        if self._n_windows < 1:
            raise ValueError(f"{self.path}: {len(self._data)} tokens hold no "
                             f"window of {self.seq_len} + 1")

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        idx = rng.integers(0, self._n_windows, size=self.host_batch)
        starts = idx * self.seq_len
        toks = np.stack([self._data[s:s + self.seq_len + 1] for s in starts])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def write_token_file(path: str | Path, tokens: np.ndarray) -> None:
    """Write a flat int32 token file (the ``MemmapTokens`` layout)."""
    np.asarray(tokens, np.int32).tofile(path)


def write_matrix_npy(path: str | Path, a, dtype=np.float32) -> Path:
    """Write a matrix or tensor as one ``.npy`` file (single-host out of
    core)."""
    path = Path(path)
    np.save(path, np.asarray(a, dtype))
    return path


def write_matrix_shards(dirpath: str | Path, a, rows_per_shard: int,
                        dtype=np.float32, manifest: bool = True) -> list[Path]:
    """Write a matrix or tensor as a directory of axis-0 ``.npy`` row shards
    (one blob a shard; sorted filename order is row order).  The last shard
    is ragged when ``rows_per_shard`` does not divide the row count.

    ``manifest=True`` also writes the directory's ``manifest.json``
    (:func:`write_shard_manifest`), so object-store readers skip the
    per-shard header reads."""
    if rows_per_shard < 1:
        raise ValueError(f"rows_per_shard must be >= 1, got {rows_per_shard}")
    dirpath = Path(dirpath)
    dirpath.mkdir(parents=True, exist_ok=True)
    # clear every earlier .npy file (DirectorySource globs *.npy, so a stale
    # shard of a shorter rewrite, a name of another width or a leftover
    # write_matrix_npy file would be read as rows) and any stale manifest,
    # which would pin the old layout
    for old in dirpath.glob("*.npy"):
        old.unlink()
    (dirpath / "manifest.json").unlink(missing_ok=True)
    a = np.asarray(a, dtype)
    n_shards = -(-a.shape[0] // rows_per_shard)
    # indices padded wide enough that lexicographic order (what the readers
    # sort by) is numeric order at any shard count
    width = max(5, len(str(max(n_shards - 1, 0))))
    paths = []
    for i, off in enumerate(range(0, a.shape[0], rows_per_shard)):
        p = dirpath / f"shard_{i:0{width}d}.npy"
        np.save(p, a[off:off + rows_per_shard])
        paths.append(p)
    if manifest:
        write_shard_manifest(dirpath)
    return paths


def _npy_layout(path: Path) -> tuple[tuple, bool, np.dtype, int]:
    """(shape, fortran_order, dtype, data_offset) from a local ``.npy``
    header, through numpy's public format API (no full load)."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        return shape, fortran, dtype, f.tell()


def write_shard_manifest(dirpath: str | Path,
                         pattern: str = "*.npy") -> Path:
    """Scan a shard directory and write its ``manifest.json``: each shard's
    rows, dtype and byte ``data_offset`` in row order, the object-store
    layout (``stream.ObjectStoreSource`` reads it in place of one header
    request a shard)."""
    dirpath = Path(dirpath)
    files = sorted(dirpath.glob(pattern))
    if not files:
        raise ValueError(f"no {pattern} shards in {dirpath}")
    # the manifest fixes the row order: one written from permuted unpadded
    # names would carry the permutation past every reader's guard
    check_shard_name_order([f.name for f in files])
    shards, rows, trailing = [], 0, None
    for f in files:
        shape, fortran, dtype, off = _npy_layout(f)
        if fortran:
            raise ValueError(f"{f}: fortran_order shards cannot be "
                             f"range-read by row tiles; rewrite in C order")
        if len(shape) < 2:
            raise ValueError(f"{f}: tile sources need ndim >= 2 arrays, "
                             f"got shape {shape}")
        if trailing is None:
            trailing = shape[1:]
        elif shape[1:] != trailing:
            raise ValueError(f"shard {f.name} has trailing shape "
                             f"{shape[1:]}, expected {trailing}")
        shards.append({"name": f.name, "rows": int(shape[0]),
                       "trailing": [int(s) for s in shape[1:]],
                       "dtype": dtype.str, "data_offset": int(off),
                       "nbytes": f.stat().st_size})
        rows += int(shape[0])
    doc = {"format": "repro-shard-manifest", "version": 1,
           "shape": [rows, *[int(s) for s in trailing]], "shards": shards}
    return atomic_write_json(dirpath / "manifest.json", doc)
