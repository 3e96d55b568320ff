"""Fault-tolerant, resumable sketch jobs (port of
``repro/stream/resilience.py``).

A sketch is linear in A and row tiles write disjoint rows of Y, so a
``SketchState`` is a small, exact checkpoint of all a streamed driver has
learned, and any lost tile range replays bit for bit from the Omega counter
lattice.  This module turns that into machinery:

  * :class:`SketchJobCheckpointer`: atomic, asynchronous checkpoints of the
    streamed drivers (``rsvd_streamed``, ``rp_sthosvd_streamed``).  A
    checkpoint is the sketch state (and any pass partial) plus a cursor: the
    count of tiles absorbed and the global row of the next tile, always a
    tile boundary, so ``TileSource.tiles_from(cursor)`` replays the exact
    suffix and the resumed run equals an uninterrupted one bit for bit.
  * Fault injection: :class:`FaultySource` (raise, hang or SIGKILL the
    process at a chosen tile) and :class:`FlakyRangeFetcher` (timeouts,
    HTTP 503, truncated reads), both deterministic.
  * Elastic re-mesh: :func:`elastic_distributed_rsvd_streamed` (a
    single-controller simulation): the survivors split a dead host's row
    range at tile boundaries (:func:`partition_rows`) and replay only it
    (:func:`sketch_row_range`); disjoint-row merges are exact, so the
    factors equal the full fleet's bit for bit.
  * :class:`ResilienceReport`: goodput, tiles recomputed and time to recover
    a fault.

Departures from the reference, each documented where it is made:

  * ``commit`` copies every array to the host on the driver's thread before
    it hands the write to the writer thread: the port's states are updated
    in place (and on the CPU ``Tensor.numpy()`` shares their memory), so a
    later tile would otherwise tear the checkpoint being written;
  * the drivers drain the writer (``SketchJobCheckpointer`` as a context
    manager) before a fault reaches their caller, so the newest checkpoint
    is on disk when they raise; the reference leaves the write in flight;
  * an Omega-carrying state's payload holds no Omega, as the reference's
    does not: ``state_from_payload`` draws it again from the key words;
  * job fingerprints of every method but ``shgemm_fused`` carry one more
    field (:func:`omega_fingerprint`), since those methods draw Omega from
    the counter lattice here and from ``jax.random`` in the reference;
  * the codecs and the elastic driver take the port's ``device=``;
  * the report is returned, never written into a benchmark file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import time
import urllib.error
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch._atomic_io import (AsyncWriter, atomic_write_dir,
                                    atomic_write_json)
from repro_torch.device import resolve_device
from repro_torch.kernels import shgemm_fused as _kf
from repro_torch.kernels.ref import dot_f32 as _dot
from repro_torch.stream import state as _st
from repro_torch.stream.source import TileSource, prefetch as _prefetch
from repro_torch.stream.state import SketchState
from repro_torch.stream.tucker import TuckerSketch

__all__ = [
    "SketchJobCheckpointer", "RestoredCheckpoint", "ResilienceReport",
    "FaultySource", "FaultInjected", "FlakyRangeFetcher",
    "state_to_payload", "state_from_payload",
    "tucker_to_payload", "tucker_from_payload", "key_fingerprint",
    "omega_fingerprint", "dtype_name", "array_to_tensor", "partition_rows",
    "sketch_row_range",
    "elastic_distributed_rsvd_streamed",
]

CKPT_FORMAT = "repro-sketch-checkpoint"
RESILIENCE_LOG = "resilience.json"
HEARTBEAT = "heartbeat.json"


# ---------------------------------------------------------------------------
# SketchState / TuckerSketch serialization
# ---------------------------------------------------------------------------

def dtype_name(dtype: torch.dtype) -> str:
    """The reference's name of a dtype (``"bfloat16"``, ``"float16"``), as
    fingerprints and payloads store it."""
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r} in a checkpoint")
    return dt


def _host(x) -> np.ndarray:
    """A host array that nothing else writes: a tensor is copied (the
    drivers update their tensors in place, and on the CPU ``.numpy()``
    shares their memory); a numpy array is taken as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def array_to_tensor(arr, device) -> torch.Tensor:
    """A tensor on ``device`` holding a copy of the restored host array
    ``arr``, with its strides: the tensor keeps the layout the uninterrupted
    run had (the bases ``torch.linalg.qr`` returns are column-major, and
    cuBLAS picks its algorithm, so its bits, by layout)."""
    return torch.from_numpy(np.array(arr)).to(device)


def _key_words(key) -> np.ndarray:
    return np.array(_kf.key_pair(key), np.uint32)


def key_fingerprint(key) -> list[int]:
    """JSON-able identity of a key (its two uint32 words, as the reference
    gives them for ``jax.random.PRNGKey``): part of a job fingerprint, so a
    resume under another key fails loudly instead of merging sketches from
    different random subspaces."""
    return [int(w) for w in _kf.key_pair(key)]


def omega_fingerprint(method: str) -> dict:
    """Fingerprint fields that tell the port's Omega stream from the
    reference's.  Kernel 2 hashes the reference's lattice, so a
    ``shgemm_fused`` job's fingerprint is the reference's and its
    checkpoints cross between the packages; every other method draws Omega
    from that lattice here and from ``jax.random`` in the reference, so its
    fingerprint carries one more field and a checkpoint of one package is
    refused by the other."""
    return {} if method == "shgemm_fused" else {"omega": "counter-lattice"}


def state_to_payload(state: SketchState, prefix: str = "state"
                     ) -> tuple[dict, dict]:
    """``(arrays, meta)`` snapshot of a SketchState: host copies of its data
    fields in the reference's layout (``y``, the key words as uint32,
    ``rows_seen`` as a 0-d int32, ``w`` and ``key_psi`` with a left sketch)
    and its static config as a JSON-able dict.  No Omega is stored.
    Round-trips bit for bit through :func:`state_from_payload`."""
    arrays = {
        f"{prefix}.y": _host(state.y),
        f"{prefix}.key_omega": _key_words(state.key_omega),
        f"{prefix}.rows_seen": np.asarray(state.rows_seen, np.int32),
    }
    if state.w is not None:
        arrays[f"{prefix}.w"] = _host(state.w)
        arrays[f"{prefix}.key_psi"] = _key_words(state.key_psi)
    meta = {"n_cols": state.n_cols, "p": state.p, "l": state.l,
            "method": state.method, "dist": state.dist,
            "omega_dtype": dtype_name(state.omega_dtype),
            "col_base": state.col_base}
    return arrays, {prefix: meta}


def state_from_payload(arrays: dict, meta: dict, prefix: str = "state",
                       device=None) -> SketchState:
    """The SketchState of a payload, on ``device``.  An Omega-carrying
    state's Omega is drawn again from its key words (``state.draw_omega``,
    bit for bit the one ``init`` drew)."""
    cfg = meta[prefix]
    dev = resolve_device(device)
    left = f"{prefix}.w" in arrays
    omega_dtype = _torch_dtype(cfg["omega_dtype"])
    key_omega = _kf.key_pair(arrays[f"{prefix}.key_omega"])
    y = array_to_tensor(arrays[f"{prefix}.y"], dev)
    omega = None
    if _st.carries_omega(cfg["method"], cfg["dist"]):
        omega = _st.draw_omega(key_omega, int(cfg["n_cols"]), y.shape[-1],
                               heads=y.shape[0] if y.ndim == 3 else None,
                               dist=cfg["dist"], omega_dtype=omega_dtype,
                               device=dev)
    return SketchState(
        y=y, n_cols=int(cfg["n_cols"]), key_omega=key_omega, omega=omega,
        w=array_to_tensor(arrays[f"{prefix}.w"], dev) if left else None,
        key_psi=(_kf.key_pair(arrays[f"{prefix}.key_psi"]) if left
                 else None),
        rows_seen=int(arrays[f"{prefix}.rows_seen"]), method=cfg["method"],
        dist=cfg["dist"], omega_dtype=omega_dtype, l=int(cfg["l"]),
        col_base=int(cfg["col_base"]))


def tucker_to_payload(ts: TuckerSketch, prefix: str = "tucker"
                      ) -> tuple[dict, dict]:
    arrays = {
        f"{prefix}.z": _host(ts.z),
        f"{prefix}.rows_seen": np.asarray(ts.rows_seen, np.int32),
    }
    meta = {prefix: {"dims": list(ts.dims), "ranks": list(ts.ranks),
                     "core_dims": list(ts.core_dims),
                     "n_modes": len(ts.modes)}}
    for i, st in enumerate(ts.modes):
        a, m = state_to_payload(st, prefix=f"{prefix}.mode{i}")
        arrays.update(a)
        meta.update(m)
    for i, kp in enumerate(ts.key_psis):
        arrays[f"{prefix}.key_psi{i}"] = _key_words(kp)
    return arrays, meta


def tucker_from_payload(arrays: dict, meta: dict, prefix: str = "tucker",
                        device=None) -> TuckerSketch:
    cfg = meta[prefix]
    dev = resolve_device(device)
    n = int(cfg["n_modes"])
    return TuckerSketch(
        modes=[state_from_payload(arrays, meta, f"{prefix}.mode{i}", dev)
               for i in range(n)],
        z=array_to_tensor(arrays[f"{prefix}.z"], dev),
        key_psis=tuple(_kf.key_pair(arrays[f"{prefix}.key_psi{i}"])
                       for i in range(n)),
        rows_seen=int(arrays[f"{prefix}.rows_seen"]),
        dims=tuple(cfg["dims"]), ranks=tuple(cfg["ranks"]),
        core_dims=tuple(cfg["core_dims"]))


# ---------------------------------------------------------------------------
# Goodput / recovery accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResilienceReport:
    """What a fault cost, measured.

    ``goodput`` = useful tile-seconds / wall tile-seconds over all attempts:
    1.0 for a fault-free run, lowered by exactly the tile work computed and
    lost (a killed attempt's progress after its last checkpoint, a dead
    host's unmerged contribution).  ``recovery_events`` holds one dict a
    fault with ``tiles_lost`` and ``time_to_recover_s`` (seconds until the
    replay caught up with the frontier before the fault)."""
    attempts: int
    tiles_total: int
    tiles_processed: int
    tiles_recomputed: int
    useful_tile_seconds: float
    wall_tile_seconds: float
    goodput: float
    wall_seconds: float
    recovery_events: list = dataclasses.field(default_factory=list)

    def as_record(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RestoredCheckpoint:
    """A loaded checkpoint: driver phase, cursor and payload."""
    seq: int
    phase: str
    pass_idx: int
    tiles_done: int       # tiles absorbed in `phase`: the replay skips them
    rows_done: int        # global row of the next tile (a tile boundary)
    arrays: dict
    meta: dict


def _read_json(path: Path) -> Optional[dict]:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def _jsonable(doc: dict) -> dict:
    """Round-trip through JSON, so fingerprints compare structurally (tuples
    become lists, numpy ints ints)."""
    return json.loads(json.dumps(doc, default=lambda o: (
        int(o) if isinstance(o, (np.integer,)) else
        float(o) if isinstance(o, (np.floating,)) else str(o))))


class SketchJobCheckpointer:
    """Checkpoint, restore and goodput accounting of one streamed job.

    Layout under ``directory``::

        ckpt_<seq>/            atomic checkpoint directories (keep-k GC):
            <name>.npy         payload arrays (sketch state, pass partials)
            manifest.json      format, phase, pass_idx, cursor, fingerprint
        heartbeat.json         per-tile progress of the live attempt (a small
                               atomic write), read on resume to measure what
                               the dead attempt lost
        resilience.json        accounting across attempts (attempts, wall
                               and tile seconds of dead attempts, recovery
                               events)

    A driver runs::

        ck = SketchJobCheckpointer(dir, every_tiles=k, fingerprint=fp,
                                   resume=resume)
        with ck:                         # drains the writer if a fault raises
            restored = ck.restore()      # None: a fresh start
            ...rebuild state and cursor from restored...
            for each tile:
                absorb the tile
                ck.note_tile(seconds)
                ck.tick(phase=..., pass_idx=..., tiles_done=...,
                        rows_done=..., payload=lambda: (arrays, meta))
            ck.commit(...)               # at each pass boundary
            report = ck.finish(tiles_total=n)

    ``resume=True`` with nothing on disk is a fresh start, so one command
    line serves the first attempt and every retry.  ``resume=False`` clears
    an earlier job's checkpoints.  A fingerprint mismatch on resume raises
    RuntimeError: resuming under another key, rank, method or tiling would
    merge incompatible sketches.
    """

    def __init__(self, directory: str | Path, *, every_tiles: int = 16,
                 fingerprint: Optional[dict] = None, resume: bool = False,
                 keep: int = 2, heartbeat_every_tiles: int = 1):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        if int(every_tiles) < 1:
            raise ValueError(f"checkpoint_every_tiles must be >= 1, got "
                             f"{every_tiles}")
        self.every = int(every_tiles)
        self.keep = max(1, int(keep))
        self.heartbeat_every = max(1, int(heartbeat_every_tiles))
        self.fingerprint = _jsonable(dict(fingerprint or {}))
        self._writer = AsyncWriter(name="repro-torch-sketch-ckpt")

        # -- this attempt's live counters ---------------------------------
        self._t0 = time.perf_counter()
        self._tile_secs = 0.0
        self._tile_secs_since_ckpt = 0.0
        self._tiles_since_ckpt = 0
        self._tiles_processed = 0
        self._ticks_since_hb = 0
        self._pending_recovery: Optional[dict] = None
        self._restored: Optional[RestoredCheckpoint] = None

        prior = _read_json(self.dir / RESILIENCE_LOG)
        hb = _read_json(self.dir / HEARTBEAT)
        if not resume:
            self._clear_previous_job()
            prior = hb = None
        if prior is not None and prior.get("finished"):
            prior = hb = None   # the earlier job completed: this is a new one
        self._log = {
            "format": "repro-resilience-log",
            "attempts": (prior.get("attempts", 0) if prior else 0) + 1,
            "wall_seconds_prev": (prior.get("wall_seconds_prev", 0.0)
                                  if prior else 0.0),
            "tile_seconds_prev": (prior.get("tile_seconds_prev", 0.0)
                                  if prior else 0.0),
            "tiles_prev": prior.get("tiles_prev", 0) if prior else 0,
            "recovery_events": (prior.get("recovery_events", [])
                                if prior else []),
            "finished": False,
        }

        if resume:
            self._restored = self._load_latest()
        self._seq = self._next_seq()

        if prior is not None:
            # a dead attempt left an unfinished log: account for its work
            # and record what the fault cost
            if hb is not None:
                self._log["wall_seconds_prev"] += float(hb.get("elapsed", 0.0))
                self._log["tile_seconds_prev"] += float(
                    hb.get("tile_secs_total", 0.0))
                self._log["tiles_prev"] += int(hb.get("tiles_processed", 0))
            cursor = 0
            if (self._restored is not None and hb is not None
                    and hb.get("phase") == self._restored.phase
                    and hb.get("pass_idx") == self._restored.pass_idx):
                cursor = self._restored.tiles_done
            tiles_lost = max(0, int(hb.get("tiles_done", 0)) - cursor) \
                if hb is not None else 0
            event = {
                "kind": "resume",
                "attempt": self._log["attempts"],
                "phase": hb.get("phase") if hb else None,
                "tiles_lost": tiles_lost,
                "tile_secs_lost": (float(hb.get("tile_secs_since_ckpt", 0.0))
                                   if hb else 0.0),
                "time_to_recover_s": 0.0,
            }
            self._log["recovery_events"].append(event)
            if tiles_lost > 0:
                self._pending_recovery = {"event": event,
                                          "tiles_left": tiles_lost,
                                          "t0": time.perf_counter()}
        atomic_write_json(self.dir / RESILIENCE_LOG, self._log)

    # -- a fault drains the writer before it reaches the caller -----------

    def __enter__(self) -> "SketchJobCheckpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.drain()
        return False

    def drain(self) -> None:
        """Block until every submitted checkpoint is on disk, raising
        nothing: for a caller that is already raising."""
        self._writer.drain()

    # -- restore -----------------------------------------------------------

    def restore(self) -> Optional[RestoredCheckpoint]:
        """The checkpoint to resume from, or None for a fresh start."""
        return self._restored

    def _ckpt_dirs(self) -> list[tuple[int, Path]]:
        out = []
        for p in self.dir.glob("ckpt_*"):
            if p.is_dir() and not p.name.endswith(".tmp") \
                    and (p / "manifest.json").is_file():
                try:
                    out.append((int(p.name.split("_")[1]), p))
                except ValueError:
                    continue
        return sorted(out)

    def _next_seq(self) -> int:
        dirs = self._ckpt_dirs()
        return (dirs[-1][0] + 1) if dirs else 0

    def _clear_previous_job(self) -> None:
        for _, p in self._ckpt_dirs():
            shutil.rmtree(p, ignore_errors=True)
        for name in (RESILIENCE_LOG, HEARTBEAT):
            try:
                (self.dir / name).unlink()
            except OSError:
                pass

    def _load_latest(self) -> Optional[RestoredCheckpoint]:
        dirs = self._ckpt_dirs()
        if not dirs:
            return None
        seq, d = dirs[-1]
        manifest = json.loads((d / "manifest.json").read_text())
        if manifest.get("format") != CKPT_FORMAT:
            raise RuntimeError(
                f"{d}: not a {CKPT_FORMAT} checkpoint (format="
                f"{manifest.get('format')!r}) — refusing to resume from "
                f"an unrecognized layout")
        theirs = manifest.get("fingerprint", {})
        if theirs != self.fingerprint:
            diff = sorted(k for k in set(theirs) | set(self.fingerprint)
                          if theirs.get(k) != self.fingerprint.get(k))
            raise RuntimeError(
                f"checkpoint fingerprint mismatch under {self.dir}: "
                f"field(s) {diff} differ between the checkpoint and this "
                f"job (checkpoint {theirs!r} vs job {self.fingerprint!r}) "
                f"— resuming would mix sketches from different "
                f"keys/shapes/methods.  Point checkpoint_dir at a fresh "
                f"directory or rerun with the original parameters")
        arrays = {k: np.load(d / f"{k}.npy") for k in manifest["arrays"]}
        return RestoredCheckpoint(
            seq=seq, phase=manifest["phase"],
            pass_idx=int(manifest["pass_idx"]),
            tiles_done=int(manifest["tiles_done"]),
            rows_done=int(manifest["rows_done"]),
            arrays=arrays, meta=manifest["meta"])

    # -- per-tile hooks ----------------------------------------------------

    def note_tile(self, seconds: float, tiles: int = 1) -> None:
        """Account ``seconds`` of tile work (this attempt)."""
        self._tile_secs += seconds
        self._tile_secs_since_ckpt += seconds
        self._tiles_processed += tiles
        pr = self._pending_recovery
        if pr is not None:
            pr["tiles_left"] -= tiles
            if pr["tiles_left"] <= 0:
                pr["event"]["time_to_recover_s"] = \
                    time.perf_counter() - pr["t0"]
                self._pending_recovery = None
                atomic_write_json(self.dir / RESILIENCE_LOG, self._log)

    def tick(self, *, phase: str, pass_idx: int, tiles_done: int,
             rows_done: int, payload: Callable[[], tuple[dict, dict]]
             ) -> bool:
        """Per-tile hook: a heartbeat every tile, a checkpoint every
        ``every_tiles`` tiles.  Returns True when a checkpoint was cut."""
        self._tiles_since_ckpt += 1
        self._ticks_since_hb += 1
        if self._tiles_since_ckpt >= self.every:
            self.commit(phase=phase, pass_idx=pass_idx,
                        tiles_done=tiles_done, rows_done=rows_done,
                        payload=payload)
            return True
        if self._ticks_since_hb >= self.heartbeat_every:
            self._write_heartbeat(phase, pass_idx, tiles_done, rows_done)
        return False

    def commit(self, *, phase: str, pass_idx: int, tiles_done: int,
               rows_done: int,
               payload: Callable[[], tuple[dict, dict]]) -> None:
        """Cut a checkpoint now (pass boundaries, the end of a job phase).
        The payload's arrays are copied to the host here, on the calling
        thread; the writer thread only writes those copies."""
        arrays, meta = payload() if callable(payload) else payload
        arrays = {k: _host(v) for k, v in arrays.items()}
        seq = self._seq
        self._seq += 1
        manifest = {
            "format": CKPT_FORMAT, "version": 1, "seq": seq,
            "phase": phase, "pass_idx": int(pass_idx),
            "tiles_done": int(tiles_done), "rows_done": int(rows_done),
            "fingerprint": self.fingerprint,
            "meta": _jsonable(meta),
            "arrays": {k: [list(v.shape), str(v.dtype)]
                       for k, v in arrays.items()},
            "time": time.time(),
        }

        def write() -> None:
            def write_arrays(tmp: Path) -> None:
                for k, v in arrays.items():
                    np.save(tmp / f"{k}.npy", v)
            atomic_write_dir(self.dir / f"ckpt_{seq:06d}", write_arrays,
                             manifest=manifest)
            self._gc()

        self._writer.submit(write)
        self._tiles_since_ckpt = 0
        self._tile_secs_since_ckpt = 0.0
        self._write_heartbeat(phase, pass_idx, tiles_done, rows_done)

    def _write_heartbeat(self, phase: str, pass_idx: int, tiles_done: int,
                         rows_done: int) -> None:
        self._ticks_since_hb = 0
        atomic_write_json(self.dir / HEARTBEAT, {
            "attempt": self._log["attempts"],
            "phase": phase, "pass_idx": int(pass_idx),
            "tiles_done": int(tiles_done), "rows_done": int(rows_done),
            "tiles_processed": int(self._tiles_processed),
            "tile_secs_total": float(self._tile_secs),
            # measured against the last submitted checkpoint (the write is
            # asynchronous): a crash between submit and write overstates
            # the loss, never understates it
            "tile_secs_since_ckpt": float(self._tile_secs_since_ckpt),
            "elapsed": float(time.perf_counter() - self._t0),
        }, indent=0)

    # -- finish ------------------------------------------------------------

    def wait(self) -> None:
        self._writer.wait()

    def report(self, *, tiles_total: int) -> ResilienceReport:
        events = self._log["recovery_events"]
        wall_tile = self._log["tile_seconds_prev"] + self._tile_secs
        wasted = sum(float(e.get("tile_secs_lost", 0.0)) for e in events)
        useful = max(wall_tile - wasted, 0.0)
        return ResilienceReport(
            attempts=int(self._log["attempts"]),
            tiles_total=int(tiles_total),
            tiles_processed=int(self._log["tiles_prev"]
                                + self._tiles_processed),
            tiles_recomputed=sum(int(e.get("tiles_lost", 0))
                                 for e in events),
            useful_tile_seconds=float(useful),
            wall_tile_seconds=float(wall_tile),
            goodput=(useful / wall_tile) if wall_tile > 0 else 1.0,
            wall_seconds=float(self._log["wall_seconds_prev"]
                               + time.perf_counter() - self._t0),
            recovery_events=list(events))

    def finish(self, *, tiles_total: int) -> ResilienceReport:
        """Drain the pending writes, mark the job done, return the report."""
        self.wait()
        report = self.report(tiles_total=tiles_total)
        self._log["finished"] = True
        self._log["report"] = report.as_record()
        atomic_write_json(self.dir / RESILIENCE_LOG, self._log)
        return report

    def _gc(self) -> None:
        dirs = self._ckpt_dirs()
        for _, p in dirs[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

class FaultInjected(RuntimeError):
    """Raised by FaultySource in ``mode="raise"``: told apart from real
    failures, so tests can assert the injected path."""


class FaultySource(TileSource):
    """TileSource wrapper that injects a fault at a chosen tile.

    The tile counter runs across replays (``tiles()`` and ``tiles_from``
    share it), so a fault can hit any pass of a multi-pass driver:
    ``fail_at_tile=n_tiles + 2`` fires in the second pass.  Modes:

      * ``"raise"``: raise :class:`FaultInjected` (through ``prefetch`` to
        the consumer); it fires again on each later tile until ``n_faults``
        faults have fired, then tiles pass through;
      * ``"hang"``: sleep ``hang_secs`` before yielding (a stalled fetcher);
      * ``"kill"``: ``SIGKILL`` the whole process (a real preemption).

    ``fail_at_tile`` may instead be drawn from ``seed`` (uniform over the
    wrapped source's tile count, ``np.random.default_rng(seed)``, the
    reference's draw).
    """

    _MODES = ("raise", "hang", "kill")

    def __init__(self, inner: TileSource, *,
                 fail_at_tile: Optional[int] = None, mode: str = "raise",
                 seed: Optional[int] = None, n_faults: int = 1,
                 hang_secs: float = 30.0):
        if mode not in self._MODES:
            raise ValueError(f"mode must be one of {self._MODES}, got "
                             f"{mode!r}")
        if fail_at_tile is None:
            if seed is None:
                raise ValueError("give fail_at_tile= or seed= (the seed "
                                 "picks a tile deterministically)")
            n_tiles = _count_tiles(inner)
            if n_tiles is None:
                raise ValueError(
                    "cannot derive a tile count for this source (no "
                    "tile_rows) — pass fail_at_tile= explicitly")
            fail_at_tile = int(
                np.random.default_rng(seed).integers(0, max(1, n_tiles)))
        self.inner = inner
        self.shape = inner.shape
        tr = getattr(inner, "tile_rows", None)
        if tr is not None:
            self.tile_rows = tr
        self.fail_at_tile = int(fail_at_tile)
        self.mode = mode
        self.n_faults = int(n_faults)
        self.hang_secs = float(hang_secs)
        self._count = 0
        self._fired = 0

    @property
    def replayable(self) -> bool:
        return self.inner.replayable

    def tiles(self) -> Iterator:
        return self._wrap(self.inner.tiles())

    def tiles_from(self, start_row: int) -> Iterator:
        return self._wrap(self.inner.tiles_from(start_row))

    def _wrap(self, it) -> Iterator:
        def gen():
            for tile in it:
                idx = self._count
                self._count += 1
                if idx >= self.fail_at_tile and self._fired < self.n_faults:
                    self._fired += 1
                    self._fire(idx)
                yield tile
        return gen()

    def _fire(self, idx: int) -> None:
        if self.mode == "raise":
            raise FaultInjected(
                f"injected fault at tile #{idx} "
                f"(configured fail_at_tile={self.fail_at_tile})")
        if self.mode == "hang":
            time.sleep(self.hang_secs)   # stall, then yield normally
        else:  # kill: indistinguishable from a preemption
            os.kill(os.getpid(), signal.SIGKILL)


def _count_tiles(src) -> Optional[int]:
    """A source's tile count from its tiling geometry (no iteration)."""
    tr = getattr(src, "tile_rows", None)
    if tr is None:
        return None
    if hasattr(src, "shards"):            # ObjectStoreSource
        rows_list = [sh.rows for sh in src.shards]
    elif hasattr(src, "shard_rows"):      # DirectorySource
        rows_list = list(src.shard_rows)
    else:
        rows_list = [src.n_rows]
    return sum(-(-r // tr) for r in rows_list)


class FlakyRangeFetcher:
    """Range-fetcher wrapper that injects transient-looking failures into
    ``read()`` calls, deterministically.

    ``fail_reads`` maps 0-based read-call indices to a failure kind
    (``True`` takes the default ``kind``); each retry is a new call index.
    Kinds:

      * ``"timeout"``: raise TimeoutError (transient: retried);
      * ``"http503"``: raise urllib's HTTPError 503 (transient: retried);
      * ``"truncate"``: return half the requested bytes (the retry layer
        classifies the resulting ShortReadError as transient).

    Or ``rate`` + ``seed`` inject i.i.d. faults a call, drawn from
    ``np.random.default_rng((seed, call index))`` as in the reference;
    ``n_faults`` caps the injections either way.
    """

    _KINDS = ("timeout", "http503", "truncate")

    def __init__(self, inner, *, fail_reads=(), kind: str = "timeout",
                 rate: float = 0.0, seed: int = 0,
                 n_faults: Optional[int] = None):
        if kind not in self._KINDS:
            raise ValueError(f"kind must be one of {self._KINDS}, got "
                             f"{kind!r}")
        self.inner = inner
        if isinstance(fail_reads, dict):
            self._fail_map = {int(k): (kind if v is True else v)
                              for k, v in fail_reads.items()}
        else:
            self._fail_map = {int(i): kind for i in fail_reads}
        for k in self._fail_map.values():
            if k not in self._KINDS:
                raise ValueError(f"unknown failure kind {k!r}")
        self.kind = kind
        self.rate = float(rate)
        self.seed = int(seed)
        self.n_faults = n_faults
        self.reads = 0       # read() calls seen
        self.injected = 0    # faults fired

    def size(self, url: str) -> int:
        return self.inner.size(url)

    def fail_next(self, n: int = 1, kind: Optional[str] = None) -> None:
        """Make the next ``n`` ``read()`` calls fail, counted from the
        current call count (construction's manifest and header reads
        included)."""
        k = kind or self.kind
        if k not in self._KINDS:
            raise ValueError(f"unknown failure kind {k!r}")
        for i in range(int(n)):
            self._fail_map[self.reads + i] = k

    def _fault_for(self, idx: int) -> Optional[str]:
        if self.n_faults is not None and self.injected >= self.n_faults:
            return None
        if self._fail_map:
            return self._fail_map.get(idx)
        if self.rate > 0.0:
            rng = np.random.default_rng((self.seed, idx))
            if rng.random() < self.rate:
                return self.kind
        return None

    def read(self, url: str, start: int, length: int) -> bytes:
        idx = self.reads
        self.reads += 1
        kind = self._fault_for(idx)
        if kind is None:
            return self.inner.read(url, start, length)
        self.injected += 1
        if kind == "timeout":
            raise TimeoutError(f"injected timeout on read #{idx} of {url}")
        if kind == "http503":
            raise urllib.error.HTTPError(url, 503, f"injected 503 on read "
                                         f"#{idx}", None, None)
        # truncate: a connection dropped mid-body
        return self.inner.read(url, start, length)[:length // 2]


# ---------------------------------------------------------------------------
# Elastic re-mesh: replay a dead host's range on the survivors
# ---------------------------------------------------------------------------

def partition_rows(r0: int, r1: int, parts: int, *,
                   tile_rows: Optional[int] = None
                   ) -> list[tuple[int, int]]:
    """Split the row range ``[r0, r1)`` into up to ``parts`` contiguous,
    near-equal chunks.  With ``tile_rows`` the cuts land on tile boundaries
    relative to ``r0`` (the dead host's own tiling), so each chunk replays
    through ``tiles_from`` without splitting a tile.  Empty chunks are
    dropped."""
    r0, r1 = int(r0), int(r1)
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    if r1 < r0:
        raise ValueError(f"empty/negative range [{r0}, {r1})")
    total = r1 - r0
    if total == 0:
        return []
    if tile_rows:
        n_tiles = -(-total // tile_rows)
        base, rem = divmod(n_tiles, parts)
        cuts, t = [r0], 0
        for i in range(parts):
            t += base + (1 if i < rem else 0)
            cuts.append(min(r0 + t * tile_rows, r1))
    else:
        base, rem = divmod(total, parts)
        cuts, t = [r0], 0
        for i in range(parts):
            t += base + (1 if i < rem else 0)
            cuts.append(r0 + t)
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]


def sketch_row_range(state: SketchState, src: TileSource, r0: int, r1: int,
                     *, src_row0: int = 0,
                     prefetch_depth: Optional[int] = 1,
                     on_tile: Optional[Callable[[int, float], None]] = None
                     ) -> SketchState:
    """Replay global rows ``[r0, r1)`` of ``src`` into ``state`` (in place,
    on the state's device).

    ``src`` covers global rows ``[src_row0, src_row0 + src.n_rows)``; ``r0``
    and ``r1`` must be tile boundaries of its tiling.  Row tiles write their
    rows of Y, so the state's rows equal any other replay's bit for bit,
    which the elastic recovery relies on.  ``on_tile(n_rows, seconds)`` runs
    after each tile (goodput accounting)."""
    local0 = int(r0) - int(src_row0)
    local1 = int(r1) - int(src_row0)
    if not 0 <= local0 <= local1 <= src.n_rows:
        raise ValueError(f"range [{r0}, {r1}) is outside the source's "
                         f"global coverage [{src_row0}, "
                         f"{src_row0 + src.n_rows})")

    def limited():
        covered = local0
        for tile in src.tiles_from(local0):
            if covered >= local1:
                break
            b = int(tile.shape[0])
            if covered + b > local1:
                raise ValueError(
                    f"r1={r1} is not a tile boundary (the tile at local "
                    f"rows [{covered}, {covered + b}) straddles it)")
            yield tile
            covered += b
        else:
            if covered != local1:
                raise ValueError(f"tiles cover only local rows "
                                 f"[{local0}, {covered}), expected "
                                 f"[{local0}, {local1})")

    it = (limited() if prefetch_depth is None
          else _prefetch(limited(), depth=prefetch_depth,
                         device=state.device))
    off = int(r0)
    for tile in it:
        t0 = time.perf_counter()
        _st.update(state, tile, off)
        b = int(tile.shape[0])
        if on_tile is not None:
            on_tile(b, time.perf_counter() - t0)
        off += b
    if off != int(r1):
        raise ValueError(f"replay covered rows [{r0}, {off}), expected "
                         f"[{r0}, {r1})")
    return state


def elastic_distributed_rsvd_streamed(
        key, sources, rank: int, *, oversample: int = 10, passes: int = 2,
        method: str = "shgemm_fused", omega_dtype=torch.bfloat16,
        lose_hosts=(), lose_after_tiles: int = 0,
        prefetch_depth: Optional[int] = 1, return_report: bool = False,
        device=None):
    """Streamed multi-host rSVD that survives hosts dying mid-job (a
    single-controller simulation of an elastic, preemptible fleet).

    ``sources[h]`` is host h's row range of the global matrix (consecutive,
    in order).  Hosts in ``lose_hosts`` die in pass 1 after sketching
    ``lose_after_tiles`` tiles, before their state is merged, so all of it
    is lost.  The survivors split each dead host's range at tile boundaries
    (:func:`partition_rows`) and replay only it (:func:`sketch_row_range`);
    every replayed chunk covers disjoint rows, so each merge adds zeros
    exactly.

    The factorization is a function of (key, data, per-source tilings)
    alone: pass 1's rows are written, whatever grouping replays them, and
    later passes accumulate B = Q^T A and Y = A.Z a source at a time in
    source order, so the factors equal the full fleet's bit for bit, and
    single-host ``rsvd_streamed``'s over the concatenated source when the
    tile boundaries coincide.

    ``passes`` must be >= 2: the single-pass finalizer's left sketch W is an
    f32 sum in tile order, which a re-partitioned replay cannot reproduce.

    Returns an ``SVDResult``; with ``return_report=True`` an
    ``(SVDResult, ResilienceReport)`` pair.
    """
    # deferred: core.rsvd imports stream
    from repro_torch.core.rsvd import (SVDResult, _check_rank,
                                       streamed_power_factor)
    from repro_torch.stream.finalize import range_basis
    from repro_torch.stream.source import as_tile_source, offset_tiles

    if passes < 2:
        raise ValueError(
            "elastic_distributed_rsvd_streamed needs passes >= 2: the "
            "single-pass finalizer's left sketch W accumulates in tile "
            "order (f32 summation), so a re-partitioned replay cannot be "
            "bitwise-equal — run the two-pass scheme, whose pass-1 state "
            "is pure write-semantics")
    dev = resolve_device(device)
    srcs = [as_tile_source(s) for s in sources]
    if not srcs:
        raise ValueError("need at least one source")
    n_cols = srcs[0].n_cols
    for i, s in enumerate(srcs):
        if s.n_cols != n_cols:
            raise ValueError(f"source {i} has {s.n_cols} cols, expected "
                             f"{n_cols}")
        if not s.replayable:
            raise ValueError(f"source {i} is not replayable — elastic "
                             f"recovery and passes >= 2 both replay tiles")
    n_hosts = len(srcs)
    lost = sorted(set(int(h) for h in lose_hosts))
    for h in lost:
        if not 0 <= h < n_hosts:
            raise ValueError(f"lose_hosts names host {h}, but there are "
                             f"only {n_hosts}")
    survivors = [h for h in range(n_hosts) if h not in set(lost)]
    if not survivors:
        raise ValueError("cannot lose every host — no survivors to "
                         "replay the work")

    row_starts, m = [], 0
    for s in srcs:
        row_starts.append(m)
        m += s.n_rows
    _check_rank(rank, m, n_cols)
    p_hat = min(rank + oversample, min(m, n_cols))

    t_start = time.perf_counter()
    tile_secs = [0.0]          # useful tile-seconds
    wasted_secs = [0.0]        # the dead hosts' lost tile-seconds
    tiles_done = [0]
    tiles_recomputed = [0]
    events: list[dict] = []

    def fresh_state() -> SketchState:
        return _st.init(key, n_cols, p_hat, max_rows=m, left=False,
                        method=method, omega_dtype=omega_dtype, device=dev)

    def note(n_rows_abs: int, secs: float) -> None:
        tile_secs[0] += secs
        tiles_done[0] += 1

    # -- pass 1: per-host sketches; the lost hosts' work evaporates --------
    per_source: dict[int, SketchState] = {}
    for h, src in enumerate(srcs):
        if h in set(lost):
            # the host sketches lose_after_tiles tiles and dies with all of
            # it unmerged
            t0 = time.perf_counter()
            doomed, n = fresh_state(), 0
            for off, tile in offset_tiles(src, prefetch_depth=prefetch_depth,
                                          device=dev):
                if n >= int(lose_after_tiles):
                    break
                _st.update(doomed, tile, row_starts[h] + off)
                n += 1
            del doomed   # dies unmerged
            wasted_secs[0] += time.perf_counter() - t0
            events.append({"kind": "host_loss", "host": h,
                           "tiles_lost": n, "phase": "sketch",
                           "time_to_recover_s": None})
            continue
        per_source[h] = sketch_row_range(
            fresh_state(), src, row_starts[h], row_starts[h] + src.n_rows,
            src_row0=row_starts[h], prefetch_depth=prefetch_depth,
            on_tile=note)

    # -- elastic recovery: the survivors re-partition each dead range -----
    for ev in events:
        h = ev["host"]
        src = srcs[h]
        t_rec = time.perf_counter()
        chunks = partition_rows(
            row_starts[h], row_starts[h] + src.n_rows, len(survivors),
            tile_rows=getattr(src, "tile_rows", None))
        st = fresh_state()
        n_before = tiles_done[0]
        for a, b in chunks:   # chunk i runs on survivor i (round robin)
            sketch_row_range(st, src, a, b, src_row0=row_starts[h],
                             prefetch_depth=prefetch_depth, on_tile=note)
        per_source[h] = st
        ev["time_to_recover_s"] = time.perf_counter() - t_rec
        ev["tiles_replayed"] = tiles_done[0] - n_before
        tiles_recomputed[0] += tiles_done[0] - n_before

    # source-order fold; disjoint rows make every grouping exact
    merged = per_source[0]
    for h in range(1, n_hosts):
        merged = _st.merge(merged, per_source[h])

    # -- later passes: accumulation in source order ------------------------
    def each_tile():
        for h, src in enumerate(srcs):
            for off, tile in offset_tiles(src, prefetch_depth=prefetch_depth,
                                          device=dev):
                t0 = time.perf_counter()
                blk = tile.to(device=dev, dtype=torch.float32)
                yield row_starts[h] + off, blk
                note(int(blk.shape[0]), time.perf_counter() - t0)

    def accumulate_b(q):
        b = torch.zeros((q.shape[1], n_cols), dtype=torch.float32, device=dev)
        for off, blk in each_tile():
            b += _dot(q[off:off + blk.shape[0]].T, blk)
        return b

    def accumulate_y(z):
        return torch.cat([_dot(blk, z) for _, blk in each_tile()], dim=0)

    res = streamed_power_factor(range_basis(merged), rank, passes,
                                accumulate_b=accumulate_b,
                                accumulate_y=accumulate_y)
    if not return_report:
        return res

    n_tiles_pass = sum(_count_tiles(s) or 0 for s in srcs)
    wall_tile = tile_secs[0] + wasted_secs[0]
    # waste: the dead hosts' lost seconds plus the replay of their ranges
    # (recomputation of progress that would exist without the fault, at the
    # average tile cost)
    useful = max(wall_tile - wasted_secs[0]
                 - _recompute_secs(events, tile_secs[0], tiles_done[0]), 0.0)
    report = ResilienceReport(
        attempts=1,
        tiles_total=n_tiles_pass * passes,
        tiles_processed=tiles_done[0],
        tiles_recomputed=tiles_recomputed[0]
        + sum(int(e.get("tiles_lost", 0)) for e in events),
        useful_tile_seconds=useful,
        wall_tile_seconds=wall_tile,
        goodput=(useful / wall_tile) if wall_tile > 0 else 1.0,
        wall_seconds=time.perf_counter() - t_start,
        recovery_events=events)
    return res, report


def _recompute_secs(events: list, total_secs: float, total_tiles: int
                    ) -> float:
    """Seconds spent replaying dead hosts' ranges, estimated at the average
    tile cost (the replay made progress that would exist without the fault:
    recomputation, not goodput)."""
    if total_tiles <= 0:
        return 0.0
    per_tile = total_secs / total_tiles
    return per_tile * sum(int(e.get("tiles_replayed", 0)) for e in events)
