"""Model-step layer of the serving stack: slot-pool tensor state plus the
prefill/decode/compress primitives, with no request lifecycle (port of
``repro/serve/model_step.py``).

Everything that touches params, the KV cache, the incremental per-slot
sketches (``serve/kv_compress.py``) and the factored leaves lives here:
``prefill_rows`` (a single-slot chunk at explicit positions),
``decode_logits``/``sample`` (one batched decode step at the uniform slot
clock), ``compress_slot``/``auto_compress`` (dense prefix -> rank-r factors),
``begin_slot`` and the ``kv_slot_bytes``/``kv_bytes_report`` accounting.

Differences from the reference, none of which changes the arithmetic:
  * the cache and factor leaves are updated in place;
  * a slot's prefill runs one serve step over the whole chunk on that
    slot's batch row alone (views into the pool), where the reference scans
    single-token steps over every slot and masks the other slots' writes
    out: the same arithmetic, summed in another order.  For a routed-MoE
    config the reference's steps route ``slots`` tokens at a time, the
    chunk's token broadcast to every slot: while their capacity holds every
    pair (``slots <= 8``) nothing drops, and the chunk runs as one step with
    a dropless capacity (``moe.dropless``); past that, which of the slot's
    pairs drop depends on how the other slots route, and the pool runs
    token by token as the reference does (``_prefill_pool``);
  * the weights are cast to the activation dtype once, at construction;
  * a masked step (the scheduler's decode, ``_prefill_pool``) restores the
    other slots' rows at the clock in every leaf with a seq axis, k/v and
    MLA latents, and their whole recurrent-state leaves, where the
    reference merges every leaf under the mask.
``begin_slot`` also zeroes the slot's recurrent state (``h``, ``conv``,
``c``, ``n``), as the Engine's admission does: the reference resets
neither, so its reused or idle-stepped slots start a request from the
last tenant's state (a documented deviation).
Windowed (ring) cache leaves keep rolling sketches whose ring mirrors the
cache ring (``kv_compress.kv_rolling_*``); only full-context k/v leaves swap
to factors.

Documented deviations: the per-(slot, leaf) sketch keys are derived on the
counter lattice in place of ``jax.random.fold_in`` (``_slot_key``: stream 7
at columns (2j, 2j + 1); ``_kv_roll_key``, the rolling sketches': stream 7
at columns ``_ROLL_COL_BASE`` + (2j, 2j + 1), a range the linear keys never
reach), and sampling at ``temperature > 0`` draws from a
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.convert import key_from_seed
from repro_torch.device import resolve_device
from repro_torch.kernels import shgemm_fused as _lattice
from repro_torch.models import cache as cache_mod
from repro_torch.models import moe
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serve import kv_compress

# Counter-lattice stream of the per-(slot, leaf) sketch keys (0-1 draw
# Omega, 6 the HOSVD mode keys); the rolling sketches' keys sit at columns
# from _ROLL_COL_BASE on (the reference folds in 0x7011 for them).
_SKETCH_KEY_STREAM = 7
_ROLL_COL_BASE = 0x7011 << 16


class ModelStep:
    """Slot-pool model state + step primitives (see module docstring)."""

    def __init__(self, cfg: ModelCfg, params, *, slots: int = 4,
                 max_seq: int = 256, temperature: float = 0.0,
                 sample_seed: int = 0, kv_sketch_rank: Optional[int] = None,
                 kv_sketch_seed: int = 7,
                 kv_compress_ratio: Optional[float] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = T.cast_params_for_compute(
            cfg, {k: v.to(self.device) for k, v in params.items()})
        self.slots = slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(sample_seed)
        self.cache = cache_mod.build_cache(cfg, slots, max_seq,
                                           device=self.device)
        self.pos = np.zeros(slots, np.int32)       # next write position
        self.last_logits: Optional[torch.Tensor] = None
        self._serve = R.make_serve_step(cfg)
        # a chunk of one slot runs as one step unless the pool's MoE
        # capacity drops pairs (see the module docstring)
        self._chunk_serve = self._serve
        self._pool_prefill = False
        if cfg.moe is not None:
            m = cfg.moe
            if moe.capacity(slots, m.num_experts, m.top_k,
                            m.capacity_factor) >= slots:
                self._chunk_serve = R.make_serve_step(moe.dropless(cfg))
            else:
                self._pool_prefill = True
        self.kv_sketch_rank = kv_sketch_rank
        self._kv_key = key_from_seed(kv_sketch_seed)
        linear_paths, ring_paths = self._find_kv_paths()
        self._kv_paths, self._kv_roll_paths = (
            (linear_paths, ring_paths) if kv_sketch_rank else ([], []))
        # windowed ring leaves, tracked even without sketching: begin_slot
        # must zero them for a new tenant
        self._ring_paths = ring_paths
        self._kv_sketches: list[Optional[dict]] = [None] * slots
        # contiguous [start, count] span of cache rows not yet absorbed into
        # the sketches, flushed every _kv_flush_every rows
        self._kv_pending: list[Optional[list]] = [None] * slots
        self._kv_flush_every = 16
        # append-only watchdog: a slot whose rows land beyond its own
        # high-water mark has a gap the sketch never streamed and must not
        # compress (DESIGN.md §12.1)
        self._kv_next_row = np.zeros(slots, np.int64)
        self._kv_contig = [True] * slots
        self.kv_compress_ratio = kv_compress_ratio
        self._kv_comp_len = np.zeros(slots, np.int32)
        self._kv_swap_paths = [p for p in self._kv_paths
                               if p[2] in ("k", "v")]
        self.kv_fact = None
        if kv_compress_ratio is not None:
            if not kv_sketch_rank:
                raise ValueError("kv_compress_ratio requires kv_sketch_rank")
            if kv_compress_ratio < 1.0:
                raise ValueError(f"kv_compress_ratio={kv_compress_ratio} "
                                 f"must be >= 1 (rows per factor rank)")
            if not self._kv_swap_paths:
                raise ValueError(
                    f"{cfg.name} has no full-context attention k/v leaves "
                    f"to compress (MLA latents / window-only stacks are not "
                    f"swappable — DESIGN.md §12)")
            self._kv_threshold = max(
                int(math.ceil(kv_compress_ratio * kv_sketch_rank)), 1)
            # a swap needs >= p streamed rows so Q's unseen rows (and hence
            # the factored prefix beyond comp_len) are exactly zero
            self._kv_min_rows = kv_compress._sketch_width(
                kv_sketch_rank, cfg.head_dim)
            self.kv_fact = cache_mod.build_kv_factors(
                cfg, slots, max_seq, kv_sketch_rank, device=self.device)

    # -- incremental KV sketching ------------------------------------------
    def _find_kv_paths(self) -> tuple[list, list]:
        """Cache leaves by stream model: full-context k/v (and MLA latents)
        are append-only; sliding-window k/v leaves overwrite rows (ring)."""
        linear, rolling = [], []
        for group in ("pre", "rem", "scan"):       # the reference's order
            for i, layer in enumerate(self.cache[group] or ()):
                for name, leaf in layer.items():
                    if name in ("k", "v"):
                        if leaf.shape[-3] == self.max_seq:
                            linear.append((group, i, name))
                        else:
                            rolling.append((group, i, name))
                    elif name in ("ckv", "kr") and leaf.shape[-2] == self.max_seq:
                        linear.append((group, i, name))
        return linear, rolling

    def _leaf(self, path) -> torch.Tensor:
        group, i, name = path
        return self.cache[group][i][name]

    def _slot_leaf(self, path, slot: int) -> torch.Tensor:
        leaf = self._leaf(path)
        return leaf[:, slot] if path[0] == "scan" else leaf[slot]

    def _kv_leaf_rows(self, path, slot: int, start: int, length: int):
        """(heads_batch, length, d) copy of cache rows [start, start+len)."""
        leaf = self._slot_leaf(path, slot)
        if path[2] in ("k", "v"):
            rows = leaf[..., start:start + length, :, :].movedim(-2, -3)
        else:                                      # ckv/kr: (..., S, d)
            rows = leaf[..., start:start + length, :][..., None, :, :]
        return rows.reshape((-1,) + tuple(rows.shape[-2:]))

    def _kv_leaf_rows_ring(self, path, slot: int, start: int, length: int):
        """(heads_batch, length, d) copy of a windowed leaf's rows for
        absolute positions [start, start+length): the cache ring holds
        position ``a`` in slot ``a % window`` (``transformer._ring_attend``)."""
        leaf = self._slot_leaf(path, slot)
        window = leaf.shape[-3]
        idx = torch.remainder(torch.arange(start, start + length,
                                           device=leaf.device), window)
        rows = leaf[..., idx, :, :].movedim(-2, -3)  # (..., KV, T, hd)
        return rows.reshape((-1,) + tuple(rows.shape[-2:]))

    def _slot_key(self, slot: int, j: int, col0: int = 0) -> tuple[int, int]:
        """Key words of slot ``slot``'s sketch of path ``j``: lattice point
        (slot, col0 + 2j / col0 + 2j+1) of the engine key on stream 7 (the
        port's stand-in for the reference's ``fold_in(fold_in(key, slot),
        j)``)."""
        k0, k1 = self._kv_key
        rows = torch.tensor([[slot]], dtype=torch.int64)
        cols = torch.tensor([[col0 + 2 * j, col0 + 2 * j + 1]],
                            dtype=torch.int64)
        words = _lattice.counter_bits(k0, k1, rows, cols, _SKETCH_KEY_STREAM)
        return tuple(int(w) for w in words[0].tolist())

    def _kv_roll_key(self, slot: int, j: int) -> tuple[int, int]:
        """Key words of slot ``slot``'s rolling sketch of ring path ``j``
        (the reference's ``fold_in(fold_in(fold_in(key, slot), 0x7011),
        j)``), on columns the linear keys never reach."""
        return self._slot_key(slot, j, _ROLL_COL_BASE)

    def _reset_slot_sketches(self, slot: int) -> None:
        sketches = {}
        for j, path in enumerate(self._kv_paths):
            rows = self._kv_leaf_rows(path, slot, 0, 1)
            sketches[path] = kv_compress.kv_sketch_init(
                self._slot_key(slot, j), rows.shape[0], rows.shape[-1],
                self.max_seq, self.kv_sketch_rank, device=self.device)
        for j, path in enumerate(self._kv_roll_paths):
            rows = self._kv_leaf_rows_ring(path, slot, 0, 1)
            window = self._slot_leaf(path, slot).shape[-3]
            sketches[path] = kv_compress.kv_rolling_init(
                self._kv_roll_key(slot, j), rows.shape[0], rows.shape[-1],
                window, self.kv_sketch_rank, device=self.device)
        self._kv_sketches[slot] = sketches
        # new tenant: drop any compressed-prefix state the slot carried
        if self.kv_fact is not None and self._kv_comp_len[slot]:
            for path in self._kv_swap_paths:
                self._store_factors(slot, path, None)
            self._kv_comp_len[slot] = 0

    def begin_slot(self, slot: int) -> None:
        """Complete per-slot reset for a new tenant: next write position
        back to 0, the slot's windowed ring rows and recurrent state
        zeroed, and — with
        sketching on — fresh sketch states (linear and rolling), cleared
        pending span, the contiguity watchdog rearmed and any factored
        prefix dropped.

        The ring zeroing is load-bearing: while a tenant's history is
        shorter than the window, the ring's unwritten slots sit at negative
        positions inside the window, so every windowed softmax includes
        them as zero rows (``transformer._ring_attend``); a reused slot
        must present the same zeros as a fresh one."""
        self.pos[slot] = 0
        for path in self._ring_paths:
            self._slot_leaf(path, slot).zero_()
        cache_mod.reset_slot_state(self.cache, slot)
        if self.kv_sketch_rank:
            self._reset_slot_sketches(slot)
            self._kv_pending[slot] = None
            self._kv_next_row[slot] = 0
            self._kv_contig[slot] = True

    def _append_slot_sketches(self, slot: int, start: int,
                              length: int) -> None:
        sk = self._kv_sketches[slot]
        for path in self._kv_paths:
            rows = self._kv_leaf_rows(path, slot, start, length)
            sk[path] = kv_compress.kv_sketch_append(sk[path], rows, start)
        if not self._kv_contig[slot]:
            # a gapped slot (the Engine's staggered admission) sees the
            # uniform clock fall below its high-water mark when longer
            # slots finish: its rolling sketches freeze at their last state
            # (the slot never compresses anyway)
            return
        for path in self._kv_roll_paths:
            # rows older than one window are already overwritten in the
            # cache ring: clamp the span to the trailing window
            end = start + length
            lo = max(start, end - sk[path].window)
            rows = self._kv_leaf_rows_ring(path, slot, lo, end - lo)
            sk[path] = kv_compress.kv_rolling_append(sk[path], rows, lo)

    def _note_kv_span(self, slot: int, start: int, length: int) -> None:
        """Record that cache rows [start, start+length) landed for ``slot``;
        flush the pending span through the sketch GEMMs once it is long
        enough (cache rows are append-only while a slot is live)."""
        if start != self._kv_next_row[slot]:
            self._kv_contig[slot] = False  # gap: rows skipped this slot
        self._kv_next_row[slot] = start + length
        pend = self._kv_pending[slot]
        if pend is None:
            self._kv_pending[slot] = [start, length]
        elif pend[0] + pend[1] == start:
            pend[1] += length
        else:                              # discontiguous: flush + restart
            self._flush_kv_pending(slot)
            self._kv_pending[slot] = [start, length]
        if self._kv_pending[slot][1] >= self._kv_flush_every:
            self._flush_kv_pending(slot)

    def _note_kv_row(self, slot: int, pos: int) -> None:
        self._note_kv_span(slot, pos, 1)

    def _flush_kv_pending(self, slot: int) -> None:
        pend = self._kv_pending[slot]
        if pend is None:
            return
        start, count = pend
        while count > 0:                   # the reference's chunking
            step = min(count, self._kv_flush_every)
            self._append_slot_sketches(slot, start, step)
            start += step
            count -= step
        self._kv_pending[slot] = None

    def kv_factors(self, slot: int) -> dict:
        """Rank-r FactoredKV per sketched cache leaf for ``slot``, finalized
        from the incrementally maintained sketches: full-context leaves
        against the slot's logical history (``_kv_hist``), windowed leaves
        for the current window (``_kv_ring_hist``)."""
        if self._kv_sketches[slot] is None:
            raise ValueError(f"slot {slot} has no sketch state (engine "
                             f"built without kv_sketch_rank, or slot never "
                             f"admitted)")
        self._flush_kv_pending(slot)
        sk = self._kv_sketches[slot]
        out = {path: kv_compress.kv_sketch_factor(
                   sk[path], self._kv_hist(slot, path), self.kv_sketch_rank)
               for path in self._kv_paths}
        for path in self._kv_roll_paths:
            out[path] = kv_compress.kv_rolling_factor(
                sk[path], self._kv_ring_hist(slot, path), self.kv_sketch_rank)
        return out

    # -- acting on the sketches: compress / swap / account -------------------
    def _kv_hist(self, slot: int, path) -> torch.Tensor:
        """(heads_batch, max_seq, d) f32 logical history: the live dense rows
        plus, once rows [0, comp_len) are swapped out (zeroed), the rank-r
        reconstruction of that prefix (``us`` rows >= comp_len are zero, so
        plain addition splices the two)."""
        hist = self._kv_leaf_rows(path, slot, 0, self.max_seq).float()
        if (self.kv_fact is not None and self._kv_comp_len[slot]
                and path in self._kv_swap_paths):
            f = self._load_factors(slot, path)
            hist = hist + f.us @ f.vt
        return hist

    def _kv_ring_hist(self, slot: int, path) -> torch.Tensor:
        """(heads_batch, window, d) window-ordered history of a windowed
        leaf, oldest live row first: what ``kv_rolling_factor`` expects."""
        sk = self._kv_sketches[slot][path]
        start = max(0, sk.rows_seen - sk.window)
        return self._kv_leaf_rows_ring(path, slot, start, sk.window)

    def _fact_leaves(self, path):
        group, i, name = path
        return self.kv_fact[group][i], f"{name}_us", f"{name}_vt"

    def _store_factors(self, slot: int, path,
                       f: Optional[kv_compress.FactoredKV]) -> None:
        """Write one path's head-batched factors into the slot's entries of
        the factored leaves (None -> zero them)."""
        tree, n_us, n_vt = self._fact_leaves(path)
        for name, src in ((n_us, None if f is None else f.us),
                          (n_vt, None if f is None else f.vt)):
            dst = tree[name][:, slot] if path[0] == "scan" else tree[name][slot]
            if src is None:
                dst.zero_()
            else:
                dst.copy_(src.reshape(dst.shape))

    def _load_factors(self, slot: int, path) -> kv_compress.FactoredKV:
        """(heads_batch, S, r) / (heads_batch, r, d) views of the slot's
        stored factors."""
        tree, n_us, n_vt = self._fact_leaves(path)
        us, vt = tree[n_us], tree[n_vt]
        us, vt = (us[:, slot], vt[:, slot]) if path[0] == "scan" else (
            us[slot], vt[slot])
        return kv_compress.FactoredKV(us.reshape((-1,) + tuple(us.shape[-2:])),
                                      vt.reshape((-1,) + tuple(vt.shape[-2:])))

    def compress_slot(self, slot: int) -> None:
        """Swap ``slot``'s dense rows [0, pos) for rank-r factors: finalize
        each full-context k/v leaf's factors from its sketch, store them,
        zero the dense rows, and advance ``comp_len``.

        Raises ValueError when there is nothing to compress — an engine
        without ``kv_compress_ratio``, a never-admitted slot, a history
        shorter than the sketch width p, a slot with no new dense tail since
        the last swap, or a gapped (non-contiguous) history."""
        if self.kv_fact is None:
            raise ValueError("engine built without kv_compress_ratio — "
                             "sketches are maintained but never acted on")
        if self._kv_sketches[slot] is None:
            raise ValueError(f"slot {slot} has no sketch state (never "
                             f"admitted)")
        self._flush_kv_pending(slot)
        pos = int(self.pos[slot])
        comp = int(self._kv_comp_len[slot])
        if pos - comp <= 0:
            raise ValueError(
                f"slot {slot} is already fully factored (comp_len == pos "
                f"== {pos}): re-compression needs newly appended dense-tail "
                f"rows")
        if pos < self._kv_min_rows:
            raise ValueError(
                f"slot {slot} has {pos} rows < sketch width "
                f"p={self._kv_min_rows}; compressing now would leave junk "
                f"in the factored rows beyond the history")
        if not self._kv_contig[slot]:
            raise ValueError(
                f"slot {slot} was admitted mid-stream: the uniform slot "
                f"clock wrote its decode rows beyond pos={pos}, so the "
                f"history has a gap the sketch never streamed — "
                f"compression requires an append-only contiguous history "
                f"(DESIGN.md §12.1)")
        facs = [kv_compress.kv_sketch_factor(
                    self._kv_sketches[slot][path], self._kv_hist(slot, path),
                    self.kv_sketch_rank) for path in self._kv_swap_paths]
        for path, f in zip(self._kv_swap_paths, facs):
            self._store_factors(slot, path, f)
        for path in self._kv_swap_paths:
            self._slot_leaf(path, slot)[..., :pos, :, :].zero_()
        self._kv_comp_len[slot] = pos

    def auto_compress(self, slot: int) -> None:
        """Fire the ``kv_compress_ratio`` trigger if the slot's dense tail
        has outgrown the threshold (no-op for gapped or too-short slots)."""
        if self.kv_fact is None or not self._kv_contig[slot]:
            return
        pos, comp = int(self.pos[slot]), int(self._kv_comp_len[slot])
        if pos - comp >= self._kv_threshold and pos >= self._kv_min_rows:
            self.compress_slot(slot)

    _maybe_compress = auto_compress

    def kv_slot_bytes(self, slot: int) -> dict:
        """Per-slot bytes over the swappable (full-context attention k/v)
        leaves: what a dense engine holds for this slot vs what the
        compressed representation needs (dense tail + f32 factors)."""
        pos = int(self.pos[slot])
        comp = int(self._kv_comp_len[slot])
        r = self.kv_sketch_rank or 0
        dense = held = 0
        for path in self._kv_swap_paths:
            leaf = self._leaf(path)
            lead = leaf.shape[0] if path[0] == "scan" else 1
            kv, hd = leaf.shape[-2], leaf.shape[-1]
            item = leaf.element_size()
            dense += lead * kv * pos * hd * item
            held += lead * kv * (pos - comp) * hd * item
            if comp:
                held += lead * kv * kv_compress.factor_bytes(comp, r, hd)
        return {"slot": slot, "pos": pos, "comp_len": comp,
                "dense_bytes": dense, "compressed_bytes": held,
                "ratio": (held / dense) if dense else 1.0}

    def kv_bytes_report(self) -> dict:
        per_slot = [self.kv_slot_bytes(s) for s in range(self.slots)]
        return {
            "slots": per_slot,
            "dense_bytes": sum(r["dense_bytes"] for r in per_slot),
            "compressed_bytes": sum(r["compressed_bytes"]
                                    for r in per_slot),
        }

    # -- prefill and decode ----------------------------------------------------
    def _slot_cache(self, slot: int) -> dict:
        """Views of one slot's batch row of every cache leaf."""
        def rows(layers, scan):
            return tuple({k: (v[:, slot:slot + 1] if scan else v[slot:slot + 1])
                          for k, v in layer.items()} for layer in layers)
        return {"pre": rows(self.cache["pre"], False),
                "scan": (rows(self.cache["scan"], True)
                         if self.cache["scan"] is not None else None),
                "rem": rows(self.cache["rem"], False)}

    def _prefill_slot(self, slot: int, tokens, start: int) -> torch.Tensor:
        """Run the chunk ``tokens`` through one serve step on ``slot``'s batch
        row: its k/v land in cache rows [start, start + len) in place and the
        chunk attends causally over the rows up to each token (an MoE pool
        whose capacity drops pairs runs ``_prefill_pool`` instead).  Returns
        the (vocab,) f32 logits after the last token."""
        if self._pool_prefill:
            return self._prefill_pool(slot, tokens, start)
        toks = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        logits, _ = self._chunk_serve(self.params, {
            "tokens": toks.reshape(1, -1), "cache": self._slot_cache(slot),
            "write_pos": start})
        return logits[0]

    def _prefill_pool(self, slot: int, tokens, start: int) -> torch.Tensor:
        """The reference's slot prefill: one serve step a token over the
        whole pool, the token broadcast to every slot, only ``slot``'s cache
        rows kept.  Returns ``slot``'s (vocab,) f32 logits after the last
        token."""
        mask = np.arange(self.slots) == slot
        for i, tok in enumerate(np.asarray(tokens, np.int64).tolist()):
            logits = self._masked_step({
                "tokens": torch.full((self.slots, 1), tok, device=self.device),
                "cache": self.cache, "write_pos": start + i}, mask)
        return logits[slot]

    def prefill_rows(self, slot: int, tokens, start: int) -> torch.Tensor:
        """Write cache rows [start, start + len(tokens)) for ``slot`` only
        and return the (vocab,) logits after the last token.  Advances the
        slot's ``pos`` and notes the rows with the sketch bookkeeping."""
        toks = np.asarray(tokens)
        if toks.ndim != 1 or toks.shape[0] == 0:
            raise ValueError(f"prefill_rows takes a non-empty 1-D token "
                             f"chunk, got shape {toks.shape}")
        if start + toks.shape[0] > self.max_seq:
            raise ValueError(f"prefill of {toks.shape[0]} rows at {start} "
                             f"overruns max_seq={self.max_seq}")
        logits = self._prefill_slot(slot, toks, start)
        self.pos[slot] = start + int(toks.shape[0])
        if self.kv_sketch_rank:
            self._note_kv_span(slot, start, int(toks.shape[0]))
        return logits

    def _seq_leaves(self):
        """(group, name, leaf) of every cache leaf with a seq axis: the
        attention k/v and the MLA latents ckv/kr."""
        for group in ("pre", "scan", "rem"):
            for layer in self.cache[group] or ():
                for name in ("k", "v", "ckv", "kr"):
                    if name in layer:
                        yield group, name, layer[name]

    def decode_logits(self, tokens, write_pos: int,
                      slot_mask=None) -> torch.Tensor:
        """One batched decode step over the pool at the uniform slot clock
        ``write_pos``.  Without ``slot_mask`` every slot's cache row lands
        at that position (Engine semantics); with a (slots,) bool mask only
        the masked slots' writes survive (the other slots' rows at
        ``write_pos`` are restored).  Returns (slots, vocab) f32 logits,
        device-resident (also kept as ``last_logits``)."""
        wp = int(write_pos)
        batch = {"tokens": torch.as_tensor(np.asarray(tokens, np.int64),
                                           device=self.device),
                 "cache": self.cache, "write_pos": wp}
        if self.kv_fact is not None:
            batch["kv_factors"] = self.kv_fact
            batch["comp_len"] = torch.as_tensor(self._kv_comp_len,
                                                device=self.device)
        if slot_mask is None:
            logits, _ = self._serve(self.params, batch)
        else:
            logits = self._masked_step(batch, slot_mask)
        self.last_logits = logits
        return logits

    def _state_leaves(self):
        """(group, leaf) of every recurrent-state leaf (h, conv, c, n)."""
        for group in ("pre", "scan", "rem"):
            for layer in self.cache[group] or ():
                for name, leaf in layer.items():
                    if name in cache_mod.STATE_LEAVES:
                        yield group, leaf

    def _masked_step(self, batch: dict, slot_mask) -> torch.Tensor:
        """One serve step over the pool at ``batch["write_pos"]`` whose cache
        writes survive only for the slots in the (slots,) bool mask: the
        other slots' rows at that clock are restored in every leaf with a
        seq axis, and their rows of every recurrent-state leaf whole (the
        reference masks every leaf)."""
        wp = batch["write_pos"]
        off_np = ~np.asarray(slot_mask, bool)
        off = torch.as_tensor(off_np, device=self.device)
        keep = [(group, name, leaf,
                 self._clock_rows(group, name, leaf, wp).clone())
                for group, name, leaf in self._seq_leaves()]
        idle = torch.as_tensor(np.flatnonzero(off_np), device=self.device)
        states = ([(leaf, int(group == "scan"),
                    leaf.index_select(int(group == "scan"), idle))
                   for group, leaf in self._state_leaves()]
                  if idle.numel() else [])
        logits, _ = self._serve(self.params, batch)
        for group, name, leaf, old in keep:
            rows = self._clock_rows(group, name, leaf, wp)
            lead = (1, -1) if group == "scan" else (-1,)
            rows.copy_(torch.where(
                off.reshape(lead + (1,) * (rows.ndim - len(lead))), old, rows))
        for leaf, axis, old in states:
            leaf.index_copy_(axis, idle, old)
        return logits

    @staticmethod
    def _clock_rows(group: str, name: str, leaf: torch.Tensor,
                    wp: int) -> torch.Tensor:
        """View of every slot's row at clock ``wp`` of a seq leaf: row
        ``wp`` of a full-context k/v leaf or of an MLA latent (seq axis -2,
        not -3), ring slot ``wp % window`` of a windowed k/v leaf (a live
        row of the masked-out slots there, which the masked decode must
        restore)."""
        row = wp % leaf.shape[-2 if name in ("ckv", "kr") else -3]
        return leaf[:, :, row] if group == "scan" else leaf[:, row]

    def sample(self, logits: torch.Tensor) -> np.ndarray:
        """(slots, vocab) logits -> (slots,) token ids: greedy at
        temperature 0, else a draw from the engine's torch.Generator."""
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.cpu().numpy()
