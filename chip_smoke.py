#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and ``nvcc``
(about 1000 s on an H100, the build included).
It imports only ``repro_torch``, torch, numpy and the standard library, and
exits non-zero at the first failed check.  Phases, each printing its lines:

1. setup: the card (``nvidia-smi`` name and power limit), TF32 off, the
   kernel build (``src/repro_torch/kernels/_build/``, one ``nvcc`` per
   source, all started together) and its time;
2. kernels vs their plain PyTorch versions at the main path's shapes
   (rSVD 4096x4096 @ .x266, RP-HOSVD 256x65536 @ .x32): both kernels, the
   on-chip Omega bit check, kernel 2 == kernel 1 on kernel 2's own Omega
   bit for bit (planner's split count and one split), bit identity across
   blocks and across each kernel's (bm, bn, splits) with each plan timed
   (the ``[plans]`` lines), the f64-oracle accuracy ladder;
3. the main path at the paper's sizes (rSVD n=4096 rank 256 on A_exp and
   A_linear, RP-HOSVD and RP-ST-HOSVD on 256^3 with ranks 32^3) through
   every method, with the reference's error limits and the kernels' launch
   and split-K reduction counts;
4. timings (median over CUDA events, and device time from torch.profiler,
   each with the launches its trace held beside the launches the calls made):
   kernels 1 and 2 under the plans the main path launches
   (``autotune.pick_blocks``: the shipped cache, else the planners
   ``ops.shgemm_plan`` and ``ops.fused_plan``, which are timed too where
   they differ) at rSVD's shape and the three RP-ST-HOSVD mode shapes, each
   beside its plain version, the f32 ``torch.matmul`` of the
   same product (``library_ms``) and the least time the card could take
   (``bound_ms``); end-to-end rSVD
   and RP-HOSVD per method (methods in turns), and a torch.profiler
   breakdown of one call of each;
5. kernels 3-4 vs their plain versions: flash attention at qwen3-0.6b's
   prefill shape (1, 32768, 16|8, 128) bf16, a ragged S and f32; factored
   decode at the engine's shape (8, 2048, 8, 128), r = 32, comp_len mixed,
   write_pos mid-cache, garbage past it, NaN factors where comp_len = 0, and
   at the full slot (write_pos 2047, comp_len up to 1984); write_pos as an
   int32 on the card bit-equal to the int, two calls bit-equal; and at
   gemma2-2b's engine shape (8, 8192, 4, 256), G 2, r = 32, softcap 50,
   early (write_pos 4700) and at the full slot;
6. prefill at full width (28 layers, random weights from a seed; batch cut
   from 32 to 1): ``make_prefill_step`` with kernel 3 vs the plain
   attention, then grow_cache + one decode step vs a full forward, in bf16
   activations (counted, timed) and in f32 activations (the first 8
   layers);
7. the engine at full width (8 slots x 2048, rank-32 sketches swapping
   every 64 rows, 8 prompts of 128 tokens, 96 new): kernel vs plain
   engines in teacher-forced lockstep in bf16 (kernel 4's launches
   counted) and in f32 (its first 8 layers), then the bf16 kernel engine
   alone (tokens/s, decode step, peak memory, one traced decode step, one
   traced swap);
8. timings of kernels 3-4: kernel, plain version, bound and library call
   (``scaled_dot_product_attention`` for flash; none exists for factored
   decode); kernel 4 at the engine's final state and at the full slot, by
   CUDA events around one call, a launch replayed from a CUDA graph (L2
   warm and evicted) and the profiler's device time, beside an empty
   launch's time, with the wrapper's host time a call and a sweep of its
   split count P (the ``[plans] kernel 4`` lines: the planner's P must be
   within 10 % of the best graph time);
9. the streamed and structured main path at the paper's sizes: kernels 1-2
   against their plain versions at the streamed shapes (row tiles, widen at
   ``col_offset``, the left sketch at ``row_offset`` on and off the ``bk``
   grid); A_exp streamed in 256- and 320-row tiles from host memory through
   the pinned prefetch, Y equal to the one-shot kernel-2 sketch and the
   widened sketch equal to a fresh one, bit for bit, W against its plain
   version; ``rsvd_streamed`` on A_exp and A_linear through kernels 2 and 1
   (passes 2, 4, 1 and adaptive, each against the reference's limit); a
   1 GiB rank-256 + noise matrix written with ``np.save`` and streamed back
   through ``MemmapSource`` (peak device memory below A/4, singular values
   against the resident rSVD, GB/s a pass, device busy share); SRHT against
   its dense oracle with no GEMM in its trace, timed beside kernel 2;
   Khatri-Rao RP-HOSVD and streamed Tucker on 256^3; kernels 1-2's launches
   on the streamed path; streamed against resident timings;
10. checkpointed, resumed and elastic jobs (``stream.resilience``): the
   checkpointed ``rsvd_streamed`` bit for bit against the plain one (kernels
   2 and 1, passes 2 and 4) with its wall-time ratio; a raised fault in the
   sketch, B and power passes, each resumed bit for bit; the 1 GiB matrix
   of phase 9 streamed by a child process that SIGKILLs itself at tile 150
   and resumed here bit for bit (time to recover, goodput); the same matrix
   as 4096-row shards behind ``ObjectStoreSource`` with 2 % of its range
   reads failing and retried, bit for bit (GB/s a pass); the elastic
   rSVD losing one of four hosts bit for bit against the full fleet; a
   streamed Tucker resumed after a fault bit for bit; kernel 2's launches;
11. the autotuner and distributed RandNLA: (11a) the shipped autotune entries
   served on the card, ``autotune_blocks`` for kernels 1-2 at rSVD's and
   RP-HOSVD's shapes and ``autotune_decode_block`` at the engine's state,
   each tuned plan bit for bit against the planner's (kernel 4 against its
   plain version), timed beside it, a second call a cache hit that times
   nothing; (11b) a 2 x 2 (data, model) gloo world of four processes on the
   one card (``launch.world.run_world``): ``distributed_rsvd`` through
   kernels 1 and 2 on A_exp against phase 3's limit and the one-process
   singular values, the range finder's Q^T Q, power iterations on A_linear
   against the Eckart-Young floor, kernel 2 at each rank's Omega row offset
   against its plain version, ``merge_across_hosts`` bit for bit against the
   one-process sketch; then ``distributed_rsvd_streamed`` over four sources
   of phase 9's matrix, its merged sketch bit for bit against
   ``rsvd_streamed``'s and resumed after a fault bit for bit.

12. training with the paper's RandNLA optimizers at qwen3-0.6b's full width:
   (12a) kernels 2 and 1 against their plain versions at GaLore's refresh
   shape (151936x1024 @ .x72) and kernel 1 at compression's (1024x151936 @
   .x32, A transposed), each timed beside its plain version, the f32
   matmul and its bound, with the compression basis's draw and QR and the
   transposed copy timed apart; (12b) six steps of the full 28-layer model
   on SyntheticLM at seq 1024 x batch 8 (micro_batches=2) with AdamW, GaLore
   through kernels 2 and 1 and in f32 (rank 64, refreshes at steps 1, 3,
   5) and AdamW after compress_and_reduce (kernel 1 on Q): losses finite,
   step, optimizer and refresh times, a traced step's kernel device time,
   peak memory, state bytes; the projection-error, compression and
   microbatch gates on the step-1 embedding gradient; (12c) ``train`` with
   GaLore on 4 layers in a deterministic child: checkpoints every 2 steps,
   a resume bit for bit against the uninterrupted run, a step raising once
   retried bit for bit, no retry in the clean runs; (12d) compression over
   a two-rank gloo group on the card against the mean of the ranks'
   single-process results.
13. open-loop serving through the continuous-batching scheduler
   (``launch.serve.run_scheduler``) at full width and depth, random bf16
   weights from a seed: (13a) qwen3-0.6b, 8 slots x 2048, rank-32 sketches
   swapping every 64 rows, prefill chunks of 256, a seeded Poisson trace of
   16 requests at 200 req/s (virtual clock), through kernel 4 and through
   the plain path on the first 4 layers (the virtual-clock SLO summaries
   must be equal, the HBM gauge in proportion to the swappable layers),
   then on the first 4 layers under an hbm_budget that admits 4 streams;
   (13b) gemma2-2b, 8 slots x 8192 (its local layers 4096-row rings that
   wrap, with rolling sketches;
   its 13 global layers decode through kernel 4 at head_dim 256, G 2,
   softcap 50), chunks of 512, 8 requests with half their prompts past
   4096: wall tokens/s and drain time, the median decode step, one traced
   decode step, peak memory, virtual-clock p50/p99 TTFT, TPOT and latency;
   every request accounted; one request of each replayed in lockstep,
   kernel path vs plain, to the bf16 logits gate with equal comp_len; one
   traced gemma2 ``compress_slot``; kernel 4 timed at gemma2's shape;
   (13c) ``stream.rolling_*`` through kernel 2 on a (4096 + 1000, 256)
   stream, the finalized sketch equal to the fresh sketch of the last
   window bit for bit.
14. routed-MoE serving, qwen3-moe-30b-a3b at full width and depth (48
   layers, 128 experts top-8; random weights from a seed drawn straight
   into bf16, the router f32: 61 GB), after the earlier phases' models are
   freed: (14a) a (1, 4096) ``make_prefill_step`` with kernel 3 (48
   launches) and with the plain attention, held to the bf16 gate, peak
   memory; (14b) grow_cache + one decode step against a full forward over
   4097 (the reference's 0.15, correlation > 0.99); (14c) a 1024-token
   prompt through ``prefill_rows`` in one chunk and in chunks of 128 (8
   slots: dropless), held to the bf16 gate; (14d) the kernel and plain
   engines in bf16 lockstep (8 slots x 2048, rank-32 sketches, 8 prompts
   of 256, 64 new), kernel 4's launches = steps x 48, equal comp_len, the
   share of (token, layer) routed expert sets both paths chose alike;
   kernel 4 against its plain version at 14d's final state and timed
   there, kernel 3 against its plain version at (1, 4096, 32|4, 128) and
   timed beside SDPA and its bound; (14e) the scheduler on the kernel path
   over a seeded trace of 8 requests, every request accounted, the
   virtual-clock SLOs; the phase within 240 s.
15. MLA serving, deepseek-v2-lite-16b at full width and depth (27 layers: a
   dense-MLP MLA prelude, then 26 MLA + MoE; kv_lora 512, rope 64; 64
   experts top-6 + 2 shared; random weights from a seed drawn straight into
   bf16, the router f32: 31.4 GB), after phase 14's model is freed: (15a) a
   (1, 4096) ``make_prefill_step`` (MLA materialized, no kernel 3 launch),
   two calls, peak memory; (15b) grow_cache + one absorbed-latent decode
   step against a full forward over 4097 (0.15, correlation > 0.99); (15c)
   a 1024-token prompt through ``prefill_rows`` in one chunk and in chunks
   of 128 and its first 128 tokens one at a time (8 slots: dropless), held
   to the bf16 gate, then a 64-token prompt through the 16-slot pool's
   ``_prefill_pool`` with another slot's live latent rows kept bit for bit;
   (15d) the scheduler, 8 slots x 4096 with rank-32 latent sketches and no
   swaps, a seeded trace of 8 requests: every request accounted, sketch
   high-water == pos, the virtual-clock SLOs, one traced decode step, the
   latents' bytes against dense K/V, ``kv_compress_ratio=2`` refused; (15e)
   the serve CLI's engine path (``run_engine``); (15f) one drained slot's
   latents streamed through kernel 2 (``kv_sketch_init(method=
   "shgemm_fused")``) in 16-row flushes, bit for bit its one-shot sketch,
   against the plain version, timed; the phase within 150 s.
16. the recurrent mixers at full width and depth, random bf16 weights from a
   seed, after phase 15's model is freed: recurrentgemma-2b (26 layers:
   RG-LRU, RG-LRU, local attention of window 2048; 5.79 GB): (16a) a (1,
   8192) ``make_prefill_step`` (the rings wrap four times), two calls, peak
   memory, one decode step on its cache against a full forward over 8193
   (0.15, correlation > 0.99), a 1024-token prompt through ``prefill_rows``
   in one chunk and in chunks of 256 and its first 128 tokens one at a time
   (the bf16 gate), the f32 first period (R, R, A) on 1024 tokens on the
   card against the CPU; (16b) the scheduler, 8 slots x 8192 with rank-32
   rolling sketches, 10 requests at 200 req/s (virtual), two past the
   window, chunks of 512: every request accounted, and each request of a
   reused slot's calls replayed in a fresh pool within the bf16 gate;
   (16e) a drained slot's window on one local layer (2048 x 256) streamed
   through kernel 2's rolling sketch in 16-row flushes, bit for bit the
   one-shot sketch, against the plain version, timed; then xlstm-350m (24
   layers: 7 mLSTM + 1 sLSTM; 1.04 GB): (16c) a (1, 4096) prefill, one
   sLSTM layer's time loop timed on 1024 tokens, grow_cache + one decode
   step against a
   full forward, the chunked and token-by-token prefill, the f32 first
   period (7 mLSTM + sLSTM) on 512 tokens against the CPU, and an engine of
   8 slots x 2048 with 10 staggered prompts of 256 (slots reused after idle
   decode steps), each request's greedy tokens equal to its lone run; (16d)
   a long_500k decode step of each model on a cache built for 524288 rows
   (its bytes == ``cache_bytes``) beside the same step at write_pos 4095;
   the phase within 150 s.
17. enc-dec and VLM serving at full width and depth, random weights from a
   seed drawn straight into bf16, after phase 16's models are freed:
   whisper-large-v3 (a 32-layer bidirectional encoder over 1500 frame
   embeddings, 32 decoder layers with cross-attention, 20 heads of 64; 3.91
   GB): (17a) the encoder on 8 utterances timed, a teacher-forced (8, 448)
   ``make_prefill_step`` with kernel 3 (32 launches, G 1) and with the
   plain attention, held to the bf16 gate, then a 224-token prefill,
   grow_cache and 32 decode steps, each against a full forward (0.15,
   correlation > 0.99); llava-next-34b (60 layers, d_model 7168, 56|8
   heads of 128; 68.88 GB): (17b) a (1, 576 image rows + 3520 tokens)
   prefill with kernel 3 (60 launches, G 7) and plain, the bf16 gate;
   layer 0's K history streamed through kernel 2's sketch in 16-row
   flushes, bit for bit its one-shot sketch; grow_cache and 16 decode
   steps against full forwards; the kernel and plain engines in text-only
   bf16 lockstep (4 slots x 2048, rank-32 sketches swapping every 64 rows,
   4 prompts of 128, 64 new; kernel 4 at G 7), then kernel 4 at the final
   state against its plain version, timed by events, graph and profiler;
   (17c) kernel 3 alone at (1, 4096, 56|8, 128) and (8, 448, 20|20, 64)
   against its plain version, by CUDA events and a CUDA-graph replay,
   beside SDPA and its bound; the phase within 200 s.
18. training and serving across processes, in gloo worlds of local
   processes on the one card (``launch.world.run_world``; no scaling
   claimed): (18a) qwen3-0.6b at full width and depth, f32 masters drawn as
   each rank's slices, AdamW, seq 1024 x global batch 8, in a (data 2 x
   model 2) world against one process on the same batches and weights:
   the step-1 loss (rtol 2e-5) and every gathered gradient (max-norm
   relative 2e-2), the losses of steps 2-3, each rank's state bytes, step
   ms and bytes handed to collectives; a collective checkpoint at step 2
   restored bit for bit in one process and in a (1 x 2) world; ``remesh``
   onto ranks 0-1 and back bit for bit; ``launch.train.main`` with
   ``--model-parallel 2`` in the world; (18b) qwen3-moe-30b-a3b at full
   width and depth in a (data 1 x model 2) world (64 experts and half the
   vocab a rank, kernel 3 on): each rank's weights checksummed against its
   block of phase 14's, 48 launches a rank, the prefill's logits against
   14a's kernel-path logits at the bf16 gate, routed sets alike, peak
   memory, prefill and all-reduce ms; the phase within 300 s.
19. the cell machinery and the dry run: (19a) every arch's SMOKE config
   (``configs/<arch>.py``) through ``materialize_inputs`` + ``step_for`` on
   the card, tests/test_arch_smoke.py's gates: a train step (finite loss,
   params moved), five at lr 3e-3 (loss down), a (2, 32) prefill with
   kernel 3 where the layer routes to it (12 launches in all) against the
   plain one at the bf16 gate, a (2, 16) decode step, prefill + one decode
   against a full forward (0.15, correlation > 0.99); (19b) the dry run
   (``launch/dryrun.py``) of qwen3-0.6b's (1, 4096) prefill at full width
   and depth on a (1, 1) mesh against the same step on the card: argument
   bytes equal to the card's tensors and the allocator's requested bytes,
   matmul FLOPs within 1 % of the profiler's, peak within 15 % of
   ``max_memory_allocated()``'s growth; then that prefill with kernel 3 (28
   launches) at the bf16 gate; (19c) the dry run's CLI on xlstm-350m x
   decode_32k and command-r-plus-104b x train_4k on the 16x16 mesh
   (subprocesses started before phase 17, each within 300 s): the rows'
   schema, their FLOPs, collective bytes and bytes a rank against 80 GB
   printed; ``compression_dryrun``'s wire ratio of 128; the phase within
   120 s.

Phases 1-10 run against an empty user autotune cache in a temporary file
(``$REPRO_TORCH_AUTOTUNE_CACHE``), so the plans they launch are the shipped
cache's (``src/repro_torch/kernels/autotune_default.json``) or the planners'.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): device memory rate, bf16/fp16 tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_TC_FLOP_PER_S = 989e12

RSVD_SHAPE = (4096, 4096, 266)     # A (m, k) @ Omega (k, p_hat = 256 + 10)
HOSVD_SHAPE = (256, 65536, 32)     # mode-0 unfolding of 256^3 @ (65536, 32)
# RP-ST-HOSVD's three mode projections of 256^3 at ranks 32^3: K shrinks
# as each mode is truncated.
STHOSVD_SHAPES = ((256, 65536, 32), (256, 8192, 32), (256, 1024, 32))
# Kernel 1's (bm, bn, splits) held bit-identical to the planner's and timed
# (the sweep that chose ``ops.shgemm_plan``'s tile at rSVD).
SHGEMM_PLANS = {"rsvd": ((128, 32, 1), (128, 32, 2), (128, 32, 4), (256, 32, 1),
                         (256, 32, 4), (256, 32, 8), (128, 64, 1), (128, 64, 4),
                         (64, 64, 1), (64, 32, 1), (32, 64, 1)),
                "hosvd": ((128, 32, 128), (128, 32, 256), (128, 32, 64),
                          (256, 32, 256), (256, 32, 128), (128, 64, 256),
                          (64, 32, 64), (32, 32, 256))}
# Kernel 2's (bm, bn, splits) held bit-identical to the planner's and timed.
FUSED_PLANS = {"rsvd": ((256, 32, 1), (256, 32, 2), (256, 32, 4), (128, 64, 1),
                        (128, 32, 1), (128, 32, 2), (64, 64, 1), (64, 32, 1),
                        (64, 64, 4), (32, 32, 1)),
               "hosvd": ((256, 32, 256), (256, 32, 128), (256, 32, 32),
                         (128, 64, 256), (128, 32, 128), (64, 32, 64),
                         (32, 32, 256))}
REPS = 3
E2E_REPS = 11


# Serving slice (qwen3-0.6b at full width).  Prefill: prefill_32k's
# sequence, batch cut from 32 to 1 (32 x 32768 tokens of activations and a
# 120 GB cache do not fit one card).  Engine: 8 slots x 2048 rows, rank-32
# KV sketches swapping every 64 rows, 8 prompts of 128 tokens, 96 new each.
ARCH = "qwen3-0.6b"
PREFILL_SEQ = 32768
RAGGED_SEQ = 4000
ENGINE_KW = dict(slots=8, max_seq=2048, kv_sketch_rank=32, kv_compress_ratio=2.0)
ENGINE_REQUESTS, PROMPT_LEN, MAX_NEW = 8, 128, 96
# The f32 passes of phases 6 and 7 (the reference's tolerances) run the
# first 8 of the 28 layers, to make room for phase 13; the bf16 passes, the
# main path, keep all 28.
F32_LAYERS = 8


def first_layers(cfg, params: dict, n: int):
    """``cfg`` and ``params`` cut to the first ``n`` layers of the stack."""
    return (cfg.with_(n_layers=n),
            {k: (w[:n] if k.startswith("layers/") else w) for k, w in params.items()})
SERVE_TOL = 1e-1          # max |d logit| kernel vs plain engine (DESIGN §12)
BF16_EXCESS = 16          # bf16 logits: ulps at the median |logit| (logits_agree)
PEAK_F32_FLOP_PER_S = 67e12   # H100 SXM f32 outside the tensor cores
TIMING_REPS = 20          # for the sub-millisecond decode kernel
STREAM_REPS = 5           # phase 9's end-to-end timings
# Kernel 4's split counts timed beside the planner's (the [plans] sweep).
FDEC_SPLITS = (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64)


class CheckFailed(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def interleaved_host_ms(torch, calls: dict, reps: int) -> dict:
    """Median wall time of each call, ending in a synchronize; the calls run
    in turns (one of each per round, after one warm-up round) so that drift
    of the card or host falls on all of them alike."""
    times = {name: [] for name in calls}
    for rnd in range(reps + 1):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if rnd:
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: sorted(v)[len(v) // 2] for name, v in times.items()}


def ptxas_usage(log: str) -> list[tuple[str, str]]:
    """(kernel, "registers ...; spills ...") for each entry function of an
    ``nvcc -Xptxas -v`` log, names demangled by ``c++filt`` where the host
    has it."""
    rows, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            rows.append([name, line.split(":", 1)[-1].strip() + "; " + spill])
    try:
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout
        names = out.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = re.sub(r"\(.*\)$", "", n.replace("(anonymous namespace)::", ""))
    except (OSError, subprocess.SubprocessError):
        pass
    return [tuple(r) for r in rows]


def device_ms(torch, fn, reps: int = REPS) -> tuple[float | None, int, int]:
    """Device time of one call of ``fn`` (torch.profiler), with the launches
    behind it: (ms, launches the trace of ``reps`` calls holds, launches
    ``reps`` calls make).  A call's launches of each kernel are counted on
    one call traced alone; each kernel's mean device time a launch comes
    from the ``reps`` calls traced after it, over the launches that trace
    holds (late in a long run the profiler keeps only some short launches,
    so dividing by ``reps`` would understate); ms sums count x mean over the
    kernels.  None where a kernel of the call is missing from the trace.
    Unlike ``median_ms`` it excludes the host's launch overhead, which sets
    the CUDA-event time of calls shorter than it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(n: int) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return {ev.key: (ev.count, ev.self_device_time_total)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.count}
    fn()
    per_call, traced = trace(1), trace(reps)
    held = sum(traced.get(k, (0, 0))[0] for k in per_call)
    expected = reps * sum(c for c, _ in per_call.values())
    if not per_call or any(traced.get(k, (0, 0))[1] <= 0 for k in per_call):
        return None, held, expected
    ms = sum(c * traced[k][1] / traced[k][0] for k, (c, _) in per_call.items())
    return ms / 1e3, held, expected


def fmt_dev(d: tuple) -> str:
    """A ``device_ms`` result as "ms (held/expected launches)"."""
    return f"{fmt_ms(d[0])} ({d[1]}/{d[2]} launches traced)"


def kernel_ms(torch, fn, match: str, reps: int = REPS) -> tuple[float | None, int]:
    """Device time of one launch of the kernel whose name holds ``match``
    (one a call of ``fn``): the mean over the launches the torch.profiler
    trace holds, with their count.  Late in a long run the trace of short
    back-to-back launches has held only some of them, so dividing by
    ``reps`` would understate the time; None where it holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA and match in ev.key]
    count = sum(ev.count for ev in evs)
    total = sum(ev.self_device_time_total for ev in evs)
    return (total / 1e3 / count if count and total > 0 else None), count


def graph_ms(torch, fn, n: int = TIMING_REPS, reps: int = 5) -> float:
    """Time of one call of ``fn`` replayed ``n`` times back to back from one
    CUDA graph (CUDA events around the replay, median of ``reps``): device
    time with the graph's launch gaps, no host in between and no profiler.
    ``fn`` runs twice on the capture stream first, so that it allocates
    nothing new while captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return sorted(times)[len(times) // 2]


def fmt_ms(t: float | None) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def device_breakdown(torch, fn):
    """One traced call: wall ms, summed device-kernel ms, and every kernel
    with its device ms, the longest first (torch.profiler).  Only device
    events count: an operator's own device time repeats that of its
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key[:40], ev.self_device_time_total / 1e3)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, sum(v for _, v in rows), rows


def bound_ms(m: int, k: int, n: int, terms: int, omega_bytes: int) -> tuple[float, str]:
    """Least time for C = A @ Omega: A read once, Omega read once (0 when
    fused), C written once, over the memory rate; ``terms`` tensor-core
    products over the bf16/fp16 peak.  The larger one, and which it is."""
    t_bytes = (m * k * 4 + omega_bytes + m * n * 4) / PEAK_BYTES_PER_S
    t_ops = 2.0 * m * n * k * terms / PEAK_TC_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def lowp_ulp(torch, x, dtype):
    """One unit in the last place of ``dtype`` at |x| (normal range)."""
    mant = 7 if dtype == torch.bfloat16 else 10
    tiny = torch.finfo(dtype).tiny
    mag = torch.clamp(x.abs(), min=tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - mant)


# Flash attention's output row (one query row of one head) held to
# ||kernel - plain|| / ||plain|| per row, the largest over all rows.  With
# randn q/k/v an output element at position p is ~sqrt(e / p) in size (0.01
# at 32k), below atol; this gate scales with it.  bf16 rounding of P and of
# the output (2^-9 relative each) keeps a sound row well under 1 %; a
# dropped or repeated 32-key tile moves the rows just past it by several %
# at 32k and by O(1) near the start.
FLASH_ROW_REL = {"bfloat16": 1e-2, "float32": 1e-3}


def row_rel_err(got, want) -> float:
    """Largest ||got - want|| / ||want|| over the rows of the last axis."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30)).max().item()


def fdec_inputs(torch, gen, *, b, s, h, kvh, hd, r, comp, wp, dtype):
    """A factored-decode state honoring the cache contract (us rows >=
    comp_len zero, dense rows < comp_len zero) with garbage past wp."""
    dev = gen.device

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    comp_t = torch.tensor(comp, dtype=torch.int32, device=dev)
    pre = torch.arange(s, device=dev)[None, :] < comp_t[:, None].long()
    us_k = rn(b, kvh, s, r) * pre[:, None, :, None]
    us_v = rn(b, kvh, s, r) * pre[:, None, :, None]
    kd = rn(b, s, kvh, hd).masked_fill(pre[..., None, None], 0.0).to(dtype)
    vd = rn(b, s, kvh, hd).masked_fill(pre[..., None, None], 0.0).to(dtype)
    return (rn(b, 1, h, hd).to(dtype), kd, vd, us_k, rn(b, kvh, r, hd), us_v,
            rn(b, kvh, r, hd), comp_t)


def phase5_kernels(torch, gen, cfg) -> dict:
    """Kernels 3-4 against their plain versions at the path's shapes."""
    from repro_torch.kernels import factored_decode as k4
    from repro_torch.kernels import flash_attention as k3
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    errs = {}
    for label, s, dt, tol in (("prefill", PREFILL_SEQ, torch.bfloat16, (2e-2, 3e-2)),
                              ("ragged", RAGGED_SEQ, torch.bfloat16, (2e-2, 3e-2)),
                              ("f32", 1000, torch.float32, (1e-4, 1e-4))):
        q, k, v = (torch.randn((1, s, n, hd), generator=gen, device=gen.device).to(dt)
                   for n in (h, kvh, kvh))
        got = k3.flash_attention(q, k, v, causal=True)
        want = k3.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel, bound = row_rel_err(got, want), FLASH_ROW_REL[str(dt)[6:]]
        print(f"[kernels] flash_attention {label} (1, {s}, {h}|{kvh}, {hd}) "
              f"{str(dt)[6:]} causal: max|kernel-plain| {err:.3e} "
              f"(rtol {tol[0]}, atol {tol[1]}); largest row "
              f"||kernel-plain||/||plain|| {rel:.3e} (bound {bound})")
        check(torch.allclose(got.float(), want.float(), rtol=tol[0], atol=tol[1]),
              f"flash_attention {label} disagrees with plain")
        check(rel <= bound, f"flash_attention {label}: a row is off by {rel:.3e} "
              f"of its norm (bound {bound})")
        errs[("flash", label)] = err
        del q, k, v, got, want
    s, r, b = ENGINE_KW["max_seq"], ENGINE_KW["kv_sketch_rank"], ENGINE_KW["slots"]
    plan = k4.decode_plan(b, kvh, s, hd, r, h // kvh)
    print(f"[kernels] factored_decode plan at ({b}, {s}, {kvh}, {hd}) r={r}: "
          f"{plan.splits} splits on a {plan.grain}-row grain, grid "
          f"({plan.splits}, {b * kvh}), {plan.smem} B shared memory a block, "
          f"workspace {plan.workspace * 4} B (no write_pos enters)")
    wp = min(1000, s // 2)                     # mid-cache, garbage past it
    comp = ((0, wp + 1, wp * 5 // 8, 0, wp + 1, wp // 4, wp * 9 // 10, 1)
            * b)[:b]                           # none / all / partial
    # The full slot: every row live, comp_len mixed up to 1984 (the last
    # swap of a 2048-row slot at 64-row swaps).
    full = (1984, 0, 1024, 1984, 64, 1920, 1984, 1)
    # f32 at 1e-4: 1001- and 2048-row sums in another order than the
    # einsums' (the reference's 1e-5 holds at its test shapes:
    # tests/test_torch_cuda.py)
    for label, cwp, ccomp, dt, tol in (
            ("bf16", wp, comp, torch.bfloat16, 1e-2),
            ("f32", wp, comp, torch.float32, 1e-4),
            ("full bf16", s - 1, full, torch.bfloat16, 1e-2),
            ("full f32", s - 1, full, torch.float32, 1e-4)):
        args = fdec_inputs(torch, gen, b=b, s=s, h=h, kvh=kvh, hd=hd, r=r,
                           comp=ccomp, wp=cwp, dtype=dt)
        got = k4.factored_decode_attention(*args, cwp, scale=hd ** -0.5)
        want = k4.factored_decode_plain(*args, cwp, scale=hd ** -0.5)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"[kernels] factored_decode {label} ({b}, {s}, {kvh}, {hd}) r={r} "
              f"write_pos={cwp} comp_len={list(ccomp)}: "
              f"max|kernel-plain| {err:.3e} (tol {tol})")
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"factored_decode {label} disagrees with plain")
        errs[("fdec", label)] = err
        if label == "bf16":
            # the clock as an int32 on the card, read by the kernel: the
            # same bits; and a second call gives the same bits again
            clock = torch.tensor([cwp], dtype=torch.int32, device=gen.device)
            by_tensor = k4.factored_decode_attention(*args, clock, scale=hd ** -0.5)
            again = k4.factored_decode_attention(*args, cwp, scale=hd ** -0.5)
            check(torch.equal(by_tensor, got),
                  "factored_decode: write_pos on the card != the int's bits")
            check(torch.equal(again, got), "factored_decode: two calls differ")
            print("[kernels] factored_decode bf16: write_pos as an int32 on the "
                  "card == the int path, and two calls, bit for bit")
    # gemma2-2b's global layers in phase 13b's engine: 8 slots x 8192 rows,
    # 4 kv heads of 256 (G = 2), r = 32, the attention softcap 50; early in
    # the slot (garbage past write_pos) and at the full slot
    from repro_torch.models import registry as R
    g2 = R.get_arch("gemma2-2b")
    gb, gs = SCHED_CELLS["13b"]["model"]["slots"], SCHED_CELLS["13b"]["model"]["max_seq"]
    gh, gkv, ghd, gcap = g2.n_heads, g2.n_kv_heads, g2.head_dim, g2.attn_softcap
    plan = k4.decode_plan(gb, gkv, gs, ghd, r, gh // gkv)
    print(f"[kernels] factored_decode plan at gemma2's ({gb}, {gs}, {gkv}, {ghd}) G "
          f"{gh // gkv} r={r}: {plan.splits} splits on a {plan.grain}-row grain, "
          f"{plan.smem} B shared memory a block, workspace {plan.workspace * 4} B")
    for label, cwp, ccomp in (
            ("gemma2 early bf16", 4700, (0, 4701, 4608, 1024, 0, 64, 4672, 1)),
            ("gemma2 full bf16", gs - 1, (8128, 0, 4096, 8128, 64, 8064, 8192, 1))):
        args = fdec_inputs(torch, gen, b=gb, s=gs, h=gh, kvh=gkv, hd=ghd, r=r,
                           comp=ccomp, wp=cwp, dtype=torch.bfloat16)
        got = k4.factored_decode_attention(*args, cwp, scale=ghd ** -0.5, cap=gcap)
        want = k4.factored_decode_plain(*args, cwp, scale=ghd ** -0.5, cap=gcap)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"[kernels] factored_decode {label} ({gb}, {gs}, {gkv}, {ghd}) G "
              f"{gh // gkv} r={r} cap {gcap} write_pos={cwp} comp_len={list(ccomp)}: "
              f"max|kernel-plain| {err:.3e} (tol 1e-2)")
        check(torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2),
              f"factored_decode {label} disagrees with plain")
        errs[("fdec", label)] = err
        del args, got, want
    # comp_len == 0 everywhere: NaN factors must change no bit
    args = list(fdec_inputs(torch, gen, b=b, s=s, h=h, kvh=kvh, hd=hd, r=r,
                            comp=(0,) * b, wp=wp, dtype=torch.bfloat16))
    out = k4.factored_decode_attention(*args, wp, scale=hd ** -0.5)
    for i in (3, 4, 5, 6):
        args[i] = torch.full_like(args[i], float("nan"))
    out_nan = k4.factored_decode_attention(*args, wp, scale=hd ** -0.5)
    check(torch.equal(out, out_nan), "factored_decode read factors of comp_len == 0")
    print("[kernels] factored_decode comp_len == 0 with NaN factors: bit-identical")
    return errs


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def bf16_agreement(torch, got, want) -> tuple[float, float]:
    """Correlation of two sets of logits, and the worst excess of |got -
    want| over two bf16 ulps at each logit's own magnitude, counted in bf16
    ulps at the median |logit|."""
    d = (got - want).abs()
    own = lowp_ulp(torch, torch.maximum(got.abs(), want.abs()), torch.bfloat16)
    excess = (d - 2 * own).max().item() / bf16_ulp(want.abs().median().item())
    corr = torch.corrcoef(torch.stack([got.ravel(), want.ravel()]))[0, 1].item()
    return corr, excess


def logits_agree(torch, got, want, dtype: str, tol: float) -> tuple[bool, str]:
    """The serve comparisons of kernel vs plain paths.  In f32 activations
    (the algorithm) the reference's tolerance holds as it is.  In bf16
    activations (the model's dtype) the logits are bf16 numbers: the
    token's own tied-embedding logit reaches ~1000, where one ulp is 4-8,
    and bf16 rounding of the hidden state differs between any two
    summation orders over 28 layers, which moves every logit by a share of
    the logits' spread.  There each logit must lie within two ulps at its
    own magnitude plus ``BF16_EXCESS`` ulps at the median |logit| (the
    spread's scale), and the correlation must exceed 0.9999: a wrong
    attention output reaches every logit through W_o, the MLP and the
    unembedding."""
    diff = (got - want).abs().max().item()
    peak = max(want.abs().max().item(), 1e-30)
    corr, excess = bf16_agreement(torch, got, want)
    if dtype == "float32":
        ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
        rule = f"rtol=atol={tol}"
    else:
        ok = excess <= BF16_EXCESS and corr > 0.9999
        rule = (f"excess over 2 own ulps {excess:.2f} ulp at the median "
                f"|logit| <= {BF16_EXCESS}, corr > 0.9999")
    return ok, (f"max|d| {diff:.3e} at |logit| max {peak:.1f}, correlation "
                f"{corr:.7f} ({rule})")


def phase6_prefill(torch, gen, cfg, weights, card) -> dict:
    """make_prefill_step at full width with kernel 3 and with the plain
    blockwise attention, then grow_cache + one decode step vs a full
    forward over S + 1 — in bf16 activations (the main path, timed and
    counted) and again in f32 activations (the reference's tolerances)."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import serve as launch
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_SEQ + 1), generator=gen,
                           device=gen.device)
    prompt = tokens[:, :PREFILL_SEQ]
    out = {}
    for act in ("bfloat16", "float32"):
        pcfg = cfg.with_(activation_dtype=act)
        params = weights[act]
        if act == "float32":
            pcfg, params = first_layers(pcfg, params, F32_LAYERS)
        kcfg = pcfg.with_(use_flash_kernel=True)
        torch.cuda.reset_peak_memory_stats()
        k3.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_k, cache = launch.run_prefill(kcfg, params, prompt)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        launches = k3.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        logits_p, cache_p = launch.run_prefill(pcfg, params, prompt)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        del cache_p
        ok, msg = logits_agree(torch, logits_k, logits_p, act, 5e-2)
        print(f"[prefill] {ARCH} full width, {pcfg.n_layers} layers, {act} "
              f"activations, (1, {PREFILL_SEQ}) tokens: kernel path {t_k * 1e3:.1f} ms ({PREFILL_SEQ / t_k:.0f} "
              f"tok/s, first call), plain attention {t_p * 1e3:.1f} ms; flash "
              f"launches {launches}; peak {peak:.2f} GiB; last-position logits "
              f"kernel vs plain: {msg} [{card}]")
        check(launches == pcfg.n_layers,
              f"flash launches {launches} != {pcfg.n_layers}")
        check(bool(torch.isfinite(logits_k).all()), "prefill logits not finite")
        check(ok, f"prefill logits ({act}): kernel path disagrees with the plain path")
        grown = cache_mod.grow_cache(cache, 1, kcfg)
        del cache
        got, _ = R.make_serve_step(kcfg)(params, {
            "tokens": tokens[:, PREFILL_SEQ:], "cache": grown,
            "write_pos": PREFILL_SEQ})
        del grown
        want = R._final_logits(kcfg, T.forward(kcfg, params, tokens,
                                               last_only=True).logits[:, -1])
        ok, msg = logits_agree(torch, got, want, act, 0.15)
        corr = torch.corrcoef(torch.stack([got.ravel(), want.ravel()]))[0, 1].item()
        print(f"[prefill] {act}: grow_cache + one decode step at write_pos "
              f"{PREFILL_SEQ} vs a full forward over {PREFILL_SEQ + 1}: {msg}")
        check(ok and corr > 0.99,
              f"prefill + decode ({act}) disagrees with the full forward")
        out[act] = {"launches": launches, "err": (logits_k - logits_p).abs().max().item(),
                    "ms_kernel": t_k * 1e3, "ms_plain": t_p * 1e3}
    return out


def phase7_engine(torch, cfg, weights, card) -> dict:
    """Two engines in teacher-forced lockstep (kernel 4 vs the plain
    oracle), in bf16 activations (the main path: launches counted; every
    step held to ``logits_agree``'s bf16 rule) and in f32 activations (the
    reference's 1e-1); then the bf16 kernel engine alone through
    ``launch.run_engine``, timed, with one traced decode step."""
    from repro_torch.kernels import factored_decode as k4
    from repro_torch.launch import serve as launch
    from repro_torch.serve.engine import Engine
    dev = next(iter(weights["bfloat16"].values())).device
    prompts = launch.make_prompts(ENGINE_REQUESTS, PROMPT_LEN, cfg.vocab, seed=1)
    out = {}
    for act in ("bfloat16", "float32"):
        pcfg = cfg.with_(activation_dtype=act)
        params = weights[act]
        if act == "float32":
            pcfg, params = first_layers(pcfg, params, F32_LAYERS)
        plain = Engine(pcfg, params, device=dev, **ENGINE_KW)
        kern = Engine(pcfg.with_(use_flash_kernel=True), params, device=dev,
                      **ENGINE_KW)
        compare = None if act == "float32" else (
            lambda got, want: bf16_agreement(torch, got, want))
        k4.launches = 0
        t0 = time.perf_counter()
        res = launch.lockstep([plain, kern], prompts, max_new=MAX_NEW,
                              compare=compare)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k4.launches
        hist_p, hist_k = res["comp_len"]
        swaps = [sum(1 for a, b in zip([[0] * kern.slots] + hist_k, hist_k)
                     if b[s] > a[s]) for s in range(kern.slots)]
        diffs, peaks = res["diffs"], res["peaks"]
        if act == "float32":
            ok = max(diffs) < SERVE_TOL
            rule = f"< {SERVE_TOL}"
        else:
            corr = min(c for c, _ in res["compared"])
            excess = max(e for _, e in res["compared"])
            ok = corr > 0.9999 and excess <= BF16_EXCESS
            rule = (f"worst excess over 2 own ulps {excess:.2f} ulp at the "
                    f"median |logit| <= {BF16_EXCESS}, least correlation of a "
                    f"step {corr:.7f} > 0.9999")
        print(f"[engine] {act} lockstep ({pcfg.n_layers} layers), {res['steps']} "
              f"decode steps in {wall:.1f} s: "
              f"max |d logit| kernel vs plain {max(diffs):.3e} ({rule}; "
              f"|logit| max {max(peaks):.1f}; mean of step maxima "
              f"{sum(diffs) / len(diffs):.3e}); fdec launches {launches} = "
              f"{res['steps']} x {pcfg.n_layers}: "
              f"{launches == res['steps'] * pcfg.n_layers}; swaps per slot {swaps}; "
              f"final comp_len {hist_k[-1]} [{card}]")
        check(launches == res["steps"] * pcfg.n_layers,
              f"fdec launches {launches} != {res['steps']} x {pcfg.n_layers}")
        check(hist_p == hist_k, "comp_len histories differ between the engines")
        check(min(swaps) >= 2, f"a slot compressed fewer than twice: {swaps}")
        check(ok, f"engines diverge ({act}): {rule}")
        out[act] = {"launches": launches, "max_diff": max(diffs), "engine": kern}
        del plain
    del out["float32"]["engine"]

    traced = []

    def trace_step(eng, i):                    # two more decode steps, traced
        if i == 10:
            traced.extend(device_breakdown(torch, eng.step))
    torch.cuda.reset_peak_memory_stats()
    run = launch.run_engine(cfg.with_(use_flash_kernel=True), weights["bfloat16"],
                            prompts, max_new=MAX_NEW, device=dev,
                            on_step=trace_step, **ENGINE_KW)
    eng, step_ms, seconds = run["engine"], run["step_ms"], run["seconds"]
    tokens = run["tokens"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    # One swap traced, on the drained engine (the bf16 lockstep's kernel
    # engine stays as it is for phase 8): slots 0 and 1 still hold a 31-row
    # tail.
    slots = iter(range(eng.slots))
    wall_c, busy_c, top_c = device_breakdown(
        torch, lambda: eng.compress_slot(next(slots)))
    heads = cfg.n_scan_periods * cfg.n_kv_heads
    print(f"[profile] one compress_slot (k and v, {heads} heads each: Q of a "
          f"({ENGINE_KW['max_seq']}, {eng._kv_min_rows}) sketch, B = Q^T K, SVD, "
          f"rank {ENGINE_KW['kv_sketch_rank']}): wall {wall_c:.3f} ms (traced), "
          f"device kernels {busy_c:.3f} ms (busy {100 * busy_c / wall_c:.0f}%); "
          f"top: " + "; ".join(f"{k} {v:.3f} ms" for k, v in top_c[:5]) + f" [{card}]")
    decode_ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    slow = [(i, round(t)) for i, t in enumerate(step_ms) if i and t > 3 * decode_ms]
    wall_t, busy, top = traced
    rep = eng.kv_bytes_report()
    print(f"[engine] bf16 kernel engine alone: {tokens} tokens in {seconds:.2f} s "
          f"({tokens / seconds:.1f} tok/s; the first step, admitting "
          f"{ENGINE_REQUESTS} x {PROMPT_LEN}-token prompts, {step_ms[0]:.0f} ms); "
          f"decode step {decode_ms:.2f} ms (median; steps over 3x the median, "
          f"the swaps: {slow}); peak memory {peak:.2f} GiB; "
          f"swappable KV {rep['compressed_bytes'] / 2**20:.1f} MiB vs dense "
          f"{rep['dense_bytes'] / 2**20:.1f} MiB [{card}]")
    fdec = sum(v for k, v in top if "fdec" in k)
    print(f"[profile] one decode step: wall {wall_t:.3f} ms (traced), device "
          f"kernels {busy:.3f} ms (busy {100 * busy / wall_t:.0f}%); kernel 4 "
          f"(fdec, {cfg.n_layers} launches) {fdec:.3f} ms; top: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:5]) + f" [{card}]")
    return out


def flash_times(torch, gen, label, h, kvh, hd, s, card) -> tuple:
    """Kernel 3 at (1, s, h|kvh, hd) bf16 causal by CUDA events, beside its
    plain version, ``scaled_dot_product_attention`` (the library call) and
    its bound: (kernel, plain, library, bound ms, what bounds it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k3
    q, k, v = (torch.randn((1, s, n, hd), generator=gen, device=gen.device)
               .to(torch.bfloat16) for n in (h, kvh, kvh))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t_k = median_ms(torch, lambda: k3.flash_attention(q, k, v, causal=True))
    t_p = median_ms(torch, lambda: k3.flash_attention_plain(q, k, v, causal=True))
    t_l = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    t_ops = k3.causal_flops(1, s, h, hd) / PEAK_TC_FLOP_PER_S
    t_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) / PEAK_BYTES_PER_S
    flash = (t_k, t_p, t_l, max(t_ops, t_bytes) * 1e3,
             "operations" if t_ops >= t_bytes else "bytes")
    per_sm = k3.blocks_per_sm(hd, torch.bfloat16)
    print(f"[time] flash_attention {label}(1, {s}, {h}|{kvh}, {hd}) G {h // kvh} "
          f"bf16 causal: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
          f"scaled_dot_product_attention {t_l:.3f} ms, bound {flash[3]:.3f} ms "
          f"({flash[4]}); kernel/bound {t_k / flash[3]:.2f}x, "
          f"{k3.causal_flops(1, s, h, hd) / t_k / 1e9:.1f} TFLOP/s; occupancy "
          f"{per_sm} blocks of {k3.WARPS} warps an SM [{card}]")
    return flash


def phase8_timings(torch, gen, cfg, kern_engine, card) -> dict:
    """Kernel, plain version, bound and library call for kernels 3-4 at the
    path's shapes: flash at the prefill shape, fdec on layer 0 of the kernel
    engine's final state (its cache, factors and comp_len)."""
    from repro_torch.kernels import factored_decode as k4
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    flash = flash_times(torch, gen, "", h, kvh, hd, PREFILL_SEQ, card)

    eng = kern_engine
    wp = int(max(eng.pos)) - 1                     # the last decode step's clock
    kc, vc = eng.cache["scan"][0]["k"][0], eng.cache["scan"][0]["v"][0]
    f = {n: w[0] for n, w in eng.kv_fact["scan"][0].items()}
    comp = torch.as_tensor(eng._kv_comp_len, device=kc.device)
    qd = torch.randn((eng.slots, 1, h, hd), generator=gen,
                     device=gen.device).to(torch.bfloat16)
    s, r = kc.shape[1], f["k_us"].shape[-1]
    full = (s - 64,) * eng.slots          # every slot after its last 64-row swap
    states = {"engine": ((qd, kc, vc, f["k_us"], f["k_vt"], f["v_us"], f["v_vt"],
                          comp), wp),
              "full": (fdec_inputs(torch, gen, b=eng.slots, s=s, h=h, kvh=kvh,
                                   hd=hd, r=r, comp=full, wp=s - 1,
                                   dtype=torch.bfloat16), s - 1)}
    # The engine meets each layer's state cold: a 64 MB read between calls
    # evicts the 50 MB L2 for the "L2 evicted" times.
    evict = torch.zeros(16 * 2**20, device=gen.device)
    floor_ms = median_ms(torch, k4.empty_launch, reps=TIMING_REPS)
    floor_graph = graph_ms(torch, k4.empty_launch)
    print(f"[time] empty kernel launch (the latency floor): {floor_ms:.4f} ms by "
          f"CUDA events around one launch, {floor_graph:.4f} ms a launch in a "
          f"CUDA graph [{card}]")
    fdec = {"per_state": []}
    for label, (args, cwp) in states.items():
        plan = k4.decode_plan(eng.slots, kvh, s, hd, r, h // kvh)
        clock = torch.tensor([cwp], dtype=torch.int32, device=gen.device)

        # the clock is read on the card, as a captured decode step would
        def call(p=None, args=args):
            return k4.factored_decode_attention(*args, clock, scale=hd ** -0.5,
                                                splits=p)

        def cold(p=None, call=call):
            evict.sum()
            return call(p)
        t_k = median_ms(torch, lambda: k4.factored_decode_attention(
            *args, cwp, scale=hd ** -0.5), reps=TIMING_REPS)
        t_d, seen = kernel_ms(torch, call, "fdec_kernel", TIMING_REPS)
        t_g = graph_ms(torch, call)
        t_c = graph_ms(torch, cold) - graph_ms(torch, lambda: evict.sum())
        t_p = median_ms(torch, lambda: k4.factored_decode_plain(
            *args, cwp, scale=hd ** -0.5), reps=TIMING_REPS)
        nbytes = k4.bytes_needed(args[0], args[1], args[3], args[7], cwp)
        nops = k4.operations_needed(args[0], args[1], args[3], args[7], cwp)
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_F32_FLOP_PER_S * 1e3
        bound, by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
        host = {}
        for how, wp_arg in (("int", cwp), ("device", clock)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):               # no sync inside
                k4.factored_decode_attention(*args, wp_arg, scale=hd ** -0.5)
            host[how] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        print(f"[time] factored_decode {label} state ({eng.slots}, {s}, {kvh}, "
              f"{hd}) r={r} write_pos={cwp} comp_len="
              f"{[int(c) for c in args[7].tolist()]}, plan {plan.splits} splits: "
              f"kernel {t_k:.4f} ms by CUDA events around one call, "
              f"{t_g:.4f} ms a launch in a CUDA graph (L2 warm), {t_c:.4f} ms "
              f"(L2 evicted), device {fmt_ms(t_d)} ms by the profiler ({seen} of "
              f"{TIMING_REPS} launches in its trace); plain {t_p:.4f} ms; bound "
              f"{bound:.5f} ms ({by}: {nbytes} B, {nops} f32 ops), empty-launch "
              f"floor {floor_ms:.4f} ms ({floor_graph:.4f} in a graph); graph/bound "
              f"{t_g / bound:.1f}x; wrapper host {host['int']:.1f} us a call with an "
              f"int clock, {host['device']:.1f} us with a device clock (mean of "
              f"1000, no sync) [{card}]")
        grains = -(-s // plan.grain)
        sweep = sorted({p for p in FDEC_SPLITS if p <= grains} | {plan.splits})
        times = {p: (median_ms(torch, lambda p=p: call(p), reps=TIMING_REPS),
                     graph_ms(torch, lambda p=p: call(p))) for p in sweep}
        best = min(times, key=lambda p: times[p][1])
        at_plan, at_best = times[plan.splits][1], times[best][1]
        print(f"[plans] kernel 4 {label} state, splits P: CUDA-event ms around "
              f"one call / ms a launch in a CUDA graph: "
              + "; ".join(f"{p} {t:.4f} / {g:.4f}" for p, (t, g) in times.items())
              + f"; least graph time at P = {best}; the planner's P = "
              f"{plan.splits} is {at_plan / at_best:.3f}x it [{card}]")
        check(at_plan <= 1.1 * at_best,
              f"kernel 4 {label}: the planner's {plan.splits} splits take "
              f"{at_plan:.4f} ms, over 1.1x the sweep's best {at_best:.4f} ms "
              f"(P = {best})")
        fdec["per_state"].append({
            "state": label, "write_pos": cwp, "splits": plan.splits,
            "ms": t_k, "device_ms": t_d, "device_launches_traced": seen,
            "graph_ms": t_g, "graph_evicted_ms": t_c, "plain_ms": t_p,
            "bound_ms": bound, "bound_by": by, "floor_ms": floor_ms,
            "floor_graph_ms": floor_graph, "host_us": host,
            "sweep": {str(p): list(v) for p, v in times.items()}})
    print("[time] factored_decode library_ms: null — no single PyTorch call "
          "computes attention over a rank-r factored prefix plus a dense tail "
          "under one softmax (scaled_dot_product_attention needs K and V "
          "materialized)")
    return {"flash_attention": flash, "factored_decode": fdec}


# Phase 9: the streamed and structured main path at the paper's sizes.
STREAM_TILE = 256                  # rows a tile (the reference's default)
RAGGED_TILE = 320                  # 12 tiles of 320 and a last one of 256
WIDEN_TO = 276                     # 266 -> 276 Omega columns
# The out-of-core matrix, 65536 x 4096 f32 (1 GiB) of rank 256 + noise: real
# out-of-core matrices exceed the card's 80 GB, and 1 GiB keeps the phase
# within the time limit (PERF.md §4 names the cut).
OOC_SHAPE = (65536, 4096)
OOC_RANK = 256
# The adaptive runs target rank 64: the posterior estimate ||A||^2 -
# sum sigma^2 cancels in f32 near 3.5e-4 relative, above A_exp's rank-256
# tail (1e-4), so at rank 256 it reads noise (PERF.md §4).
ADAPTIVE_RANK = 64
ADAPTIVE_MAX_OVERSAMPLE = 64
TUCKER_SLAB = 32                   # 8 axis-0 slabs of 256^3
# Substrings of the device kernels a GEMM launches (cuBLAS, CUTLASS,
# kernels 1-2 and their split-K reduction).
GEMM_NAMES = ("gemm", "gemv", "xmma", "cutlass", "splitk_reduce")


def svals_close(torch, got, want) -> bool:
    """``tests/test_torch_rsvd.py:_svals_close``: rtol 1e-4, atol 1e-6 s_0."""
    return bool(torch.allclose(got, want, rtol=1e-4,
                               atol=1e-6 * float(want[0])))


def pow2_scaled(torch, a):
    """``a`` times the power of two that brings its RMS to 1/sqrt(k), the
    scale of phase 2's operands, so that phase 2's absolute tolerance means
    the same for the Tucker tensor (entries up to ~5e3).  A power of two is
    exact in the hi/lo split and in every f32 sum, so kernel and plain see
    the path's bits up to the exponent."""
    rms = a.square().mean().sqrt().item()
    return a * 2.0 ** -round(math.log2(rms * math.sqrt(a.shape[1])))


def phase9_streamed(torch, dev, card) -> dict:
    """The streamed, out-of-core RandNLA path and the structured Omegas: the
    kernels against their plain versions at the streamed shapes, then the
    path itself with the kernels' counts set to 0 before each run of it and
    read after, then its timings."""
    import tempfile

    import numpy as np
    from repro_torch import main_path, stream
    from repro_torch.configs.paper_randnla import PAPER_HOSVD, PAPER_RSVD
    from repro_torch.convert import key_from_seed
    from repro_torch.core import hosvd, projection as proj, rsvd
    from repro_torch.core import structured as sx
    from repro_torch.kernels import ops
    from repro_torch.kernels import shgemm as k1
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.kernels.ref import dot_f32
    from repro_torch.stream import state as st_mod

    t_phase = time.perf_counter()
    key = key_from_seed(7)
    cfg, hcfg = PAPER_RSVD, PAPER_HOSVD
    inputs = main_path.rsvd_inputs(cfg, device=dev)
    t = main_path.hosvd_input(hcfg, device=dev)
    ranks = tuple(hcfg.ranks)
    a = inputs["exp"]
    n = a.shape[1]
    p = cfg.rank + cfg.oversample
    launches = {"shgemm": 0, "shgemm_fused": 0}

    def counted(fn):
        k1.launches = k1.reductions = 0
        k2.launches = k2.reductions = 0
        out = fn()
        torch.cuda.synchronize()
        launches["shgemm"] += k1.launches
        launches["shgemm_fused"] += k2.launches
        return out

    # -- 9.0 kernels 1-2 against their plain versions at the streamed shapes
    psi_key = st_mod.fold_in_words(key, st_mod.PSI_FOLD)
    l = 2 * p + 1
    tile, rag = a[:STREAM_TILE], a[RAGGED_TILE:2 * RAGGED_TILE]
    omega = proj.materialize_omega(key, (n, p), device=dev)
    psi_t = k2.reference_omega(psi_key, (STREAM_TILE, l), dtype=torch.bfloat16,
                               row_offset=3 * STREAM_TILE, device=dev)
    cases = [
        ("shgemm_fused", f"row tile {tuple(tile.shape)} n={p}",
         ops.shgemm_fused(tile, key, p),
         k2.shgemm_fused_plain(tile, key, p)),
        ("shgemm_fused", f"widen {tuple(tile.shape)} n={WIDEN_TO - p} "
         f"col_offset={p}",
         ops.shgemm_fused(tile, key, WIDEN_TO - p, col_offset=p),
         k2.shgemm_fused_plain(tile, key, WIDEN_TO - p, col_offset=p)),
        ("shgemm_fused", f"left sketch {tuple(tile.T.shape)} l={l} "
         f"row_offset={3 * STREAM_TILE}",
         ops.shgemm_fused(tile.T, psi_key, l, row_offset=3 * STREAM_TILE),
         k2.shgemm_fused_plain(tile.T, psi_key, l,
                               row_offset=3 * STREAM_TILE)),
        ("shgemm_fused", f"left sketch {tuple(rag.T.shape)} l={l} "
         f"row_offset={RAGGED_TILE} (off the bk grid)",
         st_mod.fused_at_row_offset(rag.T, psi_key, l, RAGGED_TILE),
         k2.shgemm_fused_plain(rag.T, psi_key, l, row_offset=RAGGED_TILE)),
        ("shgemm", f"row tile {tuple(tile.shape)} @ ({n}, {p})",
         ops.shgemm(tile, omega), k1.shgemm_plain(tile, omega, 2)),
        ("shgemm", f"left sketch {tuple(tile.T.shape)} @ "
         f"({STREAM_TILE}, {l})",
         ops.shgemm(tile.T, psi_t), k1.shgemm_plain(tile.T, psi_t, 2))]
    # Streamed Tucker's kernel-2 calls on its last axis-0 slab: mode 0's
    # row tile, and modes 1-2's update_cols tiles, a column range of the
    # unfolding at row offset 224 x 256 = 57344 of Omega_i.
    late = hcfg.dims[0] - TUCKER_SLAB
    for i, r in enumerate(ranks):
        key_i = st_mod.fold_in_words(key, i)
        u = pow2_scaled(torch, hosvd.unfold(t[late:], i))
        c0 = 0 if i == 0 else late * math.prod(
            d for j, d in enumerate(hcfg.dims) if j not in (0, i))
        cases.append((
            "shgemm_fused", f"Tucker mode {i} slab {tuple(u.shape)} n={r} "
            f"row_offset={c0}",
            ops.shgemm_fused(u, key_i, r) if i == 0
            else st_mod.fused_at_row_offset(u, key_i, r, c0),
            k2.shgemm_fused_plain(u, key_i, r, row_offset=c0)))
    errs = {"shgemm": 0.0, "shgemm_fused": 0.0}
    for kern, what, got, want in cases:
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs[kern] = max(errs[kern], err)
        print(f"[stream] {kern} {what}: max|kernel-plain| {err:.3e}")
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-4),
              f"{kern} {what} disagrees with plain")

    # -- 9a. streamed rows == one-shot rows, bit for bit (kernel 2) ---------
    host = a.cpu()              # tiles reach the card through the prefetch
    one = proj.sketch(key, a, p, method="shgemm_fused")
    fresh = proj.sketch(key, a, WIDEN_TO, method="shgemm_fused")
    for rows in (STREAM_TILE, RAGGED_TILE):
        src = stream.ArraySource(host, rows)
        st = counted(lambda: main_path.streamed_sketch(key, src, p, left=True))
        check(torch.equal(st.y, one), f"streamed Y ({rows}-row tiles) != "
              f"one-shot kernel-2 sketch")
        w_plain = k2.shgemm_fused_plain(a.T, st.key_psi, st.l).T
        w_err = (st.w - w_plain).abs().max().item()
        check(torch.allclose(st.w, w_plain, rtol=1e-5, atol=1e-4),
              f"left sketch W ({rows}-row tiles) disagrees with plain: {w_err}")
        base = counted(lambda: main_path.streamed_sketch(key, src, p))
        ext = base.widen(WIDEN_TO - p)

        def replay():
            for off, t in stream.offset_tiles(src, device=dev):
                stream.update(ext, t, off)
        counted(replay)
        grown = stream.hstack(base, ext)
        check(torch.equal(grown.y, fresh),
              f"widened {p} -> {WIDEN_TO} ({rows}-row tiles) != fresh sketch")
        print(f"[stream] A_exp {tuple(a.shape)} in {-(-a.shape[0] // rows)} tiles "
              f"of {rows} rows from host memory (prefetch depth 1): Y == "
              f"one-shot kernel-2 sketch bit for bit; widened {p} -> {WIDEN_TO} "
              f"== fresh sketch bit for bit; W (l={st.l}) vs plain max abs "
              f"{w_err:.3e}")

    # -- 9b. rsvd_streamed on A_exp and A_linear ---------------------------
    rsvd_rec = {}
    for name, mat in inputs.items():
        src = stream.ArraySource(mat, STREAM_TILE)
        err_f32 = main_path.rsvd_error(mat, cfg, "f32", key)
        s_true = main_path.SPECTRA[name](n, cfg.rank, cfg.s_p, device=dev)
        opt = float(torch.linalg.norm(s_true[ADAPTIVE_RANK:])
                    / torch.linalg.norm(s_true))
        for method in main_path.STREAMED_METHODS:
            e2, _ = counted(lambda: main_path.rsvd_streamed_error(
                mat, src, cfg, method, key))
            lim2 = main_path.error_limit("rsvd", err_f32)
            check(e2 <= lim2, f"rsvd_streamed {name} {method} passes=2: "
                  f"{e2:.3e} > {lim2:.3e}")
            _, r4 = counted(lambda: main_path.rsvd_streamed_error(
                mat, src, cfg, method, key, passes=4))
            want4 = rsvd.rsvd(key, mat, cfg.rank, oversample=cfg.oversample,
                              power_iters=1, method=method)
            check(svals_close(torch, r4.s, want4.s),
                  f"rsvd_streamed {name} {method} passes=4 singular values != "
                  f"rsvd(power_iters=1)")
            e1, _ = counted(lambda: main_path.rsvd_streamed_error(
                mat, src, cfg, method, key, passes=1))
            e_2p = main_path.rsvd_error(mat, cfg, method, key)
            check(e1 <= 3.0 * e_2p + 1e-4, f"rsvd_streamed {name} {method} "
                  f"passes=1: {e1:.3e} > 3 x {e_2p:.3e} + 1e-4")
            e0, _ = main_path.rsvd_streamed_error(mat, src, cfg, method, key,
                                                  rank=ADAPTIVE_RANK)
            tol = opt + 0.5 * (e0 - opt)
            ea, (_, info) = counted(lambda: main_path.rsvd_streamed_error(
                mat, src, cfg, method, key, rank=ADAPTIVE_RANK, tol=tol,
                max_oversample=ADAPTIVE_MAX_OVERSAMPLE, return_info=True))
            grown_ok = (info.grown_sketch_bytes < info.full_resketch_bytes
                        if method == "shgemm_fused"
                        else info.grown_sketch_bytes == info.full_resketch_bytes)
            check(info.converged and info.widen_passes >= 1 and grown_ok,
                  f"adaptive rsvd_streamed {name} {method}: {info}")
            rsvd_rec[(name, method)] = (e2, e1, ea, info)
            print(f"[stream] rsvd_streamed {name} {method} rank {cfg.rank}: "
                  f"passes=2 error {e2:.4e} (limit {lim2:.4e}, f32 one-shot "
                  f"{err_f32:.4e}); passes=4 singular values == rsvd(power_iters"
                  f"=1)'s; passes=1 error {e1:.4e} (limit 3 x {e_2p:.4e} + 1e-4); "
                  f"adaptive rank {ADAPTIVE_RANK}: tol {tol:.4e} (optimum "
                  f"{opt:.4e}, oversample 10 {e0:.4e}) -> p {info.final_p} after "
                  f"{info.widen_passes} widen(s), converged {info.converged}, "
                  f"estimates {[round(x, 6) for x in info.est_history]}, error "
                  f"{ea:.4e}, grown {info.grown_sketch_bytes} B vs re-sketch "
                  f"{info.full_resketch_bytes} B")

    # -- 9c. out of core: 1 GiB through MemmapSource -----------------------
    m9, n9 = OOC_SHAPE
    a_bytes = m9 * n9 * 4
    big = main_path.low_rank_plus_noise(
        torch.Generator(device=dev).manual_seed(99), m9, n9, OOC_RANK, 1e-6)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "a.npy"
        t0 = time.perf_counter()
        np.save(path, big.cpu().numpy())
        t_write = time.perf_counter() - t0
        del big
        torch.cuda.empty_cache()
        src = stream.MemmapSource(path, STREAM_TILE)

        def streamed():
            return rsvd.rsvd_streamed(key, src, OOC_RANK, oversample=10,
                                      passes=2, method="shgemm_fused")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = counted(streamed)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - start
        check(peak < a_bytes / 4, f"out-of-core peak device memory {peak} B "
              f">= A/4 = {a_bytes // 4} B")
        t_wall, busy, top = device_breakdown(torch, streamed)
        big = torch.from_numpy(np.load(path)).to(dev)
    one9 = rsvd.rsvd(key, big, OOC_RANK, oversample=10, method="shgemm_fused")
    check(svals_close(torch, res.s, one9.s), "out-of-core rsvd_streamed "
          "singular values != the resident one-shot rsvd's")
    e9 = float(rsvd.reconstruction_error(big, res))
    e9_one = float(rsvd.reconstruction_error(big, one9))
    del big, one9
    torch.cuda.empty_cache()
    ooc = {"wall_s": wall, "gb_per_s_a_pass": a_bytes / (wall / 2) / 1e9,
           "peak_bytes": peak, "a_bytes": a_bytes, "traced_wall_ms": t_wall,
           "device_ms": busy, "busy": busy / t_wall, "error": e9,
           "resident_error": e9_one, "write_s": t_write}
    print(f"[stream] out of core: {m9}x{n9} f32 ({a_bytes / 2**30:.0f} GiB, rank "
          f"{OOC_RANK} + noise) written with np.save in {t_write:.1f} s, streamed "
          f"back through MemmapSource in {m9 // STREAM_TILE} tiles of "
          f"{STREAM_TILE} rows, passes=2, shgemm_fused: {wall:.3f} s wall, "
          f"{ooc['gb_per_s_a_pass']:.2f} GB/s of A a pass; peak device memory "
          f"{peak / 2**20:.1f} MiB over the start (limit A/4 = "
          f"{a_bytes / 4 / 2**20:.0f} MiB); singular values == the resident "
          f"one-shot rsvd's; error {e9:.4e} (resident {e9_one:.4e}); one traced "
          f"run: wall {t_wall:.1f} ms, device kernels {busy:.1f} ms (busy "
          f"{100 * busy / t_wall:.0f}%); top: "
          + "; ".join(f"{k} {v:.1f} ms" for k, v in top[:4]) + f" [{card}]")

    # -- 9d. SRHT at n = 4096, p = 266 -------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    before = (k1.launches, k2.launches)
    y = sx.srht_sketch(key, a, p)
    oracle = dot_f32(a, sx.srht_omega(key, (n, p), device=dev))
    rel = (torch.linalg.norm(y - oracle) / torch.linalg.norm(oracle)).item()
    check(rel <= 1e-5, f"srht_sketch vs A @ srht_omega: {rel:.3e} > 1e-5")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sx.srht_sketch(key, a, p)
        torch.cuda.synchronize()
    names = sorted({ev.key for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA})
    gemms = [k for k in names if any(g in k.lower() for g in GEMM_NAMES)]
    check(names and not gemms and (k1.launches, k2.launches) == before,
          f"srht_sketch launched a GEMM: {gemms}")
    t_srht = median_ms(torch, lambda: sx.srht_sketch(key, a, p))
    d_srht = device_ms(torch, lambda: sx.srht_sketch(key, a, p))[0]
    t_fwht = median_ms(torch, lambda: sx.fwht(a))
    t_k2 = median_ms(torch, lambda: ops.shgemm_fused(a, key, p))
    d_k2 = device_ms(torch, lambda: ops.shgemm_fused(a, key, p))[0]
    srht = {"rel_err": rel, "ms": t_srht, "device_ms": d_srht, "fwht_ms": t_fwht,
            "kernel2_ms": t_k2, "kernel2_device_ms": d_k2, "kernels": names}
    print(f"[stream] srht_sketch {tuple(a.shape)} p={p}: rel. error vs A @ "
          f"srht_omega {rel:.3e}; its trace holds no GEMM ({len(names)} device "
          f"kernels: {', '.join(k[:30] for k in names)}); {t_srht:.4f} ms (device "
          f"{fmt_ms(d_srht)}; the FWHT alone {t_fwht:.4f} ms) against kernel 2's "
          f"sketch of the same shape {t_k2:.4f} ms (device {fmt_ms(d_k2)}) [{card}]")

    # -- 9e. Khatri-Rao and streamed Tucker on 256^3, ranks 32^3 -----------
    e_g = main_path.hosvd_error(t, hcfg, "rp_hosvd", "f32", key)
    lim_kr = max(5.0 * e_g, 1e-4)
    with sx.record_shapes() as shapes:
        e_kr = float(hosvd.reconstruction_error(
            t, hosvd.rp_hosvd(key, t, ranks, dist="khatri_rao")))
        e_kr_st = counted(lambda: main_path.sthosvd_streamed_error(
            t, hcfg, "shgemm_fused", "khatri_rao", key, slab_rows=TUCKER_SLAB))
    unfold_cols = min(math.prod(d for j, d in enumerate(hcfg.dims) if j != i)
                      for i in range(len(hcfg.dims)))
    widest = max(math.prod(s[1:]) for s in shapes)
    check(e_kr <= lim_kr and e_kr_st <= lim_kr,
          f"Khatri-Rao RP-HOSVD {e_kr:.3e} / streamed {e_kr_st:.3e} > "
          f"{lim_kr:.3e}")
    check(shapes and widest < unfold_cols, f"a Khatri-Rao intermediate "
          f"reached {widest} columns (unfolding: {unfold_cols})")
    e_st = counted(lambda: main_path.sthosvd_streamed_error(
        t, hcfg, "shgemm_fused", "gaussian", key, slab_rows=TUCKER_SLAB))
    e_st_one = main_path.hosvd_error(t, hcfg, "rp_sthosvd", "shgemm_fused", key)
    e_st_f32 = main_path.sthosvd_streamed_error(
        t, hcfg, "f32", "gaussian", key, slab_rows=TUCKER_SLAB)
    e_one_f32 = main_path.hosvd_error(t, hcfg, "rp_sthosvd", "f32", key)
    e_st_lowp = main_path.sthosvd_streamed_error(
        t, hcfg, "lowp_single", "gaussian", key, slab_rows=TUCKER_SLAB)
    # Streamed Tucker against the one-shot rp_sthosvd of its own method:
    # the single-pass core solve adds to the one-shot error (1.6-2.2x in
    # the readings, PERF.md §6), so phase 3's limit, made for one-shot runs,
    # does not apply.  The f32 run holds the streaming scheme, the fused
    # run its precision; the bf16-only run must fail the fused run's limit.
    lim_st, lim_st_f32 = 3.0 * e_st_one, 3.0 * e_one_f32
    check(e_st <= lim_st, f"rp_sthosvd_streamed gaussian shgemm_fused "
          f"{e_st:.3e} > 3 x one-shot {e_st_one:.3e}")
    check(e_st_f32 <= lim_st_f32, f"rp_sthosvd_streamed gaussian f32 "
          f"{e_st_f32:.3e} > 3 x one-shot {e_one_f32:.3e}")
    check(e_st_lowp > lim_st, f"the streamed-Tucker limit {lim_st:.3e} "
          f"passes a bf16-only run ({e_st_lowp:.3e})")
    print(f"[stream] 256^3 ranks 32^3: rp_hosvd khatri_rao error {e_kr:.4e}, "
          f"rp_sthosvd_streamed khatri_rao over {hcfg.dims[0] // TUCKER_SLAB} "
          f"slabs {e_kr_st:.4e} (limit max(5 x gaussian f32 {e_g:.4e}, 1e-4)); "
          f"{len(shapes)} Khatri-Rao intermediates, the widest {widest} columns "
          f"< the unfolding's {unfold_cols}; rp_sthosvd_streamed gaussian "
          f"shgemm_fused {e_st:.4e} (limit 3 x one-shot {e_st_one:.4e}), f32 "
          f"{e_st_f32:.4e} (limit 3 x one-shot {e_one_f32:.4e}), lowp_single "
          f"{e_st_lowp:.4e} (must exceed {lim_st:.4e})")
    print(f"[stream] launches on the streamed path (counts set to 0 before "
          f"each run, read after): {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the streamed path was never launched: {launches}")

    # -- timings: streamed against resident, Khatri-Rao against Gaussian ---
    src_card = stream.ArraySource(a, STREAM_TILE)
    src_host = stream.ArraySource(host, STREAM_TILE)
    calls = {
        "rsvd shgemm_fused resident": lambda: rsvd.rsvd(
            key, a, cfg.rank, oversample=cfg.oversample, method="shgemm_fused"),
        "rsvd_streamed shgemm_fused, tiles on the card": lambda: rsvd.rsvd_streamed(
            key, src_card, cfg.rank, oversample=cfg.oversample),
        "rsvd_streamed shgemm_fused, tiles from host": lambda: rsvd.rsvd_streamed(
            key, src_host, cfg.rank, oversample=cfg.oversample),
        "rp_hosvd gaussian shgemm_fused": lambda: hosvd.rp_hosvd(
            key, t, ranks, method="shgemm_fused"),
        "rp_hosvd khatri_rao": lambda: hosvd.rp_hosvd(
            key, t, ranks, dist="khatri_rao"),
        "rp_sthosvd_streamed gaussian shgemm_fused": lambda: hosvd.rp_sthosvd_streamed(
            key, stream.ArraySource(t, TUCKER_SLAB), ranks=ranks),
        "rp_sthosvd_streamed khatri_rao": lambda: hosvd.rp_sthosvd_streamed(
            key, stream.ArraySource(t, TUCKER_SLAB), ranks=ranks,
            dist="khatri_rao")}
    e2e = interleaved_host_ms(torch, calls, STREAM_REPS)
    for name, ms in e2e.items():
        print(f"[e2e] {name}: {ms:.3f} ms (median of {STREAM_REPS}, calls "
              f"interleaved) [{card}]")
    print(f"[stream] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "errs": errs, "rsvd": rsvd_rec, "ooc": ooc,
            "srht": srht, "e2e": e2e,
            "tucker": {"streamed": e_st, "oneshot": e_st_one,
                       "streamed_f32": e_st_f32, "oneshot_f32": e_one_f32,
                       "streamed_lowp": e_st_lowp}}


# Phase 10: checkpointed, resumed and elastic jobs on the card.
RESIL_EVERY = 4            # 10a-b: a checkpoint every 4 of A_exp's 16 tiles
RESIL_FAULTS = {           # 10b: where the raised fault fires (tiles count
    "sketch": (2, 6),      # across passes; 16 a pass), by passes
    "B": (2, 16 + 9),
    "power": (4, 2 * 16 + 5)}
OOC_EVERY = 32             # 10c: a checkpoint every 32 of 256 tiles
OOC_KILL_AT = 150          # 10c: the child SIGKILLs itself at this tile
SHARD_ROWS = 4096          # 10d: 16 shards and a manifest.json
FLAKY_RATE, FLAKY_SEED = 0.02, 3
ELASTIC_HOSTS, ELASTIC_LOST, ELASTIC_AFTER = 4, 2, 2
TUCKER_EVERY, TUCKER_FAULT = 2, 5
# The child of 10c: the out-of-core job, killed by its own tile source.
KILL_CHILD = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from repro_torch import main_path\n"
    "from repro_torch.convert import key_from_seed\n"
    "main_path.memmap_rsvd_job(key_from_seed(int(sys.argv[2])), sys.argv[3],\n"
    "    int(sys.argv[4]), tile_rows=int(sys.argv[5]), checkpoint_dir=sys.argv[6],\n"
    "    checkpoint_every_tiles=int(sys.argv[7]), kill_at_tile=int(sys.argv[8]))\n")


def same_bits(torch, x, y) -> bool:
    return all(torch.equal(a, b) for a, b in zip(x, y))


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase10_resilience(torch, dev, card, ooc9: dict) -> dict:
    """Checkpointed, resumed and elastic streamed jobs through kernel 2 (and
    kernel 1 in 10a): every result bit for bit against its uninterrupted
    run, with kernel 2's counts set to 0 before each run and read after."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    from repro_torch import main_path, stream
    from repro_torch.configs.paper_randnla import PAPER_HOSVD, PAPER_RSVD
    from repro_torch.convert import key_from_seed
    from repro_torch.core import hosvd, rsvd
    from repro_torch.data import pipeline
    from repro_torch.kernels import shgemm as k1
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.stream import resilience as resil

    t_phase = time.perf_counter()
    seed = 7
    key = key_from_seed(seed)
    cfg, hcfg = PAPER_RSVD, PAPER_HOSVD
    host = main_path.rsvd_inputs(cfg, device=dev)["exp"].cpu()
    launches = {"shgemm": 0, "shgemm_fused": 0}

    def counted(fn):
        k1.launches = k1.reductions = 0
        k2.launches = k2.reductions = 0
        out = fn()
        torch.cuda.synchronize()
        launches["shgemm"] += k1.launches
        launches["shgemm_fused"] += k2.launches
        return out

    def job(method, passes):
        def run(src, **kw):
            return rsvd.rsvd_streamed(key, src, cfg.rank,
                                      oversample=cfg.oversample,
                                      passes=passes, method=method, **kw)
        return run

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = stream.ArraySource(host, STREAM_TILE)

        # -- 10a. checkpointed == plain, bit for bit -----------------------
        plain = {}
        for method in main_path.STREAMED_METHODS:
            for passes in (2, 4):
                run = job(method, passes)
                ckdir = tmp / f"a-{method}-{passes}"
                want = counted(lambda: run(src))
                got, rep = counted(lambda: run(
                    src, checkpoint_dir=ckdir,
                    checkpoint_every_tiles=RESIL_EVERY, return_report=True))
                check(same_bits(torch, got, want), f"checkpointed rsvd_streamed "
                      f"{method} passes={passes} != the plain run")
                check(rep.attempts == 1 and rep.tiles_recomputed == 0,
                      f"checkpointed run without a fault: {rep}")
                ck_bytes = dir_bytes(sorted(ckdir.glob("ckpt_*"))[-1])
                ms = interleaved_host_ms(torch, {
                    "plain": lambda: run(src),
                    "ckpt": lambda: run(src, checkpoint_dir=ckdir,
                                        checkpoint_every_tiles=RESIL_EVERY)},
                    3)
                plain[(method, passes)] = want
                out[("10a", method, passes)] = {
                    "plain_ms": ms["plain"], "ckpt_ms": ms["ckpt"],
                    "ratio": ms["ckpt"] / ms["plain"], "ckpt_bytes": ck_bytes}
                print(f"[resil] 10a {method} passes={passes}, A_exp "
                      f"{tuple(host.shape)} in 16 tiles of {STREAM_TILE} rows "
                      f"from host memory, rank {cfg.rank}: checkpointed every "
                      f"{RESIL_EVERY} tiles == plain bit for bit; wall "
                      f"{ms['ckpt']:.3f} / {ms['plain']:.3f} ms = "
                      f"{ms['ckpt'] / ms['plain']:.3f}x (median of 3, in "
                      f"turns); one checkpoint {ck_bytes} B [{card}]")

        # -- 10b. a raised fault in the sketch, B and power passes ---------
        for phase, (passes, fail_at) in RESIL_FAULTS.items():
            got, rep = counted(lambda: main_path.resume_after_fault(
                job("shgemm_fused", passes), src, fail_at_tile=fail_at,
                checkpoint_dir=tmp / f"b-{phase}",
                checkpoint_every_tiles=RESIL_EVERY))
            check(same_bits(torch, got, plain[("shgemm_fused", passes)]),
                  f"resumed after a fault in the {phase} pass != the plain run")
            check(rep.attempts == 2 and rep.tiles_recomputed <= RESIL_EVERY,
                  f"fault in the {phase} pass: {rep}")
            out[("10b", phase)] = rep.as_record()
            print(f"[resil] 10b fault at tile {fail_at} ({phase} pass, passes="
                  f"{passes}), resumed: == plain bit for bit; attempts "
                  f"{rep.attempts}, tiles recomputed {rep.tiles_recomputed} "
                  f"(<= {RESIL_EVERY}), goodput {rep.goodput:.4f}")

        # -- 10c. SIGKILL out of core ---------------------------------------
        m9, n9 = OOC_SHAPE
        a_bytes = m9 * n9 * 4
        big = main_path.low_rank_plus_noise(
            torch.Generator(device=dev).manual_seed(99), m9, n9, OOC_RANK,
            1e-6)
        path = tmp / "a.npy"
        np.save(path, big.cpu().numpy())
        del big
        torch.cuda.empty_cache()
        mm = stream.MemmapSource(path, STREAM_TILE)

        def ooc_plain():
            return rsvd.rsvd_streamed(key, mm, OOC_RANK, oversample=10,
                                      passes=2, method="shgemm_fused")

        def ooc_job(name, **kw):
            return main_path.memmap_rsvd_job(
                key, path, OOC_RANK, tile_rows=STREAM_TILE,
                checkpoint_dir=tmp / name, checkpoint_every_tiles=OOC_EVERY,
                device=dev, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = counted(ooc_plain)
        t_plain = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, rep0 = counted(lambda: ooc_job("c-nofault"))
        t_ckpt = time.perf_counter() - t0
        check(same_bits(torch, got, want), "out-of-core checkpointed run != "
              "the plain run")
        ck_bytes = dir_bytes(sorted((tmp / "c-nofault").glob("ckpt_*"))[-1])
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", KILL_CHILD, str(ROOT / "src"), str(seed),
             str(path), str(OOC_RANK), str(STREAM_TILE), str(tmp / "c-kill"),
             str(OOC_EVERY), str(OOC_KILL_AT)],
            capture_output=True, text=True, timeout=300)
        t_child = time.perf_counter() - t0
        check(child.returncode == -signal.SIGKILL, f"the child was not "
              f"killed: rc {child.returncode}, {child.stderr[-2000:]}")
        hb = json.loads((tmp / "c-kill" / "heartbeat.json").read_text())
        on_disk = sorted((tmp / "c-kill").glob("ckpt_*"))
        cursor = (json.loads((on_disk[-1] / "manifest.json").read_text())
                  ["tiles_done"] if on_disk else 0)
        t0 = time.perf_counter()
        got, rep = counted(lambda: ooc_job("c-kill"))
        t_resume = time.perf_counter() - t0
        check(same_bits(torch, got, want), "out-of-core run resumed after "
              "SIGKILL != the uninterrupted run")
        check(rep.attempts == 2, f"resumed after SIGKILL: {rep}")
        ev = rep.recovery_events[-1]
        out["10c"] = {"plain_s": t_plain, "ckpt_s": t_ckpt,
                      "ratio": t_ckpt / t_plain, "ckpt_bytes": ck_bytes,
                      "child_s": t_child, "resume_s": t_resume,
                      "cursor_at_kill": cursor,
                      "heartbeat_tiles_at_kill": hb["tiles_done"],
                      "report": rep.as_record()}
        print(f"[resil] 10c out of core, {m9}x{n9} f32 ({a_bytes / 2**30:.0f} "
              f"GiB) through MemmapSource in {m9 // STREAM_TILE} tiles, rank "
              f"{OOC_RANK}, passes=2, shgemm_fused: checkpointed every "
              f"{OOC_EVERY} tiles == plain bit for bit, {t_ckpt:.3f} / "
              f"{t_plain:.3f} s = {t_ckpt / t_plain:.3f}x, one checkpoint "
              f"{ck_bytes} B; child SIGKILLed at tile {OOC_KILL_AT} after "
              f"{t_child:.1f} s (heartbeat at {hb['tiles_done']} tiles, newest "
              f"checkpoint on disk at {cursor}); resumed here in "
              f"{t_resume:.3f} s == uninterrupted bit for bit; attempts "
              f"{rep.attempts}, tiles recomputed {rep.tiles_recomputed}, time "
              f"to recover {ev['time_to_recover_s']:.3f} s, goodput "
              f"{rep.goodput:.4f} [{card}]")

        # -- 10d. object store: 4096-row shards behind range reads ---------
        shards = tmp / "shards"
        pipeline.write_matrix_shards(shards, np.load(path, mmap_mode="r"),
                                     SHARD_ROWS)
        retries = [0]

        def sleep(secs):
            retries[0] += 1
            time.sleep(secs)
        flaky = resil.FlakyRangeFetcher(stream.FileRangeFetcher(),
                                        rate=FLAKY_RATE, seed=FLAKY_SEED)
        osrc = stream.ObjectStoreSource(
            shards / "manifest.json", STREAM_TILE, fetcher=flaky,
            retry=stream.RetryPolicy(max_attempts=4, base_delay=1e-3,
                                     max_delay=1e-2, sleep=sleep))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = counted(lambda: rsvd.rsvd_streamed(
            key, osrc, OOC_RANK, oversample=10, passes=2,
            method="shgemm_fused"))
        t_os = time.perf_counter() - t0
        check(same_bits(torch, got, want), "ObjectStoreSource run != the "
              "MemmapSource run")
        check(flaky.injected > 0 and retries[0] == flaky.injected,
              f"{retries[0]} retried reads for {flaky.injected} injected "
              f"faults")
        shutil.rmtree(shards)
        out["10d"] = {"wall_s": t_os, "gb_per_s_a_pass": a_bytes / (t_os / 2)
                      / 1e9, "reads": flaky.reads, "injected": flaky.injected,
                      "retries": retries[0]}
        print(f"[resil] 10d {m9 // SHARD_ROWS} shards of {SHARD_ROWS} rows + "
              f"manifest.json through ObjectStoreSource (FileRangeFetcher in "
              f"FlakyRangeFetcher rate {FLAKY_RATE}, seed {FLAKY_SEED}): == "
              f"MemmapSource bit for bit; {flaky.reads} range reads, "
              f"{flaky.injected} faults injected, {retries[0]} retried; "
              f"{t_os:.3f} s wall, {out['10d']['gb_per_s_a_pass']:.2f} GB/s "
              f"of A a pass (phase 9 MemmapSource "
              f"{ooc9['gb_per_s_a_pass']:.2f}) [{card}]")

    # -- 10e. elastic: one of four hosts lost ------------------------------
    rows = host.shape[0] // ELASTIC_HOSTS
    hosts = [stream.ArraySource(host[h * rows:(h + 1) * rows], STREAM_TILE)
             for h in range(ELASTIC_HOSTS)]
    fleet = counted(lambda: resil.elastic_distributed_rsvd_streamed(
        key, hosts, cfg.rank, oversample=cfg.oversample))
    got, rep = counted(lambda: resil.elastic_distributed_rsvd_streamed(
        key, hosts, cfg.rank, oversample=cfg.oversample,
        lose_hosts=(ELASTIC_LOST,), lose_after_tiles=ELASTIC_AFTER,
        return_report=True))
    check(same_bits(torch, got, fleet), "elastic rSVD after a host loss != "
          "the full fleet")
    whole = plain[("shgemm_fused", 2)]
    check(svals_close(torch, fleet.s, whole.s), "elastic rSVD singular values "
          "!= rsvd_streamed on the whole matrix")
    out["10e"] = rep.as_record()
    print(f"[resil] 10e elastic rSVD over {ELASTIC_HOSTS} hosts of {rows} rows, "
          f"host {ELASTIC_LOST} lost after {ELASTIC_AFTER} tiles: == full fleet "
          f"bit for bit; singular values == rsvd_streamed's on the whole "
          f"matrix (bit for bit: {same_bits(torch, fleet, whole)}); tiles "
          f"recomputed {rep.tiles_recomputed}, goodput {rep.goodput:.4f}; "
          f"events {rep.recovery_events}")

    # -- 10f. streamed Tucker, a fault at slab 5 ---------------------------
    t = main_path.hosvd_input(hcfg, device=dev)
    tsrc = stream.ArraySource(t, TUCKER_SLAB)

    def tucker(src, **kw):
        return hosvd.rp_sthosvd_streamed(key, src, ranks=tuple(hcfg.ranks),
                                         method="shgemm_fused", **kw)
    want = counted(lambda: tucker(tsrc))
    with tempfile.TemporaryDirectory() as tmp:
        got, rep = counted(lambda: main_path.resume_after_fault(
            tucker, tsrc, fail_at_tile=TUCKER_FAULT, checkpoint_dir=tmp,
            checkpoint_every_tiles=TUCKER_EVERY))
    check(torch.equal(got.core, want.core)
          and same_bits(torch, got.factors, want.factors),
          "streamed Tucker resumed after a fault != the uninterrupted run")
    check(rep.attempts == 2 and rep.tiles_recomputed <= TUCKER_EVERY,
          f"streamed Tucker resumed: {rep}")
    out["10f"] = rep.as_record()
    print(f"[resil] 10f rp_sthosvd_streamed {tuple(hcfg.dims)} in "
          f"{hcfg.dims[0] // TUCKER_SLAB} slabs, ranks {tuple(hcfg.ranks)}, "
          f"checkpointed every {TUCKER_EVERY}, fault at slab {TUCKER_FAULT}, "
          f"resumed: == uninterrupted bit for bit; tiles recomputed "
          f"{rep.tiles_recomputed}")
    print(f"[resil] launches in phase 10 (counts set to 0 before each run, "
          f"read after): {launches}")
    check(launches["shgemm_fused"] > 0 and launches["shgemm"] > 0,
          f"a kernel of phase 10 was never launched: {launches}")
    print(f"[resil] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    out["launches"] = launches
    return out


# Phase 11: the autotuner and distributed RandNLA.
DIST_WORLD = (2, 2)        # 11b: data x model ranks, all on the one card (gloo)
DIST_TIMEOUT = 180.0       # a deadlocked collective fails the phase, not the run
DIST_HOSTS = 4             # 11b: streamed sources cut from phase 9's matrix
DIST_FAULT = (2, 1)        # 11b: the raised fault: source 2's second tile


TUNE_TIMES = ("CUDA-event ms around one call (host included) / ms a launch "
              "replayed from a CUDA graph (device)")


def tuned_vs_planned(torch, tuned, planned) -> dict:
    """Both calls timed in turns: CUDA events around one call, then a
    launch replayed from a CUDA graph (the profiler's device time is not
    read here: late in the run its traces hold no kernel)."""
    ms = {"tuned": [], "planned": []}
    for _ in range(2):
        for lbl, fn in (("tuned", tuned), ("planned", planned), ("planned", planned),
                        ("tuned", tuned)):
            ms[lbl].append((median_ms(torch, fn), graph_ms(torch, fn)))
    best = {lbl: (min(t for t, _ in v), min(g for _, g in v)) for lbl, v in ms.items()}
    return {"ms": best["tuned"][0], "graph_ms": best["tuned"][1],
            "planned_ms": best["planned"][0], "planned_graph_ms": best["planned"][1]}


def phase11_autotune(torch, dev, card, errs5: dict) -> dict:
    """11a: the shipped entries served on the card; ``autotune_blocks`` for
    kernels 1-2 at rSVD's and RP-HOSVD's shapes and ``autotune_decode_block``
    at the engine's state, each tuned plan against the planner's (bit for
    bit for kernels 1-2, kernel 4 against its plain version), a second call
    a cache hit that times nothing."""
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import factored_decode as k4
    from repro_torch.kernels import ops
    from repro_torch.convert import key_from_seed

    key = key_from_seed(7)
    bf16 = torch.bfloat16
    # the shipped entries, served to this card with the user cache empty
    shipped = at._load_shipped()
    for m, n, k in at.SHIPPED_GEMM_SHAPES:
        for fused in (False, True):
            entry = shipped.get(at.cache_key(m, n, k, bf16, 2, fused))
            check(entry is not None and at.pick_blocks(m, n, k, fused=fused)
                  == tuple(entry["plan"]) and entry["device"] == at.device_name(),
                  f"shipped entry of {(m, n, k)} fused={fused} not served on "
                  f"this card: {entry}")
    for shape in at.SHIPPED_DECODE_SHAPES:
        entry = shipped.get(at.decode_cache_key(shape[0] * shape[1], *shape[2:]))
        check(entry is not None and at.pick_decode_block(*shape) == entry["splits"],
              f"shipped kernel-4 entry of {shape} not served: {entry}")
    print(f"[tune] the {len(shipped)} shipped entries "
          f"(src/repro_torch/kernels/autotune_default.json, "
          f"{sorted({e['device'] for e in shipped.values()})}) are served on "
          f"this card with an empty user cache")

    out = {}
    gen = torch.Generator(device=dev).manual_seed(11)
    for sname, (m, k, n) in (("rsvd", RSVD_SHAPE), ("hosvd", HOSVD_SHAPE)):
        a = torch.randn((m, k), generator=gen, device=dev) / math.sqrt(k)
        b = torch.randn((k, n), generator=gen, device=dev).to(bf16)
        for name, fused in (("shgemm", False), ("shgemm_fused", True)):
            timer = at.gemm_timer(m, n, k, bf16, 2, fused, dev)
            calls = [0]

            def counted(*args, timer=timer, calls=calls):
                calls[0] += 1
                return timer(*args)
            plan, hit = at.autotune_blocks(m, n, k, fused=fused, time_fn=counted)
            timed = calls[0]
            again, hit2 = at.autotune_blocks(m, n, k, fused=fused, time_fn=counted)
            check(not hit and timed > 0 and hit2 and again == plan
                  and calls[0] == timed,
                  f"autotune {name} {sname}: second call timed "
                  f"{calls[0] - timed} plans (hit {hit2})")
            check(at.pick_blocks(m, n, k, fused=fused) == plan,
                  f"autotune {name} {sname}: the tuned plan is not served")
            planned = at.planned_blocks(m, n, k, fused=fused)
            if fused:
                tuned_call = (lambda: ops.shgemm_fused(a, key, n))
                plan_call = (lambda: ops.shgemm_fused(a, key, n, blocks=planned[:3],
                                                      splits=planned[3]))
            else:
                tuned_call = (lambda: ops.shgemm(a, b))
                plan_call = (lambda: ops.shgemm(a, b, blocks=planned[:3],
                                                splits=planned[3]))
            check(torch.equal(tuned_call(), plan_call()),
                  f"autotune {name} {sname}: tuned plan {plan} not bit-identical "
                  f"to the planner's {planned}")
            t = tuned_vs_planned(torch, tuned_call, plan_call)
            entry = at._load_cache(at.cache_path())[at.cache_key(m, n, k, bf16, 2,
                                                                 fused)]
            out[(name, sname)] = {"plan": list(plan), "planned": list(planned),
                                  "sweep_ms": entry["ms"], "swept": timed, **t}
            print(f"[tune] {name} {sname} ({m}x{k} @ {k}x{n}): {timed} plans "
                  f"(bm, bn, bk, splits) timed by CUDA-graph replay, tuned {plan} "
                  f"(sweep "
                  f"{entry['ms']:.4f} ms a call), planner's {planned}; bit for "
                  f"bit; through ops, {TUNE_TIMES}: tuned {t['ms']:.4f} / "
                  f"{t['graph_ms']:.4f}, planned {t['planned_ms']:.4f} / "
                  f"{t['planned_graph_ms']:.4f}; second call a cache hit, 0 "
                  f"timed [{card}]")
        del a, b

    # kernel 4's P at the engine's state
    b_, kvh, s, g, hd, r = at.SHIPPED_DECODE_SHAPES[0]
    timer = at.decode_timer(b_, kvh, s, g, hd, r, 2, dev)
    calls = [0]

    def counted4(*args):
        calls[0] += 1
        return timer(*args)
    p, hit = at.autotune_decode_block(b_, kvh, s, g, hd, r, time_fn=counted4)
    timed = calls[0]
    p2, hit2 = at.autotune_decode_block(b_, kvh, s, g, hd, r, time_fn=counted4)
    check(not hit and timed > 0 and hit2 and p2 == p and calls[0] == timed,
          f"autotune kernel 4: second call timed {calls[0] - timed} P")
    planned = at.planned_decode_block(b_, kvh, s, g, hd, r)
    comp = tuple(min(c, s - 1) for c in (1984, 0, 1024, 1984, 64, 1920, 1984, 1))
    comp = (comp * b_)[:b_]                    # phase 5's full slot
    args = fdec_inputs(torch, gen, b=b_, s=s, h=g * kvh, kvh=kvh, hd=hd, r=r,
                       comp=comp, wp=s - 1, dtype=torch.bfloat16)
    got = ops.factored_decode_attention(*args, s - 1, scale=hd ** -0.5, splits=p)
    want = k4.factored_decode_plain(*args, s - 1, scale=hd ** -0.5)
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2),
          f"kernel 4 at the tuned P={p} disagrees with plain: {err}")
    t = tuned_vs_planned(
        torch, lambda: ops.factored_decode_attention(
            *args, s - 1, scale=hd ** -0.5, splits=p),
        lambda: ops.factored_decode_attention(
            *args, s - 1, scale=hd ** -0.5, splits=planned))
    entry = at._load_cache(at.cache_path())[at.decode_cache_key(b_ * kvh, s, g, hd, r)]
    out["factored_decode"] = {"splits": p, "planned": planned,
                              "sweep_ms": entry["ms"], "swept": timed,
                              "max_abs_err": err, **t}
    print(f"[tune] factored_decode ({b_}, {s}, {kvh}, {hd}) r={r} g={g}: {timed} "
          f"split counts timed by CUDA-graph replay, tuned P={p} (sweep "
          f"{entry['ms']:.4f} ms a call), "
          f"the planner's P={planned}; tuned vs plain at the full slot "
          f"max|kernel-plain| {err:.3e} (phase 5's tol 1e-2; phase 5 bf16 "
          f"{errs5[('fdec', 'bf16')]:.3e}); {TUNE_TIMES}: tuned "
          f"{t['ms']:.4f} / {t['graph_ms']:.4f}, planned {t['planned_ms']:.4f} "
          f"/ {t['planned_graph_ms']:.4f}; second call a cache hit, 0 timed "
          f"[{card}]")
    return out


def phase11_rank(rank, world, dev, *, sizes, key):
    """One rank of 11b's world: distributed_rsvd through kernels 1 and 2 on
    its block of A_exp and A_linear, the range finder, kernel 2 at its Omega
    row offset against its plain version, and a merge across the data axis;
    what it measured, for the parent to check."""
    import torch
    import torch.distributed as dist
    from repro_torch import main_path, stream
    from repro_torch.configs.paper_randnla import PAPER_RSVD
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.kernels import shgemm as k1
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.kernels.ref import dot_f32
    from repro_torch.launch.mesh import HostMesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PAPER_RSVD
    p_hat = cfg.rank + cfg.oversample
    mesh = HostMesh(sizes).bind()
    out = {"coords": mesh.coords(rank), "device": str(dev)}
    # gloo on CUDA tensors: MAX and MIN of int64
    x = torch.tensor([rank, -rank], dtype=torch.int64, device=dev)
    hi, lo = x.clone(), x.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    out["int64_max_min"] = (hi.tolist(), lo.tolist())
    full = main_path.rsvd_inputs(cfg, device=dev)
    blocks = {name: D.shard_matrix(a, mesh) for name, a in full.items()}

    def rel_err(a_blk, res):
        sq = torch.stack([(a_blk - dot_f32(res.u * res.s, res.vt)).square().sum(),
                          a_blk.square().sum()])
        dist.all_reduce(sq)
        return float(torch.sqrt(sq[0] / sq[1]))

    def timed(fn):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    k1.launches = k2.launches = 0
    for method in ("shgemm_pallas", "shgemm_fused"):
        for rep in range(2):           # the second call is the one timed
            res, ms = timed(lambda: D.distributed_rsvd(
                key, blocks["exp"], cfg.rank, mesh, oversample=cfg.oversample,
                method=method))
        out[("rsvd", method)] = {"err": rel_err(blocks["exp"], res),
                                 "s": res.s.cpu(), "ms": ms}
    q = D.distributed_range_finder(key, blocks["exp"], p_hat, mesh,
                                   method="shgemm_fused")
    qtq = dot_f32(q.T, q)
    dist.all_reduce(qtq, group=mesh.group("data"))
    out["qtq_err"] = float((qtq - torch.eye(p_hat, device=dev)).abs().max())
    for it in (0, 2):
        res, ms = timed(lambda: D.distributed_rsvd(
            key, blocks["linear"], cfg.rank, mesh, oversample=cfg.oversample,
            power_iters=it, method="shgemm_fused"))
        out[("power", it)] = {"err": rel_err(blocks["linear"], res), "ms": ms}
    out["launches"] = {"shgemm": k1.launches, "shgemm_fused": k2.launches}

    # kernel 2 at this rank's Omega row offset against its plain version on
    # the materialized Omega slice (phase 2's tolerance)
    a_blk = blocks["exp"]
    off = mesh.index("model") * a_blk.shape[1]
    y = ops.shgemm_fused(a_blk, key, p_hat, row_offset=off)
    plain = k2.shgemm_fused_plain(a_blk, key, p_hat, row_offset=off)
    out["k2"] = {"row_offset": off, "err": (y - plain).abs().max().item(),
                 "ok": bool(torch.allclose(y, plain, rtol=1e-5, atol=1e-4))}

    # merge_across_hosts over the data axis: the data index's row half of
    # A_exp, in 256-row tiles, against the one-process sketch of all of it
    a = full["exp"]
    rows = a.shape[0] // mesh.size("data")
    r0 = mesh.index("data") * rows
    st = stream.init(key, a.shape[1], p_hat, max_rows=a.shape[0],
                     method="shgemm_fused", device=dev)
    for off in range(r0, r0 + rows, STREAM_TILE):
        stream.update(st, a[off:min(off + STREAM_TILE, r0 + rows)], off)
    merged = stream.merge_across_hosts(st, mesh.group("data"))
    one = ops.shgemm_fused(a, key, p_hat)
    out["merge"] = {"bitwise": bool(torch.equal(merged.y, one)),
                    "rows_seen": merged.rows_seen}
    return out


def phase11_distributed(torch, dev, card) -> dict:
    """11b: a 2 x 2 gloo world on the one card (``phase11_rank``), checked
    here against the single-process rSVD; then the single-controller
    streamed driver over four sources cut from phase 9's matrix, bit for bit
    against ``rsvd_streamed`` and resumed after a fault bit for bit."""
    import tempfile

    import numpy as np
    from repro_torch import main_path, stream
    from repro_torch.configs.paper_randnla import PAPER_RSVD
    from repro_torch.convert import key_from_seed
    from repro_torch.core import distributed as D
    from repro_torch.core import rsvd
    from repro_torch.kernels import shgemm as k1
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.launch import world
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.stream import resilience as resil

    key = key_from_seed(7)
    cfg = PAPER_RSVD
    out = {}
    t0 = time.perf_counter()
    ranks = world.run_world("chip_smoke:phase11_rank", math.prod(DIST_WORLD),
                            kwargs={"sizes": DIST_WORLD, "key": key},
                            backend="gloo", device="cuda", timeout=DIST_TIMEOUT)
    t_world = time.perf_counter() - t0
    n_ranks = len(ranks)
    for r in ranks:
        check(r["int64_max_min"] == ([n_ranks - 1, 0], [0, -(n_ranks - 1)]),
              f"gloo int64 MAX/MIN on the card: {r['int64_max_min']}")
    inputs = main_path.rsvd_inputs(cfg, device=dev)
    for method in ("shgemm_pallas", "shgemm_fused"):
        one = rsvd.rsvd(key, inputs["exp"], cfg.rank, oversample=cfg.oversample,
                        method=method)
        e_f32 = float(rsvd.reconstruction_error(inputs["exp"], rsvd.rsvd(
            key, inputs["exp"], cfg.rank, oversample=cfg.oversample, method="f32")))
        limit = main_path.error_limit("rsvd", e_f32)
        errs = [r[("rsvd", method)]["err"] for r in ranks]
        s_rank = ranks[0][("rsvd", method)]["s"].to(dev)
        check(all(e <= limit for e in errs), f"distributed_rsvd {method}: "
              f"errors {errs} over phase 3's limit {limit:.3e}")
        check(torch.allclose(s_rank[:16], one.s[:16], rtol=1e-2),
              f"distributed_rsvd {method}: singular values off the one-process rSVD")
        check(all(torch.equal(r[("rsvd", method)]["s"], ranks[0][("rsvd", method)]["s"])
                  for r in ranks), f"distributed_rsvd {method}: ranks' s differ")
        out[("rsvd", method)] = {"err": errs[0], "limit": limit,
                                 "ms": [r[("rsvd", method)]["ms"] for r in ranks]}
        print(f"[dist] distributed_rsvd {method} A_exp {cfg.n}^2 rank {cfg.rank}+"
              f"{cfg.oversample} on a {DIST_WORLD} (data, model) gloo world of "
              f"{n_ranks} processes on one card, blocks "
              f"{cfg.n // DIST_WORLD[0]}x{cfg.n // DIST_WORLD[1]}: rel. error "
              f"{errs[0]:.4e} (phase 3's limit {limit:.4e} = 1.5x f32 + 1e-7); "
              f"s[:16] within rtol 1e-2 of the one-process rSVD (max rel "
              f"{((s_rank[:16] - one.s[:16]).abs() / one.s[:16]).max().item():.2e}); "
              f"wall ms a call by rank "
              f"{[round(r[('rsvd', method)]['ms'], 3) for r in ranks]} "
              f"(four ranks share one card: these times say nothing of scaling) [{card}]")
    qtq = max(r["qtq_err"] for r in ranks)
    check(qtq <= 1e-4, f"distributed range finder: max|Q^T Q - I| {qtq:.3e}")
    s_lin = rsvd.singular_values_linear(cfg.n, cfg.rank, cfg.s_p, device=dev)
    floor = float(s_lin[cfg.rank:].norm() / s_lin.norm())
    e0, e2 = ranks[0][("power", 0)]["err"], ranks[0][("power", 2)]["err"]
    check(e2 < e0 and e2 < 1.02 * floor, f"distributed power iterations on "
          f"A_linear: {e2:.4e} (q=0 {e0:.4e}), floor {floor:.4e}")
    k2s = [r["k2"] for r in ranks]
    check(all(k["ok"] for k in k2s), f"kernel 2 at a rank's row offset != plain: {k2s}")
    check(all(r["merge"]["bitwise"] and r["merge"]["rows_seen"] == cfg.n
              for r in ranks), "merge_across_hosts != the one-process sketch")
    launches = [r["launches"] for r in ranks]
    check(all(lc["shgemm"] > 0 and lc["shgemm_fused"] > 0 for lc in launches),
          f"a kernel of the distributed path was never launched: {launches}")
    out.update(qtq_err=qtq, power={"q0": e0, "q2": e2, "floor": floor},
               k2_err=max(k["err"] for k in k2s), rank_launches=launches,
               world_s=t_world)
    print(f"[dist] range finder max|Q^T Q - I| {qtq:.2e} (<= 1e-4); A_linear "
          f"power_iters=2 rel. error {e2:.4e} (q=0 {e0:.4e}), Eckart-Young "
          f"floor {floor:.4e} (ratio {e2 / floor:.5f} <= 1.02); kernel 2 at each "
          f"rank's row offset {[k['row_offset'] for k in k2s]} vs plain on the "
          f"Omega slice: max|kernel-plain| {out['k2_err']:.3e} (rtol 1e-5, atol "
          f"1e-4); merge_across_hosts of the two data halves ({STREAM_TILE}-row tiles) "
          f"== the one-process kernel-2 sketch, bit for bit; gloo int64 MAX/MIN "
          f"on CUDA tensors right; kernel launches by rank (counts set to 0 "
          f"in each rank before its runs) {launches}; the world took "
          f"{t_world:.1f} s (spawn and CUDA start-up included)")

    # the single-controller streamed driver over four sources
    host = inputs["exp"].cpu()
    rows = host.shape[0] // DIST_HOSTS
    srcs = [stream.ArraySource(host[h * rows:(h + 1) * rows], STREAM_TILE)
            for h in range(DIST_HOSTS)]
    mesh = HostMesh((DIST_HOSTS,), ("data",))
    k1.launches = k2.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        res_d = D.distributed_rsvd_streamed(
            key, srcs, cfg.rank, mesh, oversample=cfg.oversample,
            checkpoint_dir=tmp / "d", checkpoint_every_tiles=1000)
        torch.cuda.synchronize()
        ms_d = (time.perf_counter() - t0) * 1e3
        res_s = rsvd.rsvd_streamed(key, stream.ArraySource(host, STREAM_TILE),
                                   cfg.rank, oversample=cfg.oversample,
                                   checkpoint_dir=tmp / "s",
                                   checkpoint_every_tiles=1000)

        def last(ck, name):
            return np.load(sorted((tmp / ck).glob("ckpt_*"))[-1] / f"{name}.npy")
        y_d, y_s = last("d", "done.y"), last("s", "state.y")
        check(np.array_equal(y_d, y_s), "distributed_rsvd_streamed's merged "
              "sketch != rsvd_streamed's, bit for bit")
        # B is the per-host partials' sum here and one running sum there:
        # f32 reassociation moves A_exp's tail (s down to 1e-4 s_0, gaps of
        # 3.5 %) by more than 1e-4, so the factors are held as phase 9 holds
        # singular values (svals_close) and as the reference test holds the
        # reconstruction (within 1e-5); the factors' differences are printed
        signs = torch.sign((res_d.u * res_s.u).sum(0))
        du = ((res_d.u * signs - res_s.u).abs() > 1e-5 + 1e-4 * res_s.u.abs()).any(0)
        dv = ((res_d.vt * signs[:, None] - res_s.vt).abs()
              > 1e-5 + 1e-4 * res_s.vt.abs()).any(1)
        first_off = int(torch.nonzero(du | dv)[0]) if bool((du | dv).any()) else None
        e_d = float(rsvd.reconstruction_error(inputs["exp"], res_d))
        e_s = float(rsvd.reconstruction_error(inputs["exp"], res_s))
        check(svals_close(torch, res_d.s, res_s.s) and abs(e_d - e_s) <= 1e-5,
              f"distributed_rsvd_streamed off rsvd_streamed: errors {e_d:.4e} vs "
              f"{e_s:.4e}")
        h, t = DIST_FAULT
        faulty = list(srcs)
        faulty[h] = resil.FaultySource(srcs[h], fail_at_tile=t)
        try:
            D.distributed_rsvd_streamed(key, faulty, cfg.rank, mesh,
                                        oversample=cfg.oversample,
                                        checkpoint_dir=tmp / "f",
                                        checkpoint_every_tiles=2)
            check(False, "the streamed driver's fault never fired")
        except resil.FaultInjected:
            pass
        got, rep = D.distributed_rsvd_streamed(
            key, srcs, cfg.rank, mesh, oversample=cfg.oversample,
            checkpoint_dir=tmp / "f", checkpoint_every_tiles=2, resume=True,
            return_report=True)
        check(same_bits(torch, got, res_d) and rep.attempts == 2,
              f"the resumed distributed_rsvd_streamed != the uninterrupted run ({rep})")
    torch.cuda.synchronize()
    out["streamed"] = {"launches": {"shgemm": k1.launches,
                                    "shgemm_fused": k2.launches},
                       "ms": ms_d, "tiles_recomputed": rep.tiles_recomputed,
                       "err": e_d, "err_single_host": e_s,
                       "factors_within_1e-4_to_pair": first_off}
    check(k2.launches > 0, "kernel 2 never launched by the streamed driver")
    print(f"[dist] distributed_rsvd_streamed over {DIST_HOSTS} sources of {rows} "
          f"rows of A_exp ({STREAM_TILE}-row tiles from host memory), one "
          f"controller: the merged sketch == rsvd_streamed's over the whole "
          f"source bit for bit; singular values within svals_close, rel. "
          f"errors {e_d:.6e} / {e_s:.6e} (within 1e-5); sign-aligned factors "
          f"within rtol 1e-4 / atol 1e-5 up to singular pair {first_off} of "
          f"{cfg.rank} (None: all); a raised "
          f"fault at source {h}'s tile {t}, resumed: == the uninterrupted run bit "
          f"for bit (tiles recomputed {rep.tiles_recomputed}); "
          f"{ms_d:.1f} ms wall (checkpointed); kernel launches {out['streamed']['launches']} [{card}]")
    return out


# ---------------------------------------------------------------------------
# 12. training with the paper's RandNLA optimizers
# ---------------------------------------------------------------------------

TRAIN_SEQ = 1024           # cut from train_4k's 4096 x 256 (PERF.md §4)
TRAIN_BATCH = 8
TRAIN_MICRO = 2
TRAIN_STEPS = 6
TRAIN_LR = 3e-4
TRAIN_TRACE_STEP = 4       # 0-based: the traced step, t = 5, a GaLore refresh
GALORE_RANK, GALORE_REFRESH, GALORE_OVERSAMPLE = 64, 2, 8
COMP_RANK = 32
TRAIN_CONFIGS = ("adamw", "galore shgemm_fused", "galore shgemm_pallas",
                 "galore f32", "compressed adamw")
MICRO_SPLIT = 4            # 12b: microbatches of the accumulation gate
LOOP_LAYERS, LOOP_EVERY, LOOP_RESUME_AT = 4, 2, 4
LOOP_TIMEOUT = 600
TRAIN_WORLD = 2            # 12d: gloo ranks on the one card
SHGEMM_NAMES = ("shgemm_kernel", "shgemm_fused_kernel", "splitk_reduce")
# The child of 12c: the loop, checkpoints, resume and retry under
# deterministic algorithms (the embedding's backward adds with atomics).
LOOP_CHILD = (
    "import json, sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke\n"
    "out = chip_smoke.phase12_loop(sys.argv[2])\n"
    "print(json.dumps(out))\n")


def tree_tensors(tree) -> list:
    """Every tensor of a nested dict / tuple / list (None skipped)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_tensors(v)]
    return [] if tree is None else [tree]


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


def traced_call(torch, fn):
    """One call of ``fn`` under torch.profiler: its result, the wall ms
    (ending in a synchronize) and the device ms of each kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = {ev.key: ev.self_device_time_total / 1e3 for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}
    return out, wall, rows


def training_optimizer(name: str):
    """The optimizer of one 12b configuration."""
    from repro_torch.optim import compression, galore
    from repro_torch.optim import optimizers as opt
    if name.startswith("galore"):
        return galore.galore(TRAIN_LR, rank=GALORE_RANK, refresh_every=GALORE_REFRESH,
                             method=name.split()[1], oversample=GALORE_OVERSAMPLE)
    inner = opt.adamw(TRAIN_LR)
    if name == "adamw":
        return inner

    # AdamW on the compressed gradients, as the reference's
    # test_compression_training_converges drives it
    def init(params):
        return {"compression": compression.init_state(params),
                "adamw": inner.init(params)}

    def update(grads, state, params):
        red, cst = compression.compress_and_reduce(
            grads, state["compression"], rank=COMP_RANK, method="shgemm_fused")
        upd, ast = inner.update(red, state["adamw"], params)
        return upd, {"compression": cst, "adamw": ast}

    return opt.Optimizer(init, update)


def timed_optimizer(torch, tx, times: list, keep: dict | None = None):
    """``tx`` with each update timed (synchronized, ms into ``times``);
    ``keep``, if empty, receives a copy of the first call's gradients."""
    from repro_torch.optim.optimizers import Optimizer

    def update(grads, state, params):
        if keep is not None and not keep:
            keep.update({k: g.clone() for k, g in grads.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tx.update(grads, state, params)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    return Optimizer(tx.init, update)


def phase12_kernels(torch, dev, card, key, cfg) -> dict:
    """12a: kernels 1 and 2 at the training slice's shapes against their
    plain versions (phase 2's tolerance), each timed through its ``ops``
    entry (what the path calls: A padded or copied first where the blocks
    need it) and alone on operands padded beforehand, beside its plain
    version, the f32 torch.matmul of the same product and its bound; the
    compression basis's draw and QR and the transposed-A copy timed
    apart."""
    from repro_torch.core import projection as proj
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import shgemm as k1
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.optim import compression

    cfg_v, cfg_d = cfg.vocab, cfg.d_model   # the embedding's (151936, 1024)
    gen = torch.Generator(device=dev).manual_seed(12)
    a = torch.randn((cfg_v, cfg_d), generator=gen, device=dev) / math.sqrt(cfg_d)
    p_hat = GALORE_RANK + GALORE_OVERSAMPLE
    omega = proj.materialize_omega(key, (cfg_d, p_hat), device=dev)
    q = compression._draw_basis(key, 0, cfg_v, COMP_RANK, "shgemm_fused", dev)
    q_low = q.to(torch.bfloat16)
    a_t = a.T                               # what compress_and_reduce projects

    def kernel_alone(name, a_, b_, n, plan):
        """The kernel's own launch at ``plan`` on operands padded here."""
        bm, bn, bk, splits = plan
        a_pad = ops._pad_to(a_, bm, bk)
        if name == "shgemm":
            b_pad = ops._pad_to(b_, bk, bn)
            return lambda: k1.shgemm_pallas(a_pad, b_pad, bm=bm, bn=bn, bk=bk,
                                            splits=splits)
        n_pad = n + (-n) % bn
        return lambda: k2.shgemm_fused_pallas(a_pad, key, n_pad, bm=bm, bn=bn,
                                              bk=bk, splits=splits)

    out = {}
    cases = (
        ("shgemm_fused", "galore_refresh", (cfg_v, cfg_d, p_hat), a, None,
         lambda: ops.shgemm_fused(a, key, p_hat),
         lambda: k2.shgemm_fused_plain(a, key, p_hat),
         lambda: torch.matmul(a, omega.float()), 0),
        ("shgemm", "galore_refresh", (cfg_v, cfg_d, p_hat), a, omega,
         lambda: ops.shgemm(a, omega), lambda: k1.shgemm_plain(a, omega, 2),
         lambda: torch.matmul(a, omega.float()), cfg_d * p_hat * 2),
        ("shgemm", "compression", (cfg_d, cfg_v, COMP_RANK), a_t, q_low,
         lambda: ops.shgemm(a_t, q_low), lambda: k1.shgemm_plain(a_t, q_low, 2),
         lambda: torch.matmul(a_t, q_low.float()), cfg_v * COMP_RANK * 2))
    for name, what, (m, k, n), a_, b_, entry, plain, lib, omega_bytes in cases:
        got, want = entry(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-4),
              f"{name} at the training slice's {what} shape disagrees with plain")
        del got, want
        plan = autotune.pick_blocks(m, n, k, fused=name == "shgemm_fused",
                                    device=dev)
        alone = kernel_alone(name, a_, b_, n, plan)
        t_e, t_eg = median_ms(torch, entry), graph_ms(torch, entry)
        t_k = graph_ms(torch, alone)
        del alone
        t_p = median_ms(torch, plain)
        t_l, t_lg = median_ms(torch, lib), graph_ms(torch, lib)
        t_b, by = bound_ms(m, k, n, 2, omega_bytes)
        n_pad = n + (-n) % plan[1]
        pads = [(m, k), (m + (-m) % plan[0], k + (-k) % plan[2])]
        rec = {"shape": [m, k, n], "plan": list(plan), "padded_n": n_pad,
               "padded_a": pads[1], "ms": t_e, "entry_graph_ms": t_eg,
               "kernel_graph_ms": t_k, "plain_ms": t_p, "library_ms": t_l,
               "library_graph_ms": t_lg, "bound_ms": t_b, "bound_by": by,
               "max_abs_err": err}
        out[(name, what)] = rec
        copied = (what == "compression" or pads[0] != pads[1])
        print(f"[train] 12a {name} {what} ({m}x{k} @ {k}x{n}"
              f"{', A transposed' if what == 'compression' else ''}), plan "
              f"(bm, bn, bk, splits) {plan}, n padded to {n_pad} ({n_pad - n} "
              f"wasted columns), A {'copied to ' + str(tuple(pads[1])) if copied else 'as it is'}"
              f" by ops._pad_to: max|kernel-plain| {err:.3e} (rtol 1e-5, atol "
              f"1e-4); the ops entry {t_e:.4f} ms by events ({t_eg:.4f} replayed "
              f"from a CUDA graph), the kernel alone {t_k:.4f} (graph), plain "
              f"{t_p:.4f} ms, f32 matmul {t_l:.4f} ms (graph {t_lg:.4f}), bound "
              f"{t_b:.4f} ms ({by}); kernel/bound {t_k / t_b:.2f}x [{card}]")
    # what the compression path costs around kernel 1
    t_copy = graph_ms(torch, lambda: a_t.contiguous())
    draws = interleaved_host_ms(torch, {
        m: (lambda m=m: compression._draw_basis(key, 0, cfg_v, COMP_RANK, m, dev))
        for m in ("shgemm_fused", "f32")}, REPS)
    om = proj.fused_omega(key, (cfg_v, COMP_RANK), dtype=torch.float32, device=dev)
    t_qr = median_ms(torch, lambda: torch.linalg.qr(om))
    out["compression_costs"] = {"transpose_copy_graph_ms": t_copy,
                                "draw_basis_ms": draws, "qr_ms": t_qr,
                                "copy_bytes": a.numel() * 4}
    print(f"[train] 12a compression around kernel 1: A^T's contiguous copy alone "
          f"({a.numel() * 4 / 1e6:.0f} MB) {t_copy:.4f} ms (graph); the basis "
          f"(Omega ({cfg_v}, {COMP_RANK}) f32 drawn with eager int64 ops, then "
          f"torch.linalg.qr) "
          + ", ".join(f"{m} {t:.3f} ms" for m, t in draws.items())
          + f" (host clock), of it the QR {t_qr:.4f} ms [{card}]")
    return out


def phase12_steps(torch, dev, card) -> dict:
    """12b: six steps of qwen3-0.6b at full width and depth in each of the
    five configurations, each timed and traced; then the projection-error,
    compression and microbatch gates on the captured embedding gradient."""
    from repro_torch.convert import key_from_seed
    from repro_torch.core import rsvd
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import shgemm as k1
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.launch import serve as launch
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.optim import compression, galore

    cfg = R.get_arch(ARCH)
    check(not cfg.use_flash_kernel, "training runs the plain attention")
    params = launch.init_weights(cfg, seed=0, device=dev)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=0)
    batches = [data.batch(i) for i in range(TRAIN_STEPS)]
    adam_b, galore_b = galore.optimizer_state_bytes(params, rank=GALORE_RANK)
    wire_full, wire_comp = compression.wire_bytes(params, rank=COMP_RANK)
    print(f"[train] 12b {ARCH} at full width and depth ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{T.param_count(cfg) / 1e6:.2f} M parameters, random f32 masters from "
          f"seed 0, bf16 activations, plain attention); SyntheticLM seq "
          f"{TRAIN_SEQ} x global batch {TRAIN_BATCH}, micro_batches={TRAIN_MICRO} "
          f"(cut from train_4k's 4096 x 256); {TRAIN_STEPS} steps a "
          f"configuration, lr {TRAIN_LR}; GaLore rank {GALORE_RANK} + "
          f"{GALORE_OVERSAMPLE}, refresh_every={GALORE_REFRESH}; compression "
          f"rank {COMP_RANK}")
    real_rf = rsvd.range_finder
    refresh_ms: list = []

    def timed_rf(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_rf(*a, **kw)
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    out, grads = {}, {}
    rsvd.range_finder = timed_rf
    try:
        for name in TRAIN_CONFIGS:
            opt_ms: list = []
            refresh_ms.clear()
            tx = timed_optimizer(torch, training_optimizer(name), opt_ms,
                                 grads if name == "adamw" else None)
            step = R.make_train_step(cfg, tx, micro_batches=TRAIN_MICRO)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k1.launches = k2.launches = 0
            p, s = params, step.init_opt(params)
            losses, step_ms = [], []
            for i in range(TRAIN_STEPS):
                b = batches[i]
                if i == TRAIN_TRACE_STEP:
                    (p, s, met), wall, rows = traced_call(
                        torch, lambda p=p, s=s, b=b: step(p, s, b))
                else:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    p, s, met = step(p, s, b)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(met["loss"]))
            launches = {"shgemm": k1.launches, "shgemm_fused": k2.launches}
            peak = torch.cuda.max_memory_allocated() / 2**30
            busy = sum(rows.values())
            kern = {k: v for k, v in rows.items()
                    if any(n in k for n in SHGEMM_NAMES)}
            state_b = tree_bytes(s)
            rec = {"losses": losses, "step_ms": step_ms,
                   "median_step_ms": sorted(step_ms)[len(step_ms) // 2],
                   "optimizer_ms": opt_ms,
                   "median_optimizer_ms": sorted(opt_ms)[len(opt_ms) // 2],
                   "refresh_ms": list(refresh_ms), "traced_wall_ms": wall,
                   "traced_device_ms": busy, "kernel_device_ms": kern,
                   "top_kernels": sorted(rows.items(), key=lambda r: -r[1])[:10],
                   "peak_gib": peak, "state_bytes": state_b,
                   "launches": launches}
            out[name] = rec
            check(all(math.isfinite(v) for v in losses),
                  f"training {name}: a loss is not finite: {losses}")
            print(f"[train] 12b {name}: losses "
                  f"{[round(v, 4) for v in losses]}; step {rec['median_step_ms']:.1f} "
                  f"ms (median of {len(step_ms)} untraced), optimizer "
                  f"{rec['median_optimizer_ms']:.2f} ms (median), refreshes "
                  f"{[round(v, 3) for v in refresh_ms]} ms; traced step "
                  f"{TRAIN_TRACE_STEP + 1}: wall {wall:.1f} ms, device {busy:.1f} ms "
                  f"(busy {100 * busy / wall:.0f}%), kernels 1-2 by the profiler "
                  + (", ".join(f"{k[:60]} {v:.4f} ms" for k, v in kern.items())
                     or "none")
                  + "; top kernels "
                  + ", ".join(f"{k[:40]} {v:.1f} ms" for k, v in
                              sorted(rows.items(), key=lambda r: -r[1])[:5])
                  + f"; peak memory {peak:.2f} GiB; optimizer state {state_b} B "
                  f"(optimizer_state_bytes: Adam {adam_b}, GaLore {galore_b}; "
                  f"wire_bytes: full {wire_full}, compressed {wire_comp}); "
                  f"launches {launches} [{card}]")
            del p, s, met
            torch.cuda.empty_cache()
    finally:
        rsvd.range_finder = real_rf

    n_refresh = len(range(1, TRAIN_STEPS + 1, GALORE_REFRESH))
    check(out["galore shgemm_fused"]["launches"]["shgemm_fused"] == n_refresh
          and out["galore shgemm_pallas"]["launches"]["shgemm"] == n_refresh
          and out["compressed adamw"]["launches"]["shgemm"] == TRAIN_STEPS,
          f"a kernel of the training path was not launched as expected: "
          f"{ {n: r['launches'] for n, r in out.items()} }")
    # the formula counts the moments and bases; the states add the int32
    # step counter and GaLore's two uint32 key words
    check(out["galore f32"]["state_bytes"] == galore_b + 4 + 8
          and out["adamw"]["state_bytes"] == adam_b + 4,
          "optimizer state bytes differ from optimizer_state_bytes()")

    # gates on the captured embedding gradient, scaled by a power of two to
    # unit RMS (exact), so that the absolute tolerances mean what they say
    g = grads["embed/tokens"]
    scale = 2.0 ** -round(math.log2(float(g.square().mean().sqrt())))
    g = g * scale
    key = key_from_seed(1729)
    errs = {}
    for m in ("f32", "shgemm_pallas", "shgemm_fused"):
        q = rsvd.range_finder(key, g, GALORE_RANK, oversample=GALORE_OVERSAMPLE,
                              method=m)[:, :GALORE_RANK]
        errs[m] = float(rsvd.projection_error(g, q) / torch.linalg.norm(g))
    limit = 1.5 * errs["f32"] + 1e-7
    check(errs["shgemm_fused"] <= limit and errs["shgemm_pallas"] <= limit,
          f"GaLore projection error over phase 3's limit: {errs}, limit {limit}")
    leaf = {"embed/tokens": g}
    st0 = compression.init_state(leaf)
    red = {m: compression.compress_and_reduce(leaf, st0, rank=COMP_RANK,
                                              method=m)[0]["embed/tokens"]
           for m in ("f32", "shgemm_pallas")}
    comp_rel = float((red["shgemm_pallas"] - red["f32"]).norm() / red["f32"].norm())
    check(comp_rel <= 1e-4, f"compression through kernel 1 vs f32: {comp_rel:.3e}")
    norm = grads["final_norm/scale"]
    micro = [{"embed/tokens": (0.3 + 0.2 * j) * torch.roll(g, 997 * j, 0),
              "final_norm/scale": (0.3 + 0.2 * j) * norm} for j in range(MICRO_SPLIT)]
    total = {k: sum(mb[k] for mb in micro) for k in micro[0]}
    st = compression.init_state(total)
    one, one_st = compression.compress_and_reduce(total, st, rank=COMP_RANK,
                                                  method="shgemm_fused")
    ms = compression.begin_accumulation(st, micro[0], rank=COMP_RANK,
                                        method="shgemm_fused")
    for mb in micro:
        ms = compression.accumulate_microbatch(ms, mb, method="shgemm_fused")
    acc, acc_st = compression.finish_accumulation(ms)
    mb_err = (acc["embed/tokens"] - one["embed/tokens"]).abs().max().item()
    check(torch.allclose(acc["embed/tokens"], one["embed/tokens"], rtol=1e-4, atol=1e-4)
          and torch.allclose(acc_st.residual["embed/tokens"],
                             one_st.residual["embed/tokens"], rtol=1e-4, atol=1e-4)
          and torch.equal(acc["final_norm/scale"], one["final_norm/scale"]),
          f"microbatch accumulation != compress_and_reduce of the sum ({mb_err:.3e})")
    out["gates"] = {"projection_error": errs, "limit": limit,
                    "compression_rel": comp_rel, "microbatch_max_abs": mb_err,
                    "grad_scale": scale}
    print(f"[train] 12b gates on the step-1 embedding gradient ({tuple(g.shape)}, "
          f"scaled by 2^{round(math.log2(scale))} to unit RMS): GaLore's range "
          f"finder rank {GALORE_RANK} + {GALORE_OVERSAMPLE}, ||G - PP^T G||/||G|| "
          + ", ".join(f"{m} {e:.6e}" for m, e in errs.items())
          + f" (limit 1.5x f32 + 1e-7 = {limit:.6e}); compression rank {COMP_RANK} "
          f"through kernel 1 vs f32 on the same Q: ||d||/||ref|| {comp_rel:.3e} "
          f"(<= 1e-4); {MICRO_SPLIT} microbatches accumulated vs compress_and_reduce "
          f"of their sum: max|d| {mb_err:.3e} (rtol 1e-4, atol 1e-4), the norm "
          f"leaf bit for bit [{card}]")
    del params, grads, g
    torch.cuda.empty_cache()
    return out


def phase12_loop(tmp: str) -> dict:
    """12c, in a child process with deterministic algorithms: ``train`` with
    GaLore (kernel 2) on qwen3-0.6b cut to LOOP_LAYERS layers, checkpoints
    every LOOP_EVERY steps; the uninterrupted run, a run to LOOP_RESUME_AT
    resumed to TRAIN_STEPS, and a run whose step raises once, compared bit
    for bit.  Returns what it measured."""
    import shutil

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.launch import serve as launch
    from repro_torch.models import registry as R
    from repro_torch.optim import galore
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import LoopConfig, train

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp)
    dev = torch.device("cuda")
    cfg = R.get_arch(ARCH).with_(n_layers=LOOP_LAYERS)
    params = launch.init_weights(cfg, seed=0, device=dev)
    tx = galore.galore(TRAIN_LR, rank=GALORE_RANK, refresh_every=GALORE_REFRESH,
                       method="shgemm_fused", oversample=GALORE_OVERSAMPLE)
    step = R.make_train_step(cfg, tx, micro_batches=TRAIN_MICRO)
    opt0 = step.init_opt(params)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                       seed=0)

    def same(x, y):
        xs, ys = tree_tensors(x), tree_tensors(y)
        return len(xs) == len(ys) and all(
            a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) for a, b in zip(xs, ys))

    def run(name, total, fn=step):
        lcfg = LoopConfig(total_steps=total, ckpt_every=LOOP_EVERY,
                          ckpt_dir=str(tmp / name), keep=2)
        t0 = time.perf_counter()
        res = train(fn, params, opt0, data, lcfg, return_state=True)
        return res, time.perf_counter() - t0

    out = {}
    k2.launches = 0
    (p_c, o_c, hist_c, st_c), t_clean = run("clean", TRAIN_STEPS)
    ck_bytes = dir_bytes(tmp / "clean" / f"step_{TRAIN_STEPS}")
    shutil.rmtree(tmp / "clean")
    out["clean"] = {"losses": [h["loss"] for h in hist_c],
                    "step_s": [h["dt"] for h in hist_c], "seconds": t_clean,
                    "retries": st_c.retries, "rollbacks": st_c.rollbacks,
                    "checkpoint_bytes": ck_bytes, "kernel2_launches": k2.launches}
    (p4, o4, _, st4), t_first = run("resume", LOOP_RESUME_AT)
    (saved, step_saved) = CheckpointManager(tmp / "resume").restore((p4, o4))
    out["restored_bitwise"] = step_saved == LOOP_RESUME_AT and same(saved, (p4, o4))
    del saved
    (p_r, o_r, hist_r, st_r), t_resume = run("resume", TRAIN_STEPS)
    shutil.rmtree(tmp / "resume")
    out["resume"] = {"resumed_from": st_r.resumed_from,
                     "steps": [h["step"] for h in hist_r],
                     "losses": [h["loss"] for h in hist_r],
                     "seconds": [t_first, t_resume],
                     "retries": st4.retries + st_r.retries,
                     "rollbacks": st4.rollbacks + st_r.rollbacks,
                     "bitwise": same((p_r, o_r), (p_c, o_c)),
                     "losses_equal": [h["loss"] for h in hist_r]
                     == out["clean"]["losses"][LOOP_RESUME_AT:]}
    del p_r, o_r, p4, o4
    calls = {"n": 0}

    def flaky(p, o, b):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated preemption")
        return step(p, o, b)

    (p_f, o_f, hist_f, st_f), t_flaky = run("flaky", TRAIN_STEPS, flaky)
    shutil.rmtree(tmp / "flaky")
    out["flaky"] = {"retries": st_f.retries, "rollbacks": st_f.rollbacks,
                    "steps": len(hist_f), "seconds": t_flaky,
                    "bitwise": same((p_f, o_f), (p_c, o_c))}
    out["deterministic"] = torch.are_deterministic_algorithms_enabled()
    out["cublas_workspace"] = __import__("os").environ.get("CUBLAS_WORKSPACE_CONFIG")
    return out


def phase12_rank(rank, world, dev, *, grad_seed, method, shape):
    """12d: one gloo rank's compress_and_reduce over the world's group on a
    full-size embedding gradient and one norm leaf (rank r's gradients come
    from seed grad_seed + r, so each rank can make every rank's), against
    the mean of every rank's single-process g_hat made here."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import shgemm as k1
    from repro_torch.optim import compression

    torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def grads_of(r):
        gen = torch.Generator(device=dev).manual_seed(grad_seed + r)
        return {"embed/tokens": torch.randn(shape, generator=gen, device=dev),
                "final_norm/scale": torch.randn(shape[1:], generator=gen, device=dev)}

    mine = grads_of(rank)
    st = compression.init_state(mine)
    k1.launches = 0
    compression.compress_and_reduce(mine, st, rank=COMP_RANK, method=method,
                                    group=dist.group.WORLD)      # warm-up
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    red, new_st = compression.compress_and_reduce(mine, st, rank=COMP_RANK,
                                                  method=method, group=dist.group.WORLD)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    launches = k1.launches
    singles = [compression.compress_and_reduce(grads_of(r), st, rank=COMP_RANK,
                                               method=method)[0]["embed/tokens"]
               for r in range(world)]
    mean = sum(singles) / world
    got = red["embed/tokens"]
    norm_sum = sum(grads_of(r)["final_norm/scale"] for r in range(world))
    res_want = mine["embed/tokens"] - world * mean
    return {"max_abs": (got - mean).abs().max().item(),
            "rel": float((got - mean).norm() / mean.norm()),
            "ok": bool(torch.allclose(got, mean, rtol=1e-4, atol=1e-6)),
            "residual_ok": bool(torch.allclose(new_st.residual["embed/tokens"],
                                               res_want, rtol=1e-4, atol=1e-4)),
            "norm_exact": bool(torch.equal(red["final_norm/scale"], norm_sum)),
            "ms": ms, "launches": launches}


def phase12_training(torch, dev, card) -> dict:
    """Phase 12: 12a kernels at the slice's shapes, 12b the five training
    configurations at full width and depth with their gates, 12c the loop's
    checkpoints, resume and retry in a deterministic child, 12d compression
    across two gloo ranks on the card."""
    import os
    import tempfile

    from repro_torch.convert import key_from_seed
    from repro_torch.launch import world
    from repro_torch.models import registry as R

    t_phase = time.perf_counter()
    cfg = R.get_arch(ARCH)
    out = {"kernels": phase12_kernels(torch, dev, card, key_from_seed(20), cfg)}
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    out["steps"] = phase12_steps(torch, dev, card)
    t_b = time.perf_counter()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", LOOP_CHILD, str(ROOT), tmp],
            capture_output=True, text=True, timeout=LOOP_TIMEOUT,
            env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
        t_child = time.perf_counter() - t0
    check(child.returncode == 0, f"the 12c child failed: rc {child.returncode}, "
          f"{child.stderr[-3000:]}")
    loop = json.loads(child.stdout.strip().splitlines()[-1])
    out["loop"] = loop
    c, r, f = loop["clean"], loop["resume"], loop["flaky"]
    check(loop["deterministic"] and loop["cublas_workspace"] == ":4096:8",
          "the 12c child did not run deterministic")
    check(c["retries"] == c["rollbacks"] == r["retries"] == r["rollbacks"] == 0,
          f"a clean run retried or rolled back: {c}, {r}")
    check(all(math.isfinite(v) for v in c["losses"]), f"12c losses {c['losses']}")
    check(c["kernel2_launches"] > 0, "kernel 2 never launched in the loop")
    check(loop["restored_bitwise"], "restored params / optimizer state != the saved ones")
    check(r["resumed_from"] == LOOP_RESUME_AT and r["bitwise"] and r["losses_equal"],
          f"the resumed run != the uninterrupted run bit for bit: {r}")
    check(f["retries"] == 1 and f["rollbacks"] == 0 and f["bitwise"],
          f"a step raising once: {f}")
    print(f"[train] 12c train() with GaLore shgemm_fused on {ARCH} cut to "
          f"{LOOP_LAYERS} layers at full width, a checkpoint every {LOOP_EVERY} "
          f"steps ({c['checkpoint_bytes'] / 2**30:.2f} GiB each), in a child with "
          f"torch.use_deterministic_algorithms(True) and CUBLAS_WORKSPACE_CONFIG="
          f":4096:8: {TRAIN_STEPS} clean steps in {c['seconds']:.1f} s (steps "
          f"{[round(s * 1e3, 1) for s in c['step_s']]} ms, losses "
          f"{[round(v, 4) for v in c['losses']]}), 0 retries, 0 rollbacks; "
          f"{LOOP_RESUME_AT} steps then resumed to {TRAIN_STEPS} ({r['seconds'][0]:.1f} "
          f"+ {r['seconds'][1]:.1f} s): restored state == saved bit for bit, "
          f"resumed params and optimizer state == the uninterrupted run's bit for "
          f"bit; a step raising once: {f['retries']} retry, {f['rollbacks']} "
          f"rollbacks, params == the clean run's bit for bit; kernel 2 launches "
          f"{c['kernel2_launches']} in the clean run; child {t_child:.1f} s [{card}]")

    t0 = time.perf_counter()
    ranks = world.run_world("chip_smoke:phase12_rank", TRAIN_WORLD,
                            kwargs={"grad_seed": 77, "method": "shgemm_fused",
                                    "shape": (cfg.vocab, cfg.d_model)},
                            backend="gloo", device="cuda", timeout=DIST_TIMEOUT)
    t_world = time.perf_counter() - t0
    check(all(x["ok"] and x["residual_ok"] and x["norm_exact"] for x in ranks),
          f"compression over the group != the mean of single-process results: {ranks}")
    check(all(x["launches"] > 0 for x in ranks), "kernel 1 never launched by a rank")
    out["world"] = {"ranks": ranks, "world_s": t_world}
    out["sub_seconds"] = {"12a": t_a - t_phase, "12b": t_b - t_a, "12c": t_child,
                          "12d": t_world}
    print(f"[train] 12d compress_and_reduce (shgemm_fused, rank {COMP_RANK}) over a "
          f"{TRAIN_WORLD}-rank gloo group on the one card, each rank a different "
          f"({cfg.vocab}, {cfg.d_model}) embedding gradient and a norm leaf: the group result vs "
          f"the mean of the ranks' single-process g_hat, max|d| "
          f"{max(x['max_abs'] for x in ranks):.3e}, ||d||/||mean|| "
          f"{max(x['rel'] for x in ranks):.3e} (rtol 1e-4, atol 1e-6); residuals "
          f"within rtol 1e-4 / atol 1e-4; the norm leaf the exact sum; "
          f"{[round(x['ms'], 2) for x in ranks]} ms a call by rank; kernel 1 "
          f"launches by rank {[x['launches'] for x in ranks]}; the world took "
          f"{t_world:.1f} s [{card}]")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[train] phase 12 took {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in out["sub_seconds"].items()) + ")")
    return out


# Phase 13: open-loop serving through the continuous-batching scheduler.
# 13a qwen3-0.6b and 13b gemma2-2b at full width and depth (random bf16
# weights from a seed), each trace run through the kernel path and the plain
# path (its first CUT_LAYERS layers); 13a once more, on its first CUT_LAYERS
# layers, under an hbm_budget that admits 4 streams; 13c a rolling sketch
# through kernel 2.
SCHED_CELLS = {
    "13a": {"arch": "qwen3-0.6b", "prefill_chunk": 256, "max_queue": 64,
            "model": dict(slots=8, max_seq=2048, kv_sketch_rank=32,
                          kv_compress_ratio=2.0),
            "trace": dict(seed=0, n_requests=16, arrival_rate=200.0,
                          prompt_short=(64, 256), prompt_long=(512, 1536),
                          long_frac=0.25, max_new_range=(32, 128))},
    "13b": {"arch": "gemma2-2b", "prefill_chunk": 512, "max_queue": 64,
            "model": dict(slots=8, max_seq=8192, kv_sketch_rank=32,
                          kv_compress_ratio=2.0),
            "trace": dict(seed=1, n_requests=8, arrival_rate=200.0,
                          prompt_short=(256, 1024), prompt_long=(4200, 4800),
                          long_frac=0.5, max_new_range=(64, 160))},
}
BUDGET_STREAMS = 4         # 13a's capped run ...
BUDGET_REQUESTS = 8        # ... on the trace's first 8 requests (cut from 16)
# The plain-path run of each trace and 13a's capped run take the first 4
# layers: the schedule and the virtual clock do not depend on the depth, and
# the HBM gauge scales with the swappable layers (PERF.md section 4).
CUT_LAYERS = 4
REPLAY_STEPS = 72          # decode steps of the lockstep replay (> one swap)
ROLL_ROWS, ROLL_COLS, ROLL_WINDOW, ROLL_P = 4096 + 1000, 256, 4096, 40
ROLL_TILES = (512, 1, 777, 1000, 256, 1500)   # ragged, then the rest


def cell_trace(spec: dict, vocab: int) -> list:
    """The cell's seeded Poisson trace (``loadgen.generate_trace``)."""
    from repro_torch.serve import loadgen
    t = dict(spec["trace"])
    return loadgen.generate_trace(t.pop("seed"), t.pop("n_requests"),
                                  t.pop("arrival_rate"), vocab=vocab, **t)


def replay_lockstep(torch, dev, cfg, weights, req, spec, steps: int) -> dict:
    """One request replayed through two one-slot model steps, the plain path
    and the kernel path, in lockstep as the scheduler drives a lone request:
    chunked prefill, the swap check at promotion, then masked decode steps at
    the slot's own clock, each followed by the swap check.  The plain path's
    greedy token is fed to both (teacher forcing).  Returns the per-call
    logits agreement (``bf16_agreement``) and both comp_len histories."""
    from repro_torch.serve.model_step import ModelStep
    kw = dict(spec["model"], slots=1)
    models = [ModelStep(c, weights, device=dev, **kw)
              for c in (cfg, cfg.with_(use_flash_kernel=True))]
    agree, comp = [], [[], []]
    chunk, prompt = spec["prefill_chunk"], req.prompt
    for m in models:
        m.begin_slot(0)
    for start in range(0, len(prompt), chunk):
        outs = [m.prefill_rows(0, prompt[start:start + chunk], start) for m in models]
    agree.append(bf16_agreement(torch, outs[1][None], outs[0][None]))
    token = int(torch.argmax(outs[0]))
    mask = [True]
    for i in range(steps + 1):
        for k, m in enumerate(models):
            if i:
                clock = int(m.pos[0])
                outs[k] = m.decode_logits([[token]], clock, slot_mask=mask)
                m._note_kv_row(0, clock)
                m.pos[0] = clock + 1
            m.auto_compress(0)
            comp[k].append(int(m._kv_comp_len[0]))
        if i:
            agree.append(bf16_agreement(torch, outs[1], outs[0]))
            token = int(torch.argmax(outs[0][0]))
    return {"corr": min(c for c, _ in agree), "excess": max(e for _, e in agree),
            "calls": len(agree), "comp_len": comp, "pos": int(models[0].pos[0])}


def swap_layers(cfg, max_seq: int) -> int:
    """Layers whose k/v a slot can swap to factors: full-context attention
    (a window of max_seq rows or more holds the whole history)."""
    return sum(1 for sp in cfg.layer_specs() if sp.mixer == "attn"
               and (sp.window is None or sp.window >= max_seq))


def phase13_cell(torch, dev, card, name: str, spec: dict, *,
                 budget: bool = False):
    """One scheduler cell: the trace through the kernel path (timed, one
    decode step traced, launches and peak memory) and through the plain path
    on the first ``CUT_LAYERS`` layers (the SLO summaries must be equal, the
    HBM gauge in proportion to the swappable layers), then the lockstep
    replay of the longest request.  Returns the kernel run's record and its
    scheduler."""
    from repro_torch.kernels import factored_decode as k4
    from repro_torch.launch import serve as launch
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.serve.model_step import ModelStep
    from repro_torch.serve.scheduler import Scheduler
    t_cell = time.perf_counter()
    cfg = R.get_arch(spec["arch"])
    weights = T.cast_params_for_compute(
        cfg, launch.init_weights(cfg, seed=0, device=dev, compute_dtype=True))
    torch.cuda.synchronize()
    trace = cell_trace(spec, cfg.vocab)
    kw = dict(spec["model"], prefill_chunk=spec["prefill_chunk"],
              max_queue=spec["max_queue"], device=dev)
    traced, pos_max, comp_seen = [], [0], [0]

    def watch(sch, i):
        m = sch.model
        pos_max[0] = max(pos_max[0], int(m.pos.max()))
        comp_seen[0] = max(comp_seen[0], int(m._kv_comp_len.max()))
        live = sch._live()
        offered = len(sch.metrics.records) + len(sch.metrics.rejected)
        if (not traced and offered == len(trace) and not sch.queue
                and len(live) >= 2
                and all(sch.active[s].phase == "decode" for s in live)):
            # two steps of pure batched decode (device_breakdown warms up on
            # the first), run outside the step timer; with every request
            # already offered, no arrival is due between them, so the
            # schedule is the plain run's
            traced.append(f"{len(live)} slots decoding, in the run")
            traced.extend(device_breakdown(torch, lambda: Scheduler.step(sch)))
    runs = {}
    cut_cfg, cut_weights = first_layers(cfg, weights, CUT_LAYERS)
    for path, c, w in (("kernel", cfg.with_(use_flash_kernel=True), weights),
                       ("plain", cut_cfg, cut_weights)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        k4.launches = 0
        res = launch.run_scheduler(c, w, trace,
                                   on_step=watch if path == "kernel" else None, **kw)
        res["launches"] = k4.launches
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        runs[path] = res
        if path == "plain":
            del res["scheduler"]
    kern, plain = runs["kernel"], runs["plain"]
    sch, summ = kern["scheduler"], kern["summary"]
    acct = summ["accounting"]
    check(acct["unaccounted"] == 0 and acct["in_flight"] == 0
          and acct["completed"] + acct["rejected"] == len(trace),
          f"{name}: requests not accounted: {acct}")
    n_full = swap_layers(cfg, spec["model"]["max_seq"])
    n_cut = swap_layers(cut_cfg, spec["model"]["max_seq"])
    hbm, hbm_cut = summ["hbm"], plain["summary"]["hbm"]
    check({k: v for k, v in summ.items() if k != "hbm"}
          == {k: v for k, v in plain["summary"].items() if k != "hbm"}
          and sorted(hbm) == sorted(hbm_cut)
          and all(hbm[k] * n_cut == hbm_cut[k] * n_full for k in hbm),
          f"{name}: the kernel path's SLO summary differs from the plain "
          f"path's ({n_full} and {n_cut} swappable layers): {summ} vs "
          f"{plain['summary']}")
    check(kern["launches"] > 0 and plain["launches"] == 0,
          f"{name}: kernel 4 launches {kern['launches']} (plain path "
          f"{plain['launches']})")
    kinds = list(zip(kern["step_ms"], kern["step_kinds"]))
    decode = [t for t, (p, d) in kinds if d and not p]
    what = "decode-only"
    if not decode:                  # every decode step also caught a slot up
        decode, what = [t for t, (p, d) in kinds if d], "decode (with catch-up)"
    prefill = [t for t, (p, d) in kinds if p]
    check(bool(decode) and bool(prefill), f"{name}: no decode or prefill step")
    dec_ms = sorted(decode)[len(decode) // 2]
    if not traced:
        # no pure-decode step came after the last arrival: trace a batched
        # decode of every slot on the drained model (tokens 0, at the clock
        # past the largest pos), as the scheduler's decode step runs it
        m = sch.model
        clock = min(int(m.pos.max()), m.max_seq - 1)
        traced.append(f"all {m.slots} slots, after the drain")
        traced.extend(device_breakdown(torch, lambda: m.sample(m.decode_logits(
            [[0]] * m.slots, clock, slot_mask=[True] * m.slots))))
    n_live, wall_t, busy, top = traced
    fdec = sum(v for k, v in top if "fdec" in k)
    print(f"[sched] {name} {cfg.name} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}), {spec['model']['slots']} slots x "
          f"{spec['model']['max_seq']} rows, rank {spec['model']['kv_sketch_rank']} "
          f"swapping every {int(spec['model']['kv_compress_ratio'] * spec['model']['kv_sketch_rank'])} "
          f"rows, prefill_chunk {spec['prefill_chunk']}; trace {spec['trace']}: "
          f"{kern['tokens']} tokens in {kern['seconds']:.2f} s wall "
          f"({kern['tokens_per_s']:.1f} tok/s; plain path on the first "
          f"{CUT_LAYERS} layers {plain['seconds']:.2f} s, "
          f"{plain['tokens_per_s']:.1f} tok/s); {kern['steps']} scheduler steps, "
          f"median {what} step {dec_ms:.2f} ms ({len(decode)} steps), "
          f"median step with prefill work {sorted(prefill)[len(prefill) // 2]:.2f} ms "
          f"({len(prefill)}); kernel 4 launches {kern['launches']}; peak memory "
          f"{kern['peak_gib']:.2f} GiB (plain {plain['peak_gib']:.2f}); largest pos "
          f"{pos_max[0]}, largest comp_len {comp_seen[0]}; accounting {acct}; "
          f"SLO summary equal to the plain path's, its HBM gauge x {n_full}/{n_cut} "
          f"swappable layers [{card}]")
    print(f"[sched] {name} virtual clock: TTFT p50 / p99 {summ['ttft_p50_s']:.4f} / "
          f"{summ['ttft_p99_s']:.4f} s, TPOT p50 / p99 {summ['tpot_p50_s']:.5f} / "
          f"{summ['tpot_p99_s']:.5f} s, latency p50 / p99 {summ['latency_p50_s']:.4f} / "
          f"{summ['latency_p99_s']:.4f} s, {summ['tokens_per_s']:.1f} tok/s, "
          f"concurrency max {summ['concurrency_max']}, HBM {summ['hbm']}")
    print(f"[profile] {name} one decode step ({n_live}): wall {wall_t:.3f} ms (traced), device kernels "
          f"{busy:.3f} ms (busy {100 * busy / wall_t:.0f}%); kernel 4 (fdec) "
          f"{fdec:.3f} ms; top: " + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:5])
          + f" [{card}]")
    rec = {"arch": cfg.name, "tokens": kern["tokens"], "seconds": kern["seconds"],
           "tokens_per_s": kern["tokens_per_s"], "plain_seconds": plain["seconds"],
           "steps": kern["steps"], "decode_step_ms": dec_ms,
           "traced_step": {"wall_ms": wall_t, "device_ms": busy, "fdec_ms": fdec},
           "launches": kern["launches"], "peak_gib": kern["peak_gib"],
           "pos_max": pos_max[0], "comp_len_max": comp_seen[0], "summary": summ}
    del runs, plain

    longest = max(trace, key=lambda r: len(r.prompt))
    t0 = time.perf_counter()
    rep = replay_lockstep(torch, dev, cfg, weights, longest, spec, REPLAY_STEPS)
    same = rep["comp_len"][0] == rep["comp_len"][1]
    ok = rep["excess"] <= BF16_EXCESS and rep["corr"] > 0.9999 and same
    print(f"[sched] {name} lockstep replay of request {longest.rid} ({len(longest.prompt)}"
          f"-token prompt, {REPLAY_STEPS} decode steps, to pos {rep['pos']}), kernel "
          f"path vs plain path, {rep['calls']} logits compared: worst excess over 2 "
          f"own ulps {rep['excess']:.2f} ulp at the median |logit| <= {BF16_EXCESS}, "
          f"least correlation {rep['corr']:.7f} > 0.9999; comp_len histories equal: "
          f"{same} (final {rep['comp_len'][1][-1]}); {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    check(ok, f"{name}: the replayed request's kernel path disagrees: {rep}")
    rec["replay"] = {k: rep[k] for k in ("corr", "excess", "calls", "pos")}

    if budget:
        t0 = time.perf_counter()
        del sch, kern
        torch.cuda.empty_cache()
        cut_kcfg = cut_cfg.with_(use_flash_kernel=True)
        bound = Scheduler(ModelStep(cut_kcfg, cut_weights, device=dev, **spec["model"]),
                          prefill_chunk=spec["prefill_chunk"]).stream_bound
        cap_kw = dict(kw, hbm_budget=BUDGET_STREAMS * bound)
        k4.launches = 0
        res = launch.run_scheduler(cut_kcfg, cut_weights, trace[:BUDGET_REQUESTS],
                                   **cap_kw)
        s_cap, s_b = res["scheduler"], res["summary"]
        check(s_cap.max_streams == BUDGET_STREAMS
              and s_b["concurrency_max"] == BUDGET_STREAMS
              and s_b["accounting"]["unaccounted"] == 0
              and s_b["accounting"]["in_flight"] == 0
              and s_b["accounting"]["completed"] == BUDGET_REQUESTS,
              f"{name} under hbm_budget: cap {s_cap.max_streams}, {s_b}")
        print(f"[sched] {name} on the first {CUT_LAYERS} layers, hbm_budget "
              f"{cap_kw['hbm_budget']} B = {BUDGET_STREAMS} x "
              f"the stream bound {bound} B, the trace's first {BUDGET_REQUESTS} "
              f"requests: admission cap {s_cap.max_streams} streams, concurrency "
              f"max {s_b['concurrency_max']} (mean {s_b['concurrency_mean']:.2f}), "
              f"queue depth max {s_b['queue_depth_max']}; {res['tokens']} tokens in "
              f"{res['seconds']:.2f} s wall; virtual TTFT p50 / p99 "
              f"{s_b['ttft_p50_s']:.4f} / {s_b['ttft_p99_s']:.4f} s, latency p99 "
              f"{s_b['latency_p99_s']:.4f} s; kernel 4 launches {k4.launches}; "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        rec["budget"] = {"hbm_budget": cap_kw["hbm_budget"], "stream_bound": bound,
                         "max_streams": s_cap.max_streams,
                         "launches": k4.launches, "seconds": res["seconds"],
                         "summary": s_b}
        sch = s_cap
    rec["seconds_cell"] = time.perf_counter() - t_cell
    return rec, sch


def fdec_state_times(torch, dev, label, args, wp, hd, cap, card) -> dict:
    """Kernel 4 on one state: CUDA events around a call, a launch replayed
    from a CUDA graph, the profiler's device time with the launches its
    trace holds, the plain version, and the bytes bound."""
    from repro_torch.kernels import factored_decode as k4
    clock = torch.tensor([wp], dtype=torch.int32, device=dev)

    def call():
        return k4.factored_decode_attention(*args, clock, scale=hd ** -0.5, cap=cap)
    t_k = median_ms(torch, lambda: k4.factored_decode_attention(
        *args, wp, scale=hd ** -0.5, cap=cap), reps=TIMING_REPS)
    for _ in range(3):          # late in the run a trace may hold none
        t_d, seen = kernel_ms(torch, call, "fdec_kernel", TIMING_REPS)
        if seen:
            break
    t_g = graph_ms(torch, call)
    t_p = median_ms(torch, lambda: k4.factored_decode_plain(
        *args, wp, scale=hd ** -0.5, cap=cap), reps=TIMING_REPS)
    nbytes = k4.bytes_needed(args[0], args[1], args[3], args[7], wp)
    nops = k4.operations_needed(args[0], args[1], args[3], args[7], wp)
    t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_F32_FLOP_PER_S * 1e3
    bound, by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
    b, s, kvh, _ = args[1].shape
    print(f"[time] factored_decode {label} ({b}, {s}, {kvh}, {hd}) G "
          f"{args[0].shape[2] // kvh} r={args[3].shape[-1]} cap {cap} write_pos={wp} "
          f"comp_len={[int(c) for c in args[7].tolist()]}: kernel {t_k:.4f} ms by "
          f"CUDA events, {t_g:.4f} ms a launch in a CUDA graph, device {fmt_ms(t_d)} "
          f"ms ({seen} of {TIMING_REPS} launches in the trace); plain {t_p:.4f} ms; "
          f"bound {bound:.5f} ms ({by}: {nbytes} B, {nops} f32 ops); graph/bound "
          f"{t_g / bound:.1f}x [{card}]")
    return {"state": label, "write_pos": wp, "ms": t_k, "device_ms": t_d,
            "device_launches_traced": seen, "graph_ms": t_g, "plain_ms": t_p,
            "bound_ms": bound, "bound_by": by, "bytes": nbytes}


def phase13_rolling(torch, dev, card) -> dict:
    """13c: ``stream.rolling_*`` with kernel 2 (its default method) over a
    (4096 + 1000)-row stream of 256-column rows in ragged tiles: the
    finalized sketch equals kernel 2's fresh sketch of the last window bit
    for bit (the reference's test_rolling.py tolerance for this method)."""
    from repro_torch import stream
    from repro_torch.convert import key_from_seed
    from repro_torch.kernels import shgemm_fused as k2
    gen = torch.Generator(device=dev).manual_seed(13)
    a = torch.randn((ROLL_ROWS, ROLL_COLS), generator=gen, device=dev)
    key = key_from_seed(13)
    k2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = stream.rolling_init(key, ROLL_COLS, ROLL_P, window=ROLL_WINDOW,
                             device=dev)
    pos = 0
    for c in ROLL_TILES + (ROLL_ROWS,):
        c = min(c, ROLL_ROWS - pos, ROLL_WINDOW)
        rs = stream.rolling_update(rs, a[pos:pos + c], pos)
        pos += c
        if pos == ROLL_ROWS:
            break
    fin = stream.rolling_finalize(rs)
    torch.cuda.synchronize()
    t_roll = (time.perf_counter() - t0) * 1e3
    launches = k2.launches
    fresh = stream.update(stream.init(key, ROLL_COLS, ROLL_P, max_rows=ROLL_WINDOW,
                                      method="shgemm_fused", device=dev),
                          a[ROLL_ROWS - ROLL_WINDOW:], 0)
    same = torch.equal(fin.y, fresh.y)
    print(f"[sched] 13c rolling sketch through kernel 2: a ({ROLL_ROWS}, {ROLL_COLS}) "
          f"stream in tiles of {list(ROLL_TILES)} then the rest, window {ROLL_WINDOW}, "
          f"p {ROLL_P}: finalize == the fresh sketch of the last window bit for bit: "
          f"{same}; {launches} kernel 2 launches; {t_roll:.2f} ms from init to "
          f"finalize [{card}]")
    check(same, "13c: the rolling sketch's finalize != the fresh window sketch")
    check(launches > 0, "13c: kernel 2 never launched")
    return {"launches": launches, "ms": t_roll}


def phase13_scheduler(torch, dev, card) -> dict:
    """Phase 13: 13a qwen3-0.6b and 13b gemma2-2b through the scheduler at
    full width and depth, 13a again under an hbm_budget of 4 streams, one
    traced compress_slot of gemma2, kernel 4 at gemma2's engine shapes, and
    13c the rolling sketch through kernel 2."""
    with torch.inference_mode():       # serving: no autograd bookkeeping
        return _phase13(torch, dev, card)


def _phase13(torch, dev, card) -> dict:
    t_phase = time.perf_counter()
    out = {}
    out["13a"], sch = phase13_cell(torch, dev, card, "13a", SCHED_CELLS["13a"],
                                   budget=True)
    del sch
    torch.cuda.empty_cache()
    out["13b"], sch = phase13_cell(torch, dev, card, "13b", SCHED_CELLS["13b"])
    ring = max(spec.window for spec in sch.model.cfg.pattern if spec.window)
    check(out["13b"]["pos_max"] > ring,
          f"13b: no slot passed the {ring}-row ring ({out['13b']['pos_max']})")
    check(out["13b"]["comp_len_max"] > 0, "13b: no swap fired")
    model = sch.model
    # device_breakdown calls twice (a warm-up, then the traced call): two
    # drained slots with a dense tail left, the longer tail traced
    tails = sorted((s for s in range(model.slots)
                    if model.pos[s] > model._kv_comp_len[s]
                    and model.pos[s] >= model._kv_min_rows),
                   key=lambda s: int(model.pos[s] - model._kv_comp_len[s]))
    check(len(tails) >= 2, f"13b: fewer than two slots left to swap: {tails}")
    order = iter(tails[-2:])
    slot = tails[-1]
    wall_c, busy_c, top_c = device_breakdown(
        torch, lambda: model.compress_slot(next(order)))
    n_global = sum(1 for spec in model.cfg.layer_specs() if spec.window is None)
    print(f"[profile] one compress_slot of gemma2-2b (slot {slot} at pos "
          f"{int(model.pos[slot])}; k and v of {n_global} global layers x "
          f"{model.cfg.n_kv_heads} heads, ({model.max_seq}, {model._kv_min_rows}) "
          f"sketches; the local layers' rolling sketches are not swapped): wall {wall_c:.3f} ms (traced), device kernels {busy_c:.3f} "
          f"ms (busy {100 * busy_c / wall_c:.0f}%); top: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top_c[:5]) + f" [{card}]")
    out["13b"]["traced_swap"] = {"wall_ms": wall_c, "device_ms": busy_c}

    # kernel 4 at gemma2's engine shapes: the 13b state of the first global
    # layer, and a full slot of dense rows
    cfg = sch.model.cfg
    h, kvh, hd, cap = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.attn_softcap
    gen = torch.Generator(device=dev).manual_seed(1313)
    layer = next(i for i, spec in enumerate(cfg.pattern) if spec.window is None)
    kc, vc = model.cache["scan"][layer]["k"][0], model.cache["scan"][layer]["v"][0]
    f = {n: w[0] for n, w in model.kv_fact["scan"][layer].items()}
    comp = torch.as_tensor(model._kv_comp_len, device=dev)
    q = torch.randn((model.slots, 1, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    s, r, b = kc.shape[1], f["k_us"].shape[-1], model.slots
    per_state = [fdec_state_times(
        torch, dev, "gemma2 13b state", (q, kc, vc, f["k_us"], f["k_vt"], f["v_us"],
                                    f["v_vt"], comp), int(model.pos.max()) - 1,
        hd, cap, card)]
    del sch, model, kc, vc, f
    torch.cuda.empty_cache()
    per_state.append(fdec_state_times(
        torch, dev, "gemma2 full slot, dense", fdec_inputs(
            torch, gen, b=b, s=s, h=h, kvh=kvh, hd=hd, r=r, comp=(0,) * b,
            wp=s - 1, dtype=torch.bfloat16), s - 1, hd, cap, card))
    out["fdec_per_state"] = per_state
    out["13c"] = phase13_rolling(torch, dev, card)
    out["scheduler_launches"] = {"13a": out["13a"]["launches"],
                                 "13a_budget": out["13a"]["budget"]["launches"],
                                 "13b": out["13b"]["launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[sched] phase 13 took {out['seconds']:.1f} s (13a {out['13a']['seconds_cell']:.1f} "
          f"s, 13b {out['13b']['seconds_cell']:.1f} s); kernel 4 launches "
          f"{out['scheduler_launches']} (counts set to 0 before each run)")
    return out


# Phase 14: routed-MoE serving, qwen3-moe-30b-a3b at full width and depth
# (48 layers, 32|4 heads of 128, 128 experts top-8 of width 768, vocab
# 151936; random weights from a seed drawn straight into bf16, the router
# f32: 61 GB).  Cuts (PERF.md section 4): prefill batch 32 -> 1 at 4096 of
# prefill_32k's 32768 tokens; 8-request engine and scheduler runs.
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_PREFILL_SEQ = 4096                  # 14a-b
MOE_CHUNK_PROMPT, MOE_CHUNK = 1024, 128  # 14c
MOE_ENGINE_KW = dict(slots=8, max_seq=2048, kv_sketch_rank=32, kv_compress_ratio=2.0)
MOE_REQUESTS, MOE_PROMPT_LEN, MOE_MAX_NEW = 8, 256, 64   # 14d
MOE_SCHED = {"prefill_chunk": 256, "max_queue": 64,        # 14e
             "trace": dict(seed=3, n_requests=8, arrival_rate=200.0,
                           prompt_short=(64, 256), prompt_long=(512, 1024),
                           long_frac=0.25, max_new_range=(32, 64))}
PHASE14_LIMIT_S = 240.0


def routes_alike(logs: dict) -> tuple[int, int, int | None]:
    """(sets alike, sets, first log entry that differs) over two paths'
    routed expert sets, one (tokens, k) tensor of sorted ids a layer call."""
    a, b = logs["plain"], logs["kernel"]
    check(len(a) == len(b) and all(x.shape == y.shape for x, y in zip(a, b)),
          f"the two paths routed different token counts ({len(a)} vs {len(b)} "
          f"layer calls)")
    same = [(x == y).all(-1) for x, y in zip(a, b)]
    first = next((i for i, m in enumerate(same) if not bool(m.all())), None)
    return (sum(int(m.sum()) for m in same), sum(int(m.numel()) for m in same),
            first)


def phase14_moe(torch, dev, card) -> dict:
    """Phase 14: qwen3-moe-30b-a3b through the serving entry points at full
    width and depth: (14a) make_prefill_step on the kernel and plain paths,
    (14b) grow_cache + one decode step against a full forward, (14c) a
    prompt through prefill_rows in one chunk and in chunks, (14d) the kernel
    and plain engines in bf16 lockstep with the share of routed expert sets
    alike, then kernels 4 and 3 at the path's shapes against their plain
    versions, and timed, (14e) the scheduler on the kernel path with one
    decode step traced."""
    with torch.inference_mode():       # serving: no autograd bookkeeping
        return _phase14(torch, dev, card)


def _phase14(torch, dev, card) -> dict:
    from repro_torch.kernels import factored_decode as k4
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import serve as launch
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import moe
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.model_step import ModelStep
    t_phase = time.perf_counter()
    out, sub = {}, {}
    cfg = R.get_arch(MOE_ARCH)
    kcfg = cfg.with_(use_flash_kernel=True)
    h, kvh, hd, n_layers = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    base = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    weights = T.cast_params_for_compute(
        cfg, launch.init_weights(cfg, seed=0, device=dev, compute_dtype=True))
    torch.cuda.synchronize()
    nbytes = sum(w.numel() * w.element_size() for w in weights.values())
    print(f"[moe] {cfg.name}: {T.param_count(cfg) / 1e9:.3f} B parameters "
          f"({T.active_param_count(cfg) / 1e9:.3f} B active a token) at the "
          f"published widths ({n_layers} layers, d_model {cfg.d_model}, {h}|{kvh} "
          f"heads of {hd} with qk-norm, {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k} of width {cfg.moe.d_expert}, vocab {cfg.vocab}), "
          f"drawn in bf16 (router f32) from seed 0: {nbytes / 1e9:.2f} GB in "
          f"{time.perf_counter() - t0:.1f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({base:.2f} GiB "
          f"before the draw) [{card}]")
    gen = torch.Generator(device=dev).manual_seed(1414)
    tokens = torch.randint(0, cfg.vocab, (1, MOE_PREFILL_SEQ + 1), generator=gen,
                           device=dev)
    prompt = tokens[:, :MOE_PREFILL_SEQ]

    # -- 14a: whole-prompt prefill, kernel path vs plain attention --------
    t_sub = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    k3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_k, cache = launch.run_prefill(kcfg, weights, prompt)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    launches = k3.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    k3.launches = 0
    t0 = time.perf_counter()
    logits_p, cache_p = launch.run_prefill(cfg, weights, prompt)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    plain_launches = k3.launches
    del cache_p
    ok, msg = logits_agree(torch, logits_k, logits_p, "bfloat16", 5e-2)
    cap = moe.capacity(MOE_PREFILL_SEQ, cfg.moe.num_experts, cfg.moe.top_k,
                       cfg.moe.capacity_factor)
    print(f"[moe] 14a {cfg.name} (1, {MOE_PREFILL_SEQ}) make_prefill_step (expert "
          f"capacity {cap} of {MOE_PREFILL_SEQ} tokens): kernel path "
          f"{t_k * 1e3:.1f} ms (first call; kernel 3 launches {launches}), plain "
          f"attention {t_p * 1e3:.1f} ms (launches {plain_launches}); peak memory "
          f"{peak:.2f} GiB; last-position logits kernel vs plain: {msg} [{card}]")
    check(launches == n_layers, f"14a: flash launches {launches} != {n_layers}")
    check(plain_launches == 0, f"14a: the plain path launched kernel 3 {plain_launches} times")
    check(bool(torch.isfinite(logits_k).all()), "14a: prefill logits not finite")
    check(ok, "14a: the kernel path's prefill logits disagree with the plain path's")
    out["14a"] = {"launches": launches, "ms_kernel": t_k * 1e3, "ms_plain": t_p * 1e3,
                  "peak_gib": peak, "err": (logits_k - logits_p).abs().max().item()}
    sub["14a"] = time.perf_counter() - t_sub
    # what phase 18b holds its world to, kept on the host
    out["world_ref"] = moe_world_reference(torch, cfg, kcfg, weights, prompt)

    # -- 14b: grow_cache + one decode step vs a full forward over S + 1 ----
    t_sub = time.perf_counter()
    grown = cache_mod.grow_cache(cache, 1, cfg)
    del cache
    got, _ = R.make_serve_step(kcfg)(weights, {
        "tokens": tokens[:, MOE_PREFILL_SEQ:], "cache": grown,
        "write_pos": MOE_PREFILL_SEQ})
    del grown
    want = R._final_logits(kcfg, T.forward(kcfg, weights, tokens,
                                           last_only=True).logits[:, -1])
    corr = torch.corrcoef(torch.stack([got.ravel(), want.ravel()]))[0, 1].item()
    diff = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, rtol=0.15, atol=0.15)) and corr > 0.99
    print(f"[moe] 14b grow_cache + one decode step at write_pos {MOE_PREFILL_SEQ} "
          f"(dropless: 1 token, capacity 8) vs a full forward over "
          f"{MOE_PREFILL_SEQ + 1} (capacity "
          f"{moe.capacity(MOE_PREFILL_SEQ + 1, cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor)}): "
          f"max|d| {diff:.3e} at |logit| max {want.abs().max().item():.1f}, "
          f"correlation {corr:.6f} (rtol = atol = 0.15, correlation > 0.99) [{card}]")
    check(ok, "14b: prefill + decode disagrees with the full forward")
    out["14b"] = {"max_diff": diff, "corr": corr}
    del got, want
    sub["14b"] = time.perf_counter() - t_sub

    # -- 14c: one prompt through prefill_rows in one chunk and in chunks --
    t_sub = time.perf_counter()
    prompt_c = tokens[0, :MOE_CHUNK_PROMPT].tolist()
    runs = {}
    for label, chunk in (("one chunk", MOE_CHUNK_PROMPT), ("chunks", MOE_CHUNK)):
        m = ModelStep(kcfg, weights, device=dev, slots=MOE_ENGINE_KW["slots"],
                      max_seq=MOE_ENGINE_KW["max_seq"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for start in range(0, MOE_CHUNK_PROMPT, chunk):
            last = m.prefill_rows(0, prompt_c[start:start + chunk], start)
        torch.cuda.synchronize()
        runs[label] = (last, (time.perf_counter() - t0) * 1e3, m._pool_prefill)
        del m
    (one, t_one, pool1), (many, t_many, pool2) = runs.values()
    ok, msg = logits_agree(torch, many[None], one[None], "bfloat16", 5e-2)
    print(f"[moe] 14c a {MOE_CHUNK_PROMPT}-token prompt through ModelStep.prefill_rows "
          f"({MOE_ENGINE_KW['slots']} slots: the chunk runs as one step, dropless) in "
          f"one chunk ({t_one:.1f} ms) and in chunks of {MOE_CHUNK} ({t_many:.1f} ms): "
          f"last logits {msg} [{card}]")
    check(not pool1 and not pool2, "14c: the 8-slot model step prefills token by token")
    check(ok, "14c: chunked prefill disagrees with the one-chunk prefill")
    out["14c"] = {"ms_one": t_one, "ms_chunks": t_many}
    del one, many, runs
    sub["14c"] = time.perf_counter() - t_sub

    # -- 14d: kernel vs plain engines in bf16 lockstep ---------------------
    t_sub = time.perf_counter()
    prompts = launch.make_prompts(MOE_REQUESTS, MOE_PROMPT_LEN, cfg.vocab, seed=1)
    engines = {"plain": Engine(cfg, weights, device=dev, **MOE_ENGINE_KW),
               "kernel": Engine(kcfg, weights, device=dev, **MOE_ENGINE_KW)}
    logs = {name: [] for name in engines}
    current = [None]
    route = moe.route

    def recording(c, logits):
        gates, experts = route(c, logits)
        if current[0] is not None:
            current[0].append(torch.sort(experts, dim=-1).values)
        return gates, experts

    def logged(name, step):
        def run():
            current[0] = logs[name]
            try:
                return step()
            finally:
                current[0] = None
        return run
    for name, eng in engines.items():
        eng.step = logged(name, eng.step)
    torch.cuda.reset_peak_memory_stats()
    k4.launches = 0
    moe.route = recording
    try:
        t0 = time.perf_counter()
        res = launch.lockstep(list(engines.values()), prompts, max_new=MOE_MAX_NEW,
                              compare=lambda got, want: bf16_agreement(torch, got, want))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        moe.route = route
    launches = k4.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist_p, hist_k = res["comp_len"]
    kern = engines["kernel"]
    swaps = [sum(1 for a, b in zip([[0] * kern.slots] + hist_k, hist_k) if b[s] > a[s])
             for s in range(kern.slots)]
    corr = min(c for c, _ in res["compared"])
    excess = max(e for _, e in res["compared"])
    off = next((i for i, (c, e) in enumerate(res["compared"])
                if not (c > 0.9999 and e <= BF16_EXCESS)), None)
    alike, total, first = routes_alike(logs)
    n_pre = MOE_REQUESTS * n_layers          # the admissions' layer calls come first
    dec_alike, dec_total, _ = routes_alike({k: v[n_pre:] for k, v in logs.items()})
    del logs
    print(f"[moe] 14d bf16 lockstep of the kernel and plain engines ({n_layers} "
          f"layers, {MOE_REQUESTS} prompts of {MOE_PROMPT_LEN}, {MOE_MAX_NEW} new, "
          f"{MOE_ENGINE_KW}): {res['steps']} decode steps in {wall:.1f} s; worst "
          f"excess over 2 own ulps {excess:.2f} ulp at the median |logit| (<= "
          f"{BF16_EXCESS}), least correlation {corr:.7f} (> 0.9999), first step off "
          f"the gate {off}; kernel 4 launches {launches} = {res['steps']} x {n_layers}: "
          f"{launches == res['steps'] * n_layers}; comp_len equal {hist_p == hist_k}; "
          f"swaps per slot {swaps}; peak memory {peak:.2f} GiB [{card}]")
    print(f"[moe] 14d routed expert sets chosen alike by the two paths: {alike} of "
          f"{total} (token, layer) sets ({100 * alike / total:.3f} %), "
          f"{dec_alike} of {dec_total} in the decode steps "
          f"({100 * dec_alike / dec_total:.3f} %); first layer call that differs "
          f"{first} (layer {None if first is None else first % n_layers}) [{card}]")
    check(launches == res["steps"] * n_layers,
          f"14d: fdec launches {launches} != {res['steps']} x {n_layers}")
    check(hist_p == hist_k, "14d: comp_len histories differ between the engines")
    check(min(swaps) >= 1, f"14d: a slot never compressed: {swaps}")
    check(corr > 0.9999 and excess <= BF16_EXCESS,
          f"14d: the engines diverge (excess {excess:.2f}, correlation {corr:.7f})")
    out["14d"] = {"steps": res["steps"], "launches": launches, "excess": excess,
                  "corr": corr, "routes_alike": [alike, total],
                  "decode_routes_alike": [dec_alike, dec_total], "peak_gib": peak,
                  "seconds": wall}

    # kernel 4 at the kernel engine's final state (layer 0), then kernel 3
    # at 14a's shape: each against its plain version, then timed
    wp = int(max(kern.pos)) - 1                     # the last decode step's clock
    kc, vc = kern.cache["scan"][0]["k"][0], kern.cache["scan"][0]["v"][0]
    f = {n: w[0] for n, w in kern.kv_fact["scan"][0].items()}
    comp = torch.as_tensor(kern._kv_comp_len, device=dev)
    qd = torch.randn((kern.slots, 1, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    args = (qd, kc, vc, f["k_us"], f["k_vt"], f["v_us"], f["v_vt"], comp)
    got = k4.factored_decode_attention(*args, wp, scale=hd ** -0.5)
    want = k4.factored_decode_plain(*args, wp, scale=hd ** -0.5)
    err4 = (got.float() - want.float()).abs().max().item()
    print(f"[kernels] factored_decode {cfg.name} 14d state ({kern.slots}, "
          f"{kc.shape[1]}, {kvh}, {hd}) G {h // kvh} r={f['k_us'].shape[-1]} "
          f"write_pos={wp} comp_len={[int(c) for c in comp.tolist()]}: "
          f"max|kernel-plain| {err4:.3e} (tol 1e-2)")
    check(torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2),
          "factored_decode at 14d's state disagrees with plain")
    state = fdec_state_times(torch, dev, f"{cfg.name} 14d state", args, wp, hd, 0.0, card)
    state["max_abs_err"] = err4
    out["fdec_state"] = state
    del engines, kern, kc, vc, f, args, got, want, res
    torch.cuda.empty_cache()
    sub["14d"] = time.perf_counter() - t_sub

    q, k, v = (torch.randn((1, MOE_PREFILL_SEQ, n, hd), generator=gen, device=dev)
               .to(torch.bfloat16) for n in (h, kvh, kvh))
    got = k3.flash_attention(q, k, v, causal=True)
    want = k3.flash_attention_plain(q, k, v, causal=True)
    err3 = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    print(f"[kernels] flash_attention {cfg.name} (1, {MOE_PREFILL_SEQ}, {h}|{kvh}, "
          f"{hd}) G {h // kvh} bf16 causal: max|kernel-plain| {err3:.3e} (rtol 2e-2, "
          f"atol 3e-2); largest row ||kernel-plain||/||plain|| {rel:.3e} (bound "
          f"{FLASH_ROW_REL['bfloat16']})")
    check(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=3e-2)
          and rel <= FLASH_ROW_REL["bfloat16"],
          "flash_attention at the MoE prefill shape disagrees with plain")
    del q, k, v, got, want
    t_k3, t_p3, t_l3, b3, by3 = flash_times(torch, gen, f"{cfg.name} ", h, kvh, hd,
                                            MOE_PREFILL_SEQ, card)
    out["flash"] = {"shape": [1, MOE_PREFILL_SEQ, h, kvh, hd], "max_abs_err": err3,
                    "ms": t_k3, "plain_ms": t_p3, "library_ms": t_l3,
                    "bound_ms": b3, "bound_by": by3}

    # -- 14e: the scheduler on the kernel path -----------------------------
    t_sub = time.perf_counter()
    trace = cell_trace(MOE_SCHED, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    k4.launches = 0
    res = launch.run_scheduler(kcfg, weights, trace,
                               prefill_chunk=MOE_SCHED["prefill_chunk"],
                               max_queue=MOE_SCHED["max_queue"], device=dev,
                               **MOE_ENGINE_KW)
    launches = k4.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    summ, kinds = res["summary"], res["step_kinds"]
    acct = summ["accounting"]
    decode_calls = sum(d for _, d in kinds)
    single = sum(p for p, _ in kinds)
    dec = sorted(t for t, (p, d) in zip(res["step_ms"], kinds) if d and not p)
    pre = sorted(t for t, (p, d) in zip(res["step_ms"], kinds) if p)
    sch = res["scheduler"]
    print(f"[moe] 14e scheduler, kernel path, {MOE_ENGINE_KW['slots']} slots x "
          f"{MOE_ENGINE_KW['max_seq']} rows, rank {MOE_ENGINE_KW['kv_sketch_rank']} "
          f"swapping every {int(MOE_ENGINE_KW['kv_compress_ratio'] * MOE_ENGINE_KW['kv_sketch_rank'])} "
          f"rows, prefill_chunk {MOE_SCHED['prefill_chunk']}; trace {MOE_SCHED['trace']}: "
          f"{res['tokens']} tokens in {res['seconds']:.2f} s wall "
          f"({res['tokens_per_s']:.1f} tok/s); {res['steps']} scheduler steps, "
          f"{single} single-slot prefill and catch-up calls, "
          f"{decode_calls} batched decode steps (median decode-only step "
          f"{dec[len(dec) // 2] if dec else float('nan'):.2f} ms over {len(dec)}), "
          f"median step with prefill work {pre[len(pre) // 2] if pre else float('nan'):.2f} "
          f"ms over {len(pre)}; kernel 4 launches {launches} = {decode_calls} x "
          f"{n_layers}: {launches == decode_calls * n_layers}; peak memory {peak:.2f} "
          f"GiB; largest pos {int(sch.model.pos.max())}, largest comp_len "
          f"{int(sch.model._kv_comp_len.max())}; accounting {acct} [{card}]")
    print(f"[moe] 14e virtual clock: TTFT p50 / p99 {summ['ttft_p50_s']:.4f} / "
          f"{summ['ttft_p99_s']:.4f} s, TPOT p50 / p99 {summ['tpot_p50_s']:.5f} / "
          f"{summ['tpot_p99_s']:.5f} s, latency p50 / p99 {summ['latency_p50_s']:.4f} / "
          f"{summ['latency_p99_s']:.4f} s, {summ['tokens_per_s']:.1f} tok/s, "
          f"concurrency max {summ['concurrency_max']}")
    check(acct["unaccounted"] == 0 and acct["in_flight"] == 0
          and acct["completed"] + acct["rejected"] == len(trace),
          f"14e: requests not accounted: {acct}")
    check(decode_calls > 0 and launches == decode_calls * n_layers,
          f"14e: kernel 4 launches {launches} != {decode_calls} x {n_layers}")
    check(all(0 < len(r.out) <= r.max_new for r in sch.finished),
          "14e: a finished request has no output or too much")
    # one batched decode step of every slot on the drained model, traced
    m = sch.model
    clock = min(int(m.pos.max()), m.max_seq - 1)
    wall_t, busy, top = device_breakdown(torch, lambda: m.sample(m.decode_logits(
        [[0]] * m.slots, clock, slot_mask=[True] * m.slots)))
    fdec = sum(v for k, v in top if "fdec" in k)
    mc = cfg.moe
    expert_bytes = 3 * mc.num_experts * cfg.d_model * mc.d_expert * 2 * n_layers
    print(f"[profile] 14e one decode step of all {m.slots} slots after the drain: "
          f"wall {wall_t:.3f} ms (traced), device kernels {busy:.3f} ms (busy "
          f"{100 * busy / wall_t:.0f}%); kernel 4 (fdec, {n_layers} launches) "
          f"{fdec:.3f} ms; the (E, C, D) expert products read all "
          f"{expert_bytes / 1e9:.2f} GB of expert weights a step, "
          f"{expert_bytes / PEAK_BYTES_PER_S * 1e3:.2f} ms at the memory rate; top: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:6]) + f" [{card}]")
    out["14e"] = {"launches": launches, "tokens": res["tokens"],
                  "seconds": res["seconds"], "steps": res["steps"],
                  "single_slot_calls": single, "decode_steps": decode_calls,
                  "peak_gib": peak, "summary": summ,
                  "traced_decode": {"wall_ms": wall_t, "device_ms": busy,
                                    "fdec_ms": fdec}}
    del res, sch, m, weights
    torch.cuda.empty_cache()
    sub["14e"] = time.perf_counter() - t_sub

    out["seconds"] = time.perf_counter() - t_phase
    print(f"[moe] phase 14 took {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sub.items())
          + f"); kernel 3 launches in 14a's prefill {out['14a']['launches']}, kernel 4 "
          f"in 14d's lockstep {out['14d']['launches']} and 14e's scheduler "
          f"{out['14e']['launches']} (counts set to 0 before each run)")
    check(out["seconds"] <= PHASE14_LIMIT_S,
          f"phase 14 took {out['seconds']:.1f} s > {PHASE14_LIMIT_S} s")
    return out


# Phase 15: MLA serving, deepseek-v2-lite-16b at full width and depth (27
# layers: a dense-MLP MLA prelude, then 26 MLA + MoE; d_model 2048, 16 heads,
# kv_lora 512, qk_nope 128, qk_rope 64, v_head 128; 64 experts top-6 of width
# 1408 + 2 shared of 2816; vocab 102400; random weights from a seed drawn
# straight into bf16, the router f32: 31.4 GB).  Cuts (PERF.md section 4):
# prefill batch 32 -> 1 at 4096 of prefill_32k's 32768 tokens; 8-request
# scheduler and engine runs.  MLA reaches none of the four kernels; 15f runs
# kernel 2 on the latent sketches.
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_PREFILL_SEQ = 4096                              # 15a-b
MLA_CHUNK_PROMPT, MLA_CHUNK, MLA_STEPWISE = 1024, 128, 128   # 15c, 8 slots
MLA_POOL_SLOTS, MLA_POOL_PROMPT, MLA_POOL_SEQ = 16, 64, 128   # 15c, the pool
MLA_MODEL = dict(slots=8, max_seq=4096, kv_sketch_rank=32)    # 15d, no swaps
MLA_SCHED = {"prefill_chunk": 512, "max_queue": 64,           # 15d
             "trace": dict(seed=2, n_requests=8, arrival_rate=200.0,
                           prompt_short=(128, 512), prompt_long=(1536, 3072),
                           long_frac=0.25, max_new_range=(32, 96))}
MLA_ENGINE_KW = dict(slots=8, max_seq=2048, kv_sketch_rank=32)   # 15e: the CLI's
MLA_REQUESTS, MLA_PROMPT_LEN, MLA_MAX_NEW = 8, 256, 64          # defaults
PHASE15_LIMIT_S = 150.0


def phase15_mla(torch, dev, card) -> dict:
    """Phase 15: deepseek-v2-lite-16b through the serving entry points at full
    width and depth: (15a) make_prefill_step, (15b) grow_cache + one absorbed
    decode step against a full forward, (15c) a prompt through prefill_rows in
    one chunk, in chunks and token by token, then the 16-slot pool prefill
    beside another slot's live latents, (15d) the scheduler with latent
    sketches, (15e) the CLI's engine path, (15f) one drained slot's latents
    streamed through kernel 2 against its one-shot sketch."""
    with torch.inference_mode():       # serving: no autograd bookkeeping
        return _phase15(torch, dev, card)


def _phase15(torch, dev, card) -> dict:
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.launch import serve as launch
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import moe
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_compress
    from repro_torch.serve.model_step import ModelStep
    from repro_torch.stream.state import fused_at_row_offset
    t_phase = time.perf_counter()
    out, sub = {}, {}
    cfg = R.get_arch(MLA_ARCH)
    kcfg = cfg.with_(use_flash_kernel=True)      # as the serve CLI sets it
    m_cfg, n_layers = cfg.mla, cfg.n_layers
    base = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    weights = T.cast_params_for_compute(
        cfg, launch.init_weights(cfg, seed=0, device=dev, compute_dtype=True))
    torch.cuda.synchronize()
    nbytes = sum(w.numel() * w.element_size() for w in weights.values())
    print(f"[mla] {cfg.name}: {T.param_count(cfg) / 1e9:.3f} B parameters "
          f"({T.active_param_count(cfg) / 1e9:.3f} B active a token) at the "
          f"published widths ({n_layers} layers: a dense-MLP MLA prelude, then "
          f"{n_layers - 1} MLA + MoE; d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"kv_lora {m_cfg.kv_lora_rank}, qk_nope {m_cfg.qk_nope_dim}, qk_rope "
          f"{m_cfg.qk_rope_dim}, v_head {m_cfg.v_head_dim}; {cfg.moe.num_experts} "
          f"experts top-{cfg.moe.top_k} of width {cfg.moe.d_expert} + "
          f"{cfg.moe.num_shared} shared of {cfg.moe.d_shared}; vocab {cfg.vocab}), "
          f"drawn in bf16 (router f32) from seed 0: {nbytes / 1e9:.2f} GB in "
          f"{time.perf_counter() - t0:.1f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({base:.2f} GiB "
          f"before the draw) [{card}]")
    gen = torch.Generator(device=dev).manual_seed(1515)
    tokens = torch.randint(0, cfg.vocab, (1, MLA_PREFILL_SEQ + 1), generator=gen,
                           device=dev)
    prompt = tokens[:, :MLA_PREFILL_SEQ]

    # -- 15a: whole-prompt prefill (MLA materialized), two calls ------------
    t_sub = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    k3.launches = 0
    walls = []
    for _ in range(2):
        cache = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = launch.run_prefill(kcfg, weights, prompt)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    latent = sum(leaf.numel() * leaf.element_size() for layers in
                 (cache["pre"], cache["scan"]) for layer in layers
                 for leaf in layer.values())
    print(f"[mla] 15a {cfg.name} (1, {MLA_PREFILL_SEQ}) make_prefill_step "
          f"(use_flash_kernel set, as the CLI sets it): first call "
          f"{walls[0]:.1f} ms, second {walls[1]:.1f} ms; kernel 3 launches "
          f"{k3.launches} (MLA attends through layers.attention); latent cache "
          f"{latent / 2**20:.1f} MiB ({sorted(cache['scan'][0])}); peak memory "
          f"{peak:.2f} GiB [{card}]")
    check(k3.launches == 0, f"15a: an MLA layer launched kernel 3 {k3.launches} times")
    check(bool(torch.isfinite(logits).all()), "15a: prefill logits not finite")
    check(tuple(cache["scan"][0]["ckv"].shape)
          == (cfg.n_scan_periods, 1, MLA_PREFILL_SEQ, m_cfg.kv_lora_rank),
          f"15a: latent cache shape {tuple(cache['scan'][0]['ckv'].shape)}")
    out["15a"] = {"ms_first": walls[0], "ms_second": walls[1], "peak_gib": peak,
                  "kernel3_launches": k3.launches}
    sub["15a"] = time.perf_counter() - t_sub

    # -- 15b: grow_cache + one absorbed decode step vs a full forward -----
    t_sub = time.perf_counter()
    grown = cache_mod.grow_cache(cache, 1, cfg)
    del cache, logits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = R.make_serve_step(kcfg)(weights, {
        "tokens": tokens[:, MLA_PREFILL_SEQ:], "cache": grown,
        "write_pos": MLA_PREFILL_SEQ})
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) * 1e3
    del grown
    want = R._final_logits(kcfg, T.forward(kcfg, weights, tokens,
                                           last_only=True).logits[:, -1])
    corr = torch.corrcoef(torch.stack([got.ravel(), want.ravel()]))[0, 1].item()
    diff = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, rtol=0.15, atol=0.15)) and corr > 0.99
    print(f"[mla] 15b grow_cache + one absorbed-latent decode step at write_pos "
          f"{MLA_PREFILL_SEQ} ({t_dec:.1f} ms) vs a full forward over "
          f"{MLA_PREFILL_SEQ + 1} (materialized): max|d| {diff:.3e} at |logit| "
          f"max {want.abs().max().item():.2f}, correlation {corr:.6f} (rtol = "
          f"atol = 0.15, correlation > 0.99) [{card}]")
    check(ok, "15b: prefill + absorbed decode disagrees with the full forward")
    out["15b"] = {"max_diff": diff, "corr": corr, "ms_decode": t_dec}
    del got, want
    sub["15b"] = time.perf_counter() - t_sub

    # -- 15c: prefill_rows in one chunk, in chunks, token by token; the pool -
    t_sub = time.perf_counter()
    prompt_c = tokens[0, :MLA_CHUNK_PROMPT].tolist()
    slots8 = MLA_MODEL["slots"]
    runs = {}
    for label, chunk, n in (("one chunk", MLA_CHUNK_PROMPT, MLA_CHUNK_PROMPT),
                            ("chunks", MLA_CHUNK, MLA_CHUNK_PROMPT),
                            ("token by token", 1, MLA_STEPWISE)):
        m = ModelStep(kcfg, weights, device=dev, slots=slots8,
                      max_seq=MLA_CHUNK_PROMPT)
        seen = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for start in range(0, n, chunk):
            seen[start + chunk] = m.prefill_rows(0, prompt_c[start:start + chunk],
                                                 start)
        torch.cuda.synchronize()
        runs[label] = (seen, (time.perf_counter() - t0) * 1e3, m._pool_prefill)
        del m
    (one, t_one, p1), (many, t_many, p2), (steps, t_steps, p3) = runs.values()
    ok_full, msg_full = logits_agree(torch, many[MLA_CHUNK_PROMPT][None],
                                     one[MLA_CHUNK_PROMPT][None], "bfloat16", 5e-2)
    ok_head, msg_head = logits_agree(torch, many[MLA_STEPWISE][None],
                                     steps[MLA_STEPWISE][None], "bfloat16", 5e-2)
    print(f"[mla] 15c a {MLA_CHUNK_PROMPT}-token prompt through "
          f"ModelStep.prefill_rows ({slots8} slots: a chunk is one dropless step "
          f"through MLA's cached branch) in one chunk ({t_one:.1f} ms) and in "
          f"chunks of {MLA_CHUNK} ({t_many:.1f} ms): last logits {msg_full}; its "
          f"first {MLA_STEPWISE} tokens one at a time ({t_steps:.1f} ms) against "
          f"the first chunk of {MLA_CHUNK}: {msg_head} [{card}]")
    check(not (p1 or p2 or p3), "15c: the 8-slot model step prefills through the pool")
    check(ok_full, "15c: chunked prefill disagrees with the one-chunk prefill")
    check(ok_head, "15c: a chunk disagrees with the token-by-token prefill")
    out["15c"] = {"ms_one": t_one, "ms_chunks": t_many, "ms_stepwise": t_steps}
    del one, many, steps, runs

    # the 16-slot pool: one masked pool step a token, beside slot 3's live
    # latent rows, which must stay bit for bit
    pool = ModelStep(kcfg, weights, device=dev, slots=MLA_POOL_SLOTS,
                     max_seq=MLA_POOL_SEQ)
    live = {}
    for group in ("pre", "scan"):
        for i, layer in enumerate(pool.cache[group]):
            for name, leaf in layer.items():
                rows = leaf[:, 3] if group == "scan" else leaf[3]
                rows[..., :MLA_POOL_PROMPT, :].copy_(torch.randn(
                    rows[..., :MLA_POOL_PROMPT, :].shape, generator=gen,
                    device=dev).to(rows.dtype))
                live[(group, i, name)] = rows.clone()
    pool.pos[3] = MLA_POOL_PROMPT
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = pool.prefill_rows(5, prompt_c[:MLA_POOL_PROMPT], 0)
    torch.cuda.synchronize()
    t_pool = (time.perf_counter() - t0) * 1e3
    kept = all(torch.equal(pool.cache[g][i][n][:, 3] if g == "scan"
                           else pool.cache[g][i][n][3], old)
               for (g, i, n), old in live.items())
    wrote = bool(pool.cache["scan"][0]["ckv"][:, 5, :MLA_POOL_PROMPT].any())
    cap = moe.capacity(MLA_POOL_SLOTS, cfg.moe.num_experts, cfg.moe.top_k,
                       cfg.moe.capacity_factor)
    print(f"[mla] 15c the {MLA_POOL_SLOTS}-slot pool (expert capacity {cap} "
          f"of {MLA_POOL_SLOTS} tokens: pairs drop): a {MLA_POOL_PROMPT}-token "
          f"prompt into slot 5 through _prefill_pool, one masked pool step a "
          f"token, {t_pool:.1f} ms ({t_pool / MLA_POOL_PROMPT:.1f} ms a step); "
          f"slot 3's live ckv/kr rows bit for bit: {kept}; slot 5's rows "
          f"written: {wrote}; pos {list(map(int, pool.pos))[:6]} [{card}]")
    check(pool._pool_prefill, "15c: the 16-slot model step does not prefill through the pool")
    check(kept, "15c: the pool prefill overwrote another slot's live latent rows")
    check(wrote and bool(torch.isfinite(last).all()),
          "15c: the pool prefill wrote no latent rows or non-finite logits")
    out["15c"]["ms_pool"] = t_pool
    del pool, live, last
    torch.cuda.empty_cache()
    sub["15c"] = time.perf_counter() - t_sub

    # -- 15d: the scheduler with latent sketches ---------------------------
    t_sub = time.perf_counter()
    try:
        ModelStep(kcfg, weights, device=dev, slots=1, max_seq=16,
                  kv_sketch_rank=32, kv_compress_ratio=2.0)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    check(refused is not None and "not swappable" in refused,
          "15d: a ModelStep with kv_compress_ratio did not raise for MLA latents")
    trace = cell_trace(MLA_SCHED, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    res = launch.run_scheduler(kcfg, weights, trace,
                               prefill_chunk=MLA_SCHED["prefill_chunk"],
                               max_queue=MLA_SCHED["max_queue"], device=dev,
                               **MLA_MODEL)
    peak = torch.cuda.max_memory_allocated() / 2**30
    summ, kinds = res["summary"], res["step_kinds"]
    acct = summ["accounting"]
    decode_calls = sum(d for _, d in kinds)
    single = sum(p for p, _ in kinds)
    dec = sorted(t for t, (p, d) in zip(res["step_ms"], kinds) if d and not p)
    pre = sorted(t for t, (p, d) in zip(res["step_ms"], kinds) if p)
    sch = res["scheduler"]
    m = sch.model
    high = []
    for s in range(m.slots):
        if m._kv_sketches[s] is None:
            continue
        m._flush_kv_pending(s)
        seen = {st.rows_seen for st in m._kv_sketches[s].values()}
        high.append((s, int(m.pos[s]), int(m._kv_next_row[s]), sorted(seen)))
    rep = m.kv_bytes_report()
    rows = int(m.pos.sum())
    latent = rows * n_layers * (m_cfg.kv_lora_rank + m_cfg.qk_rope_dim) * 2
    dense_kv = rows * n_layers * 2 * cfg.n_heads * m_cfg.v_head_dim * 2
    print(f"[mla] 15d scheduler, {m.slots} slots x {m.max_seq} rows, rank "
          f"{m.kv_sketch_rank} latent sketches ({len(m._kv_paths)} paths a slot), "
          f"no swaps, prefill_chunk {MLA_SCHED['prefill_chunk']}; trace "
          f"{MLA_SCHED['trace']}: {res['tokens']} tokens in {res['seconds']:.2f} s "
          f"wall ({res['tokens_per_s']:.1f} tok/s); {res['steps']} scheduler "
          f"steps, {single} single-slot prefill and catch-up calls, "
          f"{decode_calls} batched decode steps (median decode-only step "
          f"{dec[len(dec) // 2] if dec else float('nan'):.2f} ms over {len(dec)}), "
          f"median step with prefill work {pre[len(pre) // 2] if pre else float('nan'):.2f} "
          f"ms over {len(pre)}; peak memory {peak:.2f} GiB; accounting {acct}; "
          f"(slot, pos, high-water, sketch rows seen) {high} [{card}]")
    print(f"[mla] 15d virtual clock: TTFT p50 / p99 {summ['ttft_p50_s']:.4f} / "
          f"{summ['ttft_p99_s']:.4f} s, TPOT p50 / p99 {summ['tpot_p50_s']:.5f} / "
          f"{summ['tpot_p99_s']:.5f} s, latency p50 / p99 {summ['latency_p50_s']:.4f} / "
          f"{summ['latency_p99_s']:.4f} s, {summ['tokens_per_s']:.1f} tok/s, "
          f"concurrency max {summ['concurrency_max']}; kv_bytes_report swappable "
          f"{rep['compressed_bytes']} B of dense {rep['dense_bytes']} B; the "
          f"drained slots' {rows} rows hold {latent / 2**20:.1f} MiB of latents "
          f"against {dense_kv / 2**20:.1f} MiB of dense K/V ({cfg.n_heads} x "
          f"{m_cfg.v_head_dim} k and v a row a layer); kv_compress_ratio=2 "
          f"refused: {refused!r}")
    check(acct["unaccounted"] == 0 and acct["in_flight"] == 0
          and acct["completed"] + acct["rejected"] == len(trace),
          f"15d: requests not accounted: {acct}")
    check(all(0 < len(r.out) <= r.max_new for r in sch.finished),
          "15d: a finished request has no output or too much")
    check(high and all(p == h and seen == [p] for _, p, h, seen in high),
          f"15d: sketch high-water != pos: {high}")
    check(rep["dense_bytes"] == 0 and rep["compressed_bytes"] == 0,
          f"15d: MLA latents counted as swappable: {rep}")
    # one batched decode step of every slot on the drained model, traced
    clock = min(int(m.pos.max()), m.max_seq - 1)
    wall_t, busy, top = device_breakdown(torch, lambda: m.sample(m.decode_logits(
        [[0]] * m.slots, clock, slot_mask=[True] * m.slots)))
    print(f"[profile] 15d one decode step of all {m.slots} slots after the drain "
          f"(clock {clock}): wall {wall_t:.3f} ms (traced), device kernels "
          f"{busy:.3f} ms (busy {100 * busy / wall_t:.0f}%); top: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:6]) + f" [{card}]")
    out["15d"] = {"tokens": res["tokens"], "seconds": res["seconds"],
                  "steps": res["steps"], "single_slot_calls": single,
                  "decode_steps": decode_calls, "peak_gib": peak, "summary": summ,
                  "median_decode_ms": dec[len(dec) // 2] if dec else None,
                  "traced_decode": {"wall_ms": wall_t, "device_ms": busy}}
    sub["15d"] = time.perf_counter() - t_sub

    # -- 15e: the serve CLI's engine path ----------------------------------
    t_sub = time.perf_counter()
    prompts = launch.make_prompts(MLA_REQUESTS, MLA_PROMPT_LEN, cfg.vocab, seed=1)
    res = launch.run_engine(kcfg, weights, prompts, max_new=MLA_MAX_NEW,
                            device=dev, **MLA_ENGINE_KW)
    eng = res["engine"]
    dec = sorted(res["step_ms"][1:])
    print(f"[mla] 15e run_engine (the serve CLI's engine path, {MLA_ENGINE_KW}, "
          f"kv_compress_ratio None): {MLA_REQUESTS} prompts of {MLA_PROMPT_LEN}, "
          f"{MLA_MAX_NEW} new: {res['tokens']} tokens in {res['seconds']:.2f} s "
          f"({res['tokens_per_s']:.1f} tok/s, {res['steps']} steps, median step "
          f"after the first {dec[len(dec) // 2]:.2f} ms); pos "
          f"{[int(p) for p in eng.pos]} [{card}]")
    check(not eng.queue and not any(eng.active)
          and res["steps"] == MLA_MAX_NEW - 1
          and all(int(p) == MLA_PROMPT_LEN + MLA_MAX_NEW - 1 for p in eng.pos),
          "15e: the engine did not serve every request to its end")
    out["15e"] = {"tokens": res["tokens"], "seconds": res["seconds"],
                  "tokens_per_s": res["tokens_per_s"]}
    del res, eng
    sub["15e"] = time.perf_counter() - t_sub

    # -- 15f: one drained slot's latents through kernel 2 ------------------
    t_sub = time.perf_counter()
    slot = int(m.pos.argmax())
    pos = int(m.pos[slot])
    flush = m._kv_flush_every
    k2.launches = 0
    streamed = {}
    for j, path in enumerate(m._kv_paths):
        rows = m._kv_leaf_rows(path, slot, 0, pos)
        state = kv_compress.kv_sketch_init(
            m._slot_key(slot, j), rows.shape[0], rows.shape[-1], m.max_seq,
            m.kv_sketch_rank, method="shgemm_fused", device=dev)
        for start in range(0, pos, flush):
            state = kv_compress.kv_sketch_append(
                state, rows[:, start:start + flush], start)
        streamed[path] = (state, rows)
    torch.cuda.synchronize()
    launches = k2.launches
    heads = sum(rows.shape[0] for _, rows in streamed.values())
    expected = -(-pos // flush) * heads
    bitwise, err = True, 0.0
    for j, (path, (state, rows)) in enumerate(streamed.items()):
        key = state.key_omega
        for h in range(rows.shape[0]):
            d = rows.shape[-1]
            one = fused_at_row_offset(rows[h], key, state.p, h * d)
            plain = k2.shgemm_fused_plain(rows[h].float(), key, state.p,
                                          row_offset=h * d)
            bitwise &= torch.equal(state.y[h, :pos], one)
            err = max(err, (one - plain).abs().max().item())
            check(torch.allclose(one, plain, rtol=1e-5, atol=1e-4),
                  f"15f: kernel 2 on {path} head {h} disagrees with plain")
    # kernel 2 at the slot's first ckv history, (pos, 512) . p, timed
    state, rows = streamed[m._kv_paths[0]]
    a = rows[0].float().contiguous()
    p_w = state.p
    print(f"[mla] 15f slot {slot}'s latents ({pos} rows; {len(streamed)} paths, "
          f"ckv {tuple(streamed[m._kv_paths[0]][1].shape)} ... kr) streamed "
          f"through kv_sketch_init(method='shgemm_fused') + kv_sketch_append in "
          f"{flush}-row flushes: kernel 2 launches {launches} (= "
          f"{-(-pos // flush)} flushes x {heads} head rows: {launches == expected}); "
          f"every head's sketch == kernel 2's one-shot sketch of its history bit "
          f"for bit: {bitwise}; one-shot vs shgemm_fused_plain max abs err "
          f"{err:.3e} (rtol 1e-5, atol 1e-4) [{card}]")
    times = kernel2_sketch_times(torch, dev, "mla 15f", a, state.key_omega, p_w, card)
    check(launches == expected and launches > 0,
          f"15f: kernel 2 launches {launches} != {expected}")
    check(bitwise, "15f: the streamed latent sketch differs from the one-shot sketch")
    out["15f"] = {"launches": launches, "shape": [pos, a.shape[1], p_w],
                  "max_abs_err": err, **times}
    del streamed, state, rows, a, sch, m, weights
    torch.cuda.empty_cache()
    sub["15f"] = time.perf_counter() - t_sub

    out["seconds"] = time.perf_counter() - t_phase
    print(f"[mla] phase 15 took {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sub.items())
          + f"); kernel 2 launches in 15f {out['15f']['launches']} (count set to "
          f"0 before the run) [{card}]")
    check(out["seconds"] <= PHASE15_LIMIT_S,
          f"phase 15 took {out['seconds']:.1f} s > {PHASE15_LIMIT_S} s")
    return out


REC_RG, REC_XL = "recurrentgemma-2b", "xlstm-350m"
RG_PREFILL_SEQ = 8192                   # 16a: four windows of 2048
REC_CHUNK_PROMPT, REC_CHUNK, REC_STEPWISE = 1024, 256, 128   # 16a, 16c
REC_F32_SEQ = {REC_RG: 1024, REC_XL: 512}       # the f32 first period, card vs CPU
REC_F32_TOL = 1e-4                      # |card - CPU| <= 1e-4 (1 + |CPU|) elementwise
RG_MODEL = dict(slots=8, max_seq=8192, kv_sketch_rank=32)   # 16b: 2048-row rings
RG_SCHED = {"prefill_chunk": 512, "max_queue": 64,          # 16b
            "trace": dict(seed=1, n_requests=10, arrival_rate=200.0,
                          prompt_short=(256, 1024), prompt_long=(3000, 5000),
                          long_frac=0.25, max_new_range=(32, 64))}
XL_PREFILL_SEQ = 4096                   # 16c
XL_ENGINE_KW = dict(slots=8, max_seq=2048)                  # 16c engine
XL_PROMPTS, XL_PROMPT_LEN, XL_MAX_NEW = 10, 256, 48
XL_SUBMIT_AT = (0, 4, 8, 12, 16, 20, 24, 28, 60, 70)        # engine steps
LONG_SEQ = 524288                       # 16d: long_500k
PHASE16_LIMIT_S = 150.0


def phase16_recurrent(torch, dev, card) -> dict:
    """Phase 16: the recurrent mixers at full width and depth: (16a)
    recurrentgemma-2b's prefill, decode and chunked prefill, its f32 first
    period on the card against the CPU; (16b) the scheduler on it, each
    request of a reused slot against the same calls in a fresh pool; (16c)
    xlstm-350m's prefill, decode, chunked prefill, f32 first period and
    staggered engine; (16d) a long_500k decode step of each; (16e) a
    drained 16b window through kernel 2's rolling sketch."""
    with torch.inference_mode():       # serving: no autograd bookkeeping
        return _phase16(torch, dev, card)


def rec_weights(torch, dev, cfg):
    """Random f32 masters from seed 0, their bf16 compute cast, and clones
    of the f32 leaves the first period needs (the f32 masters are freed)."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import transformer as T
    masters = launch.init_weights(cfg, seed=0, device=dev)
    first = {k: (v[:1] if k.startswith("layers/") else v).clone()
             for k, v in masters.items()
             if k.startswith("layers/") or k == "embed/tokens"}
    weights = T.cast_params_for_compute(cfg, masters)
    del masters
    torch.cuda.synchronize()
    return weights, first


def first_period_f32(torch, dev, cfg, first, tokens):
    """The f32 forward of the first period (embedding, then one period of
    layers through ``apply_stack``) on the card and on the CPU, from the
    same f32 weights and embedded input: (card, CPU) hidden states."""
    from repro_torch.models import transformer as T
    cut = cfg.with_(n_layers=cfg.period, activation_dtype="float32")
    x = T.embed_tokens(cut, first, tokens)
    outs = []
    for d in (dev, torch.device("cpu")):
        p = {k: v.to(d) for k, v in first.items() if k.startswith("layers/")}
        pos = torch.arange(x.shape[1], device=d)
        y, _ = T.apply_stack(cut, p, x.to(d), positions=pos,
                             ropes=T.rope_tables(cut, pos), cache=None,
                             write_pos=0, return_cache=False)
        outs.append(y.cpu())
    return outs


def f32_period_agree(torch, got, want):
    """max |card - CPU| and whether every element is within
    REC_F32_TOL * (1 + |CPU|)."""
    d = (got - want).abs()
    return d.max().item(), bool((d <= REC_F32_TOL * (1 + want.abs())).all())


def prefill_rows_runs(torch, dev, kcfg, weights, prompt):
    """A prompt through ModelStep.prefill_rows (8 slots, slot 0) in one
    chunk, in chunks of REC_CHUNK, its first REC_STEPWISE tokens in one
    chunk and one token at a time: the logits at each call's end and each
    run's wall ms."""
    from repro_torch.serve.model_step import ModelStep
    runs = {}
    for label, chunk, n in (("one chunk", len(prompt), len(prompt)),
                            ("chunks", REC_CHUNK, len(prompt)),
                            ("head", REC_STEPWISE, REC_STEPWISE),
                            ("token by token", 1, REC_STEPWISE)):
        m = ModelStep(kcfg, weights, device=dev, slots=8, max_seq=len(prompt))
        seen = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for start in range(0, n, chunk):
            seen[start + chunk] = m.prefill_rows(0, prompt[start:start + chunk],
                                                 start)
        torch.cuda.synchronize()
        runs[label] = (seen, (time.perf_counter() - t0) * 1e3)
        del m
    n = len(prompt)
    full = logits_agree(torch, runs["chunks"][0][n][None],
                        runs["one chunk"][0][n][None], "bfloat16", 5e-2)
    head = logits_agree(torch, runs["token by token"][0][REC_STEPWISE][None],
                        runs["head"][0][REC_STEPWISE][None], "bfloat16", 5e-2)
    return {k: v[1] for k, v in runs.items()}, full, head


def decode_vs_forward(torch, kcfg, weights, cache, tokens, s):
    """One serve step of token s on ``cache`` against a full forward over
    s + 1 tokens: (ok, max |d|, correlation, step ms)."""
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = R.make_serve_step(kcfg)(weights, {
        "tokens": tokens[:, s:s + 1], "cache": cache, "write_pos": s})
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) * 1e3
    want = R._final_logits(kcfg, T.forward(kcfg, weights, tokens[:, :s + 1],
                                           last_only=True).logits[:, -1])
    corr = torch.corrcoef(torch.stack([got.ravel(), want.ravel()]))[0, 1].item()
    diff = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, rtol=0.15, atol=0.15)) and corr > 0.99
    return ok, diff, corr, t_dec


def record_slot_calls(model_step_cls):
    """Wrap ModelStep's begin_slot, prefill_rows and decode_logits (on the
    class, so that run_scheduler's own wrappers call through them): each
    slot's tenants numbered from 1, and every call a tenant's rows went
    through, in order, as (kind, position, tokens, logits); logits are kept
    for the second and later tenants of a slot.  Returns (calls, restore)."""
    import numpy as np
    calls, tenant = {}, {}
    orig = {name: getattr(model_step_cls, name)
            for name in ("begin_slot", "prefill_rows", "decode_logits")}

    def begin_slot(self, slot):
        tenant[slot] = tenant.get(slot, 0) + 1
        calls[(slot, tenant[slot])] = []
        return orig["begin_slot"](self, slot)

    def prefill_rows(self, slot, tokens, start):
        out = orig["prefill_rows"](self, slot, tokens, start)
        calls[(slot, tenant[slot])].append(
            ("prefill", int(start), [int(t) for t in tokens],
             out.clone() if tenant[slot] > 1 else None))
        return out

    def decode_logits(self, tokens, write_pos, slot_mask=None):
        out = orig["decode_logits"](self, tokens, write_pos, slot_mask=slot_mask)
        for s in np.flatnonzero(np.asarray(slot_mask, bool)):
            calls[(int(s), tenant[int(s)])].append(
                ("decode", int(write_pos), [int(np.asarray(tokens)[s, 0])],
                 out[s].clone() if tenant[int(s)] > 1 else None))
        return out

    for name, fn in (("begin_slot", begin_slot), ("prefill_rows", prefill_rows),
                     ("decode_logits", decode_logits)):
        setattr(model_step_cls, name, fn)

    def restore():
        for name, fn in orig.items():
            setattr(model_step_cls, name, fn)
    return calls, restore


def replay_tenant(torch, dev, kcfg, weights, slot, calls) -> tuple:
    """One tenant's calls again in a fresh pool of RG_MODEL, the slot begun
    once: (worst correlation, worst bf16 excess, calls bit-equal, calls)."""
    import numpy as np
    from repro_torch.serve.model_step import ModelStep
    m = ModelStep(kcfg, weights, device=dev, **RG_MODEL)
    m.begin_slot(slot)
    mask = np.arange(m.slots) == slot
    agree, equal = [], 0
    for kind, pos, toks, want in calls:
        if kind == "prefill":
            got = m.prefill_rows(slot, toks, pos)
        else:
            t8 = np.zeros((m.slots, 1), np.int32)
            t8[slot, 0] = toks[0]
            got = m.decode_logits(t8, pos, slot_mask=mask)[slot]
            m.pos[slot] = pos + 1
        agree.append(bf16_agreement(torch, got[None], want[None]))
        equal += bool(torch.equal(got, want))
    del m
    return (min(c for c, _ in agree), max(e for _, e in agree), equal,
            len(calls))


def lone_engine_run(torch, dev, cfg, weights, prompt, slot):
    """``prompt`` served alone by a fresh Engine(**XL_ENGINE_KW), admitted
    into ``slot`` as the engine admits: its greedy tokens and each step's
    logits of the slot."""
    from repro_torch.serve.engine import Engine, Request
    eng = Engine(cfg, weights, device=dev, **XL_ENGINE_KW)
    req = Request(rid=0, prompt=list(prompt), max_new=XL_MAX_NEW)
    eng.active[slot] = req
    logits = eng._prefill_slot(slot, req.prompt, 0)
    eng.pos[slot] = len(req.prompt)
    req.out.append(int(torch.argmax(logits)))
    while eng.active[slot] is not None:
        eng.step()
    return req.out


def _phase16(torch, dev, card) -> dict:
    from repro_torch import stream
    from repro_torch.kernels import factored_decode as k4
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.launch import serve as launch
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import recurrent as rec
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_compress
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.model_step import ModelStep
    from repro_torch.stream.state import fused_at_row_offset
    t_phase = time.perf_counter()
    out, sub = {}, {}
    gen = torch.Generator(device=dev).manual_seed(1616)

    # -- 16a: recurrentgemma-2b --------------------------------------------
    t_sub = time.perf_counter()
    cfg = R.get_arch(REC_RG)
    kcfg = cfg.with_(use_flash_kernel=True)      # as the serve CLI sets it
    window = next(sp.window for sp in cfg.pattern if sp.window)
    t0 = time.perf_counter()
    weights, first = rec_weights(torch, dev, cfg)
    nbytes = sum(w.numel() * w.element_size() for w in weights.values())
    print(f"[rec] {cfg.name}: {T.param_count(cfg) / 1e9:.3f} B parameters at the "
          f"published widths ({cfg.n_layers} layers in the pattern RG-LRU, RG-LRU, "
          f"local MQA attention (window {window}); d_model {cfg.d_model}, d_rnn "
          f"{cfg.rnn.d_rnn}, conv {cfg.rnn.conv_width}, {cfg.n_heads}|{cfg.n_kv_heads} "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), f32 masters "
          f"from seed 0 cast to bf16 once: {nbytes / 1e9:.2f} GB in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    tokens = torch.randint(0, cfg.vocab, (1, RG_PREFILL_SEQ + 1), generator=gen,
                           device=dev)
    check(RG_PREFILL_SEQ % window == 0,
          "16a: the prefill's last window is not the ring of its decode position")
    torch.cuda.reset_peak_memory_stats()
    k3.launches = k4.launches = 0
    walls = []
    for _ in range(2):
        cache = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = launch.run_prefill(kcfg, weights, tokens[:, :RG_PREFILL_SEQ])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ring = tuple(cache["scan"][2]["k"].shape)
    check(bool(torch.isfinite(logits).all()), "16a: prefill logits not finite")
    check(ring == (cfg.n_scan_periods, 1, window, cfg.n_kv_heads, cfg.head_dim),
          f"16a: local layers' cache {ring}")
    # the last window of 8192 tokens is the ring of write_pos 8192 (8192 %
    # 2048 == 0): the decode writes into it in place, no grow_cache
    ok, diff, corr, t_dec = decode_vs_forward(torch, kcfg, weights, cache, tokens,
                                              RG_PREFILL_SEQ)
    print(f"[rec] 16a {cfg.name} (1, {RG_PREFILL_SEQ}) make_prefill_step (the rings "
          f"wrap {RG_PREFILL_SEQ // window} times): first call {walls[0]:.1f} ms, "
          f"second {walls[1]:.1f} ms, peak memory {peak:.2f} GiB; local cache {ring}, "
          f"state leaves {sorted(cache['scan'][0])}; kernel 3 / 4 launches "
          f"{k3.launches} / {k4.launches} (windowed layers attend through "
          f"layers.attention); then one decode step at write_pos {RG_PREFILL_SEQ} "
          f"on that cache ({t_dec:.1f} ms) vs a full forward over "
          f"{RG_PREFILL_SEQ + 1}: max|d| {diff:.3e}, correlation {corr:.6f} (rtol = "
          f"atol = 0.15, correlation > 0.99) [{card}]")
    check(ok, "16a: prefill + decode disagrees with the full forward")
    out["16a"] = {"ms_first": walls[0], "ms_second": walls[1], "peak_gib": peak,
                  "decode_max_diff": diff, "decode_corr": corr, "ms_decode": t_dec}
    del cache, logits

    prompt = tokens[0, :REC_CHUNK_PROMPT].tolist()
    ms, (ok_full, msg_full), (ok_head, msg_head) = prefill_rows_runs(
        torch, dev, kcfg, weights, prompt)
    print(f"[rec] 16a a {REC_CHUNK_PROMPT}-token prompt through ModelStep."
          f"prefill_rows (8 slots) in one chunk ({ms['one chunk']:.1f} ms) and in "
          f"chunks of {REC_CHUNK} ({ms['chunks']:.1f} ms): last logits {msg_full}; "
          f"its first {REC_STEPWISE} tokens one at a time "
          f"({ms['token by token']:.1f} ms) against one chunk of them: {msg_head} "
          f"[{card}]")
    check(ok_full, "16a: chunked prefill disagrees with the one-chunk prefill")
    check(ok_head, "16a: token-by-token prefill disagrees with one chunk")
    out["16a"].update({f"ms_{k.replace(' ', '_')}": v for k, v in ms.items()})

    s32 = REC_F32_SEQ[REC_RG]
    t0 = time.perf_counter()
    got, want = first_period_f32(torch, dev, cfg, first, tokens[:, :s32])
    diff, ok = f32_period_agree(torch, got, want)
    print(f"[rec] 16a f32 first period (RG-LRU, RG-LRU, local attention) at full "
          f"width on {s32} tokens, card vs CPU (the code the CPU tests hold to the "
          f"reference): max|d| {diff:.3e} at |h| max {want.abs().max().item():.1f} "
          f"(|d| <= {REC_F32_TOL} (1 + |h|)), {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    check(ok, "16a: the card's f32 first period disagrees with the CPU's")
    out["16a"]["f32_period_max_diff"] = diff
    del first, got, want
    sub["16a"] = time.perf_counter() - t_sub

    # -- 16b: the scheduler, reused slots against a fresh pool -------------
    t_sub = time.perf_counter()
    trace = cell_trace(RG_SCHED, cfg.vocab)
    calls, restore = record_slot_calls(ModelStep)
    torch.cuda.reset_peak_memory_stats()
    try:
        res = launch.run_scheduler(kcfg, weights, trace,
                                   prefill_chunk=RG_SCHED["prefill_chunk"],
                                   max_queue=RG_SCHED["max_queue"], device=dev,
                                   **RG_MODEL)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 2**30
    summ, kinds = res["summary"], res["step_kinds"]
    acct = summ["accounting"]
    sch = res["scheduler"]
    m = sch.model
    dec = sorted(t for t, (p, d) in zip(res["step_ms"], kinds) if d and not p)
    single = sum(p for p, _ in kinds)
    longs = sum(1 for r in trace if len(r.prompt) > window)
    reused = sorted(key for key in calls if key[1] > 1)
    t_rep = time.perf_counter()
    replays = {key: replay_tenant(torch, dev, kcfg, weights, key[0], calls[key])
               for key in reused}
    t_rep = time.perf_counter() - t_rep
    print(f"[rec] 16b scheduler, {m.slots} slots x {m.max_seq} rows ({window}-row "
          f"rings, rank-{m.kv_sketch_rank} rolling sketches on "
          f"{len(m._kv_roll_paths)} ring paths), prefill_chunk "
          f"{RG_SCHED['prefill_chunk']}; trace {RG_SCHED['trace']} ({longs} prompts "
          f"past the window): {res['tokens']} tokens in {res['seconds']:.2f} s wall "
          f"({res['tokens_per_s']:.1f} tok/s); {res['steps']} scheduler steps, "
          f"{single} single-slot prefill and catch-up calls, "
          f"{sum(d for _, d in kinds)} batched decode steps (median decode-only step "
          f"{dec[len(dec) // 2] if dec else float('nan'):.2f} ms over {len(dec)}); "
          f"peak memory {peak:.2f} GiB; accounting {acct} [{card}]")
    print(f"[rec] 16b virtual clock: TTFT p50 / p99 {summ['ttft_p50_s']:.4f} / "
          f"{summ['ttft_p99_s']:.4f} s, TPOT p50 / p99 {summ['tpot_p50_s']:.5f} / "
          f"{summ['tpot_p99_s']:.5f} s, latency p50 / p99 {summ['latency_p50_s']:.4f} "
          f"/ {summ['latency_p99_s']:.4f} s; reused slots (slot, tenant): "
          + "; ".join(f"{key} {n} calls, {eq} bit-equal to a fresh pool's, corr "
                      f">= {c:.7f}, excess {e:.2f} ulp" for key, (c, e, eq, n)
                      in replays.items())
          + f" ({t_rep:.1f} s to replay) [{card}]")
    check(acct["unaccounted"] == 0 and acct["in_flight"] == 0
          and acct["completed"] + acct["rejected"] == len(trace),
          f"16b: requests not accounted: {acct}")
    check(all(0 < len(r.out) <= r.max_new for r in sch.finished),
          "16b: a finished request has no output or too much")
    check(len({s for s, _ in reused}) >= 2,
          f"16b: reused (slot, tenant) {reused}: fewer than 2 slots")
    check(all(c > 0.9999 and e <= BF16_EXCESS for c, e, _, _ in replays.values()),
          "16b: a reused slot's request differs from the same calls in a fresh pool")
    out["16b"] = {"tokens": res["tokens"], "seconds": res["seconds"],
                  "steps": res["steps"], "single_slot_calls": single,
                  "peak_gib": peak, "summary": summ,
                  "median_decode_ms": dec[len(dec) // 2] if dec else None,
                  "reused": {str(k): v for k, v in replays.items()}}
    del calls, res
    sub["16b"] = time.perf_counter() - t_sub

    # -- 16e: a drained window through kernel 2's rolling sketch -----------
    t_sub = time.perf_counter()
    slot = int(m.pos.argmax())
    pos = int(m.pos[slot])
    j, path = 0, m._kv_roll_paths[0]
    rows = m._kv_leaf_rows_ring(path, slot, pos - window, window)[:1]   # period 0
    key = m._kv_roll_key(slot, j)
    flush = m._kv_flush_every
    k2.launches = 0
    state = kv_compress.kv_rolling_init(key, 1, cfg.head_dim, window,
                                        m.kv_sketch_rank, method="shgemm_fused",
                                        device=dev)
    for start in range(0, window, flush):
        state = kv_compress.kv_rolling_append(state, rows[:, start:start + flush],
                                              pos - window + start)
    torch.cuda.synchronize()
    launches = k2.launches
    fin = stream.rolling_finalize(state)
    p_w = state.base.p
    fresh = stream.update(stream.init(key, cfg.head_dim, p_w, max_rows=window,
                                      method="shgemm_fused", heads=1, device=dev),
                          rows.float(), 0)
    bitwise = torch.equal(fin.y, fresh.y)
    a = rows[0].float().contiguous()
    kern = (lambda: fused_at_row_offset(a, state.base.key_omega, p_w, 0))
    plain = k2.shgemm_fused_plain(a, state.base.key_omega, p_w)
    err = (kern() - plain).abs().max().item()
    expected = window // flush
    print(f"[rec] 16e slot {slot}'s window after the drain (pos {pos}; {path}, "
          f"period 0: {tuple(rows.shape)}) streamed through kv_rolling_init(method="
          f"'shgemm_fused') + kv_rolling_append in {flush}-row flushes at its "
          f"absolute positions: kernel 2 launches {launches} (= {expected} flushes "
          f"x 1 kv head: {launches == expected}); finalize == the one-shot sketch "
          f"of the window bit for bit: {bitwise}; kernel vs shgemm_fused_plain max "
          f"abs err {err:.3e} (rtol 1e-5, atol 1e-4) [{card}]")
    times = kernel2_sketch_times(torch, dev, "recurrent 16e", a, state.base.key_omega,
                                 p_w, card)
    check(launches == expected, f"16e: kernel 2 launches {launches} != {expected}")
    check(bitwise, "16e: the rolling sketch's finalize != the one-shot window sketch")
    check(torch.allclose(kern(), plain, rtol=1e-5, atol=1e-4),
          "16e: kernel 2 disagrees with its plain version")
    out["16e"] = {"launches": launches, "shape": [window, a.shape[1], p_w],
                  "max_abs_err": err, **times}
    del state, fin, fresh, rows, a, sch, m
    sub["16e"] = time.perf_counter() - t_sub

    # -- 16d (recurrentgemma): a long_500k decode step ---------------------
    long_ms = {}

    def long_decode(name, cfg_, kcfg_, weights_):
        step = R.make_serve_step(kcfg_)
        cache = cache_mod.build_cache(cfg_, 1, LONG_SEQ, device=dev)
        held = sum(leaf.numel() * leaf.element_size() for g in ("pre", "scan", "rem")
                   for layer in cache[g] or () for leaf in layer.values())
        want = cache_mod.cache_bytes(cfg_, 1, LONG_SEQ)
        tok = torch.randint(0, cfg_.vocab, (1, 1), generator=gen, device=dev)
        walls = {LONG_SEQ - 1: [], 4095: []}
        for rnd in range(5):                      # the two positions in turns
            for wp, seen in walls.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = step(weights_, {"tokens": tok, "cache": cache,
                                            "write_pos": wp})
                torch.cuda.synchronize()
                if rnd:
                    seen.append((time.perf_counter() - t0) * 1e3)
                check(bool(torch.isfinite(logits).all()),
                      f"16d: {name} decode logits at write_pos {wp} not finite")
        times = {wp: sorted(v)[len(v) // 2] for wp, v in walls.items()}
        print(f"[rec] 16d {name} long_500k: one decode step on a cache built for "
              f"max_seq {LONG_SEQ} ({held / 2**20:.2f} MiB; cache_bytes "
              f"{want / 2**20:.2f} MiB: {held == want}) at write_pos {LONG_SEQ - 1}: "
              f"{times[LONG_SEQ - 1]:.2f} ms, at write_pos 4095: {times[4095]:.2f} ms "
              f"(medians of 4, in turns after one round) [{card}]")
        check(held == want, f"16d: {name} cache {held} B != cache_bytes {want} B")
        long_ms[name] = {"bytes": held, "ms_500k": times[LONG_SEQ - 1],
                         "ms_4k": times[4095]}

    long_decode(cfg.name, cfg, kcfg, weights)
    del weights
    gc.collect()
    torch.cuda.empty_cache()

    # -- 16c: xlstm-350m ----------------------------------------------------
    t_sub = time.perf_counter()
    cfg = R.get_arch(REC_XL)
    kcfg = cfg.with_(use_flash_kernel=True)
    weights, first = rec_weights(torch, dev, cfg)
    nbytes = sum(w.numel() * w.element_size() for w in weights.values())
    print(f"[rec] {cfg.name}: {T.param_count(cfg) / 1e6:.1f} M parameters at the "
          f"published widths ({cfg.n_layers} layers in the pattern 7 x mLSTM + "
          f"sLSTM; d_model {cfg.d_model}, {cfg.n_heads} heads, mLSTM width "
          f"{int(cfg.rnn.mlstm_proj_factor * cfg.d_model)}, conv "
          f"{cfg.rnn.conv_width}, vocab {cfg.vocab}), bf16 from f32 masters of seed "
          f"0: {nbytes / 1e9:.2f} GB [{card}]")
    tokens = torch.randint(0, cfg.vocab, (1, XL_PREFILL_SEQ + 1), generator=gen,
                           device=dev)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = launch.run_prefill(kcfg, weights, tokens[:, :XL_PREFILL_SEQ])
    torch.cuda.synchronize()
    t_pre = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(logits).all()), "16c: prefill logits not finite")
    # the sLSTM's time loop alone: layer 7 of period 0 on REC_CHUNK_PROMPT
    # random hidden states
    h = torch.randn((1, REC_CHUNK_PROMPT, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    p7 = {k[len("layers/p7/"):]: v[0] for k, v in weights.items()
          if k.startswith("layers/p7/")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.slstm_block(cfg, p7, h, cache=None, return_cache=False)
    torch.cuda.synchronize()
    t_sl = (time.perf_counter() - t0) * 1e3
    n_sl = sum(1 for sp in cfg.layer_specs() if sp.mixer == "slstm")
    grown = cache_mod.grow_cache(cache, 1, cfg)
    ok, diff, corr, t_dec = decode_vs_forward(torch, kcfg, weights, grown, tokens,
                                              XL_PREFILL_SEQ)
    print(f"[rec] 16c {cfg.name} (1, {XL_PREFILL_SEQ}) make_prefill_step: "
          f"{t_pre:.1f} ms (first call), peak memory {peak:.2f} GiB, state leaves "
          f"{sorted(cache['scan'][0])} / {sorted(cache['scan'][7])}; one sLSTM layer's "
          f"time loop over {REC_CHUNK_PROMPT} tokens {t_sl:.1f} ms "
          f"({1e3 * t_sl / REC_CHUNK_PROMPT:.1f} us a step; {n_sl} such layers); "
          f"grow_cache + one decode step ({t_dec:.1f} ms) vs a full forward over "
          f"{XL_PREFILL_SEQ + 1} (one mLSTM chunk of {XL_PREFILL_SEQ + 1}, the "
          f"reference's rule): max|d| {diff:.3e}, correlation {corr:.6f} (rtol = "
          f"atol = 0.15, correlation > 0.99) [{card}]")
    check(ok, "16c: prefill + decode disagrees with the full forward")
    out["16c"] = {"ms_prefill": t_pre, "peak_gib": peak, "slstm_layer_ms": t_sl,
                  "decode_max_diff": diff, "decode_corr": corr, "ms_decode": t_dec}
    del cache, grown, logits, h

    prompt = tokens[0, :REC_CHUNK_PROMPT].tolist()
    ms, (ok_full, msg_full), (ok_head, msg_head) = prefill_rows_runs(
        torch, dev, kcfg, weights, prompt)
    print(f"[rec] 16c a {REC_CHUNK_PROMPT}-token prompt through ModelStep."
          f"prefill_rows (8 slots) in one chunk ({ms['one chunk']:.1f} ms) and in "
          f"chunks of {REC_CHUNK} ({ms['chunks']:.1f} ms): last logits {msg_full}; "
          f"its first {REC_STEPWISE} tokens one at a time "
          f"({ms['token by token']:.1f} ms) against one chunk of them: {msg_head} "
          f"[{card}]")
    check(ok_full, "16c: chunked prefill disagrees with the one-chunk prefill")
    check(ok_head, "16c: token-by-token prefill disagrees with one chunk")
    out["16c"].update({f"ms_{k.replace(' ', '_')}": v for k, v in ms.items()})

    s32 = REC_F32_SEQ[REC_XL]
    t0 = time.perf_counter()
    got, want = first_period_f32(torch, dev, cfg, first, tokens[:, :s32])
    diff, ok = f32_period_agree(torch, got, want)
    print(f"[rec] 16c f32 first period (7 mLSTM + sLSTM) at full width on {s32} "
          f"tokens ({s32 // 256} mLSTM chunks), card vs CPU: max|d| {diff:.3e} at "
          f"|h| max {want.abs().max().item():.1f} (|d| <= {REC_F32_TOL} (1 + |h|)), "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    check(ok, "16c: the card's f32 first period disagrees with the CPU's")
    out["16c"]["f32_period_max_diff"] = diff
    del first, got, want

    # the engine, staggered: requests arrive at XL_SUBMIT_AT steps, so that
    # slots idle through unmasked decode steps and are reused
    prompts = launch.make_prompts(XL_PROMPTS, XL_PROMPT_LEN, cfg.vocab, seed=3)
    eng = Engine(kcfg, weights, device=dev, **XL_ENGINE_KW)
    reqs = [Request(rid=i, prompt=p, max_new=XL_MAX_NEW) for i, p in enumerate(prompts)]
    slot_of, steps = {}, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while steps <= XL_SUBMIT_AT[-1] or eng.queue or any(eng.active):
        for i, at in enumerate(XL_SUBMIT_AT):
            if at == steps:
                eng.submit(reqs[i])
        eng.step()
        steps += 1
        for s, r in enumerate(eng.active):
            if r is not None:
                slot_of.setdefault(r.rid, s)
    torch.cuda.synchronize()
    t_eng = time.perf_counter() - t0
    tenants = [sum(1 for s in slot_of.values() if s == k) for k in range(eng.slots)]
    t0 = time.perf_counter()
    lone = [lone_engine_run(torch, dev, kcfg, weights, r.prompt, slot_of[r.rid])
            for r in reqs]
    t_lone = time.perf_counter() - t0
    same = [r.out == o for r, o in zip(reqs, lone)]
    print(f"[rec] 16c Engine ({XL_ENGINE_KW}), {XL_PROMPTS} prompts of "
          f"{XL_PROMPT_LEN} submitted at steps {list(XL_SUBMIT_AT)}, {XL_MAX_NEW} "
          f"new: {steps} steps in {t_eng:.2f} s; tenants a slot {tenants}; each "
          f"request's greedy tokens == its lone run in a fresh engine (same slot): "
          f"{same} ({t_lone:.1f} s for the lone runs) [{card}]")
    check(all(len(r.out) == XL_MAX_NEW for r in reqs),
          "16c: the engine did not serve every request to its end")
    check(max(tenants) >= 2, "16c: no slot was reused")
    check(all(same), "16c: a request's tokens differ from its lone run")
    out["16c"].update({"engine_steps": steps, "engine_s": t_eng,
                       "tenants": tenants})
    del eng, reqs, lone
    sub["16c"] = time.perf_counter() - t_sub

    t_sub = time.perf_counter()
    long_decode(cfg.name, cfg, kcfg, weights)
    out["16d"] = long_ms
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    sub["16d"] = time.perf_counter() - t_sub

    out["seconds"] = time.perf_counter() - t_phase
    print(f"[rec] phase 16 took {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sub.items())
          + f"); kernel 2 launches in 16e {out['16e']['launches']} (count set to "
          f"0 before the run) [{card}]")
    check(out["seconds"] <= PHASE16_LIMIT_S,
          f"phase 16 took {out['seconds']:.1f} s > {PHASE16_LIMIT_S} s")
    return out


# Phase 17: enc-dec and VLM serving at full width and depth, random weights
# from a seed drawn straight into bf16 (PERF.md section 4).  whisper-large-v3
# (a 32-layer bidirectional encoder over 1500 frame embeddings and 32
# decoder layers with cross-attention; d_model 1280, 20 heads of 64; 3.91
# GB): 8 utterances, a teacher-forced decoder prefill of 448 tokens (its
# published text context, max_target_positions), then a 224-token prefill
# and 32 decode steps.  llava-next-34b (60 layers, d_model 7168, 56|8 heads
# of 128, 576 image rows; 68.88 GB): a (1, 576 + 3520) prefill, cut from
# 32768 by memory (the KV alone 8.05 GB there and the plain path's f32
# score chunk 7.5 GB beside the weights), 16 decode steps, and a text-only
# lockstep of the kernel and plain engines (the reference's Engine takes no
# image).  Kernel 3 runs at G 1 (whisper) and G 7 (llava), kernel 4 at G 7,
# kernel 2 on llava's K sketches.
ENCDEC_ARCH, VLM_ARCH = "whisper-large-v3", "llava-next-34b"
WH_BATCH, WH_TEXT = 8, 448                       # 17a
WH_DECODE_PREFIX, WH_DECODE_STEPS = 224, 32      # 17a
LV_TEXT = 3520                                   # 17b: 576 + 3520 = 4096 rows
LV_DECODE_STEPS = 16                             # 17b
LV_ENGINE_KW = dict(slots=4, max_seq=2048, kv_sketch_rank=32, kv_compress_ratio=2.0)
LV_PROMPTS, LV_PROMPT_LEN, LV_MAX_NEW = 4, 128, 64   # 17b lockstep
PHASE17_LIMIT_S = 200.0


def phase17_encdec_vlm(torch, dev, card) -> dict:
    """Phase 17: whisper-large-v3 and llava-next-34b through the serving
    entry points at full width and depth: (17a) whisper's encoder, its
    decoder prefill on the kernel and plain paths, grow_cache + 32 decode
    steps against full forwards; (17b) llava's prefill with its image rows
    on both paths, its layer-0 K history sketched through kernel 2, 16
    decode steps against full forwards, the kernel and plain engines in
    lockstep, kernel 4 at G 7 on the final state; (17c) kernel 3 alone at G
    7 and G 1."""
    with torch.inference_mode():       # serving: no autograd bookkeeping
        return _phase17(torch, dev, card)


def decode_steps_vs_forward(torch, kcfg, weights, cache, tokens, start, steps,
                            extra, floor=None):
    """``steps`` teacher-forced decode steps on ``cache`` (grown by ``steps``
    rows) from write_pos ``start`` (the prefill's rows, image rows
    included), each against a full forward over every token up to it, at
    the reference's 0.15 with correlation > 0.99; where a bf16 ulp of the
    logits exceeds 0.15 (whisper's tied logits reach ~1000, an ulp of 8),
    the bf16 gate of phase 6 instead; given ``floor`` (the bf16 plain
    path's own max |d| from the f32 path, ``f32_anchor``), max |d| <= 1.5x
    it passes too.  Returns (worst max |d|, least correlation, |logit|
    max, ms a step, the worst step's message)."""
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    step = R.make_serve_step(kcfg)
    n_img = start - (tokens.shape[1] - steps)
    worst, least, peak, times, worst_msg = 0.0, 1.0, 0.0, [], ""
    for i in range(steps):
        col = tokens.shape[1] - steps + i
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = step(weights, {"tokens": tokens[:, col:col + 1], "cache": cache,
                                "write_pos": start + i})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        want = R._final_logits(kcfg, T.forward(kcfg, weights, tokens[:, :col + 1],
                                               last_only=True, **extra).logits[:, -1])
        corr = torch.corrcoef(torch.stack([got.ravel(), want.ravel()]))[0, 1].item()
        ok, msg = logits_agree(torch, got, want, "bfloat16", 0.15)
        d = (got - want).abs().max().item()
        ok = (ok or bool(torch.allclose(got, want, rtol=0.15, atol=0.15))
              or (floor is not None and d <= 1.5 * floor))
        check(ok and corr > 0.99,
              f"decode step {i} at write_pos {start + i} ({n_img} image rows) "
              f"disagrees with the full forward: {msg}")
        if d >= worst:
            worst, worst_msg = d, msg
        least, peak = min(least, corr), max(peak, want.abs().max().item())
    return worst, least, peak, sorted(times)[len(times) // 2], worst_msg


def flash_case(torch, gen, label, b, s, h, kvh, hd, card) -> dict:
    """Kernel 3 at (b, s, h|kvh, hd) bf16 causal against its plain version,
    then timed by CUDA events and by a CUDA-graph replay beside its plain
    version, ``scaled_dot_product_attention`` (the library call) and its
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k3
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=gen.device)
               .to(torch.bfloat16) for n in (h, kvh, kvh))
    got = k3.flash_attention(q, k, v, causal=True)
    want = k3.flash_attention_plain(q, k, v, causal=True)
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    check(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=3e-2)
          and rel <= FLASH_ROW_REL["bfloat16"],
          f"flash_attention {label} disagrees with plain")
    del got, want
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    call = (lambda: k3.flash_attention(q, k, v, causal=True))
    t_k, t_g = median_ms(torch, call), graph_ms(torch, call, n=10)
    t_p = median_ms(torch, lambda: k3.flash_attention_plain(q, k, v, causal=True))
    t_l = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    t_ops = k3.causal_flops(b, s, h, hd) / PEAK_TC_FLOP_PER_S
    t_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) / PEAK_BYTES_PER_S
    bound, by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
    print(f"[time] flash_attention {label} ({b}, {s}, {h}|{kvh}, {hd}) G {h // kvh} "
          f"bf16 causal: max|kernel-plain| {err:.3e} (rtol 2e-2, atol 3e-2), "
          f"largest row ||kernel-plain||/||plain|| {rel:.3e} (bound "
          f"{FLASH_ROW_REL['bfloat16']}); kernel {t_k:.4f} ms by CUDA events, "
          f"{t_g:.4f} ms a launch in a CUDA graph, plain {t_p:.3f} ms, "
          f"scaled_dot_product_attention {t_l:.4f} ms, bound {bound:.4f} ms ({by}); "
          f"graph/bound {t_g / bound:.2f}x, "
          f"{k3.causal_flops(b, s, h, hd) / t_g / 1e9:.1f} TFLOP/s [{card}]")
    return {"shape": [b, s, h, kvh, hd], "max_abs_err": err, "row_rel_err": rel,
            "ms": t_k, "graph_ms": t_g, "plain_ms": t_p, "library_ms": t_l,
            "bound_ms": bound, "bound_by": by}


def kernel2_sketch_times(torch, dev, label, a, key, p_w, card) -> dict:
    """Kernel 2 on one (rows, d) history at Omega row 0: CUDA events, the
    profiler's device time with the launches its trace held, a launch
    replayed from a CUDA graph (which the profiler cannot lose), the plain
    version, cuBLAS's f32 matmul of the same product likewise, and the
    bound."""
    from repro_torch.core import projection as proj
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.stream.state import fused_at_row_offset
    kern = (lambda: fused_at_row_offset(a, key, p_w, 0))
    omega32 = proj.fused_omega(key, (a.shape[1], p_w), device=dev).float()
    lib = (lambda: torch.matmul(a, omega32))
    t_k, d_k, g_k = median_ms(torch, kern), device_ms(torch, kern), graph_ms(torch, kern)
    t_p = median_ms(torch, lambda: k2.shgemm_fused_plain(a, key, p_w))
    t_l, d_l, g_l = median_ms(torch, lib), device_ms(torch, lib), graph_ms(torch, lib)
    t_b, by = bound_ms(a.shape[0], a.shape[1], p_w, 2, 0)
    print(f"[time] shgemm_fused {label} ({a.shape[0]}x{a.shape[1]} @ "
          f"{a.shape[1]}x{p_w}, gaussian bf16, 2 terms): kernel {t_k:.4f} ms by CUDA "
          f"events, {g_k:.4f} ms a launch in a CUDA graph, device {fmt_dev(d_k)} ms; "
          f"plain {t_p:.4f} ms; f32 matmul {t_l:.4f} ms, graph {g_l:.4f} ms, device "
          f"{fmt_dev(d_l)} ms; bound {t_b:.4f} ms ({by}) [{card}]")
    return {"ms": t_k, "graph_ms": g_k, "device_ms": d_k[0],
            "device_launches_traced": list(d_k[1:]), "plain_ms": t_p,
            "library_ms": t_l, "library_graph_ms": g_l, "library_device_ms": d_l[0],
            "bound_ms": t_b, "bound_by": by}


def _phase17(torch, dev, card) -> dict:
    from repro_torch.kernels import factored_decode as k4
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import shgemm_fused as k2
    from repro_torch.launch import serve as launch
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_compress
    from repro_torch.serve.engine import Engine
    from repro_torch.stream.state import fused_at_row_offset
    t_phase = time.perf_counter()
    out, sub = {}, {}
    gen = torch.Generator(device=dev).manual_seed(1717)

    def draw(cfg):
        base = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        w = T.cast_params_for_compute(
            cfg, launch.init_weights(cfg, seed=0, device=dev, compute_dtype=True))
        torch.cuda.synchronize()
        nbytes = sum(x.numel() * x.element_size() for x in w.values())
        print(f"[encdec] {cfg.name}: {T.param_count(cfg) / 1e9:.3f} B parameters at "
              f"the published widths ({cfg.n_layers} layers"
              + (f" + a {cfg.encdec.enc_layers}-layer encoder over "
                 f"{cfg.encdec.enc_seq} frames" if cfg.encdec else "")
              + (f", {cfg.vlm.num_image_tokens} image rows" if cfg.vlm else "")
              + f", d_model {cfg.d_model}, {cfg.n_heads}|{cfg.n_kv_heads} heads of "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), drawn in bf16 "
              f"from seed 0: {nbytes / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} "
              f"s; device memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} "
              f"GiB ({base:.2f} GiB before the draw) [{card}]")
        return w

    def prefill_pair(tag, cfg, kcfg, weights, tokens, extra, bf16_gate=True):
        """make_prefill_step on the kernel path (counted from 0, timed on a
        first and a second call) and on the plain path, held to the bf16
        gate, or else (``bf16_gate`` False) to ``f32_anchor``'s checks."""
        torch.cuda.reset_peak_memory_stats()
        k3.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_k, cache = launch.run_prefill(kcfg, weights, tokens, **extra)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        launches = k3.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        del cache
        t0 = time.perf_counter()
        logits_k2, cache = launch.run_prefill(kcfg, weights, tokens, **extra)
        torch.cuda.synchronize()
        t_k2 = time.perf_counter() - t0
        k3.launches = 0
        t0 = time.perf_counter()
        logits_p, cache_p = launch.run_prefill(cfg, weights, tokens, **extra)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
        plain_launches = k3.launches
        del cache_p
        ok, msg = logits_agree(torch, logits_k, logits_p, "bfloat16", 5e-2)
        rows = tokens.shape[1] + (cfg.vlm.num_image_tokens if cfg.vlm else 0)
        print(f"[encdec] {tag} {cfg.name} ({tokens.shape[0]}, {rows}) "
              f"make_prefill_step: kernel path {t_k * 1e3:.1f} ms first call, "
              f"{t_k2 * 1e3:.1f} ms second (kernel 3 launches {launches}, G "
              f"{cfg.n_heads // cfg.n_kv_heads}), plain attention {t_p * 1e3:.1f} ms "
              f"(launches {plain_launches}); peak memory {peak:.2f} GiB; "
              f"last-position logits kernel vs plain: {msg} [{card}]")
        check(launches == cfg.n_layers,
              f"{tag}: flash launches {launches} != {cfg.n_layers}")
        check(plain_launches == 0, f"{tag}: the plain path launched kernel 3")
        check(bool(torch.isfinite(logits_k).all()), f"{tag}: prefill logits not finite")
        res = {"launches": launches, "ms_first": t_k * 1e3, "ms_second": t_k2 * 1e3,
               "ms_plain": t_p * 1e3, "peak_gib": peak,
               "err": (logits_k - logits_p).abs().max().item(), "bf16_gate": ok}
        if bf16_gate:
            check(ok, f"{tag}: the kernel path's prefill logits disagree with the plain path's")
        else:
            res.update(f32_anchor(tag, cfg, weights, tokens, extra, logits_k, logits_p))
        return cache, res

    def f32_anchor(tag, cfg, weights, tokens, extra, logits_k, logits_p):
        """Where bf16 rounding alone moves the logits past the bf16 gate (both
        bf16 paths equally far from the f32 one; PERF.md section 6):
        kernel 3 against its plain version on every layer's own inputs of
        the bf16 prefill (``FLASH_ROW_REL``), the two paths in f32
        activations on the same bf16 weights at the reference's 5e-2, and
        the bf16 kernel path no farther from the f32 plain path than 1.5x
        the bf16 plain path (max |d| and 1 - correlation)."""
        rows, orig = [], kops.flash_attention

        def held(q, k, v, *, causal=True, scale=None):
            out = orig(q, k, v, causal=causal, scale=scale)
            want = k3.flash_attention_plain(q, k, v, causal=causal, scale=scale)
            rows.append((row_rel_err(out, want), (out.float() - want.float()).abs().max().item()))
            return out
        kops.flash_attention = held
        try:
            launch.run_prefill(cfg.with_(use_flash_kernel=True), weights, tokens, **extra)
        finally:
            kops.flash_attention = orig
        rel, err = max(r for r, _ in rows), max(e for _, e in rows)
        f32 = cfg.with_(activation_dtype="float32")
        ex32 = {k: v.float() for k, v in extra.items()}
        k32, c = launch.run_prefill(f32.with_(use_flash_kernel=True), weights, tokens, **ex32)
        del c
        p32, c = launch.run_prefill(f32, weights, tokens, **ex32)
        del c
        ok32, msg32 = logits_agree(torch, k32, p32, "float32", 5e-2)

        def dist(a):
            corr = torch.corrcoef(torch.stack([a.ravel(), p32.ravel()]))[0, 1].item()
            return (a - p32).abs().max().item(), 1.0 - corr
        dk, dp = dist(logits_k), dist(logits_p)
        near = dk[0] <= 1.5 * dp[0] and dk[1] <= 1.5 * dp[1]
        print(f"[encdec] {tag} bf16 gate kernel vs plain: not held (bf16 rounding of "
              f"the stack, below); kernel 3 against its plain version on each of the "
              f"{len(rows)} layers' own inputs: largest row ||kernel-plain||/||plain|| "
              f"{rel:.3e} (bound {FLASH_ROW_REL['bfloat16']}), max|d| {err:.3e}; f32 "
              f"activations (bf16 weights) kernel vs plain: {msg32}; against the f32 "
              f"plain path (max|d|, 1 - correlation): bf16 kernel path ({dk[0]:.4e}, "
              f"{dk[1]:.3e}), bf16 plain path ({dp[0]:.4e}, {dp[1]:.3e}): kernel within "
              f"1.5x the plain path's own bf16 error {near} [{card}]")
        check(rel <= FLASH_ROW_REL["bfloat16"],
              f"{tag}: kernel 3 disagrees with plain on a layer's inputs ({rel:.3e})")
        check(ok32, f"{tag}: f32 activations: kernel path disagrees with the plain path")
        check(near, f"{tag}: the bf16 kernel path is farther from the f32 path than "
                    f"1.5x the bf16 plain path: {dk} vs {dp}")
        return {"layer_row_rel_err": rel, "layer_max_abs_err": err,
                "f32_max_diff": (k32 - p32).abs().max().item(),
                "bf16_kernel_vs_f32": list(dk), "bf16_plain_vs_f32": list(dp)}

    # -- 17a: whisper-large-v3 ---------------------------------------------
    t_sub = time.perf_counter()
    cfg = R.get_arch(ENCDEC_ARCH)
    kcfg = cfg.with_(use_flash_kernel=True)
    weights = draw(cfg)
    enc = launch.stub_embeds(cfg, WH_BATCH, seed=2, device=dev)
    tokens = torch.randint(0, cfg.vocab, (WH_BATCH, WH_TEXT), generator=gen, device=dev)
    enc_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc_out = T.encoder_forward(cfg, weights, enc["enc_embeds"])
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(enc_out).all()), "17a: encoder output not finite")
    print(f"[encdec] 17a {cfg.name} encoder over ({WH_BATCH}, {cfg.encdec.enc_seq}, "
          f"{cfg.d_model}) frame embeddings (0.01 N(0, 1), seed 2; bidirectional, "
          f"the plain attention): {enc_ms[0]:.1f} ms first call, {enc_ms[1]:.1f} ms "
          f"second [{card}]")
    del enc_out
    cache, res = prefill_pair("17a", cfg, kcfg, weights, tokens, enc)
    xk = cache["scan"][0]["xk"]
    check(tuple(xk.shape[1:]) == (WH_BATCH, cfg.encdec.enc_seq, cfg.n_kv_heads,
                                  cfg.head_dim), f"17a: xk leaf {tuple(xk.shape)}")
    del cache, xk
    out["17a"] = {"encoder_ms": enc_ms, **res}
    # grow_cache + 32 decode steps on a 224-token prefill, each against a full
    # forward (the encoder's K/V ride in the cache; the forwards rerun it)
    pre = WH_DECODE_PREFIX
    torch.cuda.reset_peak_memory_stats()
    _, cache = launch.run_prefill(kcfg, weights, tokens[:, :pre], **enc)
    grown = cache_mod.grow_cache(cache, WH_DECODE_STEPS, cfg)
    del cache
    worst, least, peak_logit, dec_ms, msg = decode_steps_vs_forward(
        torch, kcfg, weights, grown, tokens[:, :pre + WH_DECODE_STEPS], pre,
        WH_DECODE_STEPS, enc)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[encdec] 17a grow_cache + {WH_DECODE_STEPS} decode steps of {WH_BATCH} "
          f"utterances from write_pos {pre}, each against a full forward (encoder "
          f"included; rtol = atol = 0.15 or the bf16 gate, correlation > 0.99): "
          f"worst step {msg}; least correlation {least:.6f}; "
          f"decode step {dec_ms:.2f} ms (median); peak memory {peak:.2f} GiB [{card}]")
    out["17a"].update({"decode_max_diff": worst, "decode_logit_max": peak_logit,
                       "decode_corr": least,
                       "decode_ms": dec_ms, "decode_peak_gib": peak})
    del grown, weights, enc, tokens
    gc.collect()
    torch.cuda.empty_cache()
    sub["17a"] = time.perf_counter() - t_sub

    # -- 17b: llava-next-34b -------------------------------------------------
    t_sub = time.perf_counter()
    cfg = R.get_arch(VLM_ARCH)
    kcfg = cfg.with_(use_flash_kernel=True)
    h, kvh, hd, n_layers = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    n_img = cfg.vlm.num_image_tokens
    weights = draw(cfg)
    img = launch.stub_embeds(cfg, 1, seed=2, device=dev)
    tokens = torch.randint(0, cfg.vocab, (1, LV_TEXT + LV_DECODE_STEPS), generator=gen,
                           device=dev)
    cache, res = prefill_pair("17b", cfg, kcfg, weights, tokens[:, :LV_TEXT], img,
                              bf16_gate=False)
    out["17b"] = res
    # kernel 2 on the K sketches: layer 0's K history of the 4096 rows (image
    # and text), 8 kv heads at Omega rows h * 128, in the engine's 16-row
    # flushes, against the one-shot sketch and the plain version
    rows = cache["scan"][0]["k"][0, 0].transpose(0, 1)        # (KV, S, hd)
    pos = rows.shape[1]
    flush = 16
    key = (0x5EED, 17)
    k2.launches = 0
    state = kv_compress.kv_sketch_init(key, kvh, hd, pos, LV_ENGINE_KW["kv_sketch_rank"],
                                       method="shgemm_fused", device=dev)
    for start in range(0, pos, flush):
        state = kv_compress.kv_sketch_append(state, rows[:, start:start + flush], start)
    torch.cuda.synchronize()
    launches2 = k2.launches
    bitwise, err2 = True, 0.0
    for j in range(kvh):
        one = fused_at_row_offset(rows[j].float(), state.key_omega, state.p, j * hd)
        plain = k2.shgemm_fused_plain(rows[j].float(), state.key_omega, state.p,
                                      row_offset=j * hd)
        bitwise &= torch.equal(state.y[j, :pos], one)
        err2 = max(err2, (one - plain).abs().max().item())
        check(torch.allclose(one, plain, rtol=1e-5, atol=1e-4),
              f"17b: kernel 2 on head {j} disagrees with plain")
    expected = -(-pos // flush) * kvh
    print(f"[encdec] 17b layer-0 K history ({kvh}, {pos}, {hd}) streamed through "
          f"kv_sketch_init(method='shgemm_fused') + kv_sketch_append in {flush}-row "
          f"flushes: kernel 2 launches {launches2} (= {-(-pos // flush)} flushes x "
          f"{kvh} kv heads: {launches2 == expected}); every head's sketch == kernel "
          f"2's one-shot sketch bit for bit: {bitwise}; one-shot vs plain max abs err "
          f"{err2:.3e} (rtol 1e-5, atol 1e-4) [{card}]")
    check(launches2 == expected, f"17b: kernel 2 launches {launches2} != {expected}")
    check(bitwise, "17b: the streamed K sketch differs from the one-shot sketch")
    a = rows[0].float().contiguous()
    sketch = kernel2_sketch_times(torch, dev, "vlm 17b", a, state.key_omega, state.p,
                                  card)
    out["17b_sketch"] = {"launches": launches2, "shape": [pos, hd, state.p],
                         "max_abs_err": err2, **sketch}
    del rows, state, a, one, plain
    # grow_cache + 16 decode steps against full forwards (image rows included)
    grown = cache_mod.grow_cache(cache, LV_DECODE_STEPS, cfg)
    del cache
    torch.cuda.reset_peak_memory_stats()
    floor = out["17b"]["bf16_plain_vs_f32"][0]
    worst, least, peak_logit, dec_ms, msg = decode_steps_vs_forward(
        torch, kcfg, weights, grown, tokens, n_img + LV_TEXT, LV_DECODE_STEPS, img,
        floor=floor)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[encdec] 17b grow_cache + {LV_DECODE_STEPS} decode steps from write_pos "
          f"{n_img + LV_TEXT} ({n_img} image rows + {LV_TEXT} tokens), each against a "
          f"full forward (rtol = atol = 0.15, the bf16 gate or max|d| <= 1.5 x "
          f"{floor:.4f}, the bf16 plain path's own distance from the f32 path; "
          f"correlation > 0.99): worst step {msg}; least correlation {least:.6f}; "
          f"decode step {dec_ms:.2f} ms (median); peak memory {peak:.2f} GiB [{card}]")
    out["17b"].update({"decode_max_diff": worst, "decode_logit_max": peak_logit,
                       "decode_corr": least,
                       "decode_ms": dec_ms, "decode_peak_gib": peak})
    del grown, img, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # the text-only lockstep of the kernel and plain engines: kernel 4 at G 7
    prompts = launch.make_prompts(LV_PROMPTS, LV_PROMPT_LEN, cfg.vocab, seed=1)
    engines = [Engine(cfg, weights, device=dev, **LV_ENGINE_KW),
               Engine(kcfg, weights, device=dev, **LV_ENGINE_KW)]
    torch.cuda.reset_peak_memory_stats()
    k4.launches = 0
    t0 = time.perf_counter()
    res = launch.lockstep(engines, prompts, max_new=LV_MAX_NEW,
                          compare=lambda got, want: (
                              *bf16_agreement(torch, got, want),
                              bool((got.argmax(-1) == want.argmax(-1)).all()),
                              (got - want).abs().max().item()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches4 = k4.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist_p, hist_k = res["comp_len"]
    kern = engines[1]
    swaps = [sum(1 for x, y in zip([[0] * kern.slots] + hist_k, hist_k) if y[s] > x[s])
             for s in range(kern.slots)]
    corr = min(c for c, _, _, _ in res["compared"])
    excess = max(e for _, e, _, _ in res["compared"])
    same_tokens = sum(t for _, _, t, _ in res["compared"])
    worst_d = max(d for _, _, _, d in res["compared"])
    held = [t or (c > 0.9999 and e <= BF16_EXCESS) or (c > 0.99 and d <= 1.5 * floor)
            for c, e, t, d in res["compared"]]
    pool = sum(t.numel() * t.element_size() for e in engines
               for g in ("pre", "scan", "rem") for layer in e.cache[g] or ()
               for t in layer.values())
    print(f"[encdec] 17b bf16 lockstep of the kernel and plain engines, text only "
          f"({n_layers} layers, {LV_PROMPTS} prompts of {LV_PROMPT_LEN}, {LV_MAX_NEW} "
          f"new, {LV_ENGINE_KW}; the two pools {pool / 1e9:.2f} GB): {res['steps']} "
          f"decode steps in {wall:.1f} s; greedy tokens equal in {same_tokens} of "
          f"{len(held)} steps; worst excess over 2 own ulps {excess:.2f} ulp at the "
          f"median |logit| (<= {BF16_EXCESS}), least correlation {corr:.7f} (> "
          f"0.9999), worst max|d| {worst_d:.4f}; steps with equal tokens, within the "
          f"bf16 gate or within 1.5 x {floor:.4f} at correlation > 0.99 "
          f"{sum(held)} of {len(held)}; kernel 4 launches {launches4} = {res['steps']} x "
          f"{n_layers}: {launches4 == res['steps'] * n_layers}; comp_len equal "
          f"{hist_p == hist_k}; swaps per slot {swaps}; peak memory {peak:.2f} GiB "
          f"[{card}]")
    check(launches4 == res["steps"] * n_layers,
          f"17b: fdec launches {launches4} != {res['steps']} x {n_layers}")
    check(hist_p == hist_k, "17b: comp_len histories differ between the engines")
    check(min(swaps) >= 1, f"17b: a slot never compressed: {swaps}")
    check(all(held), f"17b: the engines diverge: a step's tokens differ and its "
                     f"logits miss the bf16 gate and the noise floor (excess "
                     f"{excess:.2f}, correlation {corr:.7f}, max|d| {worst_d:.4f})")
    out["17b"].update({"engine_steps": res["steps"], "engine_launches": launches4,
                       "engine_excess": excess, "engine_corr": corr,
                       "engine_same_tokens": same_tokens, "engine_max_diff": worst_d,
                       "engine_seconds": wall, "engine_peak_gib": peak,
                       "pool_gb": pool / 1e9})
    # kernel 4 at the kernel engine's final state (layer 0) against its plain
    # version, then timed (graph replay beside the profiler's count)
    wp = int(max(kern.pos)) - 1
    kc, vc = kern.cache["scan"][0]["k"][0], kern.cache["scan"][0]["v"][0]
    f = {n: w[0] for n, w in kern.kv_fact["scan"][0].items()}
    comp = torch.as_tensor(kern._kv_comp_len, device=dev)
    qd = torch.randn((kern.slots, 1, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    args = (qd, kc, vc, f["k_us"], f["k_vt"], f["v_us"], f["v_vt"], comp)
    got = k4.factored_decode_attention(*args, wp, scale=hd ** -0.5)
    want = k4.factored_decode_plain(*args, wp, scale=hd ** -0.5)
    err4 = (got.float() - want.float()).abs().max().item()
    print(f"[kernels] factored_decode {cfg.name} 17b state ({kern.slots}, "
          f"{kc.shape[1]}, {kvh}, {hd}) G {h // kvh} r={f['k_us'].shape[-1]} "
          f"write_pos={wp} comp_len={[int(c) for c in comp.tolist()]}: "
          f"max|kernel-plain| {err4:.3e} (tol 1e-2); decode_plan "
          f"{k4.decode_plan(kern.slots, kvh, kc.shape[1], hd, 32, h // kvh)}")
    check(torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2),
          "factored_decode at 17b's state disagrees with plain")
    state = fdec_state_times(torch, dev, f"{cfg.name} 17b state", args, wp, hd, 0.0, card)
    state["max_abs_err"] = err4
    out["fdec_state"] = state
    del engines, kern, kc, vc, f, args, got, want, res, weights
    gc.collect()
    torch.cuda.empty_cache()
    sub["17b"] = time.perf_counter() - t_sub

    # -- 17c: kernel 3 alone at the two prefills' shapes ---------------------
    t_sub = time.perf_counter()
    out["17c"] = {
        "G7": flash_case(torch, gen, f"{VLM_ARCH} 17c", 1, n_img + LV_TEXT, 56, 8, 128, card),
        "G1": flash_case(torch, gen, f"{ENCDEC_ARCH} 17c", WH_BATCH, WH_TEXT, 20, 20, 64,
                         card)}
    sub["17c"] = time.perf_counter() - t_sub

    out["seconds"] = time.perf_counter() - t_phase
    print(f"[encdec] phase 17 took {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sub.items())
          + f"); kernel 3 launches in 17a's prefill {out['17a']['launches']} and "
          f"17b's {out['17b']['launches']}, kernel 2 in 17b's sketches "
          f"{out['17b_sketch']['launches']}, kernel 4 in 17b's lockstep "
          f"{out['17b']['engine_launches']} (counts set to 0 before each run) [{card}]")
    check(out["seconds"] <= PHASE17_LIMIT_S,
          f"phase 17 took {out['seconds']:.1f} s > {PHASE17_LIMIT_S} s")
    return out


# Phase 18: training and serving across processes (sharding/, the mesh
# branches of models/, optim/, train/ and launch/train.py), in gloo worlds
# of local processes on the one card (no scaling is claimed: the ranks share
# the card and talk through the host).  18a trains qwen3-0.6b at full width
# and depth on a (data 2 x model 2) mesh at phase 12's cut; 18b serves
# qwen3-moe-30b-a3b at full width and depth on (data 1 x model 2): 64
# experts a rank, the vocab tables split, the attention replicated, kernel
# 3 on.
SHARD_TRAIN_WORLD = (2, 2)        # 18a: data x model ranks
SHARD_SERVE_WORLD = (1, 2)        # 18b
SHARD_STEPS = 3                   # 18a: world steps, each beside one process's
SHARD_MICRO = 4                   # 18a: four ranks' activations share the card
SHARD_SAVE_AT = 2                 # 18a: the world's checkpoint
LAUNCH_STEPS, LAUNCH_SEQ, LAUNCH_BATCH = 2, 256, 8   # 18a's launcher run,
LAUNCH_LR = 3e-4                                     # at the launcher's lr
SHARD_LAUNCH = ("--arch", ARCH, "--steps", str(LAUNCH_STEPS), "--seq",
                str(LAUNCH_SEQ), "--global-batch", str(LAUNCH_BATCH),
                "--lr", str(LAUNCH_LR), "--model-parallel", "2",
                "--ckpt-every", str(LAUNCH_STEPS))
# two AdamW runs whose gradients round apart move an element apart by at
# most 2 lr |m^|/sqrt(v^) a step, <= 1.0004 at steps 1-2 with betas (0.9,
# 0.95); weight decay adds 0.1 lr of the gap
LAUNCH_DRIFT = LAUNCH_STEPS * 2 * LAUNCH_LR * 1.001
SHARD_TIMEOUT = 420.0             # a deadlocked collective fails the phase
SHARD_GRAD_REL = 2e-2             # max-norm relative, tests/test_vocab_parallel.py
SHARD_LOSS_RTOL = 2e-5
PHASE18_LIMIT_S = 300.0


def leaf_digest(t) -> str:
    """A digest of a tensor's bytes (bit for bit comparisons across
    processes)."""
    import hashlib

    import torch
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.blake2b(t.numpy().tobytes(), digest_size=16).hexdigest()


def leaf_checksum(torch, w) -> int:
    """The exact integer sum of a tensor's bit patterns (any order gives the
    same), a leading slice at a time."""
    ints = {2: torch.int16, 4: torch.int32}[w.element_size()]
    total = 0
    for part in (w if w.dim() >= 3 else w[None]):
        total += int(part.contiguous().view(ints).to(torch.int64).sum())
    return total


def model_block(w, spec, m: int, n: int):
    """Model rank m's block of a whole leaf under a spec whose only split
    axis of more than one rank is ``model`` (of ``n``)."""
    for dim, entry in enumerate(spec):
        if entry == "model":
            k = w.shape[dim] // n
            w = w.narrow(dim, m * k, k)
    return w


def moe_world_reference(torch, cfg, kcfg, weights, prompt) -> dict:
    """What 18b holds its world to, kept on the host after 14a: the
    kernel-path last-position logits of the (1, 4096) prompt, its routed
    expert sets and the checksum of each model rank's block of every
    leaf (phase 14's one-process weights)."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import serve as launch
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import moe
    from repro_torch.sharding import rules
    specs = rules.param_specs(cfg, HostMesh(SHARD_SERVE_WORLD), serving=True)
    n = SHARD_SERVE_WORLD[1]
    sums = [{k: leaf_checksum(torch, model_block(w, specs[k], m, n))
             for k, w in weights.items()} for m in range(n)]
    routes, route = [], moe.route

    def recording(c, logits):
        gates, experts = route(c, logits)
        routes.append(torch.sort(experts, dim=-1).values.to(torch.uint8))
        return gates, experts

    kept = k3.launches
    moe.route = recording
    try:
        logits, _ = launch.run_prefill(kcfg, weights, prompt)
    finally:
        moe.route = route
        k3.launches = kept
    return {"logits": logits.float().cpu(), "routes": torch.stack(routes).cpu(),
            "sums": sums, "prompt": prompt.cpu()}


def launcher_one_process(torch, cfg, dev):
    """What 18a's launcher run is held to: one process trains the
    launcher's weights (seed 0) with its optimizer on the rows the world's
    data ranks read (``SyntheticLM`` with their ``host_id``), put together
    in data order.  The losses, and the params on the host."""
    import numpy as np
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import serve as launch
    from repro_torch.models import registry as R
    n_data = SHARD_TRAIN_WORLD[0]
    params = launch.init_weights(cfg, seed=0, device=dev)
    step = R.make_train_step(cfg, optimizer="adamw", lr=LAUNCH_LR)
    opt = step.init_opt(params)
    losses = []
    for i in range(LAUNCH_STEPS):
        parts = [SyntheticLM(vocab=cfg.vocab, seq_len=LAUNCH_SEQ,
                             global_batch=LAUNCH_BATCH, seed=0, host_id=h,
                             num_hosts=n_data).batch(i) for h in range(n_data)]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
    return losses, {k: v.cpu() for k, v in params.items()}


class CollectiveBytes:
    """Counts the bytes of the tensors this rank hands to all_reduce,
    all_gather and broadcast (its inputs), by wrapping them."""

    def __init__(self, dist):
        self.dist, self.n = dist, 0
        self.saved = {k: getattr(dist, k) for k in ("all_reduce", "all_gather",
                                                    "broadcast")}
        for name, fn in self.saved.items():
            setattr(dist, name, self._wrap(fn, name))

    def _wrap(self, fn, name):
        def call(*a, **kw):
            t = a[1] if name == "all_gather" else a[0]
            self.n += t.numel() * t.element_size()
            return fn(*a, **kw)
        return call

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def phase18_train_rank(rank, world, dev, *, sizes, batches, ckpt, launch_dir,
                       one_grads):
    """One rank of 18a: qwen3-0.6b's masters drawn as this rank's slices,
    AdamW steps on the global batches, the step-1 gradients against their
    blocks of the one-process gradients in ``one_grads`` (a file, read
    memory-mapped), a collective checkpoint at step SHARD_SAVE_AT with the
    digests of the gathered params, remesh onto ranks 0-1 and back, then
    launch.train.main inside the world."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import serve as launch
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import registry as R
    from repro_torch.optim import optimizers as O
    from repro_torch.sharding import activation as A
    from repro_torch.sharding import rules
    from repro_torch.train import loop
    from repro_torch.train.checkpoint import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = R.get_arch(ARCH)
    mesh = HostMesh(sizes).bind()
    specs = rules.param_specs(cfg, mesh)
    A.set_mesh(mesh)
    A.set_param_specs(specs)
    out = {"index": (mesh.index("data"), mesh.index("model"))}
    t0 = time.perf_counter()
    params = launch.init_weights(cfg, seed=0, device=dev, mesh=mesh, specs=specs)
    torch.cuda.synchronize()
    out["draw_s"] = time.perf_counter() - t0
    adam = O.adamw(TRAIN_LR)
    captured = {}

    def update(grads, state, p):
        captured.setdefault("grads", grads)
        return adam.update(grads, state, p)

    step = R.make_train_step(cfg, O.Optimizer(adam.init, update),
                             micro_batches=SHARD_MICRO)
    opt = step.init_opt(params)
    out["state_bytes"] = tree_bytes((params, opt["m"], opt["v"]))
    counter = CollectiveBytes(dist)
    losses, step_ms, sent = [], [], []
    try:
        for i, b in enumerate(batches):
            dist.barrier()
            torch.cuda.synchronize()
            n0, t0 = counter.n, time.perf_counter()
            params, opt, met = step(params, opt, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            sent.append(counter.n - n0)
            losses.append(float(met["loss"]))
            if i == 0:
                # max |world - one process| and max |one process| of each
                # leaf's block, then the maxima over the ranks
                g = captured.pop("grads")
                one = torch.load(one_grads, mmap=True, map_location="cpu")
                names = sorted(g)
                stats = []
                for k in names:
                    want = A.slice_leaf(one[k], specs[k], mesh).to(dev)
                    stats.append(torch.stack([(g[k] - want).abs().max(),
                                              want.abs().max()]))
                stats = torch.stack(stats)
                dist.all_reduce(stats, op=dist.ReduceOp.MAX)
                out["grad_rel"] = dict(zip(names, (
                    stats[:, 0] / stats[:, 1].clamp_min(1e-12)).tolist()))
                del g, one, stats
            if i + 1 == SHARD_SAVE_AT:
                # the write runs on rank 0's writer thread beside step 3
                ospecs = rules.opt_state_specs(cfg, mesh, opt)
                t0 = time.perf_counter()
                mgr = CheckpointManager(ckpt, mesh=mesh)
                mgr.save(SHARD_SAVE_AT, (params, opt), specs=(specs, ospecs))
                out["save_s"] = time.perf_counter() - t0
                whole = rules.gather_params(cfg, mesh, params, specs)
                if rank == 0:
                    out["saved"] = {k: leaf_digest(v) for k, v in whole.items()}
                del whole
    finally:
        counter.close()
    out.update(losses=losses, step_ms=step_ms, sent=sent,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del opt

    def specs_fn(m):
        return rules.param_specs(cfg, m)

    before = rules.gather_params(cfg, mesh, params, specs)

    def same(m, placed):
        new = specs_fn(m)
        return all(torch.equal(placed[k], A.slice_leaf(before[k], new[k], m))
                   for k in before)

    t0 = time.perf_counter()
    small, placed = loop.remesh(params, specs_fn, [0, 1], mesh=mesh)
    del params
    if small.member:
        out["small"] = same(small, placed)
    big, placed = loop.remesh(placed, specs_fn, mesh=small, device=dev)
    out["big"] = same(big, placed)
    out["remesh_s"] = time.perf_counter() - t0
    del before, placed
    t0 = time.perf_counter()
    mgr.wait()
    out["write_wait_s"] = time.perf_counter() - t0
    A.set_mesh(None)
    A.set_param_specs(None)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hist = launch_train.main(list(SHARD_LAUNCH) + ["--device", dev.type,
                                                   "--ckpt-dir", launch_dir])
    out["launcher"] = {"losses": [h["loss"] for h in hist],
                       "s": time.perf_counter() - t0}
    return out


def restore_digests(torch, dev, sizes, ckpt):
    """18a's checkpoint restored on a mesh of ``sizes`` by its own specs:
    the digests of the params gathered back (rank 0's), and the step."""
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = R.get_arch(ARCH)
    mesh = HostMesh(sizes).bind()
    specs = rules.param_specs(cfg, mesh)
    template = {k: torch.empty(0, device=dev) for k in T.schema(cfg)}
    (params, _), step = CheckpointManager(ckpt, mesh=mesh).restore(
        (template, None), SHARD_SAVE_AT, mesh=mesh, specs=(specs, None))
    whole = rules.gather_params(cfg, mesh, params, specs)
    return step, ({k: leaf_digest(v) for k, v in whole.items()}
                  if mesh.index(mesh.axis_names) == 0 else None)


def phase18_serve_rank(rank, world, dev, *, sizes, prompt, ckpt):
    """One rank of 18b, after restoring 18a's checkpoint on this (1, 2)
    mesh (``restore_digests``): qwen3-moe-30b-a3b drawn as this rank's
    slices of phase 14's weights (the serving layout: experts and vocab
    split over model), make_prefill_step on the (1, 4096) prompt with
    kernel 3 twice (counted, timed), then once more recording the routed
    sets and timing the all-reduces."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import serve as launch
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import moe
    from repro_torch.models import registry as R
    from repro_torch.sharding import activation as A
    from repro_torch.sharding import rules

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    out["restored"] = restore_digests(torch, dev, sizes, ckpt)
    torch.cuda.empty_cache()
    cfg = R.get_arch(MOE_ARCH)
    kcfg = cfg.with_(use_flash_kernel=True)
    specs = rules.param_specs(cfg, HostMesh(sizes), serving=True)
    mesh = HostMesh(sizes).bind()
    A.set_mesh(mesh)
    A.set_param_specs(specs)
    out["index"] = mesh.index("model")
    with torch.inference_mode():
        t0 = time.perf_counter()
        w = launch.init_weights(cfg, seed=0, device=dev, compute_dtype=True,
                                mesh=mesh, specs=specs)
        torch.cuda.synchronize()
        out["draw_s"] = time.perf_counter() - t0
        out["bytes"] = sum(x.numel() * x.element_size() for x in w.values())
        out["sums"] = {k: leaf_checksum(torch, x) for k, x in w.items()}
        tokens = prompt.to(dev)
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for i in range(2):
            dist.barrier()
            torch.cuda.synchronize()
            k3.launches = 0
            t0 = time.perf_counter()
            logits, cache = launch.run_prefill(kcfg, w, tokens)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                out["launches"] = k3.launches
            del cache
        out["prefill_ms"] = ms
        out["logits"] = logits.float().cpu()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        routes, route = [], moe.route
        reduce_ms, all_reduce = [], dist.all_reduce

        def recording(c, lg):
            gates, experts = route(c, lg)
            routes.append(torch.sort(experts, dim=-1).values.to(torch.uint8))
            return gates, experts

        def timed(t, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = all_reduce(t, *a, **kw)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
            return res

        moe.route, dist.all_reduce = recording, timed
        try:
            k3.launches = 0
            launch.run_prefill(kcfg, w, tokens)
        finally:
            moe.route, dist.all_reduce = route, all_reduce
        out["routes"] = torch.stack(routes).cpu()
        out["reduce_ms"] = reduce_ms
    return out


def phase18_sharded(torch, dev, card, moe_ref: dict) -> dict:
    """Phase 18: 18a training qwen3-0.6b in a (2, 2) gloo world against one
    process, its checkpoint restored in one process and in a (1, 2) world,
    remesh, the launcher's --model-parallel 2; 18b qwen3-moe-30b-a3b's
    prefill in a (1, 2) world against phase 14a."""
    import tempfile

    import numpy as np
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import serve as launch
    from repro_torch.launch import world
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers as O
    from repro_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    out, sub = {}, {}
    cfg = R.get_arch(ARCH)
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-shard-"))
    try:
        # -- 18a: one process, then the (2, 2) world ---------------------
        t_sub = time.perf_counter()
        data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=0)
        batches = [data.batch(i) for i in range(SHARD_STEPS)]
        params = launch.init_weights(cfg, seed=0, device=dev)
        adam = O.adamw(TRAIN_LR)
        captured = {}

        def update(grads, state, p):
            captured.setdefault("grads", grads)
            return adam.update(grads, state, p)

        step = R.make_train_step(cfg, O.Optimizer(adam.init, update),
                                 micro_batches=SHARD_MICRO)
        opt = step.init_opt(params)
        one_bytes = tree_bytes((params, opt["m"], opt["v"]))
        one_losses, one_ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, b)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
            one_losses.append(float(met["loss"]))
        torch.save({k: g.cpu() for k, g in captured["grads"].items()},
                   tmp / "one_grads.pt")
        del params, opt, step, captured
        launch_losses, launch_params = launcher_one_process(torch, cfg, dev)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = world.run_world(
            "chip_smoke:phase18_train_rank", math.prod(SHARD_TRAIN_WORLD),
            kwargs={"sizes": SHARD_TRAIN_WORLD, "batches": batches,
                    "ckpt": str(tmp / "world"), "launch_dir": str(tmp / "launch"),
                    "one_grads": str(tmp / "one_grads.pt")},
            backend="gloo", device="cuda", timeout=SHARD_TIMEOUT)
        t_world = time.perf_counter() - t0
        r0 = ranks[0]
        losses = r0["losses"]
        check(all(r["losses"] == losses for r in ranks),
              "18a: the ranks' losses differ")
        loss_ok = abs(losses[0] - one_losses[0]) <= SHARD_LOSS_RTOL * abs(one_losses[0])
        worst_k = max(r0["grad_rel"], key=r0["grad_rel"].get)
        worst = r0["grad_rel"][worst_k]
        print(f"[shard] 18a {ARCH} at full width and depth ({cfg.n_layers} layers, "
              f"f32 masters, AdamW, SyntheticLM seq {TRAIN_SEQ} x global batch "
              f"{TRAIN_BATCH}, micro_batches={SHARD_MICRO}) in a (data "
              f"{SHARD_TRAIN_WORLD[0]} x model {SHARD_TRAIN_WORLD[1]}) gloo world on "
              f"the one card, {t_world:.1f} s with start-up: step-1 loss {losses[0]:.6f} "
              f"vs one process {one_losses[0]:.6f} (rtol {SHARD_LOSS_RTOL}); "
              f"gradients max-norm relative worst {worst:.3e} at {worst_k} "
              f"(<= {SHARD_GRAD_REL}) [{card}]")
        print(f"[shard] 18a losses, world / one process: "
              + "; ".join(f"step {i + 1} {a:.6f} / {b:.6f}"
                          for i, (a, b) in enumerate(zip(losses, one_losses)))
              + f" [{card}]")
        print(f"[shard] 18a a rank's masters + AdamW m, v: "
              f"{[round(r['state_bytes'] / 1e9, 3) for r in ranks]} GB (one "
              f"process {one_bytes / 1e9:.3f} GB); step ms, world (rank 0) "
              f"{[round(x, 1) for x in r0['step_ms']]} vs one process "
              f"{[round(x, 1) for x in one_ms]}; bytes a rank hands to "
              f"collectives a step {[round(x / 1e9, 3) for x in r0['sent']]} GB; "
              f"draw {r0['draw_s']:.1f} s; peak {[round(r['peak_gib'], 2) for r in ranks]} "
              f"GiB [{card}]")
        check(loss_ok, "18a: the world's step-1 loss is off the one-process loss")
        check(worst <= SHARD_GRAD_REL, f"18a: gradient {worst_k} off by {worst:.3e}")
        check(all(np.isfinite(x) for x in losses), "18a: losses not finite")

        # the world's checkpoint, in one process and in a (1, 2) world
        template = {k: torch.empty(0) for k in T.schema(cfg)}
        t0 = time.perf_counter()
        (restored, _), step_no = CheckpointManager(tmp / "world").restore(
            (template, None), SHARD_SAVE_AT)
        one_digests = {k: leaf_digest(v) for k, v in restored.items()}
        t_restore = time.perf_counter() - t0
        del restored
        same_one = one_digests == r0["saved"]
        print(f"[shard] 18a checkpoint at step {SHARD_SAVE_AT}: each rank's slices sent "
              f"to rank 0's host in {r0['save_s']:.1f} s, written by its writer thread "
              f"beside step 3 and remesh ({r0['write_wait_s']:.1f} s more to wait), "
              f"{dir_bytes(tmp / 'world') / 2**30:.2f} GiB; "
              f"restored in one process ({t_restore:.1f} s) bit for bit "
              f"{same_one}; remesh onto ranks 0-1 and back onto 4, each leaf "
              f"bit for bit {[r.get('small') for r in ranks[:2]]}, "
              f"{[r['big'] for r in ranks]} ({r0['remesh_s']:.1f} s) [{card}]")
        check(step_no == SHARD_SAVE_AT and same_one,
              "18a: the one-process restore differs from the world's params")
        check(all(r["small"] for r in ranks[:2]) and all(r["big"] for r in ranks),
              "18a: remesh changed a leaf")
        lh = [r["launcher"]["losses"] for r in ranks]
        check(all(x == lh[0] for x in lh) and len(lh[0]) == LAUNCH_STEPS
              and all(np.isfinite(x) for x in lh[0]), "18a: the launcher's run")
        check((tmp / "launch" / f"step_{LAUNCH_STEPS}").exists(),
              "18a: no launcher checkpoint")
        t0 = time.perf_counter()
        (got, _), _ = CheckpointManager(tmp / "launch").restore(
            ({k: torch.empty(0, device=dev) for k in T.schema(cfg)}, None),
            LAUNCH_STEPS)
        drift = max((got[k] - launch_params[k].to(dev)).abs().max().item()
                    for k in got)
        t_restore = time.perf_counter() - t0
        del got, launch_params
        launch_ok = (abs(lh[0][0] - launch_losses[0])
                     <= SHARD_LOSS_RTOL * abs(launch_losses[0]))
        print(f"[shard] 18a launch.train.main({' '.join(SHARD_LAUNCH)}) in the "
              f"world: {r0['launcher']['s']:.1f} s, losses "
              + "; ".join(f"step {i + 1} {a:.6f} / one process {b:.6f}"
                          for i, (a, b) in enumerate(zip(lh[0], launch_losses)))
              + f" (step 1 rtol {SHARD_LOSS_RTOL}); its step-{LAUNCH_STEPS} "
              f"checkpoint restored in one process ({t_restore:.1f} s), max "
              f"|world - one process| {drift:.3e} (<= {LAUNCH_DRIFT:.3e}, AdamW's "
              f"drift) [{card}]")
        check(launch_ok, "18a: the launcher's step-1 loss is off one process's")
        check(drift <= LAUNCH_DRIFT, "18a: the launcher's checkpoint is off one "
              "process's params")
        out["18a"] = {"losses": losses, "one_losses": one_losses,
                      "launcher_losses": lh[0], "launcher_one": launch_losses,
                      "launcher_drift": drift,
                      "grad_rel": worst, "step_ms": r0["step_ms"],
                      "one_step_ms": one_ms, "sent": r0["sent"],
                      "state_bytes": [r["state_bytes"] for r in ranks],
                      "one_state_bytes": one_bytes, "world_s": t_world}
        sub["18a"] = time.perf_counter() - t_sub

        # -- 18b: qwen3-moe's prefill in a (1, 2) world ------------------
        t_sub = time.perf_counter()
        mcfg = R.get_arch(MOE_ARCH)
        t0 = time.perf_counter()
        ranks = world.run_world(
            "chip_smoke:phase18_serve_rank", math.prod(SHARD_SERVE_WORLD),
            kwargs={"sizes": SHARD_SERVE_WORLD, "prompt": moe_ref["prompt"],
                    "ckpt": str(tmp / "world")},
            backend="gloo", device="cuda", timeout=SHARD_TIMEOUT)
        t_world = time.perf_counter() - t0
        ranks.sort(key=lambda r: r["index"])
        step_no, digests = ranks[0]["restored"]
        print(f"[shard] 18a's checkpoint restored in the (1, 2) world by its own "
              f"specs (before 18b): bit for bit {digests == r0['saved']} [{card}]")
        check(step_no == SHARD_SAVE_AT and digests == r0["saved"],
              "18a: the (1, 2) world's restore differs from the world's params")
        sums_ok = [r["sums"] == moe_ref["sums"][r["index"]] for r in ranks]
        launches = [r["launches"] for r in ranks]
        want = moe_ref["logits"].to(dev)
        got = ranks[0]["logits"].to(dev)
        same = all(torch.equal(r["logits"], ranks[0]["logits"]) for r in ranks)
        ok, msg = logits_agree(torch, got, want, "bfloat16", 5e-2)
        alike = (ranks[0]["routes"] == moe_ref["routes"]).all(dim=-1)
        red = ranks[0]["reduce_ms"]
        print(f"[shard] 18b {MOE_ARCH} at full width and depth in a (data 1 x model "
              f"2) gloo world: {mcfg.moe.num_experts // 2} experts and half the vocab "
              f"a rank, attention replicated, kernel 3 on; each rank's weights "
              f"{[round(r['bytes'] / 1e9, 2) for r in ranks]} GB, drawn as its "
              f"slices of phase 14's in {[round(r['draw_s'], 1) for r in ranks]} s, "
              f"checksums equal phase 14's {sums_ok}; {t_world:.1f} s with "
              f"start-up [{card}]")
        print(f"[shard] 18b (1, {MOE_PREFILL_SEQ}) make_prefill_step: kernel 3 "
              f"launches {launches} a rank; ms first / second call "
              f"{[[round(x, 1) for x in r['prefill_ms']] for r in ranks]}; peak "
              f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; all-reduces "
              f"{len(red)} a prefill ({mcfg.n_layers} combines + the embedding), "
              f"{sum(red):.1f} ms in all (synchronized, third call); routed sets "
              f"alike phase 14a's {100 * alike.float().mean().item():.3f} % "
              f"({int((~alike).sum())} of {alike.numel()}); logits the same on "
              f"every rank {same}; vs 14a's kernel-path logits: {msg} [{card}]")
        check(all(sums_ok), "18b: a rank's weights are not its slice of phase 14's")
        check(launches == [mcfg.n_layers] * len(ranks),
              f"18b: kernel 3 launches {launches} != {mcfg.n_layers} a rank")
        check(same and bool(torch.isfinite(got).all()), "18b: the ranks' logits")
        check(ok, "18b: the world's logits disagree with phase 14a's")
        out["18b"] = {"launches": launches, "prefill_ms": [r["prefill_ms"] for r in ranks],
                      "peak_gib": [r["peak_gib"] for r in ranks],
                      "reduce_ms": sum(red), "alike": alike.float().mean().item(),
                      "world_s": t_world}
        sub["18b"] = time.perf_counter() - t_sub
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[shard] phase 18 took {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sub.items()) + ")")
    check(out["seconds"] <= PHASE18_LIMIT_S,
          f"phase 18 took {out['seconds']:.1f} s > {PHASE18_LIMIT_S} s")
    return out


# Phase 19: the cell machinery and the dry run.  19a: every arch's smoke
# config through materialize_inputs + step_for (tests/test_arch_smoke.py's
# shapes and gates); 19b: the dry run of qwen3-0.6b's (1, 4096) prefill on a
# (1, 1) mesh held against the same step on the card; 19c: the dry run's CLI
# on two production cells (started in the background before phase 17, since
# command-r-plus-104b's train cell traces for about two minutes on one host
# core) and compression_dryrun.
CELL_TRAIN, CELL_PREFILL, CELL_DECODE = (32, 2), (32, 2), (16, 2)   # (seq, batch)
CELL_LR, CELL_LOSS_STEPS, CELL_LOSS_LR = 1e-3, 5, 3e-3
CELL_DECODE_TOL, CELL_DECODE_CORR = 0.15, 0.99   # tests/test_arch_smoke.py
DRY_PREFILL = (4096, 1)                          # 19b: (seq, batch)
DRY_FLOPS_REL, DRY_PEAK_REL = 0.01, 0.15
DRY_CLI_CELLS = (("xlstm-350m", "decode_32k"), ("command-r-plus-104b", "train_4k"))
DRY_CLI_TIMEOUT = 300.0
DRY_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
PHASE19_LIMIT_S = 120.0


class DryRunCells:
    """19c's dry-run CLI calls, one subprocess a cell, started together in
    the background; ``collect`` waits for them (each within
    ``DRY_CLI_TIMEOUT`` of its start) and ``stop`` kills any still
    running.  A cell's wall runs from the start to its row file's write,
    the process's last act."""

    def __init__(self):
        import os
        import tempfile
        self.dir = Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_TORCH_DRYRUN_DIR=str(self.dir))
        self.procs = {}
        for arch, shape in DRY_CLI_CELLS:
            log = open(self.dir / f"{arch}__{shape}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", "single"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
            self.procs[(arch, shape)] = (proc, log, time.time())

    def collect(self) -> dict:
        out = {}
        for (arch, shape), (proc, log, t0) in self.procs.items():
            left = max(1.0, DRY_CLI_TIMEOUT - (time.time() - t0))
            try:
                rc = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                rc = None
            log.close()
            text = (self.dir / f"{arch}__{shape}.log").read_text()
            check(rc == 0, f"19c: dryrun {arch} x {shape} "
                  f"{'timed out' if rc is None else f'exited {rc}'} after "
                  f"{time.time() - t0:.1f} s: {text[-2000:]}")
            path = self.dir / f"{arch}__{shape}__16x16.json"
            out[(arch, shape)] = {"row": json.loads(path.read_text()),
                                  "wall_s": path.stat().st_mtime - t0}
        return out

    def stop(self) -> None:
        import shutil
        for proc, log, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def cell_shape(kind: str, seq_batch):
    from repro_torch.configs.base import ShapeCfg
    return ShapeCfg(f"smoke_{kind}", kind, seq_batch[0], seq_batch[1])


def phase19_cells(torch, dev, card, dry_cli: DryRunCells) -> dict:
    """Phase 19: (19a) every arch's SMOKE through materialize_inputs +
    step_for on the card; (19b) the dry run against the card on
    qwen3-0.6b's (1, 4096) prefill, then that prefill through kernel 3;
    (19c) the dry run's CLI rows and compression_dryrun."""
    t_phase = time.perf_counter()
    out = {"19a": phase19a_smoke(torch, dev, card)}
    out["19b"] = phase19b_dryrun_vs_card(torch, dev, card)
    out["19c"] = phase19c_cli(torch, card, dry_cli)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[cells] phase 19 took {out['seconds']:.1f} s (19a "
          f"{out['19a']['seconds']:.1f} s, 19b {out['19b']['seconds']:.1f} s, "
          f"19c {out['19c']['seconds']:.1f} s waiting)")
    check(out["seconds"] <= PHASE19_LIMIT_S,
          f"phase 19 took {out['seconds']:.1f} s > {PHASE19_LIMIT_S} s")
    return out


def phase19a_smoke(torch, dev, card) -> dict:
    """tests/test_arch_smoke.py on the card, through the registry's cell
    machinery: for every arch's SMOKE config (bf16 activations), one train
    step (finite loss, params moved), five at lr 3e-3 (loss down), a prefill
    with use_flash_kernel (kernel 3 where the layer routes to it) against
    the plain one at the bf16 gate, a decode step, and prefill + one decode
    against the full forward (0.15, correlation > 0.99)."""
    import importlib
    import pkgutil

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.models import cache as C
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    train, prefill, decode = (cell_shape("train", CELL_TRAIN),
                              cell_shape("prefill", CELL_PREFILL),
                              cell_shape("decode", CELL_DECODE))
    launches, rows = 0, {}
    modules = [importlib.import_module(f"repro_torch.configs.{m.name}")
               for m in pkgutil.iter_modules(configs.__path__)]
    by_arch = {m.CONFIG.name: m for m in modules if hasattr(m, "SMOKE")}
    check(sorted(by_arch) == sorted(R.ARCHS),
          f"19a: configs/<arch>.py modules {sorted(by_arch)}")
    for arch in sorted(R.ARCHS):
        mod = by_arch[arch]
        cfg = mod.SMOKE
        check(mod.CONFIG is R.get_arch(arch), f"19a: configs module of {arch}")
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        # one train step
        batch = R.materialize_inputs(cfg, train, 1)
        step = R.step_for(cfg, train, lr=CELL_LR)
        p2, _, m = step(params, step.init_opt(params), batch)
        loss = float(m["loss"])
        moved = any(bool((p2[k] != params[k]).any()) for k in params)
        check(math.isfinite(loss) and loss > 0 and math.isfinite(float(m["grad_norm"]))
              and moved, f"19a {arch}: train step loss {loss}, moved {moved}")
        # the loss goes down over five steps
        batch = R.materialize_inputs(cfg, train, 2)
        step = R.step_for(cfg, train, lr=CELL_LOSS_LR)
        p, opt, losses = params, step.init_opt(params), []
        for _ in range(CELL_LOSS_STEPS):
            p, opt, m = step(p, opt, batch)
            losses.append(float(m["loss"]))
        check(losses[-1] < losses[0], f"19a {arch}: losses {losses}")
        del p, opt, p2
        with torch.no_grad():
            # prefill: kernel 3 where the layer routes to it, against plain
            batch = R.materialize_inputs(cfg, prefill, 3)
            kcfg = cfg.with_(use_flash_kernel=True)
            routed = sum(1 for sp in cfg.layer_specs() if sp.mixer == "attn"
                         and sp.window is None and cfg.attn_softcap == 0.0)
            k3.launches = 0
            got, _ = R.step_for(kcfg, prefill)(params, batch)
            torch.cuda.synchronize()
            n = k3.launches
            launches += n
            want, _ = R.step_for(cfg, prefill)(params, batch)
            ok, msg = logits_agree(torch, got, want, "bfloat16", SERVE_TOL)
            check(tuple(got.shape) == (prefill.global_batch, cfg.vocab)
                  and bool(torch.isfinite(got).all()) and ok and n == routed,
                  f"19a {arch}: prefill kernel 3 launches {n} (want {routed}), {msg}")
            # a decode step on a random cache
            batch = R.materialize_inputs(cfg, decode, 4)
            cache_shapes = [tuple(t.shape) for t in tree_tensors(batch["cache"])]
            logits, cache = R.step_for(cfg, decode)(params, batch)
            check(tuple(logits.shape) == (decode.global_batch, cfg.vocab)
                  and bool(torch.isfinite(logits).all())
                  and [tuple(t.shape) for t in tree_tensors(cache)] == cache_shapes,
                  f"19a {arch}: decode step")
            # prefill S then one decode step against a full forward over S + 1
            b, s = decode.global_batch, decode.seq_len
            gen = torch.Generator(device=dev).manual_seed(5)
            tok = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                                device=dev, dtype=torch.int32)
            extra = {}
            if cfg.vlm:
                extra["img_embeds"] = 0.01 * torch.randn(
                    (b, cfg.vlm.num_image_tokens, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
            if cfg.encdec:
                extra["enc_embeds"] = 0.01 * torch.randn(
                    (b, cfg.encdec.enc_seq, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
            cast = T.cast_params_for_compute(cfg, params)
            full = R._final_logits(cfg, T.forward(cfg, cast, tok, **extra).logits[:, -1])
            _, pcache = R.make_prefill_step(cfg)(params, {"tokens": tok[:, :s], **extra})
            n_img = cfg.vlm.num_image_tokens if cfg.vlm else 0
            dec, _ = R.make_serve_step(cfg)(params, {
                "tokens": tok[:, s:], "cache": C.grow_cache(pcache, 1, cfg),
                "write_pos": s + n_img})
            diff = (dec - full).abs().max().item()
            corr = torch.corrcoef(torch.stack([dec.ravel(), full.ravel()]))[0, 1].item()
            check(bool(torch.allclose(dec, full, rtol=CELL_DECODE_TOL,
                                      atol=CELL_DECODE_TOL))
                  and corr > CELL_DECODE_CORR,
                  f"19a {arch}: prefill + decode vs full forward max|d| {diff:.3e} "
                  f"corr {corr:.5f}")
        rows[arch] = {"loss": loss, "losses": losses, "launches": n,
                      "decode_max_abs": diff, "decode_corr": corr}
        print(f"[cells] 19a {arch} SMOKE ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}): train loss {loss:.4f}, 5 steps at lr "
              f"{CELL_LOSS_LR} {losses[0]:.4f} -> {losses[-1]:.4f}; prefill "
              f"kernel 3 launches {n} vs plain: {msg}; decode {tuple(logits.shape)}; "
              f"prefill + decode vs full forward max|d| {diff:.3e} corr "
              f"{corr:.5f} [{card}]")
        del params, cast, pcache
    out = {"archs": rows, "launches": launches,
           "seconds": time.perf_counter() - t0}
    print(f"[cells] 19a: {len(rows)} archs, kernel 3 launches {launches} in "
          f"the prefills; {out['seconds']:.1f} s")
    return out


def profiler_matmul_flops(torch, fn) -> float:
    """The FLOPs torch.profiler's with_flops gives the matrix products of
    one call of ``fn`` (its elementwise aten::mul / aten::add counts left
    out: the dry run counts products)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        fn()
        torch.cuda.synchronize()
    return float(sum(e.flops for e in prof.key_averages() if e.key in DRY_MATMULS))


def phase19b_dryrun_vs_card(torch, dev, card) -> dict:
    """qwen3-0.6b at full width and depth, prefill of (1, 4096): the dry
    run on a (1, 1) mesh, then the same step on the card on the plain
    path.  The dry run's argument bytes equal the bytes of the weights and
    inputs the card holds and the growth of the caching allocator's
    requested bytes from placing them; memory_allocated() counts the
    allocator's blocks, which round a large tensor up to its 2 MiB segment
    where less than 1 MiB would be left over (the 593.5 MiB f32 embedding
    takes a 594 MiB block), so its growth is held between the bytes and
    the bytes plus 1 MiB a tensor.  Its matmul FLOPs are within 1 % of the
    profiler's; its peak (arguments + the step's own live bytes) within
    15 % of max_memory_allocated()'s growth.  Then the prefill with kernel
    3 (a launch a layer) at the bf16 gate against the plain one."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = R.get_arch(ARCH)
    shape = cell_shape("prefill", DRY_PREFILL)
    dry = DR.run_cell(cfg, shape, HostMesh((1, 1)), probe=False)
    mem = dry["memory"]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    asked = torch.cuda.memory_stats()["requested_bytes.all.current"]
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = R.materialize_inputs(cfg, shape, 0)
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - base
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"] - asked
    leaves = list(params.values()) + tree_tensors(batch)
    raw = sum(t.numel() * t.element_size() for t in leaves)
    step = R.step_for(cfg, shape)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        want, cache = step(params, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del cache
        t_plain = median_ms(torch, lambda: step(params, batch))
        prof_flops = profiler_matmul_flops(torch, lambda: step(params, batch))
        kstep = R.step_for(cfg.with_(use_flash_kernel=True), shape)
        k3.launches = 0
        got, _ = kstep(params, batch)
        torch.cuda.synchronize()
        launches = k3.launches
        t_kernel = median_ms(torch, lambda: kstep(params, batch))
    ok, msg = logits_agree(torch, got, want, "bfloat16", SERVE_TOL)
    flops_rel = abs(dry["flops"] - prof_flops) / prof_flops
    peak_rel = abs(mem["peak_bytes"] - peak) / peak
    print(f"[cells] 19b dry run {ARCH} prefill {DRY_PREFILL[1]} x "
          f"{DRY_PREFILL[0]} on a (1, 1) mesh: traced in {dry['lower_s']} s; "
          f"argument bytes {mem['argument_bytes']} (params "
          f"{mem['arguments']['params']}, inputs {mem['arguments']['inputs']}) "
          f"vs the card's tensors {raw} B, the allocator's requested bytes' "
          f"growth {requested} B, memory_allocated() growth {placed} B "
          f"(blocks); matmul FLOPs {dry['flops']:.6e} "
          f"vs profiler {prof_flops:.6e} (rel {flops_rel:.2e}); peak "
          f"{mem['peak_bytes'] / 2**30:.3f} GiB (argument "
          f"{mem['argument_bytes'] / 2**30:.3f} + temp "
          f"{mem['temp_bytes'] / 2**30:.3f} + output "
          f"{(mem['output_bytes'] - mem['alias_bytes']) / 2**30:.3f}) vs "
          f"max_memory_allocated() growth {peak / 2**30:.3f} GiB (rel "
          f"{peak_rel:.3f}); op bytes {dry['bytes']:.4e} [{card}]")
    print(f"[cells] 19b the same prefill with kernel 3: launches {launches}, "
          f"{t_kernel:.3f} ms vs plain {t_plain:.3f} ms (median of {REPS}); "
          f"logits vs plain: {msg} [{card}]")
    check(mem["argument_bytes"] == raw == requested
          and raw <= placed <= raw + len(leaves) * 2**20,
          f"19b: argument bytes {mem['argument_bytes']} vs card {raw}, "
          f"requested {requested}, blocks {placed}")
    check(flops_rel <= DRY_FLOPS_REL, f"19b: FLOPs off by {flops_rel:.3e}")
    check(peak_rel <= DRY_PEAK_REL, f"19b: peak off by {peak_rel:.3f}")
    check(launches == cfg.n_layers, f"19b: kernel 3 launches {launches}")
    check(ok, f"19b: kernel 3 logits vs plain: {msg}")
    del params, batch, got, want
    return {"dry": {k: dry[k] for k in ("flops", "bytes", "memory", "lower_s")},
            "card": {"tensor_bytes": raw, "requested_bytes": requested,
                     "placed_bytes": placed, "peak_bytes": peak,
                     "profiler_flops": prof_flops, "plain_ms": t_plain,
                     "kernel_ms": t_kernel},
            "flops_rel": flops_rel, "peak_rel": peak_rel, "launches": launches,
            "seconds": time.perf_counter() - t0}


def phase19c_cli(torch, card, dry_cli: DryRunCells) -> dict:
    """The dry run's CLI rows of DRY_CLI_CELLS (the schema
    tests/test_dryrun_cell.py asserts; the fit against one H100's 80 GB a
    rank printed, not asserted) and compression_dryrun's ratio."""
    from repro_torch.launch import compression_dryrun
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import HBM_BYTES

    t0 = time.perf_counter()
    cells = dry_cli.collect()
    waited = time.perf_counter() - t0
    out = {}
    for (arch, shape), got in cells.items():
        row, mem = got["row"], got["row"]["memory"]
        coll = row["collective_bytes"]
        fits = mem["peak_bytes"] <= HBM_BYTES
        print(f"[cells] 19c dryrun {arch} x {shape} x 16x16 ({row['devices']} "
              f"ranks, micro_batches {row['micro_batches']}): flops "
              f"{row['flops']:.4e} a rank, probe {row['probe'].get('global_flops', 0):.4e}; "
              f"collective bytes " + ", ".join(f"{k} {v:.4e}" for k, v in coll.items())
              + f"; argument {mem['argument_bytes'] / 1e9:.3f} GB, temp "
              f"{mem['temp_bytes'] / 1e9:.3f} GB, peak {mem['peak_bytes'] / 1e9:.3f} "
              f"GB a rank against {HBM_BYTES / 1e9:.0f} GB: "
              f"{'fits' if fits else 'does not fit'}; traced {row['lower_s']} s, "
              f"process wall {got['wall_s']:.1f} s [{card}]")
        check(row["devices"] == 256 and row["flops"] and row["flops"] > 0
              and row["probe"].get("global_flops", 0) > 0
              and set(coll) == set(DR.COLLECTIVES)
              and mem["argument_bytes"] > 0, f"19c: {arch} x {shape} row schema")
        out[f"{arch} x {shape}"] = {
            "flops": row["flops"], "probe_flops": row["probe"]["global_flops"],
            "collective_bytes": coll, "memory": mem, "fits_80gb": fits,
            "lower_s": row["lower_s"], "wall_s": got["wall_s"]}
    rows = compression_dryrun.main()
    ratio = rows[0][1] / rows[1][1]
    check(ratio == 128, f"19c: compression wire ratio {ratio} != 128")
    out["compression_ratio"] = ratio
    out["seconds"] = waited
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import os
    import shutil
    import tempfile
    tune_dir = tempfile.mkdtemp(prefix="chip-smoke-autotune-")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tune_dir, "autotune.json")
    try:
        return run(torch)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run(torch) -> int:
    from repro_torch import main_path
    from repro_torch.configs.paper_randnla import PAPER_HOSVD, PAPER_RSVD
    from repro_torch.convert import key_from_seed
    from repro_torch.core import hosvd, projection as proj, rsvd
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import shgemm as k1
    from repro_torch.kernels import shgemm_fused as k2

    dev = torch.device("cuda")
    bf16, fp16 = torch.bfloat16, torch.float16

    # -- 1. setup ---------------------------------------------------------
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[setup] built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
          f"into {_build.BUILD_DIR.relative_to(ROOT)}")
    for name, log in logs.items():
        for kernel, usage in ptxas_usage(log):
            print(f"[setup] ptxas {name} {kernel}: {usage}")

    gen = torch.Generator(device=dev).manual_seed(1234)
    key = key_from_seed(7)

    def operand_a(m, k):
        return torch.randn((m, k), generator=gen, device=dev) / math.sqrt(k)

    shapes = {"rsvd": RSVD_SHAPE, "hosvd": HOSVD_SHAPE}
    a_by_shape = {s: operand_a(m, k) for s, (m, k, n) in shapes.items()}
    results = {}

    # -- 2. kernels vs plain versions --------------------------------------
    for sname, (m, k, n) in shapes.items():
        a = a_by_shape[sname]
        b32 = torch.randn((k, n), generator=gen, device=dev)
        for dt in (bf16, fp16):
            b = b32.to(dt)
            for terms in (1, 2, 3):
                if terms == 3 and dt == fp16:
                    continue
                c = ops.shgemm(a, b, terms=terms)
                plain = k1.shgemm_plain(a, b, terms)
                torch.cuda.synchronize()
                err = (c - plain).abs().max().item()
                print(f"[kernels] shgemm {sname} {tuple(a.shape)}@{tuple(b.shape)} "
                      f"{str(dt)[6:]} terms={terms}: max|kernel-plain| {err:.3e}")
                check(torch.allclose(c, plain, rtol=1e-5, atol=1e-4),
                      f"shgemm {sname} {dt} terms={terms} disagrees with plain")
                results[("shgemm", sname, dt, terms)] = err
        bk = ops.shgemm_plan(m, n, k)[2]
        for dist in k2.SKETCH_DISTS:
            for dt in (bf16, fp16):
                kw = dict(dist=dist, omega_dtype=dt, row_offset=2 * bk,
                          col_offset=7)
                c = ops.shgemm_fused(a, key, n, **kw)
                plain = k2.shgemm_fused_plain(
                    a, key, n, dist=dist, s=k2._resolve_s(dist, None, k),
                    lowp_dtype=dt, row_offset=2 * bk, col_offset=7)
                torch.cuda.synchronize()
                err = (c - plain).abs().max().item()
                print(f"[kernels] shgemm_fused {sname} {tuple(a.shape)} n={n} "
                      f"{dist} {str(dt)[6:]} offsets=({2 * bk},7): "
                      f"max|kernel-plain| {err:.3e}")
                check(torch.allclose(c, plain, rtol=1e-5, atol=1e-4),
                      f"shgemm_fused {sname} {dist} {dt} disagrees with plain")
                results[("shgemm_fused", sname, dt, dist)] = err

    # Omega bit check: with A = I every split and product is exact, so the
    # kernel returns its own on-chip Omega.  HOSVD's 65536 rows are checked
    # on their last 4096 through row_offset.
    for sname, (m, k, n) in shapes.items():
        kk = min(k, 4096)
        eye = torch.eye(kk, device=dev)
        r0 = k - kk
        for dist in k2.SKETCH_DISTS:
            s = k2._resolve_s(dist, None, k)
            for dt in (bf16, fp16):
                got = ops.shgemm_fused(eye, key, n, dist=dist, omega_dtype=dt,
                                       s=s, row_offset=r0, blocks=(128, 64, 256))
                want = k2.reference_omega(key, (kk, n), dist=dist, s=s,
                                          dtype=dt, row_offset=r0,
                                          device=dev).float()
                diff = (got - want).abs()
                nbad = int((diff > 0).sum())
                if dist == "gaussian":
                    ok = bool((diff <= lowp_ulp(torch, want, dt)).all())
                else:
                    ok = nbad == 0
                print(f"[omega] {sname} {dist} {str(dt)[6:]} rows {r0}..{k}: "
                      f"{nbad} of {want.numel()} differ, max {diff.max().item():.3e}")
                check(ok, f"on-chip Omega {sname} {dist} {dt} off the lattice")

    # Bit identity across block shapes that share bk, and fused ==
    # shgemm(fused_omega) at equal blocks for the sparse dists.
    m, k, n = RSVD_SHAPE
    a = a_by_shape["rsvd"]
    omega = proj.fused_omega(key, (k, n), dist="gaussian", device=dev)
    same_bk = [(128, 64, 256), (64, 32, 256), (32, 64, 256)]
    outs = [ops.shgemm(a, omega, blocks=bl) for bl in same_bk]
    check(all(torch.equal(outs[0], o) for o in outs[1:]),
          "shgemm not bit-identical across blocks sharing bk")
    outs = [ops.shgemm_fused(a, key, n, blocks=bl) for bl in same_bk]
    check(all(torch.equal(outs[0], o) for o in outs[1:]),
          "shgemm_fused not bit-identical across blocks sharing bk")
    for dist in ("achlioptas", "very_sparse"):
        om = proj.fused_omega(key, (k, n), dist=dist, device=dev)
        check(torch.equal(ops.shgemm_fused(a, key, n, dist=dist, blocks=same_bk[0]),
                          ops.shgemm(a, om, blocks=same_bk[0])),
              f"fused != shgemm(fused_omega) for {dist}")
    print(f"[identity] bit-identical across blocks {same_bk}; "
          f"fused == shgemm(fused_omega) for achlioptas, very_sparse")

    # Kernel 2 == kernel 1 on kernel 2's own Omega (read back with A = I,
    # 4096 rows at a time), bit for bit, under the planner's split count and
    # under one split.  The two kernels share the main loop and differ in
    # their B producers; kernel 1 runs on 32 x 32 blocks with one split, so
    # one side stays on the loop's direct path, without the reduction.
    for sname, (m, k, n) in shapes.items():
        a = a_by_shape[sname]
        plan = ops.fused_plan(m, n, k)
        for dist in k2.SKETCH_DISTS:
            for dt in (bf16, fp16):
                kw = dict(dist=dist, omega_dtype=dt, s=k2._resolve_s(dist, None, k),
                          row_offset=2 * plan[2], col_offset=7)
                want = ops.shgemm(a, ops.chip_omega(key, k, n, **kw),
                                  blocks=(32, 32, plan[2]), splits=1)
                for splits in sorted({plan[3], 1}):
                    check(torch.equal(ops.shgemm_fused(a, key, n, splits=splits, **kw),
                                      want),
                          f"kernel 2 != kernel 1 on its own Omega: {sname} {dist} "
                          f"{dt} splits={splits}")
        print(f"[identity] {sname} {(m, k, n)}: kernel 2 under plan {plan} and "
              f"under splits=1 == kernel 1 (blocks (32, 32, {plan[2]}), one "
              f"split) on kernel "
              f"2's own Omega, bit for bit, for {list(k2.SKETCH_DISTS)} in bf16 "
              f"and fp16 (offsets ({2 * plan[2]}, 7))")

    # Bit identity across each kernel's (bm, bn, splits) sharing bk, each
    # timed: kernel 1 on a bf16 B, kernel 2 on its Gaussian Omega.
    for sname, (m, k, n) in shapes.items():
        a = a_by_shape[sname]
        b = torch.randn((k, n), generator=gen, device=dev).to(bf16)
        for label, planner, sweep, full in (
                ("kernel 1", ops.shgemm_plan, SHGEMM_PLANS,
                 lambda: ops.shgemm(a, b)),
                ("kernel 2", ops.fused_plan, FUSED_PLANS,
                 lambda: ops.shgemm_fused(a, key, n))):
            plan = planner(m, n, k)
            want = full()
            times = {}
            for bm, bn, splits in sweep[sname]:
                n_pad = n + (-n) % bn
                if label == "kernel 1":
                    b_pad = ops._pad_to(b, plan[2], bn)
                    call = (lambda bm=bm, bn=bn, splits=splits, b_pad=b_pad:
                            k1.shgemm_pallas(a, b_pad, bm=bm, bn=bn, bk=plan[2],
                                             splits=splits))
                else:
                    call = (lambda bm=bm, bn=bn, splits=splits, n_pad=n_pad:
                            k2.shgemm_fused_pallas(a, key, n_pad, bm=bm, bn=bn,
                                                   bk=plan[2], splits=splits))
                check(torch.equal(call()[:, :n], want),
                      f"{label} {sname} not bit-identical at {(bm, bn, splits)}")
                times[(bm, bn, splits)] = (median_ms(torch, call),
                                           device_ms(torch, call))
            best = min(times, key=lambda p: times[p][1][0] or times[p][0])
            print(f"[plans] {label} {sname} {(m, k, n)} "
                  f"{'bf16 B' if label == 'kernel 1' else 'gaussian bf16'}, "
                  f"(bm, bn, splits) at bk {plan[2]}, all bit-identical to the "
                  f"planner's {plan}; CUDA-event ms / device ms (kernel + "
                  f"reduction; launches the trace held / made): "
                  + "; ".join(f"{p} {t:.4f} / {fmt_dev(d)}" for p, (t, d) in times.items())
                  + f"; least device time {best} [{card}]")

    # Kernel 1's planner counts SHGEMM_PER_SM blocks of 128 x 32 an SM:
    # hold the table to the occupancy calculator on the built kernel.
    per_sm = {(str(dt)[6:], t): k1.blocks_per_sm(128, 32, t, dt)
              for dt in (bf16, fp16) for t in ((1, 2, 3) if dt == bf16 else (1, 2))}
    print(f"[plans] kernel 1 128 x 32 blocks an SM by (B type, terms), CUDA "
          f"occupancy calculator: {per_sm}; planner's table "
          f"{ops.SHGEMM_PER_SM} [{card}]")
    check(all(v == ops.SHGEMM_PER_SM[t] for (_, t), v in per_sm.items()),
          f"kernel 1 occupancy {per_sm} != the planner's {ops.SHGEMM_PER_SM}")

    # f64-oracle accuracy ladder (reference DESIGN.md §2).
    b32 = torch.randn((k, n), generator=gen, device=dev)
    for dt in (bf16, fp16):
        b = b32.to(dt)
        oracle = ref.sgemm_f64_oracle(a, b)
        errs = {t: ref.relative_error_fro(ops.shgemm(a, b, terms=t), oracle).item()
                for t in ((1, 2, 3) if dt == bf16 else (1, 2))}
        plain2 = ref.relative_error_fro(k1.shgemm_plain(a, b, 2), oracle).item()
        ef32 = ref.relative_error_fro(ref.dot_f32(a, b), oracle).item()
        print(f"[ladder] {str(dt)[6:]} rel. error vs f64 oracle: "
              + " ".join(f"terms={t} {e:.3e}" for t, e in errs.items())
              + f"; plain 2-term {plain2:.3e}; f32 matmul {ef32:.3e}")
        check(errs[2] < 1e-5, f"{dt} 2-term error {errs[2]} >= 1e-5")
        check(errs[1] > 100 * errs[2], f"{dt} 1-term not lossier than 2-term")
        if dt == bf16:
            check(errs[3] <= 2 * ef32, f"3-term error {errs[3]} > 2x f32 {ef32}")

    # -- 3. main path at paper size ----------------------------------------
    print(f"[main] rsvd n={PAPER_RSVD.n} rank={PAPER_RSVD.rank} "
          f"oversample={PAPER_RSVD.oversample}; hosvd dims={PAPER_HOSVD.dims} "
          f"ranks={PAPER_HOSVD.ranks}; A is {PAPER_RSVD.n ** 2 * 4 / 2**20:.0f} MiB "
          f"and the tensor {math.prod(PAPER_HOSVD.dims) * 4 / 2**20:.0f} MiB")
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.reductions = 0
    k2.launches = k2.reductions = 0
    errors = main_path.run_main_path(PAPER_RSVD, PAPER_HOSVD, device=dev)
    main_launches = {"shgemm": k1.launches, "shgemm_fused": k2.launches}
    main_reductions = {"shgemm": k1.reductions, "shgemm_fused": k2.reductions}
    for (algo, case, method), e in errors.items():
        print(f"[main] {algo} {case} {method}: rel. error {e:.4e}")
    print(f"[main] launches {main_launches} (of them with the split-K "
          f"reduction: {main_reductions}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    failures = main_path.check_errors(errors)
    check(not failures, "main path errors over the limits: " + "; ".join(failures))
    check(all(v > 0 for v in main_launches.values())
          and all(v > 0 for v in main_reductions.values()),
          f"a kernel of the path was never launched: {main_launches}, "
          f"reductions {main_reductions}")

    # -- 4. timings --------------------------------------------------------
    # Each kernel at rSVD's shape and RP-ST-HOSVD's three mode shapes (the
    # first is RP-HOSVD's) under the plan the main path launches there
    # (autotune.pick_blocks: the shipped cache, else the planner; the user
    # cache is empty), the planner's plan too where it differs, beside its
    # plain version, the f32 torch.matmul of the same product (library_ms,
    # also by device time) and its bound.
    from repro_torch.kernels import autotune
    records = {}
    per_shape = {"shgemm": [], "shgemm_fused": []}
    timed_shapes = {"rsvd": RSVD_SHAPE, "hosvd": STHOSVD_SHAPES[0]}
    timed_shapes.update({f"sthosvd_k{k}": (m, k, n) for m, k, n in STHOSVD_SHAPES[1:]})
    for sname, (m, k, n) in timed_shapes.items():
        a = a_by_shape.get(sname)
        a = operand_a(m, k) if a is None else a
        b = torch.randn((k, n), generator=gen, device=dev).to(bf16)
        omega32 = proj.fused_omega(key, (k, n), device=dev).float()
        for name, planner, omega_bytes in (("shgemm", ops.shgemm_plan, k * n * 2),
                                           ("shgemm_fused", ops.fused_plan, 0)):

            def kernel_at(plan, name=name, a=a, b=b):
                """The kernel's launch at ``plan``, its grid and workspace."""
                bm, bn, bk, splits = plan
                a_pad = ops._pad_to(a, bm, bk)
                n_pad = n + (-n) % bn
                wbytes = k1.workspace_bytes(a_pad.shape[0], n_pad, a_pad.shape[1],
                                            bk, splits)
                if name == "shgemm":
                    b_pad = ops._pad_to(b, bk, bn)
                    run = (lambda: k1.shgemm_pallas(a_pad, b_pad, bm=bm, bn=bn,
                                                    bk=bk, splits=splits))
                else:
                    run = (lambda: k2.shgemm_fused_pallas(a_pad, key, n_pad, bm=bm,
                                                          bn=bn, bk=bk,
                                                          splits=splits))
                return run, (n_pad // bn, a_pad.shape[0] // bm, splits), wbytes

            plan = autotune.pick_blocks(m, n, k, fused=name == "shgemm_fused")
            planned = planner(m, n, k)
            kern, grid, wbytes = kernel_at(plan)
            if name == "shgemm":
                b_f32 = b.float()
                plain = (lambda: k1.shgemm_plain(a, b, 2))
                lib = (lambda: torch.matmul(a, b_f32))
                what = "bf16 B"
            else:
                plain = (lambda: k2.shgemm_fused_plain(a, key, n))
                lib = (lambda: torch.matmul(a, omega32))
                what = "bf16 gaussian"
            t_k, d_k = median_ms(torch, kern), device_ms(torch, kern)
            t_pk, d_pk = t_k, d_k
            if plan != planned:
                plan_kern = kernel_at(planned)[0]
                t_pk, d_pk = median_ms(torch, plan_kern), device_ms(torch, plan_kern)
            t_p = median_ms(torch, plain)
            t_l, d_l = median_ms(torch, lib), device_ms(torch, lib)
            t_d, t_pd, t_ld = d_k[0], d_pk[0], d_l[0]
            t_b, by = bound_ms(m, k, n, 2, omega_bytes)
            print(f"[time] {name} {sname} ({m}x{k} @ {k}x{n}, {what}, 2 terms, "
                  f"plan (bm, bn, bk, splits) {plan} as the path launches it "
                  f"(autotune.pick_blocks; the planner's {planned}: "
                  f"{'the same' if plan == planned else f'{t_pk:.4f} ms, device {fmt_dev(d_pk)} ms'}"
                  f"), grid {grid}, workspace {wbytes} B): kernel {t_k:.4f} ms "
                  f"(device {fmt_dev(d_k)} ms), plain {t_p:.4f} ms, f32 matmul "
                  f"{t_l:.4f} ms (device {fmt_dev(d_l)} ms), bound {t_b:.4f} ms "
                  f"({by}); kernel/bound {t_k / t_b:.2f}x [{card}]")
            records[(name, sname)] = (t_k, t_p, t_l, t_b, by)
            err = (results.get(("shgemm", sname, bf16, 2)) if name == "shgemm"
                   else results.get(("shgemm_fused", sname, bf16, "gaussian")))
            per_shape[name].append({
                "shape": [m, k, n], "plan": list(plan), "planned": list(planned),
                "workspace_bytes": wbytes, "ms": t_k, "device_ms": t_d,
                "device_launches": d_k[1:], "planned_ms": t_pk,
                "planned_device_ms": t_pd, "plain_ms": t_p, "bound_ms": t_b,
                "bound_by": by, "library_ms": t_l, "library_device_ms": t_ld,
                "library_device_launches": d_l[1:], "max_abs_err": err})
        del omega32

    a_exp = main_path.rsvd_inputs(PAPER_RSVD, device=dev)["exp"]
    t = main_path.hosvd_input(PAPER_HOSVD, device=dev)
    calls = {("rsvd", m): (lambda m=m: rsvd.rsvd(
        key, a_exp, PAPER_RSVD.rank, oversample=PAPER_RSVD.oversample, method=m))
        for m in main_path.RSVD_METHODS}
    calls.update({(algo, m): (lambda fn=fn, m=m: fn(key, t, PAPER_HOSVD.ranks, method=m))
                  for algo, fn in main_path.HOSVD_ALGOS.items()
                  for m in main_path.HOSVD_METHODS})
    e2e = interleaved_host_ms(torch, calls, E2E_REPS)
    for (algo, method), ms in e2e.items():
        print(f"[e2e] {algo} {method}: {ms:.3f} ms (median of {E2E_REPS}, "
              f"methods interleaved), f32/{method} "
              f"{e2e[(algo, 'f32')] / ms:.3f}x [{card}]")
    omega_ms = interleaved_host_ms(torch, {
        (k, n): (lambda k=k, n=n: proj.materialize_omega(key, (k, n)))
        for k, n in ((RSVD_SHAPE[1], RSVD_SHAPE[2]), (HOSVD_SHAPE[1], HOSVD_SHAPE[2]))},
        E2E_REPS)
    for (k, n), ms in omega_ms.items():
        print(f"[e2e] materialize_omega gaussian ({k}, {n}) bf16, the non-fused "
              f"methods' Omega: {ms:.3f} ms [{card}]")
    for name in (("rsvd", "f32"), ("rsvd", "shgemm_pallas"), ("rsvd", "shgemm_fused"),
                 ("rp_hosvd", "f32"), ("rp_hosvd", "shgemm_pallas"),
                 ("rp_hosvd", "shgemm_fused")):
        wall, busy, top = device_breakdown(torch, calls[name])
        print(f"[profile] {name[0]} {name[1]}: wall {wall:.3f} ms (traced), device "
              f"kernels {busy:.3f} ms (busy {100 * busy / wall:.0f}%); top: "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:5]) + f" [{card}]")
    per_call = {}
    for name, counter, call in (
            ("rsvd shgemm_pallas", k1, lambda: rsvd.rsvd(
                key, a_exp, PAPER_RSVD.rank, method="shgemm_pallas")),
            ("rsvd shgemm_fused", k2, lambda: rsvd.rsvd(
                key, a_exp, PAPER_RSVD.rank, method="shgemm_fused")),
            ("rp_hosvd shgemm_pallas", k1, lambda: hosvd.rp_hosvd(
                key, t, PAPER_HOSVD.ranks, method="shgemm_pallas")),
            ("rp_hosvd shgemm_fused", k2, lambda: hosvd.rp_hosvd(
                key, t, PAPER_HOSVD.ranks, method="shgemm_fused"))):
        before = counter.launches
        call()
        per_call[name] = counter.launches - before
    print(f"[launches] per call: {per_call}")

    # -- 5.-8. the serving slice at qwen3-0.6b's full width ----------------
    from repro_torch.launch import serve as launch
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    cfg = R.get_arch(ARCH)
    serve_gen = torch.Generator(device=dev).manual_seed(4321)
    errs5 = phase5_kernels(torch, serve_gen, cfg)
    t0 = time.perf_counter()
    masters = launch.init_weights(cfg, seed=0, device=dev)
    weights = {"float32": masters,
               "bfloat16": T.cast_params_for_compute(cfg, masters)}
    torch.cuda.synchronize()
    print(f"[serve] {ARCH}: {T.param_count(cfg) / 1e6:.1f} M parameters at the "
          f"published widths ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}), random f32 masters from seed 0, cast to bf16 once; "
          f"{time.perf_counter() - t0:.1f} s")
    prefill = phase6_prefill(torch, serve_gen, cfg, weights, card)["bfloat16"]
    engine = phase7_engine(torch, cfg, weights, card)["bfloat16"]
    times8 = phase8_timings(torch, serve_gen, cfg, engine["engine"], card)

    # -- 9. the streamed and structured main path --------------------------
    stream9 = phase9_streamed(torch, dev, card)

    # -- 10. checkpointed, resumed and elastic jobs ------------------------
    resil10 = phase10_resilience(torch, dev, card, stream9["ooc"])

    # -- 11. the autotuner and distributed RandNLA ------------------------
    t_phase = time.perf_counter()
    tune11 = phase11_autotune(torch, dev, card, errs5)
    dist11 = phase11_distributed(torch, dev, card)
    print(f"[dist] phase 11 took {time.perf_counter() - t_phase:.1f} s")

    # -- 12. training with the paper's RandNLA optimizers -----------------
    # the serving slice's weights and engine are done with: free the card
    del masters, weights
    engine.pop("engine", None)
    torch.cuda.empty_cache()
    train12 = phase12_training(torch, dev, card)

    # -- 13. open-loop serving through the scheduler ----------------------
    torch.cuda.empty_cache()
    sched13 = phase13_scheduler(torch, dev, card)

    # -- 14. routed-MoE serving: qwen3-moe-30b-a3b (61 GB of weights) -----
    gc.collect()
    torch.cuda.empty_cache()
    moe14 = phase14_moe(torch, dev, card)

    # -- 15. MLA serving: deepseek-v2-lite-16b (31 GB of weights) ---------
    gc.collect()
    torch.cuda.empty_cache()
    mla15 = phase15_mla(torch, dev, card)

    # -- 16. recurrent mixers: recurrentgemma-2b and xlstm-350m -----------
    gc.collect()
    torch.cuda.empty_cache()
    rec16 = phase16_recurrent(torch, dev, card)

    # -- 19c's dry runs start here, in the background (host cores only) ---
    dry_cli = DryRunCells()
    try:
        # -- 17. enc-dec and VLM: whisper-large-v3, llava-next-34b (69 GB) -
        gc.collect()
        torch.cuda.empty_cache()
        encdec17 = phase17_encdec_vlm(torch, dev, card)

        # -- 18. training and serving across processes (gloo worlds) ------
        gc.collect()
        torch.cuda.empty_cache()
        shard18 = phase18_sharded(torch, dev, card, moe14.pop("world_ref"))

        # -- 19. the cell machinery and the dry run -----------------------
        gc.collect()
        torch.cuda.empty_cache()
        cells19 = phase19_cells(torch, dev, card, dry_cli)
    finally:
        dry_cli.stop()

    kernels = []
    for name, source, replaces, errkey in (
            ("shgemm", "src/repro_torch/kernels/csrc/shgemm.cu",
             "src/repro/kernels/shgemm.py:46", ("shgemm", "rsvd", bf16, 2)),
            ("shgemm_fused", "src/repro_torch/kernels/csrc/shgemm_fused.cu",
             "src/repro/kernels/shgemm_fused.py:173",
             ("shgemm_fused", "rsvd", bf16, "gaussian"))):
        t_k, t_p, t_l, t_b, by = records[(name, "rsvd")]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": main_launches[name],
                        "max_abs_err": results[errkey], "ms": t_k,
                        "plain_ms": t_p, "bound_ms": t_b, "bound_by": by,
                        "library_ms": t_l})
    for rec in kernels:
        rec["reductions"] = main_reductions[rec["name"]]
        rec["per_shape"] = per_shape[rec["name"]]
        rec["streamed_launches"] = stream9["launches"][rec["name"]]
        rec["streamed_max_abs_err"] = stream9["errs"][rec["name"]]
        rec["resilience_launches"] = resil10["launches"][rec["name"]]
        rec["autotuned"] = {sname: tune11[(rec["name"], sname)]
                            for sname in ("rsvd", "hosvd")}
        rec["distributed_launches"] = {
            "ranks": [lc[rec["name"]] for lc in dist11["rank_launches"]],
            "streamed": dist11["streamed"]["launches"][rec["name"]]}
        rec["training_launches"] = {
            name: r["launches"][rec["name"]]
            for name, r in train12["steps"].items() if name in TRAIN_CONFIGS}
        rec["training_per_shape"] = [
            {"what": key[1], **r} for key, r in train12["kernels"].items()
            if key[0] == rec["name"]]
    kernels[1]["training_launches"]["loop"] = train12["loop"]["clean"]["kernel2_launches"]
    kernels[1]["rolling_launches"] = sched13["13c"]["launches"]
    kernels[1]["mla_launches"] = mla15["15f"]["launches"]
    kernels[1]["mla"] = {"arch": MLA_ARCH, **mla15["15f"]}
    kernels[1]["recurrent_launches"] = rec16["16e"]["launches"]
    kernels[1]["recurrent"] = {"arch": REC_RG, **rec16["16e"]}
    kernels[1]["vlm_launches"] = encdec17["17b_sketch"]["launches"]
    kernels[1]["vlm"] = {"arch": VLM_ARCH, **encdec17["17b_sketch"]}
    kernels[0]["training_launches"]["world_ranks"] = [
        x["launches"] for x in train12["world"]["ranks"]]
    t_k, t_p, t_l, t_b, by = times8["flash_attention"]
    kernels.append({"name": "flash_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:38",
                    "launches": prefill["launches"],
                    "max_abs_err": errs5[("flash", "prefill")], "ms": t_k,
                    "plain_ms": t_p, "bound_ms": t_b, "bound_by": by,
                    "library_ms": t_l, "autotuned": None,
                    "distributed_launches": 0,
                    "moe": {"arch": MOE_ARCH, "launches": {"14a": moe14["14a"]["launches"]},
                            **moe14["flash"]},
                    "encdec_vlm": {"launches": {"17a": encdec17["17a"]["launches"],
                                                "17b": encdec17["17b"]["launches"]},
                                   **encdec17["17c"]},
                    "sharded": {"arch": MOE_ARCH, "world": SHARD_SERVE_WORLD,
                                "launches": {"18b": shard18["18b"]["launches"]}},
                    "cells": {"launches": {"19a": cells19["19a"]["launches"],
                                           "19b": cells19["19b"]["launches"]}}})
    fdec = times8["factored_decode"]["per_state"]
    kernels.append({"name": "factored_decode", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/factored_decode.cu",
                    "replaces": "src/repro/kernels/factored_decode.py:50",
                    "launches": engine["launches"],
                    "max_abs_err": errs5[("fdec", "bf16")], "ms": fdec[0]["ms"],
                    "device_ms": fdec[0]["device_ms"],
                    "plain_ms": fdec[0]["plain_ms"],
                    "bound_ms": fdec[0]["bound_ms"],
                    "bound_by": fdec[0]["bound_by"], "library_ms": None,
                    "per_state": (fdec + sched13["fdec_per_state"]
                                  + [moe14["fdec_state"], encdec17["fdec_state"]]),
                    "autotuned": tune11["factored_decode"],
                    "distributed_launches": 0,
                    "scheduler_launches": sched13["scheduler_launches"],
                    "moe_launches": {"14d": moe14["14d"]["launches"],
                                     "14e": moe14["14e"]["launches"]},
                    "vlm_launches": {"17b": encdec17["17b"]["engine_launches"]}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
