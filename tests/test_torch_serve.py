"""The port's serving engine (repro_torch.serve) against the reference's on
smoke qwen3 with the same weights, teacher-forced in lockstep.

The lockstep runs twice.  With f32 activations, where the point is the
algorithm, logits agree within the reference's serve tolerance (max
|d logit| < 1e-1, DESIGN.md §12).  With the model's bf16 activations the two
frameworks round at different places; there logits agree within one bf16
unit in the last place at the largest logit's magnitude.  Compression runs
at rank == head_dim, where every swap is exact whatever Omega, so no Omega
is patched; comp_len histories must be equal.  Also the reference's engine
contracts: staggered admission never compresses, the compress_slot error
paths, strictly smaller compressed bytes, and the bounded queue.

The other dense archs the port serves (gemma2 with its windowed ring layers,
codeqwen1.5, command-r-plus) run the model step's chunked prefill and masked
decode against the reference's at the qwen3 test's 1e-4, and gemma2 the f32
engine lockstep past its 16-row window, compressed.  The routed-MoE arch
(qwen3-moe) holds chunked prefill to the reference's token-by-token prefill
over the pool at 8 slots (dropless) and at 16 (the pool's capacity drops
pairs), and its f32 engine lockstep, compressed.  deepseek-v2-lite (MLA
latents and routed experts) holds the same chunked prefill at 8 and 16
slots, the masked decode's restore of the other slots' latent rows, its
latent sketches and the refusal of a compression ratio.  The recurrent
archs (recurrentgemma-2b, xlstm-350m) hold the chunked slot prefill to the
reference's token-by-token prefill and the masked decode's restore of the
other slots' state bit for bit; a reused slot (``begin_slot``, the
Engine's admission after idle decode steps) gives a fresh slot's logits,
where the reference's slots leak the last tenant's state (asserted for
itself: parity is asserted on fresh slots); their engines, refusals and
the serve CLI; and windowed layers that hold all of max_seq compress as
the reference's do."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import smoke_config as ref_smoke
from repro.models import registry as RR
from repro.models import transformer as RT
from repro.serve.engine import Engine as RefEngine, Request as RefRequest
from repro.serve.model_step import ModelStep as RefModelStep
from repro_torch.configs.base import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as launch
from repro_torch.models import registry as R
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.model_step import ModelStep
from repro_torch.serve.scheduler import QueueFullError

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

PROMPTS = [[5, 7, 11, 2], [3, 9, 1, 4]]


def _pair(act="bfloat16", arch="qwen3-0.6b"):
    ref_cfg = ref_smoke(RR.get_arch(arch)).with_(activation_dtype=act)
    cfg = smoke_config(R.get_arch(arch)).with_(activation_dtype=act)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference({k: np.asarray(v) for k, v in ref_params.items()},
                                   cfg)
    return ref_cfg, cfg, ref_params, params


def _lockstep(ref, port, max_new=30, steps=64):
    for e, Rq in ((ref, RefRequest), (port, Request)):
        for i, p in enumerate(PROMPTS):
            e.submit(Rq(rid=i, prompt=list(p), max_new=max_new))
    forced = np.random.default_rng(0).integers(0, ref.cfg.vocab, size=steps + 1)
    diffs, peaks, step = [], [], 0
    while (ref.queue or any(ref.active)) and step < steps:
        assert ref.step() == port.step()
        live = [s for s in range(ref.slots) if ref.active[s] is not None]
        want = np.asarray(ref.last_logits)[live]
        got = port.last_logits.numpy()[live]
        if live:
            diffs.append(float(np.abs(got - want).max()))
            peaks.append(float(np.abs(want).max()))
        assert list(ref._kv_comp_len) == list(port._kv_comp_len), step
        assert list(ref.pos) == list(port.pos)
        for e in (ref, port):
            for s in range(e.slots):
                if e.active[s] is not None and e.active[s].out:
                    e.active[s].out[-1] = int(forced[step])
        step += 1
    assert diffs, "engines never decoded in lockstep"
    return diffs, peaks


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", [False, True], ids=["dense", "compressed"])
def test_engine_matches_reference(act, compress):
    ref_cfg, cfg, ref_params, params = _pair(act)
    kw = dict(slots=2, max_seq=64)
    if compress:
        kw.update(kv_sketch_rank=cfg.head_dim, kv_compress_ratio=1.0)
    ref = RefEngine(ref_cfg, ref_params, **kw)
    port = Engine(cfg, params, device="cpu", **kw)
    diffs, peaks = _lockstep(ref, port)
    if act == "float32":
        assert max(diffs) < 1e-1, max(diffs)
    else:
        assert max(diffs) <= _bf16_ulp(max(peaks)), (max(diffs), max(peaks))
    if compress:
        assert (port._kv_comp_len > port._kv_threshold).all(), port._kv_comp_len
        assert port.kv_bytes_report() == ref.kv_bytes_report()


def test_model_step_prefill_rows_and_masked_decode_match_reference():
    """Chunked prefill into one slot, then a masked decode step: logits
    match, and the unmasked slot's cache row at the clock is left as it
    was."""
    ref_cfg, cfg, ref_params, params = _pair("float32")
    ref = RefModelStep(ref_cfg, ref_params, slots=2, max_seq=32)
    port = ModelStep(cfg, params, slots=2, max_seq=32, device="cpu")
    for e in (ref, port):
        e.prefill_rows(0, [3, 4, 5], 0)
    want0 = np.asarray(ref.prefill_rows(1, [6, 7], 0))
    got0 = port.prefill_rows(1, [6, 7], 0).numpy()
    np.testing.assert_allclose(got0, want0, rtol=1e-4, atol=1e-4)
    before = port.cache["scan"][0]["k"][:, 1, 3].clone()
    tokens = np.array([[8], [9]], np.int32)
    want = np.asarray(ref.decode_logits(tokens, 3, slot_mask=np.array([True, False])))
    got = port.decode_logits(tokens, 3, slot_mask=np.array([True, False])).numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert torch.equal(port.cache["scan"][0]["k"][:, 1, 3], before)
    np.testing.assert_allclose(port.cache["scan"][0]["k"].float().numpy(),
                               np.asarray(ref.cache["scan"][0]["k"], np.float32),
                               rtol=1e-2, atol=1e-2)
    assert list(port.pos) == list(ref.pos) == [3, 2]


@pytest.mark.parametrize("arch", ["gemma2-2b", "codeqwen1.5-7b",
                                  "command-r-plus-104b"])
def test_model_step_matches_reference_across_archs(arch):
    """Chunked prefill into two slots (gemma2: across its 16-row ring's
    end), then a masked decode step: logits within 1e-4, caches within a
    bf16 ulp, positions equal."""
    ref_cfg, cfg, ref_params, params = _pair("float32", arch)
    ref = RefModelStep(ref_cfg, ref_params, slots=2, max_seq=32)
    port = ModelStep(cfg, params, slots=2, max_seq=32, device="cpu")
    tok = np.random.default_rng(2).integers(1, cfg.vocab, 30).tolist()
    for slot, start, end in ((0, 0, 9), (0, 9, 18), (1, 0, 5), (0, 18, 21)):
        want = np.asarray(ref.prefill_rows(slot, tok[start:end], start))
        got = port.prefill_rows(slot, tok[start:end], start).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    tokens = np.array([[tok[21]], [tok[22]]], np.int32)
    mask = np.array([True, False])
    want = np.asarray(ref.decode_logits(tokens, 21, slot_mask=mask))
    got = port.decode_logits(tokens, 21, slot_mask=mask).numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    for group in ("pre", "scan", "rem"):
        for layer, ref_layer in zip(port.cache[group] or (), ref.cache[group] or ()):
            for name in layer:
                np.testing.assert_allclose(layer[name].float().numpy(),
                                           np.asarray(ref_layer[name], np.float32),
                                           rtol=1e-2, atol=1e-2)
    assert list(port.pos) == list(ref.pos) == [21, 5]


def test_engine_matches_reference_gemma2():
    """gemma2's engines in f32 lockstep past the window, compressing its
    global layers at rank == head_dim while the local rings wrap."""
    ref_cfg, cfg, ref_params, params = _pair("float32", "gemma2-2b")
    kw = dict(slots=2, max_seq=64, kv_sketch_rank=cfg.head_dim, kv_compress_ratio=1.0)
    ref = RefEngine(ref_cfg, ref_params, **kw)
    port = Engine(cfg, params, device="cpu", **kw)
    diffs, _ = _lockstep(ref, port, max_new=30, steps=40)
    assert max(diffs) < 1e-1, max(diffs)
    assert max(port.pos) > 16 and (port._kv_comp_len > 0).any()


# -- the routed-MoE arch (qwen3-moe) ------------------------------------------

MOE = "qwen3-moe-30b-a3b"


DEEPSEEK = "deepseek-v2-lite-16b"


def _moe_pair(arch=MOE):
    """The f32 smoke pair of a routed-MoE arch with the MoE leaves (router
    and experts) scaled by 20: at the init scale the routed experts barely
    move the residual stream, and a dropped pair would change the logits by
    ~1e-6."""
    ref_cfg, cfg, ref_params, _ = _pair("float32", arch)
    ref_params = {k: (20 * v if "/moe/" in k else v) for k, v in ref_params.items()}
    params = params_from_reference({k: np.asarray(v) for k, v in ref_params.items()},
                                   cfg)
    return ref_cfg, cfg, ref_params, params


@pytest.fixture(scope="module")
def moe_ref_prefill():
    """For each arch, once: the reference's slot prefill token by token, 40
    tokens into slot 5 of 8 and into slot 9 of 16 (slot 0 holding 12 rows
    of its own): the logits after each token and the model step."""
    runs = {}

    def get(arch):
        if arch not in runs:
            ref_cfg, cfg, ref_params, params = _moe_pair(arch)
            tok = np.random.default_rng(5).integers(1, cfg.vocab, 52).tolist()
            out = {}
            for slots, slot in ((8, 5), (16, 9)):
                ref = RefModelStep(ref_cfg, ref_params, slots=slots, max_seq=48)
                ref.prefill_rows(0, tok[40:], 0)
                out[slots] = (slot, [np.asarray(ref.prefill_rows(slot, [t], i))
                                     for i, t in enumerate(tok[:40])], ref)
            runs[arch] = (cfg, params, tok, out)
        return runs[arch]
    return get


@pytest.mark.parametrize("arch,slots,chunk", [
    pytest.param(arch, slots, chunk,
                 id=f"{'' if arch == MOE else 'deepseek-'}{slots}-{chunk}")
    for arch in (MOE, DEEPSEEK) for slots in (8, 16) for chunk in (1, 5, 16, 40)])
def test_moe_prefill_rows_chunks_match_reference_token_by_token(
        moe_ref_prefill, arch, slots, chunk):
    """Chunked prefill_rows against the reference's token-by-token prefill
    over the pool: logits at each chunk's end within 1e-4, every cache leaf
    within 1e-2 (a bf16 cache).  At 8 slots the pool's capacity (8) holds
    every pair and a chunk runs as one dropless step; at 16 it is 8 of 16
    tokens, slot 9's pairs drop as the other slots route, and the port runs
    the pool token by token: a lone slot prefilled without drops misses the
    reference's logits.  deepseek's chunks run MLA's cached branch over a
    chunk; its 16-slot pool steps must restore slot 0's latent rows."""
    cfg, params, tok, out = moe_ref_prefill(arch)
    slot, want, ref = out[slots]
    port = ModelStep(cfg, params, slots=slots, max_seq=48, device="cpu")
    port.prefill_rows(0, tok[40:], 0)
    for start in range(0, 40, chunk):
        end = min(start + chunk, 40)
        got = port.prefill_rows(slot, tok[start:end], start).numpy()
        np.testing.assert_allclose(got, want[end - 1], rtol=1e-4, atol=1e-4)
    for group in ("pre", "scan", "rem"):
        for layer, ref_layer in zip(port.cache[group] or (), ref.cache[group] or ()):
            for name in layer:
                np.testing.assert_allclose(layer[name].float().numpy(),
                                           np.asarray(ref_layer[name], np.float32),
                                           rtol=1e-2, atol=1e-2)
    assert list(port.pos) == list(ref.pos)
    lone = ModelStep(cfg, params, slots=1, max_seq=48, device="cpu")
    alone = lone.prefill_rows(0, tok[:40], 0).numpy()
    differs = np.abs(alone - want[-1]).max() > 1e-4
    assert differs == (slots > 8)


def test_deepseek_masked_decode_keeps_other_slots_latents():
    """A masked decode step at a clock inside another slot's live history:
    the masked slot's logits match the reference's, the masked-out slot's
    ckv/kr rows at the clock keep their values, and every latent leaf
    matches the reference's cache."""
    ref_cfg, cfg, ref_params, params = _pair("float32", DEEPSEEK)
    ref = RefModelStep(ref_cfg, ref_params, slots=3, max_seq=32)
    port = ModelStep(cfg, params, slots=3, max_seq=32, device="cpu")
    tok = np.random.default_rng(6).integers(1, cfg.vocab, 30).tolist()
    for slot, start, end in ((0, 0, 3), (1, 0, 9), (2, 0, 5), (1, 9, 12)):
        want = np.asarray(ref.prefill_rows(slot, tok[start:end], start))
        got = port.prefill_rows(slot, tok[start:end], start).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    clock, mask = 3, np.array([True, False, False])
    leaves = [(g, layer) for g in ("pre", "scan") for layer in port.cache[g]]
    before = {(g, i, n): (layer[n][:, :, clock] if g == "scan"
                          else layer[n][:, clock]).clone()
              for i, (g, layer) in enumerate(leaves) for n in ("ckv", "kr")}
    tokens = np.array([[tok[20]], [tok[21]], [tok[22]]], np.int32)
    want = np.asarray(ref.decode_logits(tokens, clock, slot_mask=mask))
    got = port.decode_logits(tokens, clock, slot_mask=mask).numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    for i, (g, layer) in enumerate(leaves):
        for n in ("ckv", "kr"):
            row = layer[n][:, :, clock] if g == "scan" else layer[n][:, clock]
            old = before[(g, i, n)]
            assert torch.equal(row[..., 1:, :], old[..., 1:, :]), (g, n)
            assert not torch.equal(row[..., 0, :], old[..., 0, :]), (g, n)
    assert bool(before[("pre", 0, "ckv")][1].any())    # slot 1's live row
    for group in ("pre", "scan"):
        for layer, ref_layer in zip(port.cache[group], ref.cache[group]):
            assert sorted(layer) == ["ckv", "kr"]
            for name in layer:
                np.testing.assert_allclose(layer[name].float().numpy(),
                                           np.asarray(ref_layer[name], np.float32),
                                           rtol=1e-2, atol=1e-2)


def test_deepseek_latent_sketches():
    """Rank-4 sketches of the latent cache leaves over prefill chunks and
    masked decode rows: the same sketch paths and state shapes as the
    reference's, its kv_bytes_report (nothing swappable), sketch high-water
    == pos for every slot, and each slot's streamed ckv/kr sketch equal to
    a fresh one-shot sketch of that slot's history at the slot's key within
    1e-6 (the per-slot keys are a documented deviation, so the values are
    not compared with the reference's)."""
    from repro_torch.serve import kv_compress
    ref_cfg, cfg, ref_params, params = _pair("float32", DEEPSEEK)
    kw = dict(slots=2, max_seq=48, kv_sketch_rank=4)
    ref = RefModelStep(ref_cfg, ref_params, **kw)
    port = ModelStep(cfg, params, device="cpu", **kw)
    tok = np.random.default_rng(7).integers(1, cfg.vocab, 40).tolist()
    for e in (ref, port):
        for slot in (0, 1):
            e.begin_slot(slot)
        for slot, start, end in ((0, 0, 9), (1, 0, 7), (0, 9, 26)):
            e.prefill_rows(slot, tok[start:end], start)
        for clock in (26, 27, 28):                    # slot 0 decodes alone
            e.decode_logits(np.array([[tok[clock]], [0]], np.int32), clock,
                            slot_mask=np.array([True, False]))
            e._note_kv_row(0, clock)
            e.pos[0] = clock + 1
    assert port._kv_paths == [tuple(p) for p in ref._kv_paths]
    assert {p[2] for p in port._kv_paths} == {"ckv", "kr"}
    assert port.kv_bytes_report() == ref.kv_bytes_report()
    assert port.kv_bytes_report()["dense_bytes"] == 0
    for slot in (0, 1):
        port._flush_kv_pending(slot)
        ref._flush_kv_pending(slot)
        pos = int(port.pos[slot])
        assert port._kv_next_row[slot] == pos and port._kv_contig[slot]
        for j, path in enumerate(port._kv_paths):
            state = port._kv_sketches[slot][path]
            assert tuple(state.y.shape) == ref._kv_sketches[slot][path].y.shape
            assert state.rows_seen == pos
            hist = port._kv_leaf_rows(path, slot, 0, pos)
            fresh = kv_compress.kv_sketch_init(
                port._slot_key(slot, j), hist.shape[0], hist.shape[-1], 48, 4,
                device="cpu")
            fresh = kv_compress.kv_sketch_append(fresh, hist, 0)
            np.testing.assert_allclose(state.y.numpy(), fresh.y.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=str(path))
            assert bool(state.y[:, :pos].any()) and not state.y[:, pos:].any()


def test_deepseek_refuses_a_compression_ratio():
    """MLA latents are not swappable: a compression ratio raises in both
    packages."""
    ref_cfg, cfg, ref_params, params = _pair("float32", DEEPSEEK)
    kw = dict(slots=2, max_seq=32, kv_sketch_rank=4, kv_compress_ratio=2.0)
    with pytest.raises(ValueError, match="no full-context attention k/v leaves"):
        RefModelStep(ref_cfg, ref_params, **kw)
    with pytest.raises(ValueError, match="no full-context attention k/v leaves"):
        ModelStep(cfg, params, device="cpu", **kw)


def test_moe_engine_matches_reference_f32():
    """qwen3-moe's engines in f32 lockstep, compressing at rank ==
    head_dim: logits within 1e-1, equal comp_len after every step."""
    ref_cfg, cfg, ref_params, params = _moe_pair()
    kw = dict(slots=2, max_seq=64, kv_sketch_rank=cfg.head_dim, kv_compress_ratio=1.0)
    ref = RefEngine(ref_cfg, ref_params, **kw)
    port = Engine(cfg, params, device="cpu", **kw)
    diffs, _ = _lockstep(ref, port, max_new=30, steps=40)
    assert max(diffs) < 1e-1, max(diffs)
    assert (port._kv_comp_len > 0).all()


def _port_engine(**kw):
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    return Engine(cfg, launch.init_weights(cfg, seed=0, device="cpu"),
                  device="cpu", **kw)


def test_staggered_admission_never_compresses():
    eng = _port_engine(slots=2, max_seq=64, kv_sketch_rank=4, kv_compress_ratio=2.0)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=40))
    eng.submit(Request(rid=1, prompt=[4, 5, 6], max_new=4))
    eng.submit(Request(rid=2, prompt=[7, 8, 9], max_new=20))  # queued
    eng.run()
    lagging = [s for s in range(2) if not eng._kv_contig[s]]
    synced = [s for s in range(2) if eng._kv_contig[s]]
    assert lagging and synced, (eng._kv_contig, eng._kv_comp_len)
    for s in lagging:
        assert eng._kv_comp_len[s] == 0, "gapped slot must not compress"
        with pytest.raises(ValueError, match="admitted mid-stream"):
            eng.compress_slot(s)
    for s in synced:
        assert eng._kv_comp_len[s] > 0


def test_compress_slot_error_paths():
    plain = _port_engine(slots=1, max_seq=32)
    with pytest.raises(ValueError, match="no sketch state"):
        plain.kv_factors(0)
    eng = _port_engine(slots=2, max_seq=32, kv_sketch_rank=4, kv_compress_ratio=2.0)
    with pytest.raises(ValueError, match="never|no sketch state"):
        eng.kv_factors(1)
    sk_only = _port_engine(slots=1, max_seq=32, kv_sketch_rank=4)
    with pytest.raises(ValueError, match="without kv_compress_ratio"):
        sk_only.compress_slot(0)
    eng.submit(Request(rid=0, prompt=[2, 3, 4], max_new=12))
    eng.run()
    assert eng._kv_comp_len[0] > 0
    if eng.pos[0] > eng._kv_comp_len[0]:
        eng.compress_slot(0)                 # legit: compress the last tail
    with pytest.raises(ValueError, match="already fully factored"):
        eng.compress_slot(0)
    with pytest.raises(ValueError, match="requires kv_sketch_rank"):
        _port_engine(slots=1, max_seq=32, kv_compress_ratio=2.0)
    with pytest.raises(ValueError, match=">= 1"):
        _port_engine(slots=1, max_seq=32, kv_sketch_rank=4, kv_compress_ratio=0.5)
    short = _port_engine(slots=1, max_seq=32, kv_sketch_rank=4, kv_compress_ratio=8.0)
    short.submit(Request(rid=0, prompt=[1, 2], max_new=2))
    short.step()
    with pytest.raises(ValueError, match="sketch width"):
        short.compress_slot(0)


def test_compressed_slot_bytes_strictly_drop():
    eng = _port_engine(slots=2, max_seq=64, kv_sketch_rank=4, kv_compress_ratio=2.0)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=[1 + i, 2, 3], max_new=24))
    eng.run()
    rep = eng.kv_bytes_report()
    assert all(r["comp_len"] > 0 for r in rep["slots"])
    for r in rep["slots"]:
        assert r["compressed_bytes"] < r["dense_bytes"], r


def test_bounded_queue():
    eng = _port_engine(slots=1, max_seq=32, max_queue=2)
    eng.submit(Request(rid=0, prompt=[1], max_new=2))
    eng.submit(Request(rid=1, prompt=[1], max_new=2))
    with pytest.raises(QueueFullError, match="queue depth 2"):
        eng.submit(Request(rid=2, prompt=[1], max_new=2))
    with pytest.raises(ValueError, match="max_queue"):
        _port_engine(slots=1, max_seq=32, max_queue=0)


def test_sampling_is_seeded():
    """temperature > 0 draws from the engine's torch.Generator: one seed,
    one token stream."""
    outs = []
    for _ in range(2):
        eng = _port_engine(slots=1, max_seq=32, temperature=1.0, sample_seed=3)
        eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=8))
        req = eng.queue[0]
        eng.run()
        outs.append(req.out)
    assert outs[0] == outs[1] and len(outs[0]) == 8


def test_lockstep_and_run_engine_on_cpu():
    """launch.serve's lockstep of two port engines (plain vs the
    kernel configuration, which on CPU tensors runs the plain versions)
    and its timed closed-loop run."""
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    params = launch.init_weights(cfg, seed=0, device="cpu")
    kw = dict(slots=2, max_seq=48, kv_sketch_rank=4, kv_compress_ratio=2.0,
              device="cpu")
    engines = [Engine(cfg, params, **kw),
               Engine(cfg.with_(use_flash_kernel=True), params, **kw)]
    res = launch.lockstep(engines, launch.make_prompts(2, 8, cfg.vocab), max_new=20,
                          compare=lambda got, want: got.shape == want.shape)
    assert res["steps"] == 19 and max(res["diffs"]) == 0.0
    assert res["compared"] == [True] * 18     # the last step frees every slot
    assert res["comp_len"][0] == res["comp_len"][1]
    seen = []
    run = launch.run_engine(cfg, params, launch.make_prompts(3, 8, cfg.vocab),
                            max_new=6, on_step=lambda eng, i: seen.append(i),
                            **kw)
    assert run["tokens"] == 18 and run["steps"] > 0 and run["seconds"] > 0
    assert seen == list(range(run["steps"])) == list(range(len(run["step_ms"])))
    assert not run["engine"].queue and not any(run["engine"].active)


# -- the recurrent archs: recurrentgemma-2b (RG-LRU + local attention) and
# xlstm-350m (mLSTM + sLSTM) -------------------------------------------------

RECURRENT = ["recurrentgemma-2b", "xlstm-350m"]


def _f32_conv(cache):
    """f32 ``conv`` leaves for the f32 parity runs, in either package's
    cache.  The blocks return an f32 conv state in f32 activations: the
    port writes it into its leaf in place, which a bf16 leaf would round,
    and the reference's model step scans its slot prefill with the cache as
    the carry, which refuses a bf16 leaf coming back f32."""
    for group in ("pre", "scan", "rem"):
        for layer in cache[group] or ():
            if "conv" in layer:
                conv = layer["conv"]
                layer["conv"] = (conv.float() if isinstance(conv, torch.Tensor)
                                 else conv.astype(np.float32))
    return cache


def _state_rows(model, slot):
    """Clones of ``slot``'s rows of every recurrent-state leaf."""
    out = {}
    for group in ("pre", "scan", "rem"):
        for i, layer in enumerate(model.cache[group] or ()):
            for name in ("h", "conv", "c", "n"):
                if name in layer:
                    leaf = layer[name]
                    out[(group, i, name)] = (leaf[:, slot] if group == "scan"
                                             else leaf[slot]).clone()
    return out


@pytest.fixture(scope="module")
def recurrent_ref_prefill():
    """For each arch, once: the reference's slot prefill token by token
    (f32), 12 tokens into slot 0, then 40 into fresh slot 2 of 3: the
    logits after each token and the model step."""
    runs = {}

    def get(arch):
        if arch not in runs:
            ref_cfg, cfg, ref_params, params = _pair("float32", arch)
            tok = np.random.default_rng(7).integers(1, cfg.vocab, 52).tolist()
            ref = RefModelStep(ref_cfg, ref_params, slots=3, max_seq=48)
            _f32_conv(ref.cache)
            ref.prefill_rows(0, tok[40:], 0)
            want = [np.asarray(ref.prefill_rows(2, [t], i))
                    for i, t in enumerate(tok[:40])]
            runs[arch] = (cfg, params, tok, want, ref)
        return runs[arch]
    return get


@pytest.mark.parametrize("chunk", [1, 5, 40])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_rows_chunks_match_reference_token_by_token(
        recurrent_ref_prefill, arch, chunk):
    """The port's chunked slot prefill (one serve step a chunk on the
    slot's rows; recurrentgemma's 16-row ring wraps) against the
    reference's token-by-token ``_make_slot_prefill`` on fresh slots, f32
    with f32 conv leaves: logits at each chunk's end within 1e-4, state
    leaves within 1e-4, k/v within 1e-2 (a bf16 cache)."""
    cfg, params, tok, want, ref = recurrent_ref_prefill(arch)
    port = ModelStep(cfg, params, slots=3, max_seq=48, device="cpu")
    _f32_conv(port.cache)
    port.prefill_rows(0, tok[40:], 0)
    for start in range(0, 40, chunk):
        end = min(start + chunk, 40)
        got = port.prefill_rows(2, tok[start:end], start).numpy()
        np.testing.assert_allclose(got, want[end - 1], rtol=1e-4, atol=1e-4)
    for group in ("pre", "scan", "rem"):
        for layer, ref_layer in zip(port.cache[group] or (), ref.cache[group] or ()):
            assert sorted(layer) == sorted(ref_layer)
            for name in layer:
                tol = 1e-2 if name in ("k", "v") else 1e-4
                np.testing.assert_allclose(layer[name].float().numpy(),
                                           np.asarray(ref_layer[name], np.float32),
                                           rtol=tol, atol=tol, err_msg=name)
    assert list(port.pos) == list(ref.pos)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_masked_decode_keeps_other_slots_state(arch):
    """A masked decode step for slot 0 alone: slot 0's logits and state
    match the reference's (f32, 1e-4), and slots 1 and 2 keep every
    recurrent-state row bit for bit (the unmasked step changes them)."""
    ref_cfg, cfg, ref_params, params = _pair("float32", arch)
    ref = RefModelStep(ref_cfg, ref_params, slots=3, max_seq=32)
    port = ModelStep(cfg, params, slots=3, max_seq=32, device="cpu")
    _f32_conv(ref.cache)
    _f32_conv(port.cache)
    tok = np.random.default_rng(8).integers(1, cfg.vocab, 30).tolist()
    for slot, start, end in ((0, 0, 6), (1, 0, 9), (2, 0, 4)):
        want = np.asarray(ref.prefill_rows(slot, tok[start:end], start))
        got = port.prefill_rows(slot, tok[start:end], start).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    before = {s: _state_rows(port, s) for s in range(3)}
    tokens, mask = np.array([[tok[20]], [tok[21]], [tok[22]]], np.int32), \
        np.array([True, False, False])
    want = np.asarray(ref.decode_logits(tokens, 6, slot_mask=mask))
    got = port.decode_logits(tokens, 6, slot_mask=mask).numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    for s in (1, 2):
        after = _state_rows(port, s)
        assert all(torch.equal(after[k], v) for k, v in before[s].items()), s
    assert any(not torch.equal(_state_rows(port, 0)[k], v)
               for k, v in before[0].items())
    for (group, i, name), rows in _state_rows(port, 0).items():
        ref_leaf = np.asarray(ref.cache[group][i][name], np.float32)
        ref_rows = ref_leaf[:, 0] if group == "scan" else ref_leaf[0]
        np.testing.assert_allclose(rows.float().numpy(), ref_rows, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    port.decode_logits(tokens, 6)                 # unmasked: every slot moves
    assert any(not torch.equal(_state_rows(port, 1)[k], v)
               for k, v in before[1].items())


def _tenant_run(model, slot, tokens):
    """Prefill ``tokens[:2]`` into ``slot``, then masked decode steps of the
    rest at the slot's own positions: the logits after each (a short
    prefill, so that a state left by the last tenant still shows)."""
    out = [np.asarray(model.prefill_rows(slot, tokens[:2], 0))]
    mask = np.arange(model.slots) == slot
    for i, t in enumerate(tokens[2:]):
        toks = np.zeros((model.slots, 1), np.int32)
        toks[slot, 0] = t
        out.append(np.asarray(model.decode_logits(toks, 2 + i, slot_mask=mask))[slot])
        model.pos[slot] = 3 + i
    return np.stack(out)


@pytest.mark.parametrize("arch", RECURRENT)
def test_begin_slot_reuse_equals_fresh_slot(arch, monkeypatch):
    """Slot 1 serves tenant A, then begin_slot(1) and tenant B: B's logits
    equal B's in a fresh pool (1e-6, f32).  The reference's begin_slot
    keeps A's recurrent state, and so does the port's with the reset
    patched out: B's logits then move by more than 1e-4 (at the smoke
    init's scale the recurrences forget within a few tokens, so B's prefill
    is two tokens long)."""
    ref_cfg, cfg, ref_params, params = _pair("float32", arch)
    rng = np.random.default_rng(9)
    a, b = (rng.integers(1, cfg.vocab, 5).tolist() for _ in range(2))

    def reused(model):
        model.begin_slot(1)
        _tenant_run(model, 1, a)
        model.begin_slot(1)
        return _tenant_run(model, 1, b)

    def fresh(model):
        model.begin_slot(1)
        return _tenant_run(model, 1, b)

    mk = dict(slots=2, max_seq=32)

    def make(cls, *args, **kw):
        model = cls(*args, **kw, **mk)
        _f32_conv(model.cache)
        return model

    got = reused(make(ModelStep, cfg, params, device="cpu"))
    want = fresh(make(ModelStep, cfg, params, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref_fresh = fresh(make(RefModelStep, ref_cfg, ref_params))
    np.testing.assert_allclose(want, ref_fresh, rtol=1e-4, atol=1e-4)
    ref_reused = reused(make(RefModelStep, ref_cfg, ref_params))
    assert np.abs(ref_reused - ref_fresh).max() > 1e-4
    from repro_torch.models import cache as cache_mod
    monkeypatch.setattr(cache_mod, "reset_slot_state", lambda cache, slot: None)
    leaky = reused(make(ModelStep, cfg, params, device="cpu"))
    assert np.abs(leaky - want).max() > 1e-4


@pytest.mark.parametrize("reset", [True, False], ids=["reset", "reset patched out"])
def test_engine_admission_resets_reused_idle_slot(reset, monkeypatch):
    """xlstm-350m's Engine, 2 slots: A decodes long in slot 0, B finishes
    in slot 1, which then idles through 4 unmasked decode steps (token 0
    advancing its state) before C is admitted there.  C's tokens and every
    decode logit equal C's alone in a fresh engine (1e-5, f32); with the
    admission's reset patched out they do not."""
    from repro_torch.models import cache as cache_mod
    _, cfg, _, params = _pair("float32", "xlstm-350m")
    rng = np.random.default_rng(10)
    pa, pb, pc = (rng.integers(1, cfg.vocab, 5).tolist() for _ in range(3))
    if not reset:
        monkeypatch.setattr(cache_mod, "reset_slot_state", lambda cache, slot: None)

    def run(reqs, late=None):
        eng = Engine(cfg, params, slots=2, max_seq=64, device="cpu")
        _f32_conv(eng.cache)
        for r in reqs:
            eng.submit(r)
        logits, step, slot = [], 0, None
        while eng.queue or any(eng.active):
            if late is not None and step == late[0]:
                eng.submit(late[1])
            before = len(late_req.out)
            eng.step()
            step += 1
            if slot is None:
                slot = next((s for s in range(2) if eng.active[s] is late_req), None)
            if slot is not None and len(late_req.out) > before:
                logits.append(eng.last_logits[slot].numpy())
        return logits

    late_req = Request(rid=2, prompt=pc, max_new=6)
    got = run([Request(rid=0, prompt=pa, max_new=16),
               Request(rid=1, prompt=pb, max_new=3)], late=(6, late_req))
    got_out = list(late_req.out)
    late_req = Request(rid=2, prompt=pc, max_new=6)
    want = run([late_req])
    assert len(got) == len(want) == 5 and len(got_out) == 6
    same = (got_out == late_req.out
            and np.allclose(np.stack(got), np.stack(want), rtol=1e-5, atol=1e-5))
    assert same == reset


@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_recurrent_cache_families(arch):
    """The counterpart of the reference's test_engine_other_cache_families:
    one request through the port's engine; its greedy tokens equal the
    reference's full forward's."""
    ref_cfg, cfg, ref_params, params = _pair("bfloat16", arch)
    eng = Engine(cfg, params, slots=2, max_seq=48, device="cpu")
    prompt = [3, 5, 7]
    req = Request(rid=0, prompt=list(prompt), max_new=3)
    eng.submit(req)
    eng.run()
    assert req.done and len(req.out) >= 3
    ref = []
    for _ in range(3):
        out = RT.forward(ref_cfg, ref_params, jax.numpy.asarray([prompt + ref], np.int32))
        ref.append(int(np.argmax(np.asarray(out.logits[0, -1], np.float32))))
    assert req.out[:3] == ref, (arch, req.out, ref)


@pytest.mark.parametrize("arch,max_seq,refused", [
    ("xlstm-350m", 16, True), ("recurrentgemma-2b", 48, True),
    ("recurrentgemma-2b", 16, False)])
def test_recurrent_compression_ratio(arch, max_seq, refused):
    """A compression ratio needs full-context k/v: xlstm has none, and
    recurrentgemma's local layers are full-context only while max_seq fits
    their window (16 in smoke); both packages agree."""
    ref_cfg, cfg, ref_params, params = _pair("float32", arch)
    kw = dict(slots=2, max_seq=max_seq, kv_sketch_rank=4, kv_compress_ratio=2.0)
    for make in (lambda: RefModelStep(ref_cfg, ref_params, **kw),
                 lambda: ModelStep(cfg, params, device="cpu", **kw)):
        if refused:
            with pytest.raises(ValueError, match="no full-context attention k/v leaves"):
                make()
        else:
            assert make().kv_fact is not None


@pytest.mark.parametrize("arch", RECURRENT)
def test_hbm_budget_without_swappable_bytes_raises(arch):
    """No full-context k/v at max_seq 48: an HBM budget caps nothing; the
    port says so, where the reference divides by zero."""
    from repro.serve.scheduler import Scheduler as RefScheduler
    from repro_torch.serve.scheduler import Scheduler
    ref_cfg, cfg, ref_params, params = _pair("float32", arch)
    with pytest.raises(ValueError, match="no swappable KV bytes"):
        Scheduler(ModelStep(cfg, params, slots=2, max_seq=48, device="cpu"),
                  hbm_budget=1 << 30)
    with pytest.raises(ZeroDivisionError):
        RefScheduler(RefModelStep(ref_cfg, ref_params, slots=2, max_seq=48),
                     hbm_budget=1 << 30)


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("mode", ["engine", "scheduler"])
def test_serve_cli_recurrent_smoke(arch, mode, capsys):
    """``launch.serve --smoke`` on the CPU for both recurrent archs: the
    closed-loop engine and the open-loop scheduler drain; a compression
    ratio raises."""
    base = ["--device", "cpu", "--smoke", "--arch", arch, "--slots", "2",
            "--max-seq", "128", "--prompt-len", "24", "--max-new", "8",
            "--requests", "3", "--kv-rank", "4"]
    if mode == "scheduler":
        base += ["--arrival-rate", "200", "--prefill-chunk", "16"]
    launch.main(base)
    out = capsys.readouterr().out
    if mode == "engine":
        assert "served 3 requests / 24 tokens" in out
    else:
        assert "SLO summary (virtual clock)" in out and "3 requests" in out
    with pytest.raises(ValueError, match="no full-context attention"):
        launch.main(base + ["--kv-compress-ratio", "2"])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "gemma2-2b"])
def test_windowed_layers_within_max_seq_compress_like_reference(arch):
    """Local layers whose window holds all of max_seq are full-context: the
    reference swaps their k/v to factors and decodes through them.  With a
    64-row window and max_seq 64 the f32 engines compress at rank ==
    head_dim (exact swaps) and stay in lockstep within 1e-1, with equal
    comp_len after every step (both packages' conv leaves f32)."""
    ref_cfg, cfg, ref_params, params = _pair("float32", arch)
    widen = lambda c: c.with_(pattern=tuple(  # noqa: E731
        dataclasses.replace(sp, window=64) if sp.window else sp for sp in c.pattern))
    ref_cfg, cfg = widen(ref_cfg), widen(cfg)
    kw = dict(slots=2, max_seq=64, kv_sketch_rank=cfg.head_dim, kv_compress_ratio=1.0)
    ref = RefEngine(ref_cfg, ref_params, **kw)
    port = Engine(cfg, params, device="cpu", **kw)
    _f32_conv(ref.cache)
    _f32_conv(port.cache)
    assert port._kv_swap_paths and not port._kv_roll_paths
    diffs, _ = _lockstep(ref, port, max_new=40, steps=56)
    assert max(diffs) < 1e-1, max(diffs)
    assert (port._kv_comp_len > 0).all()
