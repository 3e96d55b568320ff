"""The port's incremental KV compression (repro_torch.serve.kv_compress over
repro_torch.stream) against the reference's.  Omega differs by design (the
port draws from the counter lattice), so the parity tests patch the port's
per-head Omega to the reference's draws — as the HOSVD tests patch the mode
keys — and then hold sketch rows to 1e-5 and reconstructions us @ vt to
1e-4 (the factors themselves carry SVD sign freedom)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import stream as rstream
from repro.core import projection as rproj
from repro.serve import kv_compress as rkv
from repro_torch import stream
from repro_torch.configs.base import smoke_config
from repro_torch.convert import from_reference, key_from_seed
from repro_torch.launch import serve as launch
from repro_torch.models import registry as R
from repro_torch.serve import kv_compress as kv
from repro_torch.serve.engine import Engine, Request

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

HEADS, HD, MAX_SEQ, RANK = 3, 16, 48, 4


def _hist(seed=4, heads=HEADS, rows=MAX_SEQ, hd=HD, rank=None):
    rng = np.random.default_rng(seed)
    if rank is None:
        return rng.standard_normal((heads, rows, hd)).astype(np.float32)
    a = rng.standard_normal((heads, rows, rank)) @ rng.standard_normal((heads, rank, hd))
    return (a + 1e-3 * rng.standard_normal((heads, rows, hd))).astype(np.float32)


def _ref_state_and_patched_port(spans, hist):
    """Reference head-batched state and a port state whose Omega is patched
    to the reference's per-head draws, both fed ``spans`` of ``hist``."""
    ref = rkv.kv_sketch_init(jax.random.PRNGKey(11), HEADS, HD, MAX_SEQ, RANK)
    p = kv._sketch_width(RANK, HD)
    omegas = [np.asarray(rproj.materialize_omega(
        rstream.state._typed_key(ref.key_omega[h]), (HD, p), dtype=jnp.bfloat16))
        for h in range(HEADS)]
    port = kv.kv_sketch_init(key_from_seed(11), HEADS, HD, MAX_SEQ, RANK,
                             device="cpu")
    port.omega = torch.stack([from_reference(o) for o in omegas])
    for start, length in spans:
        rows = hist[:, start:start + length]
        ref = rkv.kv_sketch_append(ref, jnp.asarray(rows), start)
        port = kv.kv_sketch_append(port, torch.tensor(rows), start)
    return ref, port


SPANS = [[(0, 20)], [(0, 3), (3, 16), (19, 1), (20, 1), (21, 9)],
         [(0, 48)]]


@pytest.mark.parametrize("spans", SPANS, ids=["prompt", "prompt+decode", "full"])
def test_sketch_rows_match_reference(spans):
    hist = _hist()
    ref, port = _ref_state_and_patched_port(spans, hist)
    np.testing.assert_allclose(port.y.numpy(), np.asarray(ref.y), rtol=1e-5,
                               atol=1e-5)
    assert port.rows_seen == int(np.asarray(ref.rows_seen).max())


@pytest.mark.parametrize("spans", SPANS, ids=["prompt", "prompt+decode", "full"])
@pytest.mark.parametrize("low_rank", [False, True])
def test_factors_reconstruct_like_reference(spans, low_rank):
    hist = _hist(rank=RANK if low_rank else None)
    ref, port = _ref_state_and_patched_port(spans, hist)
    f_ref = rkv.kv_sketch_factor(ref, jnp.asarray(hist), RANK)
    f = kv.kv_sketch_factor(port, torch.tensor(hist), RANK)
    assert tuple(f.us.shape) == f_ref.us.shape and tuple(f.vt.shape) == f_ref.vt.shape
    want = np.einsum("hsr,hrd->hsd", np.asarray(f_ref.us), np.asarray(f_ref.vt))
    np.testing.assert_allclose((f.us @ f.vt).numpy(), want, rtol=1e-4, atol=1e-4)


def test_unseen_rows_are_masked():
    """Rows the sketch never saw (stale cache content) do not reach the
    factors: the us rows there are zero."""
    hist = _hist()
    _, port = _ref_state_and_patched_port([(0, 20)], hist)
    dirty = hist.copy()
    dirty[:, 20:] = 99.0
    f = kv.kv_sketch_factor(port, torch.tensor(dirty), RANK)
    f_clean = kv.kv_sketch_factor(port, torch.tensor(hist), RANK)
    np.testing.assert_array_equal(f.us.numpy(), f_clean.us.numpy())
    assert float(f.us[:, 20:].abs().max()) == 0.0


def test_batched_state_draws_row_blocks_of_one_lattice():
    """Head h of a batched state gets rows [h*hd, (h+1)*hd) of one Omega
    drawn from the state's key."""
    from repro_torch.core import projection as proj
    key = key_from_seed(5)
    st = stream.init(key, HD, 6, max_rows=8, heads=HEADS, device="cpu")
    big = proj.materialize_omega(key, (HEADS * HD, 6), device="cpu")
    for h in range(HEADS):
        assert torch.equal(st.omega[h], big[h * HD:(h + 1) * HD])


def test_small_helpers_match_reference():
    for rank, hd in ((4, 16), (32, 128), (16, 16), (128, 128)):
        assert kv._sketch_width(rank, hd) == rkv._sketch_width(rank, hd)
    assert kv.factor_bytes(100, 32, 128) == rkv.factor_bytes(100, 32, 128)


def test_compress_matrix_and_factored_scores():
    m = torch.tensor(_hist(rank=RANK)[0])
    f = kv.compress_matrix(key_from_seed(2), m, RANK)
    assert float(kv.compression_error(m, f)) < 1e-2
    q = torch.randn(3, HD)
    torch.testing.assert_close(kv.factored_scores(q, f), q @ kv.reconstruct(f).T,
                               rtol=1e-5, atol=1e-4)


def test_append_errors():
    st = kv.kv_sketch_init(key_from_seed(1), 2, 16, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="absolute history offset"):
        kv.kv_sketch_append(st, torch.zeros(2, 4, 16), 6)
    with pytest.raises(ValueError, match="n_heads, T, head_dim"):
        kv.kv_sketch_append(st, torch.zeros(4, 16), 0)
    with pytest.raises(ValueError, match="heads= batches right sketches only"):
        stream.init(key_from_seed(1), 16, 4, max_rows=8, method="shgemm_fused",
                    left=True, heads=2, device="cpu")
    with pytest.raises(ValueError, match="cannot widen a head-batched state"):
        kv.kv_sketch_init(key_from_seed(1), 2, 16, 8, 4, method="shgemm_fused",
                          device="cpu").widen(2)


@pytest.mark.parametrize("dist", ["gaussian", "very_sparse"])
def test_fused_head_batched_sketch_streams_as_one_shot(dist):
    """``kv_sketch_init(method="shgemm_fused")`` (an option of the
    reference's): head h hashes Omega's rows [h*hd, (h+1)*hd) in kernel 2
    (its plain version here).  Rows appended in the engine's 16-row flushes
    and a ragged tail equal, per head, one kernel-2 call over the whole
    history at that row offset and its plain version."""
    from repro_torch.kernels import shgemm_fused as k2
    hist = torch.tensor(_hist(seed=6))
    key = key_from_seed(9)
    if dist == "gaussian":
        st = kv.kv_sketch_init(key, HEADS, HD, MAX_SEQ, RANK,
                               method="shgemm_fused", device="cpu")
    else:
        st = stream.init(key, HD, kv._sketch_width(RANK, HD), max_rows=MAX_SEQ,
                         method="shgemm_fused", dist=dist, heads=HEADS,
                         device="cpu")
    assert st.omega is None and tuple(st.y.shape) == (HEADS, MAX_SEQ, st.p)
    for start, n in ((0, 16), (16, 16), (32, 5), (37, 11)):
        st = kv.kv_sketch_append(st, hist[:, start:start + n], start)
    s = k2._resolve_s(dist, None, HD)
    for h in range(HEADS):
        one = stream.state.fused_at_row_offset(hist[h], key, st.p, h * HD,
                                               dist=dist, s=s)
        plain = k2.shgemm_fused_plain(hist[h], key, st.p, dist=dist, s=s,
                                      row_offset=h * HD)
        torch.testing.assert_close(st.y[h], one, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(st.y[h], plain, rtol=1e-6, atol=1e-6)
    assert not torch.equal(st.y[0], st.y[1])          # heads on other rows


class _RecordingEngine(Engine):
    """Snapshots every row span fed to the sketches (the true rows, before a
    swap zeroes them), so a fresh state can replay the identical stream."""

    def __init__(self, *a, **kw):
        self.recorded = {}
        super().__init__(*a, **kw)

    def _append_slot_sketches(self, slot, start, length):
        for path in self._kv_paths:
            rows = self._kv_leaf_rows(path, slot, start, length).clone()
            self.recorded.setdefault((slot, path), []).append((start, rows))
        super()._append_slot_sketches(slot, start, length)


def test_incremental_append_and_factor_bitwise_equal_recompute_after_swap():
    """After swap-ins (dense prefix zeroed, tail appended at absolute
    offsets) the engine's incremental sketch equals a fresh state replaying
    the same rows bit for bit, and so do the factors finalized against the
    engine's post-swap history (the twin of the reference's
    test_kv_factors_bitwise_equal_full_recompute_after_swap)."""
    cfg = smoke_config(R.get_arch("qwen3-0.6b"))
    params = launch.init_weights(cfg, seed=0, device="cpu")
    eng = _RecordingEngine(cfg, params, slots=1, max_seq=64, kv_sketch_rank=RANK,
                           kv_compress_ratio=2.0, device="cpu")
    eng.submit(Request(rid=0, prompt=[5, 7, 11], max_new=24))
    eng.run()
    assert eng._kv_comp_len[0] > 0, "slot never swapped"
    facs = eng.kv_factors(0)
    for j, path in enumerate(eng._kv_paths):
        spans = eng.recorded[(0, path)]
        heads, d = spans[0][1].shape[0], spans[0][1].shape[-1]
        st = kv.kv_sketch_init(eng._slot_key(0, j), heads, d, eng.max_seq, RANK,
                               device="cpu")
        for start, rows in spans:
            st = kv.kv_sketch_append(st, rows, start)
        assert torch.equal(st.y, eng._kv_sketches[0][path].y), path
        ref = kv.kv_sketch_factor(st, eng._kv_hist(0, path), RANK)
        assert torch.equal(facs[path].us, ref.us), path
        assert torch.equal(facs[path].vt, ref.vt), path
