"""The port's main path end to end: rSVD (paper Algorithm 1) on the §5.1.1
A_exp and A_linear matrices and RP-HOSVD / RP-ST-HOSVD (Algorithm 2) on an
Algorithm 3 tensor, each through the f32 baseline and the mixed-precision
methods, with the reference's accuracy limits.

The streamed and structured runs (``streamed_sketch``,
``rsvd_streamed_error``, ``sthosvd_streamed_error``, ``low_rank_plus_noise``)
drive the out-of-core path: row tiles through ``repro_torch.stream`` and
kernel 2 at lattice offsets, SRHT and Khatri-Rao Omega.  The fault-tolerance
runs (``resume_after_fault``, ``memmap_rsvd_job``) drive the checkpointed
streamed drivers through ``stream.resilience``.

``chip_smoke.py`` runs it at the paper's sizes on the card; the CPU tests
run it at small sizes with ``device="cpu"``.
"""

from __future__ import annotations

import torch

from repro_torch import stream
from repro_torch.convert import key_from_seed
from repro_torch.core import hosvd, rsvd
from repro_torch.device import resolve_device
from repro_torch.stream.resilience import FaultInjected, FaultySource

RSVD_METHODS = ("f32", "shgemm", "shgemm_pallas", "shgemm_fused")
# The streamed path's methods: kernel 2 at lattice offsets, and kernel 1 on
# a materialized Omega.
STREAMED_METHODS = ("shgemm_fused", "shgemm_pallas")
HOSVD_METHODS = ("f32", "shgemm_pallas", "shgemm_fused")
HOSVD_ALGOS = {"rp_hosvd": hosvd.rp_hosvd, "rp_sthosvd": hosvd.rp_sthosvd}
SPECTRA = {"exp": rsvd.singular_values_exp,
           "linear": rsvd.singular_values_linear}


def rsvd_inputs(cfg, *, seed: int = 0, device=None) -> dict[str, torch.Tensor]:
    """The A_exp and A_linear test matrices of size ``cfg.n``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {name: rsvd.matrix_with_singular_values(
                gen, cfg.n, spectrum(cfg.n, cfg.rank, cfg.s_p, device=dev))
            for name, spectrum in SPECTRA.items()}


def hosvd_input(cfg, *, seed: int = 0, device=None) -> torch.Tensor:
    """The Algorithm 3 tensor of ``cfg.dims`` with multilinear rank
    ``cfg.ranks - cfg.pad``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return hosvd.make_test_tensor(gen, cfg.dims, cfg.ranks, cfg.pad)


def rsvd_error(a: torch.Tensor, cfg, method: str, key) -> float:
    res = rsvd.rsvd(key, a, cfg.rank, oversample=cfg.oversample,
                    power_iters=cfg.power_iters, method=method,
                    device=a.device)
    return float(rsvd.reconstruction_error(a, res))


def hosvd_error(t: torch.Tensor, cfg, algo: str, method: str, key) -> float:
    res = HOSVD_ALGOS[algo](key, t, tuple(cfg.ranks), method=method,
                            device=t.device)
    return float(hosvd.reconstruction_error(t, res))


def run_main_path(rsvd_cfg, hosvd_cfg, *, seed: int = 0,
                  device=None) -> dict[tuple[str, str, str], float]:
    """Relative reconstruction error of every (algorithm, input, method)."""
    dev = resolve_device(device)
    key = key_from_seed(seed + 1)
    errors = {}
    for name, a in rsvd_inputs(rsvd_cfg, seed=seed, device=dev).items():
        for method in RSVD_METHODS:
            errors[("rsvd", name, method)] = rsvd_error(a, rsvd_cfg, method, key)
    t = hosvd_input(hosvd_cfg, seed=seed, device=dev)
    for algo in HOSVD_ALGOS:
        for method in HOSVD_METHODS:
            errors[(algo, "tensor", method)] = hosvd_error(t, hosvd_cfg, algo,
                                                           method, key)
    return errors


def error_limit(algo: str, f32_error: float) -> float:
    """The reference's limits: rSVD within 1.5x of f32 (+1e-7), HOSVD within
    max(5x f32, 2e-5) (tests/test_rsvd.py, tests/test_hosvd_lstsq.py)."""
    if algo == "rsvd":
        return 1.5 * f32_error + 1e-7
    return max(5.0 * f32_error, 2e-5)


def check_errors(errors: dict[tuple[str, str, str], float]) -> list[str]:
    """Failures of each method against its own run's f32 baseline."""
    failures = []
    for (algo, case, method), err in errors.items():
        base = errors[(algo, case, "f32")]
        limit = error_limit(algo, base)
        if not err <= limit:
            failures.append(f"{algo}/{case}/{method}: error {err:.3e} > "
                            f"limit {limit:.3e} (f32 {base:.3e})")
    return failures


def streamed_sketch(key, source, p: int, *, left: bool = False,
                    device=None) -> stream.SketchState:
    """The kernel-2 sketch state of a matrix streamed from ``source`` (a
    TileSource) in its row tiles, prefetched to ``device``."""
    dev = resolve_device(device)
    st = stream.init(key, source.n_cols, p, max_rows=source.n_rows, left=left,
                     method="shgemm_fused", device=dev)
    for off, tile in stream.offset_tiles(source, device=dev):
        stream.update(st, tile, off)
    return st


def rsvd_streamed_error(a: torch.Tensor, source, cfg, method: str, key, *,
                        passes: int = 2, rank: int | None = None,
                        **kw) -> tuple[float, rsvd.SVDResult]:
    """Relative reconstruction error of ``rsvd_streamed`` over ``source``
    (the tiles of ``a``), with the result; ``kw`` goes to the driver
    (``tol=``, ``return_info=``, ...): with ``return_info`` the result is
    the (SVDResult, AdaptiveInfo) pair."""
    out = rsvd.rsvd_streamed(key, source, rank or cfg.rank,
                             oversample=cfg.oversample, passes=passes,
                             method=method, device=a.device, **kw)
    res = out[0] if kw.get("return_info") else out
    return float(rsvd.reconstruction_error(a, res)), out


def sthosvd_streamed_error(t: torch.Tensor, cfg, method: str, dist: str, key,
                           *, slab_rows: int) -> float:
    """Relative reconstruction error of ``rp_sthosvd_streamed`` over the
    axis-0 slabs of ``t``."""
    res = hosvd.rp_sthosvd_streamed(key, stream.ArraySource(t, slab_rows),
                                    ranks=tuple(cfg.ranks), method=method,
                                    dist=dist, device=t.device)
    return float(hosvd.reconstruction_error(t, res))


def low_rank_plus_noise(gen: torch.Generator, m: int, n: int, rank: int,
                        noise: float) -> torch.Tensor:
    """An (m, n) f32 matrix U diag(s) V^T + noise on ``gen.device``: rank
    ``rank`` with s_i = 2^(-i/32), orthonormal-ish Gaussian factors, plus
    i.i.d. noise of standard deviation ``noise`` per element."""
    dev = gen.device
    u = torch.randn((m, rank), generator=gen, device=dev) / m ** 0.5
    v = torch.randn((rank, n), generator=gen, device=dev) / n ** 0.5
    s = torch.exp2(-torch.arange(rank, dtype=torch.float32, device=dev) / 32)
    a = (u * s) @ v
    a += noise * torch.randn((m, n), generator=gen, device=dev)
    return a


def resume_after_fault(job, source, *, fail_at_tile: int, checkpoint_dir,
                       checkpoint_every_tiles: int):
    """Run ``job(source, **checkpoint kwargs)`` (a checkpointed streamed
    driver) with a ``FaultySource`` that raises at tile ``fail_at_tile``
    (counted across passes), then resume it on ``source``; returns the
    resumed run's ``(result, ResilienceReport)``.  Raises if the fault never
    fired."""
    kw = dict(checkpoint_dir=checkpoint_dir,
              checkpoint_every_tiles=checkpoint_every_tiles, resume=True)
    try:
        job(FaultySource(source, fail_at_tile=fail_at_tile, mode="raise"),
            **kw)
    except FaultInjected:
        pass
    else:
        raise RuntimeError(f"the fault at tile {fail_at_tile} never fired")
    return job(source, return_report=True, **kw)


def memmap_rsvd_job(key, path, rank: int, *, tile_rows: int, checkpoint_dir,
                    checkpoint_every_tiles: int, kill_at_tile: int | None = None,
                    device=None):
    """The out-of-core job of the kill-and-resume runs: ``rsvd_streamed``
    (kernel 2, passes=2, oversample 10) over the ``.npy`` file ``path``
    through ``MemmapSource``, checkpointed under ``checkpoint_dir`` with
    ``resume=True`` (so one call serves the first attempt and every retry).
    ``kill_at_tile`` SIGKILLs the process at that tile (``FaultySource``
    mode "kill").  Returns ``(SVDResult, ResilienceReport)``."""
    src = stream.MemmapSource(path, tile_rows)
    if kill_at_tile is not None:
        src = FaultySource(src, fail_at_tile=kill_at_tile, mode="kill")
    return rsvd.rsvd_streamed(key, src, rank, oversample=10, passes=2,
                              method="shgemm_fused",
                              checkpoint_dir=checkpoint_dir,
                              checkpoint_every_tiles=checkpoint_every_tiles,
                              resume=True, return_report=True, device=device)
