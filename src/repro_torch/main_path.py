"""The port's main path end to end: rSVD (paper Algorithm 1) on the §5.1.1
A_exp and A_linear matrices and RP-HOSVD / RP-ST-HOSVD (Algorithm 2) on an
Algorithm 3 tensor, each through the f32 baseline and the mixed-precision
methods, with the reference's accuracy limits.

``chip_smoke.py`` runs it at the paper's sizes on the card; the CPU tests
run it at small sizes with ``device="cpu"``.
"""

from __future__ import annotations

import torch

from repro_torch.convert import key_from_seed
from repro_torch.core import hosvd, rsvd
from repro_torch.device import resolve_device

RSVD_METHODS = ("f32", "shgemm", "shgemm_pallas", "shgemm_fused")
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
