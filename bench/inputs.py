"""The test inputs of the paper's experiments, frozen for the benchmark.

``a_exp``: the n x n matrix U diag(s) V^T of §5.1.1 with the A_exp spectrum
s_i = 2^(-alpha i), alpha = log2(1 / s_p) / p, and U, V the Q factors of two
Gaussian matrices.  ``algorithm3``: the low-multilinear-rank tensor of the
paper's Algorithm 3.  Both draw from one ``torch.Generator`` on the device
where the input is wanted, in f32 with TF32 off, in a few large calls.
They import nothing of the program.
"""

from __future__ import annotations

import torch


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def _unif(gen: torch.Generator, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return u * 2.0 - 1.0


def exp_spectrum(n: int, p: int, s_p: float, device=None) -> torch.Tensor:
    """s_i = 2^(-alpha i) for i < n, alpha = log2(1 / s_p) / p, in f32."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    alpha = torch.log2(torch.tensor(1.0 / s_p, dtype=torch.float32,
                                    device=device)) / p
    return torch.exp2(-alpha * i)


def a_exp(gen: torch.Generator, n: int, rank: int, s_p: float) -> torch.Tensor:
    """The A_exp test matrix: U diag(s) V^T."""
    s = exp_spectrum(n, rank, s_p, device=gen.device)
    u, _ = torch.linalg.qr(_randn(gen, (n, n)))
    v, _ = torch.linalg.qr(_randn(gen, (n, n)))
    return torch.matmul(u * s[None, :], v.T)


def unfold(t: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-k unfolding (I_k, prod of the other dims), the others in order."""
    perm = (mode,) + tuple(i for i in range(t.ndim) if i != mode)
    return t.permute(perm).reshape(t.shape[mode], -1)


def fold(m: torch.Tensor, mode: int, shape) -> torch.Tensor:
    full = (shape[mode],) + tuple(s for i, s in enumerate(shape) if i != mode)
    inv = list(range(1, mode + 1)) + [0] + list(range(mode + 1, len(shape)))
    return m.reshape(full).permute(inv)


def mode_dot(t: torch.Tensor, m: torch.Tensor, mode: int, mm=torch.matmul):
    """T x_k M for M of shape (J, I_k): M . T_(k), folded back."""
    shape = list(t.shape)
    shape[mode] = m.shape[0]
    return fold(mm(m, unfold(t, mode)), mode, shape)


def algorithm3(gen: torch.Generator, dims, ranks, pad: int) -> torch.Tensor:
    """G ~ U(-1, 1) of shape ``ranks``; each mode contracted with the rank
    J_i - pad matrix Omega_b . Omega_a (U(-1, 1) entries), J_i -> I_i."""
    g = _unif(gen, tuple(ranks))
    for i, (ii, ji) in enumerate(zip(dims, ranks)):
        oa = _unif(gen, (ji - pad, ji))
        ob = _unif(gen, (ii, ji - pad))
        g = mode_dot(g, torch.matmul(ob, oa), i)
    return g.contiguous()


def make_pool(config: dict, seed: int, device) -> list[torch.Tensor]:
    """The ``config["pool"]`` inputs of a run, from one generator seeded
    with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kind = config["input"]
    if kind == "a_exp":
        return [a_exp(gen, config["n"], config["rank"], config["s_p"])
                for _ in range(config["pool"])]
    if kind == "algorithm3":
        dims = config["dims"]
        ranks = hosvd_ranks(config)
        return [algorithm3(gen, dims, ranks, config["pad"])
                for _ in range(config["pool"])]
    raise ValueError(f"unknown input kind {kind!r}")


def hosvd_ranks(config: dict) -> list[int]:
    """Each mode's target rank, as the configuration states it."""
    ranks = [int(r) for r in config["ranks"]]
    if len(ranks) != len(config["dims"]):
        raise ValueError(f"ranks {ranks} do not match dims {config['dims']}")
    return ranks
