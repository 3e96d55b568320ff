"""The plain reference of each entry, and the numbers that decide ``correct``.

Paper Algorithm 1 (rSVD) and Algorithm 2 (RP-HOSVD, and its sequentially
truncated form) in plain PyTorch f32 with TF32 off: Omega from the frozen
lattice (``lattice.py``) at the key the program was given, stored in bf16 and
exact in f32, and every product an f32 ``torch.matmul``.  It imports nothing
of the program and takes nothing the program made but the outputs it judges.

``mm`` is the matrix product the reference runs with: ``matmul_f32`` for the
reference itself, ``matmul_tf32`` for the control, which rounds both operands
to TF32 (10 explicit mantissa bits, round to nearest even) and accumulates in
f32, as the tensor cores' TF32 mode does.
"""

from __future__ import annotations

import functools

import torch

from bench import inputs, lattice


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 explicit mantissa bits (RN-even);
    infinities and NaNs are not expected here."""
    w = x.contiguous().view(torch.int32)
    w = w + (0xFFF + ((w >> 13) & 1))
    return (w & ~0x1FFF).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32_round(a), tf32_round(b))


def _qr(y: torch.Tensor) -> torch.Tensor:
    q, _ = torch.linalg.qr(y)
    return q


def rsvd(a: torch.Tensor, key, traffic: dict, config: dict, mm=matmul_f32):
    """(U, s, V^T) of rank ``config["rank"]`` by Algorithm 1."""
    m, n = a.shape
    rank = config["rank"]
    p = min(rank + config["oversample"], m, n)
    omega = lattice.gaussian(key, (n, p), dtype=_dtype(traffic),
                             device=a.device)
    y = mm(a, omega)
    for _ in range(traffic.get("power_iters", 0)):
        q = _qr(y)
        q = _qr(mm(a.T, q))
        y = mm(a, q)
    q = _qr(y)
    u_b, s, vt = torch.linalg.svd(mm(q.T, a), full_matrices=False)
    u = mm(q, u_b)
    return u[:, :rank], s[:rank], vt[:rank, :]


def hosvd(t: torch.Tensor, key, traffic: dict, config: dict, mm=matmul_f32,
          *, sequential: bool = False):
    """(core, factors) by Algorithm 2; ``sequential`` sketches each mode on
    the core truncated so far (RP-ST-HOSVD)."""
    ranks = inputs.hosvd_ranks(config)
    keys = lattice.mode_keys(key, t.ndim)
    core, factors = t, []
    for i in range(t.ndim):
        src = core if sequential else t
        x = inputs.unfold(src, i)
        omega = lattice.gaussian(keys[i], (x.shape[1], ranks[i]),
                                 dtype=_dtype(traffic), device=t.device)
        q = _qr(mm(x, omega))
        del omega
        factors.append(q)
        if sequential:
            core = inputs.mode_dot(core, q.T, i, mm)
    if not sequential:
        for i, q in enumerate(factors):
            core = inputs.mode_dot(core, q.T, i, mm)
    return core, tuple(factors)


def _dtype(traffic: dict):
    return getattr(torch, traffic.get("omega_dtype", "bfloat16"))


REFERENCES = {"rsvd": rsvd, "rp_hosvd": hosvd,
              "rp_sthosvd": functools.partial(hosvd, sequential=True)}


# ---------------------------------------------------------------------------
# The numbers compared
# ---------------------------------------------------------------------------

def approximation(entry: str, out) -> torch.Tensor:
    """The approximation an output stands for: U diag(s) V^T, or the core
    multiplied back by its factors, in f32."""
    if entry == "rsvd":
        u, s, vt = out
        return torch.matmul(u * s[None, :], vt)
    core, factors = out
    for i, q in enumerate(factors):
        core = inputs.mode_dot(core, q, i)
    return core


def _rel(x: torch.Tensor, y: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x - y)
                 / torch.linalg.vector_norm(y))


def compare(entry: str, a: torch.Tensor, got, want) -> dict[str, float]:
    """For one call: ``gap``, the program's approximation's distance from
    the reference's, relative to the reference's; ``gap_over_err_ref``, that
    distance in units of the reference's own relative error of the input;
    ``s_gap`` (rSVD), the largest relative gap of a singular value; ``err``
    and ``err_ref``, each side's relative reconstruction error of the
    input."""
    approx, approx_ref = approximation(entry, got), approximation(entry, want)
    out = {"gap": _rel(approx, approx_ref), "err": _rel(approx, a),
           "err_ref": _rel(approx_ref, a)}
    out["gap_over_err_ref"] = out["gap"] / out["err_ref"]
    if entry == "rsvd":
        s, s_ref = got[1].to(torch.float64), want[1].to(torch.float64)
        out["s_gap"] = float(torch.max(torch.abs(s - s_ref) / s_ref))
    return out
