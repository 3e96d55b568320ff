"""Carry the reference's state across: keys, arrays and model weights.

What crosses from the JAX package is its PRNG key (as the (1, 2) uint32 key
words its fused kernel hashes), its arrays (inputs, a materialized Omega,
results) as numpy arrays, the transformer's flat parameter dict
(``params_from_reference``) and an optimizer's state
(``opt_state_from_reference``): with both, a run started in the reference
continues in the port on the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.shgemm_fused import key_pair

# numpy dtypes that torch.from_numpy rejects (ml_dtypes' extension types),
# by name: converted through an integer view of the same width.
_VIEW_DTYPES = {
    ("bfloat16", 2): (np.int16, torch.bfloat16),
    ("float8_e4m3fn", 1): (np.int8, torch.float8_e4m3fn),
    ("float8_e5m2", 1): (np.int8, torch.float8_e5m2),
}


def key_from_seed(seed: int) -> tuple[int, int]:
    """The key words of the reference's ``jax.random.PRNGKey(seed)``:
    ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def key_words_from_numpy(words: np.ndarray) -> tuple[int, int]:
    """(k0, k1) from the reference's ``key_words`` as a (1, 2) uint32 array."""
    words = np.asarray(words)
    if words.size != 2:
        raise ValueError(f"key words must hold 2 words, got shape {words.shape}")
    return key_pair(words.astype(np.uint32))


def from_reference(x) -> torch.Tensor:
    """A reference array (``np.asarray(jax_array)``) as a CPU tensor of the
    same dtype, without importing ``ml_dtypes``: bf16 and fp8 arrays go
    through an integer view of the same width."""
    x = np.ascontiguousarray(np.asarray(x))
    view = _VIEW_DTYPES.get((x.dtype.name, x.dtype.itemsize))
    if view is not None:
        int_dtype, torch_dtype = view
        return torch.from_numpy(x.view(int_dtype).copy()).view(torch_dtype)
    return torch.from_numpy(x.copy())


def params_from_reference(params: dict, cfg, *, device=None) -> dict:
    """The port's parameters from the reference's flat dict
    ``{"layers/p0/attn/wq": (periods, D, H, hd), ...}`` of numpy arrays.
    The port keeps the reference's names, stacked scan leaves and layouts,
    so each leaf crosses as it is; names and shapes are checked against the
    port's schema."""
    from repro_torch.models.transformer import schema
    defs = schema(cfg)
    if set(params) != set(defs):
        raise ValueError(f"parameter names differ from the schema: missing "
                         f"{sorted(set(defs) - set(params))}, extra "
                         f"{sorted(set(params) - set(defs))}")
    out = {}
    for name, arr in params.items():
        t = from_reference(arr)
        if tuple(t.shape) != defs[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != schema "
                             f"{defs[name].shape}")
        out[name] = t if device is None else t.to(device)
    return out


# Top-level leaves of an optimizer state that the port keeps on the CPU:
# the step counters (read on the host) and GaLore's key words.
_HOST_LEAVES = ("t", "key", "step")


def opt_state_from_reference(state, *, device=None):
    """The port's optimizer state from the reference's: an AdamW, Adafactor
    or SGD state dict, a GaLore state (``{"leaves": {name: _Leaf(proj, m,
    v)}, "t", "key"}``) or a ``compression.CompressionState``, with jax or
    numpy arrays as leaves.  Leaves keep their dtype; the step counters and
    GaLore's key words stay on the CPU (where the port's optimizers keep
    them), every other leaf goes to ``device`` (the CPU if None)."""
    from repro_torch.optim.compression import CompressionState
    from repro_torch.optim.galore import _Leaf

    def conv(x, host: bool):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v, False) for k, v in x.items()}
        fields = getattr(x, "_fields", None)
        if fields == _Leaf._fields:
            return _Leaf(*(conv(v, False) for v in x))
        if fields is not None:
            raise ValueError(f"unknown optimizer state node {type(x).__name__}"
                             f"{fields}")
        t = from_reference(x)
        return t if host or device is None else t.to(device)

    if getattr(state, "_fields", None) == CompressionState._fields:
        return CompressionState(conv(state.residual, False),
                                conv(state.step, True))
    if not isinstance(state, dict):
        raise ValueError(f"unknown optimizer state {type(state).__name__}")
    return {k: conv(v, k in _HOST_LEAVES) for k, v in state.items()}
