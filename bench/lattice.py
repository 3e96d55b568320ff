"""The counter-hash lattice that defines Omega, frozen for the benchmark.

Every Omega element is a pure function of (key words, row, col): a murmur3
finalizer over the row and column hashes, uint32 arithmetic held in int64
and masked to 32 bits.  The Gaussian is Box-Muller in f32 over two draw
streams; per-mode HOSVD keys are the words of stream 6 at rows 0..N-1,
columns 0 and 1.  This copy is the yardstick's: the program may change how
it generates Omega, never what Omega is for a key.  It imports nothing of
the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_ROW_SALT = 0x9E3779B9
_COL_SALT = 0x7F4A7C15
_STREAM_SALT = 0x632BE59B
_MASK = 0xFFFFFFFF
_MODE_KEY_STREAM = 6


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), c split into 16-bit
    halves so that no intermediate passes 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def bits(k0: int, k1: int, rows: torch.Tensor, cols: torch.Tensor,
         stream: int) -> torch.Tensor:
    """uint32 words (in int64) at each broadcast (row, col) of ``stream``."""
    hr = _fmix32((_mul32(rows & _MASK, _ROW_SALT) + k0) & _MASK)
    salt = (stream * _STREAM_SALT + k1) & _MASK
    hc = _fmix32((_mul32(cols & _MASK, _COL_SALT) + salt) & _MASK)
    return _fmix32(hr ^ _mul32(hc, _M1))


def _uniform24(words: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    return (words >> 8).to(torch.float32) * float(2.0**-24) + offset


def gaussian(key: tuple[int, int], shape: tuple[int, int], *,
             dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """The key's N(0, 1) Omega of ``shape``, rounded to ``dtype`` (the type
    Omega is stored in) and returned in f32, where its values are exact."""
    k0, k1 = (int(w) & _MASK for w in key)
    k, n = shape
    rows = torch.arange(k, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    u1 = _uniform24(bits(k0, k1, rows, cols, 0), float(2.0**-25))
    u2 = _uniform24(bits(k0, k1, rows, cols, 1))
    two_pi = torch.tensor(np.float32(2.0 * math.pi), device=u2.device)
    vals = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
    return vals.to(dtype).to(torch.float32)


def mode_keys(key: tuple[int, int], ndim: int) -> list[tuple[int, int]]:
    """Mode i's key words: stream 6 of the key at (i, 0) and (i, 1)."""
    k0, k1 = (int(w) & _MASK for w in key)
    rows = torch.arange(ndim, dtype=torch.int64)[:, None]
    cols = torch.arange(2, dtype=torch.int64)[None, :]
    words = bits(k0, k1, rows, cols, _MODE_KEY_STREAM)
    return [tuple(int(w) for w in row) for row in words.tolist()]


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def call_key(seed: int, call: int) -> tuple[int, int]:
    """The fresh key of a run's call number ``call``: two words of a
    splitmix64 chain over the seed and the call."""
    h = _splitmix64(_splitmix64(int(seed) & 0xFFFFFFFFFFFFFFFF) ^ int(call))
    return (h >> 32) & _MASK, h & _MASK
