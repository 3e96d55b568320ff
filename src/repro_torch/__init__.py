"""PyTorch + CUDA port of the mixed-precision random projection for RandNLA.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``core/``, ``kernels/``, ``configs/``, ``models/``, ``serve/``,
``stream/``, ``launch/``) and its function names, and runs on an NVIDIA
Hopper card.  Its four kernels (the two projection GEMMs, causal flash
attention and factored-prefix decode attention) are hand-written CUDA C++
(``kernels/csrc/``), built with ``nvcc`` at first use.

Entry points take ``device=None``, which means ``"cuda"``; without CUDA they
raise unless the caller passes ``device="cpu"``, where every kernel wrapper
runs its plain PyTorch version instead.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
