"""Build and load the hand-written CUDA kernels (plain C ABI, ``ctypes``).

Each library is one ``nvcc`` invocation of one ``csrc/*.cu`` source into a
shared object under ``_build/`` (git-ignored), named by a hash of every
source and header in ``csrc/`` and of the flags, so a stale library is never
loaded.  Nothing is built at import: the first launch builds what it needs,
and ``build()`` builds every library at once, one ``nvcc`` each, all started
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")

# One shared object per kernel module.  No --use_fast_math: the fused
# kernel's Gaussian needs accurate logf/cosf/sqrtf, the attention kernels
# accurate expf/tanhf.
SOURCES = {"shgemm": "shgemm.cu", "shgemm_fused": "shgemm_fused.cu",
           "flash_attention": "flash_attention.cu",
           "factored_decode": "factored_decode.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then nvcc on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(SOURCES[name].encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Build the missing libraries in parallel; return each one's compiler
    log (``-Xptxas -v``: registers, shared memory, spills).  Raises with the
    compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    procs = {}
    logs = {}
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.is_file():
            logs[name] = log.read_text() if log.is_file() else ""
            continue
        compiler = compiler or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(text)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.is_file():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
