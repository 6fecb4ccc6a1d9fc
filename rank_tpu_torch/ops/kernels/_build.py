"""Build the hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``. The library
does not include PyTorch's headers, so a build takes seconds rather than
the minutes a ``torch.utils.cpp_extension`` build takes. Outputs go to
``_build/`` beside this file (listed in ``.gitignore``), named by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"

# sm_90a keeps Hopper's wgmma/setmaxnreg available; no --use_fast_math, so
# division, sqrt and exp keep their IEEE behaviour.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as torch locates it, else
    the one on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path and the compiler's report (empty when nothing was built)."""
    lib = library_path(name)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))
