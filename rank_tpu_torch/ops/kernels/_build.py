"""Build, load, check and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``. The library
does not include PyTorch's headers, so a build takes seconds rather than
the minutes a ``torch.utils.cpp_extension`` build takes. Outputs go to
``_build/`` beside this file (listed in ``.gitignore``), named by a hash of
the source, every header in ``csrc/`` and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is.

Every entry point takes its operands' pointers, its sizes, a device index
and a stream, and returns a ``cudaError_t``; every library that includes
``csrc/common.cuh`` exports ``kernel_error_string`` for its codes.
``check_operands`` and ``launch`` are the one path from torch tensors to
such an entry point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

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
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


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


_loaded: Dict[str, ctypes.CDLL] = {}


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use and loaded
    once; ``signatures`` maps each entry point to its argument types (each
    returns an int)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[0]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    fn = lib.kernel_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return fn(code).decode()


def check_operands(who: str, named: Dict[str, Optional[torch.Tensor]]) -> None:
    """Raise unless every tensor of ``named`` (None for an absent one) is
    contiguous, float32 (int32 for ``lengths``) and on the first one's CUDA
    device. The device is checked last, so the other refusals show on CPU
    tensors too."""
    first_name = first = None
    for name, x in named.items():
        if x is None:
            continue
        want = torch.int32 if name == "lengths" else torch.float32
        if x.dtype != want:
            raise TypeError(f"{who}: {name} is {x.dtype}, needs {want}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
        if first is None:
            first_name, first = name, x
    for name, x in named.items():
        if x is not None and (x.device.type != "cuda" or x.device != first.device):
            raise ValueError(f"{who} needs every input on one CUDA device; "
                             f"{name} is on {x.device}, {first_name} on {first.device}")


def launch(lib: ctypes.CDLL, fn: str, device: torch.device, tensors: Sequence, sizes: Sequence,
           **shape) -> None:
    """Call the entry point ``fn`` with the data pointers of ``tensors``
    (None for a null one), then ``sizes``, ``device``'s index and its
    current stream; raise if the entry point refuses the launch or the
    launch fails, with the library's error and ``shape``."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    err = getattr(lib, fn)(*ptrs, *sizes, device.index,
                           torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        dims = ", ".join(f"{key}={value}" for key, value in shape.items())
        raise RuntimeError(f"{fn} launch failed: {error_string(lib, err)} ({dims})")
