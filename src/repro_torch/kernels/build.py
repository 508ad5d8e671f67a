"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library at first use and
loaded with ``ctypes``; nothing includes PyTorch's headers, so a build
takes seconds. A library is named by a hash of its source and the flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Libraries go to ``build/repro_torch_kernels/`` at the root of a source
checkout (the package at ``src/repro_torch`` beside ``pyproject.toml``),
and to ``build/`` inside this directory for an installed package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_HERE = pathlib.Path(__file__).resolve().parent
_CHECKOUT = _HERE.parents[2]
CSRC = _HERE / "csrc"
BUILD_DIR = (_CHECKOUT / "build" / "repro_torch_kernels"
             if _HERE.parents[1].name == "src"
             and (_CHECKOUT / "pyproject.toml").is_file()
             else _HERE / "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_FUNCS: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    # torch's search: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = shutil.which("nvcc") or os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels are built at first use")
    return nvcc


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is built already;
    returns the library's path."""
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha1(src.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    tmp.replace(out)            # atomic: a reader never sees half a file
    return out


def sources() -> list[str]:
    """The names of every ``csrc/*.cu``, for a caller that builds them,
    one ``build`` each (threads may build different sources at once)."""
    return [src.stem for src in sorted(CSRC.glob("*.cu"))]


def load(name: str, argtypes, source: str | None = None) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<source>.cu`` (``source``
    defaults to ``name``; built first if needed), with ``argtypes``
    declared and a ``cudaError_t`` result."""
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build(source or name))), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn
