"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each source under ``paddle_tpu_torch/csrc/`` is compiled on first use into
a shared library with a plain C interface, for ``sm_90a`` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build dir>/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, of every header under
``csrc/`` (``*.cuh``) and of the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is. nvcc's output (ptxas's
registers and spills per kernel) is kept beside the library as
``<name>-<hash>.so.log``, so a library found built still has its log. The
build directory is ``paddle_tpu_torch/_build/`` (ignored by git), or
``$PADDLE_TPU_TORCH_BUILD_DIR``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    return os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR") or \
        os.path.join(_PKG, "_build")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built: the name carries a hash of the
    source, of every ``csrc/*.cuh`` header (name and bytes) and of the
    flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    return os.path.join(build_dir(), f"{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns (library path, nvcc's output). nvcc's output lists each
    kernel's registers, shared memory and spills; for a library found
    built it is the log kept beside it, or "" if it has none."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = library_path(name)
    if os.path.exists(out):
        try:
            with open(f"{out}.log") as f:
                return out, f.read()
        except FileNotFoundError:
            return out, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels of paddle_tpu_torch are built at first use")
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    # the log first: a library that exists always has its log
    with open(f"{out}.log", "w") as f:
        f.write(proc.stdout)
    os.replace(tmp, out)
    return out, proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building it first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build(name)[0])
    return _LIBS[name]
