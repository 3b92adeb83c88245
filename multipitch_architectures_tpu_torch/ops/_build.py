"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled for Hopper (``sm_90a``) into a shared library
under ``csrc/build/``, named by a hash of the source and the flags, so a
changed source builds anew and an unchanged one is loaded as it is. The
build writes a temporary file and renames it, so processes that build at
the same time do not see a half-written library. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
the library as ``<library>.log``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    """Path of the shared library that ``csrc/<name>.cu`` builds into."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    lib = library_path(name)
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(rc={r.returncode}):\n{r.stderr}")
        with open(f"{lib}.log", "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)
