"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled for Hopper (``sm_90a``) into a shared library
under ``csrc/build/``, named by a hash of the source and the flags, so a
changed source builds anew and an unchanged one is loaded as it is. The
build writes a temporary file and renames it, so processes that build at
the same time do not see a half-written library. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
the library as ``<library>.log``. A variant of a kernel (its source text
with some lines changed, as the variants tools time them) builds the same
way from that text.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

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


def library_path(name: str, source: Optional[str] = None) -> str:
    """Path of the shared library that ``csrc/<name>.cu``, or ``source``
    in its place, builds into."""
    if source is None:
        with open(os.path.join(CSRC_DIR, f"{name}.cu")) as f:
            source = f.read()
    digest = hashlib.sha256((source + " ".join(NVCC_FLAGS)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def load(name: str, source: Optional[str] = None) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it.
    Given ``source``, a variant of that file's text, build that instead."""
    lib = library_path(name, source)
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        if source is not None:
            src = f"{lib[:-3]}.cu"
            with open(src, "w") as f:
                f.write(source)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} "
                               f"(rc={r.returncode}):\n{r.stderr}")
        with open(f"{lib}.log", "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)
