"""What the kernels' variants tools (``cqt_octave_variants``,
``int8_gemm_variants``) share.

A variant is a kernel's source, ``csrc/<kernel>.cu``, with a few lines
replaced. The variants are built together through ``_build.load``, each
swapped in for the kernel's library of its wrapper module while the tool
runs the wrapper on it, and timed with CUDA events.
"""

import contextlib
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from . import _build


def source(kernel, replacements):
    """``csrc/<kernel>.cu`` with each (old, new) text replaced; raises if an
    old text is no longer in the source."""
    with open(os.path.join(_build.CSRC_DIR, f"{kernel}.cu")) as f:
        src = f.read()
    for old, new in replacements:
        if old not in src:
            raise ValueError(f"{kernel}.cu: {old!r} not in the source")
        src = src.replace(old, new)
    return src


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]


def build(module, kernel, variants, names):
    """Checks that there is a CUDA card and that each name is in
    ``variants``; builds those variants of ``kernel``, all started
    together, through ``module._lib``. Returns {name: library}."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants run on the card")
    unknown = set(names) - set(variants)
    if unknown:
        raise ValueError(f"no variants {sorted(unknown)}; there are "
                         f"{list(variants)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(
            lambda name: module._lib(source(kernel, variants[name])),
            names)))
    print(f"{len(libs)} variants of {kernel}.cu built in "
          f"{time.perf_counter() - t0:.1f} s; {card()}")
    return libs


@contextlib.contextmanager
def using(module, lib):
    """Runs the body with ``lib`` in place of ``module``'s kernel
    library."""
    default, module._lib = module._lib, lambda: lib
    try:
        yield
    finally:
        module._lib = default


def cuda_ms(fn, reps, warmup):
    """Mean device time of ``fn()`` in ms over ``reps`` calls after
    ``warmup``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
