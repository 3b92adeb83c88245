"""ctypes binding for the native window loader (``csrc/npy_loader.cpp``).

Counterpart of ``multipitch_architectures_tpu/io/native_loader.py``, on
the port's own copy of the C++ source. It exists for corpora that exceed
device memory: the ``.npy`` files stay mmapped on the host, a C++ thread
team assembles each batch of context windows, and only the assembled
``(B, 6, 75, 216)`` slab crosses to the device, the role the reference's
16 DataLoader worker processes played (exp180d…py:281-288). A background
thread prefetches the next batches while the device computes.

The library is compiled at first use with ``g++ -O3 -std=c++17 -fPIC
-shared -pthread`` into ``csrc/build/``, named by a hash of the source
and the flags; a failed build raises, and nothing falls back to a Python
loader.
"""

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SOURCE = os.path.join(_CSRC, "npy_loader.cpp")
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def build_native_library(force: bool = False) -> str:
    """Compile ``csrc/npy_loader.cpp`` unless its library exists (or
    ``force``); returns the library's path. The build writes a temporary
    file and renames it, so processes that build at once see no
    half-written library."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    lib = os.path.join(_CSRC, "build",
                       f"libmpe_loader_{digest.hexdigest()[:16]}.so")
    if force or not os.path.exists(lib):
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = f"{lib[:-3]}.{os.getpid()}.tmp.so"
        r = subprocess.run(["g++", *_FLAGS, _SOURCE, "-o", tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed for {_SOURCE} "
                               f"(rc={r.returncode}):\n{r.stderr}")
        os.replace(tmp, lib)
    return lib


def _load_lib():
    lib = ctypes.CDLL(build_native_library())
    lib.mpe_dataset_create.restype = ctypes.c_void_p
    lib.mpe_dataset_create.argtypes = [ctypes.c_int] * 4
    lib.mpe_dataset_add_file.restype = ctypes.c_long
    lib.mpe_dataset_add_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_char_p]
    lib.mpe_dataset_num_windows.restype = ctypes.c_long
    lib.mpe_dataset_num_windows.argtypes = [ctypes.c_void_p]
    lib.mpe_dataset_error.restype = ctypes.c_char_p
    lib.mpe_dataset_error.argtypes = [ctypes.c_void_p]
    lib.mpe_dataset_fill_batch.restype = ctypes.c_int
    lib.mpe_dataset_fill_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int]
    lib.mpe_dataset_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _prefetched(items, prefetch: int):
    """Iterate ``items`` in a background thread, at most ``prefetch``
    ahead. The thread's put is bounded and gives up once the consumer is
    gone: a plain ``q.put`` would block forever when the generator is
    abandoned mid-epoch, leaking the thread and keeping the loader (and
    its mmaps) alive. An exception in the thread reaches the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    done = object()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in items:
                if not put(item):
                    return
            put(done)
        except BaseException as e:           # surface in the consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)


def _as_numpy(buf):
    """An output buffer's float32 numpy view (a CPU tensor, pinned or
    not, shares its memory); the C++ side writes it as one contiguous
    float32 block."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise ValueError("an output tensor must lie on the CPU")
        buf = buf.numpy()
    if buf.dtype != np.float32 or not buf.flags.c_contiguous:
        raise ValueError("an output buffer must be contiguous float32")
    return buf


class NativeWindowLoader:
    """Window loader over per-file (hcqt.npy, annot.npy) pairs: the HCQT
    ``(216, T, 6)`` and the roll ``(128, T)``, float32 or float64, as the
    precompute CLI writes them.

    Args:
        file_pairs: list of (hcqt_path, annot_path).
        context/stride: window geometry (``dataset_context`` semantics:
            window ``i`` of a file is centred at ``i·stride + context//2``,
            and the global index runs over the files in order).
        target_slice: (lo, hi) annotation rows (the experiments use
            (24, 96)).
        n_threads: C++ batch-assembly threads.
    """

    def __init__(self, file_pairs: Sequence[Tuple[str, str]],
                 context: int = 75, stride: int = 50,
                 target_slice: Tuple[int, int] = (24, 96),
                 n_threads: int = 8, channels: int = 6, freq_bins: int = 216):
        self._lib = _load_lib()
        self.context = context
        self.channels = channels
        self.freq_bins = freq_bins
        self.n_bins = target_slice[1] - target_slice[0]
        self.n_threads = n_threads
        self._ds = self._lib.mpe_dataset_create(
            context, stride, target_slice[0], target_slice[1])
        for hcqt_path, annot_path in file_pairs:
            n = self._lib.mpe_dataset_add_file(
                self._ds, hcqt_path.encode(), annot_path.encode())
            if n < 0:
                raise IOError(self._lib.mpe_dataset_error(self._ds).decode())

    def __len__(self):
        return int(self._lib.mpe_dataset_num_windows(self._ds))

    def fill(self, indices, out_x=None, out_y=None):
        """Assemble the windows of global ``indices``: (X (n, C, ctx, F),
        y (n, n_bins)), float32, into ``out_x`` / ``out_y`` when given
        (numpy arrays or contiguous float32 CPU tensors, pinned ones
        included, of those shapes), else into new arrays. Returns the
        buffers it filled."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        n = len(idx)
        x = _as_numpy(out_x) if out_x is not None else np.empty(
            (n, self.channels, self.context, self.freq_bins), np.float32)
        y = _as_numpy(out_y) if out_y is not None else np.empty(
            (n, self.n_bins), np.float32)
        if x.shape != (n, self.channels, self.context, self.freq_bins) or \
                y.shape != (n, self.n_bins):
            raise ValueError(f"output buffers {x.shape}, {y.shape} for "
                             f"{n} windows")
        rc = self._lib.mpe_dataset_fill_batch(
            self._ds, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n_threads)
        if rc != 0:
            raise IOError("native fill_batch failed")
        return (out_x if out_x is not None else x,
                out_y if out_y is not None else y)

    def chunks(self, batch_size: int, shuffle: bool = True, seed: int = 0):
        """One epoch's full batches of window indices (the last partial
        batch dropped), shuffled by ``numpy.random.default_rng(seed)``."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        return [order[i:i + batch_size]
                for i in range(0, len(order) - batch_size + 1, batch_size)]

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0, prefetch: int = 2):
        """Generator of (X, y) numpy batches, filled by a background
        thread up to ``prefetch`` ahead."""
        return _prefetched((self.fill(c) for c in
                            self.chunks(batch_size, shuffle, seed)), prefetch)

    def __del__(self):
        try:
            if getattr(self, "_ds", None):
                self._lib.mpe_dataset_destroy(self._ds)
                self._ds = None
        except Exception:
            pass


def _staged(loader, chunks, batch_size, device):
    """The batches of ``chunks`` on ``device``: each filled into one pair
    of pinned buffers and copied with ``non_blocking`` on a stream of its
    own; the stream is synchronized (this thread waits, the device's
    compute stream does not) before the buffers are filled again."""
    stream = torch.cuda.Stream(device)
    x_pin = torch.empty((batch_size, loader.channels, loader.context,
                         loader.freq_bins), pin_memory=True)
    y_pin = torch.empty((batch_size, loader.n_bins), pin_memory=True)
    for chunk in chunks:
        loader.fill(chunk, x_pin, y_pin)
        with torch.cuda.stream(stream):
            x = x_pin.to(device, non_blocking=True)
            y = y_pin.to(device, non_blocking=True)
        stream.synchronize()
        yield x, y


def trainer_batches(loader: NativeWindowLoader, batch_size: int,
                    shuffle: bool = True, seed: int = 0,
                    compression: Optional[float] = 10.0, device=None,
                    prefetch: int = 2):
    """The loader's batches in the Trainer's (x, y) convention, on
    ``device`` (the card unless given): x log-compressed ``(B, C, ctx,
    F)``, the ``log1p`` on the device, and y ``(B, 1, 1, n_bins)``
    (``train/trainer.py``'s ``fit`` consumes them). On the card, a
    background thread fills pinned buffers and copies them over with
    ``non_blocking`` while the device computes. No augmentation: augment
    on the device with ``data.augment`` if needed."""
    device = resolve_device(device)
    chunks = loader.chunks(batch_size, shuffle, seed)
    if device.type == "cuda":
        batches = _prefetched(_staged(loader, chunks, batch_size, device),
                              prefetch)
    else:
        batches = ((torch.from_numpy(x).to(device),
                    torch.from_numpy(y).to(device))
                   for x, y in _prefetched(
                       (loader.fill(c) for c in chunks), prefetch))
    compute = (torch.cuda.current_stream(device) if device.type == "cuda"
               else None)
    try:
        for x, y in batches:
            if compute is not None:       # the copy stream allocated them
                x.record_stream(compute)
                y.record_stream(compute)
            if compression is not None:
                x = torch.log1p(compression * x)
            yield x, y[:, None, None, :]
    finally:
        batches.close()                   # joins the prefetch thread
