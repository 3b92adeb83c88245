#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving paths, audio -> HCQT -> SAUnet:XL windowed
protocol in float32 and in int8, and its training path (SAUnet:L), in
phases, and prints each phase's result on its own line:

1. device: requires CUDA, prints the card's name and power limit, and
   sets the float32 parity flags (no TF32);
2. build: compiles the CQT octave kernel and the int8 GEMM from
   ``csrc/`` with nvcc, one process per source, started together;
3. kernel: the CQT kernel against its plain PyTorch version on the card,
   rel-to-peak tolerance 1e-5 for each octave: the 21 octaves of the
   serving HCQT (n_fft 512 and 256, hops 512..2, scaled, in their
   columns of three outputs) in one launch at 5069, 431 and 301 frames;
   small work lists at 12, 24 and 60 bins per octave that take each of
   its three sample loaders; and an exact-plan CQT of 4 s, card vs CPU.
   The single launch of the 21 octaves at 5069 frames, each octave alone
   and the plain version are timed by CUDA events, beside the first
   (float32 FMA, one launch per octave) version's time and both bounds;
4. hcqt: the HCQT of the bench's 117.701-s span on the card against the
   same HCQT on the CPU, where each octave runs the plain version
   (rel-to-peak 1e-5); the kernel must launch once; the first call (with
   the plan's copies to the card) and a warm call are timed;
5. serving: exp180e at full width with seeded random weights and
   ``cross_batch:50`` attention answers 10-s, 4-s and 2.5-s requests
   through ``hcqt`` and ``predict_framewise(batch_size=250, group=50)``;
   each output must be (T, 72), finite and within [0, 1], and a batch of
   windows must match the same model on the CPU (atol 1e-4);
6. int8-kernel: the int8 GEMM's two epilogues against their exact plain
   versions, bit for bit: the int32 sums at the TPU probe's 4096^3
   (timed beside ``torch._int_mm`` and a bf16 matmul: does int8 beat
   bf16 on this card?), and both the int32 sums and the fused
   dequantize (random scales and bias) at the 21 quantized conv shapes
   of exp180e, each at batch 2 and at every batch size the int8 serving
   phase gives it (250, 150, 50 and the tails of 42, 31 and 23
   windows; the fused entry's plain version is the plain int32 sums
   through the plain dequantize); at batch 250 each conv's fused entry is
   timed beside its host time per call, its bound, the first (mma.sync)
   version's time and the float32 cuDNN conv of the same shape;
7. int8-serving: the same model through ``predict_framewise_int8``
   (per-recording calibration on the first fused batch of 250) answers
   30-s and 10-s requests, each with its peak device memory: the
   calibration span must equal the card's float32 protocol (1e-6), the
   rest must differ from it, and the fused int8 GEMM must launch once per
   quantized conv per int8 batch of the drain (147). One int8 batch of
   250 is split by CUDA events into the int8 GEMM, the quantize and
   layout passes around it and the float32 rest; the 10-s int8 request
   is profiled three times and the float32 one once (device idle share,
   top kernels). A gated 4-s request
   (``gate=1e-3``) prints its drift and demotions. Then each quantized
   conv of the card's forward of a few windows is fed again on the CPU,
   teacher-forced: its card input through the same quantized conv on
   the CPU must give the same int8 operands; the int32 sums recomputed
   from them by the kernel on the card and by the plain version on the
   CPU must be equal; the card's fused output must equal the plain
   dequantize of the card's own sums bit for bit, and the CPU's output
   within 1e-6. The free-running gap of the whole quantized model, card
   vs CPU, is printed (bin flips cascade at full depth, see PERF.md);
8. train: the training path (no hand-written kernel: autograd and
   cuDNN), exp180d (SAUnet:L) at full width with weights drawn as the
   JAX package's ``model.init`` draws them:
   a. one AdamW step of the recipe at batch 25 (dropout 0 everywhere,
      BatchNorm in train mode, TF32 off) on a fixed batch of the
      pipeline, augmentation off, on the card and, in a process of its
      own with one thread, on the CPU, with the card's max-pool choices
      replayed (a window whose two largest values lie within the devices'
      float32 gap would send its gradient elsewhere): loss rel 1e-5; each
      gradient against the same step in float64 on the card (relative L2,
      at most 1e-4 or 4 x the CPU's own float32 error: in float32 some of
      exp180d's gradients are good to a few 1e-2 on either device); the
      conv biases that feed a BatchNorm 0 in exact arithmetic (1e-4 of
      their weights'); the parameters after the step equal up to what the
      two gradients explain through AdamW's first step (1e-6) and the
      BatchNorm statistics to 1e-5 of their max abs;
   b. ``perf/fullsize_train_diag.py`` through the port's ``Trainer.fit``:
      exp180d at lr 5e-4, batch 16, 2 epochs on the learnable synthetic
      task (3 files of 1200 frames, stride 5), loss history and probe
      predictions printed; the epoch-2 loss must fall below half of
      epoch 1's;
   c. the exp180e lr ladder (5e-4, 1e-4), the same recipe, printed;
   d. resume: epoch 0's checkpoint restored into a fresh trainer must
      equal the trainer that wrote it, bit for bit, and epoch 1's first
      step give the same loss bit for bit; the rest of epoch 1 is printed
      (the card's backward is not bit-deterministic);
   e. the registry step timed at batch 25 with the recipe's augmentation
      (CUDA events, 20 steps after 3 warm-ups), the pipeline alone,
      peak memory, three pipeline-fed steps profiled (idle share, top
      kernels), the step's FLOPs (``FlopCounterMode``) and their share
      of the float32 peak; then one ``run_experiment`` on
      ``SyntheticCorpus`` (1 epoch) through the test phase: its CSV, its
      prediction files and 150 finite measures.

Each path's kernel launch counts are reset just before its requests and
read just after. Each phase's seconds are printed at the end. The line
before the last is a JSON object with each
kernel's launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``. Any failing phase raises, and the
script exits non-zero without that line.
"""

import copy
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

FS = 22050
HOP = 512
BENCH_SECONDS = 117.701          # bench.py's span (one MuN-10 test file)
REQUEST_SECONDS = (10.0, 4.0, 2.5)
BATCH, GROUP = 250, 50
HCQT_KW = dict(fs=FS, fs_hcqt_target=50, bins_per_octave=36, num_octaves=6,
               tuning=0.0)
EXPERIMENT = "exp180e_musicnet_unet_insanelylarge_doubleselfattn"
SEED = 0
K1_TOL = 1e-5        # rel-to-peak: float32 sums over n_fft in two orders
HCQT_TOL = 1e-5      # rel-to-peak, as the CPU tests hold the port to JAX
MODEL_TOL = 1e-4     # atol on sigmoid outputs, card vs CPU, TF32 off
N_CHECK_WINDOWS = 8
BPO = 36
INT8_REQUEST_SECONDS = (30.0, 10.0)
GATED_SECONDS, GATED_BATCH, GATE = 4.0, 50, 1e-3
# atol of a quantized conv's dequantized output, card vs CPU, on the same
# input: the same float32 operations on the same int32 sums
DEQUANT_TOL = 1e-6
N_INT8_CHECK_WINDOWS = 2
PROBE = 4096                # the TPU probe's M = N = K
# the card's published dense peaks (NVIDIA H100 SXM data sheet)
INT8_OPS_PER_S, F32_FLOP_PER_S, BYTES_PER_S = 1979e12, 67e12, 3.35e12
K1_FRAMES = 5069     # frames of the bench span: 117.701 s · 22050 // 512 + 1
TF32_FLOP_PER_S = 495e12   # dense TF32 tensor-core rate (same data sheet)
# ms of the first version of the CQT kernel (float32 FMAs on CUDA cores,
# one launch per octave) for the 21 octaves at K1_FRAMES: NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md, section 6, the kernel table)
K1_FMA_MS = 1.827
# ms of the first (mma.sync, int32-out) version of the int8 GEMM at batch
# 250, per quantized conv of exp180e: NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md, section 6, the conv table)
MMA_SYNC_CONV_MS = {
    "inc.double_conv.0": 5.192, "inc.double_conv.4": 8.233,
    "down1.1.double_conv.0": 2.903, "down1.1.double_conv.4": 5.088,
    "down2.1.double_conv.0": 0.999, "down2.1.double_conv.4": 1.791,
    "down3.1.double_conv.0": 0.404, "down3.1.double_conv.4": 0.657,
    "down4.1.double_conv.0": 0.093, "down4.1.double_conv.4": 0.094,
    "upconv1.double_conv.0": 0.491, "upconv1.double_conv.4": 0.180,
    "upconv2.double_conv.0": 1.188, "upconv2.double_conv.4": 0.370,
    "upconv3.double_conv.0": 3.665, "upconv3.double_conv.4": 1.413,
    "upconv4.double_conv.0": 14.191, "upconv4.double_conv.4": 22.518,
    "conv2.0": 3.294, "conv3.0": 1.328, "conv4.0": 0.081}
TRAIN_EXPERIMENT = "exp180d_musicnet_unet_extremelylarge_doubleselfattn"
TRAIN_BATCH = 25
# one AdamW step of the exp180d recipe (registry.json)
TRAIN_STEP_CONFIG = dict(batch_size=TRAIN_BATCH, initial_lr=1e-3, eps=1e-8,
                         weight_decay=0.01)
TRAIN_LOSS_RTOL = 1e-5    # card vs CPU, one step, TF32 off
TRAIN_GRAD_TOL = 1e-4     # rel L2 error of each gradient, float32 vs float64
GRAD_FACTOR = 4           # ... or this many times the CPU's own error
TRAIN_PARAM_ATOL = 1e-6   # beyond the gap that the two gradients explain
TRAIN_STATS_TOL = 1e-5    # of each BatchNorm statistic's max abs
RESUME_BATCHES = 4        # batches per epoch of the resume check
TIMED_STEPS = 20
# (n_fft, octaves) of the serving HCQT's three bases, 0.5, 3 and 5: the
# hop halves from 512 at each octave
MAIN_PATH_BASES = ((512, 9), (512, 6), (256, 6))
MAIN_PATH_OCTAVES = [(n_fft, HOP >> k) for n_fft, n in MAIN_PATH_BASES
                     for k in range(n)]


def audio(seconds, seed):
    """bench.py's harmonic tone on C4 plus seeded noise."""
    t = np.arange(int(seconds * FS)) / FS
    y = sum((1.0 / h) * np.sin(2 * np.pi * 261.63 * h * t)
            for h in (1, 2, 3, 4, 5))
    y = y + 1e-3 * np.random.RandomState(seed).randn(len(t))
    return y.astype(np.float32)


def frames(seconds):
    """HCQT frames of a request of ``seconds``."""
    return int(seconds * FS) // HOP + 1


def int8_batch_sizes(t, batch, group, cal_batches):
    """Sizes of the int8 batches of ``predict_framewise_int8``'s drain of
    ``t`` frames: those after the float32 calibration span (the first
    ``cal_batches`` full batches, as far as the recording has them)."""
    from multipitch_architectures_tpu_torch.eval.inference import (
        _next_batch_size)

    start, sizes = min(cal_batches, t // batch) * batch, []
    while start < t:
        sizes.append(_next_batch_size(t - start, batch, group))
        start += sizes[-1]
    return sizes


def main_path_batch_sizes():
    """Every batch size at which the int8 serving phase runs the int8
    GEMM: the two requests' drains, and the gated request's (its drift
    gate runs the whole recording in batches of ``GATED_BATCH``)."""
    sizes = {n for s in INT8_REQUEST_SECONDS
             for n in int8_batch_sizes(frames(s), BATCH, GROUP, 1)}
    t = frames(GATED_SECONDS)
    sizes |= {min(GATED_BATCH, t - s) for s in range(0, t, GATED_BATCH)}
    return sorted(sizes)


def bound_ms(ops, ops_per_s, nbytes):
    """(least time in ms, "operations" or "bytes"): the larger of the
    operations over the card's peak rate for their type and the bytes
    over its memory rate."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_to_peak(got, want):
    return float((got - want).abs().max() / want.abs().max())


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``
    calls after ``warmup``."""
    import torch

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


def host_ms(fn, reps=3):
    """Host time of ``fn()`` in ms per call, without waiting for the card:
    where it is as long as the device time, the host bounds the calls."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def cuda_timed(fn):
    """(``fn()``, its device time in ms by CUDA events): one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    from multipitch_architectures_tpu_torch import set_f32_parity

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    set_f32_parity()
    # the CPU references run on one thread: a multi-threaded CPU sgemm was
    # seen to return a wrong first product for a new shape (see
    # tests/test_torch_ops.py)
    torch.set_num_threads(1)
    card = smi.splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"tf32 cudnn={torch.backends.cudnn.allow_tf32} "
          f"matmul={torch.backends.cuda.matmul.allow_tf32}")
    return torch.device("cuda", 0), card


def phase_build():
    import os
    from concurrent.futures import ThreadPoolExecutor

    from multipitch_architectures_tpu_torch.ops import _build, cqt_octave
    from multipitch_architectures_tpu_torch.ops import int8_gemm

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:      # one nvcc per source, together
        for lib in [pool.submit(m._lib) for m in (cqt_octave, int8_gemm)]:
            lib.result()
    print(f"[build] cqt_octave.cu and int8_gemm.cu ready in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in ("cqt_octave", "int8_gemm"):
        log = _build.library_path(name) + ".log"
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if ("registers" in line or "spill" in line
                            or "entry function" in line
                            or "warning" in line.lower()):
                        print(f"[build] {name} ptxas: {line.strip()}")


def k1_work_list(dev, rng, n_frames, bpo=BPO, octaves=None):
    """A work list for the CQT kernel and a twin for its plain version:
    random signals, banks and scales, on ``dev``. By default the serving
    HCQT's 21 octaves, laid out as ``hcqt`` lays them: three outputs of
    9, 6 and 6 octaves, octave k of a base in columns (n - 1 - k)·bpo of
    its output, one bank per base. ``octaves`` = [(n_fft, hop, y offset)]
    makes one output of those instead, with a bank each; an offset of 1
    leaves the signal unaligned."""
    import torch

    from multipitch_architectures_tpu_torch.ops.cqt_octave import (
        Octave, bank_for_kernel)

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    groups = ([[(n_fft, HOP >> k, 0) for k in range(n)]
               for n_fft, n in MAIN_PATH_BASES] if octaves is None
              else [octaves])
    work, twin = [], []
    for group in groups:
        n = len(group)
        out = torch.full((n_frames, n * bpo), float("nan"), device=dev)
        out_ref = torch.empty_like(out)
        krs = {}
        for k, (n_fft, hop, offset) in enumerate(group):
            if octaves is not None or n_fft not in krs:
                kr = rng.randn(n_fft, 2 * bpo) * 0.01
                krs[n_fft] = (tensor(kr), tensor(bank_for_kernel(
                    kr.astype(np.float32))))
            kr, bank = krs[n_fft]
            y = tensor(rng.uniform(-1, 1, (n_frames - 1) * hop + n_fft
                                   + offset))[offset:]
            scale = tensor(rng.uniform(1, 40, bpo))
            col = (n - 1 - k) * bpo
            kw = dict(hop=hop, n_fft=n_fft, n_frames=n_frames, col=col)
            work.append(Octave(y, kr, bank, scale, out, **kw))
            twin.append(Octave(y, kr, None, scale, out_ref, **kw))
    return work, twin


def k1_errors(work, twin, bpo):
    """(worst rel-to-peak, worst abs) of each octave's columns, kernel
    against plain; raises past K1_TOL."""
    worst_rel, worst_abs = 0.0, 0.0
    for o, r in zip(work, twin):
        got = o.out[:o.n_frames, o.col:o.col + bpo]
        want = r.out[:r.n_frames, r.col:r.col + bpo]
        rel = rel_to_peak(got, want)
        if not rel < K1_TOL:        # NaN too: a column left unwritten
            raise AssertionError(f"kernel vs plain: n_fft {o.n_fft} hop "
                                 f"{o.hop} frames {o.n_frames} bpo {bpo}: "
                                 f"rel {rel:.3g}")
        worst_rel = max(worst_rel, rel)
        worst_abs = max(worst_abs, float((got - want).abs().max()))
    return worst_rel, worst_abs


def phase_kernel(dev, card):
    """The kernel against its plain version on the card; returns the
    kernels line's numbers, the times those of the one launch of the 21
    octaves of one bench-span HCQT."""
    import torch

    from multipitch_architectures_tpu_torch.dsp import CqtPlan, cqt
    from multipitch_architectures_tpu_torch.ops.cqt_octave import (
        cqt_octaves, cqt_octaves_launcher, cqt_octaves_reference)

    rng = np.random.RandomState(SEED)
    worst_rel, worst_abs, n_checked = 0.0, 0.0, 0
    for n_frames in (K1_FRAMES, 431, 301):
        work, twin = k1_work_list(dev, rng, n_frames)
        before = cqt_octaves.launches
        cqt_octaves(work, bpo=BPO)
        cqt_octaves_reference(twin, bpo=BPO)
        torch.cuda.synchronize()
        if cqt_octaves.launches - before != 1:
            raise AssertionError(f"{cqt_octaves.launches - before} launches "
                                 f"for one work list of 21 octaves")
        rel, err = k1_errors(work, twin, BPO)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        n_checked += len(work)
        print(f"[kernel] 21 octaves at {n_frames} frames, one launch: "
              f"worst rel-to-peak {rel:.3e}, abs {err:.3e}")
        if n_frames == K1_FRAMES:
            bench = work, twin
    # other widths, and each sample loader: hop <= 4 (one contiguous
    # range), rows of 16-byte copies, rows of 4-byte copies (hop 6, and an
    # unaligned signal)
    small = [(512, 64, 0), (512, 2, 0), (256, 512, 0), (256, 8, 0),
             (256, 6, 0), (512, 64, 1)]
    for bpo in (12, 24, 60):
        work, twin = k1_work_list(dev, rng, 301, bpo=bpo, octaves=small)
        cqt_octaves(work, bpo=bpo)
        cqt_octaves_reference(twin, bpo=bpo)
        rel, err = k1_errors(work, twin, bpo)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        n_checked += len(work)
    # an exact plan: per-octave full-rate banks, n_fft up to 65536
    plan = CqtPlan.create(fs=FS, hop=HOP, fmin=32.703, n_bins=216,
                          bins_per_octave=BPO, exact=True)
    y = audio(4.0, SEED + 7)
    got = cqt(torch.as_tensor(y, device=dev), plan)
    rel_exact = rel_to_peak(got.cpu(), cqt(torch.as_tensor(y), plan))
    if not rel_exact < HCQT_TOL:
        raise AssertionError(f"exact-plan cqt, card vs CPU: rel "
                             f"{rel_exact:.3g}")
    print(f"[kernel] {n_checked} octaves within rel-to-peak {K1_TOL:g} of "
          f"the plain version (worst {worst_rel:.3e}, abs {worst_abs:.3e}), "
          f"widths 12, 24, 36, 60; exact-plan cqt of 4 s (n_fft up to "
          f"{max(plan.n_ffts)}), card vs CPU: rel {rel_exact:.3e}")

    work, twin = bench
    launch = cqt_octaves_launcher(work, bpo=BPO)
    ms = cuda_ms(launch)
    alone = [cuda_ms(cqt_octaves_launcher([o], bpo=BPO)) for o in work]
    plain_ms = cuda_ms(lambda: cqt_octaves_reference(twin, bpo=BPO), reps=5)
    wrapper_ms = host_ms(lambda: cqt_octaves(work, bpo=BPO), reps=20)
    for (n_fft, hop), t in zip(MAIN_PATH_OCTAVES, alone):
        print(f"[kernel] n_fft {n_fft} hop {hop:3d} at {K1_FRAMES} frames, "
              f"alone: {t:.4f} ms")
    # the bounds: the product's operations on tensor cores, three TF32
    # products (the row's bound), or in float32 on CUDA cores with the
    # magnitude; the bytes of signals, banks and magnitudes, once each
    product = sum(2 * K1_FRAMES * n_fft * 2 * BPO
                  for n_fft, _ in MAIN_PATH_OCTAVES)
    nbytes = sum(4 * ((K1_FRAMES - 1) * hop + n_fft + n_fft * 2 * BPO
                      + K1_FRAMES * BPO) for n_fft, hop in MAIN_PATH_OCTAVES)
    tf32 = bound_ms(3 * product, TF32_FLOP_PER_S, nbytes)
    f32 = bound_ms(product + 4 * K1_FRAMES * BPO * len(work), F32_FLOP_PER_S,
                   nbytes)
    print(f"[kernel] the 21 octaves of one {BENCH_SECONDS}-s HCQT, one "
          f"launch: {ms:.4f} ms (first version, 21 launches: "
          f"{K1_FMA_MS:.3f} ms; {K1_FMA_MS / ms:.2f}x), each octave alone "
          f"summed {sum(alone):.4f} ms, plain {plain_ms:.4f} ms, wrapper "
          f"host {wrapper_ms:.4f} ms per call; bound {tf32[0]:.4f} ms by "
          f"{tf32[1]} split TF32 ({3 * product / 1e9:.3f} GFLOP at "
          f"{TF32_FLOP_PER_S / 1e12:g} TFLOP/s; {tf32[0] / ms:.1%}), "
          f"{f32[0]:.4f} ms on CUDA cores ({f32[0] / ms:.1%}), bytes "
          f"{nbytes / 1e6:.2f} MB; {card}")
    return dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=tf32[0], bound_by=tf32[1], library_ms=None,
                bound_ms_split_tf32=tf32[0], bound_ms_cuda_cores=f32[0])


def phase_hcqt(dev):
    import torch

    from multipitch_architectures_tpu_torch.dsp import hcqt
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves

    y = audio(BENCH_SECONDS, SEED)
    before = cqt_octaves.launches
    t0 = time.perf_counter()
    got = hcqt(y, device=dev, **HCQT_KW)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cqt_octaves.launches - before
    t0 = time.perf_counter()
    hcqt(y, device=dev, **HCQT_KW)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    want = hcqt(y, device="cpu", **HCQT_KW)[0]
    rel = rel_to_peak(got.cpu(), want)
    n_frames = len(y) // HOP + 1
    if got.shape != (6, n_frames, 216) or launches != 1 or rel >= HCQT_TOL:
        raise AssertionError(f"hcqt: shape {tuple(got.shape)}, {launches} "
                             f"launches, rel {rel:.3g}")
    print(f"[hcqt] {BENCH_SECONDS} s -> {tuple(got.shape)}: 1 launch, "
          f"card vs CPU rel-to-peak {rel:.3e} (< {HCQT_TOL:g}), first call "
          f"(with the plan's copies to the card) {wall * 1e3:.1f} ms, warm "
          f"call {warm * 1e3:.1f} ms")


def phase_serving(dev, card):
    """Returns the kernel launches counted over the three requests, and
    the model on the card and on the CPU."""
    import torch

    from multipitch_architectures_tpu_torch.data import gather_windows
    from multipitch_architectures_tpu_torch.dsp import hcqt
    from multipitch_architectures_tpu_torch.eval import predict_framewise
    from multipitch_architectures_tpu_torch.eval.inference import _pad_inputs
    from multipitch_architectures_tpu_torch.experiments import load_experiment
    from multipitch_architectures_tpu_torch.models import init_parameters
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves

    cfg = load_experiment(EXPERIMENT)
    model = cfg.build_model(attn_mode=f"cross_batch:{GROUP}")
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    print(f"[serving] {EXPERIMENT}: {n_params:,} params, cross_batch:{GROUP},"
          f" batch {BATCH}")

    def serve(y):
        t0 = time.perf_counter()
        f = hcqt(y, device=dev, **HCQT_KW)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred = predict_framewise(model, f, batch_size=BATCH, group=GROUP)
        torch.cuda.synchronize()
        return f, pred, t1 - t0, time.perf_counter() - t0

    serve(audio(REQUEST_SECONDS[-1], SEED + 99))      # warm-up, not counted
    requests = [audio(s, SEED + i) for i, s in enumerate(REQUEST_SECONDS)]
    cqt_octaves.launches = 0
    results = [serve(y) for y in requests]
    launches = cqt_octaves.launches
    for seconds, y, (f, pred, t_hcqt, wall) in zip(REQUEST_SECONDS, requests,
                                                   results):
        t = len(y) // HOP + 1
        ok = (pred.shape == (t, 72) and bool(torch.isfinite(pred).all())
              and float(pred.min()) >= 0.0 and float(pred.max()) <= 1.0)
        if not ok:
            raise AssertionError(f"{seconds}-s request: shape "
                                 f"{tuple(pred.shape)}, range "
                                 f"[{float(pred.min())}, {float(pred.max())}]")
        print(f"[serving] {seconds:>4} s -> {tuple(pred.shape)} in "
              f"[{float(pred.min()):.4f}, {float(pred.max()):.4f}]: wall "
              f"{wall * 1e3:.1f} ms (hcqt {t_hcqt * 1e3:.1f} ms), "
              f"{seconds / wall:.2f}x real time; {card}")
    if launches != len(requests):
        raise AssertionError(f"{launches} kernel launches in "
                             f"{len(requests)} requests, want one per "
                             f"HCQT")

    # the same windows through the same model on the CPU
    f = results[-1][0]
    xw = gather_windows(_pad_inputs(torch.log1p(10.0 * f), 75),
                        37 + np.arange(N_CHECK_WINDOWS), 75)
    with torch.no_grad():
        got = model(xw).cpu()
        want = cpu_model(xw.cpu())
    gap = float((got - want).abs().max())
    if not gap < MODEL_TOL:
        raise AssertionError(f"card vs CPU forward: max abs gap {gap:.3g}")
    print(f"[serving] {N_CHECK_WINDOWS} windows, card vs CPU: max abs gap "
          f"{gap:.3e} (< {MODEL_TOL:g})")
    return launches, model, cpu_model


def device_profile(fn, top=8):
    """One profiled call of ``fn`` (torch.profiler, CPU and CUDA): returns
    (device idle share, host wall in s, [(kernel, device ms)] of the
    ``top`` kernels by device time). Busy time is the union of the device
    kernels' intervals; idle share is the rest of the host wall time of
    the call. The share is None when the trace holds no device kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, wall, []
    busy, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name = {}
    for k in kernels:
        by_name[k.name] = by_name.get(k.name, 0.0) + k.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (1.0 - busy / 1e6 / wall, wall,
            [(name[:60], us / 1e3) for name, us in ranked])


def conv_inputs(model, dev):
    """[(name, conv, (C, H, W) of its input)] for every conv that the int8
    mode quantizes, from one forward of a window."""
    import torch

    from multipitch_architectures_tpu_torch.eval import eligible_convs

    shapes = []
    handles = [conv.register_forward_pre_hook(
        lambda m, args, name=name: shapes.append(
            (name, m, tuple(args[0].shape[1:]))))
        for name, conv in eligible_convs(model)]
    try:
        with torch.no_grad():
            model(torch.zeros((1, 6, 75, 216), device=dev))
    finally:
        for h in handles:
            h.remove()
    return shapes


def phase_int8_kernel(dev, model):
    """The int8 GEMM's two epilogues against their exact plain versions,
    at the TPU probe's shape and at every quantized conv of ``model`` at
    every batch size that serving gives it; returns the kernels line's
    numbers, the times taken at the probe shape."""
    import torch
    import torch.nn.functional as F

    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        dequantize_reference, int8_conv2d, int8_conv2d_dequant,
        int8_conv2d_reference, int8_mm, int8_mm_reference)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0

    def rand8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def exact(got, want, what):
        """Raises unless the kernel's output equals the plain version's,
        bit for bit."""
        nonlocal worst
        err = (float((got.double() - want.double()).abs().max())
               if got.shape == want.shape and got.dtype == want.dtype
               else float("inf"))
        worst = max(worst, err)
        if err != 0.0 or not torch.equal(got, want):
            raise AssertionError(f"{what}: the kernel differs from its plain "
                                 f"version by up to {err:g}")

    a, b = rand8(PROBE, PROBE), rand8(PROBE, PROBE)
    exact(int8_mm(a, b), int8_mm_reference(a, b), f"int8_mm at {PROBE}^3")
    ops, nbytes = 2 * PROBE ** 3, 6 * PROBE * PROBE
    probe_bound = bound_ms(ops, INT8_OPS_PER_S, nbytes)
    ms = cuda_ms(lambda: int8_mm(a, b))
    plain_ms = cuda_ms(lambda: int8_mm_reference(a, b), reps=5)
    library_ms = cuda_ms(lambda: torch._int_mm(a, b))
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    bf16_ms = cuda_ms(lambda: ab @ bb)
    print(f"[int8-kernel] probe {PROBE}^3: bit-equal to the plain version; "
          f"kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s), bound "
          f"{probe_bound[0]:.4f} ms by {probe_bound[1]}, plain (float64) "
          f"{plain_ms:.4f} ms, torch._int_mm {library_ms:.4f} ms "
          f"({ops / library_ms / 1e9:.1f} TOP/s), bf16 matmul {bf16_ms:.4f}"
          f" ms ({ops / bf16_ms / 1e9:.1f} TFLOP/s): int8 "
          f"{'beats' if ms < bf16_ms else 'does not beat'} bf16")
    del a, b, ab, bb

    batches = [2] + main_path_batch_sizes()
    if batches[-1] != BATCH:
        raise AssertionError(f"serving's batch sizes {batches[1:]} do not "
                             f"end at {BATCH}")
    total = dict(kernel=0.0, before=0.0, bound=0.0, plain=0.0, cudnn=0.0)
    convs = conv_inputs(model, dev)
    for name, conv, (c, h, w) in convs:
        (kh, kw), cout = conv.kernel_size, conv.out_channels
        args = (conv.stride, conv.padding)
        wq = rand8(cout, kh, kw, c)
        s1 = torch.rand(cout, generator=gen, device=dev) * 1e-3
        s2 = torch.rand((), generator=gen, device=dev) + 0.5
        bias = torch.randn(cout, generator=gen, device=dev)
        for batch in batches:          # the last is BATCH, timed below
            xq = rand8(batch, h, w, c)
            # int8_conv2d_dequant_reference, its two steps timed apart
            sums, tp = cuda_timed(lambda: int8_conv2d_reference(xq, wq, *args))
            exact(int8_conv2d(xq, wq, *args), sums,
                  f"int8_conv2d at {name}, batch {batch}")
            dq = (s1, s2, None if batch == 2 else bias)
            got = int8_conv2d_dequant(xq, wq, *args, *dq)
            want, t_dq = cuda_timed(lambda: dequantize_reference(sums, *dq))
            tp += t_dq
            exact(got, want, f"int8_conv2d_dequant at {name}, batch {batch}")
            del sums
        ho, wo = got.shape[1:3]
        m, k = BATCH * ho * wo, kh * kw * c
        ops = 2 * m * k * cout
        bound = bound_ms(ops, INT8_OPS_PER_S, xq.numel() + wq.numel()
                         + 4 * m * cout)
        del got, want
        def fused():
            return int8_conv2d_dequant(xq, wq, *args, *dq)

        t = cuda_ms(fused, reps=3, warmup=1)
        t_host = host_ms(fused)
        x32 = torch.randn((BATCH, c, h, w), generator=gen, device=dev)
        t32 = cuda_ms(lambda: F.conv2d(x32, conv.weight, conv.bias, *args),
                      reps=3, warmup=1)
        before = MMA_SYNC_CONV_MS[name]
        total["kernel"] += t
        total["before"] += before
        total["bound"] += bound[0]
        total["plain"] += tp
        total["cudnn"] += t32
        print(f"[int8-kernel] {name}: both epilogues bit-equal at batches "
              f"{batches}; batch {BATCH}, GEMM {m} x {k} x {cout}: fused "
              f"kernel {t:.3f} ms ({ops / t / 1e9:.1f} TOP/s; mma.sync "
              f"version {before:.3f} ms; host {t_host:.3f} ms per call), "
              f"bound {bound[0]:.3f} ms by "
              f"{bound[1]} ({bound[0] / t:.1%}), plain {tp:.3f} ms, float32 "
              f"cuDNN {t32:.3f} ms")
        del xq, wq, x32
    print(f"[int8-kernel] {len(convs)} conv shapes at batch {BATCH}: fused "
          f"kernel {total['kernel']:.2f} ms (mma.sync version "
          f"{total['before']:.2f} ms), bound {total['bound']:.2f} ms "
          f"({total['bound'] / total['kernel']:.1%}), plain "
          f"{total['plain']:.2f} ms, float32 cuDNN {total['cudnn']:.2f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=probe_bound[0], bound_by=probe_bound[1],
                library_ms=library_ms)


def quantized_run(q, x):
    """``q(x)`` on ``x``'s device, with a record of each quantized conv it
    runs: (output, {name: (input, output, int8 input, int8 weights, fused
    GEMM output, (stride, padding, s1, s2, bias))}), all on the CPU. ``q``
    is a quantized model or one ``Int8Conv2d``, on ``x``'s device."""
    import torch

    from multipitch_architectures_tpu_torch.eval import quant

    gemm, calls, records = quant.int8_conv2d_dequant, [], {}

    def cpu(t):
        return None if t is None else t.cpu()

    def recording(xq, wq, stride, padding, s1, s2, bias=None):
        y = gemm(xq, wq, stride, padding, s1, s2, bias)
        calls.append((xq.cpu(), wq.cpu(), y.cpu(),
                      (stride, padding, cpu(s1), cpu(s2), cpu(bias))))
        return y

    def record(conv, args, out):
        records[conv.name] = (args[0].cpu(), out.cpu()) + calls.pop()

    handles = [m.register_forward_hook(record) for m in q.modules()
               if isinstance(m, quant.Int8Conv2d)]
    quant.int8_conv2d_dequant = recording
    try:
        with torch.no_grad():
            y = q(x).cpu()
    finally:
        quant.int8_conv2d_dequant = gemm
        for h in handles:
            h.remove()
    return y, records


def int8_batch_split(q, x):
    """CUDA-event times of one int8 batch ``q(x)``: (whole forward, its
    quantized convs replayed alone, their fused GEMMs replayed alone), ms.
    The differences are the quantize and layout passes around the GEMM
    and the float32 rest."""
    import torch

    from multipitch_architectures_tpu_torch.eval import quant

    gemm, convs, gemms = quant.int8_conv2d_dequant, [], []

    def recording(*args):
        gemms.append(args)
        return gemm(*args)

    handles = [m.register_forward_pre_hook(
        lambda m, args: convs.append((m, args[0])))
        for m in q.modules() if isinstance(m, quant.Int8Conv2d)]
    quant.int8_conv2d_dequant = recording
    try:
        with torch.no_grad():
            q(x)
    finally:
        quant.int8_conv2d_dequant = gemm
        for h in handles:
            h.remove()
    with torch.no_grad():
        whole = cuda_ms(lambda: q(x), reps=3, warmup=1)
        conv_ms = sum(cuda_ms(lambda: m(a), reps=3, warmup=1)
                      for m, a in convs)
    gemm_ms = sum(cuda_ms(lambda: gemm(*a), reps=3, warmup=1) for a in gemms)
    return whole, conv_ms, gemm_ms, len(gemms)


def phase_int8_serving(dev, card, model, cpu_model):
    """Returns the int8 GEMM's launches over the two int8 requests."""
    import torch

    from multipitch_architectures_tpu_torch.data import gather_windows
    from multipitch_architectures_tpu_torch.dsp import hcqt
    from multipitch_architectures_tpu_torch.eval import (
        calibrate_activation_scales, eligible_convs, predict_framewise,
        predict_framewise_int8, quant, quantize_convs)
    from multipitch_architectures_tpu_torch.eval.inference import _pad_inputs
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        dequantize_reference, int8_conv2d, int8_conv2d_dequant)

    n_convs = len(eligible_convs(model))

    def serve(y, **kw):
        t0 = time.perf_counter()
        f = hcqt(y, device=dev, **HCQT_KW)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred = predict_framewise_int8(model, f, group=GROUP, **kw)
        torch.cuda.synchronize()
        return f, pred, t1 - t0, time.perf_counter() - t0

    def check(seconds, pred, t):
        ok = (pred.shape == (t, 72) and bool(torch.isfinite(pred).all())
              and float(pred.min()) >= 0.0 and float(pred.max()) <= 1.0)
        if not ok:
            raise AssertionError(f"int8 {seconds}-s request: shape "
                                 f"{tuple(pred.shape)}, range "
                                 f"[{float(pred.min())}, {float(pred.max())}]")

    kw = dict(batch_size=BATCH, cal_batches=1)
    serve(audio(10.0, SEED + 98), **kw)            # warm-up, not counted
    requests = [audio(s, SEED + 10 + i)
                for i, s in enumerate(INT8_REQUEST_SECONDS)]
    int8_conv2d_dequant.launches = cqt_octaves.launches = 0
    results, peaks = [], []
    for y in requests:
        torch.cuda.reset_peak_memory_stats(dev)
        results.append(serve(y, **kw))
        peaks.append(torch.cuda.max_memory_allocated(dev))
    launches = int8_conv2d_dequant.launches
    hcqt_launches = cqt_octaves.launches
    want = n_convs * sum(len(int8_batch_sizes(frames(s), BATCH, GROUP, 1))
                         for s in INT8_REQUEST_SECONDS)
    for seconds, y, (f, pred, t_hcqt, wall), peak in zip(
            INT8_REQUEST_SECONDS, requests, results, peaks):
        t = frames(seconds)
        check(seconds, pred, t)
        t0 = time.perf_counter()
        f32 = predict_framewise(model, f, batch_size=BATCH, group=GROUP)
        torch.cuda.synchronize()
        f32_wall = t_hcqt + time.perf_counter() - t0
        cal_gap = float((pred[:BATCH] - f32[:BATCH]).abs().max())
        int8_gap = float((pred[BATCH:] - f32[BATCH:]).abs().max())
        if not (cal_gap <= 1e-6 and int8_gap > 1e-6):
            raise AssertionError(f"int8 {seconds}-s request against float32: "
                                 f"calibration span {cal_gap:.3g} (want <= "
                                 f"1e-6), the rest {int8_gap:.3g} (want > "
                                 f"1e-6)")
        print(f"[int8-serving] {seconds:>4} s -> {tuple(pred.shape)} in "
              f"[{float(pred.min()):.4f}, {float(pred.max()):.4f}]: int8 wall"
              f" {wall * 1e3:.1f} ms ({seconds / wall:.2f}x real time, hcqt "
              f"{t_hcqt * 1e3:.1f} ms), float32 {f32_wall * 1e3:.1f} ms "
              f"({seconds / f32_wall:.2f}x); against float32: calibration "
              f"span {cal_gap:.2e}, int8 frames max gap {int8_gap:.3e}; "
              f"peak device memory {peak / 2**30:.2f} GiB; {card}")
    if launches != want or hcqt_launches != len(requests):
        raise AssertionError(f"{launches} fused int8 GEMM launches (want "
                             f"{want}) and {hcqt_launches} CQT launches in "
                             f"{len(requests)} int8 requests")
    print(f"[int8-serving] fused int8 GEMM launches {launches} = {n_convs} "
          f"convs x {want // n_convs} int8 batches of the drains; CQT "
          f"launches {hcqt_launches}")

    # one int8 batch of 250 windows of the 30-s request, split
    f = results[0][0]
    xp = _pad_inputs(torch.log1p(10.0 * f), 75)
    cal, xb = (gather_windows(xp, 37 + s + np.arange(BATCH), 75)
               for s in (0, BATCH))
    q = quantize_convs(model, activation_scales=calibrate_activation_scales(
        model, [cal]))
    whole, conv_ms, gemm_ms, n = int8_batch_split(q, xb)
    print(f"[int8-serving] one int8 batch of {BATCH}: {whole:.2f} ms = int8 "
          f"GEMM, dequantize fused ({n} launches) {gemm_ms:.2f} ms + "
          f"quantize and layout passes {conv_ms - gemm_ms:.2f} ms + float32 "
          f"rest {whole - conv_ms:.2f} ms; {card}")
    del q, cal, xb
    for label, fn in (
            *[(f"int8 request (HCQT and model), reading {i + 1} of 3",
               lambda: serve(requests[-1], **kw)) for i in range(3)],
            ("float32 request (model)",
             lambda: predict_framewise(model, results[-1][0],
                                       batch_size=BATCH, group=GROUP))):
        idle, wall, top = device_profile(fn)
        idle = "not measured" if idle is None else f"{idle:.2%}"
        print(f"[int8-serving] profiled {INT8_REQUEST_SECONDS[-1]}-s {label}:"
              f" wall {wall * 1e3:.1f} ms, device idle {idle}; top kernels: "
              + "; ".join(f"{n} {ms:.1f} ms" for n, ms in top))

    # the self-gating serve: report the hybrid search it runs
    searches, search = [], quant.auto_hybrid_int8
    quant.auto_hybrid_int8 = lambda *a, **k: (
        searches.append(search(*a, **k)) or searches[-1])
    y = audio(GATED_SECONDS, SEED + 20)
    int8_conv2d_dequant.launches = 0
    try:
        _, pred, _, wall = serve(y, batch_size=GATED_BATCH, gate=GATE)
    finally:
        quant.auto_hybrid_int8 = search
    check(GATED_SECONDS, pred, frames(GATED_SECONDS))
    policy, report = searches[0]
    print(f"[int8-serving] gated {GATED_SECONDS} s (batch {GATED_BATCH}, "
          f"gate {GATE:g}, proxy gate {report['gate']:g}) -> "
          f"{tuple(pred.shape)}: worst drift {report['worst']:.3e} "
          f"({'passed' if report['passed'] else 'FAILED'}), "
          f"{len(policy['exclude'])} of {n_convs} convs demoted to float32 "
          f"{list(policy['exclude'])}, {int8_conv2d_dequant.launches} int8 "
          f"GEMM launches, wall {wall:.2f} s")

    # a few windows: each quantized conv of the card's forward fed again
    # on the CPU (teacher-forced), and the whole quantized model on the
    # card against the same quantized model on the CPU (free-running)
    f = results[-1][0]
    xw = gather_windows(_pad_inputs(torch.log1p(10.0 * f), 75),
                        37 + np.arange(N_INT8_CHECK_WINDOWS), 75)
    scales = calibrate_activation_scales(model, [xw])
    cpu_scales = {k: v.cpu() for k, v in scales.items()}
    got, card = quantized_run(quantize_convs(model, activation_scales=scales),
                              xw)
    cpu_q = quantize_convs(cpu_model, activation_scales=cpu_scales)
    want, free = quantized_run(cpu_q, xw.cpu())
    cpu_convs = dict(cpu_q.named_modules())
    worst = dict(flips=0, weights=0, sums=0.0, fused=0, gap=0.0)
    for name, (x, y, xq, wq, yq, (stride, padding, *dq)) in card.items():
        _, y_c, xq_c, wq_c, _, _ = quantized_run(cpu_convs[name], x)[1][name]
        worst["flips"] = max(worst["flips"], int((xq != xq_c).sum()))
        worst["weights"] = max(worst["weights"], int((wq != wq_c).sum()))
        # the int32 sums of the card's int8 operands: the kernel on the
        # card, the plain version on the CPU
        y32 = int8_conv2d(xq.to(dev), wq.to(dev), stride, padding)
        y32_c = int8_conv2d(xq_c, wq_c, stride, padding)
        worst["sums"] = max(worst["sums"],
                            float((y32.cpu() - y32_c).abs().max()))
        # the fused output against the plain dequantize of those sums
        plain = dequantize_reference(
            y32, *(None if t is None else t.to(dev) for t in dq))
        worst["fused"] = max(worst["fused"],
                             int((plain.cpu() != yq).sum()))
        worst["gap"] = max(worst["gap"], float((y - y_c).abs().max()))
    if (len(card) != n_convs or worst["flips"] or worst["weights"]
            or worst["sums"] or worst["fused"]
            or not worst["gap"] <= DEQUANT_TOL):
        raise AssertionError(f"quantized convs, card vs CPU on the card's "
                             f"inputs ({len(card)} of {n_convs}): {worst}")
    print(f"[int8-serving] {len(card)} quantized convs on {len(xw)} windows, "
          f"teacher-forced card vs CPU: int8 inputs and weights equal, int32 "
          f"sums (kernel on the card, plain version on the CPU) equal, fused "
          f"output equal bit for bit to the plain dequantize of the card's "
          f"sums, card vs CPU outputs within {worst['gap']:.3e} (<= "
          f"{DEQUANT_TOL:g})")
    with torch.no_grad():
        f32 = model(xw).cpu()
    flips = ", ".join(f"{k} {int((v[2] != free[k][2]).sum())}/{v[2].numel()}"
                      for k, v in card.items())
    print(f"[int8-serving] free-running card vs CPU, int8 inputs that differ "
          f"per quantized conv: {flips}; quantized model max abs gap "
          f"{float((got - want).abs().max()):.3e}; int8 vs float32 on the "
          f"card {float((got - f32).abs().max()):.3e}")
    return launches, worst["sums"]


# -- the train phase --------------------------------------------------------

def synth_file(n_frames, seed, max_poly=4):
    """(inputs (6, T, 216), roll (T, 128)) of the learnable synthetic
    multi-pitch task: a copy of tests/test_learning.py's ``synth_file``
    (the machine with the card has no JAX). An active MIDI pitch p lights
    bin 3·(p-24)+1 and its (sub)harmonics' bins across the 6 channels,
    plus noise."""
    rng = np.random.RandomState(seed)
    roll = np.zeros((n_frames, 128), np.float32)
    t = 0
    while t < n_frames:
        dur = rng.randint(10, 40)
        for p in rng.choice(np.arange(30, 90), rng.randint(1, max_poly + 1),
                            replace=False):
            roll[t:t + dur, p] = 1.0
        t += dur
    offsets = [-36, 0, 36, 57, 72, 83]
    x = np.zeros((6, n_frames, 216), np.float32)
    bins = 3 * (np.arange(128) - 24) + 1
    for c, off in enumerate(offsets):
        b = bins + off
        valid = (b >= 0) & (b < 216)
        x[c][:, b[valid]] += (1.0 / (1 + c)) * roll[:, valid]
    x += 0.05 * rng.rand(6, n_frames, 216).astype(np.float32)
    return x, roll


def zero_dropout(model):
    """Every ``nn.Dropout`` to 0: ``p_dropout=0`` leaves the SAUnet's
    attention layers at their own 0.2, as in the reference."""
    from torch import nn

    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def pool_hooks(model, indices, replay):
    """Forward hooks on every ``nn.MaxPool2d`` of ``model``: record each
    pool's argmax (``replay=False``) into ``indices``, or take the pooled
    values at the recorded argmax (``replay=True``), so that the gradient
    goes where the recording run sent it. A window whose two largest
    values lie within the two devices' float32 gap would otherwise send
    its gradient to another element on each. Returns the handles."""
    import torch.nn.functional as F
    from torch import nn

    def hook(mod, args, out, name):
        x = args[0]
        if replay:
            idx = indices[name].to(x.device).long()
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        _, idx = F.max_pool2d(x, mod.kernel_size, mod.stride, mod.padding,
                              return_indices=True)
        indices[name] = idx.int().cpu()
        return None

    return [m.register_forward_hook(
        lambda mod, args, out, name=name: hook(mod, args, out, name))
        for name, m in model.named_modules() if isinstance(m, nn.MaxPool2d)]


def train_model(name=TRAIN_EXPERIMENT, **overrides):
    from multipitch_architectures_tpu_torch.experiments import load_experiment

    return load_experiment(name).build_model(**overrides)


def cpu_train_step(path):
    """The CPU side of the card-vs-CPU step, in a process of its own (one
    torch thread, beside the card's work): the payload's model and batch
    at ``path``, the card's max-pool choices replayed; writes the loss,
    the gradients and the state after the step to ``path + '.cpu'``."""
    import torch

    from multipitch_architectures_tpu_torch.experiments import build_model
    from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    payload = torch.load(path, weights_only=True)
    model = zero_dropout(build_model(payload["model_class"],
                                     payload["model_kwargs"]))
    model.load_state_dict(payload["start"])
    trainer = Trainer(model, TrainConfig(**TRAIN_STEP_CONFIG), device="cpu")
    pool_hooks(model, payload["pools"], replay=True)
    loss = trainer.train_step(payload["x"], payload["y"])
    torch.save({"loss": float(loss),
                "grads": {k: p.grad for k, p in model.named_parameters()},
                "state": model.state_dict()}, path + ".cpu")


def start_step_card_vs_cpu(dev, tmp):
    """Phase 8a, on the card: one AdamW step of exp180d at full width
    (dropout 0, BatchNorm in train mode, TF32 off) on a fixed batch of 25
    of the pipeline, augmentation off; the CPU process for the same step
    is started, and ``finish_step_card_vs_cpu`` compares."""
    import multiprocessing

    import torch

    from multipitch_architectures_tpu_torch.data import FileSpec, TrainPipeline
    from multipitch_architectures_tpu_torch.experiments import (
        build_model, load_experiment)
    from multipitch_architectures_tpu_torch.models import init_parameters_flax
    from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer

    cfg = load_experiment(TRAIN_EXPERIMENT)
    kwargs = {**cfg.model_kwargs, "p_dropout": 0.0}
    model = zero_dropout(build_model(cfg.model_class, kwargs))
    init_parameters_flax(model, torch.Generator().manual_seed(SEED))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    pipeline = TrainPipeline([FileSpec(*synth_file(1200, seed=s))
                              for s in range(3)], device=dev)
    x, y = next(pipeline.batches(SEED, TRAIN_BATCH, shuffle=False))
    card = Trainer(model, TrainConfig(**TRAIN_STEP_CONFIG), device=dev)
    pools = {}
    handles = pool_hooks(card.model, pools, replay=False)
    loss = float(card.train_step(x, y))
    for h in handles:
        h.remove()
    # the same step in float64 on the card, the same max-pool choices: the
    # reference each device's float32 gradients are held to
    model64 = zero_dropout(build_model(cfg.model_class, kwargs)).double()
    model64.load_state_dict(start)
    exact = Trainer(model64, TrainConfig(**TRAIN_STEP_CONFIG), device=dev)
    pool_hooks(exact.model, pools, replay=True)
    exact.train_step(x.double(), y.double())
    path = os.path.join(tmp, "step.pt")
    torch.save({"start": start, "x": x.cpu(), "y": y.cpu(), "pools": pools,
                "model_class": cfg.model_class, "model_kwargs": kwargs},
               path)
    proc = multiprocessing.get_context("spawn").Process(
        target=cpu_train_step, args=(path,))
    proc.start()
    card_out = {"loss": loss, "model": model,
                "grads": {k: p.grad.cpu() for k, p in
                          card.model.named_parameters()},
                "grads64": {k: p.grad.cpu() for k, p in
                            exact.model.named_parameters()},
                "state": {k: v.cpu() for k, v in
                          card.model.state_dict().items()}}
    return proc, path, card_out


def finish_step_card_vs_cpu(proc, path, card, card_name):
    """Phase 8a, the comparison (targets in the module docstring)."""
    import torch
    from torch import nn

    proc.join(timeout=600)
    if proc.is_alive():
        proc.kill()
        proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"the CPU train step failed: exit code "
                             f"{proc.exitcode}")
    cpu = torch.load(path + ".cpu", weights_only=True)
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    # conv biases that feed a train-mode BatchNorm: gradient 0 in exact
    # arithmetic, rounding noise on both devices
    bn_fed = set()
    for name, m in card["model"].named_modules():
        if isinstance(m, nn.Sequential):
            kids = list(m.named_children())
            for (a, ca), (_, cb) in zip(kids, kids[1:]):
                if isinstance(ca, nn.Conv2d) and isinstance(cb, nn.BatchNorm2d):
                    bn_fed.add(f"{name}.{a}.bias")
    # each gradient: card vs CPU (max abs gap over the tensor's max abs),
    # and each device's float32 against the card's float64 step (relative
    # L2 error). In float32 some of exp180d's gradients are only good to a
    # few 1e-2 on either device (the normalisations' cancellations), so the
    # card is held to the float64 step as closely as the CPU is: within
    # TRAIN_GRAD_TOL, or GRAD_FACTOR x the CPU's own error where float32
    # cannot give TRAIN_GRAD_TOL
    zero_worst, rows = 0.0, []
    for k, g_cpu in cpu["grads"].items():
        g_card, g64 = card["grads"][k].double(), card["grads64"][k]
        g_cpu = g_cpu.double()
        if k in bn_fed:
            scale = float(cpu["grads"][k[:-4] + "weight"].abs().max())
            zero_worst = max(zero_worst, float(g_card.abs().max()) / scale,
                             float(g_cpu.abs().max()) / scale)
            continue
        norm = g64.norm()
        rows.append((float((g_card - g_cpu).abs().max() / g_cpu.abs().max()),
                     float((g_card - g64).norm() / norm),
                     float((g_cpu - g64).norm() / norm), k))
    grad_worst = max(rows)
    card_worst = max(rows, key=lambda r: r[1] / max(TRAIN_GRAD_TOL,
                                                    GRAD_FACTOR * r[2]))
    card_ok = all(r[1] <= max(TRAIN_GRAD_TOL, GRAD_FACTOR * r[2])
                  for r in rows)
    for r in sorted(rows, reverse=True)[:4]:
        print(f"[train]   gradient {r[3]}: card vs CPU {r[0]:.2e} of max abs;"
              f" against the float64 step (rel L2) card {r[1]:.2e}, CPU "
              f"{r[2]:.2e}")
    # AdamW's first step: p1 = p0·(1 - lr·wd) - lr·g/(|g| + eps), steep in
    # g where |g| is near eps; the parameters may differ by what the two
    # gradients explain, lr·|u(g_card) - u(g_cpu)|, plus rounding
    lr, eps = TRAIN_STEP_CONFIG["initial_lr"], 1e-8
    param_gap, param_unexplained, stats_worst = 0.0, 0.0, (0.0, "")
    for k, p_cpu in cpu["state"].items():
        p_card = card["state"][k]
        if k.endswith("num_batches_tracked"):
            continue
        gap = (p_card.double() - p_cpu.double()).abs()
        if k.endswith(("running_mean", "running_var")):
            rel = float(gap.max() / p_cpu.abs().max())
            stats_worst = max(stats_worst, (rel, k))
            continue
        g1, g2 = card["grads"][k].double(), cpu["grads"][k].double()
        explained = lr * (g1 / (g1.abs() + eps) - g2 / (g2.abs() + eps)).abs()
        param_gap = max(param_gap, float(gap.max()))
        param_unexplained = max(param_unexplained,
                                float((gap - explained).max()))
    print(f"[train] one exp180d step at batch {TRAIN_BATCH}, card vs CPU "
          f"(the card's max-pool choices replayed): loss {card['loss']:.6f} "
          f"vs {cpu['loss']:.6f}, rel {loss_rel:.2e} (<= {TRAIN_LOSS_RTOL:g});"
          f" worst gradient card vs CPU {grad_worst[0]:.2e} of its max abs "
          f"at {grad_worst[3]}; against the float64 step, worst card "
          f"{card_worst[1]:.2e} at {card_worst[3]} where the CPU's is "
          f"{card_worst[2]:.2e} (<= max({TRAIN_GRAD_TOL:g}, {GRAD_FACTOR} x "
          f"the CPU's)); "
          f"BatchNorm-fed conv "
          f"biases' gradients <= {zero_worst:.2e} of their weights'; "
          f"parameters after the step max gap {param_gap:.2e}, beyond what "
          f"the gradients explain {param_unexplained:.2e} (<= "
          f"{TRAIN_PARAM_ATOL:g}); BatchNorm statistics worst "
          f"{stats_worst[0]:.2e} of max abs at {stats_worst[1]} (<= "
          f"{TRAIN_STATS_TOL:g}); {card_name}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and card_ok
            and zero_worst <= TRAIN_GRAD_TOL
            and param_unexplained <= TRAIN_PARAM_ATOL
            and stats_worst[0] <= TRAIN_STATS_TOL):
        raise AssertionError("the card's train step differs from the CPU's")
    return dict(loss_rel=loss_rel, grad_worst=grad_worst[0],
                card_vs_f64=card_worst[1], param_gap=param_gap)


def probe_windows(dev):
    """16 windows of a held-out synthetic file, log-compressed and padded
    as the windowed protocol does (perf/fullsize_train_diag.py's probe)."""
    import torch

    from multipitch_architectures_tpu_torch.data import gather_windows
    from multipitch_architectures_tpu_torch.eval.inference import _pad_inputs

    x, _ = synth_file(200, seed=7)
    xp = _pad_inputs(torch.log1p(10.0 * torch.as_tensor(x, device=dev)), 75)
    return gather_windows(xp, 37 + np.arange(16), 75)


def learnable_run(dev, name, lr, files, probe, epochs=2):
    """perf/fullsize_train_diag.py's ``run`` through the port's
    ``Trainer.fit``: batch 16, no scheduler, noise 1e-4 and compression
    10, stride 5. Returns (history, probe mean/std before and after,
    seconds)."""
    import torch

    from multipitch_architectures_tpu_torch.data import (AugmentConfig,
                                                         TrainPipeline)
    from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer

    pipeline = TrainPipeline(files, context=75, stride=5,
                             augment=AugmentConfig(noisestd=1e-4,
                                                   compression=10.0),
                             target_slice=(24, 96), device=dev)
    cfg = TrainConfig(max_epochs=epochs, batch_size=16, initial_lr=lr,
                      loss="bce", es_patience=epochs, scheduler=None,
                      seed=SEED)
    trainer = Trainer(train_model(name), cfg, device=dev).init()

    def probe_stats():
        trainer.model.eval()
        with torch.no_grad():
            p = trainer.model(probe).flatten()
        return float(p.mean()), float(p.std())

    before = probe_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.fit(lambda e, s: pipeline.batches(s, cfg.batch_size))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return hist, before, probe_stats(), seconds


def phase_train(dev, card):
    """The training path: phase 8 of the module docstring. Returns the
    numbers PERF.md keeps."""
    import dataclasses
    import tempfile

    from multipitch_architectures_tpu_torch.data import FileSpec
    from multipitch_architectures_tpu_torch.experiments import (
        SyntheticCorpus, load_experiment, run_experiment)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        proc, path, card_step = start_step_card_vs_cpu(dev, tmp)
        try:
            # 8b. the exp180d recipe on the learnable task
            files = [FileSpec(*synth_file(1200, seed=s)) for s in range(3)]
            probe = probe_windows(dev)
            hist, p0, p1, sec = learnable_run(dev, TRAIN_EXPERIMENT, 5e-4,
                                              files, probe)
            loss = hist["train_loss"]
            print(f"[train] exp180d lr 5e-4 on the learnable task (3 files of "
                  f"1200 frames, stride 5, batch 16, 2 epochs, {sec:.1f} s): "
                  f"loss {loss[0]:.4f} -> {loss[1]:.4f} (the JAX package on a "
                  f"TPU: "
                  f"0.0624 -> 0.0132); probe mean/std {p0[0]:.3f}/{p0[1]:.3f}"
                  f" -> {p1[0]:.3f}/{p1[1]:.3f}")
            if not loss[1] < 0.5 * loss[0]:
                raise AssertionError(f"exp180d did not learn: epoch-2 loss "
                                     f"{loss[1]:.4f} is not below half of "
                                     f"{loss[0]:.4f}")
            out["learnable"] = dict(loss=loss, before=p0, after=p1)

            # 8c. the exp180e lr ladder (VERDICT r5 weak #3), no gate
            out["ladder"] = {}
            for lr in (5e-4, 1e-4):
                hist, p0, p1, sec = learnable_run(
                    dev, "exp180e_musicnet_unet_insanelylarge_doubleselfattn",
                    lr, files, probe)
                loss = hist["train_loss"]
                out["ladder"][lr] = dict(loss=loss, before=p0, after=p1)
                print(f"[train] exp180e lr {lr:.0e} ({sec:.1f} s): loss "
                      f"{loss[0]:.4f} -> {loss[1]:.4f}; probe mean/std "
                      f"{p0[0]:.3f}/{p0[1]:.3f} -> {p1[0]:.3f}/{p1[1]:.3f} "
                      f"(the JAX package on a TPU: lr 5e-4 0.5902 -> 0.5793, "
                      f"0.000/0.000; lr 1e-4 0.1074 -> 0.0107)")

            # 8d. resume
            resume_check(dev, files, tmp)

            # 8e. the registry step, timed
            out.update(registry_step(dev, card))

            # then one run_experiment through the test phase
            cfg = load_experiment(TRAIN_EXPERIMENT)
            cfg = dataclasses.replace(cfg, train_config=dataclasses.replace(
                cfg.train_config, max_train_batches=2))
            corpus = SyntheticCorpus(cfg, frames=600, n_train_files=3)
            t0 = time.perf_counter()
            res = run_experiment(cfg, corpus, os.path.join(tmp, "run"),
                                 logger=logging.getLogger("chip_smoke.run"),
                                 max_epochs_override=1, device=dev)
            sec = time.perf_counter() - t0
            name = cfg.name
            csv_path = os.path.join(tmp, "run", "results_filewise",
                                    name + ".csv")
            preds = sorted(os.listdir(os.path.join(tmp, "run", "predictions",
                                                   name)))
            measures = [v for agg in res["subsets"]
                        for m in ("filewise_mean", "framewise_mean")
                        for v in agg[m].values()]
            if not (os.path.isfile(csv_path) and len(preds) == 2
                    and len(measures) == 3 * 2 * 25
                    and all(np.isfinite(measures))):
                raise AssertionError(f"run_experiment: csv "
                                     f"{os.path.isfile(csv_path)}, "
                                     f"predictions {preds}, "
                                     f"{len(measures)} measures")
            fw = res["subsets"][0]["framewise_mean"]
            print(f"[train] run_experiment {name} on SyntheticCorpus (3 "
                  f"train files of 600 frames, 1 epoch, 2 batches, the test "
                  f"phase's 3 subsets): {sec:.1f} s; CSV and {len(preds)} "
                  f"prediction files written; {len(measures)} measures "
                  f"finite; framewise f_measure {fw['f_measure']:.4f}")
        except BaseException:
            proc.kill()
            proc.join()
            raise
        out["step"] = finish_step_card_vs_cpu(proc, path, card_step, card)
    return out


def resume_check(dev, files, tmp):
    """Phase 8d, at a small depth (``RESUME_BATCHES`` batches per epoch):
    straight, epoch 0 then epoch 1 in one trainer; resumed, epoch 0's
    checkpoint restored into a fresh trainer, then epoch 1. The recipe's
    augmentation, dropout 0.2 and validation in train mode all draw.
    Exact, bit for bit: the restored state (model, BatchNorm statistics,
    optimizer state, step) and the loss of epoch 1's first step (the same
    batch, augmentation and dropout draws on the same state through a
    deterministic forward). The rest of epoch 1 is printed, not bounded:
    the card's backward is not bit-deterministic (cuDNN, the bilinear
    upsampling and the overlapping max-pool add their gradients in any
    order), and AdamW's first steps move weights with gradients near eps
    by up to lr either way."""
    import dataclasses

    import torch

    from multipitch_architectures_tpu_torch.data import TrainPipeline
    from multipitch_architectures_tpu_torch.experiments import load_experiment
    from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer
    from multipitch_architectures_tpu_torch.train.trainer import _Checkpointer

    recipe = load_experiment(TRAIN_EXPERIMENT)
    train_p = TrainPipeline(files, stride=5, augment=recipe.augment,
                            device=dev)
    val_p = TrainPipeline(files, stride=recipe.val_stride, device=dev)
    cfg = TrainConfig(max_epochs=1, batch_size=16, initial_lr=1e-3,
                      scheduler=None, es_patience=2, seed=SEED,
                      max_train_batches=RESUME_BATCHES,
                      val_in_train_mode=True)

    def batches(epoch, seed):
        return train_p.batches(seed, cfg.batch_size)

    def val(epoch, seed):
        return val_p.batches(seed, recipe.val_batch_size, shuffle=False,
                             drop_remainder=False)

    def recorded(trainer):
        losses, step = [], trainer.train_step

        def train_step(*args):
            losses.append(step(*args))
            return losses[-1]

        trainer.train_step = train_step
        return losses

    ck = os.path.join(tmp, "resume")
    straight = Trainer(train_model(), cfg, device=dev).init()
    metric = straight.fit(batches, val, checkpoint_dir=ck)["val_loss"][0]
    two = dataclasses.replace(cfg, max_epochs=2)
    resumed = Trainer(train_model(), two, device=dev)
    epoch, resumed.lr, saved = _Checkpointer(ck).restore(resumed)
    straight.config = two
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    oa, ob = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    state_equal = (epoch == 0 and saved == metric
                   and straight.step == resumed.step
                   and all(torch.equal(a[k], b[k]) for k in a)
                   and all(torch.equal(oa["state"][i][k].cpu(),
                                       ob["state"][i][k].cpu())
                           for i in oa["state"] for k in oa["state"][i]))
    la, lb = recorded(straight), recorded(resumed)
    ha = straight.fit(batches, val, start_epoch=1, initial_best=metric)
    hb = resumed.fit(batches, val, start_epoch=1, initial_best=saved)
    first_equal = torch.equal(la[0], lb[0])
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    worst = max((float((a[k].double() - b[k].double()).abs().max()
                       / a[k].double().abs().max().clamp(min=1e-30)), k)
                for k in a if a[k].is_floating_point())
    print(f"[train] resume ({RESUME_BATCHES} batches per epoch, the recipe's "
          f"augmentation, dropout, validation in train mode): restored state "
          f"{'equal' if state_equal else 'DIFFERENT'} bit for bit; epoch 1's "
          f"first step loss {float(la[0]):.6f} vs {float(lb[0]):.6f} "
          f"({'equal' if first_equal else 'DIFFERENT'}); after epoch 1: train "
          f"loss {ha['train_loss'][0]:.6f} vs {hb['train_loss'][0]:.6f}, val "
          f"loss {ha['val_loss'][0]:.6f} vs {hb['val_loss'][0]:.6f}, worst "
          f"state gap {worst[0]:.2e} of max abs at {worst[1]} (the card's "
          f"non-deterministic backward, not bounded)")
    if not (state_equal and first_equal):
        raise AssertionError("resume is not exact on the card")


def registry_step(dev, card):
    """Phase 8e: exp180d at batch 25 with the registry's augmentation:
    train_step time, the pipeline alone, peak memory, idle share and top
    kernels, FLOPs."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from multipitch_architectures_tpu_torch.data import FileSpec, TrainPipeline
    from multipitch_architectures_tpu_torch.experiments import load_experiment
    from multipitch_architectures_tpu_torch.train import Trainer

    cfg = load_experiment(TRAIN_EXPERIMENT)
    files = [FileSpec(*synth_file(3000, seed=10 + s)) for s in range(8)]
    pipeline = TrainPipeline(files, context=cfg.context,
                             stride=cfg.train_stride, augment=cfg.augment,
                             device=dev)
    trainer = Trainer(cfg.build_model(), cfg.train_config, device=dev).init()
    bs = cfg.train_config.batch_size
    batches = list(pipeline.batches(SEED, bs))
    n = len(batches)
    step_i = iter(range(10 ** 6))

    def step():
        trainer.train_step(*batches[next(step_i) % n])

    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(step, reps=TIMED_STEPS, warmup=3)
    peak = torch.cuda.max_memory_allocated(dev)

    def epoch():
        for _ in pipeline.batches(SEED + 1, bs):
            pass

    epoch()
    pipe_ms = cuda_ms(epoch, reps=3, warmup=0) / n
    pipe_host_ms = host_ms(epoch) / n

    def fed_steps():
        for i, (x, y) in enumerate(pipeline.batches(SEED + 2, bs)):
            trainer.train_step(x, y)
            if i == 2:
                break

    idle, wall, top = device_profile(fed_steps, top=6)
    fc = FlopCounterMode(display=False)
    with fc:
        step()
    flops = fc.get_total_flops()
    share = flops / (step_ms / 1e3) / F32_FLOP_PER_S
    # diagnostic: cuDNN's own algorithm search in place of its heuristics
    torch.backends.cudnn.benchmark = True
    try:
        bench_ms = cuda_ms(step, reps=TIMED_STEPS, warmup=3)
    finally:
        torch.backends.cudnn.benchmark = False
    print(f"[train] exp180d registry step at batch {bs} (noise 1e-4, EQ 20, "
          f"transposition 5, tuning, compression 10; TF32 off): "
          f"{step_ms:.2f} ms per train_step (CUDA events, {TIMED_STEPS} steps"
          f" after 3 warm-ups); pipeline alone {pipe_ms:.3f} ms per batch "
          f"({bs / pipe_ms * 1e3:,.0f} windows/s; {n} batches per epoch; "
          f"host {pipe_host_ms:.3f} ms per batch); "
          f"peak device memory {peak / 2**30:.2f} GiB; {flops / 1e12:.3f} "
          f"TFLOP per step (FlopCounterMode) = {share:.1%} of the float32 "
          f"peak {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s; {card}")
    print(f"[train] diagnostic: with torch.backends.cudnn.benchmark on "
          f"(cuDNN times its algorithms), {bench_ms:.2f} ms per train_step "
          f"against {step_ms:.2f}; {card}")
    idle_txt = "not measured (no device kernels in the trace)" \
        if idle is None else f"{idle:.2%}"
    print(f"[train] 3 steps fed by the pipeline, profiled: wall "
          f"{wall * 1e3:.1f} ms, device idle {idle_txt}; top kernels: "
          + "; ".join(f"{k} {ms:.2f} ms" for k, ms in top))
    return dict(step_ms=step_ms, pipe_ms=pipe_ms, peak=peak, flops=flops,
                share=share, idle=idle, top=top, bench_ms=bench_ms)


def main():
    t0 = time.perf_counter()
    seconds = {}

    def lap(phase):
        nonlocal t0
        t = time.perf_counter()
        seconds[phase], t0 = t - t0, t

    dev, card = phase_device()
    phase_build()
    lap("device and build")
    cqt = phase_kernel(dev, card)
    lap("kernel")
    phase_hcqt(dev)
    lap("hcqt")
    cqt_launches, model, cpu_model = phase_serving(dev, card)
    lap("serving")
    gemm = phase_int8_kernel(dev, model)
    lap("int8-kernel")
    gemm_launches, sums_err = phase_int8_serving(dev, card, model, cpu_model)
    lap("int8-serving")
    gemm["max_abs_err"] = max(gemm["max_abs_err"], sums_err)
    del model, cpu_model

    import torch

    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        int8_conv2d_dequant)

    int8_conv2d_dequant.launches = cqt_octaves.launches = 0
    phase_train(dev, card)
    print(f"[train] the training path launched the CQT kernel "
          f"{cqt_octaves.launches} times and the int8 GEMM "
          f"{int8_conv2d_dequant.launches} times: it has no hand-written "
          f"kernel (its backward runs through autograd and cuDNN)")
    lap("train")

    print("[phases] seconds: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in seconds.items()))
    print(card)
    print(json.dumps({"kernels": [{
        "name": "cqt_octave",
        "route": "cuda",
        "source": "multipitch_architectures_tpu_torch/csrc/cqt_octave.cu",
        "replaces": "multipitch_architectures_tpu/ops/pallas_cqt.py:73",
        "launches": cqt_launches,
        **cqt,
    }, {
        "name": "int8_gemm",
        "route": "cuda",
        "source": "multipitch_architectures_tpu_torch/csrc/int8_gemm.cu",
        "replaces": "perf/pallas_int8_matmul_probe.py:44 and "
                    "perf/pallas_int8_matmul_probe.py:141",
        "launches": gemm_launches,
        **gemm,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
