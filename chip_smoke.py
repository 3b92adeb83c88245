#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving path, audio -> HCQT -> SAUnet:XL windowed
protocol, in phases, and prints each phase's result on its own line:

1. device: requires CUDA, prints the card's name and power limit, and
   sets the float32 parity flags (no TF32);
2. build: compiles the CQT octave kernel from ``csrc/`` with nvcc;
3. kernel: the kernel against its plain PyTorch version on the card at
   the serving path's shapes (n_fft 512 and 256, hops 512..2, 5069 and
   301 frames; also 12, 24 and 60 bins per octave), rel-to-peak
   tolerance 1e-5, and both timed by CUDA events at 5069 frames;
4. hcqt: the HCQT of the bench's 117.701-s span on the card against the
   same HCQT on the CPU, where each octave runs the plain version
   (rel-to-peak 1e-5); the kernel must launch 21 times;
5. serving: exp180e at full width with seeded random weights and
   ``cross_batch:50`` attention answers 10-s, 4-s and 2.5-s requests
   through ``hcqt`` and ``predict_framewise(batch_size=250, group=50)``;
   each output must be (T, 72), finite and within [0, 1], and a batch of
   windows must match the same model on the CPU (atol 1e-4).

The kernel launch counts are reset just before the three requests and
read just after. The line before the last is a JSON object with each
kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``. Any failing phase raises, and the
script exits non-zero without that line.
"""

import copy
import json
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
K1_FRAMES = 5069     # frames of the bench span: 117.701 s · 22050 // 512 + 1
# (n_fft, hops) of the serving HCQT's 21 octaves: bases 0.5, 3 and 5 have
# 9, 6 and 6 octaves, the hop halving from 512 in each
MAIN_PATH_OCTAVES = ([(512, HOP >> k) for k in range(9)]
                     + [(512, HOP >> k) for k in range(6)]
                     + [(256, HOP >> k) for k in range(6)])


def audio(seconds, seed):
    """bench.py's harmonic tone on C4 plus seeded noise."""
    t = np.arange(int(seconds * FS)) / FS
    y = sum((1.0 / h) * np.sin(2 * np.pi * 261.63 * h * t)
            for h in (1, 2, 3, 4, 5))
    y = y + 1e-3 * np.random.RandomState(seed).randn(len(t))
    return y.astype(np.float32)


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

    from multipitch_architectures_tpu_torch.ops import _build
    from multipitch_architectures_tpu_torch.ops.cqt_octave import _lib

    t0 = time.perf_counter()
    _lib()
    log = _build.library_path("cqt_octave") + ".log"
    print(f"[build] cqt_octave.cu ready in {time.perf_counter() - t0:.2f} s")
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"[build] ptxas: {line.strip()}")


def phase_kernel(dev):
    """The kernel against its plain version on the card; returns
    (max abs error, kernel ms, plain ms), the times summed over the 21
    octaves of one bench-span HCQT."""
    import torch

    from multipitch_architectures_tpu_torch.ops.cqt_octave import (
        cqt_octave, cqt_octave_reference)

    rng = np.random.RandomState(SEED)
    worst_abs, worst_rel, times, n_shapes = 0.0, 0.0, {}, 0
    for n_fft in (512, 256):
        kr = torch.as_tensor(rng.randn(n_fft, 2 * BPO) * 0.01,
                             dtype=torch.float32, device=dev)
        for hop in [HOP >> k for k in range(9)]:
            for n_frames in (K1_FRAMES, 301):
                y = torch.as_tensor(
                    rng.uniform(-1, 1, (n_frames - 1) * hop + n_fft),
                    dtype=torch.float32, device=dev)
                kw = dict(hop=hop, n_fft=n_fft, bpo=BPO, n_frames=n_frames)
                got = cqt_octave(y, kr, **kw)
                want = cqt_octave_reference(y, kr, **kw)
                torch.cuda.synchronize()
                rel = rel_to_peak(got, want)
                n_shapes += 1
                worst_abs = max(worst_abs, float((got - want).abs().max()))
                worst_rel = max(worst_rel, rel)
                if not (got.shape == (n_frames, BPO) and rel < K1_TOL):
                    raise AssertionError(
                        f"kernel vs plain: n_fft {n_fft} hop {hop} frames "
                        f"{n_frames}: shape {tuple(got.shape)}, rel {rel:.3g}")
                if n_frames == K1_FRAMES:
                    times[n_fft, hop] = (
                        cuda_ms(lambda: cqt_octave(y, kr, **kw)),
                        cuda_ms(lambda: cqt_octave_reference(y, kr, **kw)))
                    print(f"[kernel] n_fft {n_fft} hop {hop:3d} frames "
                          f"{n_frames}: kernel {times[n_fft, hop][0]:.4f} ms,"
                          f" plain {times[n_fft, hop][1]:.4f} ms, "
                          f"rel {rel:.2e}")
    # the other bins-per-octave widths the kernel is compiled for (12, 24
    # and 60 select 1, 2 and 4 bins per thread; 36 selects 3)
    for bpo in (12, 24, 60):
        kr = torch.as_tensor(rng.randn(512, 2 * bpo) * 0.01,
                             dtype=torch.float32, device=dev)
        y = torch.as_tensor(rng.uniform(-1, 1, 300 * 64 + 512),
                            dtype=torch.float32, device=dev)
        kw = dict(hop=64, n_fft=512, bpo=bpo, n_frames=301)
        rel = rel_to_peak(cqt_octave(y, kr, **kw),
                          cqt_octave_reference(y, kr, **kw))
        n_shapes += 1
        worst_rel = max(worst_rel, rel)
        if not rel < K1_TOL:
            raise AssertionError(f"kernel vs plain at bpo {bpo}: rel {rel:.3g}")
    ms = sum(times[o][0] for o in MAIN_PATH_OCTAVES)
    plain_ms = sum(times[o][1] for o in MAIN_PATH_OCTAVES)
    print(f"[kernel] {n_shapes} shapes within rel-to-peak {K1_TOL:g}: worst rel "
          f"{worst_rel:.3e}, worst abs {worst_abs:.3e}; the 21 octaves of "
          f"one {BENCH_SECONDS}-s HCQT: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    return worst_abs, ms, plain_ms


def phase_hcqt(dev):
    import torch

    from multipitch_architectures_tpu_torch.dsp import hcqt
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octave

    y = audio(BENCH_SECONDS, SEED)
    before = cqt_octave.launches
    t0 = time.perf_counter()
    got = hcqt(y, device=dev, **HCQT_KW)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cqt_octave.launches - before
    want = hcqt(y, device="cpu", **HCQT_KW)[0]
    rel = rel_to_peak(got.cpu(), want)
    n_frames = len(y) // HOP + 1
    if got.shape != (6, n_frames, 216) or launches != 21 or rel >= HCQT_TOL:
        raise AssertionError(f"hcqt: shape {tuple(got.shape)}, {launches} "
                             f"launches, rel {rel:.3g}")
    print(f"[hcqt] {BENCH_SECONDS} s -> {tuple(got.shape)}: 21 launches, "
          f"card vs CPU rel-to-peak {rel:.3e} (< {HCQT_TOL:g}), first call "
          f"{wall * 1e3:.1f} ms")


def phase_serving(dev, card):
    """Returns the kernel launches counted over the three requests."""
    import torch

    from multipitch_architectures_tpu_torch.data import gather_windows
    from multipitch_architectures_tpu_torch.dsp import hcqt
    from multipitch_architectures_tpu_torch.eval import predict_framewise
    from multipitch_architectures_tpu_torch.eval.inference import _pad_inputs
    from multipitch_architectures_tpu_torch.experiments import load_experiment
    from multipitch_architectures_tpu_torch.models import init_parameters
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octave

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
    cqt_octave.launches = 0
    results = [serve(y) for y in requests]
    launches = cqt_octave.launches
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
    if launches != 21 * len(requests):
        raise AssertionError(f"{launches} kernel launches in "
                             f"{len(requests)} requests, want 63")

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
    return launches


def main():
    dev, card = phase_device()
    phase_build()
    max_abs_err, ms, plain_ms = phase_kernel(dev)
    phase_hcqt(dev)
    launches = phase_serving(dev, card)

    import torch

    print(card)
    print(json.dumps({"kernels": [{
        "name": "cqt_octave",
        "route": "cuda",
        "source": "multipitch_architectures_tpu_torch/csrc/cqt_octave.cu",
        "replaces": "multipitch_architectures_tpu/ops/pallas_cqt.py:73",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
