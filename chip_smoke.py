#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving paths, audio -> HCQT -> SAUnet:XL windowed
protocol in float32 and in int8, its training path (SAUnet:L), the
rest of the registry's model zoo (CNN, DRCNN, Unet, SAUSnet, BLUnet and
PUnet: serving, dense serving of the CNNs, training), and the audio-in
path (WAV and note-event files to tuned, streamed HCQT features and
pitch rolls, training from them and precomputing them), serving
beyond the windowed protocol (shared ``inc``, exported artifacts in
float32 and int8, percentile calibration, the PUnet's int8 aux head),
the zoo's other 19 classes, the native window loader and the
reference-compatible datasets, the device mesh (sharded training,
serving and test phase) and the pretrained-prediction CLI, in phases,
and prints each phase's result on its own line:

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
   b. ``perf/fullsize_train_diag.py`` through the port's ``Trainer.fit``
      (``deterministic`` off: learning, not resume, is checked):
      exp180d at lr 5e-4, batch 16, 2 epochs on the learnable synthetic
      task (3 files of 1200 frames, stride 5), loss history and probe
      predictions printed; the epoch-2 loss must fall below half of
      epoch 1's;
   c. the exp180e lr ladder (5e-4, 1e-4), the same recipe, printed;
   d. resume, with ``TrainConfig.deterministic`` (the default): epoch 0's
      checkpoint restored into a fresh trainer must equal the trainer that
      wrote it, bit for bit, and the whole resumed epoch 1 must repeat the
      straight run's bit for bit: every step's loss, the epoch's train and
      validation losses, then every weight, BatchNorm statistic and
      optimizer state;
   e. the registry step timed at batch 25 with the recipe's augmentation
      (CUDA events, 20 steps after 3 warm-ups), with ``deterministic`` on
      and off, the pipeline alone,
      peak memory, three pipeline-fed steps profiled (idle share, top
      kernels), the step's FLOPs (``FlopCounterMode``) and their share
      of the float32 peak; then one ``run_experiment`` on
      ``SyntheticCorpus`` (1 epoch) through the test phase: its CSV, its
      prediction files and 150 finite measures;
9. zoo: one registry configuration per class of the zoo besides the
   SAUnet, at full width and depth, built through ``load_experiment`` with
   the weights that the JAX package's ``model.init`` draws (seeded): CNN:M
   (exp126c), DRCNN (exp128c), Unet:XL (exp160f), SAUSnet:XL (exp181f,
   ``cross_batch:50``), BLUnet:L (exp186d) and PUnet:XL (exp195f). Each
   must have its logged parameter count; answers a warm-up request and a
   10-s request through ``hcqt`` and ``predict_framewise(batch_size=250,
   group=50 for the attention model)``, (T, 72), finite and within [0, 1]
   (the PUnet's ``return_aux`` polyphony logits (T, 24), finite), with one
   CQT kernel launch per request, its wall time, real-time factor and peak
   device memory printed; the two CNNs also serve the 10-s request through
   ``predict_dense`` and ``predict_dense_chunked(chunk=512)``, each timed,
   its max abs gap to the windowed output printed; and 4 windows run on
   the card and, in a process of its own with one thread, on the CPU
   (atol 1e-4, the PUnet's logits included). Then one train step at batch
   25 of DRCNN (bce) and of PUnet:XL (multitask), dropout 0, on the card
   against a CPU process started with the script (a full-width step takes
   minutes on one core), the CPU's max-pool choices replayed on the card:
   loss rel 1e-5; each step timed (CUDA events, 20 steps after 3
   warm-ups) with ``deterministic`` on and off, with its FLOPs and their
   share of the float32 peak;
10. audio:
   a. a corpus in MusicNet's formats, synthesized from a seed on the
      card: 6 recordings of 60 s (sums of 5-partial harmonic tones following
      random note events, MIDI 24-96, up to 4 voices) as 44.1-kHz stereo
      int16 WAVs, each with a MusicNet csv (sample indices at 44.1 kHz),
      named by exp180d's split prefixes; and 20-s files in each other
      preset's annotation format (swd, bach10, phenicx, csd) and in other
      sample formats (uint8, float32 at 48 kHz, a 22.05-kHz ``.npy``).
   b. each file through the load path (``load_audio``, the HCQT with its
      tuning estimated, the roll) on the card and on the CPU (each octave
      through the plain version): HCQT rel-to-peak 1e-5, the same
      tunings, the same rolls; a chord detuned by +0.3 bin must read so
      within 0.15;
   c. a 20-min recording (51,680 frames): the whole HCQT against the same
      HCQT through the plain version on the card (rel-to-peak 1e-5) and
      against ``chunk_frames=8192`` (rel-to-peak 1e-5, one launch per
      chunk), and the exact plan once; each timed, with its peak device
      memory;
   d. the load path of a 5-min 44.1-kHz stereo WAV split into the read
      and resample, the tuning, the HCQT and the roll, and its seconds of
      audio per second;
   e. one ``run_experiment`` of exp180d at full width on ``AudioCorpus``
      (1 epoch, 2 batches) through the test phase: its CSV, its 3
      prediction files, 150 finite measures, one CQT launch per file;
      then the precompute CLI on the same corpus: ``NpyCorpus`` over its
      output must equal ``AudioCorpus.load`` bit for bit.

11. serving-2: exp180e as in phase 5 on 10-s and 30-s requests (the HCQT
   through K1):
   a. ``predict_framewise_shared`` (the ``inc`` interior shared across
      windows) against ``predict_framewise``: max abs 1e-4; both timed in
      turns (3 repeats each, with peak memory); the 10-s request split by
      CUDA events into the dense precompute, the assembly and the rest;
   b. shared-inc int8 on the 10-s request, scales from its first fused
      batch: 19 K2/K3 launches per int8 batch (``inc`` stays float32), its
      worst-of-25 drift against float32 beside the windowed int8 mode's
      on the same scales, its time;
   c. the float32 artifact (``serve.export_window_forward``, batch 250,
      ``grouped:50``) written to a file and served by a fresh process that
      imports only the port's ``serve``: the 10-s request's 431 frames go
      as 250 and a tail of 181 padded to 250, the warning must name the
      last 31 frames, every other frame within 1e-5 of
      ``predict_framewise``; export, load and request times and bytes;
   d. the int8 artifact with b's scales: two batches of 250 windows equal
      to the eager ``quantize_convs`` forward within 1e-6, 21 K2/K3
      launches per batch counted from inside the artifact;
   e. percentile (99.9) scales of one batch of 250, card vs CPU (rel
      1e-6, per tensor and per channel) and timed; PUnet:XL (exp195f)
      ``predict_framewise_int8(return_aux=True)`` on the 10-s request: the
      calibration span's aux rows equal to float32 within 1e-6;
   f. ``utils.count_macs`` of exp180e per window (the JAX package: 41.60
      G), and a ``utils.trace`` of one shared-inc request: its device idle
      share and top kernels.

12. zoo-2: the zoo's other 19 classes (``ZOO2``) at full width and
   depth with seeded flax-drawn weights: the standard trunk at exp180e's
   widths (SimpleUNet, SelfAttn, SixSelfAttn, VarLayers at depth 3,
   AllLayers with mlp_dim 512, TransEnc with 30 channels after its conv2
   and time_embed_dim 72 x 30, the three polyphony U-Nets), the two
   temporal U-Nets (scalefac 2, embed_dim 1728), the four freq U-Nets
   (scalefac 1) and the four CNNs at CNN:M's widths; attention models in
   ``cross_batch:50`` groups. Each prints its configuration and parameter
   count, answers a warm-up request and a 4-s request through ``hcqt``
   and ``predict_framewise(batch_size=250, group=50)`` with one K1 launch
   each, (T, 72) finite ((T, 73) for the bottom stack, (T, 2 x 72) and
   (T, 2 x 73) log-probabilities for the log-softmax CNNs, the polyphony
   heads' outputs per frame), its wall time, real-time factor and peak
   memory printed; 4 windows card vs a CPU process started with the
   script (atol 1e-4, the polyphony outputs included; the CPU's
   freq-pool choices replayed where the two devices' values are within
   1e-5, counted). One AdamW step at batch 25 (dropout 0, BatchNorm in
   train mode) of FreqUNetDoubleSelfAttn, the temporal U-Net with
   attention and SixSelfAttn against the CPU's step (loss rel 1e-5), the
   CPU's pooling choices replayed. FreqUNetDoubleSelfAttn answers a 10-s
   request through ``predict_framewise_int8(batch_size=250, group=50,
   cal_batches=1)``: the calibration span equal to the float32 protocol
   (1e-6), the fused K2/K3 entry launched once per quantized conv per
   int8 batch, the worst-of-25 drift printed;
13. loaders, on the precompute CLI's output of phase 10's corpus
   ((216, T, 6) / (128, T)):
   a. the native loader (its C++ source built with g++): ``fill`` of
      1000 seeded indices equal to ``gather_windows`` bit for bit;
   b. one epoch of ``trainer_batches`` on the card (pinned buffers,
      ``non_blocking`` copies, ``log1p`` on the card) against
      ``TrainPipeline`` on the same windows, in windows per second;
   c. exp180d through ``Trainer.fit`` for 20 steps at batch 25 fed by
      each, ms per step side by side, and 3 loader-fed steps profiled
      (device idle share);
   d. ``dataset_context`` with every ``aug:*`` key through a
      ``DataLoader(pin_memory=True)`` into 3 exp180d steps: the first
      batch's items equal to the same items built on the CPU;
14. parallel, on three meshes (``parallel.make_mesh``): the visible cards,
   and two logical meshes of four shards on the card, ``data=4`` and
   ``data=2 x model=2`` (tensor parallelism of the attention and MLPs):
   a. one AdamW step of exp180d at full width (seeded flax-drawn weights,
      its generator seeded) at batch 24 (dropout on) and at the
      protocol's 25 (padded by the trainer to a multiple of the mesh's
      devices, 28, with loss weight 0; dropout off on both sides: the
      mesh step draws the unpadded batch's masks) on each mesh, against
      the one-device step on the same rows and weights, in float32 and
      in float64: loss rel 1e-5 in both, all gradients' relative L2 1e-3
      in float64 (printed in float32, whose gradients of exp180d are
      good to a few 1e-2);
   b. CNN:M (exp126c, no batch coupling), dropout on, at batch 5 on the
      ``data=4`` mesh (padded to 8): its loss equals the unpadded
      one-device step's (rel 1e-5), as the JAX package's padded step is;
   c. ``Trainer(model, cfg)`` with no device or mesh: the card count and
      the path taken (the one-device step on one card, a ``data`` mesh of
      every card on several);
   d. the step at batch 24 timed on one device and on each mesh (a
      one-card mesh is not timed), ``deterministic`` on and off;
   e. a 10-s exp180e request (``cross_batch:50``, its HCQT on K1) through
      ``predict_framewise_sharded`` on the ``data=4`` mesh at per-device
      batches of 250 and 100, within 2e-5 of ``predict_framewise(
      batch_size=250, group=50)``, one K1 launch per request, timed;
   f. one ``run_experiment`` test phase of exp180d on the ``data=4`` mesh:
      its dispatch sharded, every prediction within 2e-5 of the same run
      on one device.
15. predict: the pretrained-prediction CLI (``python -m
   multipitch_architectures_tpu_torch.experiments.predict``, the
   counterpart of ``examples/predict_pretrained.py``) through its
   ``main`` in this process, on exp180e at full width with seeded
   flax-drawn weights saved as a bare ``state_dict`` ``.pt`` and a
   synthetic 10-s 22.05-kHz WAV made from a seed:
   a. ``--audio`` against ``compute_efficient_hcqt`` then
      ``predict_framewise(batch_size=50)`` in this process (1e-5; the
      same code), one K1 launch;
   b. ``--hcqt`` on a's HCQT saved in the reference's (216, T, 6) layout,
      against a (1e-5);
   c. ``--int8`` against ``predict_framewise_int8`` in this process
      (1e-6), the same K2/K3 launches, printed;
   d. PUnet:XL (exp195f) with ``--audio``: its ``_polyphony.npy`` (T, 24)
      equal to ``predict_framewise(return_aux=True)``'s aux output (1e-5);
   then a's request once more in a fresh process, within 1e-5 of a.
   Each request's wall time and the fresh process's start-up are
   printed.

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
# AudioCorpus's HCQT (its defaults), the tuning given apart
HCQT_AUDIO = dict(fs=FS, fs_hcqt_target=50.0, bins_per_octave=36,
                  num_octaves=6)
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
# the zoo phase: (registry entry, the paper's name, logged parameter
# count; tests/test_torch_zoo.py): SAUSnet:XL's log misses its four
# attention cores of 66,048 parameters, the identity residual adds none to
# DCNN:L's 4,814,683, and Unet:XL's count is the JAX model's
ZOO = (
    ("exp126c_musicnet_cnn_verywide", "CNN:M", 1_813_293),
    ("exp128c_musicnet_cnn_deepresnetverywide", "DRCNN", 4_814_683),
    ("exp160f_musicnet_unet_veryverylarge", "Unet:XL", 14_251_699),
    ("exp181f_musicnet_unet_intermedlarge_doubleselfattn_twolayers",
     "SAUSnet:XL", 14_435_647 + 4 * 66_048),
    ("exp186d_musicnet_unet_extremelylarge_blstm", "BLUnet:L", 9_649_003),
    ("exp195f_musicnet_unet_extremelylarge_polyphony_softmax", "PUnet:XL",
     14_597_963),
)
ZOO_PUNET = ZOO[5][0]
ZOO_DENSE = (ZOO[0][0], ZOO[1][0])          # the CNN family serves dense too
ZOO_TRAIN = (ZOO[1][0], ZOO_PUNET)          # bce, multitask
ZOO_SECONDS = 10.0
ZOO_CHECK_WINDOWS = 4
# phase 12 ("zoo-2"): the zoo's other 19 classes at full width, (registry
# class, configuration, batch of its requests). The standard trunk is
# exp180e's; the reference code's own constraints fix the rest (PERF.md
# §4): the varlayers' level 3 has 972 tokens (no positional table of 600
# rows), AllLayers' level 1 has 75 x 216 tokens (mlp_dim 512), TransEnc's
# temporal layers need F·C = time_embed_dim = 72 x 30, the temporal
# U-Nets' level 5 is 864 channels x 2 bins = 1728
Z2_TRUNK = dict(n_chan_layers=(128, 200, 150, 150), n_bins_out=72,
                scalefac=2)
Z2_ATTN = dict(embed_dim=256, num_heads=8, mlp_dim=8192)
Z2_SIN = dict(pos_encoding="sinusoidal")
Z2_TEMPORAL = dict(Z2_TRUNK, embed_dim=1728, num_heads=8, mlp_dim=8192)
Z2_FREQ = dict(n_chan_layers=(32, 30, 20, 10), n_bins_out=72, scalefac=1)
Z2_CNN = dict(n_chan_layers=(250, 150, 100, 100), n_bins_out=72)
ZOO2 = (
    ("simple_u_net", Z2_TRUNK, BATCH),
    ("simple_u_net_selfattn", dict(Z2_TRUNK, **Z2_ATTN), BATCH),
    ("simple_u_net_sixselfattn", dict(Z2_TRUNK, **Z2_ATTN, **Z2_SIN), BATCH),
    ("simple_u_net_doubleselfattn_varlayers",
     dict(Z2_TRUNK, **Z2_ATTN, self_attn_depth=3, self_attn_number=2), BATCH),
    ("simple_u_net_doubleselfattn_alllayers",
     dict(Z2_TRUNK, embed_dim=256, num_heads=8), BATCH),
    ("simple_u_net_doubleselfattn_transenc",
     dict(Z2_TRUNK, **Z2_ATTN, **Z2_SIN, n_chan_layers=(128, 30, 20, 10),
          self_attn_depth=1, self_attn_number=2, time_embed_dim=72 * 30),
     BATCH),
    ("u_net_temporal_selfattn_varlayers",
     dict(Z2_TEMPORAL, **Z2_SIN, self_attn_depth=1, self_attn_number=2),
     BATCH),
    ("u_net_temporal_blstm_varlayers",
     dict(Z2_TRUNK, embed_dim=1728, hidden_size=864, lstm_depth=1,
          lstm_number=2), BATCH),
    ("freq_u_net", Z2_FREQ, BATCH),
    ("freq_u_net_bottomstack", Z2_FREQ, BATCH),
    ("freq_u_net_selfattn", dict(Z2_FREQ, embed_dim=64, num_heads=8), BATCH),
    ("freq_u_net_doubleselfattn", dict(Z2_FREQ, embed_dim=64, num_heads=8),
     BATCH),
    ("simple_u_net_doubleselfattn_polyphony",
     dict(Z2_TRUNK, **Z2_ATTN, **Z2_SIN), BATCH),
    ("simple_u_net_doubleselfattn_polyphony_classif",
     dict(Z2_TRUNK, **Z2_ATTN, **Z2_SIN, num_polyphony_steps=24), BATCH),
    ("simple_u_net_polyphony_classif",
     dict(Z2_TRUNK, num_polyphony_steps=24), BATCH),
    ("basic_cnn", Z2_CNN, BATCH),
    ("basic_cnn_pool", Z2_CNN, BATCH),
    ("basic_cnn_segm_logsoftmax", dict(Z2_CNN, n_ch_out=2), BATCH),
    ("basic_cnn_segm_blank_logsoftmax", dict(Z2_CNN, n_ch_out=2), BATCH),
)
ZOO2_FAMILY = {name: ("cnns" if name.startswith("basic_cnn") else
                      "freq" if name.startswith(("freq", "u_net_temporal"))
                      else "unets") for name, _, _ in ZOO2}
# the freq U-Net that serves int8 and the three classes trained one step
ZOO2_INT8 = "freq_u_net_doubleselfattn"
ZOO2_TRAIN = ("freq_u_net_doubleselfattn", "u_net_temporal_selfattn_varlayers",
              "simple_u_net_sixselfattn")
ZOO2_SECONDS = 4.0
ZOO2_INT8_SECONDS = 10.0


def zoo2_kwargs(name):
    """Phase 12's configuration of registry class ``name``."""
    return dict(next(kw for n, kw, _ in ZOO2 if n == name))


# (n_fft, octaves) of the serving HCQT's three bases, 0.5, 3 and 5: the
# hop halves from 512 at each octave
MAIN_PATH_BASES = ((512, 9), (512, 6), (256, 6))
MAIN_PATH_OCTAVES = [(n_fft, HOP >> k) for n_fft, n in MAIN_PATH_BASES
                     for k in range(n)]
# the audio phase (10): MusicNet's file formats, synthesized from a seed
WAV_RATE = 44100                 # MusicNet's WAVs; its csv counts samples
CORPUS_SECONDS = 60.0
# exp180d's split prefixes: 2 train files, val (1729_), test (2303_,
# 1819_, 2382_; also the small-set subsets)
CORPUS_NAMES = ("1727_synth", "1730_synth", "1729_synth", "2303_synth",
                "1819_synth", "2382_synth")
EXTRA_SECONDS = 20.0
LONG_SECONDS = 20 * 60.0         # ≈ 51,700 frames at 43.07 Hz
CHUNK_FRAMES = 8192
SPLIT_SECONDS = 300.0
# rel-to-peak, a streamed HCQT against the whole one: the same octaves,
# the decimating conv1d over another length may round otherwise
STREAM_TOL = 1e-5
DETUNE_BINS, DETUNE_TOL = 0.3, 0.15      # tests/test_dsp.py:141


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
    ``top`` kernels by device time); see :func:`trace_summary`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return trace_summary(prof, wall, top)


def trace_summary(prof, wall, top=8):
    """(device idle share, ``wall``, [(kernel, device ms)] of the ``top``
    kernels by device time) of a finished profile. Busy time is the union
    of the device kernels' intervals; idle share is the rest of the host
    wall time of the call. The share is None when the trace holds no
    device kernel."""
    import torch

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


class freq_pools:
    """Within the block, record (``replay=False``) or replay the freq
    U-Nets' pooling choices, ``max_pool_with_indices_freq`` as
    ``models.unets`` calls it, in call order into or from ``indices``.
    There the index moves the value (the unpool puts it back at the
    index), so a window whose two largest values lie within the devices'
    float32 gap would change the forward itself. On replay, the card's
    own choice must agree with the recording but where the two values
    lie within ``tol`` of each other; those windows take the recorded
    index, and ``flips`` counts them."""

    def __init__(self, indices, replay, tol=1e-5):
        self.indices, self.replay, self.tol = indices, replay, tol
        self.flips, self.calls = 0, 0

    def __enter__(self):
        from multipitch_architectures_tpu_torch.models import unets

        self.module, self.orig = unets, unets.max_pool_with_indices_freq
        unets.max_pool_with_indices_freq = self.pool
        return self

    def __exit__(self, *exc):
        self.module.max_pool_with_indices_freq = self.orig

    def pool(self, x, k):
        pooled, idx = self.orig(x, k)
        self.calls += 1
        if not self.replay:
            self.indices.append(idx.cpu())
            return pooled, idx
        want = self.indices[self.calls - 1].to(x.device)
        xr = x.reshape(*x.shape[:-1], x.shape[-1] // k, k)
        at = xr.gather(-1, want[..., None])[..., 0]
        differ = want != idx
        if bool(differ.any()):
            gap = float((pooled - at)[differ].detach().abs().max())
            if gap > self.tol:
                raise AssertionError(f"freq pool: the card's choice differs "
                                     f"from the recording by {gap:.3e}, "
                                     f"beyond a float32 near-tie")
            self.flips += int(differ.sum())
        return at, want


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
    10, stride 5, ``deterministic`` off. Returns (history, probe mean/std
    before and after, seconds)."""
    import torch

    from multipitch_architectures_tpu_torch.data import (AugmentConfig,
                                                         TrainPipeline)
    from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer

    pipeline = TrainPipeline(files, context=75, stride=5,
                             augment=AugmentConfig(noisestd=1e-4,
                                                   compression=10.0),
                             target_slice=(24, 96), device=dev)
    # learning, not resume, is checked here: cuDNN's fast algorithms (the
    # deterministic ones cost 3x per step, phase 8e)
    cfg = TrainConfig(max_epochs=epochs, batch_size=16, initial_lr=lr,
                      loss="bce", es_patience=epochs, scheduler=None,
                      seed=SEED, deterministic=False)
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
    augmentation, dropout 0.2 and validation in train mode all draw; the
    trainers run with ``TrainConfig.deterministic`` (the default). Exact,
    bit for bit: the restored state (model, BatchNorm statistics,
    optimizer state, step), every loss of the resumed epoch 1 (each train
    step's, the epoch's train and validation losses), then every weight,
    BatchNorm statistic and optimizer state after it."""
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

    def same_state(a, b):
        sa, sb = a.model.state_dict(), b.model.state_dict()
        oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
        return (a.step == b.step and sa.keys() == sb.keys()
                and all(torch.equal(sa[k], sb[k]) for k in sa)
                and oa["state"].keys() == ob["state"].keys()
                and all(torch.equal(oa["state"][i][k].cpu(),
                                    ob["state"][i][k].cpu())
                        for i in oa["state"] for k in oa["state"][i]))

    ck = os.path.join(tmp, "resume")
    straight = Trainer(train_model(), cfg, device=dev).init()
    metric = straight.fit(batches, val, checkpoint_dir=ck)["val_loss"][0]
    two = dataclasses.replace(cfg, max_epochs=2)
    resumed = Trainer(train_model(), two, device=dev)
    epoch, resumed.lr, saved = _Checkpointer(ck).restore(resumed)
    straight.config = two
    state_equal = (epoch == 0 and saved == metric
                   and same_state(straight, resumed))
    la, lb = recorded(straight), recorded(resumed)
    ha = straight.fit(batches, val, start_epoch=1, initial_best=metric)
    hb = resumed.fit(batches, val, start_epoch=1, initial_best=saved)
    steps_equal = len(la) == len(lb) == RESUME_BATCHES and all(
        torch.equal(a, b) for a, b in zip(la, lb))
    epoch_equal = (ha["train_loss"] == hb["train_loss"]
                   and ha["val_loss"] == hb["val_loss"])
    after_equal = same_state(straight, resumed)
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    worst = max((float((a[k].double() - b[k].double()).abs().max()
                       / a[k].double().abs().max().clamp(min=1e-30)), k)
                for k in a if a[k].is_floating_point())

    def word(ok):
        return "equal" if ok else "DIFFERENT"

    print(f"[train] resume ({RESUME_BATCHES} batches per epoch, the recipe's "
          f"augmentation, dropout, validation in train mode, deterministic "
          f"{cfg.deterministic}): restored state {word(state_equal)} bit for "
          f"bit; epoch 1's {len(lb)} step losses {word(steps_equal)} "
          f"(first {float(la[0]):.6f} vs {float(lb[0]):.6f}, last "
          f"{float(la[-1]):.6f} vs {float(lb[-1]):.6f}); train loss "
          f"{ha['train_loss'][0]:.6f} vs {hb['train_loss'][0]:.6f}, val loss "
          f"{ha['val_loss'][0]:.6f} vs {hb['val_loss'][0]:.6f} "
          f"({word(epoch_equal)}); weights, statistics and optimizer state "
          f"after epoch 1 {word(after_equal)} (worst gap {worst[0]:.2e} of "
          f"max abs at {worst[1]})")
    if not (state_equal and steps_equal and epoch_equal and after_equal):
        raise AssertionError("resume is not exact on the card")


def registry_step(dev, card):
    """Phase 8e: exp180d at batch 25 with the registry's augmentation:
    train_step time with ``deterministic`` on (the default) and off, the
    pipeline alone, peak memory, idle share and top kernels, FLOPs."""
    import dataclasses

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
    # the price of bit-exact resume: the same step without
    # cudnn.deterministic (the trainer reads its config at each step)
    det = trainer.config
    trainer.config = dataclasses.replace(det, deterministic=False)
    free_ms = cuda_ms(step, reps=TIMED_STEPS, warmup=3)
    trainer.config = det

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
          f"{step_ms:.2f} ms per train_step with deterministic on, "
          f"{free_ms:.2f} ms with it off ({step_ms / free_ms - 1:+.1%}) "
          f"(CUDA events, {TIMED_STEPS} steps after 3 warm-ups); pipeline "
          f"alone {pipe_ms:.3f} ms per batch "
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
    return dict(step_ms=step_ms, free_ms=free_ms, pipe_ms=pipe_ms, peak=peak,
                flops=flops, share=share, idle=idle, top=top,
                bench_ms=bench_ms)


# -- the zoo phase ----------------------------------------------------------

def zoo_model(name, **overrides):
    """A registry entry's model at full width, built through
    ``load_experiment``, with the weights that the JAX package's
    ``model.init`` draws, drawn from a generator seeded ``SEED`` (so the
    card and the CPU processes build the same model); attention models in
    ``cross_batch:GROUP`` groups. Returns (model, attention group or
    None)."""
    import inspect

    import torch

    from multipitch_architectures_tpu_torch.experiments import (
        MODEL_REGISTRY, load_experiment)
    from multipitch_architectures_tpu_torch.models import init_parameters_flax

    cfg = load_experiment(name)
    group = None
    if "attn_mode" in inspect.signature(
            MODEL_REGISTRY[cfg.model_class]).parameters:
        group = GROUP
        overrides = {**overrides, "attn_mode": f"cross_batch:{GROUP}"}
    model = cfg.build_model(**overrides)
    init_parameters_flax(model, torch.Generator().manual_seed(SEED))
    return model, group


def zoo_windows():
    """ZOO_CHECK_WINDOWS windows of a synthetic file, log-compressed and
    padded as the windowed protocol does, on the CPU: the same in every
    process."""
    import torch

    from multipitch_architectures_tpu_torch.data import gather_windows
    from multipitch_architectures_tpu_torch.eval.inference import _pad_inputs

    x, _ = synth_file(120, seed=11)
    xp = _pad_inputs(torch.log1p(10.0 * torch.from_numpy(x)), 75)
    return gather_windows(xp, 37 + 30 * np.arange(ZOO_CHECK_WINDOWS), 75)


def zoo_cpu_forwards(path):
    """The CPU side of the zoo's card-vs-CPU forwards, in a process of its
    own with one thread: each configuration's eval forward of
    ``zoo_windows()``, written to ``path``."""
    import torch

    torch.set_num_threads(1)
    x, out = zoo_windows(), {}
    for name, _, _ in ZOO:
        model = zoo_model(name)[0].eval()
        with torch.no_grad():
            y = model(x)
        out[name] = list(y) if isinstance(y, tuple) else [y]
    torch.save(out, path)


def zoo_train_batch(device):
    """Phase 8a's fixed batch of 25, augmentation off, on ``device``."""
    from multipitch_architectures_tpu_torch.data import FileSpec, TrainPipeline

    pipeline = TrainPipeline([FileSpec(*synth_file(1200, seed=s))
                              for s in range(3)], device=device)
    return next(pipeline.batches(SEED, TRAIN_BATCH, shuffle=False))


def zoo_train_model(name):
    """``name`` (a registry entry of phase 9, or a class of phase 12) for
    the step check: p_dropout 0 and every dropout 0."""
    build = zoo2_model if name in ZOO2_FAMILY else zoo_model
    return zero_dropout(build(name, p_dropout=0.0)[0])


def zoo_train_config(name):
    """The step's recipe; the loss is the registry entry's (phase 9) or
    the BCE (phase 12's single-output classes)."""
    from multipitch_architectures_tpu_torch.experiments import load_experiment
    from multipitch_architectures_tpu_torch.train import TrainConfig

    loss = "bce" if name in ZOO2_FAMILY else \
        load_experiment(name).train_config.loss
    return TrainConfig(**TRAIN_STEP_CONFIG, loss=loss)


def zoo_cpu_step(name, path):
    """The CPU side of a zoo train step, in a process of its own with one
    thread, started when the script starts (a step at full width takes
    minutes on one core): one AdamW step of ``name`` on the fixed batch,
    its max-pool choices recorded for the card to replay; writes the loss,
    the batch and the choices to ``path``."""
    import torch

    from multipitch_architectures_tpu_torch.train import Trainer

    torch.set_num_threads(1)
    x, y = zoo_train_batch("cpu")
    trainer = Trainer(zoo_train_model(name), zoo_train_config(name),
                      device="cpu")
    pools, freq = {}, []
    pool_hooks(trainer.model, pools, replay=False)
    t0 = time.perf_counter()
    with freq_pools(freq, replay=False):
        loss = float(trainer.train_step(x, y))
    torch.save({"loss": loss, "x": x, "y": y, "pools": pools,
                "freq_pools": freq, "seconds": time.perf_counter() - t0},
               path)


def zoo_cpu_steps(names, path):
    """:func:`zoo_cpu_step` of each of ``names`` in turn, in one process,
    each written to ``path`` with the name inserted."""
    for name in names:
        zoo_cpu_step(name, path.replace(".pt", f"_{name}.pt"))


def start_zoo_cpu(tmp):
    """Start the zoo's CPU processes (forwards, and one per train step);
    returns {what: (process, result path)}."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    jobs = {"forwards": (zoo_cpu_forwards, ()),
            "zoo2_forwards": (zoo2_cpu_forwards, ()),
            "zoo2_steps": (zoo_cpu_steps, (ZOO2_TRAIN,))}
    for name in ZOO_TRAIN:
        jobs[name] = (zoo_cpu_step, (name,))
    procs = {}
    for what, (fn, args) in jobs.items():
        path = os.path.join(tmp, f"zoo_{what}.pt")
        proc = ctx.Process(target=fn, args=(*args, path))
        proc.start()
        procs[what] = (proc, path)
    return procs


def stop(procs):
    for proc, _ in procs.values():
        if proc.is_alive():
            proc.kill()
        proc.join()


def zoo_cpu_result(procs, what, timeout=900, part=None):
    """The result of CPU process ``what`` (of its step ``part`` for
    ``zoo2_steps``), waiting for the process."""
    import torch

    proc, path = procs[what]
    proc.join(timeout=timeout)
    if proc.is_alive():
        proc.kill()
        proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"the zoo's CPU process {what!r} failed: exit "
                             f"code {proc.exitcode}")
    if part is not None:
        path = path.replace(".pt", f"_{part}.pt")
    return torch.load(path, weights_only=True)


def zoo_serve(dev, card, name, paper, count, cpu_out):
    """One configuration of the zoo phase (module docstring, phase 9).
    Returns its CQT kernel launches."""
    import torch

    from multipitch_architectures_tpu_torch.dsp import hcqt
    from multipitch_architectures_tpu_torch.eval import (
        predict_dense, predict_dense_chunked, predict_framewise)
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves

    model, group = zoo_model(name)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != count:
        raise AssertionError(f"{paper} ({name}): {n_params:,} parameters, "
                             f"logged {count:,}")
    model.to(dev).eval()
    punet = name == ZOO_PUNET

    def serve(y):
        t0 = time.perf_counter()
        f = hcqt(y, device=dev, **HCQT_KW)[0]
        out = predict_framewise(model, f, batch_size=BATCH, group=group,
                                return_aux=punet)
        torch.cuda.synchronize()
        return f, out, time.perf_counter() - t0

    before = cqt_octaves.launches
    serve(audio(REQUEST_SECONDS[-1], SEED + 99))        # warm-up request
    torch.cuda.reset_peak_memory_stats(dev)
    y = audio(ZOO_SECONDS, SEED + 7)
    f, out, wall = serve(y)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = cqt_octaves.launches - before
    pred, aux = out if punet else (out, None)
    t = frames(ZOO_SECONDS)
    ok = (pred.shape == (t, 72) and bool(torch.isfinite(pred).all())
          and float(pred.min()) >= 0.0 and float(pred.max()) <= 1.0)
    if punet:
        ok = ok and aux.shape == (t, 24) and bool(torch.isfinite(aux).all())
    if not ok or launches != 2:
        raise AssertionError(f"{paper}: output {tuple(pred.shape)} in "
                             f"[{float(pred.min())}, {float(pred.max())}], "
                             f"aux {None if aux is None else aux.shape}, "
                             f"{launches} CQT launches in 2 requests")
    mode = f"cross_batch:{group}, " if group else ""
    print(f"[zoo] {paper} ({name}): {n_params:,} parameters (logged); "
          f"{ZOO_SECONDS} s -> {tuple(pred.shape)} in [{float(pred.min()):.4f}"
          f", {float(pred.max()):.4f}]"
          + (f", polyphony logits {tuple(aux.shape)} finite" if punet else "")
          + f" ({mode}batch {BATCH}): wall {wall * 1e3:.1f} ms, "
          f"{ZOO_SECONDS / wall:.2f}x real time, peak device memory "
          f"{peak / 2**30:.2f} GiB; 1 CQT launch per request; {card}")

    if name in ZOO_DENSE:
        for label, fn in (("predict_dense", lambda: predict_dense(model, f)),
                          ("predict_dense_chunked(chunk=512)",
                           lambda: predict_dense_chunked(model, f,
                                                         chunk=512))):
            fn()                                        # warm-up
            dense, ms = cuda_timed(fn)
            gap = float((dense - pred).abs().max())
            if dense.shape != pred.shape or not bool(
                    torch.isfinite(dense).all()):
                raise AssertionError(f"{paper} {label}: {dense.shape}")
            print(f"[zoo] {paper} {label}: {ms:.1f} ms for the {ZOO_SECONDS}"
                  f"-s request ({ZOO_SECONDS / ms * 1e3:.1f}x real time), max "
                  f"abs gap to the windowed output {gap:.3e} (not the "
                  f"protocol: the dense pass sees the neighbouring frames "
                  f"where each window sees zero padding); {card}")

    with torch.no_grad():
        got = model(zoo_windows().to(dev))
    got = list(got) if isinstance(got, tuple) else [got]
    gaps = [float((g.cpu() - w).abs().max()) for g, w in zip(got, cpu_out)]
    if len(got) != len(cpu_out) or not max(gaps) < MODEL_TOL:
        raise AssertionError(f"{paper} card vs CPU: max abs gaps {gaps}")
    print(f"[zoo] {paper} {ZOO_CHECK_WINDOWS} windows, card vs CPU (one "
          f"thread): max abs gap {gaps[0]:.3e}"
          + (f", polyphony logits {gaps[1]:.3e}" if punet else "")
          + f" (< {MODEL_TOL:g})")
    del model
    torch.cuda.empty_cache()
    return launches


def zoo_step(dev, card, name, cpu, reps=TIMED_STEPS):
    """One AdamW step of ``name`` at batch 25 on the card, the CPU's
    max-pool choices (and freq-pool choices) replayed, against the CPU
    process's step; then the step timed over ``reps`` steps with
    ``deterministic`` on and off, and its FLOPs."""
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from multipitch_architectures_tpu_torch.train import Trainer

    cfg = zoo_train_config(name)
    trainer = Trainer(zoo_train_model(name), cfg, device=dev)
    x, y = cpu["x"].to(dev), cpu["y"].to(dev)
    handles = pool_hooks(trainer.model, cpu["pools"], replay=True)
    with freq_pools(cpu["freq_pools"], replay=True) as fp:
        loss = float(trainer.train_step(x, y))
    for h in handles:
        h.remove()
    rel = abs(loss - cpu["loss"]) / abs(cpu["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"{name}: train step loss {loss}")

    def step():
        trainer.train_step(x, y)

    step_ms = cuda_ms(step, reps=reps, warmup=3)
    trainer.config = dataclasses.replace(cfg, deterministic=False)
    free_ms = cuda_ms(step, reps=reps, warmup=3)
    trainer.config = cfg
    fc = FlopCounterMode(display=False)
    with fc:
        step()
    flops = fc.get_total_flops()
    share = flops / (step_ms / 1e3) / F32_FLOP_PER_S
    tag = "zoo-2" if name in ZOO2_FAMILY else "zoo"
    print(f"[{tag}] train step {name} ({cfg.loss}) at batch {TRAIN_BATCH}, "
          f"card vs CPU (the CPU's max-pool choices replayed, dropout 0): "
          f"loss {loss:.6f} vs {cpu['loss']:.6f}, rel {rel:.2e} (<= "
          f"{TRAIN_LOSS_RTOL:g}; the CPU's step took {cpu['seconds']:.1f} s "
          f"on one thread; {fp.flips} freq-pool near-ties replayed); "
          f"{step_ms:.2f} ms per train_step with "
          f"deterministic on, {free_ms:.2f} ms off (CUDA events, "
          f"{reps} steps after 3 warm-ups), {flops / 1e12:.3f} TFLOP "
          f"per step (FlopCounterMode) = {share:.1%} of the float32 peak "
          f"with deterministic on, {share * step_ms / free_ms:.1%} off; "
          f"{card}")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{name}: the card's train step loss differs "
                             f"from the CPU's by rel {rel:.2e}")
    del trainer
    torch.cuda.empty_cache()


def phase_zoo(dev, card, procs):
    """Phase 9: the rest of the registry's model zoo at full width.
    Returns the CQT kernel launches of its requests."""
    cpu_forwards = zoo_cpu_result(procs, "forwards")
    launches = 0
    for name, paper, count in ZOO:
        launches += zoo_serve(dev, card, name, paper, count,
                              cpu_forwards[name])
    for name in ZOO_TRAIN:
        zoo_step(dev, card, name, zoo_cpu_result(procs, name))
    return launches


# -- the audio phase ----------------------------------------------------------

def midi_hz(midi):
    return 440.0 * 2.0 ** ((np.asarray(midi, np.float64) - 69) / 12)


def note_events(rng, seconds, voices):
    """Random note events (start s, end s, MIDI 24-96, voice) of
    ``voices`` monophonic voices: notes of 0.15-1.2 s with rests of up to
    0.4 s between them."""
    events = []
    for v in range(voices):
        t = rng.uniform(0, 0.5)
        while t < seconds - 0.2:
            end = min(seconds, t + rng.uniform(0.15, 1.2))
            events.append((t, end, int(rng.randint(24, 97)), v))
            t = end + rng.uniform(0.0, 0.4)
    return sorted(events)


def synth(events, seconds, rate, dev, channels=1, seed=0):
    """Audio of ``events`` at ``rate``, made on ``dev``: each note a sum of
    5 harmonic partials (amplitudes 0.6^k) with a random level and 10-ms
    smoothed edges; each voice panned at random between the channels.
    Returns (n, channels) float64 numpy, peak 0.9."""
    import torch

    rng = np.random.RandomState(seed)
    n = int(seconds * rate)
    voices = sorted({e[3] for e in events})
    out = torch.zeros((n, channels), dtype=torch.float64, device=dev)
    ramp = torch.hann_window(int(0.02 * rate), dtype=torch.float64,
                             device=dev)
    ramp = (ramp / ramp.sum()).view(1, 1, -1)
    for v in voices:
        freq = torch.zeros(n, dtype=torch.float64, device=dev)
        gate = torch.zeros(n, dtype=torch.float64, device=dev)
        for start, end, midi, voice in events:
            if voice == v:
                s0, s1 = int(start * rate), int(end * rate)
                freq[s0:s1] = float(midi_hz(midi))
                gate[s0:s1] = rng.uniform(0.3, 1.0)
        phase = torch.cumsum(2 * np.pi * freq / rate, 0)
        tone = sum(0.6 ** k * torch.sin((k + 1) * phase) for k in range(5))
        env = torch.nn.functional.conv1d(gate.view(1, 1, -1), ramp,
                                         padding="same").view(-1)
        pan = [1.0]
        if channels == 2:
            right = rng.uniform(0.2, 0.8)
            pan = [1 - right, right]
        out += (tone * env)[:, None] * torch.tensor(pan, device=dev)
    out *= 0.9 / out.abs().max()
    return out.cpu().numpy()


def musicnet_csv(path, events):
    """MusicNet's csv: start/end as sample indices at 44.1 kHz."""
    with open(path, "w") as f:
        f.write("start_time,end_time,instrument,note,start_beat,end_beat,"
                "note_value\n")
        for start, end, midi, v in events:
            f.write(f"{round(start * WAV_RATE)},{round(end * WAV_RATE)},"
                    f"{(1, 41, 42, 43)[v]},{midi},{2 * start:.3f},"
                    f"{2 * (end - start):.3f},Quarter\n")


def note_name(midi):
    names = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")
    return f"{names[midi % 12]}{midi // 12 - 1}"


def write_preset(path, schema, events, seconds):
    """``events`` in the text export of a NOTE_EVENT_SCHEMAS preset."""
    with open(path, "w") as f:
        if schema == "swd":
            f.write("start;end;pitch;instrument\n")
            for start, end, midi, v in events:
                f.write(f"{start:.4f};{end:.4f};{midi};voice{v}\n")
        elif schema == "bach10":
            for start, end, midi, _ in events:
                f.write(f"{round(start * 1e3)}\t{round(end * 1e3)}\t"
                        f"{midi}\n")
        elif schema == "phenicx":
            f.write("onset,offset,note\n")
            for start, end, midi, _ in events:
                f.write(f"{start:.3f},{end:.3f},{note_name(midi)}\n")
        elif schema == "csd":         # one voice's f0 track, 10-ms frames
            for i in range(int(seconds * 100)):
                t = i / 100
                f0 = next((midi_hz(m) for s, e, m, _ in events
                           if s <= t < e), 0.0)
                f.write(f"{t:.2f},{f0:.3f}\n")


def make_corpus(root, dev):
    """Phase 10a: the synthetic corpus in MusicNet's formats under
    ``root/audio`` and ``root/csv`` (exp180d's split prefixes, 44.1-kHz
    stereo int16 WAVs of 60 s), and under ``root/extra`` one file per
    other preset and per other sample format, with the schema each needs.
    Returns [(audio path, annotation path, schema, what)] of the extras."""
    from scipy.io import wavfile

    for sub in ("audio", "csv", "extra"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, name in enumerate(CORPUS_NAMES):
        rng = np.random.RandomState(SEED + 100 + i)
        events = note_events(rng, CORPUS_SECONDS, rng.randint(1, 5))
        y = synth(events, CORPUS_SECONDS, WAV_RATE, dev, channels=2,
                  seed=SEED + 200 + i)
        wavfile.write(os.path.join(root, "audio", name + ".wav"), WAV_RATE,
                      np.round(y * 32767).astype(np.int16))
        musicnet_csv(os.path.join(root, "csv", name + ".csv"), events)
    extras = []
    formats = [("swd", "swd", ".csv", "int16 stereo 44.1 kHz"),
               ("bach10", "bach10", ".txt", "int16 stereo 44.1 kHz"),
               ("phenicx", "phenicx", ".txt", "int16 stereo 44.1 kHz"),
               ("csd", "csd", ".csv", "int16 stereo 44.1 kHz"),
               ("uint8", None, ".csv", "uint8 mono 44.1 kHz"),
               ("float32", None, ".csv", "float32 stereo 48 kHz"),
               ("npy", None, ".csv", ".npy mono 22.05 kHz")]
    for i, (name, schema, ext, what) in enumerate(formats):
        rng = np.random.RandomState(SEED + 300 + i)
        events = note_events(rng, EXTRA_SECONDS,
                             1 if schema == "csd" else rng.randint(1, 5))
        rate = {"float32": 48000, "npy": FS}.get(name, WAV_RATE)
        channels = 1 if name in ("uint8", "npy") else 2
        y = synth(events, EXTRA_SECONDS, rate, dev, channels=channels,
                  seed=SEED + 400 + i)
        audio_path = os.path.join(root, "extra", name + (
            ".npy" if name == "npy" else ".wav"))
        if name == "npy":
            np.save(audio_path, y[:, 0].astype(np.float32))
        elif name == "uint8":
            wavfile.write(audio_path, rate,
                          np.round(y[:, 0] * 127 + 128).astype(np.uint8))
        elif name == "float32":
            wavfile.write(audio_path, rate, y.astype(np.float32))
        else:
            wavfile.write(audio_path, rate,
                          np.round(y * 32767).astype(np.int16))
        annot = os.path.join(root, "extra", name + ext)
        if schema is None:
            musicnet_csv(annot, events)
        else:
            write_preset(annot, schema, events, EXTRA_SECONDS)
        extras.append((audio_path, annot, schema, what))
    return extras


class record_tuning:
    """Records each tuning that ``compute_efficient_hcqt`` estimates."""

    def __enter__(self):
        import multipitch_architectures_tpu_torch.dsp  # noqa: F401

        self.module = sys.modules["multipitch_architectures_tpu_torch.dsp."
                                  "hcqt"]
        self.real = self.module.estimate_tuning
        self.values = []

        def spy(*args, **kw):
            self.values.append(self.real(*args, **kw))
            return self.values[-1]

        self.module.estimate_tuning = spy
        return self.values

    def __exit__(self, *exc):
        self.module.estimate_tuning = self.real


class plain_k1:
    """Runs every CQT work list through the kernel's plain version
    (``cqt_octaves_reference``), on the card too."""

    def __enter__(self):
        import multipitch_architectures_tpu_torch.dsp  # noqa: F401
        from multipitch_architectures_tpu_torch.ops.cqt_octave import (
            cqt_octaves_reference)

        self.modules = [sys.modules[f"multipitch_architectures_tpu_torch.dsp."
                                    f"{m}"] for m in ("cqt", "hcqt")]
        self.real = [m.cqt_octaves for m in self.modules]
        for m in self.modules:
            m.cqt_octaves = cqt_octaves_reference

    def __exit__(self, *exc):
        for m, real in zip(self.modules, self.real):
            m.cqt_octaves = real


def audio_card_vs_cpu(dev, root, extras):
    """Phase 10b: each file through ``audio_example`` (load_audio, the
    HCQT with its tuning estimated, the roll) on the card and on the CPU
    (each octave through the plain version): HCQT rel-to-peak
    ``HCQT_TOL``, the same tunings, the same rolls."""
    from multipitch_architectures_tpu_torch.dsp import estimate_tuning
    from multipitch_architectures_tpu_torch.experiments.runner import (
        audio_example, annotation_path)

    files = [(os.path.join(root, "audio", n + ".wav"),
              annotation_path(os.path.join(root, "csv"), n), None,
              "int16 stereo 44.1 kHz, musicnet csv") for n in CORPUS_NAMES]
    files += [(a, t, s, f"{w}, {s or 'musicnet'} {os.path.splitext(t)[1]}")
              for a, t, s, w in extras]
    worst = 0.0
    for audio_path, annot, schema, what in files:
        pair = []
        for device in (dev, "cpu"):
            with record_tuning() as tuning:
                pair.append(audio_example(audio_path, annot, schema=schema,
                                          device=device) + (tuning[0],))
        (x, roll, t_card), (x_cpu, roll_cpu, t_cpu) = pair
        rel = float(np.abs(x - x_cpu).max() / np.abs(x_cpu).max())
        worst = max(worst, rel)
        if not (rel < HCQT_TOL and t_card == t_cpu and
                np.array_equal(roll, roll_cpu) and roll.sum() > 0 and
                np.isfinite(x).all()):
            raise AssertionError(f"{audio_path}: card vs CPU rel {rel:.3g}, "
                                 f"tuning {t_card} vs {t_cpu}, rolls equal "
                                 f"{np.array_equal(roll, roll_cpu)}")
        print(f"[audio] {os.path.basename(audio_path)} ({what}): "
              f"{tuple(x.shape)} + roll {tuple(roll.shape)} "
              f"({int(roll.sum())} active cells); tuning {t_card:+.2f} bin "
              f"on both; HCQT card vs CPU rel-to-peak {rel:.3e} "
              f"(< {HCQT_TOL:g}); rolls equal")
    # a chord detuned by +0.3 bin must read as such
    t = np.arange(4 * FS) / FS
    shift = 2.0 ** (DETUNE_BINS / 36)
    chord = sum(a * np.sin(2 * np.pi * f * shift * t)
                for a, f in ((1.0, 261.6256), (0.5, 329.6276),
                             (0.25, 440.0))).astype(np.float32)
    est = estimate_tuning(chord, fs=FS, bins_per_octave=36)
    if abs(est - DETUNE_BINS) >= DETUNE_TOL:
        raise AssertionError(f"a +{DETUNE_BINS}-bin chord read as {est}")
    print(f"[audio] a chord detuned by +{DETUNE_BINS} bin reads "
          f"{est:+.2f} (within {DETUNE_TOL}); worst card vs CPU HCQT over "
          f"{len(files)} files {worst:.3e}")
    return worst


def timed_hcqt(dev, y, tuning, **kw):
    """(HCQT, seconds, K1 launches, peak device memory above the start in
    bytes) of one ``efficient_hcqt_device`` call on an array."""
    import torch

    from multipitch_architectures_tpu_torch.dsp import efficient_hcqt_device
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = cqt_octaves.launches
    t0 = time.perf_counter()
    out = efficient_hcqt_device(y, device=dev, tuning=tuning, **HCQT_AUDIO,
                                **kw)[0]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return (out, sec, cqt_octaves.launches - before,
            torch.cuda.max_memory_allocated() - base)


def audio_long(dev, card):
    """Phase 10c: a 20-min recording: the whole HCQT against the plain
    version on the card, against ``chunk_frames=CHUNK_FRAMES`` (one launch
    per chunk), and the exact plan once; times and peak memory."""
    import torch

    from multipitch_architectures_tpu_torch.dsp import estimate_tuning

    rng = np.random.RandomState(SEED + 500)
    y = synth(note_events(rng, LONG_SECONDS, 4), LONG_SECONDS, FS, dev,
              seed=SEED + 501)[:, 0].astype(np.float32)
    t0 = time.perf_counter()
    tuning = estimate_tuning(y, fs=FS, bins_per_octave=36)
    tuning_s = time.perf_counter() - t0
    n_frames = len(y) // HOP + 1
    chunks = -(-n_frames // CHUNK_FRAMES)
    whole, first_s, launches, _ = timed_hcqt(dev, y, tuning)
    whole, whole_s, launches_warm, whole_mem = timed_hcqt(dev, y, tuning)
    with plain_k1():
        plain, plain_s, plain_launches, plain_mem = timed_hcqt(dev, y,
                                                               tuning)
    rel_plain = rel_to_peak(whole, plain)
    del plain
    whole = whole.cpu().numpy()
    streamed, stream_first_s, _, _ = timed_hcqt(dev, y, tuning,
                                                chunk_frames=CHUNK_FRAMES)
    streamed, stream_s, stream_launches, stream_mem = timed_hcqt(
        dev, y, tuning, chunk_frames=CHUNK_FRAMES)
    rel_stream = float(np.abs(streamed - whole).max() / np.abs(whole).max())
    exact, exact_s, exact_launches, exact_mem = timed_hcqt(dev, y, tuning,
                                                           exact=True)
    # interior frames: the bases' longest kernels reach 2.4 s (103 frames)
    interior = np.s_[:, 128:-128]
    gap_exact = rel_to_peak(exact.cpu()[interior],
                            torch.from_numpy(whole[interior]))
    del exact
    if not (whole.shape == (6, n_frames, 216) and launches == launches_warm
            == 1 and plain_launches == 0 and rel_plain < HCQT_TOL
            and stream_launches == chunks and rel_stream < STREAM_TOL
            and streamed.shape == whole.shape and exact_launches == 1
            and np.isfinite(whole).all()):
        raise AssertionError(f"20-min HCQT: shape {whole.shape}, launches "
                             f"{launches}/{launches_warm}/{plain_launches}/"
                             f"{stream_launches} (want 1/1/0/{chunks}), "
                             f"{exact_launches} exact; rel plain "
                             f"{rel_plain:.3g}, streamed {rel_stream:.3g}")
    mib = 2 ** 20
    print(f"[audio] {LONG_SECONDS / 60:.0f}-min recording, {n_frames} "
          f"frames: tuning {tuning:+.2f} bin in {tuning_s:.2f} s (host, "
          f"float64); whole HCQT {whole_s * 1e3:.1f} ms warm "
          f"({first_s * 1e3:.1f} first), 1 launch, peak "
          f"{whole_mem / mib:.0f} MiB above the start; against the plain "
          f"version on the card ({plain_s * 1e3:.1f} ms, peak "
          f"{plain_mem / mib:.0f} MiB) rel-to-peak {rel_plain:.3e} "
          f"(< {HCQT_TOL:g}); {card}")
    print(f"[audio] streamed, chunk_frames={CHUNK_FRAMES}: {chunks} chunks, "
          f"{stream_launches} launches; {stream_s * 1e3:.1f} ms warm "
          f"({stream_first_s * 1e3:.1f} first; to host numpy), peak "
          f"{stream_mem / mib:.0f} MiB; against the whole HCQT rel-to-peak "
          f"{rel_stream:.3e} (< {STREAM_TOL:g}); exact plan (whole): "
          f"{exact_s * 1e3:.1f} ms, 1 launch, peak {exact_mem / mib:.0f} "
          f"MiB, {gap_exact:.3e} rel-to-peak from the multirate plan on "
          f"interior frames (its kernel-reuse approximation)")
    return dict(whole_s=whole_s, stream_s=stream_s, exact_s=exact_s,
                whole_mem=whole_mem, stream_mem=stream_mem,
                rel_plain=rel_plain, rel_stream=rel_stream)


def audio_split(dev, root, card):
    """Phase 10d: the load path of a 5-min 44.1-kHz stereo WAV, step by
    step as ``audio_example`` runs it; the second of two runs (the first
    builds the tuned plans)."""
    import torch
    from scipy.io import wavfile

    from multipitch_architectures_tpu_torch.dsp import (
        compute_annotation_array_nooverlap, compute_efficient_hcqt,
        estimate_tuning)
    from multipitch_architectures_tpu_torch.io import (load_audio,
                                                       load_note_events)

    rng = np.random.RandomState(SEED + 600)
    events = note_events(rng, SPLIT_SECONDS, 4)
    path = os.path.join(root, "split.wav")
    wavfile.write(path, WAV_RATE, np.round(synth(
        events, SPLIT_SECONDS, WAV_RATE, dev, channels=2,
        seed=SEED + 601) * 32767).astype(np.int16))
    musicnet_csv(os.path.join(root, "split.csv"), events)
    for _ in range(2):
        t = [time.perf_counter()]
        y = load_audio(path, FS)
        t.append(time.perf_counter())
        tuning = estimate_tuning(y, fs=FS, bins_per_octave=36)
        t.append(time.perf_counter())
        f_hcqt, fs_hcqt, _ = compute_efficient_hcqt(
            y, tuning=tuning, device=dev, **HCQT_AUDIO)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        roll = compute_annotation_array_nooverlap(
            load_note_events(os.path.join(root, "split.csv")),
            f_hcqt.shape[1], fs_hcqt, annot_type="pitch")
        pair = (np.transpose(f_hcqt, (2, 1, 0)).astype(np.float32),
                np.asarray(roll, np.float32).T)
        t.append(time.perf_counter())
    read_s, tuning_s, hcqt_s, roll_s = np.diff(t)
    total = t[-1] - t[0]
    print(f"[audio] load split, {SPLIT_SECONDS:.0f}-s 44.1-kHz stereo WAV "
          f"({pair[0].shape[1]} frames): read + resample {read_s:.3f} s, "
          f"tuning {tuning_s:.3f} s (host), HCQT {hcqt_s:.3f} s (card, "
          f"synchronized, with the copy to host), roll {roll_s:.3f} s "
          f"(host); total {total:.3f} s = {SPLIT_SECONDS / total:.0f} s of "
          f"audio per second; {card}")
    return dict(read_s=read_s, tuning_s=tuning_s, hcqt_s=hcqt_s,
                roll_s=roll_s, total_s=total)


def audio_run(dev, root):
    """Phase 10e: exp180d at full width trained, validated and tested on
    the corpus through ``AudioCorpus``, then the precompute CLI on the same
    corpus, whose output through ``NpyCorpus`` must equal
    ``AudioCorpus.load``. Returns the CQT kernel launches (one per file
    read: each load once, cached, and each precomputed file)."""
    import dataclasses

    from multipitch_architectures_tpu_torch.experiments import (
        AudioCorpus, NpyCorpus, load_experiment, precompute, run_experiment)
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves

    cfg = load_experiment(TRAIN_EXPERIMENT)
    cfg = dataclasses.replace(cfg, train_config=dataclasses.replace(
        cfg.train_config, max_train_batches=2))
    audio_dir, csv_dir = (os.path.join(root, d) for d in ("audio", "csv"))
    corpus = AudioCorpus(audio_dir, csv_dir, device=dev)
    before = cqt_octaves.launches
    t0 = time.perf_counter()
    res = run_experiment(cfg, corpus, os.path.join(root, "run"),
                         logger=logging.getLogger("chip_smoke.audio"),
                         max_epochs_override=1, device=dev)
    sec = time.perf_counter() - t0
    run_launches = cqt_octaves.launches - before
    name = cfg.name
    csv_path = os.path.join(root, "run", "results_filewise", name + ".csv")
    preds = sorted(os.listdir(os.path.join(root, "run", "predictions",
                                           name)))
    measures = [v for agg in res["subsets"]
                for m in ("filewise_mean", "framewise_mean")
                for v in agg[m].values()]
    if not (os.path.isfile(csv_path) and len(preds) == 3
            and len(measures) == 3 * 2 * 25 and all(np.isfinite(measures))
            and run_launches == len(CORPUS_NAMES)):
        raise AssertionError(f"run_experiment on AudioCorpus: csv "
                             f"{os.path.isfile(csv_path)}, predictions "
                             f"{preds}, {len(measures)} measures, "
                             f"{run_launches} CQT launches")
    fw = res["subsets"][0]["framewise_mean"]
    print(f"[audio] run_experiment {name} on AudioCorpus ({len(CORPUS_NAMES)}"
          f" files of {CORPUS_SECONDS:.0f} s: 2 train, 1 val, 3 test; 1 "
          f"epoch, 2 batches, the test phase's 3 subsets): {sec:.1f} s; CQT "
          f"launches {run_launches} (one per file); CSV and {len(preds)} "
          f"prediction files written; {len(measures)} measures finite; "
          f"framewise f_measure {fw['f_measure']:.4f}")

    out = os.path.join(root, "features")
    before = cqt_octaves.launches
    t0 = time.perf_counter()
    if precompute.main(["--audio-dir", audio_dir, "--csv-dir", csv_dir,
                        "--out-dir", out]) != 0:
        raise AssertionError("the precompute CLI failed")
    pre_s = time.perf_counter() - t0
    pre_launches = cqt_octaves.launches - before
    npy = NpyCorpus(os.path.join(out, "hcqt"), os.path.join(out, "pitch"))
    gaps = []
    for fn in corpus.files():
        stem = os.path.splitext(fn)[0]
        for a, b in zip(npy.load(stem + ".npy"), corpus.load(fn)):
            gaps.append(float(np.abs(a - b).max()) if a.shape == b.shape
                        else np.inf)
    if max(gaps) != 0 or pre_launches != len(CORPUS_NAMES):
        raise AssertionError(f"precompute: NpyCorpus against "
                             f"AudioCorpus.load max abs {max(gaps)}, "
                             f"{pre_launches} CQT launches")
    print(f"[audio] precompute CLI on the same corpus: {pre_s:.1f} s, "
          f"{pre_launches} CQT launches; NpyCorpus over its output equals "
          f"AudioCorpus.load bit for bit ({len(gaps)} arrays)")
    return run_launches + pre_launches


def phase_audio(dev, card, root):
    """Phase 10 (module docstring), its corpus and the precompute CLI's
    output (``root/features``, which phase 13 reads) under ``root``.
    Returns the CQT kernel launches of its main path (the run on
    AudioCorpus and the precompute CLI) and the numbers PERF.md keeps."""
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        int8_conv2d_dequant)

    out = {}
    t0 = time.perf_counter()
    extras = make_corpus(root, dev)
    print(f"[audio] corpus written in {time.perf_counter() - t0:.1f} s:"
          f" {len(CORPUS_NAMES)} x {CORPUS_SECONDS:.0f}-s 44.1-kHz "
          f"stereo int16 WAVs with MusicNet csvs, and {len(extras)} "
          f"files of {EXTRA_SECONDS:.0f} s in other formats")
    out["worst_file_rel"] = audio_card_vs_cpu(dev, root, extras)
    out.update(audio_long(dev, card))
    out.update(audio_split(dev, root, card))
    # the main path: the counts from 0 just before it, read just after
    int8_conv2d_dequant.launches = cqt_octaves.launches = 0
    launches = audio_run(dev, root)
    if (cqt_octaves.launches != launches
            or int8_conv2d_dequant.launches):
        raise AssertionError(f"audio: {cqt_octaves.launches} CQT "
                             f"launches counted, {launches} by file; "
                             f"{int8_conv2d_dequant.launches} int8 GEMM")
    return launches, out


# the serving-2 phase (11): shared inc, serving artifacts, the int8 mode's
# remaining options
SHARED_SECONDS = (10.0, 30.0)
SHARED_REPEATS = 3
SHARED_INT8_CONVS = 19         # exp180e's 21 quantized convs but inc's two
ARTIFACT_TOL = 1e-5            # the artifact's frames against eager
PERCENTILE = 99.9
PERCENTILE_RTOL = 1e-6
EXP180E_GMACS = 41.60          # the JAX package's count_macs per window
# the artifact's 10-s request in a fresh process that imports only the
# port's serve module (and torch, numpy): its load, a cold and a warm
# request, the duplicate-padded tail's warning, and the modules it
# imported
ARTIFACT_CHILD = r"""
import json, sys, time, warnings
t0 = time.perf_counter()
import numpy as np
import torch
from multipitch_architectures_tpu_torch import set_f32_parity
from multipitch_architectures_tpu_torch.serve import (
    load_window_forward, predict_framewise_exported)
t_import = time.perf_counter() - t0
set_f32_parity()
artifact, features, out = sys.argv[1:4]
t0 = time.perf_counter()
with open(artifact, "rb") as f:
    fn = load_window_forward(f.read())
torch.cuda.synchronize()
t_load = time.perf_counter() - t0
f = torch.from_numpy(np.load(features)).cuda()
times, caught = [], []
for _ in range(2):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        pred = predict_framewise_exported(fn, f,
                                          batch_size=fn.meta["batch_size"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    caught += [str(x.message) for x in w]
np.save(out, pred.cpu().numpy())
print(json.dumps(dict(
    import_s=t_import, load_s=t_load, request_s=times, warnings=caught,
    meta=fn.meta, modules=sorted(m for m in sys.modules
                                 if m.startswith("multipitch")))))
"""


def timed_request(fn):
    """(``fn()``, host seconds, peak device MiB): one call, the card
    synchronised, the peak counted from this call."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 20)


def shared_split(model, f):
    """CUDA-event split of one shared-inc request: the dense precompute,
    then per batch of the drain the assembly and the rest of the model.
    Returns (precompute ms, assemble ms, rest ms), summed over batches."""
    import torch

    from multipitch_architectures_tpu_torch.eval.inference import (
        _next_batch_size, _pad_inputs)
    from multipitch_architectures_tpu_torch.eval.shared_inc import (
        SharedIncForward)

    fwd = SharedIncForward(model)
    t = f.shape[1]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    ln, inc = fwd.precompute(_pad_inputs(torch.log1p(10.0 * f), 75))
    events[1].record()
    marks, start = [], 0
    while start < t:
        n = _next_batch_size(t - start, BATCH, GROUP)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        x1 = fwd.assemble(ln, inc, 37 + start + np.arange(n))
        e[1].record()
        with torch.no_grad():
            fwd.rest(x1)
        e[2].record()
        marks.append(e)
        start += n
    torch.cuda.synchronize()
    return (events[0].elapsed_time(events[1]),
            sum(e[0].elapsed_time(e[1]) for e in marks),
            sum(e[1].elapsed_time(e[2]) for e in marks))


def percentile_card_vs_cpu(model, x):
    """Each quantized conv's input for the batch ``x``: its 99.9th
    percentile of |x|, per tensor and per channel, on the card and on the
    CPU. Returns the worst relative gap."""
    import torch

    from multipitch_architectures_tpu_torch.eval import (eligible_convs,
                                                         percentile_abs)

    worst = [0.0]

    def hook(_, args):
        a = args[0]
        for per_channel in (False, True):
            card = percentile_abs(a, PERCENTILE, per_channel).cpu()
            cpu = percentile_abs(a.cpu(), PERCENTILE, per_channel)
            worst[0] = max(worst[0], float(((card - cpu).abs()
                                            / cpu.abs()).max()))

    handles = [m.register_forward_pre_hook(hook)
               for _, m in eligible_convs(model)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return worst[0]


def serving2_shared(dev, card, model, feats):
    """11a: shared-inc against windowed, float32, each request timed in
    turns; the split of the 10-s request. Returns the windowed outputs."""
    import torch

    from multipitch_architectures_tpu_torch.eval import (
        predict_framewise, predict_framewise_shared)

    windowed = {}
    for seconds, f in feats.items():
        def plain():
            return predict_framewise(model, f, batch_size=BATCH, group=GROUP)

        def shared():
            return predict_framewise_shared(model, f, batch_size=BATCH,
                                            group=GROUP)

        want, got = plain(), shared()                  # warm-ups
        gap = float((got - want).abs().max())
        if not gap <= MODEL_TOL:
            raise AssertionError(f"shared-inc {seconds}-s request against "
                                 f"windowed: max abs {gap:.3g}")
        times = {"windowed": [], "shared": []}
        peaks = {}
        for _ in range(SHARED_REPEATS):
            for name, fn in (("windowed", plain), ("shared", shared)):
                _, wall, peak = timed_request(fn)
                times[name].append(wall * 1e3)
                peaks[name] = peak
        w, sh = (np.mean(times[k]) for k in ("windowed", "shared"))
        print(f"[serving-2] shared-inc {seconds:>4} s ({f.shape[1]} frames):"
              f" max abs {gap:.3e} from windowed (<= {MODEL_TOL:g}); "
              f"windowed {', '.join(f'{t:.1f}' for t in times['windowed'])}"
              f" ms (peak {peaks['windowed']:.0f} MiB), shared "
              f"{', '.join(f'{t:.1f}' for t in times['shared'])} ms (peak "
              f"{peaks['shared']:.0f} MiB): shared {100 * (sh / w - 1):+.2f} "
              f"% ({seconds * 1e3 / sh:.2f}x real time); {card}")
        windowed[seconds] = want
    pre, asm, rest = shared_split(model, feats[SHARED_SECONDS[0]])
    print(f"[serving-2] shared-inc {SHARED_SECONDS[0]} s split by CUDA "
          f"events: precompute {pre:.3f} ms, assemble {asm:.3f} ms, rest "
          f"{rest:.3f} ms")
    return windowed


def serving2_int8(dev, card, model, f, want):
    """11b: shared-inc int8 on the 10-s request, scales from its first
    fused batch; beside the windowed int8 mode on the same scales.
    Returns (the scales, K2/K3 launches)."""
    import torch

    from multipitch_architectures_tpu_torch.data import gather_windows
    from multipitch_architectures_tpu_torch.eval import (
        calibrate_activation_scales, measure_drift, predict_framewise,
        predict_framewise_shared, quantize_convs)
    from multipitch_architectures_tpu_torch.eval.inference import _pad_inputs
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        int8_conv2d_dequant)

    xp = _pad_inputs(torch.log1p(10.0 * f), 75)
    scales = calibrate_activation_scales(
        model, [gather_windows(xp, 37 + np.arange(BATCH), 75)])
    predict_framewise_shared(model, f, batch_size=BATCH, group=GROUP,
                             activation_scales=scales)         # warm-up
    int8_conv2d_dequant.launches = 0
    got, wall, peak = timed_request(lambda: predict_framewise_shared(
        model, f, batch_size=BATCH, group=GROUP, activation_scales=scales))
    launches = int8_conv2d_dequant.launches
    batches = len(int8_batch_sizes(f.shape[1], BATCH, GROUP, 0))
    if launches != SHARED_INT8_CONVS * batches:
        raise AssertionError(f"shared-inc int8: {launches} K2/K3 launches "
                             f"in {batches} batches, want "
                             f"{SHARED_INT8_CONVS} per batch")
    windowed = predict_framewise(quantize_convs(model, activation_scales=
                                                scales), f, batch_size=BATCH,
                                 group=GROUP)
    ref = want.cpu().numpy()
    worst = {}
    for name, pred in (("shared", got), ("windowed", windowed)):
        drift, _ = measure_drift(ref, pred.cpu().numpy())
        worst[name] = max(drift.values())
    print(f"[serving-2] shared-inc int8 {SHARED_SECONDS[0]} s: {launches} "
          f"K2/K3 launches ({SHARED_INT8_CONVS} per batch x {batches}); "
          f"worst-of-25 drift against float32 {worst['shared']:.3e} "
          f"(windowed int8 on the same scales {worst['windowed']:.3e}); "
          f"{wall * 1e3:.1f} ms, peak {peak:.0f} MiB; {card}")
    return scales, launches


def serving2_artifact(dev, card, model, f, want, tmp):
    """11c: the float32 artifact, exported here and served by a fresh
    process."""
    import torch

    from multipitch_architectures_tpu_torch.serve import export_window_forward

    t0 = time.perf_counter()
    blob = export_window_forward(model, batch_size=BATCH,
                                 batch_mode=f"grouped:{GROUP}",
                                 meta=dict(model=EXPERIMENT))
    t_export = time.perf_counter() - t0
    artifact = os.path.join(tmp, "exp180e_f32.mptpu")
    with open(artifact, "wb") as fh:
        fh.write(blob)
    features = os.path.join(tmp, "request.npy")
    np.save(features, f.cpu().numpy())
    out = os.path.join(tmp, "artifact_pred.npy")
    child = subprocess.run(
        [sys.executable, "-c", ARTIFACT_CHILD, artifact, features, out],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if child.returncode:
        raise RuntimeError(f"the artifact's process failed:\n"
                           f"{child.stderr[-4000:]}")
    res = json.loads(child.stdout.strip().splitlines()[-1])
    t = f.shape[1]
    tail = (t % BATCH) % GROUP
    got = torch.from_numpy(np.load(out))
    gap = float((got[:t - tail] - want.cpu()[:t - tail]).abs().max())
    gap_tail = float((got[t - tail:] - want.cpu()[t - tail:]).abs().max())
    named = [w for w in res["warnings"] if f"last {tail} frames" in w]
    models = [m for m in res["modules"] if ".models" in m]
    if not gap <= ARTIFACT_TOL or not named or models:
        raise AssertionError(f"float32 artifact: max abs {gap:.3g} over the "
                             f"first {t - tail} frames; warnings "
                             f"{res['warnings']}; model modules {models}")
    print(f"[serving-2] float32 artifact (batch {BATCH}, grouped:{GROUP}): "
          f"{len(blob):,} bytes, export {t_export:.2f} s; a fresh process "
          f"(import {res['import_s']:.2f} s, no model code: "
          f"{len(res['modules'])} port modules) loads it in "
          f"{res['load_s']:.2f} s and serves the {SHARED_SECONDS[0]}-s "
          f"request in {res['request_s'][0] * 1e3:.1f} ms cold, "
          f"{res['request_s'][1] * 1e3:.1f} ms warm; {t - tail} frames "
          f"within {gap:.3e} of predict_framewise (<= {ARTIFACT_TOL:g}), "
          f"the last {tail} {gap_tail:.3e} (warned: {named[0][:60]}...); "
          f"{card}")


def serving2_int8_artifact(dev, card, model, scales, f):
    """11d: the int8 artifact with 11b's scales, loaded here: two batches
    of 250 windows against the eager quantized forward, its K2/K3
    launches counted from inside the artifact. Returns the launches."""
    import torch

    from multipitch_architectures_tpu_torch.data import gather_windows
    from multipitch_architectures_tpu_torch.eval import (eligible_convs,
                                                         quantize_convs)
    from multipitch_architectures_tpu_torch.eval.inference import _pad_inputs
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        int8_conv2d_dequant)
    from multipitch_architectures_tpu_torch.serve import (
        export_window_forward, load_window_forward)

    q = quantize_convs(model, activation_scales=scales)
    t0 = time.perf_counter()
    blob = export_window_forward(q, batch_size=BATCH,
                                 batch_mode=f"grouped:{GROUP}")
    t_export = time.perf_counter() - t0
    fn = load_window_forward(blob, device=dev)
    xp = _pad_inputs(torch.log1p(10.0 * f), 75)
    xs = [gather_windows(xp, 37 + b * BATCH + np.arange(BATCH), 75)
          for b in range(2)]
    fn(xs[0])                                               # warm-up
    int8_conv2d_dequant.launches = 0
    got = [fn(x) for x in xs]
    launches = int8_conv2d_dequant.launches
    with torch.no_grad():
        want = [q(x).reshape(BATCH, -1) for x in xs]
    gap = max(float((g - w).abs().max()) for g, w in zip(got, want))
    n_convs = len(eligible_convs(model))
    if launches != n_convs * len(xs) or not gap <= DEQUANT_TOL:
        raise AssertionError(f"int8 artifact: {launches} launches for "
                             f"{len(xs)} batches ({n_convs} convs); max abs "
                             f"{gap:.3g} from the eager forward")
    print(f"[serving-2] int8 artifact: {len(blob):,} bytes, export "
          f"{t_export:.2f} s, header int8={fn.meta['int8']}; "
          f"{launches} K2/K3 launches from inside it for {len(xs)} batches "
          f"of {BATCH} ({n_convs} per batch); max abs {gap:.3e} from the "
          f"eager quantize_convs forward (<= {DEQUANT_TOL:g})")
    return launches


def serving2_options(dev, card, model, f):
    """11e: percentile calibration card vs CPU and timed; PUnet:XL's
    int8 request with its aux head. Returns the K2/K3 launches."""
    import torch

    from multipitch_architectures_tpu_torch.data import gather_windows
    from multipitch_architectures_tpu_torch.eval import (
        calibrate_activation_scales, eligible_convs, predict_framewise,
        predict_framewise_int8)
    from multipitch_architectures_tpu_torch.eval.inference import _pad_inputs
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        int8_conv2d_dequant)

    x = gather_windows(_pad_inputs(torch.log1p(10.0 * f), 75),
                       37 + np.arange(BATCH), 75)
    rel = percentile_card_vs_cpu(model, x)
    if not rel <= PERCENTILE_RTOL:
        raise AssertionError(f"percentile scales card vs CPU: rel {rel:.3g}")
    ms = {}
    for name, kw in (("max", {}), ("percentile", dict(percentile=PERCENTILE)),
                     ("percentile per channel", dict(percentile=PERCENTILE,
                                                     per_channel=True))):
        calibrate_activation_scales(model, [x], **kw)          # warm-up
        _, wall, _ = timed_request(
            lambda: calibrate_activation_scales(model, [x], **kw))
        ms[name] = wall * 1e3
    print(f"[serving-2] percentile {PERCENTILE} scales of one batch of "
          f"{BATCH}, card vs CPU: worst rel {rel:.3e} (<= "
          f"{PERCENTILE_RTOL:g}, per tensor and per channel); calibration "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items()) + f"; {card}")

    pu, _ = zoo_model(ZOO_PUNET)
    pu.eval().to(dev)
    want, want_aux = predict_framewise(pu, f, batch_size=BATCH,
                                       return_aux=True)
    int8_conv2d_dequant.launches = 0
    (got, aux), wall, _ = timed_request(lambda: predict_framewise_int8(
        pu, f, batch_size=BATCH, cal_batches=1, return_aux=True))
    launches = int8_conv2d_dequant.launches
    t = f.shape[1]
    gap = float((aux[:BATCH] - want_aux[:BATCH]).abs().max())
    n_convs = len(eligible_convs(pu))
    if (aux.shape != want_aux.shape or not gap <= DEQUANT_TOL
            or launches != n_convs * len(int8_batch_sizes(t, BATCH, None, 1))
            or not bool(torch.isfinite(aux).all())):
        raise AssertionError(f"PUnet:XL int8 return_aux: aux "
                             f"{tuple(aux.shape)}, calibration span max abs "
                             f"{gap:.3g}, {launches} launches")
    print(f"[serving-2] PUnet:XL ({ZOO_PUNET}) predict_framewise_int8("
          f"return_aux=True), {SHARED_SECONDS[0]} s: aux {tuple(aux.shape)},"
          f" calibration span's aux rows within {gap:.3e} of float32 (<= "
          f"{DEQUANT_TOL:g}), the rest {float((aux[BATCH:] - want_aux[BATCH:]).abs().max()):.3e}"
          f"; {launches} K2/K3 launches ({n_convs} convs); {wall * 1e3:.1f} "
          f"ms")
    del pu
    return launches


def serving2_profile(model, f, tmp):
    """11f: exp180e's multiply-accumulates per window; a traced shared-inc
    request through ``utils.trace``."""
    import torch

    from multipitch_architectures_tpu_torch.eval import (
        predict_framewise_shared)
    from multipitch_architectures_tpu_torch.utils import count_macs, trace

    gmacs = count_macs(model, (1, 6, 75, 216)) / 1e9
    if round(gmacs, 2) != EXP180E_GMACS:
        raise AssertionError(f"count_macs(exp180e) {gmacs:.4f} G, the JAX "
                             f"package gives {EXP180E_GMACS} G")
    log_dir = os.path.join(tmp, "trace")
    with trace(log_dir) as prof:
        t0 = time.perf_counter()
        predict_framewise_shared(model, f, batch_size=BATCH, group=GROUP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle, wall, top = trace_summary(prof, wall, top=6)
    size = os.path.getsize(os.path.join(log_dir, "trace.json"))
    print(f"[serving-2] count_macs(exp180e) {gmacs:.4f} G per window (the "
          f"JAX package: {EXP180E_GMACS} G); utils.trace of a shared-inc "
          f"{SHARED_SECONDS[0]}-s request: {size:,} bytes, wall "
          f"{wall * 1e3:.1f} ms, device idle "
          + ("not measured (no device kernel in the trace)" if idle is None
             else f"{100 * idle:.2f} %") + "; top kernels: "
          + "; ".join(f"{n} {ms:.1f} ms" for n, ms in top))


def phase_serving2(dev, card, tmp):
    """Phase 11. Returns (K1 launches, K2/K3 launches) of its main paths:
    the two requests' HCQTs; the shared-inc int8 request, the int8
    artifact's batches and the PUnet's int8 request."""
    import torch

    from multipitch_architectures_tpu_torch.dsp import hcqt
    from multipitch_architectures_tpu_torch.experiments import load_experiment
    from multipitch_architectures_tpu_torch.models import init_parameters
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves

    model = load_experiment(EXPERIMENT).build_model(
        attn_mode=f"cross_batch:{GROUP}")
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model.eval().to(dev)
    cqt_octaves.launches = 0
    feats = {s: hcqt(audio(s, SEED + 11 + i), device=dev, **HCQT_KW)[0]
             for i, s in enumerate(SHARED_SECONDS)}
    cqt_launches = cqt_octaves.launches
    if cqt_launches != len(feats):
        raise AssertionError(f"{cqt_launches} K1 launches for "
                             f"{len(feats)} HCQTs")
    f10 = feats[SHARED_SECONDS[0]]
    windowed = serving2_shared(dev, card, model, feats)
    scales, shared_launches = serving2_int8(dev, card, model, f10,
                                            windowed[SHARED_SECONDS[0]])
    serving2_artifact(dev, card, model, f10, windowed[SHARED_SECONDS[0]],
                      tmp)
    artifact_launches = serving2_int8_artifact(dev, card, model, scales,
                                               feats[SHARED_SECONDS[1]])
    punet_launches = serving2_options(dev, card, model, f10)
    serving2_profile(model, f10, tmp)
    return cqt_launches, shared_launches + artifact_launches + punet_launches




# -- the zoo-2 phase (12): the zoo's other 19 classes ------------------------

def zoo2_model(name, **overrides):
    """Phase 12's model of registry class ``name`` at its configuration
    (``ZOO2``), with the weights that the JAX package's ``model.init``
    draws, from a generator seeded ``SEED`` (the card and the CPU
    processes build the same model); attention models in
    ``cross_batch:GROUP`` groups. Returns (model, attention group or
    None)."""
    import inspect

    import torch

    from multipitch_architectures_tpu_torch.experiments import (
        MODEL_REGISTRY, build_model)
    from multipitch_architectures_tpu_torch.models import init_parameters_flax

    kw, group = zoo2_kwargs(name), None
    if "attn_mode" in inspect.signature(MODEL_REGISTRY[name]).parameters:
        group = GROUP
        kw["attn_mode"] = f"cross_batch:{GROUP}"
    model = build_model(name, {**kw, **overrides})
    init_parameters_flax(model, torch.Generator().manual_seed(SEED))
    return model, group


def zoo2_cpu_forwards(path):
    """The CPU side of phase 12's card-vs-CPU forwards, in a process of its
    own with one thread: each class's eval forward of ``zoo_windows()``
    and its freq-pool choices, written to ``path``."""
    import torch

    torch.set_num_threads(1)
    x, out = zoo_windows(), {}
    for name, _, _ in ZOO2:
        model = zoo2_model(name)[0].eval()
        pools = []
        with torch.no_grad(), freq_pools(pools, replay=False):
            y = model(x)
        out[name] = {"y": list(y) if isinstance(y, tuple) else [y],
                     "pools": pools}
    torch.save(out, path)


def zoo2_out_shape(name, t):
    """What ``predict_framewise`` gives for ``t`` frames: 72 pitches, 73
    with the bottom stack's activity row, the log-softmax CNNs'
    ``n_ch_out`` channels of 72 (73 with the blank bin) flattened per
    frame as the JAX package's ``predict_framewise`` reshapes them."""
    kw = zoo2_kwargs(name)
    bins = 73 if name in ("freq_u_net_bottomstack",
                          "basic_cnn_segm_blank_logsoftmax") else 72
    return (t, kw.get("n_ch_out", 1) * bins)


def zoo2_serve(dev, card, name, batch, cpu):
    """One class of phase 12: its configuration and parameter count, a
    warm-up request and a ``ZOO2_SECONDS`` request through ``hcqt`` and
    ``predict_framewise``, one K1 launch each, (T, bins) finite (within
    [0, 1] but for the log-softmax CNNs, which give log-probabilities);
    then ``ZOO_CHECK_WINDOWS`` windows card vs the CPU process (atol
    ``MODEL_TOL``, the polyphony head's output included), the CPU's
    freq-pool choices replayed where they are near-ties. Returns the
    K1 launches of its requests."""
    import torch

    from multipitch_architectures_tpu_torch.dsp import hcqt
    from multipitch_architectures_tpu_torch.eval import predict_framewise
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves

    model, group = zoo2_model(name)
    n_params = sum(p.numel() for p in model.parameters())
    model.to(dev).eval()
    aux = "polyphony" in name

    def serve(y):
        t0 = time.perf_counter()
        f = hcqt(y, device=dev, **HCQT_KW)[0]
        out = predict_framewise(model, f, batch_size=batch, group=group,
                                return_aux=aux)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    before = cqt_octaves.launches
    serve(audio(REQUEST_SECONDS[-1], SEED + 99))        # warm-up request
    torch.cuda.reset_peak_memory_stats(dev)
    out, wall = serve(audio(ZOO2_SECONDS, SEED + 7))
    peak = torch.cuda.max_memory_allocated(dev)
    launches = cqt_octaves.launches - before
    pred, poly = out if aux else (out, None)
    t = frames(ZOO2_SECONDS)
    log_probs = "logsoftmax" in name
    ok = (tuple(pred.shape) == zoo2_out_shape(name, t)
          and bool(torch.isfinite(pred).all())
          and (log_probs or 0.0 <= float(pred.min()) <= float(pred.max())
               <= 1.0)
          and (not log_probs or float(pred.max()) <= 0.0))
    if aux:
        ok = ok and poly.shape[0] == t and bool(torch.isfinite(poly).all())
    if not ok or launches != 2:
        raise AssertionError(f"{name}: output {tuple(pred.shape)} in "
                             f"[{float(pred.min())}, {float(pred.max())}], "
                             f"aux {None if poly is None else poly.shape}, "
                             f"{launches} K1 launches in 2 requests")
    cfg = ", ".join(f"{k}={v}" for k, v in zoo2_kwargs(name).items())
    print(f"[zoo-2] {name} ({cfg}): {n_params:,} parameters; "
          f"{ZOO2_SECONDS} s -> {tuple(pred.shape)} in "
          f"[{float(pred.min()):.4f}, {float(pred.max()):.4f}]"
          + (f", polyphony {tuple(poly.shape)} finite" if aux else "")
          + f" (batch {batch}" + (f", cross_batch:{group}" if group else "")
          + f"): wall {wall * 1e3:.1f} ms, {ZOO2_SECONDS / wall:.2f}x real "
          f"time, peak device memory {peak / 2**30:.2f} GiB; 1 K1 launch "
          f"per request; {card}")

    with torch.no_grad(), freq_pools(cpu["pools"], replay=True) as fp:
        got = model(zoo_windows().to(dev))
    got = list(got) if isinstance(got, tuple) else [got]
    gaps = [float((g.cpu() - w).abs().max()) for g, w in zip(got, cpu["y"])]
    if len(got) != len(cpu["y"]) or not max(gaps) < MODEL_TOL:
        raise AssertionError(f"{name} card vs CPU: max abs gaps {gaps}")
    print(f"[zoo-2] {name} {ZOO_CHECK_WINDOWS} windows, card vs CPU (one "
          f"thread): max abs gap " + ", ".join(f"{g:.3e}" for g in gaps)
          + f" (< {MODEL_TOL:g}; {fp.flips} freq-pool near-ties replayed)")
    del model
    torch.cuda.empty_cache()
    return launches


def zoo2_int8(dev, card):
    """Phase 12's int8 request: ``ZOO2_INT8`` through
    ``predict_framewise_int8(batch_size=BATCH, group=GROUP, cal_batches=1)``
    on a ``ZOO2_INT8_SECONDS`` request, beside the float32 protocol: the
    calibration span equal to it (1e-6), the fused K2/K3 entry launched
    once per quantized conv per int8 batch, the worst-of-25 drift.
    Returns (K1 launches, K2/K3 launches)."""
    import torch

    from multipitch_architectures_tpu_torch.dsp import hcqt
    from multipitch_architectures_tpu_torch.eval import (
        eligible_convs, measure_drift, predict_framewise,
        predict_framewise_int8)
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        int8_conv2d_dequant)

    model, group = zoo2_model(ZOO2_INT8)
    model.to(dev).eval()
    n_convs = len(eligible_convs(model))
    before = cqt_octaves.launches
    f = hcqt(audio(ZOO2_INT8_SECONDS, SEED + 12), device=dev, **HCQT_KW)[0]
    cqt = cqt_octaves.launches - before
    want = predict_framewise(model, f, batch_size=BATCH, group=group)
    predict_framewise_int8(model, f, batch_size=BATCH, group=group,
                           cal_batches=1)                # warm-up
    int8_conv2d_dequant.launches = 0
    got, wall, peak = timed_request(lambda: predict_framewise_int8(
        model, f, batch_size=BATCH, group=group, cal_batches=1))
    launches = int8_conv2d_dequant.launches
    t = f.shape[1]
    batches = len(int8_batch_sizes(t, BATCH, group, 1))
    span = min(BATCH, t)
    cal_gap = float((got[:span] - want[:span]).abs().max())
    drift, _ = measure_drift(want.cpu().numpy(), got.cpu().numpy())
    print(f"[zoo-2] int8 {ZOO2_INT8} {ZOO2_INT8_SECONDS} s ({t} frames): "
          f"{n_convs} quantized convs x {batches} int8 batches = {launches} "
          f"K2/K3 launches; calibration span against the float32 protocol "
          f"{cal_gap:.3e} (<= {DEQUANT_TOL:g}); worst-of-25 drift against "
          f"float32 {max(drift.values()):.3e}; wall {wall * 1e3:.1f} ms, "
          f"peak {peak:.0f} MiB; {card}")
    if launches != n_convs * batches or not cal_gap <= DEQUANT_TOL or \
            cqt != 1:
        raise AssertionError(f"zoo-2 int8: {launches} K2/K3 launches for "
                             f"{n_convs} convs x {batches} batches, "
                             f"calibration span gap {cal_gap}, {cqt} K1")
    del model
    torch.cuda.empty_cache()
    return cqt, launches


def phase_zoo2(dev, card, procs):
    """Phase 12 (module docstring). Returns (K1 launches, K2/K3 launches)
    of its main path: the 19 classes' requests and the int8 request."""
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        int8_conv2d_dequant)

    cpu = zoo_cpu_result(procs, "zoo2_forwards")
    int8_conv2d_dequant.launches = cqt_octaves.launches = 0
    k1 = sum(zoo2_serve(dev, card, name, batch, cpu[name])
             for name, _, batch in ZOO2)
    if cqt_octaves.launches != k1 or int8_conv2d_dequant.launches:
        raise AssertionError(f"zoo-2: {cqt_octaves.launches} K1 launches "
                             f"counted, {k1} by request; "
                             f"{int8_conv2d_dequant.launches} K2/K3")
    int8_k1, k2 = zoo2_int8(dev, card)
    for name in ZOO2_TRAIN:
        zoo_step(dev, card, name, zoo_cpu_result(procs, "zoo2_steps",
                                                 part=name), reps=5)
    return k1 + int8_k1, k2



# -- the loaders phase (13): the native window loader and the datasets -------

LOADER_STRIDE = 5          # ≈ 500 windows per 60-s file of phase 10
LOADER_INDICES = 1000
LOADER_STEPS = 20
DATASET_STEPS = 3
DATASET_AUG = {"compression": 10.0, "aug:transpsemitones": 5,
               "aug:randomeq": 20, "aug:noisestd": 1e-4, "aug:tuning": True,
               "aug:smooth_len": 4, "aug:smooth_win": "hann", "seed": SEED}


def loader_pairs(features):
    """(hcqt, pitch) file pairs of the precompute CLI's output: the HCQT
    (216, T, 6) and the roll (128, T) of each recording."""
    names = sorted(os.listdir(os.path.join(features, "hcqt")))
    return [(os.path.join(features, "hcqt", n),
             os.path.join(features, "pitch", n)) for n in names]


def windows_per_s(batches, batch_size):
    """(windows per second, batches) of one pass over ``batches``, the
    card synchronised at the end."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in batches)
    torch.cuda.synchronize()
    return n * batch_size / (time.perf_counter() - t0), n


def fed_fit(dev, cfg, batches_fn, steps):
    """``Trainer.fit`` of exp180d (``deterministic`` off) for one epoch of
    ``steps`` batches from ``batches_fn``, after one warm-up step: (ms per
    step by the host clock, the card synchronised; the epoch's loss; the
    trainer)."""
    import dataclasses

    import torch

    from multipitch_architectures_tpu_torch.train import Trainer

    tc = dataclasses.replace(cfg.train_config, max_epochs=1,
                             max_train_batches=steps, scheduler=None,
                             early_stopping=False, deterministic=False)
    trainer = Trainer(cfg.build_model(), tc, device=dev).init()
    trainer.train_step(*next(iter(batches_fn(0, 0))))       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.fit(batches_fn)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / steps,
            hist["train_loss"][-1], trainer)


def loader_check(pairs):
    """Phase 13a: ``fill`` of ``LOADER_INDICES`` seeded indices equal to the
    port's ``gather_windows`` on the same files, bit for bit."""
    import torch

    from multipitch_architectures_tpu_torch.data import gather_windows
    from multipitch_architectures_tpu_torch.io import NativeWindowLoader

    loader = NativeWindowLoader(pairs, 75, LOADER_STRIDE)
    idx = np.random.RandomState(SEED).randint(0, len(loader), LOADER_INDICES)
    x, y = loader.fill(idx)
    files = [(torch.from_numpy(np.ascontiguousarray(
        np.load(h).transpose(2, 1, 0))), np.load(a)) for h, a in pairs]
    counts = np.cumsum([0] + [(f.shape[1] - 75) // LOADER_STRIDE
                              for f, _ in files])
    bad = 0
    for k, i in enumerate(idx):
        f = int(np.searchsorted(counts, i, side="right")) - 1
        inputs, roll = files[f]
        center = (i - counts[f]) * LOADER_STRIDE + 37
        want = gather_windows(inputs, [center], 75)[0].numpy()
        bad += not (np.array_equal(x[k], want) and np.array_equal(
            y[k], roll[24:96, center].astype(np.float32)))
    if bad or counts[-1] != len(loader):
        raise AssertionError(f"native loader: {bad} of {len(idx)} windows "
                             f"differ from gather_windows; {len(loader)} "
                             f"windows, {counts[-1]} by file")
    print(f"[loaders] native loader over the precompute CLI's output "
          f"({len(pairs)} files, (216, T, 6) / (128, T), stride "
          f"{LOADER_STRIDE}: {len(loader)} windows): {len(idx)} seeded "
          f"windows and targets equal gather_windows bit for bit")
    return loader, files


def loader_timing(dev, card, loader, files, train=None):
    """Phase 13b-c: ``trainer_batches`` alone against ``TrainPipeline`` on
    the same windows; exp180d fed by each through ``Trainer.fit``; a
    profile of 3 loader-fed steps, beside phase 8e's when ``train``
    holds it."""
    from multipitch_architectures_tpu_torch.data import FileSpec, TrainPipeline
    from multipitch_architectures_tpu_torch.experiments import load_experiment
    from multipitch_architectures_tpu_torch.io import trainer_batches

    bs = TRAIN_BATCH
    pipeline = TrainPipeline([FileSpec(x.numpy(), r.T) for x, r in files],
                             stride=LOADER_STRIDE, device=dev)
    if len(pipeline) != len(loader):
        raise AssertionError(f"{len(pipeline)} pipeline windows, "
                             f"{len(loader)} loader windows")
    windows_per_s(trainer_batches(loader, bs, device=dev), bs)   # warm-up
    rates = {}
    for label, fn in (
            ("trainer_batches", lambda: trainer_batches(loader, bs,
                                                        seed=1, device=dev)),
            ("TrainPipeline", lambda: pipeline.batches(1, bs)),
            ("trainer_batches again", lambda: trainer_batches(
                loader, bs, seed=2, device=dev))):
        rates[label], n = windows_per_s(fn(), bs)
    print(f"[loaders] one epoch ({n} batches of {bs}) alone, the card "
          f"synchronised at the end: " + "; ".join(
              f"{k} {v:,.0f} windows/s" for k, v in rates.items())
          + f" (the pipeline holds the recordings on the card and applies "
          f"the compression only here); {card}")

    cfg = load_experiment(TRAIN_EXPERIMENT)
    fed = {}
    for label, fn in (
            ("native loader", lambda epoch, seed: trainer_batches(
                loader, bs, seed=seed, device=dev)),
            ("TrainPipeline", lambda epoch, seed: pipeline.batches(seed,
                                                                   bs))):
        fed[label] = fed_fit(dev, cfg, fn, LOADER_STEPS)
    trainer = fed["native loader"][2]

    def three_steps():
        for i, (x, y) in enumerate(trainer_batches(loader, bs, seed=5,
                                                   device=dev)):
            trainer.train_step(x, y)
            if i == 2:
                break

    idle, wall, top = device_profile(three_steps, top=4)
    idle_txt = "not measured (no device kernels in the trace)" \
        if idle is None else f"{idle:.2%}"
    losses = [v[1] for v in fed.values()]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"loader-fed training: losses {losses}")
    print(f"[loaders] exp180d Trainer.fit, {LOADER_STEPS} steps at batch "
          f"{bs} (deterministic off, TF32 off): " + "; ".join(
              f"fed by the {k} {v[0]:.2f} ms per step (loss {v[1]:.4f})"
              for k, v in fed.items())
          + f"; 3 loader-fed steps profiled: wall {wall * 1e3:.1f} ms, "
          f"device idle {idle_txt}; top kernels: "
          + "; ".join(f"{k} {ms:.2f} ms" for k, ms in top) + f"; {card}")
    if train and "free_ms" in train:
        idle8 = "not measured" if train["idle"] is None else \
            f"{train['idle']:.2%}"
        print(f"[loaders] beside phase 8e's registry step (prebuilt "
              f"batches, augmentation on): {train['free_ms']:.2f} ms with "
              f"deterministic off; 3 pipeline-fed steps (deterministic on) "
              f"idle {idle8}")
    return rates, fed, idle


def dataset_steps(dev, card, files):
    """Phase 13d: ``dataset_context`` with every ``aug:*`` key through a
    ``DataLoader(pin_memory=True)`` into ``DATASET_STEPS`` exp180d steps;
    the first batch's items equal the same items built again on the
    CPU."""
    import torch

    from multipitch_architectures_tpu_torch.data import dataset_context
    from multipitch_architectures_tpu_torch.experiments import load_experiment
    from multipitch_architectures_tpu_torch.train import Trainer

    inputs, roll = files[0]
    targets = roll[24:96].T
    params = dict(DATASET_AUG, context=75, stride=LOADER_STRIDE)
    ds = dataset_context(inputs, targets, params)
    batches = torch.utils.data.DataLoader(ds, batch_size=TRAIN_BATCH,
                                          pin_memory=True)
    again = dataset_context(inputs, targets, params)
    cfg = load_experiment(TRAIN_EXPERIMENT)
    trainer = Trainer(cfg.build_model(), cfg.train_config, device=dev).init()
    losses = []
    for i, (x, y) in enumerate(batches):
        if i == 0:
            items = [again[j] for j in range(TRAIN_BATCH)]
            same = all(torch.equal(x[j], a) and torch.equal(y[j], b)
                       for j, (a, b) in enumerate(items))
            if not (same and x.is_pinned()):
                raise AssertionError(f"dataset_context: first batch equal "
                                     f"to the CPU's items {same}, pinned "
                                     f"{x.is_pinned()}")
        losses.append(float(trainer.train_step(
            x.to(dev, non_blocking=True), y.to(dev, non_blocking=True))))
        if i + 1 == DATASET_STEPS:
            break
    if not all(np.isfinite(losses)):
        raise AssertionError(f"dataset-fed steps: losses {losses}")
    print(f"[loaders] dataset_context (every aug:* key, seed {SEED}; "
          f"{len(ds)} items) through DataLoader(pin_memory=True) into "
          f"{DATASET_STEPS} exp180d steps at batch {TRAIN_BATCH}: losses "
          + ", ".join(f"{v:.4f}" for v in losses) + "; the first batch's "
          f"items equal the same items built on the CPU, pinned; {card}")


def phase_loaders(dev, card, features, train=None):
    """Phase 13 (module docstring), on the precompute CLI's output of
    phase 10's corpus under ``features``; ``train`` is phase 8's result,
    whose registry step (8e) is printed beside the loader-fed one.
    Launches no kernel."""
    pairs = loader_pairs(features)
    loader, files = loader_check(pairs)
    out = loader_timing(dev, card, loader, files, train)
    dataset_steps(dev, card, files)
    return out


# -- the parallel phase (14): meshes, sharded training and serving ---------

PARALLEL_SHARDS = 4               # the logical data mesh on one card
PARALLEL_BATCHES = (24, 25)       # even on every mesh; the protocol's
PARALLEL_LOSS_RTOL = 1e-5         # mesh vs the one-device step
PARALLEL_GRAD_TOL = 1e-3          # rel L2 of all gradients, float64
PARALLEL_PRED_TOL = 2e-5          # sharded vs single-device protocol
PARALLEL_SECONDS = 10.0
PARALLEL_PER_DEVICE = (250, 100)  # 250: the request is all tail at 431
PARALLEL_TIMED_STEPS = 3
PARALLEL_RUNNER_FRAMES = 250      # per synthetic file: a super-batch of 200
PADDED_BATCH = 5                  # on data=4: padded to 8


def parallel_meshes(dev):
    """(name, mesh): the visible cards, and two logical meshes of four
    shards on the card (``dev`` named four times)."""
    from multipitch_architectures_tpu_torch.parallel import make_mesh

    return (("cards", make_mesh()),
            (f"data={PARALLEL_SHARDS}",
             make_mesh(devices=[dev] * PARALLEL_SHARDS)),
            ("data=2 x model=2",
             make_mesh(devices=[dev] * PARALLEL_SHARDS, model_axis=2)))


def parallel_step(dev, mesh, x, y, w, dtype, deterministic=True,
                  dropout=True, name=TRAIN_EXPERIMENT):
    """One AdamW step of ``name`` (exp180d) at full width (the weights
    the JAX package's ``model.init`` draws, seeded; dropout on unless
    ``dropout`` is false, its generator seeded) on ``mesh``, or on ``dev``
    without one: (loss, all gradients flattened, float64, on the card;
    the trainer)."""
    import torch

    from multipitch_architectures_tpu_torch.models import init_parameters_flax
    from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer

    model = train_model(name)
    if not dropout:
        zero_dropout(model)
    init_parameters_flax(model, torch.Generator().manual_seed(SEED))
    cfg = TrainConfig(**{**TRAIN_STEP_CONFIG, "batch_size": x.shape[0],
                         "deterministic": deterministic})
    trainer = Trainer(model.to(dtype), cfg, device=None if mesh else dev,
                      mesh=mesh)
    torch.manual_seed(SEED)
    loss = float(trainer.train_step(x.to(dtype), y.to(dtype), w))
    grad = torch.cat([p.grad.flatten().double()
                      for p in trainer.model.parameters()])
    return loss, grad, trainer


def parallel_train(dev, card, meshes):
    """Phase 14a: exp180d on each mesh against the one-device step on
    the same (explicitly padded and weighted) batch, in float32 and in
    float64, dropout on where the batch needs no padding, off on both
    sides where it does (the mesh step draws the unpadded batch's masks,
    which the one-device step on the padded rows does not: phase 14b
    checks those); returns the worst loss and gradient gaps."""
    import torch

    from multipitch_architectures_tpu_torch.data import FileSpec, TrainPipeline

    pipeline = TrainPipeline([FileSpec(*synth_file(1200, seed=s))
                              for s in range(3)], device=dev)
    batches = {b: next(pipeline.batches(SEED, b, shuffle=False))
               for b in PARALLEL_BATCHES}
    refs, worst = {}, {"loss": 0.0, "grad64": 0.0, "grad32": 0.0}
    for name, mesh in meshes:
        for b in PARALLEL_BATCHES:
            x, y = batches[b]
            n = b + (-b) % mesh.size
            drop = n == b
            for dtype in (torch.float32, torch.float64):
                if (b, n, dtype) not in refs:
                    # the rows and weights the mesh's padding gives
                    idx = torch.arange(n, device=dev) % b
                    w = None if n == b else (idx == torch.arange(
                        n, device=dev)).to(dtype)
                    refs[b, n, dtype] = parallel_step(
                        dev, None, x[idx], y[idx], w, dtype,
                        dropout=drop)[:2]
                loss0, grad0 = refs[b, n, dtype]
                loss, grad, _ = parallel_step(dev, mesh, x, y, None, dtype,
                                              dropout=drop)
                rel_loss = abs(loss - loss0) / abs(loss0)
                rel_grad = float((grad - grad0).norm() / grad0.norm())
                bits = 64 if dtype == torch.float64 else 32
                worst["loss"] = max(worst["loss"], rel_loss)
                worst[f"grad{bits}"] = max(worst[f"grad{bits}"], rel_grad)
                print(f"[parallel] exp180d step, batch {b} on {name} "
                      f"{mesh.shape} (padded to {n}; dropout "
                      f"{'on' if drop else 'off'}), float{bits}: loss "
                      f"{loss:.7f} vs one device {loss0:.7f}, rel "
                      f"{rel_loss:.2e} (<= {PARALLEL_LOSS_RTOL:g}); all "
                      f"gradients rel L2 {rel_grad:.2e}" + (
                          f" (<= {PARALLEL_GRAD_TOL:g})" if bits == 64 else
                          " (float32: printed, held in float64)"))
                if not (rel_loss <= PARALLEL_LOSS_RTOL and (
                        bits == 32 or rel_grad <= PARALLEL_GRAD_TOL)):
                    raise AssertionError(f"{name}: the sharded step differs "
                                         f"from the one-device step")
    return worst


def parallel_padded_dropout(dev, card, mesh):
    """Phase 14b: CNN:M (exp126c: no BatchNorm, no cross-batch
    attention; dropout on) at batch 5 on ``mesh`` (padded to 8 with loss
    weight 0) against the unpadded one-device step: the mesh step draws
    the 5 real rows' masks, so the losses are equal (rel 1e-5), as the
    JAX package's padded step is; returns the gap."""
    import torch

    from multipitch_architectures_tpu_torch.data import FileSpec, TrainPipeline

    name = ZOO[0][0]
    pipeline = TrainPipeline([FileSpec(*synth_file(600, seed=SEED + 14))],
                             device=dev)
    x, y = next(pipeline.batches(SEED, PADDED_BATCH, shuffle=False))
    loss0 = parallel_step(dev, None, x, y, None, torch.float32,
                          name=name)[0]
    loss = parallel_step(dev, mesh, x, y, None, torch.float32, name=name)[0]
    rel = abs(loss - loss0) / abs(loss0)
    n = PADDED_BATCH + (-PADDED_BATCH) % mesh.size
    print(f"[parallel] CNN:M step, batch {PADDED_BATCH} on {mesh.shape} "
          f"(padded to {n}), dropout on: loss {loss:.7f} vs the unpadded "
          f"one-device step {loss0:.7f}, rel {rel:.2e} (<= "
          f"{PARALLEL_LOSS_RTOL:g})")
    if not rel <= PARALLEL_LOSS_RTOL:
        raise AssertionError("the padded step's dropout differs from the "
                             "unpadded step's")
    return rel


def parallel_default(dev):
    """Phase 14c: ``Trainer(model, cfg)`` with neither a device nor a
    mesh spans the visible cards: the one-device step on one card, a
    ``data`` mesh of all of them on several; returns the path."""
    import torch

    from multipitch_architectures_tpu_torch.train import TrainConfig, Trainer

    n_cards = torch.cuda.device_count()
    trainer = Trainer(train_model(ZOO[0][0]), TrainConfig())
    path = ("the one-device step on " + str(trainer.device)
            if trainer.mesh is None else
            f"data-parallel over {trainer.mesh.shape}")
    print(f"[parallel] Trainer(model, cfg) with {n_cards} visible card(s): "
          f"{path}")
    if (trainer.mesh is None) != (n_cards == 1) or (
            trainer.mesh is not None and trainer.mesh.size != n_cards):
        raise AssertionError("the default device set is not every card")
    return path


def parallel_timing(dev, card, meshes):
    """Phase 14d: ms per exp180d ``train_step`` at batch 24 on one device
    and on each mesh, ``deterministic`` on and off (CUDA events)."""
    import dataclasses

    import torch

    x, y = (torch.rand(PARALLEL_BATCHES[0], 6, 75, 216, device=dev),
            (torch.rand(PARALLEL_BATCHES[0], 1, 1, 72, device=dev) > 0.9
             ).float())
    times = {}
    for name, mesh in (("one device", None),) + tuple(meshes):
        if name == "cards" and mesh.size == 1:
            continue      # one card: the one-device step with a mesh's cost
        _, _, trainer = parallel_step(dev, mesh, x, y, None, torch.float32)
        for det in (True, False):
            trainer.config = dataclasses.replace(trainer.config,
                                                 deterministic=det)
            times[name, det] = cuda_ms(lambda: trainer.train_step(x, y),
                                       reps=PARALLEL_TIMED_STEPS, warmup=1)
        print(f"[parallel] exp180d train_step at batch "
              f"{PARALLEL_BATCHES[0]} on {name}"
              + ("" if mesh is None else f" {mesh.shape}")
              + f": {times[name, True]:.2f} ms with deterministic on, "
              f"{times[name, False]:.2f} ms off ({PARALLEL_TIMED_STEPS} steps "
              f"after 1, CUDA events); {card}"
              + ("" if mesh is None or name == "cards" else
                 "; logical shards of one card measure the mechanism's "
                 "overhead, not a speed-up"))
    return times


def parallel_serving(dev, card, mesh):
    """Phase 14e: a 10-s exp180e request (HCQT on K1, ``cross_batch:50``)
    through ``predict_framewise_sharded`` on the logical data mesh, per
    device batches of 250 (the request's 431 windows are all tail) and
    100 (a super-batch of 400, a tail of 31), against
    ``predict_framewise(batch_size=250, group=50)``; returns the K1
    launches (one per request) and the gap."""
    import torch

    from multipitch_architectures_tpu_torch.dsp import hcqt
    from multipitch_architectures_tpu_torch.eval import (
        predict_framewise, predict_framewise_sharded)
    from multipitch_architectures_tpu_torch.experiments import load_experiment
    from multipitch_architectures_tpu_torch.models import init_parameters
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves

    model = load_experiment(EXPERIMENT).build_model(
        attn_mode=f"cross_batch:{GROUP}")
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model.eval().to(dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    y = audio(PARALLEL_SECONDS, SEED + 14)
    cqt_octaves.launches = 0
    worst = 0.0
    for per_device in PARALLEL_PER_DEVICE:
        f, hcqt_ms = timed(lambda: hcqt(y, device=dev, **HCQT_KW)[0])
        want, one_ms = timed(lambda: predict_framewise(
            model, f, batch_size=BATCH, group=GROUP))
        for _ in range(2):       # the second call is timed warm
            got, sharded_ms = timed(lambda: predict_framewise_sharded(
                model, f, mesh, per_device_batch=per_device, group=GROUP))
        gap = float((got - want).abs().max())
        worst = max(worst, gap)
        ok = (got.shape == (frames(PARALLEL_SECONDS), 72)
              and bool(torch.isfinite(got).all()) and gap <= PARALLEL_PRED_TOL)
        print(f"[parallel] {PARALLEL_SECONDS:g}-s exp180e request on "
              f"{mesh.shape}, per-device batch {per_device}, group {GROUP}: "
              f"{tuple(got.shape)}, max abs gap to predict_framewise("
              f"batch_size={BATCH}) {gap:.2e} (<= {PARALLEL_PRED_TOL:g}); "
              f"sharded {sharded_ms:.1f} ms, one device {one_ms:.1f} ms, "
              f"hcqt {hcqt_ms:.1f} ms (host clock, synchronised); {card}; "
              f"logical shards of one card measure the mechanism's "
              f"overhead, not a speed-up")
        if not ok:
            raise AssertionError("the sharded request differs from the "
                                 "single-device protocol")
    if cqt_octaves.launches != len(PARALLEL_PER_DEVICE):
        raise AssertionError(f"{cqt_octaves.launches} CQT launches in "
                             f"{len(PARALLEL_PER_DEVICE)} requests")
    return cqt_octaves.launches, worst


def parallel_runner(dev, card, mesh):
    """Phase 14f: one ``run_experiment`` test phase of exp180d (seeded
    weights, synthetic files) on the logical data mesh against
    the same run on one device: every stored prediction within 2e-5."""
    import logging
    import tempfile

    from multipitch_architectures_tpu_torch.experiments import (
        SyntheticCorpus, load_experiment, run_experiment)

    cfg = load_experiment(TRAIN_EXPERIMENT)
    corpus = SyntheticCorpus(cfg, frames=PARALLEL_RUNNER_FRAMES,
                             n_train_files=1, seed=SEED)
    kw = dict(do_train=False, do_val=False, store_predictions=True,
              store_results_filewise=False)
    records = []

    class Capture(logging.Handler):
        def emit(self, r):
            records.append(r.getMessage())

    with tempfile.TemporaryDirectory() as tmp:
        log = logging.getLogger("parallel_runner")
        log.setLevel(logging.INFO)
        log.addHandler(Capture())
        t0 = time.perf_counter()
        run_experiment(cfg, corpus, os.path.join(tmp, "one"), logger=log,
                       device=dev, **kw)
        t1 = time.perf_counter()
        run_experiment(cfg, corpus, os.path.join(tmp, "mesh"), logger=log,
                       mesh=mesh, **kw)
        t2 = time.perf_counter()
        one = os.path.join(tmp, "one", "predictions", cfg.name)
        names = sorted(os.listdir(one))
        gap = max(float(np.abs(
            np.load(os.path.join(tmp, "mesh", "predictions", cfg.name, n))
            - np.load(os.path.join(one, n))).max()) for n in names)
    sharded = [m for m in records if m.startswith("Test dispatch sharded")]
    print(f"[parallel] run_experiment test phase of exp180d on "
          f"{mesh.shape}: {sharded}; {len(names)} prediction files, max "
          f"abs gap to the one-device run {gap:.2e} (<= "
          f"{PARALLEL_PRED_TOL:g}); {t2 - t1:.1f} s vs {t1 - t0:.1f} s")
    if not (sharded and names and gap <= PARALLEL_PRED_TOL):
        raise AssertionError("the sharded test phase differs from the "
                             "one-device run")
    return gap


def phase_parallel(dev, card):
    """Phase 14 of the module docstring: returns the K1 launches of its
    requests and the numbers PERF.md keeps."""
    meshes = parallel_meshes(dev)
    for name, mesh in meshes:
        print(f"[parallel] mesh {name}: {mesh}")
    out = {"train": parallel_train(dev, card, meshes)}
    out["padded_dropout"] = parallel_padded_dropout(dev, card, meshes[1][1])
    out["default"] = parallel_default(dev)
    out["times"] = parallel_timing(dev, card, meshes)
    launches, out["serving_gap"] = parallel_serving(dev, card, meshes[1][1])
    out["runner_gap"] = parallel_runner(dev, card, meshes[1][1])
    return launches, out


PREDICT_SECONDS = 10.0
PREDICT_BATCH = 50                # the CLI's default, the example's
PREDICT_TOL = 1e-5                # the CLI against the same calls in-process
PREDICT_INT8_TOL = 1e-6
PREDICT_CLI = "multipitch_architectures_tpu_torch.experiments.predict"
# the example's frontend, written out here apart from the CLI's
PREDICT_HCQT = dict(fs=FS, fs_hcqt_target=50, bins_per_octave=36,
                    num_octaves=6)


def predict_checkpoint(name, path):
    """Registry entry ``name``'s model at full width with the weights the
    JAX package's ``model.init`` draws (seeded), saved at ``path`` as a
    bare ``state_dict`` (the reference's key layout): (the model in eval
    mode, the CLI's ``--checkpoint``, ``--model`` and ``--model-args``)."""
    import torch

    from multipitch_architectures_tpu_torch.experiments import load_experiment
    from multipitch_architectures_tpu_torch.models import init_parameters_flax

    cfg = load_experiment(name)
    model = cfg.build_model()
    init_parameters_flax(model, torch.Generator().manual_seed(SEED))
    torch.save(model.state_dict(), path)
    return model.eval(), ["--checkpoint", path, "--model", cfg.model_class,
                          "--model-args", json.dumps(cfg.model_kwargs)]


def predict_request(argv, out):
    """One request through the CLI's ``main`` in this process: (the
    prediction, the polyphony logits or None, wall ms, K1 launches, K2/K3
    launches), the counts set to 0 just before and read just after."""
    import torch

    from multipitch_architectures_tpu_torch.experiments import predict
    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        int8_conv2d_dequant)

    torch.cuda.synchronize()
    int8_conv2d_dequant.launches = cqt_octaves.launches = 0
    t0 = time.perf_counter()
    if predict.main(argv + ["--out", out]) != 0:
        raise RuntimeError(f"the predict CLI failed on {argv}")
    ms = (time.perf_counter() - t0) * 1e3
    k1, k23 = cqt_octaves.launches, int8_conv2d_dequant.launches
    poly = out.replace(".npy", "_polyphony.npy")
    return (np.load(out), np.load(poly) if os.path.exists(poly) else None,
            ms, k1, k23)


def predict_check(what, got, want, tol, card, ms, k1, k23):
    gap = float(np.abs(got - want).max())
    ok = got.shape == want.shape and bool(np.isfinite(got).all()) and \
        gap <= tol
    print(f"[predict] {what}: {got.shape}, max abs gap {gap:.2e} (<= "
          f"{tol:g}); {ms:.1f} ms wall (host clock, the card synchronised); "
          f"K1 launches {k1}, K2/K3 launches {k23}; {card}")
    if not ok:
        raise AssertionError(f"predict: {what} differs")
    return gap


def phase_predict(dev, card, tmp):
    """Phase 15 of the module docstring: returns the K1 and K2/K3
    launches of the CLI's requests in this process and the worst gap."""
    import torch
    from scipy.io import wavfile

    from multipitch_architectures_tpu_torch.dsp import compute_efficient_hcqt
    from multipitch_architectures_tpu_torch.eval import (
        predict_framewise, predict_framewise_int8)
    from multipitch_architectures_tpu_torch.io import load_audio
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        int8_conv2d_dequant)

    root = os.path.join(tmp, "predict")
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(SEED + 15)
    wav = os.path.join(root, "request.wav")
    y = synth(note_events(rng, PREDICT_SECONDS, 3), PREDICT_SECONDS, FS, dev,
              seed=SEED + 15)
    wavfile.write(wav, FS, y[:, 0].astype(np.float32))
    model, args = predict_checkpoint(EXPERIMENT, os.path.join(root, "xl.pt"))
    model.to(dev)
    k1 = k23 = 0
    worst = 0.0

    # (a) --audio against the same calls in this process
    got_a, _, ms, n1, n23 = predict_request(args + ["--audio", wav],
                                            os.path.join(root, "a.npy"))
    k1, k23 = k1 + n1, k23 + n23
    f, _, _ = compute_efficient_hcqt(load_audio(wav, FS), device=dev,
                                     **PREDICT_HCQT)
    x = torch.from_numpy(np.ascontiguousarray(f.transpose(2, 1, 0))).to(dev)
    with torch.no_grad():
        want = predict_framewise(model, x, batch_size=PREDICT_BATCH)
    worst = max(worst, predict_check(
        f"(a) exp180e --audio {PREDICT_SECONDS:g} s vs compute_efficient_hcqt"
        f" + predict_framewise", got_a, want.cpu().numpy(), PREDICT_TOL,
        card, ms, n1, n23))
    if got_a.shape != (frames(PREDICT_SECONDS), 72) or n1 != 1:
        raise AssertionError("predict: --audio is not one HCQT of the "
                             "request's frames")

    # (b) --hcqt on (a)'s HCQT in the reference's layout
    hcqt = os.path.join(root, "request_hcqt.npy")
    np.save(hcqt, f)
    got_b, _, ms, n1, n23 = predict_request(args + ["--hcqt", hcqt],
                                            os.path.join(root, "b.npy"))
    worst = max(worst, predict_check(
        "(b) exp180e --hcqt (216, T, 6) vs (a)", got_b, got_a, PREDICT_TOL,
        card, ms, n1, n23))

    # (c) --int8 against predict_framewise_int8 in this process
    got_c, _, ms, n1, n23 = predict_request(
        args + ["--hcqt", hcqt, "--int8"], os.path.join(root, "c.npy"))
    k23 += n23
    int8_conv2d_dequant.launches = 0
    with torch.no_grad():
        want = predict_framewise_int8(model, x, batch_size=PREDICT_BATCH)
    if int8_conv2d_dequant.launches != n23 or not n23:
        raise AssertionError(f"predict: {n23} K2/K3 launches through the "
                             f"CLI, {int8_conv2d_dequant.launches} in "
                             f"process")
    worst = max(worst, predict_check(
        "(c) exp180e --hcqt --int8 vs predict_framewise_int8", got_c,
        want.cpu().numpy(), PREDICT_INT8_TOL, card, ms, n1, n23))
    del model

    # (d) PUnet:XL --audio: its polyphony logits
    punet, pargs = predict_checkpoint(ZOO_PUNET, os.path.join(root, "p.pt"))
    punet.to(dev)
    out_d = os.path.join(root, "d.npy")
    got_d, poly, ms, n1, n23 = predict_request(pargs + ["--audio", wav],
                                               out_d)
    k1 += n1
    with torch.no_grad():
        want, aux = predict_framewise(punet, x, batch_size=PREDICT_BATCH,
                                      return_aux=True)
    worst = max(worst, predict_check(
        "(d) PUnet:XL --audio vs predict_framewise(return_aux=True)", got_d,
        want.cpu().numpy(), PREDICT_TOL, card, ms, n1, n23))
    if poly is None or poly.shape != (got_d.shape[0], 24):
        raise AssertionError("predict: no (T, 24) _polyphony.npy")
    worst = max(worst, predict_check(
        "(d) PUnet:XL _polyphony.npy vs the aux output", poly,
        aux.cpu().numpy(), PREDICT_TOL, card, ms, n1, n23))
    del punet

    # (a) again, in a fresh process
    out_f = os.path.join(root, "fresh.npy")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", PREDICT_CLI] + args + ["--audio", wav,
                                                      "--out", out_f],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if child.returncode:
        raise RuntimeError(f"the predict CLI's process failed:\n"
                           f"{child.stderr[-4000:]}")
    request_ms = float(child.stdout.strip().splitlines()[-1].split(" in ")[-1]
                       .split()[0])
    gap = float(np.abs(np.load(out_f) - got_a).max())
    worst = max(worst, gap)
    print(f"[predict] `python -m {PREDICT_CLI} --audio` in a fresh process: "
          f"{wall:.2f} s wall, of which the request {request_ms:.1f} ms and "
          f"start-up (imports, the CQT kernel's build or load) "
          f"{wall - request_ms / 1e3:.2f} s; max abs gap to (a) {gap:.2e} "
          f"(<= {PREDICT_TOL:g}); {card}")
    if gap > PREDICT_TOL:
        raise AssertionError("predict: the fresh process differs from (a)")
    return k1, k23, worst


def main():
    import tempfile

    t0 = time.perf_counter()
    seconds = {}

    def lap(phase):
        nonlocal t0
        t = time.perf_counter()
        seconds[phase], t0 = t - t0, t

    dev, card = phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        # the zoo's CPU references take minutes on one core each: they run
        # beside every phase until the zoo phase reads them
        procs = start_zoo_cpu(tmp)
        try:
            launches = run_phases(dev, card, procs, lap, tmp)
        finally:
            stop(procs)

    import torch

    print("[phases] seconds: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in seconds.items()))
    cqt_launches, cqt, gemm_launches, gemm = launches
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


def run_phases(dev, card, procs, lap, tmp):
    """Phases 2-15; returns the kernels' launches on the main paths and
    their measurements."""
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

    from multipitch_architectures_tpu_torch.ops.cqt_octave import cqt_octaves
    from multipitch_architectures_tpu_torch.ops.int8_gemm import (
        int8_conv2d_dequant)

    int8_conv2d_dequant.launches = cqt_octaves.launches = 0
    train = phase_train(dev, card)
    print(f"[train] the training path launched the CQT kernel "
          f"{cqt_octaves.launches} times and the int8 GEMM "
          f"{int8_conv2d_dequant.launches} times: it has no hand-written "
          f"kernel (its backward runs through autograd and cuDNN)")
    lap("train")

    int8_conv2d_dequant.launches = cqt_octaves.launches = 0
    zoo_launches = phase_zoo(dev, card, procs)
    if cqt_octaves.launches != zoo_launches or int8_conv2d_dequant.launches:
        raise AssertionError(f"zoo: {cqt_octaves.launches} CQT launches "
                             f"counted, {zoo_launches} by request; "
                             f"{int8_conv2d_dequant.launches} int8 GEMM")
    print(f"[zoo] the zoo's {2 * len(ZOO)} requests launched the CQT kernel "
          f"{cqt_octaves.launches} times (once per request) and the int8 "
          f"GEMM {int8_conv2d_dequant.launches} times (int8 serving is the "
          f"SAUnet's)")
    lap("zoo")

    audio_root = os.path.join(tmp, "audio")
    audio_launches, _ = phase_audio(dev, card, audio_root)
    print(f"[audio] the audio path's run and precompute launched the CQT "
          f"kernel {audio_launches} times (once per file read) and the int8 "
          f"GEMM 0 times")
    lap("audio")

    serving2_cqt, serving2_gemm = phase_serving2(dev, card, tmp)
    print(f"[serving-2] the shared-inc, artifact and int8-option paths "
          f"launched the CQT kernel {serving2_cqt} times (once per HCQT) "
          f"and the int8 GEMM {serving2_gemm} times")
    lap("serving-2")

    zoo2_cqt, zoo2_gemm = phase_zoo2(dev, card, procs)
    print(f"[zoo-2] the 19 classes' {2 * len(ZOO2)} requests and the int8 "
          f"request launched the CQT kernel {zoo2_cqt} times (once per "
          f"request) and the int8 GEMM {zoo2_gemm} times (once per "
          f"quantized conv per int8 batch)")
    lap("zoo-2")

    int8_conv2d_dequant.launches = cqt_octaves.launches = 0
    phase_loaders(dev, card, os.path.join(audio_root, "features"), train)
    if cqt_octaves.launches or int8_conv2d_dequant.launches:
        raise AssertionError(f"loaders: {cqt_octaves.launches} CQT and "
                             f"{int8_conv2d_dequant.launches} int8 GEMM "
                             f"launches")
    print("[loaders] the loader paths launched no kernel (their work is the "
          "host's and the copies')")
    lap("loaders")

    int8_conv2d_dequant.launches = cqt_octaves.launches = 0
    parallel_cqt, _ = phase_parallel(dev, card)
    if cqt_octaves.launches != parallel_cqt or int8_conv2d_dequant.launches:
        raise AssertionError(f"parallel: {cqt_octaves.launches} CQT "
                             f"launches counted, {parallel_cqt} by request; "
                             f"{int8_conv2d_dequant.launches} int8 GEMM")
    print(f"[parallel] the sharded paths launched the CQT kernel "
          f"{parallel_cqt} times (once per request) and the int8 GEMM 0 "
          f"times (the collectives are device copies and sums: no kernel of "
          f"their own)")
    lap("parallel")

    predict_cqt, predict_gemm, _ = phase_predict(dev, card, tmp)
    print(f"[predict] the predict CLI's requests in this process launched "
          f"the CQT kernel {predict_cqt} times (once per --audio request) "
          f"and the int8 GEMM {predict_gemm} times (the --int8 request)")
    lap("predict")
    return (cqt_launches + zoo_launches + audio_launches + serving2_cqt
            + zoo2_cqt + parallel_cqt + predict_cqt, cqt,
            gemm_launches + serving2_gemm + zoo2_gemm + predict_gemm, gemm)


if __name__ == "__main__":
    sys.exit(main())
