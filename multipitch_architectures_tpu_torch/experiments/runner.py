"""The single experiment runner, on one device.

Counterpart of ``multipitch_architectures_tpu/experiments/runner.py``,
which replaces the reference's per-script train/val/test program
(canonical anatomy exp180d…py:185-520, SURVEY §2.8) with one
implementation driven by :class:`ExperimentConfig`:

- split by filename-prefix matching (exp180d…py:238-247);
- train with the augmentation on the device, validate without;
- test on the reference's 3 subsets (10-file full / 3-file first 90 s
  (3920 frames) / 3-file full, exp180d…py:403-426) with the stride-1
  windowed protocol (``eval.predict_framewise``; cross-batch attention
  models regrouped as ``cross_batch:<test_batch_size>``), per-file
  predictions saved as .npy, both measure families (11 + 14), filewise
  and frame-weighted means logged in the reference's format, subset 0
  written to CSV (with the ``csv`` module, in pandas' layout: the
  machine with the card has no pandas).

Corpora: precomputed ``.npy`` features (:class:`NpyCorpus`), audio and
note-event files turned into features at load time (:class:`AudioCorpus`,
the HCQT on the device) and synthetic data (:class:`SyntheticCorpus`).
The test phase's dispatch sharded over several devices is left out by
design: the port runs on one card.
"""

import csv
import dataclasses
import logging
import math
import os
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data import FileSpec, TrainPipeline
from ..eval import (calculate_eval_measures, calculate_mpe_measures_mireval,
                    predict_framewise)
from ..ops.attention import TorchMultiheadAttention
from ..train.trainer import Trainer, _Checkpointer
from ..utils import model_summary
from .configs import ExperimentConfig

MIREVAL_KEYS = [
    "Precision", "Recall", "Accuracy", "Substitution Error", "Miss Error",
    "False Alarm Error", "Total Error", "Chroma Precision", "Chroma Recall",
    "Chroma Accuracy", "Chroma Substitution Error", "Chroma Miss Error",
    "Chroma False Alarm Error", "Chroma Total Error",
]


@dataclass
class NpyCorpus:
    """Per-file ``.npy`` pairs like the reference's precomputed features:
    ``data_dir/<fn>.npy`` = HCQT (216, T, 6), ``annot_dir/<fn>.npy`` =
    pitch roll (128, T) (exp180d…py:258-278 layout)."""

    data_dir: str
    annot_dir: str

    def files(self) -> List[str]:
        return sorted(os.listdir(self.data_dir))

    def load(self, fn: str) -> Tuple[np.ndarray, np.ndarray]:
        inputs = np.transpose(
            np.load(os.path.join(self.data_dir, fn)), (2, 1, 0))
        targets = np.load(os.path.join(self.annot_dir, fn)).T
        return inputs.astype(np.float32), targets.astype(np.float32)


def audio_example(audio_path: str, annot_path: str, *, fs: int = 22050,
                  fs_hcqt_target: float = 50.0, bins_per_octave: int = 36,
                  chunk_frames: Optional[int] = None, schema=None,
                  exact: bool = False, device=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One recording's training pair from its files: the efficient HCQT
    of the audio with its tuning estimated (6, T, 216) and the
    rasterized pitch roll (T, 128), both float32 numpy, as
    :meth:`NpyCorpus.load` gives them. The HCQT runs on ``device``
    (streamed with ``chunk_frames``); reading, resampling, tuning and
    rasterizing run on the host."""
    from ..dsp import (compute_annotation_array_nooverlap,
                       compute_efficient_hcqt)
    from ..io import load_audio, load_note_events

    audio = load_audio(audio_path, fs)
    f_hcqt, fs_hcqt, _ = compute_efficient_hcqt(
        audio, fs=fs, fs_hcqt_target=fs_hcqt_target,
        bins_per_octave=bins_per_octave, num_octaves=6,
        chunk_frames=chunk_frames, exact=exact, device=device)
    events = load_note_events(annot_path, schema=schema)
    roll = compute_annotation_array_nooverlap(
        events, f_hcqt.shape[1], fs_hcqt, annot_type="pitch")
    return (np.transpose(f_hcqt, (2, 1, 0)).astype(np.float32),
            np.asarray(roll, np.float32).T)


def annotation_path(csv_dir: str, name: str) -> str:
    """``csv_dir/<name>.csv``, else ``<name>.txt`` where only that exists."""
    annot = os.path.join(csv_dir, name + ".csv")
    txt = os.path.join(csv_dir, name + ".txt")
    if not os.path.exists(annot) and os.path.exists(txt):
        return txt
    return annot


@dataclass
class AudioCorpus:
    """Train directly from audio, with no precompute step (the reference
    requires notebook-01 precomputation to .npy first).

    ``audio_dir/<name>.wav|.npy`` + ``csv_dir/<name>.csv|.txt``
    (MusicNet/SWD auto-detected; Bach10, PHENICX-Anechoic,
    ChoralSingingDataset and custom formats via ``annotation_schema``,
    io.NOTE_EVENT_SCHEMAS) → the efficient HCQT on ``device`` (the card
    unless ``"cpu"``; streamed via ``chunk_frames`` for long recordings)
    and the rasterized pitch roll (:func:`audio_example`), computed at
    load time and LRU-cached in the process (an epoch re-reads every
    file).

    Memory: the float32 HCQT is 6×216×4 B per frame at ≈ 43 Hz ≈ 13.4 MB
    per minute of audio, so a MusicNet-scale corpus (≈ 34 h) is ≈ 27 GB;
    the default ``cache_bytes`` (8 GiB ≈ 10 h of audio) bounds what stays
    resident, and the least recently used recordings are computed again
    on the next epoch. ``cache_bytes=None`` leaves the cache unbounded;
    precompute to .npy (``experiments/precompute.py``) and use
    :class:`NpyCorpus` where recomputation is too slow."""

    audio_dir: str
    csv_dir: str
    fs: int = 22050
    fs_hcqt_target: float = 50.0
    bins_per_octave: int = 36
    chunk_frames: Optional[int] = None
    cache: bool = True
    cache_bytes: Optional[int] = 8 << 30
    #: None = auto-detect MusicNet / SWD csv; otherwise a
    #: io.NOTE_EVENT_SCHEMAS preset name ('bach10', 'phenicx', 'csd', …)
    #: or a custom io.NoteEventSchema column map. Annotation files may
    #: then be .csv OR .txt (<name>.csv preferred when both exist).
    annotation_schema: Optional[object] = None
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._cache: "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = \
            OrderedDict()
        self._cache_nbytes = 0

    def files(self) -> List[str]:
        return sorted(fn for fn in os.listdir(self.audio_dir)
                      if fn.endswith((".wav", ".npy")))

    def load(self, fn: str) -> Tuple[np.ndarray, np.ndarray]:
        if fn in self._cache:
            self._cache.move_to_end(fn)               # LRU refresh
            return self._cache[fn]
        out = audio_example(
            os.path.join(self.audio_dir, fn),
            annotation_path(self.csv_dir, os.path.splitext(fn)[0]),
            fs=self.fs, fs_hcqt_target=self.fs_hcqt_target,
            bins_per_octave=self.bins_per_octave,
            chunk_frames=self.chunk_frames, schema=self.annotation_schema,
            device=self.device)
        nbytes = out[0].nbytes + out[1].nbytes
        if self.cache and (self.cache_bytes is None
                           or nbytes <= self.cache_bytes):
            self._cache[fn] = out
            self._cache_nbytes += nbytes
            while (self.cache_bytes is not None
                   and self._cache_nbytes > self.cache_bytes):
                _, old = self._cache.popitem(last=False)
                self._cache_nbytes -= old[0].nbytes + old[1].nbytes
        return out


@dataclass
class SyntheticCorpus:
    """Synthetic data for smoke runs: file names are derived from the
    experiment's split prefixes so the prefix matching exercises the same
    code path as real data. The same names and seeds as the JAX
    package's, so the same files."""

    config: ExperimentConfig
    frames: int = 400
    n_train_files: int = 2
    seed: int = 0

    def files(self) -> List[str]:
        names = [f"train{i:03d}_synth.npy" for i in range(self.n_train_files)]
        for v in self.config.val_versions[:1]:
            names.append(f"{v}valsynth.npy")
        for v in (self.config.test_versions or ["test_"])[:2]:
            names.append(f"{v}testsynth.npy")
        for v in self.config.test_versions_small[:1]:
            if not any(n.startswith(v) for n in names):
                names.append(f"{v}testsynth.npy")
        return names

    def load(self, fn: str):
        # stable digest (zlib.crc32), NOT hash(): python string hashing is
        # salted per process, which would make smoke runs irreproducible
        rng = np.random.RandomState(
            (zlib.crc32(fn.encode()) + self.seed) % (2 ** 31))
        t = self.frames
        inputs = rng.rand(6, t, 216).astype(np.float32)
        targets = (rng.rand(t, 128) > 0.93).astype(np.float32)
        return inputs, targets


def _slice_targets(targets, cfg: ExperimentConfig):
    if cfg.num_output_bins != 12:
        return targets[:, cfg.min_pitch:cfg.min_pitch + cfg.num_output_bins]
    return targets


def _matches(fn: str, versions: Sequence[str]) -> bool:
    return any(v in fn for v in versions)


class _MultiCorpus:
    """Union of corpora with per-corpus train/val strides (the Exp4
    big-mix setup, configs.BIGMIX_STRIDES). Member corpora must have
    disjoint file names."""

    def __init__(self, members):
        # members: list of (corpus, train_stride, val_stride)
        self.members = members
        self._index = {}
        for corpus, ts, vs in members:
            for fn in corpus.files():
                self._index[fn] = (corpus, ts, vs)

    def files(self) -> List[str]:
        return sorted(self._index)

    def load(self, fn: str):
        return self._index[fn][0].load(fn)

    def strides(self, fn: str) -> Tuple[int, int]:
        _, ts, vs = self._index[fn]
        return ts, vs


def run_experiment(cfg: ExperimentConfig, corpus, out_dir: str,
                   logger: Optional[logging.Logger] = None,
                   do_train: bool = True, do_val: bool = True,
                   do_test: bool = True, store_predictions: bool = True,
                   store_results_filewise: bool = True,
                   max_epochs_override: Optional[int] = None,
                   resume: bool = False, device=None) -> Dict:
    """Run one experiment end to end on ``device`` (the card by default;
    raises without one unless ``device="cpu"``). Returns a results dict
    with the history and the per-subset measure aggregates.

    ``corpus`` may be a single corpus (NpyCorpus/AudioCorpus/
    SyntheticCorpus) or a
    list of ``(corpus, train_stride, val_stride)`` tuples for the Exp4
    big-mix protocol.

    ``resume=True`` restores the experiment's checkpoint (full training
    state, epoch, lr, metric) and continues from the next epoch,
    deterministically with respect to a straight run.
    """
    device = resolve_device(device)
    if isinstance(corpus, (list, tuple)):
        corpus = _MultiCorpus(list(corpus))
    logger = logger or _default_logger(cfg.name, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "models", cfg.name)
    ckpt = _Checkpointer(ckpt_dir)
    results: Dict = {"name": cfg.name}

    _log_startup_config(cfg, logger, do_train, do_val, do_test,
                        store_predictions, store_results_filewise,
                        ckpt_dir, out_dir)
    model = cfg.build_model()
    logger.info("Model: %d parameters, on %s",
                sum(p.numel() for p in model.parameters()), device)
    # the reference's torchinfo summary, at its input (exp180d…py:233)
    logger.info("%s", model_summary(model, (1, 6, 174, 216)))
    tcfg = cfg.train_config
    if max_epochs_override is not None:
        tcfg = dataclasses.replace(tcfg, max_epochs=max_epochs_override)
    trainer = Trainer(model, tcfg, logger=logger, device=device).init()

    test_and_val = list(cfg.test_versions) + list(cfg.val_versions)
    for subset in cfg.extra_test_subsets.values():
        test_and_val += list(subset)

    if do_train:
        train_files, val_files = [], []
        for fn in corpus.files():
            if cfg.train_versions:
                # explicit train list (the Exp3 Schubert splits,
                # exp201b…py:252); else complement of test+val (Exp1/2/4)
                is_train = _matches(fn, cfg.train_versions)
            else:
                is_train = not _matches(
                    fn, test_and_val + cfg.test_versions_small)
            if is_train:
                train_files.append(fn)
                logger.info(" - file %s added to training set.", fn)
            elif do_val and _matches(fn, cfg.val_versions):
                val_files.append(fn)
                logger.info(" - file %s added to validation set.", fn)

        def specs(fns, which):
            out = []
            for fn in fns:
                inputs, targets = corpus.load(fn)
                stride = None
                if isinstance(corpus, _MultiCorpus):
                    ts, vs = corpus.strides(fn)
                    stride = ts if which == "train" else vs
                out.append(FileSpec(inputs, _slice_targets(targets, cfg),
                                    stride=stride))
            return out

        train_p = TrainPipeline(specs(train_files, "train"),
                                context=cfg.context, stride=cfg.train_stride,
                                augment=cfg.augment, target_slice=None,
                                device=device)
        logger.info("Training set & loader generated, length %d",
                    len(train_p))
        val_p = None
        if do_val and val_files:
            val_p = TrainPipeline(specs(val_files, "val"),
                                  context=cfg.context, stride=cfg.val_stride,
                                  target_slice=None,
                                  compression=cfg.augment.compression,
                                  device=device)
            logger.info("Validation set & loader generated, length %d",
                        len(val_p))

        start_epoch = 0
        initial_best = None
        if resume and ckpt.exists():
            last_epoch, lr, metric = ckpt.restore(trainer)
            start_epoch = last_epoch + 1
            if lr:
                trainer.lr = lr
                if trainer.scheduler is not None:
                    # carry the reduced LR (and its best) into the fresh
                    # ReduceLROnPlateau, else the first scheduler.step
                    # snaps back to initial_lr
                    trainer.scheduler.lr = lr
            if not math.isnan(metric):
                initial_best = metric
                if trainer.scheduler is not None:
                    trainer.scheduler.best = metric
            logger.info("Resuming from checkpoint: epoch %d, lr %.6f",
                        start_epoch, trainer.lr)

        logger.info("\n \n ###################### START TRAINING "
                    "###################### \n")
        history = trainer.fit(
            lambda epoch, seed: train_p.batches(seed, tcfg.batch_size),
            (lambda epoch, seed: val_p.batches(seed, cfg.val_batch_size,
                                               shuffle=False,
                                               drop_remainder=False))
            if val_p else None,
            checkpoint_dir=ckpt_dir, start_epoch=start_epoch,
            initial_best=initial_best)
        results["history"] = history
        logger.info(" ### trained model saved in %s \n", ckpt_dir)

    if do_test:
        logger.info("\n \n ###################### START TESTING "
                    "###################### \n")
        if do_train and tcfg.early_stopping and ckpt.exists():
            ckpt.restore(trainer)
        predict = _make_test_predict(cfg, trainer.model, device)

        subsets = [("large test set (10 files)", cfg.test_versions, None),
                   ("small test set (3 files), first 90s",
                    cfg.test_versions_small, 3920),
                   ("small test set (3 files), full",
                    cfg.test_versions_small, None)]
        # RETRAIN4-style extra subsets (alternate MuN-10 variants / TRIOS;
        # RETRAIN4_exp…py:247-253 loops 6 subsets)
        for key, versions in cfg.extra_test_subsets.items():
            if list(versions) != list(cfg.test_versions):
                subsets.append((f"extra subset {key}", versions, None))
        results["subsets"] = []
        # Exp4 big-mix: per-dataset aggregation before the overall one
        # (exp210d_bigmix…py:615-626 keeps ds_* accumulators per corpus)
        if isinstance(corpus, _MultiCorpus) and cfg.test_versions:
            for ci, (member, _, _) in enumerate(corpus.members):
                agg = _test_subset(
                    cfg, member, cfg.test_versions, None, predict,
                    logger, f"test dataset #{ci}", None)
                if agg["n_files"]:
                    results["subsets"].append(agg)
        for subset_idx, (desc, versions, max_frames) in enumerate(subsets):
            if not versions:
                continue
            agg = _test_subset(
                cfg, corpus, versions, max_frames, predict,
                logger, desc,
                os.path.join(out_dir, "predictions", cfg.name)
                if store_predictions and subset_idx == 0 else None)
            results["subsets"].append(agg)
            if subset_idx == 0 and store_results_filewise:
                _write_csv(agg, os.path.join(
                    out_dir, "results_filewise", cfg.name + ".csv"))
    return results


def _log_startup_config(cfg, logger, do_train, do_val, do_test,
                        store_predictions, store_results_filewise,
                        ckpt_dir, out_dir):
    """The reference's startup config echo (exp180d…py:186-233): every
    parameter block logged before anything runs."""
    tcfg = cfg.train_config
    logger.info("Logging experiment %s", cfg.name)
    logger.info("Experiment config: do training = %s", do_train)
    logger.info("Experiment config: do validation = %s", do_val)
    logger.info("Experiment config: do testing = %s", do_test)
    aug = {f"aug:{k}": v for k, v in dataclasses.asdict(cfg.augment).items()}
    logger.info("Training set parameters: %s",
                {"context": cfg.context, "stride": cfg.train_stride,
                 "compression": cfg.augment.compression, **aug})
    logger.info("Validation set parameters: %s",
                {"context": cfg.context, "stride": cfg.val_stride,
                 "compression": cfg.augment.compression})
    logger.info("Test set parameters: %s",
                {"context": cfg.context, "stride": cfg.test_stride,
                 "compression": cfg.augment.compression})
    if do_train:
        logger.info("Training parameters: %s",
                    {"batch_size": tcfg.batch_size, "shuffle": True})
        logger.info("Trained model saved in %s", ckpt_dir)
        logger.info(" --- Training config: ------------------------------"
                    "----------- ")
        logger.info("Maximum number of epochs: %s", tcfg.max_epochs)
        logger.info("Criterion (Loss): %s", tcfg.loss)
        logger.info("Optimizer parameters: %s",
                    {"name": "AdamW", "initial_lr": tcfg.initial_lr,
                     "betas": list(tcfg.betas), "eps": tcfg.eps,
                     "weight_decay": tcfg.weight_decay})
        logger.info("Scheduler parameters: %s",
                    {"name": tcfg.scheduler, **tcfg.scheduler_params})
        logger.info("Early stopping parameters: %s",
                    {"use_early_stopping": tcfg.early_stopping,
                     "mode": tcfg.es_mode, "min_delta": tcfg.es_min_delta,
                     "patience": tcfg.es_patience,
                     "percentage": tcfg.es_percentage})
    if do_test:
        logger.info("Test parameters: %s",
                    {"batch_size": cfg.test_batch_size, "shuffle": False})
        logger.info("Save filewise results = %s, in folder %s",
                    store_results_filewise,
                    os.path.join(out_dir, "results_filewise"))
        logger.info("Save model predictions = %s, in folder %s",
                    store_predictions, os.path.join(out_dir, "predictions"))
    logger.info(" --- Model config: ---------------------------------------"
                "----- ")
    logger.info("Model: %s", cfg.model_class)
    logger.info("Model parameters: %s", cfg.model_kwargs)


def _make_test_predict(cfg, model, device):
    """The test phase's whole-recording prediction: the windowed protocol
    (``predict_framewise``) in batches of ``test_batch_size``. A model
    with cross-batch attention is rebuilt with
    ``cross_batch:<test_batch_size>`` and the trained weights, so that
    each attention group is one reference test batch
    (exp180d…py:417-426)."""
    modes = {m.mode for m in model.modules()
             if isinstance(m, TorchMultiheadAttention)}
    group = None
    if modes == {"cross_batch"}:
        group = cfg.test_batch_size
        grouped = cfg.build_model(attn_mode=f"cross_batch:{group}")
        grouped.load_state_dict(model.state_dict())
        model = grouped.to(device)
    model.eval()

    def predict(inputs):
        x = torch.as_tensor(inputs, dtype=torch.float32, device=device)
        return predict_framewise(model, x, context=cfg.context,
                                 batch_size=cfg.test_batch_size,
                                 compression=cfg.augment.compression,
                                 group=group).cpu().numpy()

    return predict


def _test_subset(cfg, corpus, versions, max_frames, predict,
                 logger, desc, predictions_dir):
    eval_measures = cfg.eval_measures
    n_files = 0
    total = np.zeros(len(eval_measures))
    total_mireval = np.zeros(len(MIREVAL_KEYS))
    n_kframes = 0.0
    framewise = np.zeros(len(eval_measures))
    framewise_mireval = np.zeros(len(MIREVAL_KEYS))
    per_file = []

    for fn in corpus.files():
        if not _matches(fn, versions):
            continue
        inputs, targets = corpus.load(fn)
        targets = _slice_targets(targets, cfg)
        if max_frames is not None:
            inputs = inputs[:, :max_frames, :]
            targets = targets[:max_frames, :]
        pred = predict(inputs)
        if pred.shape != targets.shape:
            raise ValueError(f"{fn}: predictions {pred.shape} against "
                             f"targets {targets.shape}")
        if predictions_dir:
            os.makedirs(predictions_dir, exist_ok=True)
            np.save(os.path.join(predictions_dir, fn[:-4] + ".npy"), pred)

        eval_dict = calculate_eval_measures(
            targets, pred, measures=eval_measures, threshold=cfg.eval_thresh)
        eval_numbers = np.fromiter(eval_dict.values(), dtype=float)
        mpe = calculate_mpe_measures_mireval(
            targets, pred, threshold=cfg.eval_thresh, min_pitch=cfg.min_pitch)
        mireval_numbers = np.array([mpe[k] for k in MIREVAL_KEYS])

        n_files += 1
        total += eval_numbers
        total_mireval += mireval_numbers
        kframes = targets.shape[0] / 1000
        n_kframes += kframes
        framewise += kframes * eval_numbers
        framewise_mireval += kframes * mireval_numbers
        per_file.append((fn, eval_dict, mpe))
        logger.info("file %s tested. Cosine sim: %s", fn,
                    eval_dict.get("cosine_sim"))

    logger.info("### Testing done. ########################################"
                "######## \n")
    logger.info("#   Results for %s ######################### \n", desc)
    mean_meas = total / max(n_files, 1)
    mean_mireval = total_mireval / max(n_files, 1)
    for k, name in enumerate(eval_measures):
        logger.info("Mean %s:   %s", name, mean_meas[k])
    for k, name in enumerate(MIREVAL_KEYS):
        logger.info("Mean %s:   %s", name, mean_mireval[k])
    logger.info("\n")
    fw_means = framewise / max(n_kframes, 1e-12)
    fw_mireval = framewise_mireval / max(n_kframes, 1e-12)
    for k, name in enumerate(eval_measures):
        logger.info("Framewise %s:   %s", name, fw_means[k])
    for k, name in enumerate(MIREVAL_KEYS):
        logger.info("Framewise %s:   %s", name, fw_mireval[k])

    filewise_mean = dict(zip(eval_measures, mean_meas.tolist()))
    filewise_mean.update(zip(MIREVAL_KEYS, mean_mireval.tolist()))
    framewise_mean = dict(zip(eval_measures, fw_means.tolist()))
    framewise_mean.update(zip(MIREVAL_KEYS, fw_mireval.tolist()))
    return {
        "description": desc,
        "n_files": n_files,
        "per_file": per_file,
        "filewise_mean": filewise_mean,
        "framewise_mean": framewise_mean,
    }


def _csv_cell(value):
    """pandas' ``to_csv`` rendering: missing and NaN empty, numbers by
    ``str`` (the shortest repr)."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return str(value)


def _write_csv(agg, path):
    """The per-file rows and the two means, as the JAX package's
    ``pandas.DataFrame(rows).to_csv(path)`` writes them: an unnamed
    index column, the union of the rows' keys in first-seen order."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rows = [{"Filename": fn, **eval_dict, **mpe}
            for fn, eval_dict, mpe in agg["per_file"]]
    rows.append({"Filename": "FILEWISE MEAN", **agg["filewise_mean"]})
    rows.append({"Filename": "FRAMEWISE MEAN", **agg["framewise_mean"]})
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + columns)
        for i, row in enumerate(rows):
            writer.writerow([i] + [_csv_cell(row.get(c)) for c in columns])


def _default_logger(name, out_dir):
    os.makedirs(os.path.join(out_dir, "logs"), exist_ok=True)
    logger = logging.getLogger(f"experiment.{name}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(
            os.path.join(out_dir, "logs", name + ".txt"))
        fh.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)s : %(message)s"))
        logger.addHandler(fh)
        logger.addHandler(logging.StreamHandler())
    return logger
