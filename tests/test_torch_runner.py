"""The port's experiment layer against the JAX package, on the CPU: the
registry reading, the split loader, the synthetic corpus, the test
phase's aggregates and CSV, a whole ``run_experiment`` and its CLI.

The test phase is fed the same numpy predictions on both sides, so its
aggregates must agree to float64 rounding (rtol 1e-12; the two
packages' measures are separate numpy code) and the CSV text must be
pandas' to the byte.
"""

import csv
import dataclasses
import json
import logging
import math
import os

import numpy as np
import pytest
import torch

from multipitch_architectures_tpu.experiments import configs as jconfigs
from multipitch_architectures_tpu.experiments import runner as jrunner
from multipitch_architectures_tpu.experiments import splits as jsplits
from multipitch_architectures_tpu_torch.experiments import (
    BIGMIX_STRIDES, SyntheticCorpus, apply_split_to_config,
    available_experiments, load_experiment, run_experiment,
    shrink_for_smoke, split_datasets, split_filenames)
from multipitch_architectures_tpu_torch.experiments import configs, runner
from multipitch_architectures_tpu_torch.experiments import run as cli

EXP180D = "exp180d_musicnet_unet_extremelylarge_doubleselfattn"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _comparable(cfg):
    d = dataclasses.asdict(cfg)
    d["train_config"]["betas"] = tuple(d["train_config"]["betas"])
    return d


@pytest.mark.parametrize("fix", [False, True])
def test_every_registry_entry_loads_as_in_jax(fix):
    names = available_experiments()
    assert names == jconfigs.available_experiments() and len(names) == 111
    for name in names:
        assert _comparable(load_experiment(name, fix_val_split=fix)) == \
            _comparable(jconfigs.load_experiment(name, fix_val_split=fix)), \
            name
    assert BIGMIX_STRIDES == jconfigs.BIGMIX_STRIDES
    assert configs._fix_merged_prefixes(["1828_1829_", "1733_", "x"]) == \
        ["1828_", "1829_", "1733_", "x"]


def test_exp180d_recipe():
    cfg = load_experiment(EXP180D)
    tc, aug = cfg.train_config, cfg.augment
    assert (tc.batch_size, tc.initial_lr, tc.betas, tc.eps, tc.weight_decay) \
        == (25, 1e-3, (0.9, 0.999), 1e-8, 0.01)
    assert tc.scheduler == "ReduceLROnPlateau" and tc.val_in_train_mode
    assert tc.scheduler_params["factor"] == 0.5 and \
        tc.scheduler_params["patience"] == 5
    assert (aug.noisestd, aug.randomeq, aug.transposition, aug.tuning,
            aug.compression) == (1e-4, 20, 5, True, 10)
    assert (cfg.train_stride, cfg.val_stride, cfg.val_batch_size) == \
        (50, 50, 50)
    model = cfg.build_model()
    assert sum(p.numel() for p in model.parameters()) == 8_115_003
    small = shrink_for_smoke(cfg)
    assert _comparable(small) == _comparable(jconfigs.shrink_for_smoke(
        jconfigs.load_experiment(EXP180D)))


def test_split_loader_matches_jax(tmp_path):
    path = str(tmp_path / "split.json")
    with open(path, "w") as f:
        json.dump({"train": [{"filename": "a.npy", "dataset": "MusicNet"},
                             {"filename": "b.npy", "dataset": "SWD"}],
                   "val": [{"filename": "c.npy", "dataset": "SWD"}],
                   "test": [{"filename": "d.npy"}]}, f)
    for part in ("train", "val", "test"):
        for ds in (None, "SWD"):
            assert split_filenames(path, part, ds) == \
                jsplits.split_filenames(path, part, ds)
    assert split_datasets(path) == jsplits.split_datasets(path)
    cfg = apply_split_to_config(load_experiment(EXP180D), path)
    assert (cfg.train_versions, cfg.val_versions, cfg.test_versions) == \
        (["a.npy", "b.npy"], ["c.npy"], ["d.npy"])


def test_synthetic_corpus_is_the_jax_corpus():
    ours = SyntheticCorpus(load_experiment(EXP180D), frames=120, seed=3)
    theirs = jrunner.SyntheticCorpus(jconfigs.load_experiment(EXP180D),
                                     frames=120, seed=3)
    assert ours.files() == theirs.files()
    for fn in ours.files():
        for a, b in zip(ours.load(fn), theirs.load(fn)):
            np.testing.assert_array_equal(a, b)
    corpus = runner._MultiCorpus([(ours, 35, 35)])
    assert corpus.strides(ours.files()[0]) == (35, 35)


def _fake_predict(inputs):
    """Deterministic predictions in [0, 1] from the inputs alone."""
    return np.clip(inputs[1, :, :72] * 1.2 - 0.1, 0.0, 1.0).astype(
        np.float32)


def test_test_subset_aggregates_and_csv_match_jax(tmp_path):
    cfg = load_experiment(EXP180D)
    jcfg = jconfigs.load_experiment(EXP180D)
    corpus = SyntheticCorpus(cfg, frames=150)
    log = logging.getLogger("test")
    versions = cfg.test_versions
    ours = runner._test_subset(cfg, corpus, versions, 100, _fake_predict,
                               log, "subset", str(tmp_path / "ours"))
    theirs = jrunner._test_subset(jcfg, corpus, versions, 100,
                                  _fake_predict, log, "subset",
                                  str(tmp_path / "theirs"))
    assert ours["n_files"] == theirs["n_files"] == 2
    for key in ("filewise_mean", "framewise_mean"):
        assert list(ours[key]) == list(theirs[key])
        assert len(ours[key]) == 11 + 14
        np.testing.assert_allclose(list(ours[key].values()),
                                   list(theirs[key].values()), rtol=1e-12)
    for (fa, ea, ma), (fb, eb, mb) in zip(ours["per_file"],
                                          theirs["per_file"]):
        assert fa == fb and list(ea) == list(eb) and list(ma) == list(mb)
        np.testing.assert_allclose(list(ea.values()), list(eb.values()),
                                   rtol=1e-12)
    for fn in os.listdir(tmp_path / "theirs"):
        np.testing.assert_array_equal(np.load(tmp_path / "ours" / fn),
                                      np.load(tmp_path / "theirs" / fn))
    # the same rows through both writers: pandas' text, byte for byte
    runner._write_csv(theirs, str(tmp_path / "ours.csv"))
    jrunner._write_csv(theirs, str(tmp_path / "theirs.csv"))
    assert (tmp_path / "ours.csv").read_bytes() == \
        (tmp_path / "theirs.csv").read_bytes()
    # missing cells and NaN render empty, as pandas does
    theirs["per_file"][0][1]["precision"] = float("nan")
    del theirs["per_file"][1][2]["Recall"]
    runner._write_csv(theirs, str(tmp_path / "ours2.csv"))
    jrunner._write_csv(theirs, str(tmp_path / "theirs2.csv"))
    assert (tmp_path / "ours2.csv").read_bytes() == \
        (tmp_path / "theirs2.csv").read_bytes()


def _smoke_config():
    """exp180d shrunk as ``--smoke`` does, and further (scalefac 32,
    layers (4, 4, 2, 2), batch 4), with one test file and no small-set
    subsets, so the run stays a few seconds: 2 train files of 200 frames
    (4 windows, one batch), 1 val, 1 test."""
    cfg = shrink_for_smoke(load_experiment(EXP180D))
    kw = {**cfg.model_kwargs, "scalefac": 32, "embed_dim": 16,
          "n_chan_layers": [4, 4, 2, 2]}
    return dataclasses.replace(
        cfg, model_kwargs=kw, test_versions=cfg.test_versions[:1],
        test_versions_small=[],
        train_config=dataclasses.replace(cfg.train_config, batch_size=4))


def test_run_experiment_trains_tests_writes_and_resumes(tmp_path, caplog):
    cfg = _smoke_config()
    corpus = SyntheticCorpus(cfg, frames=200)
    out = str(tmp_path / "run")
    log = logging.getLogger("test.run")
    with caplog.at_level(logging.INFO, logger="test.run"):
        res = run_experiment(cfg, corpus, out, logger=log,
                             max_epochs_override=1, device="cpu")
    assert len(res["history"]["train_loss"]) == 1
    assert np.isfinite(res["history"]["val_loss"][0])
    assert [s["n_files"] for s in res["subsets"]] == [1]
    for agg in res["subsets"]:
        assert all(math.isfinite(v) for v in agg["framewise_mean"].values())
    name = cfg.name
    pred = np.load(os.path.join(out, "predictions", name,
                                "2303_testsynth.npy"))
    assert pred.shape == (200, 72) and 0 <= pred.min() <= pred.max() <= 1
    with open(os.path.join(out, "results_filewise", name + ".csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0][:3] == ["", "Filename", "precision"] and len(rows) == 4
    assert [r[1] for r in rows[1:]] == ["2303_testsynth.npy",
                                        "FILEWISE MEAN", "FRAMEWISE MEAN"]
    assert "START TRAINING" in caplog.text
    assert "Training set & loader generated, length 4" in caplog.text
    assert " - file 1729_valsynth.npy added to validation set." in caplog.text
    # resume: the checkpoint's epoch 0 -> epoch 1 only
    with caplog.at_level(logging.INFO, logger="test.run"):
        res = run_experiment(cfg, corpus, out, logger=log, do_test=False,
                             max_epochs_override=2, resume=True,
                             device="cpu")
    assert "Resuming from checkpoint: epoch 1" in caplog.text
    assert len(res["history"]["train_loss"]) == 1


def test_cli_lists_and_wires_a_smoke_run(monkeypatch, capsys, tmp_path):
    assert cli.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == available_experiments()
    seen = {}

    def fake_run(cfg, corpus, out_dir, **kw):
        seen.update(cfg=cfg, corpus=corpus, out_dir=out_dir, **kw)
        return {"subsets": [{"framewise_mean": {"f_measure": 0.5}}]}

    import multipitch_architectures_tpu_torch.experiments as exp

    monkeypatch.setattr(exp, "run_experiment", fake_run)
    assert cli.main(["--config", EXP180D, "--smoke", "--cpu", "--out-dir",
                     str(tmp_path), "--fix-val-split"]) == 0
    assert "Framewise f_measure: 0.5" in capsys.readouterr().out
    assert seen["device"] == "cpu" and seen["max_epochs_override"] == 1
    assert seen["cfg"].model_kwargs["n_chan_layers"] == [8, 8, 4, 2]
    assert "1828_" in seen["cfg"].val_versions
    assert isinstance(seen["corpus"], SyntheticCorpus) and \
        seen["corpus"].frames == 300
    cli.main(["--config", EXP180D, "--epochs", "3", "--resume",
              "--data-dir", "d", "--annot-dir", "a"])
    assert seen["device"] is None and seen["max_epochs_override"] == 3
    assert seen["resume"] and isinstance(seen["corpus"], runner.NpyCorpus)
    with pytest.raises(SystemExit):
        cli.main(["--config", EXP180D])       # no data and no --smoke
