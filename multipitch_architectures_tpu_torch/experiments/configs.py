"""Experiment configurations.

Counterpart of ``multipitch_architectures_tpu/experiments/configs.py``.
The registry is data: the JAX package's ``experiments/registry.json``
(the configuration values of the reference's 111 experiment scripts:
model class and arguments, dataset and loader settings,
optimizer/scheduler/early-stopping settings, evaluation measures and
threshold, split prefix lists, batch caps) is read by file path, without
importing that package. ``load_experiment`` turns an entry into the model's
class and arguments, an ``AugmentConfig``, a ``TrainConfig`` and split
lists.

Notes on faithfulness (as in the JAX package):

- the Exp1/Exp2 ``val_versions`` lists contain the reference's
  missing-comma artifacts (e.g. '1828_1829_', exp180d…py:242-245), so
  several intended validation files land in the train set exactly as
  upstream; ``fix_val_split=True`` repairs them;
- the Exp4 big-mix per-corpus strides are hard-coded blocks upstream
  (exp210d_bigmix…py:310,359,405,437); they are tabulated here.
"""

import dataclasses
import inspect
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List

from ..data.augment import AugmentConfig
from .. import models as M
from ..train.trainer import TrainConfig

REGISTRY_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "multipitch_architectures_tpu", "experiments", "registry.json")

# reference class name -> this package's module: every class of the zoo
MODEL_REGISTRY = {
    "basic_cnn": M.BasicCnn,
    "basic_cnn_pool": M.BasicCnnPool,
    "basic_cnn_segm_sigmoid": M.BasicCnnSegmSigmoid,
    "basic_cnn_segm_logsoftmax": M.BasicCnnSegmLogSoftmax,
    "basic_cnn_segm_blank_logsoftmax": M.BasicCnnSegmBlankLogSoftmax,
    "deep_cnn_segm_sigmoid": M.DeepCnnSegmSigmoid,
    "simple_u_net": M.SimpleUNet,
    "simple_u_net_largekernels": M.SimpleUNetLargeKernels,
    "simple_u_net_selfattn": M.SimpleUNetSelfAttn,
    "simple_u_net_doubleselfattn": M.SimpleUNetDoubleSelfAttn,
    "simple_u_net_sixselfattn": M.SimpleUNetSixSelfAttn,
    "simple_u_net_doubleselfattn_twolayers":
        M.SimpleUNetDoubleSelfAttnTwoLayers,
    "simple_u_net_doubleselfattn_alllayers":
        M.SimpleUNetDoubleSelfAttnAllLayers,
    "simple_u_net_doubleselfattn_varlayers":
        M.SimpleUNetDoubleSelfAttnVarLayers,
    "u_net_blstm_varlayers": M.UNetBlstmVarLayers,
    "u_net_temporal_selfattn_varlayers": M.UNetTemporalSelfAttnVarLayers,
    "u_net_temporal_blstm_varlayers": M.UNetTemporalBlstmVarLayers,
    "simple_u_net_doubleselfattn_transenc": M.SimpleUNetDoubleSelfAttnTransEnc,
    "freq_u_net": M.FreqUNet,
    "freq_u_net_bottomstack": M.FreqUNetBottomStack,
    "freq_u_net_selfattn": M.FreqUNetSelfAttn,
    "freq_u_net_doubleselfattn": M.FreqUNetDoubleSelfAttn,
    "simple_u_net_doubleselfattn_polyphony":
        M.SimpleUNetDoubleSelfAttnPolyphony,
    "simple_u_net_doubleselfattn_polyphony_classif":
        M.SimpleUNetDoubleSelfAttnPolyphonyClassif,
    "simple_u_net_polyphony_classif": M.SimpleUNetPolyphonyClassif,
    "simple_u_net_polyphony_classif_softmax":
        M.SimpleUNetPolyphonyClassifSoftmax,
}

# Exp4 big-mix per-corpus train/val strides
# (exp210d_bigmix…py:39,47 then :310-311, :359-360, :405, :437-438)
BIGMIX_STRIDES = {
    "MusicNet": (35, 35),
    "SWD": (6, 4),
    "Bach10": (1, 1),
    "PHENICX-Anechoic": (2, 2),
    "ChoralSingingDataset": (4, 4),
}


def build_model(model_class: str, model_kwargs: dict, **overrides):
    """Build ``model_class`` from registry ``model_kwargs`` (keys the
    class does not take, such as ``n_ch_out``, are dropped; lists become
    tuples) and ``overrides`` (e.g. ``attn_mode='cross_batch:50'``)."""
    if model_class not in MODEL_REGISTRY:
        raise KeyError(f"unknown model class {model_class!r}; "
                       f"known: {sorted(MODEL_REGISTRY)}")
    cls = MODEL_REGISTRY[model_class]
    accepted = inspect.signature(cls).parameters
    kwargs = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in model_kwargs.items() if k in accepted}
    return cls(**{**kwargs, **overrides})


def load_checkpoint(model, path: str):
    """Load the weights at ``path`` into ``model`` with ``strict=True``
    and return it: a reference ``state_dict`` ``.pt`` (the port's modules
    carry the reference's key names) or the port trainer's checkpoint
    (its ``"model"`` entry)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd.get("model", sd), strict=True)
    return model


@dataclass
class ExperimentConfig:
    name: str
    family: str
    model_class: str
    model_kwargs: dict
    train_config: TrainConfig
    augment: AugmentConfig
    # window geometry
    context: int = 75
    train_stride: int = 50
    val_stride: int = 50
    test_stride: int = 1
    val_batch_size: int = 50
    test_batch_size: int = 50
    # target geometry
    num_output_bins: int = 72
    min_pitch: int = 24
    # splits (filename prefix matching, exp180d…py:238-247)
    val_versions: List[str] = field(default_factory=list)
    test_versions: List[str] = field(default_factory=list)
    test_versions_small: List[str] = field(default_factory=list)
    train_versions: List[str] = field(default_factory=list)
    extra_test_subsets: Dict[str, List[str]] = field(default_factory=dict)
    # eval
    eval_measures: List[str] = field(default_factory=list)
    eval_thresh: float = 0.4
    raw: dict = field(default_factory=dict, repr=False)

    def build_model(self, **overrides):
        return build_model(self.model_class, self.model_kwargs, **overrides)


def available_experiments() -> List[str]:
    with open(REGISTRY_PATH) as f:
        return sorted(json.load(f))


def _fix_merged_prefixes(versions: List[str]) -> List[str]:
    """Split concatenated prefixes like '1828_1829_' (the upstream
    missing-comma bug) back into their parts."""
    out = []
    for v in versions:
        parts = re.findall(r"[0-9A-Za-z]+_", v)
        out.extend(parts if parts and "".join(parts) == v else [v])
    return out


def load_experiment(name: str, fix_val_split: bool = False,
                    registry_path: str = REGISTRY_PATH) -> ExperimentConfig:
    with open(registry_path) as f:
        raw = json.load(f)[name]

    tdp = raw.get("train_dataset_params", {})
    augment = AugmentConfig(
        transposition=tdp.get("aug:transpsemitones"),
        scalingfactor=tdp.get("aug:scalingfactor"),
        randomeq=tdp.get("aug:randomeq"),
        noisestd=tdp.get("aug:noisestd"),
        tuning=bool(tdp.get("aug:tuning", False)),
        compression=tdp.get("compression", 10),
    )

    op = raw.get("optimizer_params", {})
    sp = raw.get("scheduler_params", {})
    ep = raw.get("early_stopping_params", {})
    sched_name = sp.get("name") if sp.get("use_scheduler", True) else None
    sched_params = {}
    if sched_name == "ReduceLROnPlateau":
        sched_params = {k: sp[k] for k in
                        ("factor", "patience", "threshold", "cooldown",
                         "min_lr", "eps") if k in sp}
    elif sched_name == "LambdaLR":
        sched_params = {k: sp[k] for k in
                        ("start_lr", "end_lr", "n_decay", "exp_decay")
                        if k in sp}

    train_config = TrainConfig(
        max_epochs=raw.get("max_epochs", 100),
        batch_size=raw.get("train_params", {}).get("batch_size", 25),
        initial_lr=op.get("initial_lr", 1e-3),
        betas=tuple(op.get("betas", (0.9, 0.999))),
        eps=op.get("eps", 1e-8),
        weight_decay=op.get("weight_decay", 0.01),
        scheduler=sched_name,
        scheduler_params=sched_params,
        early_stopping=ep.get("use_early_stopping", True),
        es_mode=ep.get("mode", "min"),
        es_min_delta=ep.get("min_delta", 1e-5),
        es_patience=ep.get("patience", 12),
        es_percentage=ep.get("percentage", False),
        loss=raw.get("loss", "bce"),
        max_train_batches=raw.get("max_train_batches"),
        # the reference never calls model.eval() for validation, so its
        # val losses (which drive checkpoint gating + LR plateau) see
        # dropout and batch-mode BN (exp180d…py:340-352); replicate that
        # for registry experiments (Trainer default is the sane False)
        val_in_train_mode=True,
    )

    val_versions = list(raw.get("val_versions", []))
    if fix_val_split:
        val_versions = _fix_merged_prefixes(val_versions)

    extra = {key: raw[key] for key in
             ("test_versions1", "test_versions2", "test_versions3",
              "test_versions4", "test_pieces") if key in raw}

    return ExperimentConfig(
        name=name,
        family=raw.get("family", ""),
        model_class=raw["model_class"],
        model_kwargs=raw.get("model_params", {}),
        train_config=train_config,
        augment=augment,
        context=tdp.get("context", 75),
        train_stride=tdp.get("stride", 50),
        val_stride=raw.get("val_dataset_params", {}).get("stride", 50),
        test_stride=raw.get("test_dataset_params", {}).get("stride", 1),
        val_batch_size=raw.get("val_params", {}).get("batch_size", 50),
        test_batch_size=raw.get("test_params", {}).get("batch_size", 50),
        num_output_bins=raw.get("num_output_bins", 72),
        min_pitch=raw.get("min_pitch", 24),
        val_versions=val_versions,
        test_versions=raw.get("test_versions",
                              raw.get("test_versions1", [])),
        test_versions_small=raw.get("test_versions_small", []),
        train_versions=raw.get("train_versions", []),
        extra_test_subsets=extra,
        eval_measures=raw.get("eval_measures", []),
        eval_thresh=raw.get("eval_thresh", 0.4),
        raw=raw,
    )


def shrink_for_smoke(cfg: ExperimentConfig) -> ExperimentConfig:
    """Scale a config down for fast synthetic smoke runs while keeping
    the class and code path (the JAX package's geometry:
    ``experiments/run.py --smoke`` and the end-to-end tests). The BLSTM's
    widths follow the scalefac-16 bottleneck (32 channels x 13 bins)."""
    kw = dict(cfg.model_kwargs)
    kw["n_chan_layers"] = [8, 8, 4, 2]
    if "scalefac" in kw:
        kw["scalefac"] = 16
    if "embed_dim" in kw:
        if cfg.model_class == "u_net_blstm_varlayers":
            kw["embed_dim"], kw["hidden_size"] = 416, 208
        else:
            kw["embed_dim"] = 32
    if "mlp_dim" in kw:
        kw["mlp_dim"] = 64
    if "n_prefilt_layers" in kw:
        kw["n_prefilt_layers"] = min(kw["n_prefilt_layers"], 2)
    tc = dataclasses.replace(cfg.train_config, batch_size=8)
    return dataclasses.replace(cfg, model_kwargs=kw, train_config=tc)
