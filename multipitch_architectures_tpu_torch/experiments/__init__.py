"""Experiment layer: the config registry distilled from the reference's
111 scripts, and one configurable runner."""

from .configs import (BIGMIX_STRIDES, MODEL_REGISTRY, ExperimentConfig,
                      available_experiments, build_model, load_experiment,
                      shrink_for_smoke)
from .runner import AudioCorpus, NpyCorpus, SyntheticCorpus, run_experiment
from .splits import (apply_split_to_config, load_split, split_datasets,
                     split_filenames)
