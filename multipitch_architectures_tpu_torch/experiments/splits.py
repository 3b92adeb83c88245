"""Dataset-split JSON loader.

Counterpart of ``multipitch_architectures_tpu/experiments/splits.py``
(json only; the port keeps its own copy). The reference ships split
definitions as JSON under ``dataset_splits/`` (test_MuN-10*.json,
big_mixed_dataset.json): lists of ``{"filename": ..., ["dataset": ...]}``
entries per partition (train/val/test). This loader turns them into the
filename (and per-dataset) lists the runner consumes, an alternative to
the in-script prefix lists of the registry.
"""

import dataclasses
import json
from typing import Dict, List, Optional


def load_split(path: str) -> Dict[str, List[dict]]:
    with open(path) as f:
        return json.load(f)


def split_filenames(path: str, partition: str,
                    dataset: Optional[str] = None) -> List[str]:
    """Filenames of one partition, optionally filtered to one dataset
    (big_mixed_dataset.json entries carry a 'dataset' key)."""
    entries = load_split(path).get(partition, [])
    return [e["filename"] for e in entries
            if dataset is None or e.get("dataset") == dataset]


def split_datasets(path: str) -> List[str]:
    """Distinct dataset names appearing in a (big-mix) split file."""
    seen = []
    for part in load_split(path).values():
        for e in part:
            name = e.get("dataset")
            if name and name not in seen:
                seen.append(name)
    return seen


def apply_split_to_config(cfg, path: str):
    """Return a copy of ``cfg`` whose train/val/test version lists are the
    split file's exact filenames (prefix matching degenerates to exact
    containment for full names)."""
    return dataclasses.replace(
        cfg,
        train_versions=split_filenames(path, "train"),
        val_versions=split_filenames(path, "val"),
        test_versions=split_filenames(path, "test"),
    )
