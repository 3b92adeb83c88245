"""Early stopping, with the reference's semantics
(libdl/metrics/monitoring.py:4-63).

Counterpart of ``multipitch_architectures_tpu/train/monitoring.py``
(numpy only; the port keeps its own copy):

- min/max mode, absolute or percentage min_delta;
- NaN metric -> immediate stop (monitoring.py:32-33);
- patience == 0 -> never stops, every epoch "is better"
  (monitoring.py:23-25);
- ``curr_is_better`` gates the save-on-best checkpoint
  (exp180d…py:372-378).
"""

import numpy as np


class EarlyStopping:
    def __init__(self, mode="min", min_delta=0.0, patience=10,
                 percentage=False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode} is unknown!")
        self.mode = mode
        self.min_delta = min_delta
        self.patience = patience
        self.percentage = percentage
        self.best = None
        self.num_bad_epochs = 0

    def is_better(self, a, best):
        if self.patience == 0:
            return True
        delta = (best * self.min_delta / 100) if self.percentage \
            else self.min_delta
        if self.mode == "min":
            return a < best - delta
        return a > best + delta

    def step(self, metric) -> bool:
        """Returns True when training should stop."""
        if self.patience == 0:
            return False
        if self.best is None:
            self.best = metric
            return False
        if np.isnan(metric):
            return True
        if self.is_better(metric, self.best):
            self.num_bad_epochs = 0
            self.best = metric
        else:
            self.num_bad_epochs += 1
        return self.num_bad_epochs >= self.patience

    def curr_is_better(self, metric) -> bool:
        return self.is_better(metric, self.best)


# reference-compatible alias (libdl.metrics.early_stopping)
early_stopping = EarlyStopping
