"""Utilities: profiling and tracing, model summaries, plotting."""

from .plot import plot_matrix
from .profiling import StepTimer, device_sync, trace
from .summary import count_macs, model_summary

__all__ = ["StepTimer", "device_sync", "trace", "count_macs",
           "model_summary", "plot_matrix"]
