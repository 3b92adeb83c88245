"""Utilities: the recorder (spans, counters, tracing), model summaries,
plotting."""

from .plot import plot_matrix
from .profiling import counters, device_sync, recording, span, trace
from .summary import count_macs, model_summary

__all__ = ["counters", "device_sync", "recording", "span", "trace",
           "count_macs", "model_summary", "plot_matrix"]
