"""The benchmark of the PyTorch and CUDA port
(``multipitch_architectures_tpu_torch``) on NVIDIA H100 cards.

One command runs one cell of ``BENCHMARK.json`` once::

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints one JSON line: whether the timed path's outputs agree with the
plain reference under ``portbench/reference/``, and the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``).
Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``portbench/configs/<config>.json``: widths, precision, frontend,
  serving or training recipe, and the limits of the output check;
- ``portbench/traffic/<mix>.json``: the loop, the laws of lengths and
  arrivals, the sample that the output check compares;
- ``portbench/metrics/<metric>.py``: a ``read(run)`` that returns the
  metric, or None where the run has nothing to read; a metric with no
  file of its own reads with its family's, the name cut at its last dot
  (``k1_roofline.int8`` with ``k1_roofline.py``);
- ``portbench/counts/``: operations and bytes, from the configuration's
  shapes.
"""
