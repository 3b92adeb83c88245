"""The model's FLOPs of the windows served over the window's wall time,
as a share of the dense TF32 peak."""

from portbench import reduce


def read(run):
    flops = reduce.serve_flops_per_window(run) * reduce.windows(run)
    return reduce.mfu_percent(flops, run.window_end)
