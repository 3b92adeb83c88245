"""The least time of the model's work on the windows served, at the
configuration's precision (float32 FLOPs at the dense TF32 peak; in
int8, the calibration passes and the float32 rest so, and the int8
operations at the int8 peak), over the window's wall time, in %."""

from portbench import reduce


def read(run):
    return reduce.mfu_percent(reduce.serve_flops(run), run.window_end)
