"""FLOPs of the window's training steps (forward and backward, counted
on the reference's shapes) over its wall time, as a share of the dense
TF32 peak."""

from portbench import common, reduce


def read(run):
    if not run.steps:
        return None
    t = run.cfg["train"]
    flops = common.counts(run.cfg, run.root).train_step_flops(
        run.cfg["model"]["args"], t["batch_size"], t["context"])
    return reduce.mfu_percent(flops * run.steps, run.window_end)
