"""Device ms per window between the model's forward pre- and post-hooks
(CUDA events), over the windows served."""

from portbench import reduce


def read(run):
    n = reduce.windows(run)
    if not run.model_ms or not n:
        return None
    return sum(run.model_ms) / n
