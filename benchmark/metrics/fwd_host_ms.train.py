"""Host ms a training step spends in its forward (the program's
``train.forward`` span: draws, conditions, denoiser, loss) without the
encode inside it, over the traced window's steps.

Read in the traced window alone, so it includes the tracer's cost (CUPTI
on every launch, the profiler's record of every operator): it reads
higher than the untraced program spends, and tells stages apart, not
what a change saves end to end."""

from benchmark.metrics._program import TRAINING, host_ms


def read(run):
    return host_ms(run, TRAINING, "train.forward", without="train.encode")
