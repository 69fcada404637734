"""Host ms a training step spends from the global norm through Adam's
step (the program's ``train.optimizer`` span), over the traced window's
steps.

Read in the traced window alone, so it includes the tracer's cost (CUPTI
on every launch, the profiler's record of every operator): it reads
higher than the untraced program spends, and tells stages apart, not
what a change saves end to end."""

from benchmark.metrics._program import TRAINING, host_ms


def read(run):
    return host_ms(run, TRAINING, "train.optimizer")
