"""Device-idle ms a training step whose innermost program span is the
global norm and Adam (``train.optimizer``).

Read in the traced window alone, so the gaps include the tracer's cost
on the host: they name where the card waits under the tracer, not what
a change saves end to end."""

from benchmark.metrics._program import TRAINING, idle_ms


def read(run):
    return idle_ms(run, TRAINING, "train.optimizer")
