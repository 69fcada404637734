"""Device-idle ms a training step whose innermost program span is the
frozen codec encode (``train.encode``): the card waiting on the encode's
host work.

Read in the traced window alone, so the gaps include the tracer's cost
on the host: they name where the card waits under the tracer, not what
a change saves end to end."""

from benchmark.metrics._program import TRAINING, idle_ms


def read(run):
    return idle_ms(run, TRAINING, "train.encode")
