"""Device-idle ms a request whose innermost program span is the
generator's pipeline run (``gen.pipeline``).

Read in the traced window alone, so the gaps include the tracer's cost
on the host: they name where the card waits under the tracer, not what
a change saves end to end."""

from benchmark.metrics._program import SAMPLING, idle_ms


def read(run):
    return idle_ms(run, SAMPLING, "gen.pipeline")
