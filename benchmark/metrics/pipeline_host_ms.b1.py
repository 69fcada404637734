"""Host ms a request spends running the generator's pipeline (the
program's ``gen.pipeline`` span: on the card the copies into the graph's
static inputs, the replay's launch and the outputs' clones), over the
traced window's requests.

Read in the traced window alone, so it includes the tracer's cost (CUPTI
on every launch, the profiler's record of every operator): it reads
higher than the untraced program spends, and tells stages apart, not
what a change saves end to end."""

from benchmark.metrics._program import SAMPLING, host_ms


def read(run):
    return host_ms(run, SAMPLING, "gen.pipeline")
