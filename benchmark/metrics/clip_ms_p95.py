"""The 95th percentile of every request's ms from sent until its decoded
motion is on the host (host clock); a failed request counts as never
answered."""

from benchmark.harness.readers import latency_ms


def read(run):
    return latency_ms(run, 95.0)
