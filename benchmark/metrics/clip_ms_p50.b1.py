"""The median of the measured window's request ms (host clock), read in
the traced run: a steadier statistic beside ``clip_ms_p95``, whose tail
spreads by 6 to 12 % between runs on one machine."""

from benchmark.harness.readers import latency_ms


def read(run):
    return latency_ms(run, 50.0)
