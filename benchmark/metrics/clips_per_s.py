"""Clips whose decoded motion reached the host in the window, without a
non-finite value, over the window's seconds (host clock)."""

from benchmark.harness.readers import rate


def read(run):
    return rate(run)
