"""The share of the traced window in which no device operation ran."""

from benchmark.metrics._sampling import sampling_idle as read  # noqa: F401
