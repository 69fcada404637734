"""The whole clip's share of the card's bf16 peak: the model FLOPs of the
measured window's clips (counts/clip.py) over its seconds, read in the
traced run."""

from benchmark.metrics._sampling import sampling_mfu as read  # noqa: F401
