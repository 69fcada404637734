"""The whole step's share of the card's bf16 peak: the model FLOPs of the
measured window's samples (counts/train_step.py) over its seconds, read
in the traced run."""

from benchmark.metrics._training import training_mfu as read  # noqa: F401
