"""The host's ms a training step spends enqueueing its work: the host
clock around the step's call, which does not wait for the card, over the
traced window's steps.  Where it nears the step's device time the host
paces the step."""

from benchmark.metrics._training import step_enqueue_ms as read  # noqa: F401
