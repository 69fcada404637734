"""Training samples whose step (loss, gradients, Adam's update) finished
in the window, over the window's seconds (host clock; the window closes
when the card has finished every step enqueued in it)."""

from benchmark.harness.readers import rate


def read(run):
    return rate(run)
