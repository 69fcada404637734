"""Seconds from the process's start to the window's opening: the build of
the kernels, the weights, the model and its packs, the warm-up and the
graph captures."""


def read(run):
    return run.setup_s
