"""Utilities: carrying weights across from the JAX package and from the
reference's torch checkpoints, CUDA graphs, logging, motion files."""
