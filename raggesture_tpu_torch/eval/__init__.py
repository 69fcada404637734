"""Evaluation of saved result directories: metrics and the evaluator."""
