"""Retrieval: corpus caches, scorers, exemplar placement (port of
``raggesture_tpu/retrieval``)."""
