"""Distributed optimisation: the gradient compressor (``distributed.collectives``)."""
