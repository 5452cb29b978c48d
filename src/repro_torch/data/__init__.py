"""Synthetic training data (``data.pipeline``)."""
