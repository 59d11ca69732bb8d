"""Deterministic synthetic data (``pipeline``)."""
