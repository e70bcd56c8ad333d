"""Deterministic synthetic inputs (``data.pipeline``)."""
