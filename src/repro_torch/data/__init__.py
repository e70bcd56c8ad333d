"""Deterministic synthetic inputs (``data.pipeline``)."""
from repro_torch.data.pipeline import (InputShape, SHAPES, make_batch,
                                       input_specs, synthetic_batch_iterator)

__all__ = ["InputShape", "SHAPES", "make_batch", "input_specs",
           "synthetic_batch_iterator"]
