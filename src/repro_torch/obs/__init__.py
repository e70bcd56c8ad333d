"""Observability layer: the profile→pack→observe loop.

* ``probe`` — :class:`DriftingService`, the simulator's ground-truth serving
  rates over time (with injected :class:`RateShift` regressions), plus the
  measurement probe a real deployment would get from
  ``ContinuousBatchingEngine.windowed_rates()``.

The modules are numpy and stdlib only, statement for statement those of the
JAX package's ``obs``. The metrics hub, trace spans, drift detectors,
recalibrating policies and exporters are still to be ported; ``__all__``
names only what exists.
"""
from repro_torch.obs.probe import DriftingService, RateShift

__all__ = ["DriftingService", "RateShift"]
