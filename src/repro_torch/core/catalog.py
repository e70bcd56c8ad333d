"""Instance catalog: the port's copy of ``InstanceType``, ``Catalog`` and
``UTILIZATION_CAP`` from ``repro.core.catalog``.

An instance type is a bin with a capacity vector over resource dimensions
and an hourly price per location.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

# The paper's dimension order for the cloud catalogs; other catalogs (the
# H100 one) name their own dimensions.
DIMENSIONS = ("cpu_cores", "memory_gib", "gpu_compute", "gpu_memory_gib")

# The paper's measured safe-utilization threshold: above 90% on any dimension,
# analysis performance degrades, so the manager never packs past it.
UTILIZATION_CAP = 0.90


@dataclasses.dataclass(frozen=True)
class InstanceType:
    """One instance configuration: a raw capacity vector over
    ``dimensions`` priced in $/hour per location."""

    name: str
    capacity: tuple[float, ...]          # raw capacity per dimension
    prices: Mapping[str, float]          # location -> $/hour
    has_gpu: bool = False
    dimensions: tuple[str, ...] = DIMENSIONS

    def usable(self, cap: float = UTILIZATION_CAP) -> tuple[float, ...]:
        """Capacity after the 90% utilization head-room rule."""
        return tuple(c * cap for c in self.capacity)

    def cheapest_location(self) -> tuple[str, float]:
        loc = min(self.prices, key=self.prices.__getitem__)
        return loc, self.prices[loc]


@dataclasses.dataclass(frozen=True)
class Catalog:
    """A set of instance types, each priced in $/hour per location."""

    types: tuple[InstanceType, ...]

    def __post_init__(self) -> None:
        names = [t.name for t in self.types]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate instance type names: {names}")

    def get(self, name: str) -> InstanceType:
        for t in self.types:
            if t.name == name:
                return t
        raise KeyError(name)
