"""Cloud instance catalog — Table I of the paper plus the instances used in Fig. 3/6.

An *instance type* is a bin with a capacity vector over resource dimensions and an
hourly price that depends on the datacenter location. The paper's dimensions are
(cpu_cores, memory_gib, gpu_compute, gpu_memory_gib); the H100 catalog
(gpu_catalog.py) reuses the same InstanceType with different dimension names.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

# Canonical resource dimension order used by the packing solver for the cloud
# (paper) catalog. Kaseb et al. [7] use exactly these four dimensions.
DIMENSIONS = ("cpu_cores", "memory_gib", "gpu_compute", "gpu_memory_gib")

# The paper's measured safe-utilization threshold: above 90% on any dimension,
# analysis performance degrades, so the manager never packs past it.
UTILIZATION_CAP = 0.90


@dataclasses.dataclass(frozen=True)
class InstanceType:
    """One cloud instance configuration (a "truck" in the sidebar analogy):
    a raw capacity vector over ``dimensions`` (cores, GiB, GPU fraction,
    GPU GiB by default) priced in $/hour per location."""

    name: str
    capacity: tuple[float, ...]          # raw capacity per dimension
    prices: Mapping[str, float]          # location -> $/hour
    has_gpu: bool = False
    dimensions: tuple[str, ...] = DIMENSIONS

    def price_at(self, location: str) -> float:
        try:
            return self.prices[location]
        except KeyError:
            raise KeyError(
                f"instance {self.name} is not offered in {location}; "
                f"available: {sorted(self.prices)}"
            ) from None

    @property
    def locations(self) -> tuple[str, ...]:
        return tuple(sorted(self.prices))

    def usable(self, cap: float = UTILIZATION_CAP) -> tuple[float, ...]:
        """Capacity after the 90% utilization head-room rule."""
        return tuple(c * cap for c in self.capacity)

    def cheapest_location(self) -> tuple[str, float]:
        loc = min(self.prices, key=self.prices.__getitem__)
        return loc, self.prices[loc]


@dataclasses.dataclass(frozen=True)
class Catalog:
    """A set of instance types offered by one or more vendors, each priced
    in $/hour per datacenter location."""

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

    def offered_at(self, location: str) -> tuple[InstanceType, ...]:
        return tuple(t for t in self.types if location in t.prices)

    @property
    def locations(self) -> tuple[str, ...]:
        locs: set[str] = set()
        for t in self.types:
            locs.update(t.prices)
        return tuple(sorted(locs))

    def choices(self) -> tuple[tuple[InstanceType, str, float], ...]:
        """All (type, location, price) choices — the multiple-choice dimension."""
        out = []
        for t in self.types:
            for loc, p in sorted(t.prices.items()):
                out.append((t, loc, p))
        return tuple(out)


# --------------------------------------------------------------------------
# Paper catalogs
# --------------------------------------------------------------------------

def fig3_catalog() -> Catalog:
    """The two instance types behind Fig. 3 of the paper.

    Kaseb et al. [7] ran on EC2 with a CPU instance at $0.419/h (c4.2xlarge,
    2016 pricing) and a GPU instance at $0.650/h (g2.2xlarge: 8 vCPU, 15 GiB,
    1×GRID K520 with 4 GiB GPU memory). These prices reproduce every dollar
    figure in Fig. 3 (4×0.419=1.676, 11×0.650=7.150, 0.419+10×0.650=6.919).
    """
    cpu = InstanceType(
        name="c4.2xlarge",
        capacity=(8.0, 15.0, 0.0, 0.0),
        prices={"us-east-1": 0.419},
        has_gpu=False,
    )
    gpu = InstanceType(
        name="g2.2xlarge",
        capacity=(8.0, 15.0, 1.0, 4.0),
        prices={"us-east-1": 0.650},
        has_gpu=True,
    )
    return Catalog(types=(cpu, gpu))


def table1_catalog() -> Catalog:
    """Table I of the paper: EC2 + Azure types at three locations each."""
    return Catalog(types=(
        InstanceType("c4.2xlarge", (8.0, 15.0, 0.0, 0.0),
                     {"virginia": 0.398, "london": 0.476, "singapore": 0.462}),
        InstanceType("c4.8xlarge", (36.0, 60.0, 0.0, 0.0),
                     {"virginia": 1.591, "london": 1.902, "singapore": 1.848}),
        InstanceType("g3.8xlarge", (32.0, 244.0, 2.0, 16.0),
                     {"virginia": 2.280, "singapore": 3.340}, has_gpu=True),
        InstanceType("D8v3", (8.0, 32.0, 0.0, 0.0),
                     {"us-east": 0.384, "west-europe": 0.480, "east-asia": 0.625}),
        InstanceType("NC24r", (24.0, 224.0, 4.0, 48.0),
                     {"us-east": 3.960, "west-europe": 5.132}, has_gpu=True),
    ))


def fig6_catalog() -> Catalog:
    """Multi-region catalog for the location experiments (Fig. 6).

    Modeled on 2018 EC2 pricing across the regions the paper's Fig. 4 world
    map shows (N. Virginia, Oregon, São Paulo, Ireland, Frankfurt, Singapore,
    Tokyo, Sydney). Price disparity across regions reaches ~63%, matching the
    paper's observation on the Azure D8v3 (0.625/0.384 = 1.63).
    """
    cpu_small_prices = {
        "us-east-1": 0.398, "us-west-2": 0.398, "sa-east-1": 0.618,
        "eu-west-1": 0.453, "eu-central-1": 0.486, "ap-southeast-1": 0.462,
        "ap-northeast-1": 0.504, "ap-southeast-2": 0.522, "ap-south-1": 0.420,
    }
    cpu_large_prices = {k: round(v * 4.0 - 0.001, 3) for k, v in cpu_small_prices.items()}
    gpu_prices = {
        "us-east-1": 0.650, "us-west-2": 0.650, "eu-west-1": 0.702,
        "ap-southeast-1": 1.000, "ap-northeast-1": 0.898, "sa-east-1": 1.134,
        "ap-southeast-2": 0.898, "ap-south-1": 0.813,
    }
    gpu_big_prices = {
        "us-east-1": 2.280, "us-west-2": 2.280, "eu-west-1": 2.420,
        "ap-northeast-1": 3.160, "ap-southeast-2": 3.366, "ap-south-1": 2.926,
        "sa-east-1": 3.580, "eu-central-1": 2.726, "ap-southeast-1": 3.340,
    }
    return Catalog(types=(
        InstanceType("c4.2xlarge", (8.0, 15.0, 0.0, 0.0), cpu_small_prices),
        InstanceType("c4.8xlarge", (36.0, 60.0, 0.0, 0.0), cpu_large_prices),
        InstanceType("g2.2xlarge", (8.0, 15.0, 1.0, 4.0), gpu_prices, has_gpu=True),
        InstanceType("g3.8xlarge", (32.0, 244.0, 2.0, 16.0), gpu_big_prices, has_gpu=True),
    ))
