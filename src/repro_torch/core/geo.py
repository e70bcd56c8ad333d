"""Geography: cameras, datacenters, RTT model, and RTT-feasibility (Fig. 4).

Chen et al. [5] observed that the achievable frame rate of a pull-based
network-camera stream drops as the camera<->instance round-trip time grows.
We model the achievable frame rate as ``fps_max(rtt_ms) = RTT_BUDGET / rtt_ms``:
a stream with target frame rate f is feasible at a location iff
``rtt(camera, location) <= RTT_BUDGET / f``. With RTT_BUDGET = 1000 this gives
the paper's regimes: below 1 fps almost every location is feasible (circles
cover the globe, Fig. 4b); above 20 fps only nearby datacenters qualify
(Fig. 4a); 1-20 fps is the interesting mid-band.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

RTT_BUDGET_MS = 1000.0          # fps * rtt_ms <= RTT_BUDGET_MS
FIBER_MS_PER_KM = 0.01          # ~200 km/ms one way -> 0.01 ms/km round trip x2 below
RTT_OVERHEAD_MS = 10.0          # handshake / last-mile constant


@dataclasses.dataclass(frozen=True)
class Place:
    name: str
    lat: float
    lon: float


# Cloud datacenters (region name -> coordinates), EC2-style regions.
DATACENTERS: Mapping[str, Place] = {
    "us-east-1": Place("N. Virginia", 38.95, -77.45),
    "us-west-2": Place("Oregon", 45.60, -122.60),
    "sa-east-1": Place("Sao Paulo", -23.55, -46.63),
    "eu-west-1": Place("Ireland", 53.35, -6.26),
    "eu-central-1": Place("Frankfurt", 50.11, 8.68),
    "ap-southeast-1": Place("Singapore", 1.35, 103.82),
    "ap-northeast-1": Place("Tokyo", 35.68, 139.69),
    "ap-southeast-2": Place("Sydney", -33.87, 151.21),
    "ap-south-1": Place("Mumbai", 19.08, 72.88),
}

# Worldwide network cameras, mirroring the paper's Fig. 4 world map.
CAMERAS: Mapping[str, Place] = {
    "nyc": Place("New York", 40.71, -74.01),
    "chicago": Place("Chicago", 41.88, -87.63),
    "la": Place("Los Angeles", 34.05, -118.24),
    "saopaulo": Place("Sao Paulo", -23.55, -46.63),
    "london": Place("London", 51.51, -0.13),
    "paris": Place("Paris", 48.86, 2.35),
    "berlin": Place("Berlin", 52.52, 13.40),
    "singapore": Place("Singapore", 1.29, 103.85),
    "tokyo": Place("Tokyo", 35.68, 139.69),
    "sydney": Place("Sydney", -33.87, 151.21),
    "mumbai": Place("Mumbai", 19.08, 72.88),
    "seattle": Place("Seattle", 47.61, -122.33),
}


def haversine_km(a: Place, b: Place) -> float:
    r = 6371.0
    p1, p2 = math.radians(a.lat), math.radians(b.lat)
    dp = p2 - p1
    dl = math.radians(b.lon - a.lon)
    h = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * r * math.asin(math.sqrt(h))


def rtt_ms(camera: str, region: str) -> float:
    """Round-trip time estimate between a camera and a datacenter region."""
    cam, dc = CAMERAS[camera], DATACENTERS[region]
    km = haversine_km(cam, dc)
    return RTT_OVERHEAD_MS + 2.0 * km * FIBER_MS_PER_KM


def max_fps(camera: str, region: str) -> float:
    """Highest frame rate sustainable from this camera at this region [5]."""
    return RTT_BUDGET_MS / rtt_ms(camera, region)


def feasible_regions(camera: str, fps: float, regions) -> list[str]:
    """Regions inside the camera's Fig.-4 circle for this target frame rate."""
    return [r for r in regions if max_fps(camera, r) >= fps]


def nearest_region(camera: str, regions) -> str:
    return min(regions, key=lambda r: rtt_ms(camera, r))


# ---------------------------------------------------------------------------
# Local (solar) time — the fleet simulator's diurnal demand curves peak at a
# camera's *local* rush hours, so a worldwide fleet ramps region by region as
# the sun moves ("follow the sun").
# ---------------------------------------------------------------------------

def utc_offset_hours(place: Place | str) -> float:
    """Solar-time UTC offset from longitude (15 degrees of longitude = 1 h).

    A mean-solar-time approximation of the timezone: it ignores political
    timezone boundaries and DST, which is exactly what a demand model keyed
    to daylight/rush-hour behaviour wants.
    """
    if isinstance(place, str):
        place = CAMERAS.get(place) or DATACENTERS[place]
    return place.lon / 15.0


def local_hour(utc_hour: float, place: Place | str) -> float:
    """Local solar hour-of-day in [0, 24) for a UTC simulation time in hours.

    ``place`` is a camera id, a datacenter region id, or a ``Place``.
    """
    return (utc_hour + utc_offset_hours(place)) % 24.0
