"""Composable demand generators: the fleet's frame-rate needs over time.

A demand model maps simulated UTC hours to the set of demanded
:class:`~repro_torch.core.workload.Stream` objects. The base generator gives every
camera a diurnal rush-hour curve in its *local* (solar) time via
``core.geo.local_hour``, so a worldwide fleet ramps region by region as the
sun moves. Wrappers compose on top: Poisson camera churn (arrivals with
exponential lifetimes), flash-crowd events (a region's rates spike for a
window), and day/night program-mix shifts. Everything is a pure, seeded
function of time — two scans of the same model are identical.

Demand has two equivalent representations. ``streams_at`` returns the
classic list of ``Stream`` objects (the API edge). ``columns_at`` returns a
:class:`StreamColumns` — the same fleet as struct-of-arrays (ids, fps
vector, program/camera codes) — which the columnar fleet simulator and the
packed planner consume without materializing a Python object per stream.
Every wrapper composes on columns: churn appends rows, flash crowds rescale
the fps vector, mix shifts rewrite program codes. The two views are
bit-identical (``float(cols.fps[i]) == streams[i].fps`` etc.; see
tests/test_columnar_parity.py).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional, Protocol, Sequence

import numpy as np

from repro_torch.core import geo
from repro_torch.core.workload import PIPELINES, PROGRAMS, Stream


class DemandModel(Protocol):
    def streams_at(self, t_h: float) -> list[Stream]: ...


class StreamColumns(Sequence):
    """One tick's demanded fleet as struct-of-arrays.

    ``ids`` is the per-stream id list (stable models reuse the same list
    object every tick — downstream fast paths key on that identity);
    ``fps`` the demanded rates in frames/s (float64, exactly the rounded
    values ``streams_at`` would produce); programs and cameras are stored
    factorized: ``program_codes[i]`` indexes ``programs_unique`` (and
    ``camera_codes[i]`` indexes ``cameras_unique``, ``-1`` = no camera), so
    class grouping in the packed planner is pure array work.

    It is also a ``Sequence[Stream]``: indexing/iterating materializes the
    object view lazily (once per tick, cached), so object-path consumers —
    repair planning, EWMA forecasts — keep working unchanged.
    """

    __slots__ = ("ids", "fps", "program_codes", "programs_unique",
                 "camera_codes", "cameras_unique", "_streams")

    def __init__(self, ids, fps, program_codes, programs_unique,
                 camera_codes, cameras_unique) -> None:
        self.ids = ids
        self.fps = fps
        self.program_codes = program_codes
        self.programs_unique = programs_unique
        self.camera_codes = camera_codes
        self.cameras_unique = cameras_unique
        self._streams: Optional[list[Stream]] = None

    def __len__(self) -> int:
        return len(self.ids)

    def _materialize(self) -> list[Stream]:
        if self._streams is None:
            progs = self.programs_unique
            cams = self.cameras_unique
            fps = self.fps.tolist()
            self._streams = [
                Stream(sid, progs[p], fps=f,
                       camera=(cams[c] if c >= 0 else None))
                for sid, p, f, c in zip(self.ids, self.program_codes.tolist(),
                                        fps, self.camera_codes.tolist())]
        return self._streams

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def any_camera(self) -> bool:
        return bool((self.camera_codes >= 0).any())


def _factorize_by_id(objs) -> tuple[np.ndarray, tuple]:
    """Codes for a list of objects, grouped by identity."""
    code_of: dict[int, int] = {}
    unique: list = []
    codes = np.empty(len(objs), dtype=np.int64)
    for n, o in enumerate(objs):
        c = code_of.get(id(o))
        if c is None:
            c = len(unique)
            code_of[id(o)] = c
            unique.append(o)
        codes[n] = c
    return codes, tuple(unique)


def _factorize_cameras(cams) -> tuple[np.ndarray, tuple]:
    """Codes for a list of camera ids (``None`` maps to code ``-1``)."""
    code_of: dict[str, int] = {}
    unique: list[str] = []
    codes = np.empty(len(cams), dtype=np.int64)
    for n, c in enumerate(cams):
        if c is None:
            codes[n] = -1
            continue
        k = code_of.get(c)
        if k is None:
            k = len(unique)
            code_of[c] = k
            unique.append(c)
        codes[n] = k
    return codes, tuple(unique)


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """One camera's demand profile: a diurnal curve between ``base_fps`` and
    ``peak_fps`` (both in frames/s, reached at local rush hours)."""

    stream_id: str
    camera: str                  # key in geo.CAMERAS
    program: str                 # key in workload.PROGRAMS
    base_fps: float              # frames/s off-peak
    peak_fps: float              # frames/s at the rush-hour crest


def rush_hour_fps(local_h: float, base: float, peak: float,
                  width_h: float = 1.5) -> float:
    """Demanded frame rate (frames/s) at local hour ``local_h``: morning
    (8:30) and evening (17:30) rush hours as Gaussian bumps of width
    ``width_h`` hours over a quiet base rate (paper Fig. 5's shape)."""
    bump = (math.exp(-((local_h - 8.5) / width_h) ** 2)
            + math.exp(-((local_h - 17.5) / width_h) ** 2))
    return base + (peak - base) * min(1.0, bump)


def _rush_hour_fps_array(local_h: np.ndarray, base, peak,
                         width_h: float) -> np.ndarray:
    """Batched :func:`rush_hour_fps` — identical floats, one numpy pass."""
    bump = (np.exp(-((local_h - 8.5) / width_h) ** 2)
            + np.exp(-((local_h - 17.5) / width_h) ** 2))
    return base + (peak - base) * np.minimum(1.0, bump)


@dataclasses.dataclass(frozen=True)
class DiurnalFleet:
    """Each camera follows the rush-hour curve in its own local time.

    Demand is evaluated *batched*: one numpy pass computes every camera's
    local hour and rush-hour frame rate (frames/s) per tick, instead of a
    Python call per camera — the per-stream loop only constructs the
    ``Stream`` objects. ``repro_torch.core.packed.scalar_mode()`` switches back to
    the original per-camera evaluation (the parity baseline); both paths
    produce identical streams bit for bit (see tests/test_packed_parity.py).
    """

    cameras: tuple[CameraSpec, ...]
    width_h: float = 1.5

    def _arrays(self):
        """Cached per-camera columns: (utc offsets h, base fps, peak fps,
        program objects, stream ids, camera ids, program codes/unique,
        camera codes/unique)."""
        cached = getattr(self, "_cols", None)
        if cached is None:
            programs = [PROGRAMS[c.program] for c in self.cameras]
            cams = [c.camera for c in self.cameras]
            pcodes, puniq = _factorize_by_id(programs)
            ccodes, cuniq = _factorize_cameras(cams)
            cached = (
                np.array([geo.utc_offset_hours(c.camera)
                          for c in self.cameras]),
                np.array([c.base_fps for c in self.cameras]),
                np.array([c.peak_fps for c in self.cameras]),
                programs,
                [c.stream_id for c in self.cameras],
                cams,
                pcodes, puniq, ccodes, cuniq,
            )
            object.__setattr__(self, "_cols", cached)
        return cached

    def fps_at(self, t_h: float) -> np.ndarray:
        """All cameras' demanded frame rates (frames/s) at UTC hour ``t_h``
        as one vector — the batched form of :func:`rush_hour_fps`."""
        offs, base, peak = self._arrays()[:3]
        local_h = np.mod(t_h + offs, 24.0)
        return _rush_hour_fps_array(local_h, base, peak, self.width_h)

    def columns_at(self, t_h: float) -> StreamColumns:
        """The fleet at ``t_h`` as :class:`StreamColumns` (the id list and
        code arrays are the cached per-fleet objects, reused every tick)."""
        (_, _, _, _, ids, _, pcodes, puniq, ccodes, cuniq) = self._arrays()
        # np.round is verified bit-identical to the scalar round(., 3) on
        # this curve family (tests/test_packed_parity.py covers it end to
        # end)
        fps = np.round(self.fps_at(t_h), 3)
        return StreamColumns(ids, fps, pcodes, puniq, ccodes, cuniq)

    def streams_at(self, t_h: float) -> list[Stream]:
        from repro_torch.core import packed
        if not packed.enabled() and self.cameras:
            out = []
            for c in self.cameras:
                fps = rush_hour_fps(geo.local_hour(t_h, c.camera),
                                    c.base_fps, c.peak_fps, self.width_h)
                out.append(Stream(c.stream_id, PROGRAMS[c.program],
                                  fps=round(fps, 3), camera=c.camera))
            return out
        (_, _, _, programs, ids, cams) = self._arrays()[:6]
        # tolist() converts to Python floats in one pass
        fps = np.round(self.fps_at(t_h), 3).tolist()
        # reuse the frozen Stream while a camera's rounded rate is unchanged
        # (diurnal curves plateau at base and peak) — identical objects, no
        # per-tick reallocation for the stable part of the fleet
        cache = getattr(self, "_stream_cache", None)
        if cache is None:
            cache = [None] * len(ids)
            object.__setattr__(self, "_stream_cache", cache)
        out = []
        for n, (sid, prog, fr, cam) in enumerate(zip(ids, programs, fps, cams)):
            s = cache[n]
            if s is None or s.fps != fr:
                s = Stream(sid, prog, fps=fr, camera=cam)
                cache[n] = s
            out.append(s)
        return out


def columnar_fleet(ids: list, utc_offset_h: np.ndarray, base_fps: np.ndarray,
                   peak_fps: np.ndarray, program_codes: np.ndarray,
                   programs_unique: tuple, camera_codes: np.ndarray,
                   cameras_unique: tuple, width_h: float = 1.5) -> DiurnalFleet:
    """Build a :class:`DiurnalFleet` directly from columns — no per-camera
    :class:`CameraSpec` objects. At continent scale (10^6 streams) the object
    constructor would allocate a million specs just to factorize them back
    into the arrays below; this hands the fleet its cached columns up front.
    ``programs_unique`` holds :class:`~repro_torch.core.workload.Program` objects,
    ``cameras_unique`` camera ids (keys of ``geo.CAMERAS``); the code arrays
    index them per stream (camera code ``-1`` = no camera). The resulting
    model is bit-identical to the equivalent ``DiurnalFleet(specs)``."""
    pcodes = np.asarray(program_codes, dtype=np.int64)
    ccodes = np.asarray(camera_codes, dtype=np.int64)
    puniq = tuple(programs_unique)
    cuniq = tuple(cameras_unique)
    programs = [puniq[c] for c in pcodes.tolist()]
    cams = [cuniq[c] if c >= 0 else None for c in ccodes.tolist()]
    fleet = DiurnalFleet(cameras=(), width_h=width_h)
    object.__setattr__(fleet, "_cols", (
        np.asarray(utc_offset_h, dtype=np.float64),
        np.asarray(base_fps, dtype=np.float64),
        np.asarray(peak_fps, dtype=np.float64),
        programs, list(ids), cams, pcodes, puniq, ccodes, cuniq))
    return fleet


@dataclasses.dataclass(frozen=True)
class PipelineCameraSpec:
    """One camera running an analysis *pipeline* at a fixed capture rate.

    Unlike :class:`CameraSpec` (whose frame rate swings diurnally), the
    camera grabs ``fps`` frames/s around the clock — what swings is the
    scene's *content density* between ``base_density`` (sparse night) and
    ``peak_density`` (dense rush hour), which modulates how often each
    downstream pipeline stage activates. A busy scene IS the demand spike."""

    stream_id: str
    camera: str                  # key in geo.CAMERAS
    pipeline: str                # key in workload.PIPELINES
    fps: float                   # capture rate, frames/s (constant)
    base_density: float = 0.05   # scene density off-peak, in [0, 1]
    peak_density: float = 1.0    # scene density at the rush-hour crest


class _PipelineArrays:
    """Static per-fleet columns for :class:`PipelineFleet` (built once)."""

    __slots__ = ("offs", "dbase", "dpeak",
                 "pair_spec", "pair_share", "pair_floor", "pair_gain",
                 "pair_fps", "base_idx", "pooled_idx",
                 "base_ids", "base_pcodes", "base_ccodes",
                 "pool_code", "n_pools", "pool_chunks", "pool_prefixes",
                 "all_pcodes", "all_ccodes", "puniq", "cuniq", "ids")


@dataclasses.dataclass(frozen=True)
class PipelineFleet:
    """Content-aware pipeline demand: cameras emit *stages*, not streams.

    Every camera runs its pipeline's stages; each stage becomes one demand
    item ``"{stream_id}::{stage}"`` at the activation-weighted stage rate —
    so the planner packs stages (cheap full-frame detectors separately from
    heavy crop models) and the fleet's effective demand follows the scene
    density curve, not a frame-rate knob.

    ``consolidate=True`` additionally pools each camera-colocated group of
    ``consolidatable`` stage crops (same camera, pipeline, stage) into
    shared workers: the pooled rate is split across the fewest chunks that
    respect the stage's ``cap_fps()`` *at peak density* — the chunk count is
    static, so pooled ids (``"pool::{pipeline}.{stage}@{camera}#{k}"``) are
    stable all day and only the per-chunk rate breathes with the scene; one
    model load serves many cameras' crops, and no chunk ever appears
    mid-run just because the scene got busy. The ``#k`` suffix reuses the
    replica anti-affinity grammar from ``core.markets``: chunks of one pool
    never co-locate on a single spot market.

    Like :class:`DiurnalFleet`, evaluation is batched (one numpy pass per
    tick over the flattened (camera, stage) pairs) with a bit-identical
    scalar fallback under ``repro_torch.core.packed.scalar_mode()``.
    """

    cameras: tuple[PipelineCameraSpec, ...]
    width_h: float = 1.5
    consolidate: bool = False

    # sim.fleet keys its stage/pooled ledger columns off this marker
    emits_stages = True

    def _arrays(self) -> _PipelineArrays:
        cached = getattr(self, "_cols", None)
        if cached is not None:
            return cached
        a = _PipelineArrays()
        a.offs = np.array([geo.utc_offset_hours(c.camera)
                           for c in self.cameras])
        a.dbase = np.array([c.base_density for c in self.cameras])
        a.dpeak = np.array([c.peak_density for c in self.cameras])
        # flatten to (camera, stage) pairs, spec-major in stage order
        pair_spec, share, floor, gain, fps = [], [], [], [], []
        pair_ids, pair_progs, pair_cams, pooled = [], [], [], []
        pair_stage, pair_pipe = [], []
        for n, spec in enumerate(self.cameras):
            pipe = PIPELINES[spec.pipeline]
            for st in pipe.stages:
                pair_spec.append(n)
                share.append(st.rate_share)
                floor.append(st.activation_floor)
                gain.append(st.activation_gain)
                fps.append(spec.fps)
                pair_ids.append(f"{spec.stream_id}::{st.name}")
                pair_progs.append(st.resolved_program())
                pair_cams.append(spec.camera)
                pair_stage.append(st)
                pair_pipe.append(pipe.name)
                pooled.append(self.consolidate and st.consolidatable)
        a.pair_spec = np.array(pair_spec, dtype=np.int64)
        a.pair_share = np.array(share)
        a.pair_floor = np.array(floor)
        a.pair_gain = np.array(gain)
        a.pair_fps = np.array(fps)
        pooled = np.array(pooled, dtype=bool)
        a.base_idx = np.flatnonzero(~pooled)
        a.pooled_idx = np.flatnonzero(pooled)
        a.base_ids = [pair_ids[i] for i in a.base_idx.tolist()]
        # pools factorize by (camera, pipeline, stage) in first appearance
        # order over the pooled pairs — the scalar path's dict order
        pool_of: dict[tuple, int] = {}
        pool_code, caps, prefixes, pool_progs, pool_cams = [], [], [], [], []
        peak_tot: list[float] = []
        for i in a.pooled_idx.tolist():
            st, pname, cam = pair_stage[i], pair_pipe[i], pair_cams[i]
            spec = self.cameras[pair_spec[i]]
            key = (cam, pname, st.name)
            k = pool_of.get(key)
            if k is None:
                k = len(pool_of)
                pool_of[key] = k
                caps.append(st.cap_fps())
                prefixes.append(f"pool::{pname}.{st.name}@{cam}")
                pool_progs.append(st.resolved_program())
                pool_cams.append(cam)
                peak_tot.append(0.0)
            pool_code.append(k)
            # the member's rate at the densest the scene ever gets — the
            # diurnal curve is bounded by [min, max](base, peak) density
            dmax = max(spec.base_density, spec.peak_density)
            act = min(1.0, max(0.0, st.activation_floor
                               + st.activation_gain * dmax))
            peak_tot[k] += round(spec.fps * (st.rate_share * act), 3)
        a.pool_code = np.array(pool_code, dtype=np.int64)
        a.n_pools = len(pool_of)
        # chunk counts are pinned at peak: per-chunk rate stays under
        # cap_fps() all day and the pooled id list never changes mid-run
        a.pool_chunks = np.array(
            [max(1, math.ceil(t / c)) for t, c in zip(peak_tot, caps)],
            dtype=np.int64)
        a.pool_prefixes = prefixes
        # one factorization covers base pairs and pools (emission order:
        # base items first, then pool chunks)
        base_progs = [pair_progs[i] for i in a.base_idx.tolist()]
        base_cams = [pair_cams[i] for i in a.base_idx.tolist()]
        pcodes, a.puniq = _factorize_by_id(base_progs + pool_progs)
        ccodes, a.cuniq = _factorize_cameras(base_cams + pool_cams)
        nb = len(base_progs)
        if a.n_pools:
            mm = a.pool_chunks
            a.all_pcodes = np.concatenate([pcodes[:nb],
                                           np.repeat(pcodes[nb:], mm)])
            a.all_ccodes = np.concatenate([ccodes[:nb],
                                           np.repeat(ccodes[nb:], mm)])
        else:
            a.all_pcodes, a.all_ccodes = pcodes, ccodes
        a.ids = a.base_ids + [f"{pref}#{k}"
                              for pref, m in zip(a.pool_prefixes,
                                                 a.pool_chunks.tolist())
                              for k in range(m)]
        object.__setattr__(self, "_cols", a)
        return a

    def density_at(self, t_h: float) -> np.ndarray:
        """Every camera's scene density at UTC hour ``t_h`` — the rush-hour
        curve of :func:`rush_hour_fps` reinterpreted as content density."""
        a = self._arrays()
        local = np.mod(t_h + a.offs, 24.0)
        return _rush_hour_fps_array(local, a.dbase, a.dpeak, self.width_h)

    def _pair_rates(self, t_h: float) -> np.ndarray:
        """Per-(camera, stage) demanded frames/s at ``t_h`` (milli-fps)."""
        a = self._arrays()
        dens = self.density_at(t_h)
        act = np.minimum(1.0, np.maximum(
            0.0, a.pair_floor + a.pair_gain * dens[a.pair_spec]))
        # same op order as the scalar path: fps * (share * activation)
        return np.round(a.pair_fps * (a.pair_share * act), 3)

    def columns_at(self, t_h: float) -> StreamColumns:
        a = self._arrays()
        rate = self._pair_rates(t_h)
        if a.n_pools == 0:
            return StreamColumns(a.ids, rate, a.all_pcodes, a.puniq,
                                 a.all_ccodes, a.cuniq)
        # np.bincount accumulates weights in input order — the same order
        # (spec-major, stage order) the scalar dict accumulation uses
        totals = np.bincount(a.pool_code, weights=rate[a.pooled_idx],
                             minlength=a.n_pools)
        # truncate (never round up) so cap_fps stays a hard per-chunk ceiling
        chunk = np.floor((totals / a.pool_chunks) * 1000.0) / 1000.0
        fps = np.concatenate([rate[a.base_idx],
                              np.repeat(chunk, a.pool_chunks)])
        return StreamColumns(a.ids, fps, a.all_pcodes, a.puniq,
                             a.all_ccodes, a.cuniq)

    def streams_at(self, t_h: float) -> list[Stream]:
        from repro_torch.core import packed
        if packed.enabled() or not self.cameras:
            return list(self.columns_at(t_h))
        out: list[Stream] = []
        pool_totals: dict[tuple, float] = {}
        pool_meta: dict[tuple, tuple] = {}
        for spec in self.cameras:
            pipe = PIPELINES[spec.pipeline]
            dens = rush_hour_fps(geo.local_hour(t_h, spec.camera),
                                 spec.base_density, spec.peak_density,
                                 self.width_h)
            for st in pipe.stages:
                act = min(1.0, max(0.0, st.activation_floor
                                   + st.activation_gain * dens))
                f = round(spec.fps * (st.rate_share * act), 3)
                if self.consolidate and st.consolidatable:
                    key = (spec.camera, pipe.name, st.name)
                    meta = pool_meta.get(key)
                    if meta is None:
                        meta = pool_meta[key] = [st.cap_fps(),
                                                 st.resolved_program(), 0.0]
                        pool_totals[key] = 0.0
                    pool_totals[key] += f
                    # member's rate at peak density — fixes the chunk count
                    dmax = max(spec.base_density, spec.peak_density)
                    act_pk = min(1.0, max(0.0, st.activation_floor
                                          + st.activation_gain * dmax))
                    meta[2] += round(spec.fps * (st.rate_share * act_pk), 3)
                else:
                    out.append(Stream(f"{spec.stream_id}::{st.name}",
                                      st.resolved_program(), fps=f,
                                      camera=spec.camera))
        for (cam, pname, sname), total in pool_totals.items():
            cap, prog, peak = pool_meta[(cam, pname, sname)]
            m = max(1, math.ceil(peak / cap))
            f = math.floor((total / m) * 1000.0) / 1000.0
            for k in range(m):
                out.append(Stream(f"pool::{pname}.{sname}@{cam}#{k}",
                                  prog, fps=f, camera=cam))
        return out


@dataclasses.dataclass(frozen=True)
class PoissonChurn:
    """Cameras come and go: Poisson arrivals (``rate_per_h`` per simulated
    hour) over the horizon, each living an exponential lifetime of mean
    ``mean_lifetime_h`` hours, cycling through a pool of camera templates.
    The whole arrival schedule is drawn once at construction from the seed.

    Churn streams ride the *same* diurnal curve as the fleet they join:
    ``width_h`` is taken from the wrapped model's rush-hour width (or set
    explicitly), not silently reset to the default."""

    inner: DemandModel
    templates: tuple[CameraSpec, ...]
    rate_per_h: float = 0.5
    mean_lifetime_h: float = 6.0
    horizon_h: float = 24.0
    seed: int = 0
    # None = inherit the innermost wrapped model's width_h (1.5 if none
    # declares one); a float pins it explicitly
    width_h: Optional[float] = None
    _schedule: tuple[tuple[float, float, CameraSpec], ...] = ()

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        n = int(rng.poisson(self.rate_per_h * self.horizon_h))
        arrivals = np.sort(rng.uniform(0.0, self.horizon_h, n))
        lifetimes = rng.exponential(self.mean_lifetime_h, n)
        sched = []
        for k, (a, life) in enumerate(zip(arrivals, lifetimes)):
            tpl = self.templates[k % len(self.templates)]
            spec = dataclasses.replace(tpl, stream_id=f"{tpl.stream_id}-churn{k}")
            sched.append((float(a), float(a + life), spec))
        object.__setattr__(self, "_schedule", tuple(sched))

    def effective_width_h(self) -> float:
        """The rush-hour width churn streams use: ``width_h`` if set, else
        the first ``width_h`` found walking down the wrapped model chain."""
        if self.width_h is not None:
            return self.width_h
        m = self.inner
        while m is not None:
            w = getattr(m, "width_h", None)
            if w is not None:
                return w
            m = getattr(m, "inner", None)
        return 1.5

    def _churn_arrays(self):
        """Cached per-schedule columns for the batched path."""
        cached = getattr(self, "_carr", None)
        if cached is None:
            sched = self._schedule
            programs = [PROGRAMS[c.program] for _, _, c in sched]
            cached = (
                np.array([s for s, _, _ in sched]),
                np.array([e for _, e, _ in sched]),
                np.array([geo.utc_offset_hours(c.camera)
                          for _, _, c in sched]),
                np.array([c.base_fps for _, _, c in sched]),
                np.array([c.peak_fps for _, _, c in sched]),
                programs,
                [c.stream_id for _, _, c in sched],
                [c.camera for _, _, c in sched],
            )
            object.__setattr__(self, "_carr", cached)
        return cached

    def _active_fps(self, t_h: float):
        """(active schedule indices, their rounded fps) at ``t_h``."""
        starts, ends, offs, base, peak = self._churn_arrays()[:5]
        if starts.size == 0:
            return np.empty(0, dtype=np.int64), np.empty(0)
        active = np.flatnonzero((starts <= t_h) & (t_h < ends))
        if active.size == 0:
            return active, np.empty(0)
        local = np.mod(t_h + offs[active], 24.0)
        fps = _rush_hour_fps_array(local, base[active], peak[active],
                                   self.effective_width_h())
        return active, np.round(fps, 3)

    def streams_at(self, t_h: float) -> list[Stream]:
        from repro_torch.core import packed
        out = self.inner.streams_at(t_h)
        if not packed.enabled():
            width = self.effective_width_h()
            for start, end, c in self._schedule:
                if start <= t_h < end:
                    fps = rush_hour_fps(geo.local_hour(t_h, c.camera),
                                        c.base_fps, c.peak_fps, width)
                    out.append(Stream(c.stream_id, PROGRAMS[c.program],
                                      fps=round(fps, 3), camera=c.camera))
            return out
        active, fps = self._active_fps(t_h)
        if active.size:
            _, _, _, _, _, programs, ids, cams = self._churn_arrays()
            for k, f in zip(active.tolist(), fps.tolist()):
                out.append(Stream(ids[k], programs[k], fps=f, camera=cams[k]))
        return out

    def columns_at(self, t_h: float) -> StreamColumns:
        cols = self.inner.columns_at(t_h)
        active, fps = self._active_fps(t_h)
        if not active.size:
            return cols
        _, _, _, _, _, programs, ids, cams = self._churn_arrays()
        puniq = list(cols.programs_unique)
        pcode_of = {id(p): n for n, p in enumerate(puniq)}
        cuniq = list(cols.cameras_unique)
        ccode_of = {c: n for n, c in enumerate(cuniq)}
        pcodes = np.empty(active.size, dtype=np.int64)
        ccodes = np.empty(active.size, dtype=np.int64)
        for n, k in enumerate(active.tolist()):
            p = programs[k]
            pc = pcode_of.get(id(p))
            if pc is None:
                pc = len(puniq)
                pcode_of[id(p)] = pc
                puniq.append(p)
            pcodes[n] = pc
            cam = cams[k]
            cc = ccode_of.get(cam)
            if cc is None:
                cc = len(cuniq)
                ccode_of[cam] = cc
                cuniq.append(cam)
            ccodes[n] = cc
        return StreamColumns(
            cols.ids + [ids[k] for k in active.tolist()],
            np.concatenate([cols.fps, fps]),
            np.concatenate([cols.program_codes, pcodes]), tuple(puniq),
            np.concatenate([cols.camera_codes, ccodes]), tuple(cuniq))


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """An event (match, incident) multiplies demand on selected cameras for a
    window. The spike is capped at ``cap_fps`` *and* at each stream's own
    program feasibility ceiling (the rate a 90%-capped GPU sustains —
    ~14 fps for ZF but only ~2.8 for VGG16), so a boosted stream can always
    still be planned somewhere."""

    inner: DemandModel
    start_h: float
    duration_h: float
    multiplier: float
    cameras: Optional[frozenset[str]] = None      # geo camera ids; None = all
    cap_fps: float = 12.0

    def streams_at(self, t_h: float) -> list[Stream]:
        out = self.inner.streams_at(t_h)
        if not (self.start_h <= t_h < self.start_h + self.duration_h):
            return out
        boosted = []
        for s in out:
            if self.cameras is None or s.camera in self.cameras:
                cap = min(self.cap_fps, s.program.max_gpu_fps())
                f = min(s.fps * self.multiplier, cap)
                # truncate (never round up) so the cap stays a hard ceiling
                s = dataclasses.replace(s, fps=math.floor(f * 1000) / 1000)
            boosted.append(s)
        return boosted

    def columns_at(self, t_h: float) -> StreamColumns:
        cols = self.inner.columns_at(t_h)
        if not (self.start_h <= t_h < self.start_h + self.duration_h):
            return cols
        caps = np.array([min(self.cap_fps, p.max_gpu_fps())
                         for p in cols.programs_unique])
        cap = caps[cols.program_codes]
        if self.cameras is None:
            mask = np.ones(len(cols), dtype=bool)
        else:
            sel = np.array([c in self.cameras for c in cols.cameras_unique],
                           dtype=bool)
            mask = (cols.camera_codes >= 0) \
                & sel[np.maximum(cols.camera_codes, 0)]
        f = np.minimum(cols.fps * self.multiplier, cap)
        fps = np.where(mask, np.floor(f * 1000) / 1000, cols.fps)
        return StreamColumns(cols.ids, fps,
                             cols.program_codes, cols.programs_unique,
                             cols.camera_codes, cols.cameras_unique)


@dataclasses.dataclass(frozen=True)
class MixShift:
    """Program-mix shift: a deterministic fraction of cameras switches to a
    different (cheaper, e.g. VGG16 at low rates) analysis program during
    local night hours — monitoring instead of live detection."""

    inner: DemandModel
    night_program: str = "VGG16"
    fraction: float = 0.3
    night_start_h: float = 22.0
    night_end_h: float = 6.0

    def _selected(self, stream_id: str) -> bool:
        # pure function of the id — memoized so a 10k-stream fleet does not
        # re-hash every stream every tick
        memo = getattr(self, "_memo", None)
        if memo is None:
            memo = {}
            object.__setattr__(self, "_memo", memo)
        sel = memo.get(stream_id)
        if sel is None:
            sel = (zlib.crc32(stream_id.encode()) % 1000) < self.fraction * 1000
            memo[stream_id] = sel
        return sel

    def _selected_mask(self, ids) -> np.ndarray:
        """Per-stream selection as a bool vector, cached per id-list object
        (stable fleets reuse their id list every tick)."""
        cached = getattr(self, "_selmask", None)
        if cached is not None and cached[0] is ids:
            return cached[1]
        mask = np.fromiter((self._selected(sid) for sid in ids),
                           dtype=bool, count=len(ids))
        object.__setattr__(self, "_selmask", (ids, mask))
        return mask

    def streams_at(self, t_h: float) -> list[Stream]:
        # the night test depends only on the camera, not the stream — decide
        # once per distinct camera per tick instead of per stream
        night_of: dict[str, bool] = {}
        prog = PROGRAMS[self.night_program]
        out = []
        for s in self.inner.streams_at(t_h):
            if s.camera is not None:
                night = night_of.get(s.camera)
                if night is None:
                    lh = geo.local_hour(t_h, s.camera)
                    night = lh >= self.night_start_h or lh < self.night_end_h
                    night_of[s.camera] = night
                if night and self._selected(s.stream_id):
                    s = dataclasses.replace(s, program=prog)
            out.append(s)
        return out

    def columns_at(self, t_h: float) -> StreamColumns:
        cols = self.inner.columns_at(t_h)
        if not len(cols):
            return cols
        offs = np.array([geo.utc_offset_hours(c)
                         for c in cols.cameras_unique]) \
            if cols.cameras_unique else np.empty(0)
        local = np.mod(t_h + offs, 24.0)
        night_uniq = (local >= self.night_start_h) | (local < self.night_end_h)
        night = (cols.camera_codes >= 0) \
            & night_uniq[np.maximum(cols.camera_codes, 0)] \
            if offs.size else np.zeros(len(cols), dtype=bool)
        shift = night & self._selected_mask(cols.ids)
        if not shift.any():
            return cols
        prog = PROGRAMS[self.night_program]
        puniq = cols.programs_unique
        try:
            code = next(n for n, p in enumerate(puniq) if p is prog)
        except StopIteration:
            code = len(puniq)
            puniq = puniq + (prog,)
        pcodes = np.where(shift, code, cols.program_codes)
        return StreamColumns(cols.ids, cols.fps, pcodes, puniq,
                             cols.camera_codes, cols.cameras_unique)


def peak_streams(demand: DemandModel, horizon_h: float,
                 step_h: float = 0.5) -> list[Stream]:
    """Scan ``horizon_h`` simulated hours (every ``step_h``) and return each
    stream at its maximum demanded rate in frames/s — what a static
    peak-provisioned deployment must plan (and pay $/hour) for."""
    best: dict[str, Stream] = {}
    t = 0.0
    while t < horizon_h:
        for s in demand.streams_at(t):
            cur = best.get(s.stream_id)
            if cur is None or s.fps > cur.fps:
                best[s.stream_id] = s
        t += step_h
    return [best[k] for k in sorted(best)]
