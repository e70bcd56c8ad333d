"""Seasonal hour-of-week demand forecasting (BEYOND-PAPER).

The paper's workloads are strongly diurnal (§V's demand curves repeat by
hour of day), yet the other policies are reactive or, at best,
trend-extrapolating. :class:`SeasonalForecaster` learns the *shape*:
per-stream-class mean demand curves keyed by hour-of-week bucket, with an
EWMA residual correction for systematic bias and an explicit cold-start
answer (an unseen bucket forecasts the current rate — the reactive path).

A *stream class* is ``(program name, camera)``: streams of one class share
a local-time demand curve (the scenario library builds fleets exactly this
way), so a handful of class curves generalizes over thousands of streams
and a camera that joins mid-week inherits its class's history immediately.

Three feature sources feed the same model:

* :meth:`observe` — the per-decision demand the attached policy sees
  (class-resolved; the columnar path is a ``bincount`` over
  :class:`~repro_torch.sim.demand.StreamColumns` codes);
* :meth:`fit_ledger` — a past run's :class:`~repro_torch.sim.ledger.Ledger`
  (fleet-level ``frames_demanded`` per tick → the fleet curve);
* :meth:`attach_hub` — live ``fleet.frames.demanded`` telemetry points
  from an :class:`~repro_torch.obs.TelemetryHub`, which both extend the fleet
  curve *during* a run and drive a clipped multiplicative live-scale
  correction (today is running X% hotter than the fitted curve).

:class:`~repro_torch.sim.mpc.MPCPolicy` rolls these forecasts ahead of the boot
delay; ``benchmarks/forecast_mpc.py`` gates the pair against the reactive
baseline.
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.sim.demand import StreamColumns


class SeasonalForecaster:
    """Hour-of-week demand curves per stream class, with residual EWMA.

    Per class and per bucket the fit is the running mean of the observed
    *per-member* rate (frames/s); :meth:`forecast_fps` adds the class's
    EWMA residual (systematic error of recent observations against the
    fitted curve) and the fleet-level live scale. A target bucket with
    fewer than ``min_obs`` observations is *cold*: the forecast falls back
    to the stream's current rate, i.e. exactly what a reactive policy
    plans for.
    """

    #: the telemetry metric the hub subscriber consumes
    HUB_METRIC = "fleet.frames.demanded"

    def __init__(self, period_h: float = 168.0, bucket_h: float = 1.0,
                 alpha: float = 0.2, min_obs: int = 1,
                 live_window: int = 6,
                 live_clip: tuple[float, float] = (0.5, 2.0)) -> None:
        self.period_h = period_h
        self.bucket_h = bucket_h
        self.n_buckets = max(1, int(round(period_h / bucket_h)))
        self.alpha = alpha
        self.min_obs = min_obs
        self.live_clip = live_clip
        # class key -> [bucket sums (mean fps per member), bucket counts]
        self._classes: dict[tuple[str, str], list[np.ndarray]] = {}
        self._resid: dict[tuple[str, str], float] = {}
        # fleet-level curve (ledger fits + telemetry points land here)
        self._fleet_sum = np.zeros(self.n_buckets)
        self._fleet_cnt = np.zeros(self.n_buckets, dtype=np.int64)
        # recent observed/fitted fleet ratios from the hub subscriber
        self._live: collections.deque = collections.deque(maxlen=live_window)
        self._last_point: Optional[tuple[float, float]] = None
        self._idx_cache: Optional[tuple] = None

    # -- time --------------------------------------------------------------

    def bucket(self, t_h: float) -> int:
        """Hour-of-week bucket of simulated UTC hour ``t_h``."""
        return int(math.floor((t_h % self.period_h) / self.bucket_h)) \
            % self.n_buckets

    # -- stream classes ----------------------------------------------------

    def _class_index(self, streams) -> tuple[list, np.ndarray]:
        """(class keys, per-stream class index) for one tick's fleet.

        Columnar input resolves classes with one ``np.unique`` over the
        combined program/camera codes; the result is cached on the identity
        of the three arrays, so stable fleets (same ids, same codes object)
        pay once. The cache holds the arrays themselves and compares them
        by ``is``: a key of bare ``id()``s would match a new array that
        reuses a freed one's address. Object input takes the per-stream
        dict walk.
        """
        if isinstance(streams, StreamColumns):
            cols = streams
            key = (cols.ids, cols.program_codes, cols.camera_codes)
            cached = self._idx_cache
            if cached is not None and all(
                    a is b for a, b in zip(cached[0], key)):
                return cached[1], cached[2]
            pc = cols.program_codes
            cc = cols.camera_codes
            combo = pc.astype(np.int64) * (len(cols.cameras_unique) + 1) \
                + (cc + 1)
            _, first, inv = np.unique(combo, return_index=True,
                                      return_inverse=True)
            keys = []
            for i0 in first.tolist():
                p = cols.programs_unique[int(pc[i0])]
                c = int(cc[i0])
                keys.append((getattr(p, "name", str(p)),
                             cols.cameras_unique[c] if c >= 0 else ""))
            self._idx_cache = (key, keys, inv)
            return keys, inv
        keys: list[tuple[str, str]] = []
        of: dict[tuple[str, str], int] = {}
        inv = np.empty(len(streams), dtype=np.int64)
        for n, s in enumerate(streams):
            k = (getattr(s.program, "name", str(s.program)), s.camera or "")
            c = of.get(k)
            if c is None:
                c = len(keys)
                of[k] = c
                keys.append(k)
            inv[n] = c
        return keys, inv

    def _fps_of(self, streams) -> np.ndarray:
        if isinstance(streams, StreamColumns):
            return streams.fps
        return np.array([s.fps for s in streams])

    # -- fitting -----------------------------------------------------------

    def observe(self, t_h: float, streams) -> None:
        """Fold one decision's demanded rates into the seasonal fit.

        Residuals update *before* the new observation merges: the EWMA
        tracks how today's demand deviates from the curve as fitted so
        far, which is exactly the correction the next forecast needs.
        """
        if len(streams) == 0:
            return
        keys, inv = self._class_index(streams)
        fps = self._fps_of(streams)
        sums = np.bincount(inv, weights=fps, minlength=len(keys))
        cnts = np.bincount(inv, minlength=len(keys))
        means = sums / np.maximum(cnts, 1)
        b = self.bucket(t_h)
        for k, key in enumerate(keys):
            m = float(means[k])
            rec = self._classes.get(key)
            if rec is None:
                rec = self._classes[key] = [
                    np.zeros(self.n_buckets),
                    np.zeros(self.n_buckets, dtype=np.int64)]
            csum, ccnt = rec
            if ccnt[b] > 0:
                pred = csum[b] / ccnt[b]
                self._resid[key] = ((1.0 - self.alpha)
                                    * self._resid.get(key, 0.0)
                                    + self.alpha * (m - pred))
            csum[b] += m
            ccnt[b] += 1

    def warmup(self, demand, horizon_h: float, dt_h: float = 1.0,
               start_h: float = 0.0) -> None:
        """Prime the class curves by replaying a demand model over
        ``[start_h, start_h + horizon_h)`` — "yesterday's telemetry" (every
        demand model in the scenario library is a pure seeded function of
        time, so a replay is legitimate history, not leakage)."""
        t = start_h
        end = start_h + horizon_h
        cols = getattr(demand, "columns_at", None)
        while t < end - 1e-9:
            self.observe(t, cols(t) if cols is not None
                         else demand.streams_at(t))
            t += dt_h

    def fit_ledger(self, ledger) -> None:
        """Fold a past run's per-tick ``frames_demanded`` into the
        fleet-level hour-of-week curve (intervals come from consecutive
        record times; the final record reuses the last interval)."""
        recs = list(ledger.records)
        for i, r in enumerate(recs):
            if i + 1 < len(recs):
                dt = recs[i + 1].t - r.t
            elif i > 0:
                dt = r.t - recs[i - 1].t
            else:
                continue               # one record: interval unknowable
            if dt <= 0:
                continue
            b = self.bucket(r.t)
            self._fleet_sum[b] += r.frames_demanded / (dt * 3600.0)
            self._fleet_cnt[b] += 1

    # -- live telemetry ----------------------------------------------------

    def attach_hub(self, hub) -> None:
        """Subscribe to an :class:`~repro_torch.obs.TelemetryHub`: every
        ``fleet.frames.demanded`` point extends the fleet curve and the
        live-scale window as the run happens."""
        hub.subscribe(self._on_point)

    def _on_point(self, point) -> None:
        if point.name != self.HUB_METRIC:
            return
        prev = self._last_point
        self._last_point = (point.t, point.value)
        if prev is None:
            return
        t0, frames = prev
        dt = point.t - t0
        if dt <= 0:
            # time went backwards: a new run is streaming through the hub
            self._live.clear()
            return
        fps = frames / (dt * 3600.0)
        b = self.bucket(t0)
        if self._fleet_cnt[b] > 0:
            pred = self._fleet_sum[b] / self._fleet_cnt[b]
            if pred > 0:
                self._live.append(fps / pred)
        self._fleet_sum[b] += fps
        self._fleet_cnt[b] += 1

    def live_scale(self) -> float:
        """Clipped mean of recent observed/fitted fleet demand ratios —
        the "today is hotter/cooler than the curve" correction. 1.0 when
        no telemetry has arrived (and, by construction, on a day that
        matches the fit)."""
        if not self._live:
            return 1.0
        s = sum(self._live) / len(self._live)
        lo, hi = self.live_clip
        return min(hi, max(lo, s))

    def fleet_fps(self, at_t: float) -> Optional[float]:
        """Fitted fleet-level rate at ``at_t`` (None when the bucket is
        cold) — the coarse curve ledger fits and telemetry feed."""
        b = self.bucket(at_t)
        if self._fleet_cnt[b] < self.min_obs:
            return None
        return float(self._fleet_sum[b] / self._fleet_cnt[b])

    # -- forecasting -------------------------------------------------------

    def forecast_fps(self, at_t: float, streams
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(forecast frames/s, known mask) aligned with ``streams``.

        Where the mask is False the class's target bucket is cold and the
        returned rate is the stream's *current* rate — the reactive
        fallback. Warm entries are ``(bucket mean + residual) * live_scale``,
        floored at zero.
        """
        fps = self._fps_of(streams)
        if len(fps) == 0:
            return fps, np.zeros(0, dtype=bool)
        keys, inv = self._class_index(streams)
        b = self.bucket(at_t)
        scale = self.live_scale()
        pred = np.empty(len(keys))
        known = np.zeros(len(keys), dtype=bool)
        for k, key in enumerate(keys):
            rec = self._classes.get(key)
            if rec is not None and rec[1][b] >= self.min_obs:
                p = (rec[0][b] / rec[1][b] + self._resid.get(key, 0.0)) \
                    * scale
                pred[k] = max(0.0, p)
                known[k] = True
            else:
                pred[k] = 0.0
        known_s = known[inv]
        return np.where(known_s, pred[inv], fps), known_s

    def coverage(self, at_t: float, streams) -> float:
        """Fraction of the fleet whose class bucket at ``at_t`` is warm —
        the cold-start gate :class:`~repro_torch.sim.mpc.MPCPolicy` checks
        before trusting the forecast over the reactive path."""
        if len(streams) == 0:
            return 0.0
        _, known = self.forecast_fps(at_t, streams)
        return float(np.count_nonzero(known)) / len(known)
