"""Observability layer (BEYOND-PAPER): the profile→pack→observe loop, closed.

The paper's manager profiles serving throughput once at startup and packs
from that calibration forever. This package makes the loop continuous:

* ``metrics``      — :class:`TelemetryHub`, a streaming metric export: the
                     fleet simulator's event loop pushes per-tick points
                     (named after OpenTelemetry conventions) to subscribers
                     *as they happen*, instead of post-hoc ``Ledger`` reads.
* ``trace``        — :class:`Tracer` / :class:`Span`, per-replan trace
                     spans (simulated time + wall-clock duration + decision
                     attributes, nested recalibrate → replan); and the
                     serving path's spans (``trace.program_tracer()``): an
                     engine step's admission, prefills, decode, readback
                     and retirements, each decode step's host issue, and
                     each request's wait in the queue. They are
                     recorded only while a ``torch.profiler`` records on
                     the serving thread, so profiling the process turns
                     them on; but for the queue wait each is also a
                     ``repro_torch/<name>`` range on the timeline of a
                     profiler that records operators.
* ``drift``        — :class:`DriftDetector`, comparing measured engine
                     rates against the active
                     :class:`~repro_torch.sim.ledger.ServiceCalibration` and
                     firing when the relative error holds past a threshold
                     for K consecutive ticks.
* ``probe``        — :class:`DriftingService`, the simulator's ground-truth
                     serving rates over time (with injected regressions)
                     plus the measurement probe a real deployment would get
                     from ``ContinuousBatchingEngine.windowed_rates()``.
* ``recalibrate``  — :class:`RecalibratingPolicy`, wrapping any autoscaling
                     policy: re-profiles on drift and forces a
                     min-migration repair replan through the existing
                     ``core/repair.py`` machinery.
* ``export``       — the exporter bridge: :class:`JsonlMetricExporter`
                     (OTLP-ish newline-delimited JSON, a hub subscriber),
                     :func:`chrome_trace` / :func:`write_chrome_trace`
                     (span trees as ``chrome://tracing`` JSON; the serving
                     spans at their real host start times), and the
                     :class:`MetricAggregator` with Counter / Gauge /
                     Histogram instruments (exact p50/p95/p99).
* ``regional``     — per-region live drift: :class:`WindowedServiceProbe`
                     (``windowed_rates()`` delta-export semantics over the
                     simulated truth), :class:`EngineWindowProbe` (real
                     per-region engines), :class:`RegionalDriftDetector`
                     (one streak per group) and
                     :class:`RegionalRecalibratingPolicy` (re-profile only
                     the drifted group, repair scoped to its bins).

The modules are numpy and stdlib only, statement for statement those of the
JAX package's ``obs``, so verdicts, plans, ledgers and exported files are
the same bit for bit. ``chip_smoke.py``'s observability phase runs the
fleet-wide loop on ``drifting_scene``, the exporters and the per-group loop
on ``regional_drift``, and the per-group loop over two serving engines on
the card.
"""
from repro_torch.obs.drift import DriftConfig, DriftDetector, DriftVerdict
from repro_torch.obs.export import (Counter, Gauge, Histogram,
                                    JsonlMetricExporter, MetricAggregator,
                                    chrome_trace, hub_with_exporters,
                                    load_jsonl_metrics,
                                    spans_from_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.metrics import MetricPoint, TelemetryHub
from repro_torch.obs.probe import DriftingService, RateShift
from repro_torch.obs.recalibrate import RecalibratingPolicy
from repro_torch.obs.regional import (EngineWindowProbe,
                                      RegionalDriftDetector,
                                      RegionalRecalibratingPolicy,
                                      RegionalVerdict, WindowedServiceProbe,
                                      camera_region_groups)
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "Counter", "DriftConfig", "DriftDetector", "DriftVerdict",
    "DriftingService", "EngineWindowProbe", "Gauge", "Histogram",
    "JsonlMetricExporter", "MetricAggregator", "MetricPoint", "RateShift",
    "RecalibratingPolicy", "RegionalDriftDetector",
    "RegionalRecalibratingPolicy", "RegionalVerdict", "Span", "TelemetryHub",
    "Tracer", "WindowedServiceProbe", "camera_region_groups", "chrome_trace",
    "hub_with_exporters", "load_jsonl_metrics", "spans_from_chrome_trace",
    "write_chrome_trace",
]
