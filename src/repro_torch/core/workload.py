"""Stream workloads and the calibrated per-program resource model.

A *stream* = one analysis program running on one camera's data at a desired
frame rate (a "box" in the paper's truck analogy). Its resource requirement
vector depends on which kind of instance executes it (CPU-only vs GPU) — this
is the *multiple-choice* part of the packing problem.

Calibration. The paper does not publish the raw per-program utilization
coefficients, only the outcomes (Fig. 3) and qualitative facts (GPU speedup up
to 16x at high frame rates, <5% benefit at low rates; performance degrades
past 90% utilization). The linear coefficients below are fitted so that the
solver reproduces *all nine cells* of Fig. 3 exactly — instance counts and
dollar figures — under the Fig. 3 catalog. See tests/test_fig3.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.catalog import InstanceType


@dataclasses.dataclass(frozen=True)
class AnalysisProgram:
    """Resource model of one computer-vision program (VGG16, ZF, ...).

    Requirements are linear in frame rate: ``base + per_fps * fps`` per
    dimension, with separate CPU-execution and GPU-execution profiles.
    ``cpu_cores_per_fps=None`` in the GPU profile's host part means the GPU
    profile still consumes some host cores to decode/feed frames.
    """

    name: str
    # CPU execution profile
    cpu_cores_per_fps: float              # cores needed per frame/second on CPU
    cpu_mem_gib: float                    # host memory (model + buffers)
    # GPU execution profile
    gpu_frac_per_fps: float               # fraction of one GPU per frame/second
    gpu_mem_base_gib: float               # GPU memory: model weights
    gpu_mem_per_fps_gib: float            # GPU memory: frame buffers
    gpu_feed_cores: float = 0.5           # host cores to fetch/decode the stream
    supports_cpu: bool = True
    supports_gpu: bool = True

    def cpu_requirement(self, fps: float) -> tuple[float, ...]:
        """(cpu_cores, memory_gib, gpu_compute, gpu_memory_gib) on a CPU instance."""
        return (self.cpu_cores_per_fps * fps, self.cpu_mem_gib, 0.0, 0.0)

    def gpu_requirement(self, fps: float) -> tuple[float, ...]:
        return (
            self.gpu_feed_cores,
            self.cpu_mem_gib,
            self.gpu_frac_per_fps * fps,
            self.gpu_mem_base_gib + self.gpu_mem_per_fps_gib * fps,
        )

    def max_cpu_fps(self, cores_usable: float) -> float:
        return cores_usable / self.cpu_cores_per_fps

    def max_gpu_fps(self, gpu_usable: float = 0.9) -> float:
        return gpu_usable / self.gpu_frac_per_fps

    def gpu_speedup(self, fps: float, cores_usable: float = 7.2) -> float:
        """Effective GPU speedup at a target frame rate (paper: up to 16x at
        high rates, <5% at the lowest rates — batching amortization)."""
        peak = self.max_gpu_fps() / self.max_cpu_fps(cores_usable)
        return max(1.0, min(peak, peak * fps / self.max_gpu_fps()))


# Fitted to reproduce Fig. 3 exactly (see module docstring).
VGG16 = AnalysisProgram(
    name="VGG16",
    cpu_cores_per_fps=16.0,      # 0.45 fps max on a c4.2xlarge (7.2 usable cores)
    cpu_mem_gib=2.0,
    gpu_frac_per_fps=0.32,       # 2.81 fps max on one GPU -> ~6.3x speedup
    gpu_mem_base_gib=0.5,        # ~528 MB of weights
    gpu_mem_per_fps_gib=0.3,
)

ZF = AnalysisProgram(
    name="ZF",
    cpu_cores_per_fps=7.2,       # 1.0 fps max on a c4.2xlarge
    cpu_mem_gib=1.5,
    gpu_frac_per_fps=0.056,      # 16.07 fps max on one GPU -> ~16x speedup
    gpu_mem_base_gib=0.25,
    gpu_mem_per_fps_gib=0.35,
)

PROGRAMS = {"VGG16": VGG16, "ZF": ZF}


@dataclasses.dataclass(frozen=True)
class Stream:
    """One analysis program bound to one camera at a desired frame rate
    (``fps`` in frames/s); the box being packed onto $/hour instances."""

    stream_id: str
    program: AnalysisProgram
    fps: float
    camera: Optional[str] = None          # camera id for the geo experiments
    frame_pixels: int = 640 * 480         # kept for completeness; folded into fps cost

    def requirement_for(self, itype: InstanceType,
                        fps: Optional[float] = None) -> Optional[tuple[float, ...]]:
        """Requirement vector on this instance type, or None if incompatible.

        ``fps`` overrides the stream's own frame rate (used by the Fig. 6
        target-frame-rate sweeps). Compatibility also checks that the vector
        fits inside the usable (90%-capped) capacity of a single empty
        instance: a ZF stream at 8 fps needs 57.6 cores — no CPU instance in
        the catalog can run it at all.
        """
        f = self.fps if fps is None else fps
        return requirement_for(self.program, f, itype)


def requirement_for(program: AnalysisProgram, fps: float,
                    itype: InstanceType) -> Optional[tuple[float, ...]]:
    """Requirement vector of ``program`` at ``fps`` on ``itype``, or None if
    incompatible (unsupported execution mode, or the vector does not fit the
    usable capacity of a single empty instance)."""
    if itype.has_gpu:
        if not program.supports_gpu:
            return None
        req = program.gpu_requirement(fps)
    else:
        if not program.supports_cpu:
            return None
        req = program.cpu_requirement(fps)
    usable = itype.usable()
    if any(r > u + 1e-9 for r, u in zip(req, usable)):
        return None
    return req


def class_requirement_columns(program: AnalysisProgram, fps: float,
                              types: Sequence[InstanceType],
                              target_fps: Optional[float] = None
                              ) -> list[Optional[tuple[float, ...]]]:
    """Requirement column of one (program, frame-rate) *class*: its vector on
    every instance type (None = incompatible), at ``target_fps`` frames/s or
    the class's own rate. Pipeline stages become classes through their
    (possibly pixel-scaled) stage program, so the packed builder prices
    stages with exactly the same code path as whole streams."""
    f = fps if target_fps is None else target_fps
    return [requirement_for(program, f, t) for t in types]


def requirement_columns(stream: Stream, types: Sequence[InstanceType],
                        target_fps: Optional[float] = None
                        ) -> list[Optional[tuple[float, ...]]]:
    """One *column* of the requirement matrix: this stream's vector on every
    instance type (None = incompatible), at ``target_fps`` frames/s or the
    stream's own rate. The packed ``build_problem`` evaluates one column per
    (program, frame-rate) class and broadcasts it across locations — the
    requirement vector never varies by location, only RTT feasibility does
    — so construction is O(classes x types), not O(streams x choices)."""
    return class_requirement_columns(stream.program, stream.fps, types,
                                     target_fps)


def make_streams(spec: Sequence[tuple[str, float, int]], camera_ids: Sequence[str] | None = None) -> list[Stream]:
    """Build streams from (program_name, fps, count) tuples."""
    out: list[Stream] = []
    k = 0
    for prog_name, fps, count in spec:
        for _ in range(count):
            cam = camera_ids[k] if camera_ids is not None else None
            out.append(Stream(f"{prog_name.lower()}-{fps}-{k}", PROGRAMS[prog_name], fps, camera=cam))
            k += 1
    return out


# The three scenarios of Fig. 3 — (program, fps, number of cameras).
FIG3_SCENARIOS: dict[int, list[tuple[str, float, int]]] = {
    1: [("VGG16", 0.25, 1), ("ZF", 0.55, 3)],
    2: [("VGG16", 0.20, 1), ("ZF", 0.50, 1)],
    3: [("VGG16", 0.20, 2), ("ZF", 8.00, 10)],
}


# ---------------------------------------------------------------------------
# Content-aware analysis pipelines (beyond-paper).
#
# Real deployments run multi-stage filter pipelines: a cheap detector watches
# every frame and an expensive model fires only on the ROI crops the detector
# surfaces (smart tolling's hierarchical ROI execution; Rivas et al.'s
# object-level consolidation; CrossRoI's cross-camera overlap — PAPERS.md).
# Two consequences for the planner:
#
#   * demand is *endogenous*: how busy the scene is (traffic density) decides
#     how often downstream stages activate, so a scene getting busy IS a
#     demand spike — not just a frame-rate knob someone turned;
#   * the unit being packed is the *stage*, not the stream: a crop stage
#     processes a fraction of the source pixels (``pixel_share``) at a
#     density-dependent fraction of the source rate, and crop stages from
#     co-located cameras can be consolidated onto shared GPU bins because
#     the model weights are loaded once per bin, not once per camera.
# ---------------------------------------------------------------------------

_SCALED_PROGRAMS: dict[tuple[int, float], AnalysisProgram] = {}
_SCALED_BASES: list[AnalysisProgram] = []   # strong refs: keep id() keys unique


def scaled_program(base: AnalysisProgram, pixel_share: float) -> AnalysisProgram:
    """The ``base`` program run on crops covering ``pixel_share`` of a frame.

    Per-frame compute and frame-buffer memory scale with the pixels actually
    processed, so the per-fps coefficients shrink by ``pixel_share``; the
    model-weight and host-buffer bases do not (the network is the same size
    no matter how small the crop) — which is exactly why consolidating many
    small crop stages onto one bin pays: one copy of the weights serves all.

    Cached per (base, pixel_share) so repeated calls return the *same*
    object — requirement classes factorize by ``id(program)``.
    """
    if pixel_share == 1.0:
        return base
    if not (0.0 < pixel_share <= 1.0):
        raise ValueError(f"pixel_share must be in (0, 1], got {pixel_share}")
    key = (id(base), float(pixel_share))
    prog = _SCALED_PROGRAMS.get(key)
    if prog is None:
        prog = dataclasses.replace(
            base,
            name=f"{base.name}@{pixel_share:g}px",
            cpu_cores_per_fps=base.cpu_cores_per_fps * pixel_share,
            gpu_frac_per_fps=base.gpu_frac_per_fps * pixel_share,
            gpu_mem_per_fps_gib=base.gpu_mem_per_fps_gib * pixel_share,
        )
        _SCALED_PROGRAMS[key] = prog
        _SCALED_BASES.append(base)
    return prog


@dataclasses.dataclass(frozen=True)
class PipelineStage:
    """One stage of an analysis pipeline.

    ``rate_share`` is the fraction of source frames this stage sees when the
    scene is fully dense; ``activation(density)`` modulates it by content:
    ``clip(activation_floor + activation_gain * density, 0, 1)``. A stage
    with ``activation_floor=1.0, activation_gain=0.0`` is always-on (the
    upstream detector watching every frame); a downstream crop stage uses a
    small floor (idle scenes still trigger occasionally) and gain ~1.

    ``pixel_share`` shrinks the per-fps coefficients of ``program`` (crops
    cover a fraction of the frame); ``consolidatable`` marks stages whose
    crops from co-located cameras may be pooled onto shared bins, up to
    ``pool_cap_fps`` frames/s per pooled worker (default: the scaled
    program's single-GPU ceiling).
    """

    name: str
    program: AnalysisProgram
    rate_share: float = 1.0
    pixel_share: float = 1.0
    activation_floor: float = 1.0
    activation_gain: float = 0.0
    consolidatable: bool = False
    pool_cap_fps: Optional[float] = None

    def resolved_program(self) -> AnalysisProgram:
        """The (pixel-share-scaled) program this stage actually runs."""
        return scaled_program(self.program, self.pixel_share)

    def activation(self, density: float) -> float:
        """Fraction of this stage's full-density rate active at ``density``."""
        return min(1.0, max(0.0, self.activation_floor
                            + self.activation_gain * density))

    def stage_fps(self, source_fps: float, density: float) -> float:
        """Frames/s this stage processes from a ``source_fps`` camera."""
        return source_fps * (self.rate_share * self.activation(density))

    def cap_fps(self, gpu_usable: float = 0.9) -> float:
        """Max frames/s one pooled worker of this stage can absorb."""
        if self.pool_cap_fps is not None:
            return self.pool_cap_fps
        return self.resolved_program().max_gpu_fps(gpu_usable)


@dataclasses.dataclass(frozen=True)
class AnalysisPipeline:
    """A per-camera DAG of stages, linearized to per-stage rate shares.

    A camera running a pipeline does not emit one demand item — it emits one
    item per stage, each a (scaled-program, stage-fps) requirement class the
    planner packs like any other stream. The *effective* demand of the
    camera is the activation-weighted sum of its stage demands.
    """

    name: str
    stages: tuple[PipelineStage, ...]

    def __post_init__(self) -> None:
        if not self.stages:
            raise ValueError("pipeline needs at least one stage")
        seen = set()
        for st in self.stages:
            if st.name in seen:
                raise ValueError(f"duplicate stage name {st.name!r}")
            seen.add(st.name)

    def effective_fps(self, source_fps: float, density: float) -> float:
        """Total frames/s across stages at this content density."""
        return sum(st.stage_fps(source_fps, density) for st in self.stages)

    def stage_rates(self, source_fps: float, density: float
                    ) -> list[tuple[PipelineStage, float]]:
        """(stage, frames/s) per stage — the demand items a camera emits."""
        return [(st, st.stage_fps(source_fps, density)) for st in self.stages]


def stage_requirement_columns(pipeline: AnalysisPipeline, source_fps: float,
                              density: float,
                              types: Sequence[InstanceType]
                              ) -> list[list[Optional[tuple[float, ...]]]]:
    """Per-stage requirement columns at a content density — one
    ``class_requirement_columns`` row per stage, at the demand layer's
    rounding (rates quantized to milli-fps like ``sim.demand`` emits)."""
    return [class_requirement_columns(st.resolved_program(),
                                      round(f, 3), types)
            for st, f in pipeline.stage_rates(source_fps, density)]


# Reference pipelines. ``roi_vehicle``: a full-frame ZF detector watches every
# frame; a VGG16 classifier fires on vehicle crops (~quarter frame) for half
# the frames when the scene is saturated, almost never at night.
# ``roi_plate``: detector -> plate tracker on half-frame crops -> OCR-style
# VGG16 on tiny plate crops; only the OCR stage is consolidatable (trackers
# keep per-camera state).
PIPELINES: dict[str, AnalysisPipeline] = {
    "roi_vehicle": AnalysisPipeline("roi_vehicle", (
        PipelineStage("detect", ZF),
        PipelineStage("classify", VGG16, rate_share=0.5, pixel_share=0.25,
                      activation_floor=0.04, activation_gain=0.96,
                      consolidatable=True),
    )),
    "roi_plate": AnalysisPipeline("roi_plate", (
        PipelineStage("detect", ZF),
        PipelineStage("track", ZF, rate_share=0.4, pixel_share=0.5,
                      activation_floor=0.1, activation_gain=0.9),
        PipelineStage("ocr", VGG16, rate_share=0.2, pixel_share=0.125,
                      activation_floor=0.02, activation_gain=0.98,
                      consolidatable=True),
    )),
}
