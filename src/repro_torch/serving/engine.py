"""Serving engines + camera-stream simulator, ported from
``repro.serving.engine``.

Each camera frame becomes one fixed-size inference request; a stream at f
fps enqueues f requests per second.

* ``ServingEngine`` — static lock-step batching: prefill a batch of
  equal-length prompts, then decode all of them together.
* ``ContinuousBatchingEngine`` — a fixed pool of preallocated KV-cache
  slots; new requests are admitted into free slots mid-decode, finished
  requests free their slot immediately, and the queue is drained
  earliest-deadline-first using each stream's per-frame budget (1/fps).

The engines run wherever their parameters live (a CUDA device in serving,
the CPU in tests). The cache is updated in place: a prefill writes its
slot's rows, and each decode step writes one KV position per row (attention)
or each row's state and conv history (SSD), so the pool is allocated once
and never copied. Stats and their exports
(``measured_rates``, ``windowed_rates``, ``report``) match the reference's
exactly, so the reference planner, simulator and observability code consume
these engines unchanged; ``ContinuousBatchingEngine.report()`` adds two
fields of its own, ``decode_graph_share`` and ``dense_kernel_share`` (the
share of the FLOPs of its fp32 CUDA products of many rows, a prefill's,
that ran on the split-TF32 kernel, ``kernels.dense_gemm``).

On a CUDA device, with plain (not DTensor) parameters,
``ContinuousBatchingEngine`` captures its decode step once, when it is
built, as a CUDA graph over its own cache (``steps.DecodeGraph``), and each
step replays it: the same kernels on the same tensors, one launch for the
host to issue. The static engine, whose position is an int, decodes
eagerly.

While a torch profiler records on the serving thread, each
``ContinuousBatchingEngine.step`` is a tree of spans on the program tracer
of ``obs.trace`` (``engine.step``, ``engine.admit``, ``engine.prefill``,
``engine.decode``, ``engine.readback``, ``engine.retire``) and each admission
records its request's ``request.queue`` wait; that module's docstring lists
them. Outputs, ``stats`` and ``report()`` are the same with the spans on or
off, and the engine's clock is read no more often.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import dense_gemm as _dg
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.models.config import ArchConfig
from repro_torch.tree import leaves


@dataclasses.dataclass
class Request:
    request_id: str
    tokens: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    stream_id: Optional[str] = None
    enqueue_t: float = 0.0
    deadline_s: float = float("inf")   # per-frame latency budget (1/fps)
    output: Optional[np.ndarray] = None
    finish_t: float = 0.0

    @property
    def deadline_t(self) -> float:
        return self.enqueue_t + self.deadline_s

    @property
    def latency_s(self) -> float:
        return self.finish_t - self.enqueue_t


class _EngineStatsMixin:
    """Shared stats accounting (both engines keep a ``stats`` dict with a
    float ``wall_s`` and integer counters including ``tokens_generated``,
    plus per-stream token tallies and active windows behind
    ``measured_rates``/``windowed_rates``). A copy of the reference's mixin,
    whose module imports jax."""

    def _init_stream_stats(self) -> None:
        self._stream_tokens: dict[str, int] = {}
        # per-stream active window [first_seen, last_seen] on the engine
        # clock (cumulative wall_s)
        self._stream_window: dict[str, list[float]] = {}
        self._touched: set[str] = set()
        self._rate_snapshot: tuple[float, dict[str, int]] = (0.0, {})

    def reset_stats(self) -> None:
        """Zero the counters (e.g. after a warmup run)."""
        self.stats = {k: 0.0 if isinstance(v, float) else 0
                      for k, v in self.stats.items()}
        self._init_stream_stats()

    def throughput_tokens_per_s(self) -> float:
        if self.stats["wall_s"] == 0:
            return 0.0
        return self.stats["tokens_generated"] / self.stats["wall_s"]

    def _count_stream_token(self, req: Request, n: int = 1) -> None:
        key = req.stream_id or req.request_id
        self._stream_tokens[key] = self._stream_tokens.get(key, 0) + n
        self._touched.add(key)

    def _mark_windows(self, clock0: float, clock1: float) -> None:
        """Extend the active window of every stream served this step to
        cover [clock0, clock1] (engine-clock seconds)."""
        for key in self._touched:
            w = self._stream_window.get(key)
            if w is None:
                self._stream_window[key] = [clock0, clock1]
            elif clock1 > w[1]:
                w[1] = clock1
        self._touched.clear()

    def measured_rates(self) -> dict[str, float]:
        """Measured tokens/sec per stream over *that stream's* active window
        (first-seen to last-seen on the engine clock) — the profiling export
        the planner packs from. A stream whose window is empty falls back to
        the total wall time."""
        wall = self.stats["wall_s"]
        out: dict[str, float] = {}
        for sid, n in sorted(self._stream_tokens.items()):
            w = self._stream_window.get(sid)
            span = (w[1] - w[0]) if w is not None else 0.0
            if span <= 0.0:
                span = wall
            if span <= 0.0:
                continue
            out[sid] = n / span
        return out

    def windowed_rates(self) -> dict[str, float]:
        """Tokens/sec per stream since the *previous* call. Streams with no
        tokens in the window are omitted (no data, not zero throughput)."""
        wall = self.stats["wall_s"]
        prev_wall, prev_tokens = self._rate_snapshot
        span = wall - prev_wall
        out: dict[str, float] = {}
        if span > 0:
            for sid, n in sorted(self._stream_tokens.items()):
                delta = n - prev_tokens.get(sid, 0)
                if delta > 0:
                    out[sid] = delta / span
        self._rate_snapshot = (wall, dict(self._stream_tokens))
        return out


def _params_device_dtype(params) -> tuple[torch.device, torch.dtype]:
    emb = params["embed"]["embedding"]
    return emb.device, emb.dtype


def _check_fits(req: Request, cache_len: int) -> None:
    if len(req.tokens) + req.max_new_tokens > cache_len:
        raise ValueError(
            f"request {req.request_id}: prompt {len(req.tokens)} + "
            f"{req.max_new_tokens} new tokens exceeds cache_len {cache_len}")


def _argmax(logits: torch.Tensor) -> np.ndarray:
    """Greedy tokens; ties take the first maximum, as jnp.argmax does."""
    return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()


class ServingEngine(_EngineStatsMixin):
    """Static-batching engine for equal-length frame requests."""

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 cache_len: int = 512, opts: Optional[M.ModelOptions] = None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.opts = opts or M.ModelOptions(remat=False)
        M.check_cache_options(cfg, self.opts)
        self.device, _ = _params_device_dtype(params)
        self.queue: list[Request] = []
        self._init_stream_stats()
        self.stats = {"requests": 0, "tokens_generated": 0, "batches": 0,
                      "decode_steps": 0, "wall_s": 0.0}

    def submit(self, req: Request) -> None:
        """Queue a request; one that would run past ``cache_len`` is refused
        here, before anything is queued (the reference's static engine
        takes it and clamps the cache write)."""
        _check_fits(req, self.cache_len)
        req.enqueue_t = time.monotonic()
        self.queue.append(req)

    def _pad_batch(self, reqs: Sequence[Request]) -> torch.Tensor:
        L = max(len(r.tokens) for r in reqs)
        if not all(len(r.tokens) == L for r in reqs):
            raise ValueError("static batching requires equal-length frame "
                             "requests")
        toks = np.stack([r.tokens for r in reqs])
        return torch.as_tensor(toks, dtype=torch.long, device=self.device)

    def step(self) -> list[Request]:
        """Serve one batch from the queue; returns completed requests."""
        if not self.queue:
            return []
        batch_reqs = self.queue[: self.max_batch]
        self.queue = self.queue[len(batch_reqs):]
        t0 = time.monotonic()
        clock0 = self.stats["wall_s"]

        tokens = self._pad_batch(batch_reqs)
        B, L = tokens.shape
        logits, cache = steps.prefill_step(self.params, {"tokens": tokens},
                                           self.cfg, self.opts,
                                           self.cache_len)
        max_new = max(r.max_new_tokens for r in batch_reqs)
        outs = np.zeros((B, max_new), np.int32)
        tok = _argmax(logits)
        for i in range(max_new):
            outs[:, i] = tok
            logits, cache = steps.decode_step(
                self.params, cache,
                {"token": torch.as_tensor(tok, dtype=torch.long,
                                          device=self.device),
                 "pos": L + i}, self.cfg, self.opts)
            tok = _argmax(logits)
            self.stats["decode_steps"] += 1

        wall = time.monotonic() - t0
        self.stats["wall_s"] += wall
        self.stats["batches"] += 1
        for b, r in enumerate(batch_reqs):
            r.output = outs[b, : r.max_new_tokens]
            r.finish_t = time.monotonic()
            self.stats["requests"] += 1
            self.stats["tokens_generated"] += r.max_new_tokens
            self._count_stream_token(r, r.max_new_tokens)
        self._mark_windows(clock0, self.stats["wall_s"])
        return list(batch_reqs)

    def drain(self) -> list[Request]:
        done: list[Request] = []
        while self.queue:
            done.extend(self.step())
        return done


class ContinuousBatchingEngine(_EngineStatsMixin):
    """Continuous batching over a fixed pool of preallocated KV-cache slots.

    Each of the ``max_slots`` rows of one batched cache (length
    ``cache_len``) is a slot. Per step: (1) admit queued requests into free
    slots in earliest-deadline-first order — each admission prefills that
    one request and writes its KV into the slot in place
    (``steps.prefill_into_slot_step``), leaving the other slots untouched;
    (2) run a single batched decode step with per-slot positions; (3)
    retire any request that reached its ``max_new_tokens``, freeing its
    slot for the next admission.

    Greedy decoding is identical to the static engine's: the prefill's
    last-position argmax is the first generated token, and each decode step
    at position prompt_len + i yields token i + 1. On the card each decode
    step is a replay of the graph captured at construction; the graph
    counts its replays, and ``report()["decode_graph_share"]`` reads them.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_slots: int = 8,
                 cache_len: int = 512, opts: Optional[M.ModelOptions] = None):
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.opts = opts or M.ModelOptions(remat=False)
        M.check_cache_options(cfg, self.opts)
        self.device, dtype = _params_device_dtype(params)
        self.queue: list[Request] = []
        self.cache = M.init_cache(cfg, max_slots, cache_len, dtype, self.opts,
                                  device=self.device)
        # the decode step as a CUDA graph, captured now (before any
        # profiler a caller starts) where every tensor is a plain CUDA one
        self._decode_graph = None
        if self.device.type == "cuda" and not any(
                isinstance(t, DTensor) for t in leaves([params, self.cache])):
            self._decode_graph = steps.DecodeGraph(params, self.cache, cfg,
                                                   self.opts, max_slots)
        self._slot_req: list[Optional[Request]] = [None] * max_slots
        self._slot_pos = np.zeros(max_slots, np.int32)   # next write position
        self._slot_out: list[list[int]] = [[] for _ in range(max_slots)]
        self._pending = np.zeros(max_slots, np.int32)    # next token to feed
        self._latencies: list[float] = []
        self._slo_hits = 0
        self._occupancy_sum = 0.0
        self._dense0 = _dense_flops()
        self._init_stream_stats()
        self.stats = {"requests": 0, "tokens_generated": 0, "prefills": 0,
                      "decode_steps": 0, "wall_s": 0.0}

    # -- queue ---------------------------------------------------------------

    def submit(self, req: Request) -> None:
        _check_fits(req, self.cache_len)
        req.enqueue_t = time.monotonic()
        self.queue.append(req)

    def active_slots(self) -> list[int]:
        return [s for s in range(self.max_slots)
                if self._slot_req[s] is not None]

    # -- engine loop ---------------------------------------------------------

    def _admit(self, req: Request, slot: int, span) -> None:
        tokens = torch.as_tensor(req.tokens[None, :], dtype=torch.long,
                                 device=self.device)
        logits, self.cache = steps.prefill_into_slot_step(
            self.params, self.cache, {"tokens": tokens}, slot, self.cfg,
            self.opts, self.cache_len)
        with span("engine.readback"):
            first = int(_argmax(logits))
        self._slot_req[slot] = req
        self._slot_out[slot] = [first]
        self._slot_pos[slot] = len(req.tokens)
        self._pending[slot] = first
        self.stats["prefills"] += 1
        self.stats["tokens_generated"] += 1
        self._count_stream_token(req)

    def _retire(self, slot: int, span) -> Request:
        req = self._slot_req[slot]
        with span("engine.retire", request_id=req.request_id) as sp:
            req.output = np.asarray(self._slot_out[slot], np.int32)
            req.finish_t = time.monotonic()
            self._latencies.append(req.latency_s)
            if req.latency_s <= req.deadline_s:
                self._slo_hits += 1
            self._slot_req[slot] = None
            self._slot_out[slot] = []
            self.stats["requests"] += 1
            if sp is not None:
                sp.attrs["latency_s"] = req.latency_s
        return req

    def step(self) -> list[Request]:
        """One engine iteration: EDF admission into free slots, then one
        batched decode step for every occupied slot. Returns the requests
        completed this iteration."""
        span = steps.serving_span()      # once a step: on while profiled
        with span("engine.step") as root:
            t0 = time.monotonic()
            clock0 = self.stats["wall_s"]
            done: list[Request] = []

            # 1) admission, earliest deadline first
            if self.queue:
                with span("engine.admit"):
                    self.queue.sort(key=lambda r: r.deadline_t)
                    for slot in range(self.max_slots):
                        if not self.queue:
                            break
                        if self._slot_req[slot] is not None:
                            continue
                        req = self.queue.pop(0)
                        with span("engine.prefill",
                                        request_id=req.request_id, slot=slot,
                                        prompt_len=len(req.tokens),
                                        queue_depth=len(self.queue)) as sp:
                            if sp is not None:
                                # enqueue_t is on the engine's clock: moved
                                # to the tracer's by this step's two starts
                                from repro_torch.obs.trace import \
                                    program_tracer
                                program_tracer().record(
                                    "request.queue",
                                    req.enqueue_t + root.start_s - t0,
                                    sp.start_s, request_id=req.request_id)
                            self._admit(req, slot, span)
                        if len(self._slot_out[slot]) >= req.max_new_tokens:
                            # max_new_tokens == 1
                            done.append(self._retire(slot, span))

            # 2) one decode step for all active slots (free slots ride along
            # and are overwritten by the next admission's prefill)
            active = self.active_slots()
            if active:
                with span("engine.decode", active_slots=len(active)):
                    tok = torch.as_tensor(self._pending, dtype=torch.long,
                                          device=self.device)
                    pos = torch.as_tensor(self._slot_pos, dtype=torch.long,
                                          device=self.device)
                    logits, self.cache = steps.decode_step(
                        self.params, self.cache, {"token": tok, "pos": pos},
                        self.cfg, self.opts, graph=self._decode_graph)
                with span("engine.readback"):
                    nxt = _argmax(logits)
                self.stats["decode_steps"] += 1
                self._occupancy_sum += len(active) / self.max_slots
                for s in active:
                    self._slot_pos[s] += 1
                    self._slot_out[s].append(int(nxt[s]))
                    self._pending[s] = nxt[s]
                    self.stats["tokens_generated"] += 1
                    self._count_stream_token(self._slot_req[s])
                    if len(self._slot_out[s]) >= \
                            self._slot_req[s].max_new_tokens:
                        done.append(self._retire(s, span))

            self.stats["wall_s"] += time.monotonic() - t0
            self._mark_windows(clock0, self.stats["wall_s"])
        return done

    def drain(self) -> list[Request]:
        done: list[Request] = []
        while self.queue or self.active_slots():
            done.extend(self.step())
        return done

    # -- reporting -----------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the counters, the graph's replays among them, and latency
        records (e.g. after a warmup)."""
        super().reset_stats()
        if self._decode_graph is not None:
            self._decode_graph.replays = 0
        self._latencies = []
        self._slo_hits = 0
        self._occupancy_sum = 0.0
        self._dense0 = _dense_flops()

    def report(self) -> dict:
        """SLO attainment, latency percentiles, slot occupancy, the share
        of decode steps replayed from the CUDA graph, and the share of the
        FLOPs of fp32 CUDA products of at least ``dense_gemm.MIN_ROWS`` rows
        (in this process, since the counters were zeroed) that ran on the
        split-TF32 kernel (0 where there were none). With no
        completed requests the latency fields *and* ``slo_attainment`` are
        ``None`` and the counters are zero; the report never raises."""
        lat = sorted(self._latencies)
        n = len(lat)

        def pct(p: float) -> Optional[float]:
            if not lat:
                return None
            return lat[min(n - 1, max(0, int(np.ceil(p * n)) - 1))]

        steps_ = self.stats["decode_steps"]
        taken, declined = (now - then for now, then in
                           zip(_dense_flops(), self._dense0))
        return {
            "requests": self.stats["requests"],
            "tokens_per_s": self.throughput_tokens_per_s(),
            "slo_attainment": (self._slo_hits / n) if n else None,
            "p50_latency_s": pct(0.50),
            "p99_latency_s": pct(0.99),
            "slot_occupancy": (self._occupancy_sum / steps_) if steps_ else 0.0,
            "decode_graph_share": (self._decode_graph.replays / steps_)
            if steps_ and self._decode_graph is not None else 0.0,
            "dense_kernel_share": (taken / (taken + declined))
            if taken + declined else 0.0,
        }


def _dense_flops() -> tuple[int, int]:
    """The split-TF32 kernel's FLOPs taken and declined, so far."""
    return _dg.dense_gemm.flops_taken, _dg.dense_gemm.flops_declined


class StreamSimulator:
    """Camera streams enqueueing fixed-size frame requests at a frame rate.

    Works with either engine (both expose submit/drain/cfg)."""

    def __init__(self, engine, prompt_len: int = 32,
                 new_tokens: int = 8, vocab: Optional[int] = None,
                 seed: int = 0):
        self.engine = engine
        self.prompt_len = prompt_len
        self.new_tokens = new_tokens
        self.vocab = vocab or engine.cfg.vocab_size
        self.rng = np.random.default_rng(seed)
        self.frame_count = 0
        self._accum: dict[str, float] = {}

    def tick(self, streams_fps: dict[str, float], dt_s: float = 1.0) -> int:
        """Enqueue dt_s worth of frames for each stream at its fps.
        Fractional frames accumulate across ticks. Each frame carries a
        1/fps latency budget, which the engine uses for EDF ordering and
        SLO accounting."""
        n = 0
        for sid, fps in streams_fps.items():
            acc = self._accum.get(sid, 0.0) + fps * dt_s
            frames = int(acc)
            self._accum[sid] = acc - frames
            budget = (1.0 / fps) if fps > 0 else float("inf")
            for _ in range(frames):
                toks = self.rng.integers(
                    0, self.vocab, self.prompt_len).astype(np.int32)
                self.engine.submit(Request(
                    request_id=f"{sid}-f{self.frame_count}",
                    tokens=toks, max_new_tokens=self.new_tokens,
                    stream_id=sid, deadline_s=budget))
                self.frame_count += 1
                n += 1
        return n
