"""The harness's spans and the reading of a device trace.

A span is the harness's own: around a call into the program (a module
attribute it wraps for the run, such as a kernel's entry or a step
function), or around its own loop and window. Each call is kept with its
host times and a description of its arguments (shapes, dtypes, scalars),
so that a metric's reader can work out the call's operations and bytes.

In a traced run every span is also a ``torch.profiler.record_function``
range, and ``read_events`` takes from the raw trace: the device time of
every kernel, copy or fill launched inside each span (by the host call
that launched it, not by the kernel's name), the
device's busy time over the window, the device operations that took most
time, and the device's idle gaps by the innermost span the host was in.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import itertools
import re
import time

import torch

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cuda_runtime", "cuda_driver")
PREFIX = "pb/"
RUNTIME = re.compile(r"cu(da)?[A-Z]")     # cudaLaunchKernel, cuLaunchKernel
_ids = itertools.count()


class Call:
    """One call inside a span: its profiler range's name, the description
    of its arguments, its host times and the device time launched inside
    it (filled from the trace)."""
    __slots__ = ("mark", "info", "t0", "t1", "device_s")

    def __init__(self, name: str, info: dict):
        self.info = info
        self.mark = f"{PREFIX}{name}/{next(_ids)}"
        self.t0 = self.t1 = 0.0
        self.device_s = None


def describe(args, kwargs) -> dict:
    """Shapes of tensor arguments, scalars as they are, the first tensor's
    dtype."""
    dtype = None

    def one(a):
        nonlocal dtype
        if isinstance(a, torch.Tensor):
            dtype = dtype or str(a.dtype).replace("torch.", "")
            return tuple(a.shape)
        if isinstance(a, (bool, int, float, str)) or a is None:
            return a
        return type(a).__name__
    return {"args": [one(a) for a in args],
            "kwargs": {k: one(v) for k, v in kwargs.items()}, "dtype": dtype}


class Spans:
    """The spans of one run. ``profiling`` makes each a profiler range."""

    def __init__(self, profiling: bool, sync=None):
        self.profiling = profiling
        self.sync = sync or (lambda: None)
        self.calls: dict[str, list[Call]] = collections.defaultdict(list)
        self._restore = []

    @contextlib.contextmanager
    def span(self, name: str, info: dict | None = None, sync: bool = False):
        call = Call(name, info or {})
        rf = (torch.profiler.record_function(call.mark) if self.profiling
              else contextlib.nullcontext())
        with rf:
            call.t0 = time.perf_counter()
            try:
                yield call
            finally:
                if sync:
                    self.sync()
                call.t1 = time.perf_counter()
        self.calls[name].append(call)

    def wrap(self, name: str, target: str, sync: bool = False) -> None:
        """Put a span named ``name`` around every call of ``target``
        ("module:attribute") until ``restore``."""
        mod_name, attr = target.split(":")
        module = importlib.import_module(mod_name)
        orig = getattr(module, attr)

        @functools.wraps(orig)
        def spanned(*args, **kwargs):
            with self.span(name, describe(args, kwargs), sync):
                return orig(*args, **kwargs)
        setattr(module, attr, spanned)
        self._restore.append((module, attr, orig, spanned))

    def restore(self) -> None:
        """Put the program's entries back, with what the run changed of
        their attributes (such as a kernel's launch counter)."""
        while self._restore:
            module, attr, orig, spanned = self._restore.pop()
            setattr(module, attr, orig)
            orig.__dict__.update({k: v for k, v in spanned.__dict__.items()
                                  if k != "__wrapped__"})

    def between(self, name: str, t0: float, t1: float) -> list:
        """The calls of ``name`` that began inside [t0, t1]."""
        return [c for c in self.calls.get(name, []) if t0 <= c.t0 <= t1]


def _label(mark: str) -> str:
    return mark[len(PREFIX):].rsplit("/", 1)[0]


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def kind_of(e) -> str:
    """An event's kineto activity type; torch releases whose events do not
    say it are read by the device and the name: on the device, fills,
    copies, the harness's ranges and kernels; on the host, the harness's
    ranges, CUDA runtime and driver calls, and operators."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if e.device_type() != torch.autograd.DeviceType.CPU:
        if name.startswith(PREFIX):
            return "gpu_user_annotation"
        low = name.lower()
        return ("gpu_memcpy" if low.startswith("memcpy") else "gpu_memset"
                if low.startswith("memset") else "kernel")
    if name.startswith(PREFIX):
        return "user_annotation"
    return "cuda_runtime" if RUNTIME.match(name) else "cpu_op"


class Profiler:
    """torch's kineto profiler recording the harness's ranges and no
    operator (recording every operator slows a host-paced path several
    times over), with the CUDA runtime's calls and the device's work on a
    card. Its events are read raw: the profiler's own parse is never run."""

    def __init__(self, cuda: bool):
        from torch._C._profiler import ProfilerActivity
        self.cuda = cuda
        self.activities = {ProfilerActivity.CPU} | (
            {ProfilerActivity.CUDA} if cuda else set())
        self.events = []

    def start(self) -> None:
        from torch._C._profiler import RecordScope, _ExperimentalConfig
        from torch.autograd import (ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        _prepare_profiler(config, self.activities)
        _enable_profiler(config, self.activities, {RecordScope.USER_SCOPE})

    def stop(self) -> None:
        from torch.autograd import _disable_profiler
        if self.cuda:
            torch.cuda.synchronize()
        self.events = _disable_profiler().events()


def read_events(events, spans: Spans, window_mark: str) -> dict:
    """Every span call's ``device_s``, and {busy_s, window_s, device_ops,
    idle_gaps} over the span ``window_mark``, from kineto's events."""
    marks, launches, work = {}, {}, []
    kinds = collections.Counter()
    for e in events:
        kind = kind_of(e)
        kinds[kind] += 1
        if kind in DEVICE_WORK:
            work.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name(), e.correlation_id()))
        elif kind in LAUNCHES:
            launches[e.correlation_id()] = e.start_ns()
        elif kind == "user_annotation" and e.name().startswith(PREFIX):
            marks[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.start_thread_id())
    if window_mark not in marks:
        raise RuntimeError(f"the trace holds no span {window_mark}")
    ws, we, main = marks[window_mark]

    # device time launched inside each span: by the time of the host call
    # that launched it (the program launches from one thread at a time:
    # the backward's thread while the caller's waits for it)
    timeline = [(s, 0, m) for m, (s, e, tid) in marks.items()]
    timeline += [(e, 2, m) for m, (s, e, tid) in marks.items()]
    timeline += [(launches[corr], 1, i)
                 for i, (_, _, _, corr) in enumerate(work) if corr in launches]
    timeline.sort(key=lambda x: (x[0], x[1]))
    inside = collections.Counter()
    active = []
    for _, kind, x in timeline:
        if kind == 0:
            active.append(x)
        elif kind == 2:
            active.remove(x)
        else:
            d = work[x][1] - work[x][0]
            for m in active:
                inside[m] += d
    for calls in spans.calls.values():
        for c in calls:
            if c.mark in marks:
                c.device_s = inside[c.mark] / 1e9

    # busy time and the device's work by name inside the window
    clipped = sorted((max(s, ws), min(e, we), n) for s, e, n, _ in work
                     if e > ws and s < we)
    by_name = collections.Counter()
    busy, gaps, cur_s, cur_e = 0, [], ws, ws
    for s, e, n in clipped:
        by_name[n] += e - s
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if we > cur_e:
        gaps.append((cur_e, we))

    # each idle gap by the innermost span the host's main thread was in
    items = [(s, 0, m) for m, (s, e, tid) in marks.items() if tid == main]
    items += [(e, 2, m) for m, (s, e, tid) in marks.items() if tid == main]
    items += [((a + b) // 2, 1, b - a) for a, b in gaps]
    items.sort(key=lambda x: (x[0], x[1]))
    idle = collections.Counter()
    stack = []
    for _, kind, x in items:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            stack.remove(x)
        else:
            inner = _label(stack[-1]) if stack else "harness"
            idle["harness" if inner == _label(window_mark) else inner] += x
    by_span = collections.Counter()
    for m, t in inside.items():
        by_span[_label(m)] += t / 1e9
    return {"busy_s": busy / 1e9, "window_s": (we - ws) / 1e9,
            "events": dict(kinds), "device_s_by_span": dict(by_span),
            "device_ops": [[_safe(n), t / 1e9]
                           for n, t in by_name.most_common(10)],
            "idle_gaps": [[n, t / 1e9] for n, t in idle.most_common(10)]}
