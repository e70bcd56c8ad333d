"""The trace reader on kineto-shaped events: device time by the span whose
host call launched it (not by kernel name), busy time over the window, and
idle gaps by the innermost span."""
import pytest
import torch

from harness.trace import Spans, read_events

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    """A kineto event as releases without ``activity_type`` give it."""

    def __init__(self, name, device, start, end, corr=0, tid=1):
        self._v = (name, device, start, end - start, corr, tid)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def start_thread_id(self): return self._v[5]


class Typed(Event):
    def __init__(self, kind, *a, **k):
        super().__init__(*a, **k)
        self.kind = kind

    def activity_type(self): return self.kind


def _spans():
    spans = Spans(False)
    with spans.span("window") as w, spans.span("step") as s, \
            spans.span("flash", {"args": []}) as f, spans.span("bwd") as b:
        pass
    return spans, w.mark, s.mark, f.mark, b.mark


def _events(w, s, f, b, typed):
    ev = [(("user_annotation",), w, CPU, 0, 1000),
          (("user_annotation",), s, CPU, 100, 600),
          (("user_annotation",), f, CPU, 200, 300),
          # the backward's own thread, while the caller's waits
          (("user_annotation",), b, CPU, 350, 390, 0, 2),
          (("cuda_runtime",), "cudaLaunchKernel", CPU, 360, 361, 80, 2),
          (("kernel",), "dq_kernel", CUDA, 500, 520, 80),
          (("cpu_op",), "aten::mm", CPU, 240, 260, 77),     # an op's own id
          (("cuda_runtime",), "cudaLaunchKernel", CPU, 250, 255, 77),
          (("kernel",), "sgemm_kernel", CUDA, 400, 500, 77),
          (("gpu_user_annotation",), f, CUDA, 400, 500),
          (("cuda_runtime",), "cuLaunchKernel", CPU, 700, 705, 78),
          (("kernel",), "elementwise", CUDA, 700, 900, 78),
          (("gpu_memset",), "Memset (Device)", CUDA, 1500, 1600, 79)]
    if typed:
        return [Typed(k[0], *rest) for k, *rest in ev]
    return [Event(*rest) for _, *rest in ev]


@pytest.mark.parametrize("typed", [True, False])
def test_device_time_by_launching_span(typed):
    spans, w, s, f, b = _spans()
    got = read_events(_events(w, s, f, b, typed), spans, w)
    (flash,), (step,), (bwd,) = (spans.calls[n] for n in ("flash", "step",
                                                           "bwd"))
    assert flash.device_s == 100e-9 and bwd.device_s == 20e-9
    assert step.device_s == 120e-9
    assert got["window_s"] == 1000e-9 and got["busy_s"] == 320e-9
    assert [n for n, _ in got["device_ops"]] == ["elementwise",
                                                 "sgemm_kernel", "dq_kernel"]
    idle = dict(got["idle_gaps"])
    assert idle == {"flash": 400e-9, "harness": 280e-9}
