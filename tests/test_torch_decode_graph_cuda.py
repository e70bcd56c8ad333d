"""The continuous-batching engine's decode step replayed from its CUDA graph
(``steps.DecodeGraph``) against the same engine decoding eagerly, on the
card: reduced olmo-1b, mamba2-2.7b, granite-4.0-h-small (widened to the
grouped expert kernels' multiples of 64), recurrentgemma-9b (ring cache,
fused RG-LRU kernel in decode), yi-9b and qwen3-moe-30b-a3b (capacity
routing). Slots are admitted and retired between steps. Every test here
needs a CUDA device of compute capability >= 9.0 (Hopper) and skips
without one; this file imports no jax:

    python -m pytest -q tests/test_torch_decode_graph_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_experts as me  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe, steps  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine, Request  # noqa: E402

ARCHS = ["olmo-1b", "mamba2-2.7b", "granite-4.0-h-small",
         "recurrentgemma-9b", "yi-9b", "qwen3-moe-30b-a3b"]
SLOTS, CACHE_LEN = 3, 48
COUNTERS = (fa.flash_attention, fa.flash_attention_bwd, me.moe_experts,
            rg.rglru_scan, rg.rglru_gated_scan, ssd.ssd_scan)
# the port's device kernels, as a trace names them
DEVICE_KERNELS = ("flash_attention_kernel", "flash_attention_bwd",
                  "moe_grouped_kernel", "rglru_scan_kernel",
                  "rglru_gated_scan_kernel", "ssd_scan_kernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA GPU of compute capability >= 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(arch, device):
    cfg = get_config(arch, reduced=True)
    if arch == "granite-4.0-h-small":
        # widths of 64, which the grouped expert kernels take
        cfg = dataclasses.replace(cfg, d_model=128, head_dim=32,
                                  moe_d_ff=64, experts_held=4)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    device=device)
    return cfg, params


def _engine(cfg, params, graph=True):
    eng = ContinuousBatchingEngine(cfg, params, max_slots=SLOTS,
                                   cache_len=CACHE_LEN)
    if not graph:
        eng._decode_graph = None         # the eager twin
    return eng


def _counts():
    return [f.launches for f in COUNTERS]


def _device_launches(prof) -> dict:
    out = dict.fromkeys(DEVICE_KERNELS, 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in DEVICE_KERNELS:
                out[name] += name in e.name
    return out


def _serve(eng, cfg, monkeypatch):
    """Seven requests of 6-12 tokens, 3-6 answered each, through ``SLOTS``
    slots, under ``torch.profiler``. Returns (outputs by request, each
    decode step's logits stacked, the wrappers' calls over the drain, those
    inside its decode steps, the port's kernels that ran on the card by
    the trace)."""
    logits, in_decode = [], [0] * len(COUNTERS)
    plain = steps.decode_step

    def recorded(*args, **kw):
        before = _counts()
        out, cache = plain(*args, **kw)
        in_decode[:] = [d + n - b for d, n, b in
                        zip(in_decode, _counts(), before)]
        logits.append(out.clone())
        return out, cache
    monkeypatch.setattr(steps, "decode_step", recorded)
    rng = np.random.default_rng(7)
    for i in range(7):
        eng.submit(Request(f"r{i}", rng.integers(0, cfg.vocab_size, 6 + i)
                           .astype(np.int32), max_new_tokens=3 + i % 4))
    before = _counts()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        done = {r.request_id: r.output for r in eng.drain()}
        torch.cuda.synchronize()
    calls = [n - b for n, b in zip(_counts(), before)]
    monkeypatch.setattr(steps, "decode_step", plain)
    return (done, torch.stack(logits), calls, in_decode,
            _device_launches(prof))


@pytest.mark.parametrize("arch", ARCHS)
def test_replay_serves_what_the_eager_step_serves(cuda, arch, monkeypatch):
    """Equal tokens, bit-equal logits at every decode step, and the same
    port kernels run on the card, by a trace of each drain. A replay calls
    no wrapper: the graphed drain's wrapper calls are the eager twin's
    outside its decode steps, and building the graph (the warm-up step and
    the capture) calls each wrapper twice as often as one eager step and
    leaves the cache zero. In the MoE models the routing of the eager
    twin's decode steps moves from step to step, so the replay recomputes
    it."""
    cfg, params = _model(arch, cuda)
    before = _counts()
    graphed = _engine(cfg, params)
    built = [n - b for n, b in zip(_counts(), before)]
    assert graphed._decode_graph is not None
    assert all(torch.count_nonzero(t) == 0 for layer in graphed.cache
               for t in layer.values())
    out_g, logits_g, calls_g, in_decode_g, device_g = _serve(
        graphed, cfg, monkeypatch)

    routes = []
    plain_route = moe._route

    def route(router, x, cfg_):
        out = plain_route(router, x, cfg_)
        if x.shape[0] == SLOTS and len(routes) < 64:
            routes.append(out[2].clone())
        return out
    monkeypatch.setattr(moe, "_route", route)
    out_e, logits_e, calls_e, in_decode_e, device_e = _serve(
        _engine(cfg, params, graph=False), cfg, monkeypatch)
    assert set(out_g) == set(out_e) == {f"r{i}" for i in range(7)}
    for k in out_e:
        np.testing.assert_array_equal(out_g[k], out_e[k])
    assert logits_g.shape == logits_e.shape
    assert torch.equal(logits_g, logits_e)
    assert device_g == device_e
    assert any(device_g.values())
    n = graphed.stats["decode_steps"]
    assert n == logits_g.shape[0] and graphed._decode_graph.replays == n
    assert graphed.report()["decode_graph_share"] == 1.0
    assert in_decode_g == [0] * len(COUNTERS)
    assert calls_g == [c - d for c, d in zip(calls_e, in_decode_e)]
    assert [b * n for b in built] == [2 * d for d in in_decode_e]
    if cfg.num_experts:
        assert len({tuple(r.flatten().tolist()) for r in routes}) > 1


@pytest.mark.parametrize("arch", ARCHS)
def test_a_replay_does_not_synchronise(cuda, arch):
    """A replayed step (inputs on the card) makes no synchronising call, and
    returns logits that the next replay does not overwrite."""
    cfg, params = _model(arch, cuda)
    eng = _engine(cfg, params)
    graph = eng._decode_graph
    tok = torch.arange(SLOTS, device=cuda)
    pos = torch.full((SLOTS,), 5, dtype=torch.long, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, _ = steps.decode_step(params, eng.cache,
                                     {"token": tok, "pos": pos}, cfg,
                                     eng.opts, graph=graph)
        second, _ = steps.decode_step(params, eng.cache,
                                      {"token": tok + 1, "pos": pos + 1},
                                      cfg, eng.opts, graph=graph)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert graph.replays == 2
    kept = first.clone()
    torch.cuda.synchronize()
    assert torch.equal(first, kept) and not torch.equal(first, second)


def test_other_inputs_run_eagerly(cuda):
    """An int position, a foreign cache and flipped TF32 flags each run the
    eager step, and the engine counts such a step as eager."""
    cfg, params = _model("olmo-1b", cuda)
    eng = _engine(cfg, params)
    graph = eng._decode_graph
    tok = torch.arange(SLOTS, device=cuda)
    pos = torch.full((SLOTS,), 4, dtype=torch.long, device=cuda)
    steps.decode_step(params, eng.cache, {"token": tok, "pos": 4}, cfg,
                      eng.opts, graph=graph)
    assert graph.replays == 0
    other = M.init_cache(cfg, SLOTS, CACHE_LEN, torch.float32, eng.opts,
                         device=cuda)
    twin = M.init_cache(cfg, SLOTS, CACHE_LEN, torch.float32, eng.opts,
                        device=cuda)
    got, _ = steps.decode_step(params, other, {"token": tok, "pos": pos},
                               cfg, eng.opts, graph=graph)
    want, _ = M.decode_step(params, tok, pos, twin, cfg, eng.opts)
    assert graph.replays == 0 and torch.equal(got, want)

    for c in eng.cache:
        for t in c.values():
            t.zero_()
    eng.submit(Request("r0", np.arange(6, dtype=np.int32),
                       max_new_tokens=4))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        eng.step()                      # a prefill, then an eager step
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert eng.stats["decode_steps"] == 1 and graph.replays == 0
    eng.step()                          # the flags as captured: a replay
    assert eng.stats["decode_steps"] == 2 and graph.replays == 1
    assert eng.report()["decode_graph_share"] == 0.5
