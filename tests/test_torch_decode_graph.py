"""The continuous-batching engine's decode graph on the CPU: what
``steps.decode_step`` does with and without one, which inputs a
``DecodeGraph`` takes for a replay, and the engine's replay counter, which
reads 0 here because the CPU has no CUDA graph. The replay itself is held
against the eager step on the card in ``test_torch_decode_graph_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine, Request  # noqa: E402

SLOTS, CACHE_LEN = 3, 32


@pytest.fixture(scope="module")
def model():
    cfg = get_config("olmo-1b", reduced=True)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    return cfg, params, M.ModelOptions(remat=False)


def _cache(model, seed=1):
    """A filled cache: each slot prefilled with its own prompt."""
    cfg, params, opts = model
    cache = M.init_cache(cfg, SLOTS, CACHE_LEN, torch.float32, opts,
                         device="cpu")
    g = torch.Generator().manual_seed(seed)
    for s in range(SLOTS):
        toks = torch.randint(0, cfg.vocab_size, (1, 5 + s), generator=g)
        steps.prefill_into_slot_step(params, cache, {"tokens": toks}, s, cfg,
                                     opts, CACHE_LEN)
    return cache


def _batch(cfg):
    return {"token": torch.tensor([3, 1, 4]) % cfg.vocab_size,
            "pos": torch.tensor([5, 6, 7])}


def _copy(cache):
    return [{k: t.clone() for k, t in layer.items()} for layer in cache]


def _graph(params, cache, slots=SLOTS):
    """A ``DecodeGraph`` as capture leaves it, without the capture (which
    needs the card): what ``takes`` reads."""
    g = object.__new__(steps.DecodeGraph)
    g.params = params
    g.token = torch.zeros(slots, dtype=torch.long)
    g.pos = torch.zeros(slots, dtype=torch.long)
    g._storage, g._flags = steps._cache_storage(cache), steps._tf32()
    return g


def test_decode_step_without_a_graph_is_the_eager_step(model):
    cfg, params, opts = model
    a, b = _cache(model), _cache(model)
    got, out = steps.decode_step(params, a, _batch(cfg), cfg, opts,
                                 graph=None)
    want, _ = M.decode_step(params, _batch(cfg)["token"], _batch(cfg)["pos"],
                            b, cfg, opts)
    assert torch.equal(got, want)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(out, b) for k in x)
    assert all(o[k] is c[k] for o, c in zip(out, a) for k in c)


class _Fake:
    """A graph whose ``takes`` answers as told and whose replay returns a
    marker, so that ``decode_step``'s choice shows."""

    def __init__(self, takes: bool):
        self.answer, self.replayed = takes, []
        self.logits = torch.full((SLOTS, 7), 2.5)

    def takes(self, params, cache, batch):
        return self.answer

    def replay(self, token, pos):
        self.replayed.append((token, pos))
        return self.logits.clone()


def test_decode_step_replays_only_what_the_graph_takes(model):
    cfg, params, opts = model
    cache = _cache(model)
    batch = _batch(cfg)
    yes = _Fake(True)
    logits, out = steps.decode_step(params, cache, batch, cfg, opts,
                                    graph=yes)
    assert out is cache and torch.equal(logits, yes.logits)
    assert logits is not yes.logits
    assert yes.replayed == [(batch["token"], batch["pos"])]
    no = _Fake(False)
    before = _copy(cache)
    logits, _ = steps.decode_step(params, cache, batch, cfg, opts, graph=no)
    want, _ = M.decode_step(params, batch["token"], batch["pos"], before, cfg,
                            opts)
    assert no.replayed == [] and torch.equal(logits, want)


def test_graph_takes_only_its_own_input(model):
    cfg, params, opts = model
    cache = _cache(model)
    g = _graph(params, cache)
    batch = _batch(cfg)
    assert g.takes(params, cache, batch)
    # an int position (the static engine's lock step)
    assert not g.takes(params, cache, {**batch, "pos": 5})
    # another batch size
    assert not g.takes(params, cache, {"token": batch["token"][:2],
                                       "pos": batch["pos"][:2]})
    # a foreign cache, or one tensor of the cache replaced
    assert not g.takes(params, _cache(model), batch)
    swapped = [dict(layer) for layer in cache]
    swapped[-1]["v"] = swapped[-1]["v"].clone()
    assert not g.takes(params, swapped, batch)
    # the same tensors in another list: still the engine's cache
    assert g.takes(params, [dict(layer) for layer in cache], batch)
    # other parameters, even equal ones
    assert not g.takes(dict(params), cache, batch)
    # the TF32 flags flipped since the capture
    flags = steps._tf32()
    try:
        torch.backends.cuda.matmul.allow_tf32 = not flags[0]
        assert not g.takes(params, cache, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
    assert g.takes(params, cache, batch)


def test_cpu_engine_reports_no_replay_and_resets_the_counter(model):
    cfg, params, _ = model
    eng = ContinuousBatchingEngine(cfg, params, max_slots=SLOTS,
                                   cache_len=CACHE_LEN)
    assert eng._decode_graph is None
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.submit(Request(f"r{i}", rng.integers(0, cfg.vocab_size, 6)
                           .astype(np.int32), max_new_tokens=3 + i % 2))
    done = eng.drain()
    assert len(done) == 4 and eng.stats["decode_steps"] > 0
    assert "decode_graph_replays" not in eng.stats
    assert eng.report()["decode_graph_share"] == 0.0
    # a graph's replays, as the card's leave them: the one counter the
    # report reads and reset_stats zeroes
    eng._decode_graph = _graph(params, eng.cache)
    eng._decode_graph.replays = 2
    assert eng.report()["decode_graph_share"] == \
        2 / eng.stats["decode_steps"]
    eng.reset_stats()
    assert eng._decode_graph.replays == 0
    assert eng.report()["decode_graph_share"] == 0.0
