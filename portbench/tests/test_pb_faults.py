"""A run with its timed path broken underneath must come out not correct:
once for each fault a cell can have. The harness's look for a chip is
skipped (the CPU, reduced sizes); the rest of the run is the benchmark's."""
import pytest
import torch

from harness import cell


def _token_altered(mp):
    from repro_torch.serving import engine
    orig = engine._argmax
    mp.setattr(engine, "_argmax", lambda logits: (orig(logits) + 1) % 7)


def _cache_unchanged(mp):
    from repro_torch.models import steps
    orig = steps.decode_step

    def step(params, cache, batch, *a, **k):
        logits, _ = orig(params, [{n: t.clone() for n, t in c.items()}
                                  for c in cache], batch, *a, **k)
        return logits, cache
    mp.setattr(steps, "decode_step", step)


def _half_the_slots(mp):
    from repro_torch.models import steps
    orig = steps.decode_step

    def step(params, cache, batch, *a, **k):
        logits, cache = orig(params, cache, batch, *a, **k)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half], logits[:half]]), cache
    mp.setattr(steps, "decode_step", step)


def _state_unchanged(mp):
    from repro_torch.models import steps
    mp.setattr(steps, "adamw_update",
               lambda params, grads, state, cfg, lr: (
                   params, {**state, "step": state["step"] + 1},
                   {"grad_norm": torch.zeros(())}))


def _half_the_batch(mp):
    from repro_torch.models import model
    orig = model.loss_fn

    def loss(params, batch, *a, **k):
        half = batch["tokens"].shape[0] // 2
        return orig(params, {n: t[:half] for n, t in batch.items()}, *a, **k)
    mp.setattr(model, "loss_fn", loss)


@pytest.mark.parametrize("workload,fault", [
    ("olmo-1b.frames-576", _token_altered),
    ("olmo-1b.frames-576", _cache_unchanged),
    ("olmo-1b.frames-576", _half_the_slots),
    ("mamba2-2.7b.frames-576", _token_altered),
    ("mamba2-2.7b.frames-576", _cache_unchanged),
    ("mamba2-2.7b.frames-576", _half_the_slots),
    ("olmo-1b.train-2k", _state_unchanged),
    ("olmo-1b.train-2k", _half_the_batch),
])
def test_a_broken_timed_path_is_not_correct(workload, fault, tiny_root,
                                            monkeypatch):
    fault(monkeypatch)
    r = cell.run_cell(workload, 77, 1.0, False, root=tiny_root,
                      device="cpu")
    assert r["correct"] is False, r["checks"]
