"""granite-4.0-h-small on the port, at the reduced size on the CPU, against
the plain reference ``tests/plain_ref/granite_hybrid_lm.py`` on seeded
random weights: the full forward's logits, prefill then decode through the
continuous-batching engine, the dropless MoE where the capacity form would
drop, the four expert shares adding up to the uncut layer, attention
without RoPE at the configured scale, the parameter counts, and the two
references' imports. No JAX: the reference package has no such block.

Tolerances: the port and the reference compute the same fp32 values in
other orders (the chunked SSD scan against the quadratic dual form, each
token's K experts summed in k order against a scatter-add by expert, the
shared expert added at another point), so they agree to fp32 rounding
grown over the layers, not bit for bit. Relative to the largest logit (or
output) that is ~1e-6 here; the limits allow 1e-4. The routing takes the
same experts on both sides: each test holds the reference's count of
near-tied routing decisions at 0 (a tie within 1e-5 could flip one).
"""
import ast
import dataclasses
import math
from pathlib import Path

import pytest
import torch

from plain_ref import granite_hybrid_lm as ref
from repro_torch import checkpoint
from repro_torch.kernels import ref as kref
from repro_torch.models import model as M
from repro_torch.models import moe, steps
from repro_torch.models.config import get_config
from repro_torch.serving import ContinuousBatchingEngine, Request

ARCH = "granite-4.0-h-small"
ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4          # of the largest |value|: fp32 sums in other orders


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH, reduced=True)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    return cfg, params


def as_dict(cfg):
    return dataclasses.asdict(cfg)


def close(got, want, rtol=RTOL):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rtol * scale, (err, scale)


def tokens(cfg, shape, seed):
    return torch.randint(0, cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(seed))


def reference(params, toks, cfg, held=None):
    ref.ROUTING.update(decisions=0, near_ties=0)
    with torch.no_grad():
        out = ref.forward(params, toks, as_dict(cfg), held)
    assert ref.ROUTING["near_ties"] == 0, ref.ROUTING
    return out


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "plain"])
def test_full_forward_logits_match_the_reference(model, use_kernels):
    cfg, params = model
    toks = tokens(cfg, (2, 37), 1)
    opts = M.ModelOptions(use_kernels=use_kernels, remat=False)
    with torch.no_grad():
        h, aux = M.forward_hidden(params, {"tokens": toks}, cfg, opts)
        got = M.logits_of(params, h, cfg)
    close(got, reference(params, toks, cfg))
    assert aux.item() > 0.0           # the load-balance loss, for training


def test_loss_fn_takes_the_dropless_aux(model):
    cfg, params = model
    toks = tokens(cfg, (2, 17), 2)
    total, m = M.loss_fn(params, {"tokens": toks[:, :-1],
                                  "labels": toks[:, 1:]}, cfg,
                         M.ModelOptions(use_kernels=False, remat=False))
    assert math.isfinite(total.item()) and m["aux_loss"].item() > 0.0
    assert total.item() == pytest.approx(
        m["ce_loss"].item() + M.MOE_AUX_WEIGHT * m["aux_loss"].item())


def test_engine_prefill_then_decode_match_the_full_forward(model,
                                                           monkeypatch):
    """Two requests of other lengths through ContinuousBatchingEngine: the
    logits the steps return at the prefill and at each of 8 decode steps
    against the reference's full forward over the prompt and the served
    tokens."""
    cfg, params = model
    got = {}
    prefill, decode = steps.prefill_into_slot_step, steps.decode_step
    engine = ContinuousBatchingEngine(cfg, params, max_slots=3, cache_len=48)

    def captured_prefill(p, cache, batch, slot, *a, **k):
        logits, cache = prefill(p, cache, batch, slot, *a, **k)
        got[slot] = [logits]
        return logits, cache

    def captured_decode(p, cache, batch, *a, **k):
        logits, cache = decode(p, cache, batch, *a, **k)
        for slot, req in enumerate(engine._slot_req):
            if req is not None:
                got[slot].append(logits[slot])
        return logits, cache
    monkeypatch.setattr(steps, "prefill_into_slot_step", captured_prefill)
    monkeypatch.setattr(steps, "decode_step", captured_decode)
    prompts = {"a": tokens(cfg, (21,), 3), "b": tokens(cfg, (30,), 4)}
    for rid, p in prompts.items():
        engine.submit(Request(rid, p.numpy(), max_new_tokens=9))
    done = {r.request_id: r for r in engine.drain()}
    by_slot = {0: "a", 1: "b"}
    for slot, rid in by_slot.items():
        served = torch.as_tensor(done[rid].output)
        assert len(served) == 9 and len(got[slot]) == 9  # prefill + 8 steps
        seq = torch.cat([prompts[rid], served[:-1]])[None]
        want = reference(params, seq, cfg)[0, len(prompts[rid]) - 1:]
        close(torch.stack(got[slot]), want)
        assert torch.equal(served, want.argmax(-1))


def test_serving_steps_leave_the_aux_loss_out(model, monkeypatch):
    """A serving prefill and decode step compute no load-balance aux loss
    in their dropless layers (no request needs it); the full forward
    computes it once a layer, for ``loss_fn``."""
    cfg, params = model
    calls = []
    stats = moe._expert_stats
    monkeypatch.setattr(moe, "_expert_stats",
                        lambda *a: calls.append(1) or stats(*a))
    opts = M.ModelOptions()
    batch = {"tokens": tokens(cfg, (1, 12), 3)}
    logits, cache = M.prefill(params, batch, cfg, opts, cache_len=16)
    M.decode_step(params, logits.argmax(-1), 12, cache, cfg, opts)
    assert not calls
    _, aux = M.forward_hidden(params, batch, cfg, opts)
    assert len(calls) == sum(f == "moe" for _, f in cfg.layer_kinds)
    assert aux.item() > 0.0


def test_dropless_where_the_capacity_form_would_drop(model):
    """A router that sends every token to experts 0..K-1: each takes all T
    entries, past the capacity form's C; the dropless layer keeps them all
    and equals the reference."""
    cfg, params = model
    layer = {k: v.clone() for k, v in params["layers"][0]["ffn"].items()
             if k != "shared"} | {"shared": params["layers"][0]["ffn"]
                                  ["shared"]}
    D, K = cfg.d_model, cfg.experts_per_token
    g = torch.Generator().manual_seed(5)
    v = torch.randn(D, generator=g)
    v = v / v.norm()
    layer["router"][:, :K] += 30.0 * torch.linspace(1.0, 1.5, K)[None] \
        * v[:, None]
    x = torch.randn(3, 11, D, generator=g) + 3.0 * v
    T = x.shape[0] * x.shape[1]
    C = moe.capacity(T, dataclasses.replace(cfg, capacity_factor=1.25))
    _, _, top_ids = moe._route(layer["router"], x.reshape(T, D), cfg)
    assert set(top_ids.unique().tolist()) == set(range(K)) and T > C
    with torch.no_grad():
        got, _ = moe.apply_moe_dropless(layer, x, cfg)
        want = ref.moe(layer, x, as_dict(cfg))
        dropped, _ = moe.apply_moe(layer, x, dataclasses.replace(
            cfg, capacity_factor=1.25))
    close(got, want)
    routed = want - ref.swiglu(layer["shared"], x)
    # the capacity form (no shared expert) drops entries: far from it
    assert (dropped - routed).abs().max() > 0.1 * routed.abs().max()


def test_four_shares_add_up_to_the_uncut_layer(model):
    """The experts split into four equal shares, as four devices hold
    them: the shares' outputs, the shared expert counted once, add up to
    the reference's uncut layer."""
    cfg, params = model
    layer = params["layers"][1]["ffn"]
    E = cfg.num_experts
    x = torch.randn(2, 13, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    shared = ref.swiglu(layer["shared"], x)
    total = torch.zeros_like(x)
    with torch.no_grad():
        for first in range(0, E, E // 4):
            share = {k: layer[k][first:first + E // 4]
                     for k in ("w1", "w2", "w3")}
            share |= {"router": layer["router"], "shared": layer["shared"]}
            part, _ = moe.apply_moe_dropless(share, x, cfg,
                                             experts=(first, E // 4))
            total += part - shared
            close(part, ref.moe(share, x, as_dict(cfg), (first, E // 4)))
        total += shared
        close(total, ref.moe(layer, x, as_dict(cfg)))


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "einsum"])
def test_attention_without_rope_at_the_configured_scale(model, use_flash):
    """attention_full and the decode step's attention (no RoPE, softmax
    scale attention_multiplier = 1/hd, not 1/sqrt(hd)) against the
    reference's attention; RoPE or the default scale would not match."""
    from repro_torch.models import layers
    cfg, params = model
    p = params["layers"][1]["mixer"]
    x = torch.randn(1, 19, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    want = ref.attention(p, x, as_dict(cfg))
    with torch.no_grad():
        got, (k, v) = layers.attention_full(p, x, cfg, use_flash=use_flash)
        close(got, want)
        ck = torch.zeros(1, 24, cfg.num_kv_heads, cfg.head_dim)
        cv = torch.zeros_like(ck)
        ck[:, :18], cv[:, :18] = k[:, :18], v[:, :18]
        last, _, _ = layers.attention_decode(p, x[:, 18:], ck, cv, 18, cfg)
        close(last, want[:, 18:])
        for other in (dataclasses.replace(cfg, rope=True),
                      dataclasses.replace(cfg, attention_multiplier=0.0)):
            wrong, _ = layers.attention_full(p, x, other, use_flash=use_flash)
            assert (wrong - want).abs().max() > 1e-3 * want.abs().max()


def test_param_counts_of_the_full_config():
    cfg = get_config(ARCH)
    whole = dataclasses.replace(cfg, experts_held=0)
    assert whole.param_count() == 32_207_337_984
    assert cfg.param_count() == 11_823_020_544          # 18 of 72 held
    # active: the 10 routed of 72 whole; 10 x 18/72 = 2.5 of those held
    assert whole.active_param_count() == 8_803_121_664
    assert cfg.active_param_count() == 5_971_966_464
    shapes = checkpoint.param_shapes(cfg)
    n = sum(math.prod(s) for s in _leaves(shapes))
    assert n == cfg.param_count()
    assert shapes["layers"][0]["ffn"]["w1"] == (18, 4096, 768)
    assert shapes["layers"][0]["ffn"]["router"] == (4096, 72)
    assert [k for k, _ in cfg.layer_kinds[:10]] == ["ssd"] * 5 + ["attn"] \
        + ["ssd"] * 4


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_other_configs_keep_their_eps_and_multipliers():
    """The new fields default to what every other config did: mamba2-2.7b's
    gated norm keeps eps 1e-6, so its logits do not move."""
    for arch in ("mamba2-2.7b", "olmo-1b", "qwen3-moe-30b-a3b"):
        cfg = get_config(arch)
        assert (cfg.ssm_norm_eps, cfg.rms_norm_eps) == (1e-6, 1e-6)
        assert (cfg.embedding_multiplier, cfg.residual_multiplier,
                cfg.attention_multiplier, cfg.logits_scaling) == \
            (1.0, 1.0, 0.0, 1.0)
        assert cfg.rope and cfg.held_experts == cfg.num_experts
        assert cfg.moe_shared_d_ff == 0


def test_sorted_entries_and_the_plain_grouped_product():
    """``_sort_held``: the held entries sorted by expert, each expert's end
    row, each entry's sorted row (T·K for one held elsewhere); the plain
    grouped product over them against a loop over entries."""
    g = torch.Generator().manual_seed(8)
    top_ids = torch.randint(0, 12, (9, 3), generator=g)
    rows, ends, pos = moe._sort_held(top_ids, 4, 5)
    flat = top_ids.reshape(-1)
    held = (flat >= 4) & (flat < 9)
    assert ends.tolist() == torch.cumsum(torch.bincount(
        flat[held] - 4, minlength=5), 0).tolist()
    for i in range(flat.numel()):
        if held[i]:
            e = int(flat[i]) - 4
            assert (ends[e - 1] if e else 0) <= pos[i] < ends[e]
            assert rows[pos[i]] == i // 3
        else:
            assert pos[i] == flat.numel()
    x = torch.randn(9, 8, generator=g)
    w1, w3 = torch.randn(5, 8, 6, generator=g), torch.randn(5, 8, 6,
                                                            generator=g)
    w2 = torch.randn(5, 6, 8, generator=g)
    y = kref.moe_experts_ref(x, rows, ends, w1, w3, w2)
    assert y.shape == (28, 8) and not y[ends[-1]:].any()
    for i in range(flat.numel()):
        if held[i]:
            e, t = int(flat[i]) - 4, i // 3
            want = (torch.nn.functional.silu(x[t] @ w1[e]) *
                    (x[t] @ w3[e])) @ w2[e]
            torch.testing.assert_close(y[pos[i]], want)


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names - {"__future__", "math"}


@pytest.mark.parametrize("path, allowed", [
    ("tests/plain_ref/granite_hybrid_lm.py", {"torch"}),
    ("portbench/reference/granite_hybrid_lm.py", {"torch", "reference"}),
])
def test_references_import_only_torch(path, allowed):
    """Whole top-level module names (``repro_torch`` is not ``repro``); the
    benchmark's copy may import ``reference.common`` beside torch."""
    got = _top_level_imports(ROOT / path)
    assert got <= allowed, got
    assert "torch" in got
    if "reference" in got:
        tree = ast.parse((ROOT / path).read_text())
        mods = {n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.module
                and n.module.startswith("reference")}
        assert mods == {"reference.common"}
