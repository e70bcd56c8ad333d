"""The plain references against the port's plain path at reduced widths,
and a planted run in a lower precision (TF32, emulated on the CPU) that the
limits must refuse."""
import json

import pytest
import torch

from conftest import PORTBENCH, TINY_CONFIGS
from harness import cell, check, weights
from reference import dense_lm, mamba2_lm
from reference import train as ref_train
from reference.common import Precision, round_tf32

FAMILIES = {"olmo-1b": dense_lm, "mamba2-2.7b": mamba2_lm}


def tiny(name):
    c = json.loads((PORTBENCH / "configs" / f"{name}.json").read_text())
    c.update(TINY_CONFIGS[name])
    return c


def port_logits(c, params, tokens):
    from repro_torch.models import layers
    from repro_torch.models import model as M
    arch = cell.arch_config(c)
    h, _ = M.forward_hidden(params, {"tokens": tokens}, arch,
                            M.ModelOptions(use_kernels=False, remat=False))
    return layers.unembed(params["embed"], h, arch)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_reference_logits_match_the_port(name):
    c, ref = tiny(name), FAMILIES[name]
    params = weights.make(ref.tree(c), 11, "cpu")
    tokens = torch.randint(0, c["vocab_size"], (2, 70),
                           generator=torch.Generator().manual_seed(1))
    want = port_logits(c, params, tokens)
    got = ref.logits_last(params, tokens, 70, c, Precision("fp32"))
    assert torch.allclose(got, want, rtol=2e-5, atol=2e-5 * want.abs().max())


def test_reference_steps_match_the_port():
    from repro_torch.models import model as M
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamWConfig, adamw_init
    c = tiny("olmo-1b")
    o = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
             clip_norm=1.0, warmup=2, total=10, min_ratio=0.1)
    g = torch.Generator().manual_seed(2)
    rows = [torch.randint(0, c["vocab_size"], (2, 33), generator=g)
            for _ in range(3)]
    batches = [(r[:, :-1], r[:, 1:]) for r in rows]
    ref = ref_train.run(dense_lm, weights.make(dense_lm.tree(c), 5, "cpu"),
                        batches, c, o, Precision("fp32"))
    params = weights.make(dense_lm.tree(c), 5, "cpu")
    start = [p.clone() for p in ref_train.leaves(params)]
    topts = ST.TrainOptions(opt=AdamWConfig(**{k: o[k] for k in (
        "lr", "b1", "b2", "eps", "weight_decay", "clip_norm")}),
        schedule_total=o["total"], schedule_warmup=o["warmup"])
    state = {"params": params, "opt": adamw_init(params, topts.opt)}
    prog = {"loss": []}
    for i, (x, y) in enumerate(batches):
        state, m = ST.train_step(state, {"tokens": x, "labels": y},
                                 cell.arch_config(c),
                                 M.ModelOptions(use_kernels=False), topts)
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad1"] = [float(t.double().norm()) / 0.1
                             for t in ref_train.leaves(state["opt"]["m"])]
    prog["delta"] = [float((p - q).double().norm()) for p, q in
                     zip(ref_train.leaves(state["params"]), start)]
    got = check.training_readings(prog, ref)
    assert max(got.values()) < 1e-5, got


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.1])
    r = round_tf32(x)
    assert r[0] == 1.0 + 2**-10 and r[1] == 1.0       # ties to even
    assert r[2] == 1.0 + 2**-9
    assert abs(r[3] + 3.1) <= 3.1 * 2**-11


@pytest.mark.parametrize("workload", ["olmo-1b.frames-576",
                                      "mamba2-2.7b.frames-576"])
def test_lower_precision_fails_the_serving_limits(workload, tiny_root):
    """The control in the program's place, at the reduced sizes: what TF32
    puts first, read against the fp32 reference, fails a limit."""
    ctx, _, _ = cell.context(workload, 3, 1.0, False, root=tiny_root,
                             device="cpu")
    c = ctx.config
    params = weights.make(ctx.ref.tree(c), 3, "cpu")
    g = torch.Generator().manual_seed(4)
    sample = []
    for _ in range(16):
        prompt = torch.randint(0, c["vocab_size"], (120,), generator=g)
        served = torch.randint(0, c["vocab_size"], (4,), generator=g)
        sample.append((prompt.numpy(), served.numpy(), None))
    got = check.serving_control(ctx, params, sample, "tf32")
    assert any(got[k] > ctx.limits[k] for k in ctx.limits), got
