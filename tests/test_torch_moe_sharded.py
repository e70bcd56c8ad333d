"""The MoE sharding forms of the port (``repro_torch.models.moe``):
``apply_moe_local`` (per-sequence dispatch) against the reference's, and
``apply_moe_local`` and ``apply_moe_shard_map`` against global dispatch
at an ample capacity (the port's twins of the reference's
``test_moe_local_dispatch_matches_global`` and
``test_moe_shard_map_matches_global``); ``apply_moe_shard_map`` on a
(1, 2) gloo mesh, the experts split over "model", against the reference's
on its smoke mesh; every form on DTensors (a (2, 1) mesh: tokens split over
"data") against the plain function; the ``ModelOptions`` fields that reach
them. fp32, the reference's tolerance 2e-5; the same weights and inputs
(numpy, seeded) on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch.mesh import make_smoke_mesh as jsmoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from test_torch_dist_train import run_ranks  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "grok-1-314b")


def _cfgs(arch, cf=None):
    jcfg, cfg = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    return jcfg, cfg


def _weights(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    w = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w1": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w2": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if cfg.gated:
        w["w3"] = rng.standard_normal((E, D, F)) / np.sqrt(D)
    return {k: v.astype(np.float32) for k, v in w.items()}


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _port(w, x):
    return ({k: torch.from_numpy(v) for k, v in w.items()},
            torch.from_numpy(x))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [None, 0.5, 8.0], ids=["cf-default", "cf-0.5",
                                                     "cf-8"])
@pytest.mark.parametrize("B,S", [(3, 32), (2, 7)])
def test_apply_moe_local_matches_the_reference(arch, cf, B, S):
    jcfg, cfg = _cfgs(arch, cf)
    w, x = _weights(cfg), _x(cfg, B, S)
    jout, jaux = jmoe.apply_moe({k: jnp.asarray(v) for k, v in w.items()},
                                jnp.asarray(x), jcfg, local_dispatch=True)
    out, aux = moe.apply_moe_local(*_port(w, x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert aux.item() == pytest.approx(float(jaux), abs=2e-5)
    # the option routes there too
    out2, _ = moe.apply_moe(*_port(w, x), cfg, local_dispatch=True)
    assert torch.equal(out, out2)


def test_moe_local_dispatch_matches_global():
    """Per-sequence dispatch equals global dispatch when capacity is ample
    (the same routing, experts and weights)."""
    _, cfg = _cfgs("qwen3-moe-30b-a3b", 8.0)
    p, x = _port(_weights(cfg), _x(cfg, 3, 32))
    o_g, a_g = moe.apply_moe(p, x, cfg)
    o_l, a_l = moe.apply_moe(p, x, cfg, local_dispatch=True)
    np.testing.assert_allclose(o_l.numpy(), o_g.numpy(), atol=1e-6, rtol=1e-6)
    assert a_l.item() == pytest.approx(a_g.item(), abs=1e-6)


def test_expert_shard_constraint_changes_nothing_on_plain_tensors():
    _, cfg = _cfgs("qwen3-moe-30b-a3b")
    p, x = _port(_weights(cfg), _x(cfg, 2, 16))
    a, b = moe.apply_moe(p, x, cfg), moe.apply_moe(
        p, x, cfg, expert_shard_constraint=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_slot_runs_and_expert_shares_partition_global_dispatch():
    """The mesh body's shares (experts first..first+count-1, run r of n of
    each expert's slots) sum to the global output, at a capacity that
    drops tokens: what ``_moe_on_mesh`` sums over "model" and the data
    axes."""
    _, cfg = _cfgs("qwen3-moe-30b-a3b", 0.5)
    p, x = _port(_weights(cfg), _x(cfg, 2, 32))
    want, aux = moe._global(p, x, cfg)
    E, m, n = cfg.num_experts, 2, 3
    total = torch.zeros_like(want)
    for r in range(m):
        share = {k: (v if k == "router" else v[r * E // m:(r + 1) * E // m])
                 for k, v in p.items()}
        for run in range(n):
            out, stats = moe._global(share, x, cfg, (r * E // m, E // m),
                                     (run, n))
            total += out
            assert all(torch.equal(a, b) for a, b in zip(stats, aux))
    np.testing.assert_allclose(total.numpy(), want.numpy(), **TOL)


def test_moe_options_reach_the_ffn():
    """``ModelOptions.moe_local_dispatch`` routes a model's MoE layers per
    sequence: equal to the default at an ample capacity, different at a
    small one."""
    from repro_torch import checkpoint
    _, cfg = _cfgs("qwen3-moe-30b-a3b", 8.0)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    h = {}
    for local in (False, True):
        opts = M.ModelOptions(use_kernels=False, moe_local_dispatch=local)
        h[local], _ = M.forward_hidden(params, {"tokens": tok}, cfg, opts)
    np.testing.assert_allclose(h[True].numpy(), h[False].numpy(), **TOL)
    small = dataclasses.replace(cfg, capacity_factor=0.25)
    a, _ = M.forward_hidden(params, {"tokens": tok}, small,
                            M.ModelOptions(use_kernels=False))
    b, _ = M.forward_hidden(params, {"tokens": tok}, small, M.ModelOptions(
        use_kernels=False, moe_local_dispatch=True))
    assert not torch.allclose(a, b)


SHARD_MAP_CODE = """
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import moe
from repro_torch.models.config import get_config
import dataclasses
SHAPE, ARCH, CF = {shape}, "{arch}", {cf}
mesh = make_smoke_mesh(SHAPE)
cfg = get_config(ARCH, reduced=True)
if CF is not None:
    cfg = dataclasses.replace(cfg, capacity_factor=CF)
w = {{k: torch.from_numpy(v) for k, v in np.load(DIR + "/w.npz").items()}}
x = torch.from_numpy(np.load(DIR + "/x.npy"))
out, aux = moe.apply_moe_shard_map(w, x, cfg, mesh, dp_axes=("data",))
placed = {{k: SH.distribute(v, SH.param_spec("layers/0/ffn/" + k, v, mesh,
                                             SH.ShardingPolicy()), mesh)
          for k, v in w.items()}}
dx = SH.distribute(x, ("data", None, None), mesh)
forms = {{}}
for name, fn in (("local", lambda: moe.apply_moe_local(placed, dx, cfg)),
                 ("global", lambda: moe.apply_moe(placed, dx, cfg)),
                 ("constraint", lambda: moe.apply_moe(
                     placed, dx, cfg, expert_shard_constraint=True)),
                 ("shard_map", lambda: moe.apply_moe_shard_map(
                     placed, dx, cfg, mesh))):
    o, a = fn()
    forms[name] = [o.full_tensor().tolist(), a.full_tensor().item(),
                   [p.is_shard(0) for p in placed["w1"].placements]]
put({{"out": out.tolist(), "aux": aux.item(), "forms": forms}})
"""


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_shard_map_on_two_ranks_matches_the_reference(arch, tmp_path):
    """Experts split over "model" on a (1, 2) gloo mesh, against the
    reference's ``apply_moe_shard_map`` on its smoke mesh; each form on
    DTensors against the plain function on that mesh."""
    jcfg, cfg = _cfgs(arch, 8.0)
    w, x = _weights(cfg), _x(cfg, 2, 32)
    np.savez(tmp_path / "w.npz", **w)
    np.save(tmp_path / "x.npy", x)
    mesh = jsmoke()
    with mesh:
        jout, jaux = jax.jit(lambda p_, x_: jmoe.apply_moe_shard_map(
            p_, x_, jcfg, mesh))({k: jnp.asarray(v) for k, v in w.items()},
                                 jnp.asarray(x))
    out = run_ranks(SHARD_MAP_CODE.format(shape=(1, 2), arch=arch, cf=8.0),
                    2, tmp_path)
    p, xt = _port(w, x)
    plain = {"local": moe.apply_moe_local(p, xt, cfg),
             "global": moe.apply_moe(p, xt, cfg)}
    plain["constraint"] = plain["shard_map"] = plain["global"]
    for rec in out:
        np.testing.assert_allclose(np.asarray(rec["out"]), np.asarray(jout),
                                   **TOL)
        assert rec["aux"] == pytest.approx(float(jaux), abs=2e-5)
        for name, (o, a, pl) in rec["forms"].items():
            assert pl == [False, True]            # experts over "model"
            np.testing.assert_allclose(np.asarray(o),
                                       plain[name][0].numpy(), **TOL,
                                       err_msg=name)
            assert a == pytest.approx(plain[name][1].item(), abs=2e-5)


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["cf-8", "cf-0.5"])
def test_forms_on_a_data_split_mesh(cf, tmp_path):
    """Tokens split over "data" on a (2, 1) mesh: per-sequence dispatch and
    global dispatch (which gathers the tokens and splits each expert's
    slots between the data ranks) equal the plain functions even where
    capacity drops tokens; ``shard_map`` routes each rank's half alone
    (capacity over it, aux averaged)."""
    _, cfg = _cfgs("qwen3-moe-30b-a3b", cf)
    w, x = _weights(cfg), _x(cfg, 4, 16)
    np.savez(tmp_path / "w.npz", **w)
    np.save(tmp_path / "x.npy", x)
    out = run_ranks(SHARD_MAP_CODE.format(shape=(2, 1),
                                          arch="qwen3-moe-30b-a3b", cf=cf),
                    2, tmp_path)
    p, xt = _port(w, x)
    halves = [moe.apply_moe({k: v for k, v in p.items()}, xt[i:i + 2], cfg)
              for i in (0, 2)]
    want = {"local": moe.apply_moe_local(p, xt, cfg),
            "global": moe.apply_moe(p, xt, cfg),
            "shard_map": (torch.cat([h[0] for h in halves]),
                          (halves[0][1] + halves[1][1]) / 2)}
    want["constraint"] = want["global"]
    for rec in out:
        np.testing.assert_allclose(np.asarray(rec["out"]),
                                   want["shard_map"][0].numpy(), **TOL)
        for name, (o, a, _) in rec["forms"].items():
            np.testing.assert_allclose(np.asarray(o), want[name][0].numpy(),
                                       **TOL, err_msg=name)
            assert a == pytest.approx(want[name][1].item(), abs=2e-5)
