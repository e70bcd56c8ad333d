"""The port's AdamW and cosine schedule (``repro_torch.optim``) against the
reference's (``repro.optim``) on the same numbers, and the reference's own
optimizer tests (``test_substrates.py``) mirrored on the port."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, cosine_schedule, global_norm)

# one fp32 step of the same arithmetic: pow, sqrt and the clip's divide may
# land one ulp apart in the two libraries
TOL = dict(rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("warmup,total", [(1, 2), (10, 100), (3, 30),
                                          (100, 10_000), (0, 5)])
def test_cosine_schedule_matches_reference(warmup, total):
    for step in range(total + 6):
        want = float(jcosine(jnp.asarray(step, jnp.int32), warmup=warmup,
                             total=total))
        got_t = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                warmup=warmup, total=total)
        assert got_t.dtype == torch.float32
        assert float(got_t) == pytest.approx(want, rel=1e-6, abs=1e-7)
        assert cosine_schedule(step, warmup=warmup, total=total) == \
            pytest.approx(want, rel=1e-6, abs=1e-7)


def _tree(rng, scale):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32) * scale,
            "blk": {"b": rng.standard_normal(7).astype(np.float32) * scale,
                    "m": rng.standard_normal((3, 2, 4)).astype(np.float32)
                    * scale}}


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _pairs(a, b):
    for k in a:
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k])
        else:
            yield k, a[k], b[k]


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])     # clip off / on
def test_adamw_update_matches_reference(state_dtype, grad_scale):
    """Three updates from the same tree, moments and gradients: params, m,
    v, step and grad_norm after each, clipping inactive (‖g‖ < 1) and
    active (‖g‖ > 1), moments in fp32 and in bf16."""
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    jcfg = JAdamWConfig(state_dtype=getattr(jnp, state_dtype))
    cfg = AdamWConfig(state_dtype=getattr(torch, state_dtype))
    jp = _to(params, jnp.asarray)
    tp = _to(params, torch.tensor)
    jst, tst = jadamw_init(jp, jcfg), adamw_init(tp, cfg)
    for i in range(3):
        grads = _tree(rng, grad_scale)
        lr_scale = 0.5 + 0.25 * i
        jp, jst, jm = jadamw_update(jp, _to(grads, jnp.asarray), jst, jcfg,
                                    jnp.float32(lr_scale))
        tp, tst, tm = adamw_update(tp, _to(grads, torch.tensor), tst, cfg,
                                   torch.tensor(lr_scale))
        assert (float(tm["grad_norm"]) > 1.0) == (grad_scale > 1)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        for tree_t, tree_j in ((tp, jp), (tst["m"], jst["m"]),
                               (tst["v"], jst["v"])):
            for name, t, j in _pairs(tree_t, tree_j):
                assert str(t.dtype)[6:] == str(j.dtype), name
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(j, np.float32),
                    **(TOL if t.dtype == torch.float32
                       else dict(rtol=1e-2, atol=1e-6)), err_msg=name)


def test_adamw_updates_in_place():
    params = {"w": torch.ones(4)}
    state = adamw_init(params, AdamWConfig())
    w, m = params["w"], state["m"]["w"]
    new_params, new_state, _ = adamw_update(params, {"w": torch.ones(4)},
                                            state, AdamWConfig())
    assert new_params["w"] is w and new_state["m"]["w"] is m
    assert not torch.equal(w, torch.ones(4))
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1


def test_global_norm_sums_every_leaf_in_fp32():
    tree = {"a": torch.full((3,), 2.0, dtype=torch.bfloat16),
            "b": [torch.full((4,), 1.0)]}
    assert float(global_norm(tree)) == pytest.approx(4.0)
    assert global_norm(tree).dtype == torch.float32


# ---- test_substrates.py's optimizer tests, on the port ----

def test_adamw_optimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = AdamWConfig(lr=0.3, weight_decay=0.0)
    state = adamw_init(params, cfg)
    loss = lambda p: torch.sum(p["w"] ** 2)
    for _ in range(100):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state, _ = adamw_update(params, {"w": g}, state, cfg)
    assert float(loss(params)) < 1e-2


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    cfg = AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    state = adamw_init(params, cfg)
    huge = {"w": torch.full((4,), 1e6)}
    _, _, m = adamw_update(params, huge, state, cfg)
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_cosine_schedule_shape():
    assert float(cosine_schedule(torch.tensor(0), warmup=10,
                                 total=100)) == 0.0
    mid = float(cosine_schedule(torch.tensor(10), warmup=10, total=100))
    assert mid == pytest.approx(1.0, abs=1e-6)
    end = float(cosine_schedule(torch.tensor(100), warmup=10, total=100))
    assert end == pytest.approx(0.1, abs=1e-6)
