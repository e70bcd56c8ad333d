"""The port's training objective (``models.model.loss_fn``) and its
gradients against ``jax.value_and_grad`` of the reference's
``repro.models.model.loss_fn``, for each reduced family, on the same weights
(the reference's ``init_params`` written by its ``save_checkpoint`` and read
by the port's ``load_flat``) and the same ``make_batch`` training batch.
Every gradient leaf is mapped through the same bridge. The port runs with
its kernels on (on the CPU: the plain versions, flash attention through its
autograd Function) and remat on; the reference on its jnp path, as it
trains."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint as jsave  # noqa: E402
from repro.data.pipeline import InputShape as JInputShape  # noqa: E402
from repro.data.pipeline import make_batch as jmake_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro_torch.checkpoint import load_flat  # noqa: E402
from repro_torch.data.pipeline import InputShape, make_batch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps as ST  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

# the reference's own gradient tolerance
# (test_model_parts.py::test_blockwise_attention_grad_matches)
TOL = dict(atol=5e-5, rtol=5e-5)
B, SEQ = 2, 80          # past recurrentgemma's window of 64; 16 patches + 64

FAMILIES = ["olmo-1b", "yi-9b", "mamba2-2.7b", "recurrentgemma-9b",
            "qwen3-moe-30b-a3b", "internvl2-1b", "hubert-xlarge"]


def _as_port(tree, cfg, tmp_path, name):
    """A reference pytree (params or grads) in the port's layout, through
    the weight bridge."""
    path = str(tmp_path / f"{name}.npz")
    jsave(path, tree)
    return load_flat(path, cfg, device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch, tmp_path):
    jcfg = jget_config(arch, reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jbatch = jmake_batch(jcfg, JInputShape("t", SEQ, B, "train"), seed=3)
    fn = jax.jit(functools.partial(
        jax.value_and_grad(JM.loss_fn, has_aux=True), cfg=jcfg,
        opts=JM.ModelOptions()))
    (jtotal, jmetrics), jgrads = fn(jparams, jbatch)

    cfg = get_config(arch, reduced=True)
    params = _as_port(jparams, cfg, tmp_path, "params")
    batch = make_batch(cfg, InputShape("t", SEQ, B, "train"), seed=3,
                       device="cpu")
    total, metrics, grads = ST.compute_grads(
        params, batch, cfg, M.ModelOptions(), ST.TrainOptions())

    np.testing.assert_allclose(float(total), float(jtotal), **TOL)
    for k in ("ce_loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)
    if cfg.num_experts:
        assert float(metrics["aux_loss"]) > 0
    want = _as_port(jgrads, cfg, tmp_path, "grads")
    got_leaves, want_leaves = leaves(grads), leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(leaves(params))
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert max(float(g.abs().max()) for g in got_leaves) > 0
