"""The port's training step (``models.steps.train_step``: ``loss_fn``'s
gradients, microbatch accumulation, the cosine schedule and AdamW in place)
against the reference's jitted ``train_step`` on reduced olmo-1b for three
steps, with one and with four microbatches, from the same weights and
batches; remat on and off giving the same gradients in the port. The
reference's final train state is read into the port's structure with the
port's ``restore_checkpoint``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint as jsave  # noqa: E402
from repro.data.pipeline import InputShape as JInputShape  # noqa: E402
from repro.data.pipeline import make_batch as jmake_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import steps as JST  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.data.pipeline import (InputShape, make_batch,  # noqa: E402
                                       synthetic_batch_iterator)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps as ST  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

# the reference's gradient tolerance; the AdamW state after three steps
# carries it (the update divides by √v, so it does not grow)
TOL = dict(atol=5e-5, rtol=5e-5)
ARCH, B, SEQ, STEPS = "olmo-1b", 8, 32, 3


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    jcfg = jget_config(ARCH, reduced=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    path = str(tmp_path_factory.mktemp("w") / "params.npz")
    jsave(path, jparams)
    return jcfg, jparams, get_config(ARCH, reduced=True), path


def _topts(mod, n):
    return mod.TrainOptions(microbatches=n, schedule_total=10,
                            schedule_warmup=2)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(start, microbatches, tmp_path):
    jcfg, jparams, cfg, wpath = start
    jtopts = _topts(JST, microbatches)
    jstate = {"params": jparams,
              "opt": JST.adamw_init(jparams, jtopts.opt)}
    jstep = JST.make_jitted_train_step(jcfg, JM.ModelOptions(), jtopts)
    topts = _topts(ST, microbatches)
    params = checkpoint.load_flat(wpath, cfg, device="cpu")
    state = {"params": params, "opt": adamw_init(params, topts.opt)}
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jmake_batch(
            jcfg, JInputShape("t", SEQ, B, "train"), seed=10 + i))
        state, m = ST.train_step(state, make_batch(
            cfg, InputShape("t", SEQ, B, "train"), seed=10 + i,
            device="cpu"), cfg, M.ModelOptions(), topts)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                       err_msg=f"step {i} {k}")
    path = str(tmp_path / "ref_state.npz")
    jsave(path, jstate)
    want = checkpoint.restore_checkpoint(path, state, cfg)
    assert int(state["opt"]["step"]) == int(want["opt"]["step"]) == STEPS
    for got, ref in zip(leaves(state), leaves(want)):
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_remat_does_not_change_the_gradients(start):
    *_, cfg, wpath = start
    params = checkpoint.load_flat(wpath, cfg, device="cpu")
    batch = next(synthetic_batch_iterator(
        cfg, InputShape("t", SEQ, B, "train"), start_seed=5, device="cpu"))
    out = [ST.compute_grads(params, batch, cfg, M.ModelOptions(remat=r),
                            ST.TrainOptions()) for r in (True, False)]
    # the same arithmetic; only the recomputed forward's BLAS calls may
    # block their sums otherwise (seen: 4e-9 under a loaded CPU)
    assert float(out[0][0]) == pytest.approx(float(out[1][0]), abs=1e-6)
    for a, b in zip(leaves(out[0][2]), leaves(out[1][2])):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)
    assert all(not p.requires_grad for p in leaves(params))


def test_batch_iterator_is_make_batch_at_successive_seeds():
    cfg = get_config(ARCH, reduced=True)
    shape = InputShape("t", SEQ, 2, "train")
    it = synthetic_batch_iterator(cfg, shape, start_seed=7, device="cpu")
    for seed in (7, 8, 9):
        got, want = next(it), make_batch(cfg, shape, seed=seed,
                                         device="cpu")
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k])


def test_split_microbatches_refuses_a_ragged_split():
    batch = {"tokens": torch.zeros(6, 4), "pos": torch.tensor(3)}
    split = ST._split_microbatches(batch, 3)
    assert split["tokens"].shape == (3, 2, 4)
    assert split["pos"].tolist() == [3, 3, 3]
    with pytest.raises(ValueError):
        ST._split_microbatches(batch, 4)
