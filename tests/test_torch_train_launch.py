"""The port's training launcher (``launch.train.train``) on the CPU, and its
checkpoints crossing with the reference's in both directions: the reference
reads the port's train state into ``init_train_state``'s structure, and the
port reads what the reference's ``train`` wrote."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import restore_checkpoint as jrestore  # noqa: E402
from repro.data.pipeline import InputShape as JInputShape  # noqa: E402
from repro.data.pipeline import make_batch as jmake_batch  # noqa: E402
from repro.launch.train import train as jtrain  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import steps as JST  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.data.pipeline import InputShape, make_batch  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps as ST  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL = dict(atol=5e-5, rtol=5e-5)
ARCH = "olmo-1b"


def test_training_loss_decreases():
    """``test_system.py::test_training_loss_decreases`` on the port."""
    rec = train(ARCH, reduced=True, steps=30, batch=8, seq=64,
                log_every=100, device="cpu")
    assert set(rec) >= {"arch", "steps", "first_loss", "final_loss",
                        "wall_s", "loss_history"}
    assert len(rec["loss_history"]) == len(rec["grad_norm_history"]) == 30
    first5 = np.mean(rec["loss_history"][:5])
    last5 = np.mean(rec["loss_history"][-5:])
    assert np.isfinite(last5)
    assert last5 < first5, f"loss did not decrease: {first5} -> {last5}"


def _port_state(cfg):
    return ST.init_train_state(cfg, torch.Generator().manual_seed(1),
                               torch.float32, ST.TrainOptions(),
                               device="cpu")


def _port_loss(params, cfg, seed):
    batch = make_batch(cfg, InputShape("t", 32, 2, "train"), seed=seed,
                       device="cpu")
    with torch.no_grad():
        return float(M.loss_fn(params, batch, cfg, M.ModelOptions())[0])


def _ref_loss(params, jcfg, seed):
    batch = jmake_batch(jcfg, JInputShape("t", 32, 2, "train"), seed=seed)
    return float(JM.loss_fn(params, batch, jcfg, JM.ModelOptions())[0])


def test_reference_reads_the_port_checkpoint(tmp_path):
    path = str(tmp_path / "port.npz")
    train(ARCH, reduced=True, steps=3, batch=4, seq=64, log_every=100,
          checkpoint_path=path, device="cpu")
    meta = json.load(open(path + ".meta.json"))
    assert meta["arch"] == ARCH and meta["steps"] == 3
    jcfg = jget_config(ARCH, reduced=True)
    like = JST.init_train_state(jcfg, jax.random.PRNGKey(0), jnp.float32,
                                JST.TrainOptions())
    restored = jrestore(path, like)
    assert int(restored["opt"]["step"]) == 3
    cfg = get_config(ARCH, reduced=True)
    state = checkpoint.restore_checkpoint(path, _port_state(cfg), cfg)
    assert int(state["opt"]["step"]) == 3
    np.testing.assert_allclose(_ref_loss(restored["params"], jcfg, 4),
                               _port_loss(state["params"], cfg, 4), **TOL)
    # the port's round trip is exact
    again = str(tmp_path / "again.npz")
    checkpoint.save_checkpoint(again, state, cfg)
    for a, b in zip(leaves(state), leaves(checkpoint.restore_checkpoint(
            again, _port_state(cfg), cfg))):
        assert torch.equal(a, b)


def test_port_reads_the_reference_checkpoint(tmp_path):
    path = os.path.join(str(tmp_path), "ref.npz")
    jtrain(ARCH, reduced=True, steps=3, batch=4, seq=64,
           checkpoint_path=path, log_every=100)
    jcfg = jget_config(ARCH, reduced=True)
    like = JST.init_train_state(jcfg, jax.random.PRNGKey(0), jnp.float32,
                                JST.TrainOptions())
    restored = jrestore(path, like)
    cfg = get_config(ARCH, reduced=True)
    state = checkpoint.restore_checkpoint(path, _port_state(cfg), cfg)
    assert int(state["opt"]["step"]) == int(restored["opt"]["step"]) == 3
    data = np.load(path)
    wq = data["opt/m/scan/[0]/mixer/wq"]
    for layer in range(cfg.num_layers):
        np.testing.assert_array_equal(
            state["opt"]["m"]["layers"][layer]["mixer"]["wq"].numpy(),
            wq[layer])
    np.testing.assert_allclose(_ref_loss(restored["params"], jcfg, 5),
                               _port_loss(state["params"], cfg, 5), **TOL)
    with pytest.raises((KeyError, ValueError)):    # another model
        checkpoint.restore_checkpoint(
            path, _port_state(get_config("yi-9b", reduced=True)),
            get_config("yi-9b", reduced=True))
