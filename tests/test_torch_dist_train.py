"""Training on a mesh in the port: ``steps._split_microbatches`` with
``batch_axes`` on a (2, 1) gloo mesh, ``launch.train.train(mesh=...)``
on a 1x1 mesh against ``mesh=None`` step for step, and one step of
reduced olmo-1b on a (1, 2) tensor-parallel mesh and on a (2, 1)
data-parallel mesh at 2 microbatches (and yi-9b's GQA on (1, 2)) against
the unsharded step (the flash attention's plain version through
``layers._heads_local``); one decode step on a mesh against the plain one
(heads split, head_dim split, MoE tokens split).

Each world runs in processes of its own (one default process group a
process), over gloo and a ``FileStore``, started by ``run_ranks`` with a
timeout. ``run_ranks`` is shared with the other ``test_torch_*`` files of
the distributed layer."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
RANK_TIMEOUT_S = 240
TOL = dict(rtol=2e-5, atol=2e-5)

PRELUDE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD, DIR = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
BACKEND = sys.argv[4]
if BACKEND == "fake":
    from repro_torch.launch.dryrun import init_fake_world
    init_fake_world(WORLD)
else:
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(DIR, "store"), WORLD),
        rank=RANK, world_size=WORLD)
def put(obj):
    with open(os.path.join(DIR, f"out{RANK}.json"), "w") as f:
        json.dump(obj, f)
"""


def run_ranks(code: str, world: int, tmp_path, backend: str = "gloo",
              timeout: int = RANK_TIMEOUT_S) -> list:
    """Run ``code`` (after ``PRELUDE``: ``RANK``, ``WORLD``, ``DIR``, a
    default process group of ``world`` ranks over gloo, or one fake rank of
    a ``world``-rank group, and ``put(obj)``) in ``world`` processes (one
    for the fake group), each killed at ``timeout`` s. Returns each rank's
    ``put`` value; fails on a non-zero exit or a timeout."""
    script = tmp_path / "rank.py"
    script.write_text(PRELUDE + textwrap.dedent(code))
    # one thread a rank: the ranks' work is small, and the suite runs
    # beside other workers
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    n = 1 if backend == "fake" else world
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path),
         backend], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return [json.loads((tmp_path / f"out{r}.json").read_text())
            for r in range(n)]


def test_split_microbatches_keeps_the_batch_on_the_data_axis(tmp_path):
    out = run_ranks("""
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch import sharding as SH
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.models.steps import _split_microbatches
        mesh = make_smoke_mesh((2, 1))
        full = torch.arange(8 * 6, dtype=torch.int32).reshape(8, 6)
        batch = SH.distribute({"tokens": full}, {"tokens": (("data",), None)},
                              mesh)
        got = _split_microbatches(batch, 2, ("data",))["tokens"]
        plain = _split_microbatches({"tokens": full}, 2)["tokens"]
        put({"placements": [str(p) for p in got.placements],
             "local": list(got.to_local().shape),
             "equal": bool(torch.equal(got.full_tensor(), plain)),
             "plain_untouched": bool(torch.equal(
                 _split_microbatches({"tokens": full}, 2, ("data",))[
                     "tokens"], plain))})
        """, 2, tmp_path)
    for rec in out:
        assert rec["placements"] == [str(Shard(1)), str(Replicate())]
        assert rec["local"] == [2, 2, 6]
        assert rec["equal"] and rec["plain_untouched"]


def test_train_on_a_smoke_mesh_equals_train_without_one(tmp_path):
    out = run_ranks("""
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.launch.train import train
        kw = dict(steps=3, batch=4, seq=32, device="cpu", log_every=10)
        meshed = train("olmo-1b", mesh=make_smoke_mesh(), microbatches=2,
                       checkpoint_path=os.path.join(DIR, "meshed.npz"), **kw)
        plain = train("olmo-1b", microbatches=2,
                      checkpoint_path=os.path.join(DIR, "plain.npz"), **kw)
        put({k: [meshed[k], plain[k]] for k in ("loss_history",
                                                 "grad_norm_history")})
        """, 1, tmp_path)[0]
    for key, (meshed, plain) in out.items():
        assert len(meshed) == 3
        np.testing.assert_allclose(meshed, plain, **TOL, err_msg=key)
    # the meshed state is gathered into the same checkpoint
    meshed, plain = (np.load(tmp_path / f"{k}.npz") for k in ("meshed",
                                                               "plain"))
    assert sorted(meshed.files) == sorted(plain.files)
    for k in plain.files:
        np.testing.assert_allclose(meshed[k], plain[k], **TOL, err_msg=k)


STEP_CODE = """
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.data.pipeline import InputShape, make_batch
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import data_axes, make_smoke_mesh
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.models.config import get_config
from repro_torch.tree import leaves
SHAPE, ARCH, MB = {shape}, "{arch}", {mb}
mesh = make_smoke_mesh(SHAPE)
cfg = get_config(ARCH, reduced=True)
opts = M.ModelOptions(use_kernels=True)
topts = ST.TrainOptions(microbatches=MB,
                        batch_axes=data_axes(mesh) if MB > 1 else ())
ishape = InputShape("t", 32, 4, "train")
batch = make_batch(cfg, ishape, seed=0, device="cpu")
fresh = lambda: ST.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    torch.float32, topts, device="cpu")
state, m0 = ST.train_step(fresh(), batch, cfg, opts, topts)
st = fresh()
placed = SH.distribute(st, SH.state_specs(st, mesh,
                                          SH.ShardingPolicy.for_arch(cfg)),
                       mesh)
with implicit_replication():
    dstate, m1 = ST.train_step(placed, SH.distribute(
        batch, SH.batch_specs(cfg, ishape, mesh), mesh), cfg, opts, topts)
params = leaves(SH.gather(dstate["params"]))
sharded = [str(p.placements) for p in leaves(dstate["params"])
           if any(not q.is_replicate() for q in p.placements)]
put({{"loss": [m0["loss"].item(), m1["loss"].full_tensor().item()],
     "norm": [m0["grad_norm"].item(), m1["grad_norm"].full_tensor().item()],
     "param_err": max((a - b).abs().max().item() for a, b in
                      zip(leaves(state["params"]), params)),
     "sharded_leaves": len(sharded)}})
"""


@pytest.mark.parametrize("shape,arch,mb", [
    ((1, 2), "olmo-1b", 1), ((2, 1), "olmo-1b", 2), ((1, 2), "yi-9b", 1)],
    ids=["olmo-tp", "olmo-dp-microbatches", "yi-gqa-tp"])
def test_sharded_step_equals_the_unsharded_one(tmp_path, shape, arch, mb):
    out = run_ranks(STEP_CODE.format(shape=shape, arch=arch, mb=mb), 2,
                    tmp_path)
    for rec in out:
        assert rec["sharded_leaves"] > 0
        np.testing.assert_allclose(rec["loss"][1], rec["loss"][0], **TOL)
        np.testing.assert_allclose(rec["norm"][1], rec["norm"][0], **TOL)
        assert rec["param_err"] <= 2e-5
    assert out[0] == out[1]


DECODE_CODE = """
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import checkpoint
from repro_torch.data.pipeline import InputShape
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.models.config import get_config
from repro_torch.tree import leaves
SHAPE, ARCH, B, L = {shape}, "{arch}", 4, 16
mesh = make_smoke_mesh(SHAPE)
cfg = get_config(ARCH, reduced=True)
opts = M.ModelOptions(use_kernels=False)
params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
tok = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab_size, (B, 8)).astype(np.int32))
_, cache = M.prefill(params, {{"tokens": tok}}, cfg, opts, L)
batch = {{"token": tok[:, 0].clone(), "pos": torch.tensor(8, dtype=torch.int32)}}
shape = InputShape("d", L, B, "decode")
policy = SH.ShardingPolicy.for_arch(cfg)
dparams = SH.distribute(params, SH.params_specs(params, mesh, policy), mesh)
dcache = SH.distribute(cache, SH.cache_specs(cache, cfg, shape, mesh, policy),
                       mesh)
dbatch = SH.distribute(batch, SH.batch_specs(cfg, shape, mesh), mesh)
want, wcache = ST.decode_step(params, cache, batch, cfg, opts)
with implicit_replication():
    got, gcache = ST.decode_step(dparams, dcache, dbatch, cfg, opts)
put({{"logits_err": (got.full_tensor() - want).abs().max().item(),
     "cache_err": max((a - b).abs().max().item() for a, b in zip(
         leaves(SH.gather(gcache)), leaves(wcache))),
     "head_dim_split": any(p.is_shard(3)
                           for p in leaves(dcache)[0].placements)}})
"""


@pytest.mark.parametrize("shape,arch,world,split", [
    ((1, 2), "olmo-1b", 2, False), ((1, 4), "yi-9b", 4, True),
    ((2, 1), "qwen3-moe-30b-a3b", 2, False)],
    ids=["olmo-heads", "yi-head-dim", "qwen-moe-data"])
def test_sharded_decode_step_equals_the_unsharded_one(tmp_path, shape, arch,
                                                       world, split):
    """One decode step on DTensors (the cache written on each rank's shard;
    attention per local head, or by head_dim parts summed where the KV
    heads do not divide the model axis) against the plain step."""
    out = run_ranks(DECODE_CODE.format(shape=shape, arch=arch), world,
                    tmp_path)
    for rec in out:
        assert rec["logits_err"] <= 2e-5
        assert rec["cache_err"] <= 2e-5
        assert rec["head_dim_split"] is split
