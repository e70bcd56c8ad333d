"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``): every parameter's spec, leaf for
leaf, for every architecture at full size on both reference mesh shapes
((16, 16) and (2, 16, 16), duck-typed meshes as in
``tests/test_sharding.py``), the cache specs of four architectures at
``decode_32k`` and ``long_500k``, divisibility on the port's own H100
meshes, the fsdp policy, ``to_placements``' refusals, and a reduced
qwen3-moe train step on a 1x1 gloo mesh from the reference's weights
against the reference's sharded step on its smoke mesh.

The reference's parameters and caches are stacked over the block pattern's
repeats (``scan/[j]/...``, a leading repeat dim whose spec entry is None);
the port's are per layer (``layers/<l>/...``). ``checkpoint._tree_key``
maps a port path to the reference's key, and the reference's leading None
is stripped for stacked leaves."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.store import save_checkpoint as jsave  # noqa: E402
from repro.data.pipeline import SHAPES as JSHAPES  # noqa: E402
from repro.data.pipeline import InputShape as JInputShape  # noqa: E402
from repro.data.pipeline import make_batch as jmake_batch  # noqa: E402
from repro.launch import dryrun as JDR  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jsmoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import steps as JST  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro.models.config import list_archs  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.data.pipeline import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import POD1, POD2  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.tree import items  # noqa: E402
from test_torch_dist_train import run_ranks  # noqa: E402


class RefMesh:
    """The reference's duck-typed mesh: ``.shape`` and ``.axis_names``."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


class PortMesh:
    """The port's: ``.mesh_dim_names`` and ``.shape`` (a tuple)."""

    def __init__(self, shape: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


REF_SHAPES = {"pod1": {"data": 16, "model": 16},
              "pod2": {"pod": 2, "data": 16, "model": 16}}
PORT_SHAPES = {"pod1": dict(zip(POD1[1], POD1[0])),
               "pod2": dict(zip(POD2[1], POD2[0]))}


def _ref_specs(tree, specs) -> dict:
    """{npz key: (spec tuple, leaf ndim)} of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    out = {}
    for (path, leaf), spec in zip(leaves, flat_specs, strict=True):
        key = "/".join(str(p.key) if hasattr(p, "key") else f"[{p.idx}]"
                       for p in path)
        out[key] = (tuple(spec) + (None,) * (leaf.ndim - len(spec)),
                    leaf.ndim)
    return out


def _specs(tree) -> list:
    """The spec leaves of a port spec tree (dicts and lists; a spec is a
    tuple), in ``items``' order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _specs(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _specs(v)]
    return [tree]


def _port_key(cfg, path: str) -> tuple:
    key, repeat = checkpoint._tree_key(cfg, path)
    return key, repeat is not None


def _norm(spec, ndim) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_param_specs_equal_the_reference(arch, mesh):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jparams = jax.eval_shape(lambda: JM.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    want = _ref_specs(jparams, JSH.params_specs(
        jparams, RefMesh(REF_SHAPES[mesh]), JSH.ShardingPolicy.for_arch(jcfg)))
    params = checkpoint.meta_params(cfg, torch.bfloat16)
    got = SH.params_specs(params, PortMesh(REF_SHAPES[mesh]),
                          SH.ShardingPolicy.for_arch(cfg))
    seen = set()
    for (path, leaf), spec in zip(items(params), _specs(got), strict=True):
        key, stacked = _port_key(cfg, path)
        ref, ndim = want[key]
        if stacked:
            assert ref[0] is None
            ref, ndim = ref[1:], ndim - 1
        assert ndim == leaf.dim(), path
        assert _norm(spec, leaf.dim()) == ref, (path, spec, ref)
        seen.add(key)
    assert seen == set(want)


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-2.7b", "recurrentgemma-9b",
                                  "grok-1-314b"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_equal_the_reference(arch, shape_name):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshape, shape = JSHAPES[shape_name], SHAPES[shape_name]
    jopts = JDR.model_options(jcfg, jshape)
    jcache = jax.eval_shape(lambda: JM.init_cache(
        jcfg, jshape.global_batch, jshape.seq_len, jnp.bfloat16, jopts))
    mesh = REF_SHAPES["pod1"]
    want = _ref_specs(jcache, JSH.cache_specs(
        jcache, jcfg, jshape, RefMesh(mesh), JSH.ShardingPolicy.for_arch(jcfg)))
    opts = DR.model_options(cfg, shape)
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                         torch.bfloat16, opts, device="meta")
    got = SH.cache_specs(cache, cfg, shape, PortMesh(mesh),
                         SH.ShardingPolicy.for_arch(cfg))
    seen = set()
    for layer, (c, specs) in enumerate(zip(cache, got, strict=True)):
        for name, leaf in c.items():
            key, stacked = _port_key(cfg, f"layers/{layer}/{name}")
            ref, ndim = want[key]
            if stacked:
                assert ref[0] is None
                ref, ndim = ref[1:], ndim - 1
            assert ndim == leaf.dim()
            assert _norm(specs[name], leaf.dim()) == ref, (layer, name)
            seen.add(key)
    assert seen == set(want)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_every_sharded_dim_divides_on_the_port_meshes(arch, mesh):
    cfg = get_config(arch)
    pm = PortMesh(PORT_SHAPES[mesh])
    params = checkpoint.meta_params(cfg, torch.bfloat16)
    specs = SH.params_specs(params, pm, SH.ShardingPolicy.for_arch(cfg))
    n_sharded = 0
    for (path, leaf), spec in zip(items(params), _specs(specs),
                                  strict=True):
        # to_placements raises on a dim that does not divide
        placements = SH.to_placements(spec, pm, leaf.shape)
        n_sharded += any(p.is_shard() for p in placements)
        for d, entry in enumerate(spec):
            names = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n = math.prod(PORT_SHAPES[mesh][a] for a in names)
            assert leaf.shape[d] % n == 0, (path, leaf.shape, spec)
    assert n_sharded > 0


def test_large_archs_use_fsdp():
    for arch, big in (("grok-1-314b", True), ("yi-9b", True),
                      ("olmo-1b", False), ("qwen3-moe-30b-a3b", True)):
        assert SH.ShardingPolicy.for_arch(get_config(arch)).fsdp is big
        assert SH.ShardingPolicy.for_arch(get_config(arch)).fsdp == \
            JSH.ShardingPolicy.for_arch(jget_config(arch)).fsdp


def test_to_placements_shards_in_mesh_order_and_refuses_uneven_shards():
    from torch.distributed.tensor import Replicate, Shard
    pm = PortMesh({"pod": 2, "data": 4, "model": 8})
    assert SH.to_placements((("pod", "data"), None, "model"), pm,
                            (16, 3, 64)) == [Shard(0), Shard(0), Shard(2)]
    assert SH.to_placements((), pm) == [Replicate()] * 3
    with pytest.raises(ValueError, match="does not divide"):
        SH.to_placements(("model", None), pm, (12, 4))
    with pytest.raises(ValueError, match="does not divide"):
        SH.to_placements(((("pod", "data")),), pm, (4,))
    with pytest.raises(ValueError, match="mesh order"):
        SH.to_placements((("data", "pod"),), pm, (16,))


def test_batch_specs_equal_the_reference():
    for arch in list_archs():
        for name in SHAPES:
            for mesh in REF_SHAPES.values():
                want = JSH.batch_specs(jget_config(arch), JSHAPES[name],
                                       RefMesh(mesh))
                got = SH.batch_specs(get_config(arch), SHAPES[name],
                                     PortMesh(mesh))
                assert got.keys() == want.keys()
                for k in got:
                    assert tuple(got[k]) == tuple(want[k]), (arch, name, k)


@pytest.fixture(scope="module")
def ref_moe_step(tmp_path_factory):
    """The reference's ``test_sharded_train_step_runs_on_smoke_mesh``
    step: reduced qwen3-moe on its 1x1 smoke mesh, with its loss and the
    weights it started from (saved as the reference's npz)."""
    cfg = jget_config("qwen3-moe-30b-a3b", reduced=True)
    mesh = jsmoke()
    policy = JSH.ShardingPolicy()
    opts = JM.ModelOptions(remat=False)
    topts = JST.TrainOptions()
    shape = JInputShape("t", 64, 2, "train")
    path = str(tmp_path_factory.mktemp("moe") / "params.npz")
    with mesh:
        state = JST.init_train_state(cfg, jax.random.PRNGKey(0), jnp.float32,
                                     topts)
        jsave(path, state["params"])
        state_sh = JSH.to_named(JSH.state_specs(state, mesh, policy), mesh)
        batch_sh = JSH.to_named(JSH.batch_specs(cfg, shape, mesh), mesh)
        state = jax.device_put(state, state_sh)
        f = functools.partial(JST.train_step, cfg=cfg, opts=opts,
                              topts=topts)
        step = jax.jit(f, in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, None))
        _, metrics = step(state, jmake_batch(cfg, shape, seed=0))
    return path, float(metrics["loss"]), float(metrics["grad_norm"])


def test_sharded_moe_train_step_matches_the_reference(ref_moe_step, tmp_path):
    path, loss, norm = ref_moe_step
    out = run_ranks(f"""
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch import checkpoint
        from repro_torch.data.pipeline import InputShape, make_batch
        from repro_torch.launch import sharding as SH
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.models import model as M
        from repro_torch.models import steps as ST
        from repro_torch.models.config import get_config
        from repro_torch.optim import adamw_init
        cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
        mesh = make_smoke_mesh()
        topts = ST.TrainOptions()
        params = checkpoint.load_flat({path!r}, cfg, device="cpu")
        state = {{"params": params, "opt": adamw_init(params, topts.opt)}}
        state = SH.distribute(state, SH.state_specs(state, mesh,
                                                    SH.ShardingPolicy()), mesh)
        shape = InputShape("t", 64, 2, "train")
        batch = SH.distribute(make_batch(cfg, shape, seed=0, device="cpu"),
                              SH.batch_specs(cfg, shape, mesh), mesh)
        with implicit_replication():
            _, m = ST.train_step(state, batch, cfg,
                                 M.ModelOptions(remat=False), topts)
        put([m["loss"].full_tensor().item(),
             m["grad_norm"].full_tensor().item()])
        """, 1, tmp_path)[0]
    np.testing.assert_allclose(out, [loss, norm], rtol=2e-5, atol=2e-5)
