"""The port's dry run and step analysis (``repro_torch.launch.dryrun``,
``launch.step_analysis``): ``input_specs`` against the reference's
``ShapeDtypeStruct``s for every architecture and shape; FLOPs of a plain
matrix product; per-device (local) FLOPs of a column-parallel product and
the all-reduce of a row-parallel one on a fake (16, 16) mesh; a reduced
olmo-1b train step's per-device FLOPs on a 1x1 mesh against
``repro.launch.hlo_analysis.analyze_hlo`` of the reference's compiled
step; ``run_one``'s records (a run, a skip, an uneven batch) and the
command line; ``LLMStream.requirement(dryrun_dir)`` against the
reference's formula on the same record.

A process holds one default process group, so each mesh runs in a process
of its own (``run_ranks``)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.core import tpu_catalog as JTC  # noqa: E402
from repro.data.pipeline import SHAPES as JSHAPES  # noqa: E402
from repro.data.pipeline import input_specs as jinput_specs  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import steps as JST  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro.models.config import list_archs  # noqa: E402
from repro_torch.core import gpu_catalog as G  # noqa: E402
from repro_torch.data.pipeline import SHAPES, input_specs  # noqa: E402
from repro_torch.launch.step_analysis import analyze_step  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from test_torch_dist_train import (RANK_TIMEOUT_S, SRC,  # noqa: E402
                                   run_ranks)

JDTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.float32): torch.float32}
# the port's per-device FLOPs of reduced olmo-1b's train step against the
# reference's compiled step: the same matrix products (forward, remat's
# recompute, backward). The gap found was 0 at (64, 4) and (128, 2); the
# bound leaves room for summation order only
FLOPS_REL_TOL = 1e-9
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_shape", "params",
               "active_params", "ring_cache", "moe_local",
               "blockwise_attention", "policy", "trace_s",
               "flops_per_device", "flops_by_op", "bytes_per_device",
               "collective_bytes_per_device", "collectives", "memory"}


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_equal_the_reference(arch, shape):
    want = jinput_specs(jget_config(arch), JSHAPES[shape])
    got = input_specs(get_config(arch), SHAPES[shape])
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert t.dtype == JDTYPES[jnp.dtype(want[k].dtype)], k


def test_plain_matmul_flops_and_bytes():
    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    out, rec = analyze_step(lambda x, y: x @ y, a, b)
    assert rec["flops_per_device"] == 2 * 64 * 32 * 128
    assert rec["bytes_per_device"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert rec["collective_bytes_per_device"] == 0
    assert rec["memory"] == {"argument_size_in_bytes": 4 * (64 * 128 +
                                                            128 * 32),
                             "output_size_in_bytes": 4 * 64 * 32}
    assert torch.equal(out, a @ b)


def test_local_flops_and_collectives_on_a_fake_mesh(tmp_path):
    rec = run_ranks("""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.launch.step_analysis import analyze_step
        mesh = make_smoke_mesh((16, 16))
        meta = lambda *s: torch.empty(*s, device="meta")
        x = DTensor.from_local(meta(64, 2048), mesh, [Replicate()] * 2,
                               run_check=False)
        w = DTensor.from_local(meta(2048, 8192 // 16), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        w2 = DTensor.from_local(meta(8192 // 16, 2048), mesh,
                                [Replicate(), Shard(0)], run_check=False)
        _, col = analyze_step(lambda a, b: a @ b, x, w)
        y = x @ w
        _, row = analyze_step(lambda a, b: (a @ b).redistribute(
            mesh, [Replicate(), Replicate()]), y, w2)
        put({"col": col, "row": row})
        """, 256, tmp_path, backend="fake")[0]
    col, row = rec["col"], rec["row"]
    assert col["flops_per_device"] == 2 * 64 * 2048 * 8192 / 16
    assert col["collectives"]["counts"] == {k: 0 for k in
                                            col["collectives"]["counts"]}
    assert col["memory"]["argument_size_in_bytes"] == \
        4 * (64 * 2048 + 2048 * 512)
    assert row["flops_per_device"] == 2 * 64 * 512 * 2048
    assert row["collectives"]["counts"]["all-reduce"] == 1
    assert sum(row["collectives"]["counts"].values()) == 1
    assert row["collectives"]["per_kind_bytes"]["all-reduce"] == \
        4 * 64 * 2048
    assert row["collective_bytes_per_device"] == 4 * 64 * 2048


def _ref_train_flops(seq, batch) -> float:
    cfg = jget_config("olmo-1b", reduced=True)
    topts = JST.TrainOptions()
    state = JST.init_train_state(cfg, jax.random.PRNGKey(0), jnp.float32,
                                 topts)
    batch_sds = {k: jax.ShapeDtypeStruct((batch, seq), jnp.int32)
                 for k in ("tokens", "labels")}
    step = JST.make_jitted_train_step(cfg, JM.ModelOptions(remat=True),
                                      topts)
    txt = step.lower(state, batch_sds).compile().as_text()
    return analyze_hlo(txt)["flops_per_device"]


def test_train_step_flops_agree_with_the_reference_compiled_step(tmp_path):
    seq, batch = 64, 4
    got = run_ranks(f"""
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.data.pipeline import InputShape
        from repro_torch.launch import dryrun as DR
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.launch.step_analysis import analyze_step
        from repro_torch.models.config import get_config
        cfg = get_config("olmo-1b", reduced=True)
        fn, args, _ = DR.build(cfg, InputShape("t", {seq}, {batch}, "train"),
                               make_smoke_mesh(), dtype=torch.float32)
        with implicit_replication():
            _, rec = analyze_step(fn, *args)
        put(rec)
        """, 1, tmp_path, backend="fake")[0]
    want = _ref_train_flops(seq, batch)
    assert got["flops_per_device"] == pytest.approx(want, rel=FLOPS_REL_TOL)


def test_run_one_records(tmp_path):
    out = run_ranks("""
        from repro_torch.launch import dryrun as DR
        ok = DR.run_one("olmo-1b", "decode_32k", "pod1")
        skip = DR.run_one("hubert-xlarge", "decode_32k", "pod1")
        put({"ok": ok, "skip": skip})
        """, 256, tmp_path, backend="fake")[0]
    ok = out["ok"]
    assert set(ok) == RECORD_KEYS
    assert ok["mesh_shape"] == [32, 8]
    assert set(ok["collectives"]["counts"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    # olmo-1b decodes 128 rows over 32 data shards: 4 a rank, 2 heads of 16
    # a rank; the weights' products alone give 2 FLOPs a parameter a row
    cfg = get_config("olmo-1b")
    assert ok["flops_per_device"] > 2 * cfg.param_count() * 4 / 8
    assert ok["memory"]["argument_size_in_bytes"] < ok["memory"][
        "device_bytes"]
    assert out["skip"]["skipped"].startswith("encoder-only")


def test_uneven_batch_is_refused_and_the_command_line_writes_records(
        tmp_path):
    """prefill_32k's batch of 32 does not divide pod2's 64 data shards: the
    record says so as an error (the reference's in_shardings would refuse
    it), and the command line exits 1 after writing it."""
    out = run_ranks("""
        from repro_torch.launch import dryrun as DR
        try:
            DR.run_one("olmo-1b", "prefill_32k", "pod2")
            err = None
        except ValueError as e:
            err = str(e)
        put({"err": err})
        """, 512, tmp_path, backend="fake")[0]
    assert "does not divide" in out["err"]
    rec_dir = tmp_path / "records"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "olmo-1b", "--shape", "prefill_32k",
                        "--mesh", "pod2", "--out", str(rec_dir)],
                       env=dict(os.environ, PYTHONPATH=SRC,
                                OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert r.returncode == 1, r.stdout + r.stderr
    rec = json.loads((rec_dir / "olmo-1b_prefill_32k_pod2.json").read_text())
    assert "does not divide" in rec["error"]


def _record(tmp_path, flops, **extra):
    rec = {"arch": "olmo-1b", "shape": "decode_32k", "mesh": "pod1",
           "flops_per_device": flops, **extra}
    (tmp_path / "olmo-1b_decode_32k_pod1.json").write_text(json.dumps(rec))
    return str(tmp_path)


def test_requirement_reads_the_dry_run_as_the_reference_does(tmp_path):
    d = _record(tmp_path, 3.32425e9)
    for rate in (1.0, 70.0, 312.5):
        got = G.LLMStream("s", "olmo-1b", rate).requirement(d)
        want = JTC.LLMStream("s", "olmo-1b", rate).requirement(d)
        assert got[0] == pytest.approx(want[0], rel=1e-12)
        assert got[0] == pytest.approx(rate * 3.32425e9 * 2 / 1e12,
                                       rel=1e-12)
        closed = G.LLMStream("s", "olmo-1b", rate).requirement()
        assert closed[0] == pytest.approx(
            rate * 2 * get_config("olmo-1b").active_param_count() / 1e12)
        assert got[1] == closed[1]
    # an error record, or none, falls back to the closed form
    (tmp_path / "err").mkdir()
    err = _record(tmp_path / "err", 1e12, error="ValueError: x")
    assert G.LLMStream("s", "olmo-1b", 5.0).requirement(err) == \
        G.LLMStream("s", "olmo-1b", 5.0).requirement()
    assert G.LLMStream("s", "olmo-1b", 5.0).requirement(
        str(tmp_path / "none")) == G.LLMStream("s", "olmo-1b",
                                               5.0).requirement()


def test_planner_takes_the_dry_run(tmp_path):
    """At a rate where compute binds, the dry run's per-token FLOPs (2.8x
    the closed form for olmo-1b at 32k) change the plan, as the
    reference's records change its TPU plan."""
    d = _record(tmp_path, 3.32425e9)
    streams = G.streams_from_measured("olmo-1b", {f"s{i}": 1e5
                                                  for i in range(4)})
    closed = G.plan_gpu_fleet(streams, strategy="packed")
    traced = G.plan_gpu_fleet(streams, d, strategy="packed")
    assert traced["hourly_cost"] > closed["hourly_cost"]
    problem = G.build_gpu_problem(streams, G.h100_catalog(), d)
    req = next(r for r in problem.items[0].requirements if r is not None)
    assert req == G.LLMStream("s0", "olmo-1b", 1e5).requirement(d)
