"""The reference's entry points that the port carries under their own names,
against the JAX package on the same inputs: ``attention_full(positions=)``
(einsum and flash, causal and windowed), ``init_vgg16``/``apply_vgg16`` and
``init_zf``/``apply_zf``, ``repro_torch.data``'s exports, and
``serve(dryrun_dir=)`` / ``--dryrun-dir``, whose dry-run record reaches the
fleet planner. fp32 at 2e-5."""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.data as jdata  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import vgg as JV  # noqa: E402
from repro.models.config import get_config as jget_config  # noqa: E402
from repro_torch.core import gpu_catalog as G  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import vgg as TV  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
STRATEGIES = ("per-stream", "uniform-big", "packed")


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (D, H * hd), "wk": (D, K * hd), "wv": (D, K * hd),
              "wo": (H * hd, D)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


def _positions(pattern, B, S):
    if pattern == "none":
        return None
    if pattern == "shifted":                      # (1, S), from 7
        return np.arange(7, 7 + S, dtype=np.int32)[None, :]
    # (B, S), another offset a row
    return (np.arange(S, dtype=np.int32)[None, :]
            + np.array([[3], [40]], np.int32)[:B])


@pytest.mark.parametrize("window", [0, 16], ids=["causal", "window16"])
@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("pattern", ["shifted", "per-row", "none"])
def test_attention_full_positions_match_reference(pattern, use_flash, window):
    """RoPE at the given positions; the masks stay in index space. With
    ``use_flash`` the reference runs its Pallas kernel in interpret mode
    and the port its plain version (CPU tensors)."""
    arch, B, S = "yi-9b", 2, 64                       # GQA 4 over 2
    cfg = get_config(arch, reduced=True)
    p = _attn_params(cfg, 11)
    x = np.random.default_rng(12).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = _positions(pattern, B, S)
    kw = dict(window=window, use_flash=use_flash)
    want, (jk, _) = JL.attention_full(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jget_config(arch, reduced=True),
        positions=None if pos is None else jnp.asarray(pos), **kw)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got, (k, _) = TL.attention_full(
        tp, torch.from_numpy(x), cfg,
        positions=None if pos is None else torch.from_numpy(pos).long(), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    default, (k0, _) = TL.attention_full(tp, torch.from_numpy(x), cfg, **kw)
    if pos is None:
        torch.testing.assert_close(got, default, rtol=0, atol=0)
    else:
        # the positions moved RoPE; a row's scores depend on position
        # differences only, so its output does not move
        assert not torch.allclose(k, k0, **TOL)
        torch.testing.assert_close(got, default, **TOL)


@pytest.mark.parametrize("net", ["vgg16", "zf"])
def test_vgg_and_zf_entry_points_match_reference(net):
    """The reference's weights through the port's ``apply_<net>``, at 64
    px; the port's ``init_<net>`` is ``init_convnet`` on its layout, leaf
    shapes equal to the reference's."""
    layout = {"vgg16": TV.VGG16_LAYOUT, "zf": TV.ZF_LAYOUT}[net]
    jp = getattr(JV, f"init_{net}")(jax.random.PRNGKey(0), input_hw=64,
                                    num_classes=10)
    x = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(getattr(JV, f"apply_{net}")(jp, jnp.asarray(x)))
    params = TV.params_from_reference(jp, device="cpu")
    got = getattr(TV, f"apply_{net}")(params, torch.from_numpy(x))
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    kw = dict(input_hw=64, num_classes=10, device="cpu")
    mine = getattr(TV, f"init_{net}")(torch.Generator().manual_seed(1), **kw)
    same = TV.init_convnet(layout, torch.Generator().manual_seed(1), **kw)
    for part in ("conv", "fc"):
        assert [tuple(l["w"].shape) for l in mine[part]] == \
            [tuple(l["w"].shape) for l in params[part]]
        for a, b in zip(mine[part], same[part]):
            torch.testing.assert_close(a["w"], b["w"], rtol=0, atol=0)


def test_data_package_exports_the_reference_names():
    from repro_torch import data
    from repro_torch.data import (SHAPES, InputShape, input_specs,  # noqa
                                  make_batch, synthetic_batch_iterator)
    assert data.__all__ == jdata.__all__
    for name in data.__all__:
        assert getattr(data, name) is getattr(TP, name)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jdata.SHAPES.items()}
    cfg, jcfg = get_config("olmo-1b", reduced=True), \
        jget_config("olmo-1b", reduced=True)
    shape = InputShape("t", 16, 2, "train")
    got = make_batch(cfg, shape, seed=5, device="cpu")
    want = jdata.make_batch(jcfg, jdata.InputShape("t", 16, 2, "train"),
                            seed=5)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert set(input_specs(cfg, shape)) == set(got)
    first = next(iter(synthetic_batch_iterator(cfg, shape, device="cpu")))
    assert set(first) == set(got)


class EngineClock:
    # a stand-in for the engine's time module: each monotonic() call is one
    # millisecond, so the measured rates depend on the engine's work alone
    def __init__(self):
        self.calls = 0

    def monotonic(self):
        self.calls += 1
        return self.calls * 1e-3


def _record(d, flops):
    rec = {"arch": "olmo-1b", "shape": "decode_32k", "mesh": "pod1",
           "flops_per_device": flops}
    (d / "olmo-1b_decode_32k_pod1.json").write_text(json.dumps(rec))
    return str(d)


def _replan(report, dryrun_dir):
    streams = G.streams_from_measured(
        "olmo-1b", report["measured_stream_tokens_per_s"])
    return {s: G.plan_gpu_fleet(streams, dryrun_dir, strategy=s)
            for s in STRATEGIES}


def test_serve_dryrun_dir_reaches_the_planner(tmp_path, monkeypatch):
    """The closed form packs the four streams by HBM; a record that says
    compute binds gives another packed plan, and ``serve``'s plans are
    ``plan_gpu_fleet`` of its measured rates with that record."""
    monkeypatch.setattr(engine_mod, "time", EngineClock())
    closed = serve_mod.serve("olmo-1b", device="cpu", seconds=1)
    assert closed["fleet_plans"] == _replan(closed, None)
    # per-token FLOPs that make the fastest stream need 0.6 of one H100's
    # usable TFLOP/s, so that compute binds where HBM did
    usable = G.h100_catalog().get("h100-1").usable()[0]
    flops_tok = 0.6 * usable * 1e12 / max(
        closed["measured_stream_tokens_per_s"].values())
    d = _record(tmp_path, flops_tok * 128 / 256)
    monkeypatch.setattr(engine_mod, "time", EngineClock())
    traced = serve_mod.serve("olmo-1b", device="cpu", seconds=1,
                             dryrun_dir=d)
    assert traced["frames_served"] == closed["frames_served"] == 8
    assert set(traced) == set(closed)
    assert traced["fleet_plans"] == _replan(traced, d)
    packed = traced["fleet_plans"]["packed"]
    assert packed != _replan(traced, None)["packed"]
    assert packed["hourly_cost"] > closed["fleet_plans"]["packed"][
        "hourly_cost"]
    req = G.LLMStream("s", "olmo-1b", 1.0).requirement(d)
    assert req[0] == pytest.approx(flops_tok / 1e12, rel=1e-12)


def test_dryrun_dir_flag_reaches_serve(tmp_path, monkeypatch, capsys):
    seen = {}
    monkeypatch.setattr(serve_mod, "serve",
                        lambda *a, **kw: seen.update(kw) or {})
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu",
                                      "--dryrun-dir", "some/dir"])
    serve_mod.main()
    assert seen["dryrun_dir"] == "some/dir" and seen["device"] == "cpu"
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu"])
    serve_mod.main()
    assert seen["dryrun_dir"] is None
    capsys.readouterr()

    # the command line end to end on the reduced model, the record read
    monkeypatch.undo()
    monkeypatch.setattr(engine_mod, "time", EngineClock())
    d = _record(tmp_path, 3.32425e9)     # the dry run's olmo-1b figure
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu",
                                      "--seconds", "1", "--dryrun-dir", d])
    serve_mod.main()
    out = json.loads(capsys.readouterr().out)
    assert out["frames_served"] == 8
    assert out["fleet_plans"] == _replan(out, d)
