"""The port's VGG16 and ZF (``repro_torch.models.vgg``) against the JAX
package's (``repro.models.vgg``) with the same weights (JAX initialises
them, ``params_from_reference`` converts them): logits at 64 px, at an odd
67 px (ceil at the stride-2 convs, floor at the pools) and, for ZF, at
224 px (its 7×7/2 conv pads 2 before and 3 after, its 5×5/2 one 1 and 2);
the SAME padding itself; ``flops_per_frame``; and the port's own
initialiser. fp32 at 2e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import vgg as J  # noqa: E402
from repro_torch.models import vgg as P  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
NETS = ("vgg16", "zf")
LAYOUTS = {"vgg16": P.VGG16_LAYOUT, "zf": P.ZF_LAYOUT}


def _reference(net, hw, classes=10, seed=0):
    jp = getattr(J, f"init_{net}")(jax.random.PRNGKey(seed), input_hw=hw,
                                   num_classes=classes)
    x = np.random.default_rng(seed).standard_normal(
        (2, hw, hw, 3)).astype(np.float32)
    want = np.asarray(getattr(J, f"apply_{net}")(jp, jnp.asarray(x)))
    return jp, x, want


@pytest.mark.parametrize("net,hw", [("vgg16", 64), ("zf", 64),
                                    ("vgg16", 67), ("zf", 67), ("zf", 224)])
def test_logits_match_reference(net, hw):
    jp, x, want = _reference(net, hw)
    params = P.params_from_reference(jp, device="cpu")
    got = P.apply_convnet(params, torch.from_numpy(x), LAYOUTS[net])
    assert got.shape == (2, 10) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("size,k,stride,want", [
    (224, 7, 2, (2, 3)), (64, 7, 2, (2, 3)), (56, 5, 2, (1, 2)),
    (67, 7, 2, (3, 3)), (17, 5, 2, (2, 2)), (14, 3, 1, (1, 1))])
def test_same_pad_is_jax_same(size, k, stride, want):
    """Total pad max((ceil(n/s) - 1)·s + k - n, 0), the smaller half
    before; the output size is JAX's."""
    assert P.same_pad(size, k, stride) == want
    x = jnp.zeros((1, size, size, 1))
    w = jnp.zeros((k, k, 1, 1))
    out = jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                       dimension_numbers=("NHWC", "HWIO",
                                                          "NHWC"))
    assert out.shape[1] == (size + sum(want) - k) // stride + 1


def test_converter_moves_hwio_to_oihw_and_keeps_fc_rows():
    jp, _, _ = _reference("zf", 64)
    params = P.params_from_reference(jp, device="cpu")
    assert len(params["conv"]) == len(jp["conv"]) == 5
    for got, ref in zip(params["conv"], jp["conv"]):
        np.testing.assert_array_equal(
            got["w"].numpy(), np.transpose(np.asarray(ref["w"]), (3, 2, 0, 1)))
        assert set(got) == {"w", "b"}                 # no stride leaf
    for got, ref in zip(params["fc"], jp["fc"]):
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(ref["w"]))


@pytest.mark.parametrize("hw", [64, 67, 224])
def test_flops_per_frame_equal_reference(hw):
    for layout in ("VGG16_LAYOUT", "ZF_LAYOUT"):
        assert P.flops_per_frame(getattr(P, layout), hw) == \
            J.flops_per_frame(getattr(J, layout), hw)
    assert P.VGG16_LAYOUT == J.VGG16_LAYOUT and P.ZF_LAYOUT == J.ZF_LAYOUT


def test_relative_cost_matches_workload_model():
    """VGG16 is several times ZF's cost a frame (30.72 against 2.546 GFLOP
    at 224 px with the 512-wide head), as in the reference's test."""
    fv = P.flops_per_frame(P.VGG16_LAYOUT, 224)
    fz = P.flops_per_frame(P.ZF_LAYOUT, 224)
    assert (fv, fz) == (30_720_499_712, 2_545_672_192)
    assert 1.5 < fv / fz < 30


@pytest.mark.parametrize("net", NETS)
def test_port_init_shapes_and_stds(net):
    """The port's seeded initialiser: the reference's leaf shapes (conv
    weights as OIHW) and stds 1/sqrt(fan_in); the same draw twice from the
    same seed."""
    jp, x, _ = _reference(net, 64)
    mk = lambda: P.init_convnet(
        LAYOUTS[net], torch.Generator().manual_seed(3), input_hw=64,
        num_classes=10, device="cpu")
    params, again = mk(), mk()
    for got, ref in zip(params["conv"], jp["conv"]):
        k, _, c_in, c_out = np.asarray(ref["w"]).shape
        assert tuple(got["w"].shape) == (c_out, c_in, k, k)
        std = 1.0 / np.sqrt(k * k * c_in)
        assert abs(got["w"].std().item() / std - 1) < 0.1
    for got, ref in zip(params["fc"], jp["fc"]):
        assert tuple(got["w"].shape) == np.asarray(ref["w"]).shape
        assert abs(got["w"].std().item() * np.sqrt(got["w"].shape[0]) - 1) \
            < 0.1
    out = P.apply_convnet(params, torch.from_numpy(x), LAYOUTS[net])
    torch.testing.assert_close(out, P.apply_convnet(
        again, torch.from_numpy(x), LAYOUTS[net]), atol=0, rtol=0)
    assert out.shape == (2, 10) and torch.isfinite(out).all()
