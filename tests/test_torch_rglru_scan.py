"""The port's plain RG-LRU scan (``repro_torch.kernels.ref``) against the JAX
package: its oracle (an associative scan) on the reference's kernel-test grid
and on ragged shapes, its Pallas kernel in interpret mode on the non-slow
shape of ``tests/test_kernels.py``, and a Python loop; and the port's
dispatch, which sends CPU tensors to the plain version. fp32 at 2e-5, as
test_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru_scan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as cuda_rg  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(B, S, W, seed=0, a_range=(0.7, 0.999)):
    """a ~ U(a_range), b ~ N(0, 1), as test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(*a_range, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,S,W", [
    (2, 128, 512), (1, 256, 256), (3, 64, 128), (1, 512, 1024),  # the grid
    (2, 37, 300),                        # ragged: no Pallas block divides it
    (1, 1, 5),
    (1, 32, 4096),                       # recurrentgemma-9b serving shape
])
def test_plain_rglru_scan_matches_jax_oracle(B, S, W):
    a, b = _inputs(B, S, W, seed=S)
    want = np.asarray(JR.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    got = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_rglru_scan_matches_pallas_interpret():
    """The non-slow shape of test_kernels.py::test_rglru_scan_kernel, with
    its blocks (bs 64, bw 128)."""
    a, b = _inputs(3, 64, 128, seed=1)
    want = np.asarray(pallas_rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                        block_seq=64, block_w=128))
    got = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_rglru_scan_matches_python_loop():
    """Mirrors test_kernels.py::test_rglru_scan_matches_python_loop."""
    B, S, W = 1, 37, 8
    a, b = _inputs(B, S, W, seed=2, a_range=(0.5, 0.999))
    h = np.zeros((B, W), np.float32)
    want = np.zeros_like(a)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plain_rglru_scan_long_slow_decay():
    """a close to 1 over a long sequence: h grows to ~100·|b|, so the
    comparison with the oracle is relative."""
    a, b = _inputs(1, 1024, 64, seed=3, a_range=(0.99, 0.9999))
    want = np.asarray(JR.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    got = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert np.abs(want).max() > 20
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_ops_dispatch_by_device():
    a, b = map(torch.from_numpy, _inputs(2, 16, 24))
    before = cuda_rg.rglru_scan.launches
    got = ops.rglru_scan(a, b)                            # CPU: plain
    torch.testing.assert_close(got, ref.rglru_scan_ref(a, b), atol=0, rtol=0)
    assert cuda_rg.rglru_scan.launches == before
    with pytest.raises(ValueError):
        ops.rglru_scan(a.to("meta"), b)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back: a CPU tensor raises before any build."""
    a, b = map(torch.from_numpy, _inputs(2, 16, 24))
    before = cuda_rg.rglru_scan.launches
    with pytest.raises(ValueError):
        cuda_rg.rglru_scan(a, b)
    assert cuda_rg.rglru_scan.launches == before
