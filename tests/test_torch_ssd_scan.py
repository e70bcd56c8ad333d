"""The port's plain SSD scan (``repro_torch.kernels.ref``) against the JAX
package: its Pallas kernel in interpret mode and both of its oracles, on the
non-slow grid of ``tests/test_kernels.py`` plus a large-dt case whose
unmasked upper triangle would overflow fp32; and the port's dispatch, which
sends CPU tensors to the plain version. fp32 at 3e-5, as test_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as cuda_ssd  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)

GRID = [
    # b, s, h, p, g, n, chunk, dt range
    (2, 128, 4, 32, 1, 32, 32, (0.001, 0.1)),
    (1, 256, 2, 64, 1, 64, 64, (0.001, 0.1)),
    (1, 64, 4, 16, 2, 16, 16, (0.001, 0.1)),       # 2 B/C groups
    (1, 64, 4, 16, 2, 16, 32, (2.0, 6.0)),         # large dt: see below
]

ORACLES = {
    "pallas_interpret": lambda x, dt, A, B, C, L: pallas_ssd_scan(
        x, dt, A, B, C, L),
    "jax_ssd_scan_ref": JR.ssd_scan_ref,
    "jax_ssd_scan_naive": lambda x, dt, A, B, C, L: JR.ssd_scan_naive(
        x, dt, A, B, C),
}


def _inputs(shape, seed=0):
    """x, B, C ~ N(0, 1), dt ~ U(dt range), A ~ -U(0.5, 2). In the large-dt
    case dt and A are drawn from grids of quarters and halves instead, so
    every partial sum of dt·A is exact in fp32 and cs is the same whatever
    order a cumsum adds in: at |cs| ~ 100, cs_i - cs_{i-1} otherwise loses
    ~1e-5 to cancellation, which the oracles' own cumsums round differently
    (the comparison is about the mask, not that rounding)."""
    b, s, h, p, g, n, _, (lo, hi) = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    if lo >= 1.0:
        dt = rng.integers(int(4 * lo), int(4 * hi) + 1, (b, s, h)) / 4
        A = -rng.integers(1, 5, (h,)) / 2
    else:
        dt = rng.uniform(lo, hi, (b, s, h))
        A = -rng.uniform(0.5, 2.0, (h,))
    return (x, dt.astype(np.float32), A.astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("oracle", sorted(ORACLES))
@pytest.mark.parametrize("shape", GRID, ids=lambda s: "x".join(map(str, s[:7]))
                         + f"-dt{s[7][1]}")
def test_plain_ssd_scan_matches_jax(shape, oracle):
    arrays = _inputs(shape)
    L = shape[6]
    want = np.asarray(ORACLES[oracle](*map(jnp.asarray, arrays), L))
    got = ref.ssd_scan_ref(*_torch(arrays), L)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.isfinite(want).all() and bool(got.isfinite().all())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_large_dt_case_would_overflow_without_the_mask():
    """The last grid case is a real trap: within some chunk, dt·|A| sums past
    ~88, so e^{cs_i - cs_j} over the upper triangle is inf in fp32, and a
    0/1 triangle multiplied in would turn it into NaN."""
    shape = GRID[-1]
    x, dt, A, B, C = _inputs(shape)
    L = shape[6]
    cs = np.cumsum((dt * A).reshape(1, -1, L, shape[2]), axis=2)
    assert (cs[:, :, 0] - cs[:, :, -1]).max() > 88.8
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cs[:, :, 0] - cs[:, :, -1])).any()
    got = ref.ssd_scan_ref(*_torch((x, dt, A, B, C)), L)
    assert bool(got.isfinite().all())


def test_plain_naive_matches_plain_chunked():
    """The port's own two plain versions agree (the chunked form against
    the O(s) recurrence), as test_kernels.py's chunked-equals-sequential."""
    arrays = _torch(_inputs(GRID[0], seed=3))
    want = ref.ssd_scan_naive(*arrays)
    for chunk in (16, 32, 64, 128):
        torch.testing.assert_close(ref.ssd_scan_ref(*arrays, chunk), want,
                                   **TOL)


@pytest.mark.parametrize("b,chunk_a,chunk_b",
                         [(1, 16, 32), (2, 32, 16), (3, 16, 16)])
def test_plain_ssd_chunk_invariance(b, chunk_a, chunk_b):
    """Mirrors test_model_parts.py::test_ssd_chunk_invariance_seeded."""
    arrays = _torch(_inputs((b, 64, 2, 16, 1, 16, 0, (0.001, 0.1)), seed=b))
    torch.testing.assert_close(ref.ssd_scan_ref(*arrays, chunk_a),
                               ref.ssd_scan_ref(*arrays, chunk_b), **TOL)


def test_plain_ssd_scan_keeps_bf16_dtype_and_rejects_ragged():
    x, dt, A, B, C = _torch(_inputs(GRID[0]))
    y = ref.ssd_scan_ref(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), 32)
    assert y.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        ref.ssd_scan_ref(x[:, :100], dt[:, :100], A, B[:, :100], C[:, :100],
                         32)


def test_ops_dispatch_by_device():
    arrays = _torch(_inputs(GRID[2]))
    before = cuda_ssd.ssd_scan.launches
    got = ops.ssd_scan(*arrays, 16)                       # CPU: plain
    torch.testing.assert_close(got, ref.ssd_scan_ref(*arrays, 16), atol=0,
                               rtol=0)
    assert cuda_ssd.ssd_scan.launches == before
    mixed = list(arrays)
    mixed[0] = mixed[0].to("meta")
    with pytest.raises(ValueError):
        ops.ssd_scan(*mixed, 16)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back: a CPU tensor raises before any build."""
    with pytest.raises(ValueError):
        cuda_ssd.ssd_scan(*_torch(_inputs(GRID[2])), 16)
    assert cuda_ssd.smem_bytes(64, 128, 128) == 85_248    # serving shape
    assert cuda_ssd.smem_bytes(64, 128, 128) <= cuda_ssd.MAX_SMEM_BYTES


# ---- the chunk-parallel decomposition the CUDA kernels compute ----

CHUNKED = [
    # b, s, h, p, g, n, chunk, dt range
    (1, 128, 4, 16, 2, 16, 32, (0.001, 0.1)),      # 4 chunks, 2 groups
    (2, 96, 4, 32, 1, 32, 32, (0.001, 0.1)),       # 3 chunks, 2 rows
    (1, 100, 4, 16, 2, 16, 32, (0.001, 0.1)),      # ragged: 32, 32, 32, 4
    (1, 64, 6, 16, 3, 16, 16, (0.001, 0.1)),       # 3 groups of 2 heads
    (1, 80, 4, 16, 2, 16, 16, (0.5, 2.0)),         # large dt, 5 chunks
]


def _chunked_inputs(shape, seed=0):
    """As ``_inputs``; large dt ~ U(0.5, 2) is drawn on a grid of quarters
    and A on a grid of halves, so that every partial sum of dt·A is exact
    and the comparison is about the decomposition, not the cumsum's
    rounding (see ``_inputs``)."""
    b, s, h, p, g, n, _, (lo, hi) = shape
    if lo < 0.5:
        return _inputs(shape, seed)
    rng = np.random.default_rng(seed)
    dt = rng.integers(int(4 * lo), int(4 * hi) + 1, (b, s, h)) / 4
    A = -rng.integers(1, 5, (h,)) / 2
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            dt.astype(np.float32), A.astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32))


def _zero_padded(arrays, chunk):
    """The inputs zero-padded along s to a multiple of chunk, as the model
    pads before the scan."""
    s = arrays[0].shape[1]
    pad = (-s) % chunk
    return [a if i == 2 else                            # A has no s axis
            np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
            for i, a in enumerate(arrays)]


@pytest.mark.parametrize("shape", CHUNKED, ids=lambda s: "x".join(
    map(str, s[:7])) + f"-dt{s[7][1]}")
def test_chunked_decomposition_matches_pallas_and_naive(shape):
    """The plain chunk-parallel form (C·Bᵀ per group, local states, the pass
    over chunks, outputs) against the Pallas kernel in interpret mode, on
    the zero-padded inputs with the padding's rows dropped, and against the
    port's O(s) recurrence on the inputs as they are; fp32 at 2e-5."""
    arrays = _chunked_inputs(shape)
    s, L = shape[1], shape[6]
    got = ref.ssd_scan_chunked(*_torch(arrays), L)
    assert got.dtype == torch.float32 and got.shape == arrays[0].shape
    padded = _zero_padded(arrays, L)
    pallas = np.asarray(pallas_ssd_scan(*map(jnp.asarray, padded), L))[:, :s]
    naive = ref.ssd_scan_naive(*_torch(arrays)).numpy()
    assert np.isfinite(pallas).all() and bool(got.isfinite().all())
    for want in (pallas, naive):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_chunked_decomposition_equals_the_plain_scan_on_whole_chunks():
    """On a chunk multiple it agrees with ``ssd_scan_ref`` (the Pallas
    body's own sequential-over-chunks form) and keeps bf16."""
    arrays = _torch(_inputs(GRID[0], seed=4))
    torch.testing.assert_close(ref.ssd_scan_chunked(*arrays, 32),
                               ref.ssd_scan_ref(*arrays, 32), atol=2e-5,
                               rtol=2e-5)
    x, dt, A, B, C = arrays
    y = ref.ssd_scan_chunked(x.bfloat16(), dt, A, B.bfloat16(),
                             C.bfloat16(), 32)
    assert y.dtype == torch.bfloat16


def test_scratch_is_sized_per_group_and_chunk():
    """C·Bᵀ is one (L, L) tile per (batch, chunk, group), not per head;
    the carried states and decays exist only past one chunk."""
    shapes = cuda_ssd.scratch_shapes(1, 128, 80, 1, 128, 64, 128)
    assert shapes == {"cb": (1, 1, 1, 128, 128), "cs": (1, 1, 80, 128),
                      "dt": (1, 1, 80, 128), "states": (1, 0, 80, 128, 64),
                      "decay": (1, 0, 80)}
    assert cuda_ssd.scratch_layout(1, 128, 80, 1, 128, 64, 128) == (
        0, 16384, 26624, 36864, 36864, 36864)
    shapes = cuda_ssd.scratch_shapes(2, 300, 8, 2, 128, 64, 128)
    assert shapes["cb"] == (2, 3, 2, 128, 128)
    assert shapes["states"] == (2, 2, 8, 128, 64)
    offsets = cuda_ssd.scratch_layout(1, 20, 3, 1, 4, 16, 4)
    assert all(o % 4 == 0 for o in offsets)     # every buffer on 16 bytes
    # cb 5·4·4 = 80, cs and dt 5·3·4 = 60 each, states 4·3·4·16 = 768,
    # decay 4·3 = 12 floats
    assert offsets == (0, 80, 140, 200, 968, 980)


@pytest.mark.parametrize("p,n,chunk,esize,chunks,want", [
    (64, 128, 128, 4, 1, 44_032),       # serving shape: one chunk
    (64, 128, 128, 4, 2, 85_248),       # ... carrying a state
    (64, 128, 128, 2, 2, 64_768),       # bf16
    (128, 128, 128, 4, 16, 150_784),
    (16, 16, 16, 4, 4, 4_736),
])
def test_smem_bytes_follow_the_kernels_layout(p, n, chunk, esize, chunks,
                                              want):
    assert cuda_ssd.smem_bytes(p, n, chunk, esize, chunks) == want


def test_shape_checks_refuse_what_the_kernels_do_not_take():
    """The device-independent checks, on CPU tensors: each bad input raises
    before any build or launch."""
    x, dt, A, B, C = _torch(_inputs(GRID[0]))
    cuda_ssd.check_shapes(x, dt, A, B, C, 32)            # the good case
    bad = [
        (x.half(), dt, A, B.half(), C.half(), 32),        # dtype
        (x, dt.double(), A, B, C, 32),                    # dt not fp32
        (x.transpose(1, 2), dt, A, B, C, 32),             # shapes disagree
        (x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B, C, 32),
        (x[..., :24].contiguous(), dt, A, B, C, 32),      # head dim 24
        (x, dt, A, B[..., :30].contiguous(), C[..., :30].contiguous(), 32),
        (x, dt, A[:3], B, C, 32),                         # A's shape
        (x, dt, A, B, C, 30),                             # chunk % 4
        (x, dt, A, B, C, 4096),                           # shared memory
        (x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0], 32),  # empty
    ]
    for args in bad:
        with pytest.raises(ValueError):
            cuda_ssd.check_shapes(*args)
    flat = torch.empty(x.numel() + 1)[1:].view(x.shape)  # 4 bytes off
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_ssd.check_shapes(flat, dt, A, B, C, 32)
