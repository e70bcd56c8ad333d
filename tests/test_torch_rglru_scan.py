"""The port's plain RG-LRU scan (``repro_torch.kernels.ref``) against the JAX
package: its oracle (an associative scan) on the reference's kernel-test grid
and on ragged shapes, its Pallas kernel in interpret mode on the non-slow
shape of ``tests/test_kernels.py``, and a Python loop; and the port's
dispatch, which sends CPU tensors to the plain version. fp32 at 2e-5, as
test_kernels.py.

The plain version of the fused kernel, ``ref.rglru_gated_scan_ref`` (gates,
scan from a state, GeLU gating), against the JAX package's ``_gates``, scan
and gelu gating (fp32 at 2e-5, bf16 at 2e-2) and, from a non-zero state,
against a Python loop; the CUDA kernel's chunked decomposition, written out
step by step in PyTorch, against the plain loop; and the wrappers' checks
and launch layout, which are plain Python."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru_scan  # noqa: E402
from repro.models import rglru as JM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as cuda_rg  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


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


# ---------------- the fused form's plain version ----------------

def _gated_inputs(B, S, W, seed=0, h0=False):
    """xc, Wr, Wi, gate_pre ~ N(0, 1) (the weights scaled by 1/sqrt(W), as
    ``init_rglru``), lam as ``init_rglru`` draws it, and h0 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = rng.uniform(0.9 ** 2, 0.999 ** 2, W)
    lam = np.log(np.expm1(-np.log(u) / (2 * ref.RG_C))).astype(np.float32)
    scale = np.float32(1 / np.sqrt(W))
    out = dict(xc=f32(B, S, W), wr=f32(W, W) * scale,
               wi=f32(W, W) * scale, gate_pre=f32(B, S, W), lam=lam)
    if h0:
        out["h0"] = f32(B, W)
    return out


def _jax_gated(inp, dtype):
    """The JAX package's tail of rglru_forward: _gates, its scan oracle
    (from zero) and the gelu gating, in ``dtype``."""
    cast = lambda k: jnp.asarray(inp[k]).astype(dtype)
    params = {"wr": cast("wr"), "wi": cast("wi"),
              "lam": jnp.asarray(inp["lam"])}
    xc = cast("xc")
    a, gated_in = JM._gates(params, xc)
    h = JM.rglru_scan_ref(a, gated_in)
    y = h.astype(dtype) * jax.nn.gelu(cast("gate_pre"))
    return np.asarray(y.astype(jnp.float32)), np.asarray(h[:, -1])


def _torch_gated(inp, dtype, **kw):
    cast = lambda k: torch.from_numpy(inp[k]).to(dtype)
    xc = cast("xc")
    return ref.rglru_gated_scan_ref(xc @ cast("wr"), xc @ cast("wi"), xc,
                                    cast("gate_pre"),
                                    torch.from_numpy(inp["lam"]), **kw)


@pytest.mark.parametrize("B,S,W", [(1, 32, 64), (2, 37, 30), (8, 1, 48),
                                   (1, 1, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_scan_ref_matches_jax(B, S, W, dtype):
    inp = _gated_inputs(B, S, W, seed=S + W)
    want_y, want_h = _jax_gated(inp, getattr(jnp, dtype))
    y, h = _torch_gated(inp, getattr(torch, dtype))
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, W) and tuple(h.shape) == (B, W)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(), want_y, **tol)
    np.testing.assert_allclose(h.numpy(), want_h, **tol)


def test_gated_scan_ref_from_a_state_matches_python_loop():
    """A non-zero h0, written into ``state_out`` = h0 in place."""
    B, S, W = 3, 9, 7
    inp = _gated_inputs(B, S, W, seed=4, h0=True)
    xc, wr, wi, g, lam, h0 = (inp[k].astype(np.float64) for k in (
        "xc", "wr", "wi", "gate_pre", "lam", "h0"))
    sig = lambda v: 1 / (1 + np.exp(-v))
    a = np.exp(-8 * np.log1p(np.exp(lam)) * sig(xc @ wr))
    b = np.sqrt(np.maximum(1 - a * a, 1e-12)) * sig(xc @ wi) * xc
    gelu = 0.5 * g * (1 + np.tanh(np.sqrt(2 / np.pi) * (g + 0.044715 * g ** 3)))
    h = h0.copy()
    want = np.zeros_like(xc)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h * gelu[:, t]
    state = torch.from_numpy(inp["h0"].copy())
    y, last = _torch_gated(inp, torch.float32, h0=state, state_out=state)
    assert last is state
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(state.numpy(), h, **TOL)


# ---------------- the CUDA kernel's decomposition, written out ----------------

def _kernel_decomposition(a, b, h0, layout):
    """What ``csrc/rglru_scan.cu`` computes, step by step: per tile of
    NW·(32/G)·L steps, each chunk of L steps from zero, (A, B) = (∏a, h_end);
    a Kogge-Stone scan over the 32/G chunks of a warp by the operator
    (A1, B1)∘(A2, B2) = (A1·A2, B1·A2 + B2); the warps' totals folded in
    order from the state entering the tile; each chunk's steps again from its
    carry-in. Steps past S are the identity (a = 1, b = 0)."""
    L, G, NW, _ = layout
    CL = 32 // G
    B, S, W = a.shape
    tile = NW * CL * L
    h_run = torch.zeros(B, W) if h0 is None else h0.clone()
    out = torch.empty(B, S, W)
    for t0 in range(0, S, tile):
        n = min(tile, S - t0)
        pad = lambda x, v: torch.nn.functional.pad(
            x[:, t0:t0 + n], (0, 0, 0, tile - n), value=v)
        ac = pad(a, 1.0).reshape(B, NW, CL, L, W)
        bc = pad(b, 0.0).reshape(B, NW, CL, L, W)
        A, Bs = torch.ones(B, NW, CL, W), torch.zeros(B, NW, CL, W)
        for j in range(L):
            Bs = ac[:, :, :, j] * Bs + bc[:, :, :, j]
            A = A * ac[:, :, :, j]
        cl = torch.arange(CL)[None, None, :, None]
        d = 1
        while d < CL:
            pa = torch.roll(A, d, dims=2)
            pb = torch.roll(Bs, d, dims=2)
            A, Bs = (torch.where(cl >= d, pa * A, A),
                     torch.where(cl >= d, pb * A + Bs, Bs))
            d *= 2
        ea = torch.where(cl == 0, 1.0, torch.roll(A, 1, dims=2))
        eb = torch.where(cl == 0, 0.0, torch.roll(Bs, 1, dims=2))
        h_warp = []
        for w in range(NW):
            h_warp.append(h_run)
            h_run = A[:, w, -1] * h_run + Bs[:, w, -1]
        h = ea * torch.stack(h_warp, 1)[:, :, None] + eb
        steps = []
        for j in range(L):
            h = ac[:, :, :, j] * h + bc[:, :, :, j]
            steps.append(h)
        out[:, t0:t0 + n] = torch.stack(steps, 3).reshape(B, tile, W)[:, :n]
    return out


@pytest.mark.parametrize("B,S,W,a_range", [
    (1, 32, 64, (0.7, 0.999)),        # the serving layout: 32 one-step chunks
    (8, 1, 16, (0.7, 0.999)),         # decode: one chunk, from a state
    (2, 37, 12, (0.7, 0.999)),        # ragged: a 40-step tile
    (1, 3, 8, (0.7, 0.999)),          # 4 chunks a warp
    (1, 100, 8, (0.7, 0.999)),        # chunks of 8 steps, two warps
    (1, 2048, 8, (0.99, 0.9999)),     # four 512-step tiles, slow decay
])
def test_kernel_decomposition_matches_plain_loop(B, S, W, a_range):
    """The CUDA kernel's decomposition in fp32 agrees with the plain loop
    within the 1e-4 the kernel is held to on the card."""
    a, b = map(torch.from_numpy, _inputs(B, S, W, seed=S, a_range=a_range))
    h0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, W)).astype(np.float32)) if S == 1 else None
    layout = cuda_rg.launch_layout(B, S, W, 4)
    got = _kernel_decomposition(a, b, h0, layout)
    want = ref.rglru_scan_ref(a, b, h0)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# ---------------- the wrappers' host-side logic ----------------

@pytest.mark.parametrize("shape,vec,want", [
    ((1, 32, 4096), 4, (1, 4, 4, 256)),     # prefill: one step a thread
    ((8, 1, 4096), 4, (1, 32, 1, 256)),     # decode of 8 slots
    ((1, 2048, 4096), 4, (8, 4, 8, 256)),   # four 512-step tiles
    ((2, 37, 300), 4, (1, 4, 5, 38)),       # ragged S and W
    ((1, 3, 5), 1, (1, 8, 1, 1)),           # 4 chunks a warp, 1 channel each
])
def test_launch_layout(shape, vec, want):
    L, G, NW, blocks = cuda_rg.launch_layout(*shape, vec)
    assert (L, G, NW, blocks) == want
    assert NW * (32 // G) * L >= min(shape[1], 512)   # a tile covers S
    assert NW <= cuda_rg.MAX_WARPS and G * vec <= 128


def test_serving_shapes_fill_the_card():
    """At least one block per SM of a 132-SM H100 at the prefill and the
    8-slot decode of recurrentgemma-9b."""
    for shape in ((1, 32, 4096), (8, 1, 4096)):
        assert cuda_rg.launch_layout(*shape, 4)[3] >= 132


@pytest.mark.parametrize("W,ptrs,esize,want", [
    (4096, (0, 256, 4096), 4, 4),      # 16-byte fp32 accesses
    (4096, (0, 256, 4096), 2, 4),      # 8-byte bf16 accesses
    (302, (0, 256), 4, 2),             # W % 4 = 2
    (301, (0, 256), 4, 1),             # odd W
    (4096, (0, 8), 4, 2),              # a pointer on 8 bytes, not 16
    (4096, (0, 4), 4, 1),
    (4096, (0, 4), 2, 2),              # bf16: 4 bytes hold 2
])
def test_vector_width(W, ptrs, esize, want):
    assert cuda_rg.vector_width(W, ptrs, esize) == want


def _gated_tensors(B=2, S=5, W=8, dtype=torch.float32):
    x = torch.zeros(B, S, W, dtype=dtype)
    return [x, x.clone(), x.clone(), x.clone(), torch.zeros(W)]


@pytest.mark.parametrize("case", [
    "half", "mixed_dtypes", "shapes_disagree", "not_3d", "empty",
    "lam_bf16", "lam_shape", "h0_shape", "h0_bf16", "state_shape",
])
def test_gated_checks_refuse_what_the_kernel_does_not_take(case):
    r, i, xc, g, lam = _gated_tensors()
    h0 = state = None
    if case == "half":
        r, i, xc, g = (t.half() for t in (r, i, xc, g))
    elif case == "mixed_dtypes":
        g = g.bfloat16()
    elif case == "shapes_disagree":
        g = g[:, :3]
    elif case == "not_3d":
        r, i, xc, g = (t[0] for t in (r, i, xc, g))
    elif case == "empty":
        r, i, xc, g = (t[:, :0] for t in (r, i, xc, g))
    elif case == "lam_bf16":
        lam = lam.bfloat16()
    elif case == "lam_shape":
        lam = lam[:7]
    elif case == "h0_shape":
        h0 = torch.zeros(2, 9)
    elif case == "h0_bf16":
        h0 = torch.zeros(2, 8, dtype=torch.bfloat16)
    elif case == "state_shape":
        state = torch.zeros(1, 8)
    with pytest.raises(ValueError):
        cuda_rg.check_gated_shapes(r, i, xc, g, lam, h0, state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_checks_accept_what_the_kernel_takes(dtype):
    r, i, xc, g, lam = _gated_tensors(dtype=dtype)
    cuda_rg.check_gated_shapes(r, i, xc, g, lam)
    h0 = torch.zeros(2, 8)
    cuda_rg.check_gated_shapes(r, i, xc, g, lam, h0, h0)


def test_gated_ops_dispatch_by_device():
    inp = _gated_inputs(2, 6, 8, seed=3, h0=True)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    args = (t["xc"] @ t["wr"], t["xc"] @ t["wi"], t["xc"], t["gate_pre"],
            t["lam"])
    before = cuda_rg.rglru_gated_scan.launches
    y, h = ops.rglru_gated_scan(*args, h0=t["h0"])       # CPU: plain
    want_y, want_h = ref.rglru_gated_scan_ref(*args, h0=t["h0"])
    torch.testing.assert_close(y, want_y, atol=0, rtol=0)
    torch.testing.assert_close(h, want_h, atol=0, rtol=0)
    assert cuda_rg.rglru_gated_scan.launches == before
    with pytest.raises(ValueError):
        ops.rglru_gated_scan(*(a.to("meta") for a in args))
    with pytest.raises(ValueError):
        ops.rglru_gated_scan(*args, h0=t["h0"].to("meta"))


def test_cuda_gated_wrapper_refuses_cpu_tensors():
    """A CPU tensor raises before any build; nothing is counted."""
    r, i, xc, g, lam = _gated_tensors()
    before = cuda_rg.rglru_gated_scan.launches
    with pytest.raises(ValueError):
        cuda_rg.rglru_gated_scan(r, i, xc, g, lam)
    assert cuda_rg.rglru_gated_scan.launches == before


def test_scan_checks_refuse_what_the_kernel_does_not_take():
    f32, shape = torch.float32, (2, 5, 8)
    for a_shape, b_shape, dtypes in [
            (shape, shape, (torch.bfloat16, torch.bfloat16)),
            (shape, (2, 4, 8), (f32, f32)),
            ((5, 8), (5, 8), (f32, f32)),
            ((2, 0, 8), (2, 0, 8), (f32, f32)),
            ((65536, 1, 8), (65536, 1, 8), (f32, f32))]:
        with pytest.raises(ValueError):
            cuda_rg._check_scan_static(torch.Size(a_shape),
                                       torch.Size(b_shape), dtypes)
