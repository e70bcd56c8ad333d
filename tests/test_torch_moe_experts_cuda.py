"""The grouped fp32 expert kernels of the dropless MoE layer
(``csrc/moe_experts.cu``) against their plain PyTorch version, on the GPU:
both tile sizes, the wrapper's refusals, the launch counter, and a reduced
granite-4.0-h-small prefill and decode with the kernels against the plain
path. Every test here needs a CUDA device of compute capability >= 9.0
(Hopper) and skips without one; this file imports no jax:

    python -m pytest -q tests/test_torch_moe_experts_cuda.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint  # noqa: E402
from repro_torch.kernels import moe_experts as me  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402

# fp32: the kernel sums each dot product over d in order, the plain version
# in cuBLAS's order; relative to the largest output
RTOL = 1e-5

# tokens, experts routed to, top-k, held (first, count), D, F
SHAPES = [
    (576, 72, 10, (0, 18), 512, 256),     # prefill tiles, granite's routing
    (16, 72, 10, (0, 18), 512, 256),      # decode tiles
    (16, 72, 10, (54, 18), 256, 128),     # the last share
    (37, 8, 3, (2, 4), 128, 64),          # ragged rows, an expert with none
    (300, 16, 2, (0, 16), 192, 320),      # all held, widths of 64 only
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA GPU of compute capability >= 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    T, E, K, (first, n), D, Fw = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    top = torch.argsort(torch.rand(T, E, generator=g), dim=-1)[:, :K]
    rows, ends, pos = moe._sort_held(top.to(device), first, n)
    x = torch.randn(T, D, generator=g).to(device)
    w1 = (torch.randn(n, D, Fw, generator=g) / D ** 0.5).to(device)
    w3 = (torch.randn(n, D, Fw, generator=g) / D ** 0.5).to(device)
    w2 = (torch.randn(n, Fw, D, generator=g) / Fw ** 0.5).to(device)
    return x, rows, ends, w1, w3, w2


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("small", [False, True], ids=["big", "small"])
def test_kernel_matches_plain_version(cuda, shape, small):
    args = _inputs(shape, cuda)
    got = me.moe_experts(*args, small)
    want = ref.moe_experts_ref(*args)
    held = int(args[2][-1])
    assert torch.all(got[-1] == 0)
    err = (got[:held] - want[:held]).abs().max().item()
    assert err <= RTOL * want.abs().max().item()


def test_dispatch_launches_kernel_and_counts(cuda):
    args = _inputs(SHAPES[1], cuda)
    before = me.moe_experts.launches
    ops.moe_experts(*args, small=True)
    assert me.moe_experts.launches == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, rows, ends, w1, w3, w2 = _inputs(SHAPES[3], cuda)
    before = me.moe_experts.launches
    bad = [(x.double(), rows, ends, w1, w3, w2),            # dtype
           (x, rows.int(), ends, w1, w3, w2),                # index dtype
           (x[:, :64].contiguous(), rows, ends, w1, w3, w2),  # D disagrees
           (x, rows, ends, w1[..., :32].contiguous(),
            w3[..., :32].contiguous(), w2[:, :32].contiguous()),  # F 32
           (x.cpu(), rows, ends, w1, w3, w2)]                # device
    for args in bad:
        with pytest.raises(ValueError):
            me.moe_experts(*args, False)
    assert me.moe_experts.launches == before


def test_reduced_granite_kernels_match_plain(cuda):
    """Reduced granite-4.0-h-small, widened to multiples of 64 so that the
    expert kernels take it: prefill and two decode steps with the kernels
    (SSD scan, flash, grouped experts) against the plain path."""
    cfg = dataclasses.replace(get_config("granite-4.0-h-small", reduced=True),
                              d_model=128, head_dim=32, moe_d_ff=64,
                              experts_held=4)
    params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                    device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda)
    out = {}
    before = me.moe_experts.launches
    for use in (True, False):
        opts = M.ModelOptions(use_kernels=use, remat=False)
        with torch.no_grad():
            lg, cache = M.prefill(params, {"tokens": toks}, cfg, opts, 48)
            steps = [lg]
            for i in range(2):
                lg, cache = M.decode_step(params, toks[:, i], 40 + i, cache,
                                          cfg, opts)
                steps.append(lg)
        out[use] = torch.stack(steps)
    assert me.moe_experts.launches == before + 3 * cfg.num_layers
    err = (out[True] - out[False]).abs().max().item()
    assert err <= 1e-4 * out[False].abs().max().item()
