"""The fp32 flash-attention design for long query runs
(``flash_attention_kernel_f32_rows`` in ``csrc/flash_attention.cu``) on the
CPU: which calls take it (``design``), its shared memory, its work items,
and its schedule written out in torch (the same items in the same order,
each item's key range, one KV tile at a time with the row maxima, P, the
rescale and O += P·v) against the plain version and the JAX package's
Pallas kernel in interpret mode. The kernel itself is held against the plain
version on the GPU by chip_smoke.py and tests/test_torch_cuda_kernels.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

NEG_INF = -1e30


def _inputs(seed, B, S, H, hd, K, T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32))


def _schedule(q, k, v, causal, window):
    """What flash_attention_kernel_f32_rows computes, item by item in its
    order: per KV tile of ``rows_key_tile(hd)`` keys, the scaled scores
    with the kernel's masks (-1e30 for a key the row may not see, -inf past
    the ragged end of T), the row's new maximum, P = exp(s - m) (0 past T),
    l and O rescaled by exp(m_old - m) and P added; then O / l and lse =
    m + log l. Returns (out, lse, the times each (b, h, row) was
    written)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    rows, bc = tfa.rows_per_item(B, S, H), tfa.rows_key_tile(hd)
    scale = 1.0 / math.sqrt(hd)
    out = torch.full_like(q, float("nan"))
    lse = torch.full((B, H, S), float("nan"))
    seen = torch.zeros((B, H, S), dtype=torch.int64)
    for b, h, r0, nr, t_lo, ntiles in tfa.rows_items(B, S, T, H, hd, causal,
                                                     window):
        kh = h // (H // K)
        qt = torch.zeros(rows, hd)
        qt[:nr] = q[b, r0:r0 + nr, h]
        q_pos = torch.arange(rows)[:, None] + r0 + T - S
        m = torch.full((rows,), NEG_INF)
        l = torch.zeros(rows)
        acc = torch.zeros(rows, hd)
        for i in range(ntiles):
            t0 = t_lo + i * bc
            n = min(bc, T - t0)
            kt, vt = torch.zeros(bc, hd), torch.zeros(bc, hd)
            kt[:n], vt[:n] = k[b, t0:t0 + n, kh], v[b, t0:t0 + n, kh]
            t = torch.arange(bc)[None, :] + t0
            vis = torch.ones(rows, bc, dtype=torch.bool)
            if causal:
                vis &= t <= q_pos
            if window > 0:
                vis &= t > q_pos - window
            s = torch.where(vis, (qt @ kt.T) * scale, NEG_INF)
            s = torch.where(t < T, s, -math.inf)
            m_new = torch.maximum(m, s.max(dim=1).values)
            alpha = torch.exp(m - m_new)
            p = torch.where(t < T, torch.exp(s - m_new[:, None]), 0.0)
            l = l * alpha + p.sum(dim=1)
            acc = acc * alpha[:, None] + p @ vt
            m = m_new
        out[b, r0:r0 + nr, h] = (acc / torch.where(l == 0, 1.0, l)[:, None]
                                 )[:nr]
        lse[b, h, r0:r0 + nr] = (m + torch.log(l))[:nr]
        seen[b, h, r0:r0 + nr] += 1
    return out, lse, seen


# every main path's shape and the edge cases, (B, S, H), with the design
# each takes
@pytest.mark.parametrize("B,S,H,dtype,want", [
    (8, 256, 16, torch.float32, "f32_rows"),   # olmo-1b training, hd 128
    (1, 500, 16, torch.float32, "f32_rows"),   # hubert-xlarge, hd 80
    (1, 288, 14, torch.float32, "f32_rows"),   # internvl2-1b: 126 items
    (1, 1024, 16, torch.float32, "f32_rows"),  # 1024-token shapes
    (1, 300, 32, torch.float32, "f32_rows"),   # yi-9b's 300-token prompt
    (2, 64, 32, torch.float32, "f32_rows"),    # S = 64, T < S: 128 items
    (1, 96, 32, torch.float32, "f32_rows"),    # 96 items: the fewest
    (1, 64, 4, torch.float32, "f32"),          # (1,64,4,64,4,48): 8 items
    (1, 64, 47, torch.float32, "f32"),         # 94 items: just too few
    (2, 100, 4, torch.float32, "f32"),         # 32 items: the 8-row kernel
    (1, 256, 8, torch.float32, "f32"),         # 64 items
    (1, 32, 16, torch.float32, "f32"),         # the served prefills
    (1, 32, 48, torch.float32, "f32"),         # nemotron-4-15b's
    (1, 37, 8, torch.float32, "f32"),          # the ragged 37-row case
    (8, 63, 64, torch.float32, "f32"),         # one row short of an item
    (1, 32, 32, torch.bfloat16, "bf16"),       # qwen3-moe / moonshot
    (8, 256, 16, torch.bfloat16, "bf16"),
    (1, 1024, 16, torch.bfloat16, "bf16"),
])
def test_design_names_each_paths_kernel(B, S, H, dtype, want):
    assert tfa.design(B, S, H, dtype) == want


# (B, S, H): the row count of each main path's items
@pytest.mark.parametrize("B,S,H,want", [
    (8, 256, 16, 64),       # olmo-1b training: 1024 items of 32 rows
    (1, 500, 16, 64),       # hubert-xlarge: 256 items of 32 rows
    (1, 288, 14, 32),       # internvl2-1b: 126 items of 32 fit at once
    (1, 1024, 16, 64),
    (1, 300, 32, 64),       # yi-9b's 300-token prefill
    (1, 64, 4, 32),         # (1,64,4,64,4,48)
    (1, 352, 12, 32),       # 132 items of 32 rows: the most that fit
    (1, 353, 12, 64),       # 144: more than the card's 132 SMs
])
def test_rows_per_item_fills_the_card(B, S, H, want):
    assert tfa.rows_per_item(B, S, H) == want
    if want == 32:
        assert B * H * -(-S // 32) <= tfa.SMS
    else:
        assert B * H * -(-S // 32) > tfa.SMS


@pytest.mark.parametrize("hd,rows,want", [
    (32, 64, 62_208), (64, 64, 103_168), (80, 64, 123_648),
    (128, 64, 185_088), (256, 64, 208_128),
    (32, 32, 49_024), (64, 32, 85_888), (80, 32, 104_320),
    (128, 32, 159_616), (256, 32, 170_368),
])
def test_smem_bytes_rows_follow_the_kernels_layout(hd, rows, want):
    """q (the item's rows of hd + 4), a ring of two K tiles (hd + 4) and
    two V tiles (hd), Pᵀ (keys × rows + 4), 3 values a row; 64-key tiles,
    32 at hd 256; every head dim fits a Hopper block."""
    bc = 32 if hd == 256 else 64
    layout = 4 * (rows * (hd + 4) + 2 * bc * (hd + 4) + 2 * bc * hd
                  + bc * (rows + 4) + 3 * rows)
    assert tfa.smem_bytes_rows(hd, rows) == layout == want
    assert want <= tfa.MAX_SMEM_BYTES


def test_shape_checks_take_every_head_dim_in_both_fp32_designs():
    for hd in tfa.HEAD_DIMS:
        for S in (32, 300):
            q, k, v = (torch.from_numpy(a)
                       for a in _inputs(hd, 1, S, 2, hd, 1, S))
            tfa.check_shapes(q, k, v)


ITEM_CASES = [
    (8, 256, 16, 128, 16, 256, True, 0),   # olmo-1b training
    (1, 500, 16, 80, 16, 500, False, 0),   # hubert-xlarge
    (1, 288, 14, 64, 2, 288, True, 0),     # internvl2-1b
    (1, 64, 4, 64, 4, 48, True, 0),        # T < S: 16 blind rows
    (1, 160, 2, 32, 1, 100, True, 0),      # T < S: blind rows, 2 KV tiles
    (1, 300, 16, 256, 1, 300, True, 128),  # hd 256, the window bites
    (2, 130, 3, 32, 1, 200, True, 40),     # T > S, window, ragged
    (1, 1024, 16, 256, 1, 1024, True, 256),
]


@pytest.mark.parametrize("B,S,H,hd,K,T,causal,window", ITEM_CASES)
def test_rows_items_cover_every_row_once_and_every_visible_key(
        B, S, H, hd, K, T, causal, window):
    """Each (b, h, query row) lies in exactly one item; each item's KV tiles
    hold every key its rows see (all keys for a tile with a blind row);
    under a causal mask without a window or blind rows the items come
    longest first."""
    items = tfa.rows_items(B, S, T, H, hd, causal, window)
    rows, bc = tfa.rows_per_item(B, S, H), tfa.rows_key_tile(hd)
    count = np.zeros((B, H, S), int)
    for b, h, r0, nr, t_lo, ntiles in items:
        count[b, h, r0:r0 + nr] += 1
        assert 1 <= nr <= rows and r0 % rows == 0 and ntiles >= 1
        pos = np.arange(r0, r0 + nr)[:, None] + T - S
        t = np.arange(T)[None, :]
        vis = np.ones((nr, T), bool)
        if causal:
            vis &= t <= pos
        if window > 0:
            vis &= t > pos - window
        keys = np.nonzero(vis.any(axis=0))[0]
        if not vis.any(axis=1).all():     # a row that sees no key
            assert (t_lo, ntiles) == (0, -(-T // bc))
        assert keys.size == 0 or (keys.min() >= t_lo and
                                  keys.max() < t_lo + ntiles * bc)
        assert t_lo % bc == 0 and t_lo + (ntiles - 1) * bc < T
    assert (count == 1).all()
    if causal and window == 0 and T >= S:
        tiles = [it[5] for it in items]
        assert tiles == sorted(tiles, reverse=True)
    assert len(items) == B * H * -(-S // rows)


SCHEDULE_CASES = [
    # 32-row items (all fit on the card at once)
    (1, 128, 2, 32, 1, 128, True, 0),      # 4 query tiles × 2 KV tiles
    (1, 256, 2, 64, 1, 256, True, 64),     # MQA, the window skips tiles
    (2, 128, 4, 64, 2, 256, True, 0),      # T > S, GQA
    (1, 100, 2, 80, 2, 100, False, 0),     # hd 80 encoder, ragged tiles
    (1, 64, 4, 32, 4, 48, True, 0),        # T < S: rows that see no key
    (1, 96, 2, 256, 1, 96, True, 40),      # hd 256: 32-key tiles
    # 64-row items (more than the card's SMs hold at 32)
    (1, 128, 40, 32, 4, 128, True, 0),     # 10-way GQA
    (1, 128, 36, 80, 36, 128, False, 0),   # hd 80 encoder
    (1, 128, 70, 256, 1, 128, True, 48),   # hd 256, window
]


@pytest.mark.parametrize("B,S,H,hd,K,T,causal,window", SCHEDULE_CASES + [
    (2, 150, 4, 80, 2, 150, True, 0),      # ragged causal GQA, 3 items
    (1, 70, 2, 256, 1, 90, True, 24),      # hd 256, T > S with a window
    (1, 160, 2, 32, 1, 100, True, 0),      # T < S: 60 blind rows, whose
                                           # items take both KV tiles
    (1, 100, 80, 64, 8, 60, True, 0),      # T < S with 64-row items
])
def test_schedule_matches_plain(B, S, H, hd, K, T, causal, window):
    """The kernel's schedule in fp32 against the plain version (the output
    and the log-sum-exp), within 2e-5; every row written once."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(S + T, B, S, H, hd, K,
                                                     T))
    got, lse, seen = _schedule(q, k, v, causal, window)
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                 window=window)
    assert (seen == 1).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
    if T < S:                      # the rows that see no key: mean(v)
        mean_v = v.mean(dim=1, keepdim=True).repeat_interleave(H // K, 2)
        torch.testing.assert_close(got[:, :S - T], mean_v.expand(
            B, S - T, H, hd), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,S,H,hd,K,T,causal,window", SCHEDULE_CASES)
def test_schedule_matches_pallas_interpret(B, S, H, hd, K, T, causal,
                                           window):
    """The same schedule against the JAX package's Pallas kernel, run in
    interpret mode through its jitted ``kernels.ops`` wrapper, within
    2e-5."""
    arrs = _inputs(S + T, B, S, H, hd, K, T)
    got, _, _ = _schedule(*(torch.from_numpy(a) for a in arrs), causal,
                          window)
    want = jops.flash_attention(*(jnp.asarray(a) for a in arrs),
                                causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
