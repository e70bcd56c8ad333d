"""The frozen yardstick against the bounds the port's kernel table
(PERF.md) recorded from the same closed forms."""
import math

from metrics import counts, peaks

OLMO = {"d_model": 2048, "vocab_size": 50304, "num_layers": 16,
        "num_heads": 16, "num_kv_heads": 16, "head_dim": 128, "d_ff": 8192,
        "gated": True, "block_pattern": [["attn", "mlp"]],
        "norm": "nonparam_ln", "tie_embeddings": True}
MAMBA2 = {"d_model": 2560, "vocab_size": 50280, "num_layers": 64,
          "block_pattern": [["ssd", None]], "ssm_state": 128,
          "ssm_head_dim": 64, "ssm_expand": 2, "ssm_conv": 4,
          "norm": "rmsnorm", "tie_embeddings": False}


def ms(flops_bytes):
    return 1e3 * counts.bound_s(*flops_bytes)


def test_flash_bounds_pinned():
    # olmo-1b training forward (8, 256, 16, 128) causal, with lse
    assert round(ms(counts.attention_fwd(8, 256, 16, 128, 16, 256, True, 0,
                                         lse=True)), 6) == 0.032177
    # hubert-xlarge (1, 500, 16, 80) non-causal
    assert round(ms(counts.attention_fwd(1, 500, 16, 80, 16, 500, False,
                                         0)), 6) == 0.019104
    # internvl2-1b (1, 288, 14, 64) over 2 KV heads, causal
    assert round(ms(counts.attention_fwd(1, 288, 14, 64, 2, 288, True,
                                         0)), 6) == 0.002226
    # the backward at the training shape: 5.39 GFLOP, 134 MB
    f, b = counts.attention_bwd(8, 256, 16, 128, 16, True, 0)
    assert round(f / 1e9, 2) == 5.39 and round(b / 1e6) == 134


def test_ssd_bound_pinned():
    f, b = counts.ssd_scan(1, 128, 80, 64, 1, 128, 128)
    assert b == 5_415_232
    assert round(ms((f, b)), 6) == 0.001616
    assert round(f / 1e6, 1) == 86.7


def test_model_flops_pinned():
    assert counts.param_count(OLMO) == 1_176_764_416
    assert round(counts.flops_per_token_closed(OLMO) / 1e9, 5) == 2.35353
    assert counts.param_count(MAMBA2) == 2_830_788_096
    assert counts.matmul_params(OLMO) == 1_073_741_824


def test_visible_pairs_against_a_mask():
    import numpy as np
    for S, T, causal, window in [(7, 7, True, 0), (5, 9, True, 3),
                                 (6, 6, False, 2), (4, 4, False, 0)]:
        p = np.arange(S)[:, None] + T - S
        t = np.arange(T)[None, :]
        vis = np.ones((S, T), bool)
        if causal:
            vis &= t <= p
        if window:
            vis &= t > p - window
        assert counts.visible_pairs(S, T, causal, window) == vis.sum()


def test_peak_of_the_stated_precision():
    assert peaks.flops_of({"dtype": "float32", "tf32": False}) == 67e12
    assert peaks.flops_of({"dtype": "float32", "tf32": True}) == 495e12
    assert math.isclose(peaks.HBM_BYTES_PER_S, 3.35e12)
