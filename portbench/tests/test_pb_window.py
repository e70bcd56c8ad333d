"""The window's arithmetic: every frame answered over the whole window,
the p90 over every frame, tokens of every step over the window."""
import math

from harness import spec
from conftest import ROOT

CONFIG = {"dtype": "float32", "tf32": False, "d_model": 2048,
          "vocab_size": 50304, "num_layers": 16, "num_heads": 16,
          "num_kv_heads": 16, "head_dim": 128, "d_ff": 8192, "gated": True,
          "block_pattern": [["attn", "mlp"]], "norm": "nonparam_ln",
          "tie_embeddings": True}


def read(name, run):
    return spec.reader(ROOT, name).read(run)


def test_rates_and_tail_take_every_frame_and_all_the_window():
    run = spec.Run(cell={}, config=CONFIG, traffic={})
    run.window = (100.0, 130.0)
    # 20 frames: latencies 0.1, 0.2, ..., 2.0 s
    run.frames = [(100.0 + i, 100.0 + i + 0.1 * (i + 1), 576, 8)
                  for i in range(20)]
    assert read("frames_per_s", run) == 20 / 30.0
    assert math.isclose(read("frame_latency_p90_s", run), 1.8)  # 18th of 20
    run.frames = run.frames[:1]
    assert math.isclose(read("frame_latency_p90_s", run), 0.1)
    run.frames = []
    assert read("frames_per_s", run) is None


def test_training_rate_and_mfu():
    run = spec.Run(cell={}, config=CONFIG, traffic={"batch": 4,
                                                    "seq_len": 2048})
    run.window = (0.0, 12.5)
    run.steps = [8192] * 7
    assert read("train_tokens_per_s", run) == 7 * 8192 / 12.5
    mfu = read("mfu.train", run)
    # 6 x (matmul parameters + head) a token, plus attention, at 67 TFLOP/s
    rough = 6 * 1.1768e9 * 7 * 8192 / 12.5 / 67e12 * 100
    assert rough < mfu < 1.1 * rough


def test_serving_mfu_counts_each_frame_once():
    run = spec.Run(cell={}, config=CONFIG, traffic={})
    run.window = (0.0, 2.0)
    run.frames = [(0.0, 1.0, 576, 8)] * 10
    from metrics import counts
    per = counts.model_flops_frame(CONFIG, 576, 8)
    assert math.isclose(read("mfu.serve", run), 100 * 10 * per / 2 / 67e12)
    # the prefill is ~2 x 1.074e9 matmul parameters x 576 tokens
    assert 1.24e12 < per < 1.3e12
