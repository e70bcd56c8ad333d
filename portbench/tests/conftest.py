"""The benchmark's own tests. Most run on the CPU at reduced sizes: a copy
of the benchmark with small configurations and traffic in a temporary
root, run through the same harness. Tests marked ``card`` need an NVIDIA
Hopper GPU and skip elsewhere (each decides inside itself):

    python -m pytest portbench/tests            # here, on the CPU
    python -m pytest portbench/tests -m card    # on the card
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
for p in (str(PORTBENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# reduced sizes: every width of the cell cut, the shapes' kinds kept
TINY_CONFIGS = {
    "olmo-1b": dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
                    head_dim=64, d_ff=512, vocab_size=512),
    "mamba2-2.7b": dict(num_layers=2, d_model=256, ssm_state=32,
                        ssm_head_dim=32, ssm_chunk=32, vocab_size=512),
}
TINY_TRAFFIC = {
    "frames-576": dict(cameras=4, frame_tokens=[[40, 1.0]], new_tokens=4,
                       max_slots=2, cache_len=48, sample_requests=4),
    "train-2k": dict(batch=2, seq_len=32),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA Hopper GPU; skips elsewhere")


def patch_json(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def tiny_copy(dest: Path) -> Path:
    """A copy of the benchmark under ``dest`` with every configuration and
    traffic mix at a size a CPU runs in seconds."""
    shutil.copytree(PORTBENCH, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    for name, changes in TINY_CONFIGS.items():
        patch_json(dest / "portbench" / "configs" / f"{name}.json", **changes)
    for name, changes in TINY_TRAFFIC.items():
        patch_json(dest / "portbench" / "traffic" / f"{name}.json", **changes)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    """Skip unless an NVIDIA Hopper GPU is here."""
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA Hopper GPU")
