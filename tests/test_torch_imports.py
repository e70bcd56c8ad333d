"""The port stands alone: ``repro_torch`` imports with jax blocked and loads
no module of the JAX package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert "jax" not in {m.split(".")[0] for m, mod in sys.modules.items()
                     if mod is not None}
print(len(names))
"""


def test_port_imports_with_jax_blocked_and_loads_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15      # every module was imported


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s)|from\s+repro\s+import)", re.M)


def test_no_port_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py"))
    assert files
    bad = [str(f.relative_to(SRC)) for f in files
           if _FORBIDDEN.search(f.read_text())]
    assert not bad, bad
