"""The port's public surface against the JAX package's, name for name.

For every module of ``src/repro/`` the port's counterpart in
``src/repro_torch/`` (the same path, or the one ``RENAMES`` gives) must
hold each public name of the reference's: the names in ``__all__``, or
else each top-level ``def``, ``class`` and assignment without a leading
underscore. For each public function, every parameter name of the
reference's must be a parameter of the port's (a JAX ``key`` is the port's
``generator``). Both packages are read with ``ast`` and neither is
imported, so the test needs no JAX and runs in a second.

The deliberate differences are the entries of ``EXCEPTIONS``, each with its
reason. An entry that no longer matches a difference fails the test, so the
table cannot go stale. When a case fails: port the name the reference has,
or, if the port rightly does without it, add an entry with its reason.

    PYTHONPATH=src python -m pytest -q tests/test_torch_surface.py
"""
import ast
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

# the reference's module -> its counterpart's path, where they differ
RENAMES = {"core/tpu_catalog.py": "core/gpu_catalog.py",
           "launch/hlo_analysis.py": "launch/step_analysis.py",
           "checkpoint/store.py": "checkpoint.py",
           "checkpoint/__init__.py": "checkpoint.py"}
# a parameter of the reference's -> the port's name for it, in every function
PARAM_RENAMES = {"key": "generator"}

_PYTREE = "a JAX typing alias"
_TILES = "a Pallas tile size or interpret flag; the CUDA kernel picks its own"
_INIT = ("the port draws every leaf in checkpoint.init_params (param_shapes, "
         "_init_std), with the same distributions")
_JIT = "wraps jax.jit; the port's step functions run eagerly"
_TPU = "TPU catalog; the H100 one is h100_catalog, build_gpu_problem, " \
       "plan_gpu_fleet"
_HLO = "parses XLA's HLO; step_analysis.analyze_step traces on meta tensors"
_SSD_NAMES = "the SSD inputs Bm and Cm are named B and C"

# (module,) a whole module; (module, name) a public name; (module, name,
# parameter) one parameter of a public function
EXCEPTIONS = {
    ("kernels/pltpu_compat.py",): "Pallas TPU compiler-parameter shim",
    ("launch/reanalyze.py",): "re-reads stored HLO dumps; the port stores "
                              "none and re-runs dryrun in seconds",
    ("kernels/flash_attention.py", "NEG_INF"): "the Pallas body's mask "
                                               "constant",
    ("kernels/flash_attention.py", "flash_attention", "bq"): _TILES,
    ("kernels/flash_attention.py", "flash_attention", "bk"): _TILES,
    ("kernels/flash_attention.py", "flash_attention", "interpret"): _TILES,
    ("kernels/ops.py", "flash_attention", "bq"): _TILES,
    ("kernels/ops.py", "flash_attention", "bk"): _TILES,
    ("kernels/ops.py", "ssd_scan", "Bm"): _SSD_NAMES,
    ("kernels/ops.py", "ssd_scan", "Cm"): _SSD_NAMES,
    ("kernels/ssd_scan.py", "ssd_scan", "Bm"): _SSD_NAMES,
    ("kernels/ssd_scan.py", "ssd_scan", "Cm"): _SSD_NAMES,
    ("kernels/ssd_scan.py", "ssd_scan", "interpret"): _TILES,
    ("kernels/rglru_scan.py", "rglru_scan", "block_seq"): _TILES,
    ("kernels/rglru_scan.py", "rglru_scan", "block_w"): _TILES,
    ("kernels/rglru_scan.py", "rglru_scan", "interpret"): _TILES,
    ("models/layers.py", "init_norm"): _INIT,
    ("models/layers.py", "init_attention"): _INIT,
    ("models/layers.py", "init_mlp"): _INIT,
    ("models/layers.py", "init_embed"): _INIT,
    ("models/moe.py", "init_moe"): _INIT,
    ("models/ssm.py", "init_ssd"): _INIT,
    ("models/rglru.py", "init_rglru"): _INIT,
    ("models/model.py", "init_block"): _INIT,
    ("models/model.py", "init_params"): _INIT,
    ("models/ssm.py", "ssd_scan_ref"): "lives in kernels/ref.py",
    ("models/rglru.py", "rglru_scan_ref"): "lives in kernels/ref.py",
    ("models/steps.py", "make_jitted_train_step"): _JIT,
    ("models/steps.py", "make_jitted_prefill"): _JIT,
    ("models/steps.py", "make_jitted_decode"): _JIT,
    ("models/steps.py", "make_jitted_prefill_into_slot"): _JIT,
    ("optim/adamw.py", "Pytree"): _PYTREE,
    ("models/model.py", "Pytree"): _PYTREE,
    ("models/steps.py", "Pytree"): _PYTREE,
    ("checkpoint/store.py", "Pytree"): _PYTREE,
    ("launch/sharding.py", "Pytree"): _PYTREE,
    ("launch/sharding.py", "to_named"): "makes jax NamedShardings; the port's "
                                        "specs are DTensor placements",
    ("launch/sharding.py", "param_spec", "stacked"): "the port's per-layer "
                                                     "lists have no stacked "
                                                     "layer dim",
    ("core/tpu_catalog.py", "MFU"): "a TPU speed figure the port must not "
                                    "carry",
    ("core/tpu_catalog.py", "tpu_catalog"): _TPU,
    ("core/tpu_catalog.py", "build_tpu_problem"): _TPU,
    ("core/tpu_catalog.py", "plan_tpu_fleet"): _TPU,
    ("launch/hlo_analysis.py", "analyze_hlo"): _HLO,
    ("launch/hlo_analysis.py", "summarize_compiled"): _HLO,
    ("launch/dryrun.py", "MICROBATCHES"): "per-arch microbatches sized to a "
                                          "TPU's memory",
    ("launch/dryrun.py", "build_lowered"): "lowers with jax; the port's "
                                           "dryrun.build traces eagerly",
    ("launch/dryrun.py", "run_one", "hlo_dir"): "the port stores no HLO dumps",
    ("launch/dryrun.py", "run_one", "tag"): "names the HLO dump files",
}

MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _text(path: Path) -> str:
    return path.read_text()


def _port_text(rel: str) -> str:
    """The source of the port's module ``rel`` (a path under repro_torch)."""
    return _text(PORT / rel)


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


def _names(source: str) -> tuple:
    """({name: parameters for a function, else None}, the ``from``
    imports as {name: (module, its name there)}, ``__all__`` or None), of
    the module's top-level statements."""
    defs, imports, all_ = {}, {}, None
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            defs[node.name] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names = [n for t in targets
                     for n in (t.elts if isinstance(t, ast.Tuple) else [t])
                     if isinstance(n, ast.Name)]    # not `f.attr = ...`
            for n in names:
                defs[n.id] = None
                if n.id == "__all__":
                    all_ = [e.value for e in node.value.elts]
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                imports[a.asname or a.name] = (node.module, a.name)
    return defs, imports, all_


def _public(source: str) -> dict:
    """The reference module's public names: {name: parameters or None}."""
    defs, _, all_ = _names(source)
    if all_ is not None:
        return {n: defs.get(n) for n in all_}
    return {n: p for n, p in defs.items() if not n.startswith("_")}


def _port_module_path(module: str) -> str | None:
    """A ``repro_torch.x.y`` module's path under repro_torch, if it is one."""
    parts = module.split(".")
    if parts[0] != "repro_torch":
        return None
    base = "/".join(parts[1:])
    for rel in (f"{base}.py", f"{base}/__init__.py"):
        if (PORT / rel).exists():
            return rel
    return None


def _port_entry(rel: str, name: str):
    """(present, parameters or None) of ``name`` in the port's module
    ``rel``, following the port's own imports to the definition."""
    defs, imports, _ = _names(_port_text(rel))
    if name in defs:
        return True, defs[name]
    if name not in imports:
        return False, None
    module, orig = imports[name]
    target = _port_module_path(module)
    return _port_entry(target, orig) if target else (True, None)


def module_gaps(rel: str) -> list:
    """The differences of the port's counterpart of the reference's module
    ``rel``, in ``EXCEPTIONS``' key form, before the exceptions apply."""
    port_rel = RENAMES.get(rel, rel)
    if not (PORT / port_rel).exists():
        return [(rel,)]
    gaps = []
    for name, ref_params in _public(_text(REF / rel)).items():
        present, port_params = _port_entry(port_rel, name)
        if not present:
            gaps.append((rel, name))
            continue
        if ref_params is None:
            continue
        have = set(port_params or ())
        gaps += [(rel, name, p) for p in ref_params
                 if PARAM_RENAMES.get(p, p) not in have]
    return gaps


def check(rel: str) -> tuple:
    """(the gaps no exception covers, the exceptions of ``rel`` that match
    no gap)."""
    gaps = module_gaps(rel)
    stale = [k for k in EXCEPTIONS if k[0] == rel and k not in gaps]
    return [g for g in gaps if g not in EXCEPTIONS], stale


_PLANTED = {
    # a public name of the reference taken from its counterpart
    "planted-missing-name": (
        "launch/serve.py", "def serve(", "def _serve(",
        [("launch/serve.py", "serve")], []),
    # a parameter of the reference's renamed in the port
    "planted-missing-parameter": (
        "models/layers.py", "positions: torch.Tensor | None = None",
        "pos: torch.Tensor | None = None",
        [("models/layers.py", "attention_full", "positions")], []),
    # an exception for a name the port has: the table's entry is stale
    "planted-stale-exception": (
        "models/vgg.py", None, None, [], [("models/vgg.py", "init_zf")]),
}


@pytest.mark.parametrize("case", MODULES + sorted(_PLANTED))
def test_public_surface(case, monkeypatch):
    if case in MODULES:
        gaps, stale = check(case)
        assert not gaps, f"{case}: the port lacks {gaps}"
        assert not stale, f"{case}: EXCEPTIONS entries match nothing: {stale}"
        return
    # a planted fault must show as a gap, or as a stale entry
    rel, old, new, want_gaps, want_stale = _PLANTED[case]
    if old is not None:
        port_rel = RENAMES.get(rel, rel)
        real = _port_text(port_rel)
        assert old in real
        this = sys.modules[__name__]
        monkeypatch.setattr(this, "_port_text", lambda r: real.replace(
            old, new) if r == port_rel else _text(PORT / r))
    for key in want_stale:
        monkeypatch.setitem(EXCEPTIONS, key, "planted")
    assert check(rel) == (want_gaps, want_stale)


def test_exceptions_name_reference_modules_and_give_reasons():
    for key, reason in EXCEPTIONS.items():
        assert key[0] in MODULES, key
        assert 1 <= len(key) <= 3 and isinstance(reason, str) and reason
    assert set(RENAMES) <= set(MODULES)
    assert all((PORT / p).exists() for p in RENAMES.values())
