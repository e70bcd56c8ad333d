"""Per-device roofline inputs of one traced step, the port's counterpart of
``repro.launch.hlo_analysis``, with the reference's record keys.

The reference walks the compiled per-device HLO. The port runs eagerly,
so ``analyze_step`` runs the step itself (on meta tensors in the dry run,
which allocates nothing) under a ``TorchDispatchMode`` that sees every
operation on plain tensors. On a mesh DTensor turns each operation into
operations on the local shards, and it is those that are counted, so every
number is per device. (A counter entered around DTensor operations would
count their global shapes: ``FlopCounterMode`` counts a column-sharded
matrix product whole.) DTensor's own shape propagation, which it runs on
fake tensors of the global shapes, is not counted.

  * ``flops_per_device``: ``torch.utils.flop_counter``'s formulas (matrix
    products, convolutions, attention) over the local operations, and
    ``flops_by_op`` the same by operation;
  * ``bytes_per_device``: operand plus result bytes of every local
    operation that moves data (views move none). The port has no fusion
    boundaries, so this is an unfused upper bound: a fused kernel, as XLA
    would make of an elementwise chain, reads and writes less;
  * ``collective_bytes_per_device`` and ``collectives``: the result bytes
    and the number of each collective, by the reference's five kinds; the
    counts are ``torch.distributed.tensor.debug.CommDebugMode``'s;
  * ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``,
    the local bytes of the step's inputs and outputs.

The reference's XLA-only fields are left out: ``xla_cost_analysis`` (XLA's
own count, which runs each loop body once), ``generated_code_size_in_bytes``
and ``temp_size_in_bytes`` (the compiler's buffer assignment): an eager
program has no compiled code and no buffer plan to read them from.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# collective operations (functional and in-place c10d) by the kind they are
_KIND_OF = (("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("send", "collective-permute"), ("recv", "collective-permute"))
_FREE = ("wait_tensor", "_wrap_tensor_autograd", "empty", "empty_strided",
         "_local_scalar_dense")


def collective_kind(name: str):
    """The reference's kind of a collective operation's name, or None."""
    if "c10d" not in name:
        return None
    for key, kind in _KIND_OF:
        if key in name:
            return kind
    return None


def _nbytes(xs) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(xs)
               if isinstance(t, torch.Tensor))


def local_bytes(tree) -> int:
    """Bytes of every tensor in ``tree``; of a DTensor, its local shard."""
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class _LocalCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and collective bytes of the operations on plain
    tensors. An operation on DTensors is passed on (``NotImplemented``) to
    DTensor, whose operations on the local shards then come back here."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: dict = {}
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVE_KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        leaves = tree_leaves((args, kwargs, out))
        if any(isinstance(t, FakeTensor) for t in leaves):
            return out                    # DTensor's shape propagation
        name = func.name()
        kind = collective_kind(name)
        if kind is not None:
            self.coll[kind] += _nbytes(out)
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        if not func.is_view and not any(f in name for f in _FREE):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def analyze_step(fn, *args) -> tuple:
    """Run ``fn(*args)`` under the counters. Returns (its result, the
    record: ``flops_per_device``, ``bytes_per_device``,
    ``collective_bytes_per_device``, ``collectives`` {``per_kind_bytes``,
    ``counts``} and ``memory``)."""
    counter = _LocalCounter()
    comm = CommDebugMode()
    with comm, counter:
        out = fn(*args)
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for op, n in comm.get_comm_counts().items():
        kind = collective_kind(str(op))
        if kind is not None:
            counts[kind] += n
    rec = {
        "flops_per_device": float(counter.flops),
        "flops_by_op": {k: float(v) for k, v in sorted(
            counter.flops_by_op.items(), key=lambda kv: -kv[1])},
        "bytes_per_device": float(counter.bytes),
        "collective_bytes_per_device": float(sum(counter.coll.values())),
        "collectives": {"per_kind_bytes": counter.coll, "counts": counts},
        "memory": {"argument_size_in_bytes": local_bytes(args),
                   "output_size_in_bytes": local_bytes(out)},
    }
    return out, rec
