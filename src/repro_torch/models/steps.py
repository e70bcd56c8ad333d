"""Step functions: train (with microbatch gradient accumulation), prefill,
decode and prefill-into-slot, ported from ``repro.models.steps``. PyTorch
runs eagerly, so there is no jit wrapper; on the card a serving engine's
decode step is replayed from a CUDA graph captured once (``DecodeGraph``).

``train_step`` differentiates ``model.loss_fn`` with ``torch.autograd``:
with the kernels on, flash attention's gradient is the CUDA backward kernel
(``kernels.ops.FlashAttention``), and the SSD and RG-LRU kernels, which
have no backward yet, refuse grad on the card (train those models with
``ModelOptions(use_kernels=False)``). The update is AdamW in place. The
serving steps run under ``torch.no_grad()``.

On a mesh the state and the batch are DTensors (``launch.sharding``) and
the same code runs under ``implicit_replication`` (a plain tensor made
inside the model, a mask or positions, counts as replicated). With
``TrainOptions.batch_axes`` the microbatch split is redistributed so each
microbatch's batch dim stays on the data axes, the reference's
``with_sharding_constraint``.

``serving_span`` is the serving path's switch for its spans on the program
tracer of ``obs.trace``: on while a torch profiler records, a no-op
otherwise. With it ``decode_step`` is a ``steps.decode`` span, the host's
issue of the step, which returns before the card has run it.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch import checkpoint
from repro_torch.launch.sharding import constrain
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    microbatches: int = 1            # gradient-accumulation steps per batch
    opt: AdamWConfig = AdamWConfig()
    schedule_total: int = 10_000
    schedule_warmup: int = 100
    # mesh axes carrying the batch dim: when set, the microbatch split of a
    # DTensor batch keeps each microbatch's batch dim on them (otherwise
    # the (n, B/n, ...) reshape may leave microbatches replicated)
    batch_axes: tuple = ()


def init_train_state(cfg: ArchConfig, generator: torch.Generator, dtype,
                     topts: TrainOptions, device="cuda") -> dict:
    """{"params": ``checkpoint.init_params`` drawn on ``generator``, "opt":
    ``adamw_init``}, on ``device``."""
    params = checkpoint.init_params(cfg, generator, dtype, device=device)
    return {"params": params, "opt": adamw_init(params, topts.opt)}


def _split_microbatches(batch: dict, n: int, batch_axes=()) -> dict:
    """(B, ...) -> (n, B/n, ...) for every tensor with a batch dimension; a
    0-d tensor is repeated n times. With ``batch_axes``, a DTensor result is
    redistributed so the per-microbatch batch dim (dim 1) carries those
    mesh axes and the microbatch dim (dim 0) is replicated; a plain tensor
    is unchanged."""
    def split(x):
        if x.dim() == 0:
            return x.expand(n)
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n} microbatches")
        out = x.reshape(n, B // n, *x.shape[1:])
        if batch_axes:
            out = constrain(out, (None, tuple(batch_axes),
                                  *([None] * (out.dim() - 2))))
        return out
    return {k: split(v) for k, v in batch.items()}


def compute_grads(params, batch: dict, cfg: ArchConfig,
                  opts: M.ModelOptions, topts: TrainOptions):
    """The loss, its metrics and the gradient of every parameter (a tree
    shaped as ``params``), averaged over ``topts.microbatches`` as the
    reference does: with one microbatch the gradients are in the
    parameters' dtype and the metrics are ``loss_fn``'s; with n, fp32 sums
    of the n gradients and losses times 1/n, and no other metric. A leaf the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives."""
    # detached aliases: the caller's tensors keep requires_grad False
    live = map_tree(lambda p: p.detach().requires_grad_(), params)
    flat = leaves(live)

    def grad_of(b):
        loss, metrics = M.loss_fn(live, b, cfg, opts)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, gs)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    if topts.microbatches <= 1:
        loss, metrics, grads = grad_of(batch)
    else:
        mb = _split_microbatches(batch, topts.microbatches,
                                 topts.batch_axes)
        # zeros_like keeps a DTensor parameter's placements
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        loss = 0.0
        for i in range(topts.microbatches):
            l, _, gs = grad_of({k: v[i] for k, v in mb.items()})
            for acc, g in zip(grads, gs):
                acc.add_(g)
            loss = loss + l
        k = 1.0 / topts.microbatches
        grads = [g * k for g in grads]
        loss = loss * k
        metrics = {}
    it = iter(grads)
    return loss, metrics, map_tree(lambda _: next(it), params)


def train_step(state: dict, batch: dict, cfg: ArchConfig,
               opts: M.ModelOptions, topts: TrainOptions):
    """One optimizer step; gradients averaged over ``topts.microbatches``.
    The learning-rate scale is read at the step counter before the update.
    The parameters and moments are updated in place. Returns
    (state, {"loss", "grad_norm", and with one microbatch "ce_loss",
    "aux_loss", "tokens"})."""
    params = state["params"]
    loss, metrics, grads = compute_grads(params, batch, cfg, opts, topts)
    lr_scale = cosine_schedule(state["opt"]["step"],
                               warmup=topts.schedule_warmup,
                               total=topts.schedule_total)
    params, opt, opt_metrics = adamw_update(params, grads, state["opt"],
                                            topts.opt, lr_scale)
    return {"params": params, "opt": opt}, {"loss": loss, **opt_metrics,
                                            **metrics}


@torch.no_grad()
def prefill_step(params, batch: dict, cfg: ArchConfig, opts: M.ModelOptions,
                 cache_len: int):
    return M.prefill(params, batch, cfg, opts, cache_len)


@torch.no_grad()
def decode_step(params, cache: list, batch: dict, cfg: ArchConfig,
                opts: M.ModelOptions, graph: DecodeGraph | None = None):
    """``batch["pos"]`` may be an int (lock-step batch) or a (B,) tensor of
    per-slot positions (continuous batching). The cache is updated in
    place. With ``graph``, a step on the input it was captured for
    (``DecodeGraph.takes``) is a replay of it, and returns a copy of the
    graph's logits; any other input runs eagerly."""
    with serving_span()("steps.decode"):
        if graph is not None and graph.takes(params, cache, batch):
            return graph.replay(batch["token"], batch["pos"]), cache
        return M.decode_step(params, batch["token"], batch["pos"], cache,
                             cfg, opts)


def _cache_storage(cache: list) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape)) for layer in cache
                 for t in layer.values())


def _tf32() -> tuple:
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


class DecodeGraph:
    """``M.decode_step`` of ``slots`` rows at per-row positions, captured
    once as a CUDA graph over one engine's ``params`` and ``cache`` (plain
    CUDA tensors): every step then replays the same kernels on the same
    tensors, and the host issues one graph launch instead of each kernel.

    Built: static ``token`` and ``pos`` buffers of (slots,), one eager
    warm-up step on a side stream (the kernels' first calls, cuBLAS's
    workspaces), then the capture, then the cache zeroed again, so the
    engine starts as without the graph. A kernel wrapper's ``launches``
    counts its calls, so the warm-up and the capture count and a replay,
    which calls no wrapper, does not. ``replays`` counts the replays."""

    def __init__(self, params, cache: list, cfg: ArchConfig,
                 opts: M.ModelOptions, slots: int):
        self.params = params
        dev = params["embed"]["embedding"].device
        self.token = torch.zeros(slots, dtype=torch.long, device=dev)
        self.pos = torch.zeros(slots, dtype=torch.long, device=dev)
        self.replays = 0
        self._storage, self._flags = _cache_storage(cache), _tf32()
        with torch.no_grad(), torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                M.decode_step(params, self.token, self.pos, cache, cfg, opts)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.logits, _ = M.decode_step(params, self.token, self.pos,
                                               cache, cfg, opts)
            for layer in cache:
                for t in layer.values():
                    t.zero_()

    def takes(self, params, cache: list, batch: dict) -> bool:
        """Whether a step is the one captured: the same ``params`` object,
        the cache's tensors where they were, (slots,) token and position
        tensors, and the TF32 flags of the capture."""
        tok, pos = batch["token"], batch["pos"]
        return (params is self.params
                and isinstance(pos, torch.Tensor)
                and pos.shape == self.pos.shape
                and isinstance(tok, torch.Tensor)
                and tok.shape == self.token.shape
                and _tf32() == self._flags
                and _cache_storage(cache) == self._storage)

    def replay(self, token: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One step: the inputs into the static buffers, the graph
        replayed; returns a copy of its logits (B, V), which the next
        replay would overwrite."""
        self.token.copy_(token)
        self.pos.copy_(pos)
        self.graph.replay()
        self.replays += 1
        return self.logits.clone()


@torch.no_grad()
def prefill_into_slot_step(params, cache: list, batch: dict, slot: int,
                           cfg: ArchConfig, opts: M.ModelOptions,
                           cache_len: int):
    """Prefill ONE request (leading batch dim of 1) and write its KV into
    row ``slot`` of an existing batched cache — the admission primitive of
    continuous batching: a new request joins a running pool without
    re-prefilling the other slots. Returns (last-position logits (V,),
    the batched cache, updated in place)."""
    logits, one = M.prefill(params, batch, cfg, opts, cache_len)
    return logits[0], M.insert_cache_slot(cache, one, slot)


_NO_SPAN = contextlib.nullcontext()


def _no_span(name: str, t: float = 0.0, **attrs):
    return _NO_SPAN


def serving_span():
    """``span`` of ``obs.trace.program_tracer()`` while a torch profiler
    records on the calling thread, else a no-op of the same call, whose
    context yields None: profiling the process turns the serving path's
    spans on. The ``obs`` package, which pulls in the planner, is imported
    only then. The program tracer keeps one stack of open spans, so one
    thread at a time serves while a profiler records."""
    if not torch.autograd._profiler_enabled():
        return _no_span
    from repro_torch.obs.trace import program_tracer
    return program_tracer().span
