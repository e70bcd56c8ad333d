#!/usr/bin/env python3
"""Time two versions of the port's flash-attention (forward and backward),
SSD-scan and RG-LRU kernels on one GPU, in turns, from one command.

    python3 benchmarks/port/kernel_ab.py --ab build/parent/src

runs four processes one after another on the same card: the kernels under
``build/parent/src`` (the ``src/`` directory of another commit, unpacked
there with ``git archive <commit> src/repro_torch | tar -x -C
build/parent``), this checkout's, this checkout's again, and the other
commit's again (A, B, B, A), and prints one JSON line per process and a
summary. ``--src DIR`` runs one process against the ``repro_torch`` under
``DIR``. Each process builds its kernels with that version's own build code
and measures, in fp32 at each shape below:

- device ms per call: ``torch.profiler`` intervals of every device kernel
  named after the wrapper (all of an SSD call's kernels), over 50 calls;
- ms per call issued back to back: CUDA events over 200 calls;
- host enqueue ms per call: a host clock over 200 calls, no synchronise;

with ``chip_smoke.py``'s timing helpers; with ``--drain ARCH`` each process
also profiles one drain of 8 requests on full-width ARCH
(``chip_smoke.profile_serving``: wall time, device busy time and idle share,
device time by kernel) through that version's model and engine. For the
RG-LRU: the scan at the
recurrentgemma-9b prefill shape and a long one; the unfused sequence the
served path ran before the fused kernel (the gates in torch ops, then the
scan kernel in prefill or the in-place state update in decode, then the
gelu gating; its device time is every device kernel of the calls), in
either version; and, where the version has it, the fused
``rglru_gated_scan``, at the prefill and at the 8-slot decode. The flash
backward at olmo-1b's training shape (8, 256, 16, 128) causal, in fp32 and
bf16, from the forward's output and lse (its device time is every device
kernel named ``flash_attention_bwd``: Δ, dkdv and dq). ``--only KIND ...``
measures only those kinds (flash, flash_bwd, ssd, rglru, and train, which
only ``--only`` asks for: full-width olmo-1b, fp32, batch 8 × 256, through
that version's ``models.steps.train_step`` with its kernels, one step to
warm up and then ``TRAIN_STEPS`` steps on a host clock that ends in a
synchronise).

Needs a CUDA GPU; imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (its timing helpers; it imports no kernel)

# B, S, H, hd, K, T, window (causal)
FLASH_SHAPES = [(1, 32, 16, 128, 16, 32, 0), (1, 32, 16, 256, 1, 32, 2048),
                (1, 1024, 16, 128, 16, 1024, 0),
                (1, 1024, 16, 256, 1, 1024, 256)]
# b, s, h, p, g, n, chunk
SSD_SHAPES = [(1, 128, 80, 64, 1, 128, 128), (1, 2048, 16, 64, 2, 128, 128)]
# B, S, W (RG-LRU scan); B, S, W, with an initial state (fused form)
RGLRU_SHAPES = [(1, 32, 4096), (1, 2048, 4096)]
GATED_SHAPES = [(1, 32, 4096, False), (8, 1, 4096, True)]
# B, S, H, hd, K (causal, T == S): olmo-1b's training shape
FLASH_BWD_SHAPES = [(8, 256, 16, 128, 16)]
KINDS = ("flash", "flash_bwd", "ssd", "rglru")
TRAIN_STEPS = 6


def unfused_rglru(torch, rg, r_pre, i_pre, xc, gate_pre, lam, h0):
    """The RG-LRU of one layer after its projections as the served path ran
    it before the fused kernel: the gates in torch ops, the scan kernel (h0
    None: a prefill) or the in-place state update (a decode), the gating."""
    F = torch.nn.functional
    r = torch.sigmoid(r_pre.float())
    i = torch.sigmoid(i_pre.float())
    a = torch.exp(-8.0 * F.softplus(lam) * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xc.float())
    if h0 is None:
        h = rg.rglru_scan(a.contiguous(), b.contiguous())
    else:
        h = h0.mul_(a[:, 0]).add_(b[:, 0])[:, None]
    return h.to(xc.dtype) * F.gelu(gate_pre, approximate="tanh")


def _times(torch, run, kernel: str) -> dict:
    return {"device_ms": chip_smoke.device_ms(torch, run, kernel)[0],
            "back_to_back_ms": chip_smoke.cuda_ms(torch, run),
            "host_enqueue_ms": chip_smoke.host_enqueue_ms(torch, run)}


def measure(src: str, label: str, drain: str = "",
            kinds=KINDS) -> dict:
    """One version's times; runs in a process of its own."""
    sys.path.insert(0, os.path.abspath(src))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
    rg = importlib.import_module("repro_torch.kernels.rglru_scan")
    assert os.path.abspath(fa.__file__).startswith(os.path.abspath(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.build()
    if "ssd" in kinds or drain:
        ssd.build()
    if "rglru" in kinds or drain:
        rg.build()
    out = {"label": label, "src": src, "card": _card(),
           **{kind: {} for kind in kinds}}
    if "train" in kinds:
        out["train"]["olmo-1b (8, 256) fp32"] = train_times(torch)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for B, S, H, hd, K in FLASH_BWD_SHAPES if "flash_bwd" in kinds else ():
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (torch.randn((B, S, H, hd), generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((B, S, K, hd), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
            o = fa.flash_attention(q, k, v, causal=True, lse=lse)
            run = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=True)
            out["flash_bwd"][f"{(B, S, H, hd, K)} {str(dtype)[6:]}"] = \
                _times(torch, run, "flash_attention_bwd")
    for B, S, H, hd, K, T, window in (FLASH_SHAPES if "flash" in kinds
                                      else ()):
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda")
        k = torch.randn((B, T, K, hd), generator=gen, device="cuda")
        v = torch.randn((B, T, K, hd), generator=gen, device="cuda")
        run = lambda: fa.flash_attention(q, k, v, causal=True, window=window)
        out["flash"][str((B, S, H, hd, K, T, window))] = {
            "device_ms": chip_smoke.device_ms(torch, run,
                                              "flash_attention_kernel")[0],
            "back_to_back_ms": chip_smoke.cuda_ms(torch, run),
            "host_enqueue_ms": chip_smoke.host_enqueue_ms(torch, run)}
    for b, s, h, p, g, n, L in SSD_SHAPES if "ssd" in kinds else ():
        x = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dt = torch.rand((b, s, h), generator=gen, device="cuda") * 0.099 \
            + 0.001
        A = -(torch.rand((h,), generator=gen, device="cuda") * 1.5 + 0.5)
        Bm = torch.randn((b, s, g, n), generator=gen, device="cuda")
        Cm = torch.randn((b, s, g, n), generator=gen, device="cuda")
        run = lambda: ssd.ssd_scan(x, dt, A, Bm, Cm, L)
        out["ssd"][str((b, s, h, p, g, n, L))] = {
            "device_ms": chip_smoke.device_ms(torch, run,
                                              "ssd_scan_kernel")[0],
            "back_to_back_ms": chip_smoke.cuda_ms(torch, run),
            "host_enqueue_ms": chip_smoke.host_enqueue_ms(torch, run)}
    for B, S, W in RGLRU_SHAPES if "rglru" in kinds else ():
        a = torch.rand((B, S, W), generator=gen, device="cuda") * 0.299 + 0.7
        b = torch.randn((B, S, W), generator=gen, device="cuda")
        out["rglru"][f"scan {(B, S, W)}"] = _times(
            torch, lambda: rg.rglru_scan(a, b), "rglru_scan_kernel")
    for B, S, W, with_h0 in GATED_SHAPES if "rglru" in kinds else ():
        ins = [torch.randn((B, S, W), generator=gen, device="cuda")
               for _ in range(4)]
        u = torch.rand((W,), generator=gen, device="cuda") * 0.187 + 0.81
        lam = torch.log(torch.expm1(-torch.log(u) / 16.0))
        h0 = (torch.randn((B, W), generator=gen, device="cuda") if with_h0
              else None)
        shape = (B, S, W)
        out["rglru"][f"unfused {shape}"] = _times(
            torch, lambda: unfused_rglru(torch, rg, *ins, lam, h0), "")
        if hasattr(rg, "rglru_gated_scan"):
            out["rglru"][f"fused {shape}"] = _times(
                torch, lambda: rg.rglru_gated_scan(*ins, lam, h0, h0),
                "rglru_gated_scan_kernel")
    if drain:
        wrappers = {"flash_attention": fa.flash_attention,
                    "ssd_scan": ssd.ssd_scan, "rglru_scan": rg.rglru_scan}
        if hasattr(rg, "rglru_gated_scan"):
            wrappers["rglru_gated_scan"] = rg.rglru_gated_scan
        out["drain"] = chip_smoke.profile_serving(torch, drain, wrappers)
    return out


def train_times(torch) -> dict:
    """Full-width olmo-1b fp32 training steps through the version under
    test: the mean step time (host clock, synchronised) and tokens/s."""
    import time
    steps = importlib.import_module("repro_torch.models.steps")
    model = importlib.import_module("repro_torch.models.model")
    pipeline = importlib.import_module("repro_torch.data.pipeline")
    config = importlib.import_module("repro_torch.models.config")
    cfg = config.get_config("olmo-1b")
    topts, opts = steps.TrainOptions(), model.ModelOptions()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = steps.init_train_state(cfg, gen, torch.float32, topts,
                                   device="cuda")
    shape = pipeline.InputShape("custom_train", 256, 8, "train")
    batches = [pipeline.make_batch(cfg, shape, seed=i)
               for i in range(TRAIN_STEPS + 1)]
    state, _ = steps.train_step(state, batches[0], cfg, opts, topts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, _ = steps.train_step(state, b, cfg, opts, topts)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    return {"step_s": step_s, "tokens_per_s": 8 * 256 / step_s}


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="measure the repro_torch under DIR")
    ap.add_argument("--label", default="")
    ap.add_argument("--drain", metavar="ARCH", default="",
                    help="also profile one drain of full-width ARCH")
    ap.add_argument("--ab", metavar="OTHER_SRC",
                    help="A/B/B/A: OTHER_SRC, this checkout, this checkout, "
                         "OTHER_SRC, each in a process of its own")
    ap.add_argument("--only", nargs="+", choices=KINDS + ("train",),
                    default=list(KINDS),
                    help="measure only these kinds (train: only if named)")
    args = ap.parse_args()
    if args.src:
        print(json.dumps(measure(args.src, args.label or args.src,
                                 args.drain, args.only)), flush=True)
        return
    if not args.ab:
        ap.error("give --src or --ab")
    order = [(args.ab, "other"), (os.path.join(ROOT, "src"), "this"),
             (os.path.join(ROOT, "src"), "this"), (args.ab, "other")]
    runs = []
    for src, label in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--src", src, "--label", label,
                              "--drain", args.drain, "--only", *args.only],
                             capture_output=True, text=True, cwd=ROOT)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"kernel_ab: the {label} run failed")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    summary = {}
    for kind in args.only:
        shapes = {shape: None for r in runs for shape in r.get(kind, {})}
        for shape in shapes:
            for metric in (("step_s", "tokens_per_s") if kind == "train" else
                           ("device_ms", "back_to_back_ms",
                            "host_enqueue_ms")):
                summary[f"{kind} {shape} {metric}"] = {
                    label: [r[kind][shape][metric] for r in runs
                            if r["label"] == label and shape in r.get(kind,
                                                                      {})]
                    for label in ("other", "this")}
    if args.drain:
        for metric in ("wall_ms", "wall_traced_ms", "device_busy_ms",
                       "device_idle_share"):
            summary[f"drain {args.drain} {metric}"] = {
                label: [r["drain"][metric] for r in runs
                        if r["label"] == label]
                for label in ("other", "this")}
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
