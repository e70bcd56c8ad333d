"""Share of the batched decode step's roofline over the window: each
step's bound (``step``: its operations at the configuration's peak or its
bytes at the HBM rate, whichever is longer) summed over the device time of
everything launched inside the calls to ``models/steps.py::decode_step``,
the kernels of a replayed CUDA graph among them, by the trace, in %.

A step serves the window's mean occupied slots (the engine's
``slot_occupancy`` x the traffic's ``max_slots``), each row at the frame's
length, the fewest positions a decode step's row attends. Its bytes:
every matmul weight read once (an MoE layer's by ``counts_moe.moe_bytes``:
the router, the shared expert, the held experts its rows are expected to
touch, the layer's input and output), the output head, and each row's
state: an attention layer's keys and values read, an SSD layer's fp32
state read and written. Its operations: two per matmul weight a row, the
head, the attention products or the SSD state work (``counts``), and each
MoE layer's. The conv history, the norms and the new position's writes are
left out, so the bound is a floor."""
from metrics import counts, counts_moe, peaks

SPANS = {"decode": {"target": "repro_torch.models.steps:decode_step",
                    "sync": True}}


def step(c: dict, rows: float, ctx: int) -> tuple[float, float]:
    """(flops, bytes) of one decode step of ``rows`` rows at ``ctx``
    positions each."""
    e = counts.ESIZE[c["dtype"]]
    D, V = c["d_model"], c["vocab_size"]
    weights, moe_bytes, state = D * V, 0.0, 0.0
    flops = 2.0 * D * V * rows + counts._mixing_flops(c, rows, rows * ctx)
    for mixer, ffn in counts._kinds(c):
        w = counts._mixer_matmul(c, mixer)
        if ffn == "moe":
            flops += counts_moe.moe_flops(c, rows)
            moe_bytes += counts_moe.moe_bytes(c, rows)
        else:
            w += counts._ffn_matmul(c, ffn)
        weights += w
        flops += 2.0 * w * rows
        if mixer in ("attn", "attn_window"):
            state += 2 * e * rows * ctx * c["num_kv_heads"] * c["head_dim"]
        elif mixer == "ssd":
            _, H, P, N = counts._ssd_sizes(c)
            state += 2 * 4 * rows * H * P * N
    return flops, e * weights + moe_bytes + state


def read(run):
    occupancy = run.engine_report.get("slot_occupancy")
    if not occupancy:
        return None
    rows = occupancy * run.traffic["max_slots"]
    ctx = min(n for n, _ in run.traffic["frame_tokens"])
    flops, nbytes = step(run.config, rows, ctx)
    bound = max(flops / peaks.flops_of(run.config),
                nbytes / peaks.HBM_BYTES_PER_S)
    return counts.roofline_pct((run.spans.between("decode", *run.window),
                                lambda info: bound))
