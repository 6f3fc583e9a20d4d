"""The routed MLP's share of its roofline, in %: over the port's
``moe.routed_mlp`` spans in the window (decode and serving prefill), the sum
of each call's least time over the sum of its time on the card. A call's
least time is the larger of reading every expert's weights once at the
card's HBM bandwidth and the experts' products for its real tokens (top-k
experts each, 6 d f per token and expert) at the card's bf16 peak. Real
tokens are the enclosing span's ``tokens``: the prompt or chunk, or the
decode batch's active slots, so padding and idle slots count as no work.
None off the card."""
from servebench import flops, program

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def compute(record):
    if record.device_name == "cpu":
        return None
    every = program.all_spans(record)
    found = [s for s in program.spans(record, "moe.routed_mlp")
             if "device_end" in s]
    if not found:
        return None
    m = record.model
    d, f, e, k = m["d_model"], m["d_ff"], m["n_experts"], m["top_k"]
    peaks = flops.peaks(record.device_name)
    weight_s = e * 3 * d * f * ITEMSIZE[m["dtype"]] / peaks["hbm_bytes_per_s"]
    bound = busy = 0.0
    for s in found:
        tokens = program.enclosing_attr(every, s, "tokens") or 0
        bound += max(weight_s, 6 * d * f * k * tokens / peaks["bf16_flops"])
        busy += (s["device_end"] - s["device_start"]) / 1e9
    return 100.0 * bound / busy if busy > 0 else None
