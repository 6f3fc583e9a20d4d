"""The whole step's share of the card's bf16 peak, in %: the model FLOPs of
the work done in the window (the prompts of requests whose first token came
inside it, each token at its own context length, and every output token
decoded inside it) over the engine steps' wall time in the window times the
peak."""
from servebench import flops


def compute(record):
    if not record.steps or record.device_name == "cpu":
        return None
    model, work = record.model, 0
    for r in record.requests:
        if record.t_open <= r["first"] < record.t_close:
            work += flops.prompt_flops(model, r["prompt_len"])
        work += flops.decode_flops(model, r["prompt_len"], r["gen_open"],
                                   r["gen_close"])
    wall = sum(s[1] for s in record.steps)
    peak = flops.peaks(record.device_name)["bf16_flops"]
    return 100.0 * work / (wall * peak)
