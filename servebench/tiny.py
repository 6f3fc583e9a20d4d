"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for the
tests: the same files, traffic kinds and harness path, with a reduced model
(the family's ``tiny``: two layers, width 128), sixteen slots an instance
and short requests.

``TINY_GAP_LIMIT`` is the dense check's limit at this size: sound CPU runs
read a widest gap of 0.001-0.026, the float8 control 0.34-0.54 (six seeds
each). The tiny MoE model is not held to it: at width 128 with 4 experts a
routed token sits near a tie between two experts so often that rounding
moves its served tokens as far as the control's (widest 0-2.7, mean 0-0.038
against the control's 0.05-0.15 over eight seeds); its control is tested on
the card at full size."""
from __future__ import annotations

import copy

from servebench import bench, families

TINY_GAP_LIMIT = 0.1


def tiny_cell(name: str, root=bench.ROOT) -> bench.Cell:
    cell = bench.resolve(name, root=root)
    config = copy.deepcopy(cell.config)
    config["model"] = families.load(config["model"]).tiny(config["model"])
    config["engine"].update(
        max_slots=16, max_seq=112,
        prefill_chunk=16 if config["engine"]["prefill_chunk"] else 0)
    config["check"] = {"max_logit_gap": TINY_GAP_LIMIT, "sample_requests": 4,
                       "min_tokens": 10}
    traffic = copy.deepcopy(cell.traffic)
    traffic["prompt"].update(min=8, max=64, mean=32)
    if traffic["loop"] == "open":
        traffic["output"].update(min=24, max=48, mean=32)
        # enough load that the killed instance has requests in flight, and
        # slots to spare on its peer for them to resume in
        traffic.update(rate_rps=16.0, grace_s=20)
        if traffic.get("kill"):
            # the warm spare back well inside the 4 s window, so the ring
            # is whole again at the close, where the replicas are read back
            traffic["kill"]["rejoin_delay_s"] = 1.0
    else:
        traffic["output"].update(min=8, max=24, mean=12)
        traffic.update(clients=16, stagger_s=0.5)
    cell.config, cell.traffic = config, traffic
    return cell
