"""Request lifecycle + per-request metrics (TTFT, TPOT, latency)."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"         # chunked prefill: prompt chunks interleaved
                                # with decode steps (EngineConfig.prefill_chunk)
    DECODE = "decode"
    MIGRATING = "migrating"     # KevlarFlow: resuming on a replication target
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival_time: float
    prompt_tokens: Optional[list] = None        # real-compute path only

    state: RequestState = RequestState.QUEUED
    generated: int = 0
    instance_id: Optional[int] = None

    # metrics (absolute times; -1 = not yet)
    admit_time: float = -1.0                    # prefill started (last admit)
    first_token_time: float = -1.0
    finish_time: float = -1.0
    n_retries: int = 0
    n_migrations: int = 0
    prefill_progress: float = 0.0

    # replication bookkeeping
    replicated_through: int = 0                 # tokens safely replicated
    replica_node: Optional[int] = None
    migrate_pause: float = 0.0                  # remaining migration stall (s)

    output_tokens: Optional[list] = None

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.arrival_time

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival_time

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.generated

    def restart(self):
        """Standard fault behaviour: lose all progress, re-queue, re-prefill.
        TTFT is *not* reset — the user is still waiting on the same request
        (matches the paper's measurement)."""
        self.state = RequestState.QUEUED
        self.generated = 0
        self.prefill_progress = 0.0
        self.instance_id = None
        self.n_retries += 1
        self.replicated_through = 0
        if self.output_tokens:
            self.output_tokens.clear()
        self.admit_time = -1.0
        self.first_token_time = -1.0    # paper: queue spike re-inflates TTFT

    def timing(self) -> dict:
        """Wire-format timing block (served by the HTTP layer and the
        latency bench): absolute stamps plus the derived TTFT/latency."""
        return {
            "arrival_time": self.arrival_time,
            "admit_time": self.admit_time,
            "first_token_time": self.first_token_time,
            "finish_time": self.finish_time,
            "ttft": self.ttft if self.first_token_time >= 0 else -1.0,
            "latency": self.latency if self.finish_time >= 0 else -1.0,
        }


def summarize(requests: List[Request], span: Optional[float] = None):
    """Aggregate metrics over completed requests (paper Table 1 columns).

    ``span`` (clock units covered by the run) additionally yields goodput:
    completed requests/s and generated tokens/s over the span."""
    import numpy as np

    done = [r for r in requests if r.state == RequestState.DONE]
    if not done:
        return {"n": 0}
    lat = np.array([r.latency for r in done])
    ttft = np.array([r.ttft for r in done if r.first_token_time >= 0])
    tpot = np.array([(r.latency - r.ttft) / max(r.generated, 1) for r in done])
    out = {
        "n": len(done),
        "latency_avg": float(lat.mean()),
        "latency_p99": float(np.percentile(lat, 99)),
        "ttft_avg": float(ttft.mean()),
        "ttft_p99": float(np.percentile(ttft, 99)),
        "tpot_avg": float(tpot.mean()),
        "tpot_p99": float(np.percentile(tpot, 99)),
        "retries": sum(r.n_retries for r in requests),
        "migrations": sum(r.n_migrations for r in requests),
    }
    if span is not None and span > 0:
        out["goodput_req_s"] = len(done) / span
        out["goodput_tok_s"] = sum(r.generated for r in done) / span
    return out
