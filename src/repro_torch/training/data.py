"""Token data pipeline: a deterministic synthetic corpus with ShareGPT-shaped
document lengths, packed into LM batches. Nothing is downloaded; the
stream has Zipfian unigram statistics, so losses behave like natural text
rather than uniform noise. numpy ``default_rng`` draws in the reference's
order, so batches equal the reference's bit for bit."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.workload import sharegpt_lengths


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 256
    seed: int = 0
    zipf_a: float = 1.2


class TokenStream:
    """Packed LM batches: documents of ShareGPT-shaped lengths, separated by
    BOS (= 1), concatenated and cut into (batch, seq_len + 1) rows."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        self.rng = np.random.default_rng(dcfg.seed)

    def _doc(self) -> np.ndarray:
        p_len, o_len = sharegpt_lengths(self.rng, 1)
        n = int(p_len[0] + o_len[0])
        toks = self.rng.zipf(self.dcfg.zipf_a, n)
        toks = np.clip(toks, 2, self.cfg.vocab_size - 1)
        return np.concatenate([[1], toks])        # BOS-prefixed

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        need = self.dcfg.batch_size * (self.dcfg.seq_len + 1)
        buf = np.empty(0, np.int64)
        while True:
            while len(buf) < need:
                buf = np.concatenate([buf, self._doc()])
            chunk, buf = buf[:need], buf[need:]
            tokens = chunk.reshape(self.dcfg.batch_size,
                                   self.dcfg.seq_len + 1).astype(np.int32)
            yield {"tokens": tokens}


def make_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
               seed: int = 0, n_patches: int = 16) -> Dict[str, np.ndarray]:
    """One training batch of the family's inputs (numpy): tokens (B, S+1);
    the VLM adds patch embeddings, the audio encoder takes frame
    embeddings, unit targets and a mask instead."""
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "audio":
        return {
            "frame_embeds": rng.standard_normal(
                (batch_size, seq_len, cfg.d_model)).astype(np.float32),
            "targets": rng.integers(0, cfg.vocab_size,
                                    (batch_size, seq_len)).astype(np.int32),
            "mask": (rng.random((batch_size, seq_len)) < 0.5),
        }
    tokens = np.clip(rng.zipf(1.2, (batch_size, seq_len + 1)), 2,
                     cfg.vocab_size - 1).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.arch_type == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (batch_size, n_patches, cfg.d_model)).astype(np.float32)
    return batch
