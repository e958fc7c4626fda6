"""Deterministic synthetic data pipeline with per-host sharding.

Port of ``src/repro/data/pipeline.py``: the generator is numpy in both
packages, so the token stream is the reference's bit for bit.  Batches are
deterministic in (seed, step), so a restarted job regenerates the exact
token stream (restore at step k => skip k batches), on any host count.

The token stream is a mixture of Zipf-distributed unigrams and repeated
n-gram motifs, a learnable distribution whose loss goes down.
:func:`batch_for_model` hands a batch to a model as torch tensors on an
explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_count: int = 64
    motif_prob: float = 0.5


class SyntheticLM:
    """Deterministic (seed, step) -> batch generator."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed motif bank (part of the "dataset")
        self.motifs = rng.integers(
            0, cfg.vocab, size=(cfg.motif_count, cfg.motif_len)
        ).astype(np.int32)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self.probs = p / p.sum()

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1):
        """Batch shard for ``host_id`` at ``step`` (numpy int32 arrays).
        Concatenating all host shards reproduces the global batch
        regardless of host count."""
        cfg = self.cfg
        assert cfg.global_batch % num_hosts == 0
        per_host = cfg.global_batch // num_hosts
        rows = []
        for r in range(host_id * per_host, (host_id + 1) * per_host):
            rng = np.random.default_rng(
                (cfg.seed, step, r))           # row-deterministic
            toks = rng.choice(cfg.vocab, size=cfg.seq_len + 1,
                              p=self.probs).astype(np.int32)
            # paste motifs
            n_paste = rng.binomial(cfg.seq_len // cfg.motif_len,
                                   cfg.motif_prob)
            for _ in range(n_paste):
                m = rng.integers(0, cfg.motif_count)
                at = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len)
                toks[at:at + cfg.motif_len] = self.motifs[m]
            rows.append(toks)
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1].copy(),
                "labels": arr[:, 1:].copy()}

    def iter_batches(self, start_step: int = 0, host_id: int = 0,
                     num_hosts: int = 1) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step, host_id, num_hosts)
            step += 1


def batch_for_model(cfg: ModelConfig, data: dict, rng_seed: int = 0, *,
                    device=None) -> dict:
    """Adapt a token batch to the model's input format, as torch tensors
    on ``device`` (None: CUDA).  The families the port trains take tokens;
    the reference's stub frontends (embeddings input, encdec) are later
    slices of the port and raise here."""
    dev = resolve_device(device)
    if cfg.family == "encdec" or cfg.input_mode == "embeddings":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family}/{cfg.input_mode} input is not "
            f"ported yet (ROADMAP.md queue 1 item 9)")
    return {"tokens": torch.from_numpy(data["tokens"]).to(dev),
            "labels": torch.from_numpy(data["labels"]).to(dev)}


def _stub_embed(tokens: np.ndarray, d: int) -> np.ndarray:
    """Deterministic cheap 'frontend': hash tokens into embeddings (the
    reference's stub for the ViT / speech encoders; numpy, so equal to
    it)."""
    base = (tokens[..., None].astype(np.int64) * 2654435761 % 2**31)
    idx = base + np.arange(d, dtype=np.int64)
    vals = ((idx * 1103515245 + 12345) % 65536).astype(np.float32)
    return ((vals / 32768.0) - 1.0) * 0.05
