"""Model API over the families the port serves: dense, moe, hybrid
(Zamba2) and rwkv (RWKV-6).

``build_model(cfg)`` returns a :class:`Model`:

  init(generator)                -> params (the family's ``nn.Module``)
  prefill(params, batch, cache)  -> (next-token logits [B, V], cache)
  decode(params, batch, cache)   -> (logits [B, V], cache)
  init_cache(batch, max_len)     -> per-layer KV buffers or recurrent states

Batches: ``{"tokens": [B, S] int}`` for prefill, ``{"tokens": [B, 1]}`` for
decode.  The model runs on CUDA unless it is built with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rwkv, ssm
from repro_torch.models import transformer as T


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def param_module(cfg: ModelConfig, *, device, dtype) -> nn.Module:
    """The family's parameter module, uninitialised."""
    if cfg.family == "hybrid":
        return ssm.Zamba2(cfg, device=device, dtype=dtype)
    if cfg.family == "rwkv":
        return rwkv.RWKV6(cfg, device=device, dtype=dtype)
    return T.Transformer(cfg, device=device, dtype=dtype)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype

    def init(self, generator: torch.Generator) -> nn.Module:
        """Random parameters on the model's device, drawn from
        ``generator`` (a generator of that device)."""
        init = {"hybrid": ssm.init_zamba2,
                "rwkv": rwkv.init_rwkv6}.get(self.cfg.family,
                                             T.init_transformer)
        return init(self.cfg, generator=generator, device=self.device,
                    dtype=self.dtype)

    def _embed(self, params, tokens) -> torch.Tensor:
        x = L.embed(params.embed, tokens.to(self.device))
        if self.cfg.tie_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.dtype)
        return x

    def init_cache(self, batch: int, max_len: int,
                   cache_dtype=torch.bfloat16) -> dict:
        kw = dict(device=self.device, dtype=cache_dtype)
        if self.cfg.family == "hybrid":
            return ssm.zamba2_init_state(self.cfg, batch, max_len, **kw)
        if self.cfg.family == "rwkv":
            return rwkv.rwkv6_init_state(self.cfg, batch, **kw)
        return T.init_cache(self.cfg, batch, max_len, **kw)

    def prefill(self, params, batch: dict, cache: dict):
        toks = batch["tokens"]
        x = self._embed(params, toks)
        fam = self.cfg.family
        if fam in ("hybrid", "rwkv"):
            stack = ssm.zamba2_prefill if fam == "hybrid" else \
                rwkv.rwkv6_prefill
            h, cache = stack(params, self.cfg, x, cache)
            logits = T.logits_fn(params, self.cfg, h, last_only=True)
        else:
            logits, cache = T.prefill(params, self.cfg, x,
                                      _positions(*toks.shape, self.device),
                                      cache)
        return logits[:, 0], cache

    def decode(self, params, batch: dict, cache: dict):
        x = self._embed(params, batch["tokens"])
        fam = self.cfg.family
        if fam in ("hybrid", "rwkv"):
            step = ssm.zamba2_decode_step if fam == "hybrid" else \
                rwkv.rwkv6_decode_step
            h, cache = step(params, self.cfg, x, cache)
            logits = T.logits_fn(params, self.cfg, h, last_only=True)
        else:
            logits, cache = T.decode_step(params, self.cfg, x, cache)
        return logits[:, 0], cache


def build_model(cfg: ModelConfig, *, device=None,
                dtype: torch.dtype = torch.bfloat16) -> Model:
    """Dense, moe, hybrid and rwkv families; encdec and the embeddings
    input are later slices of the port."""
    T.check_supported(cfg)
    return Model(cfg=cfg, device=resolve_device(device), dtype=dtype)


def make_batch(cfg: ModelConfig, kind: str, batch: int, seq: int,
               rng_seed: int = 0, *, device=None) -> dict:
    """Synthetic token batch from a numpy seed (the reference's token
    stream for the same seed)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    toks = rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    if kind == "decode":
        return {"tokens": torch.from_numpy(toks[:, :1]).to(dev)}
    return {"tokens": torch.from_numpy(toks).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}
