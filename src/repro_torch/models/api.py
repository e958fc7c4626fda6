"""Model API over the families the port serves: dense, moe, hybrid
(Zamba2) and rwkv (RWKV-6).

``build_model(cfg)`` returns a :class:`Model`:

  init(generator)                -> params (the family's ``nn.Module``)
  loss(params, batch)            -> (ce + 0.01 * aux, {"ce", "aux"}),
                                    differentiable in the parameters
  prefill(params, batch, cache)  -> (next-token logits [B, V], cache)
  decode(params, batch, cache)   -> (logits [B, V], cache)
  decode_step(params, batch, cache) -> the same, leaving the cache's host
                                    length alone (what a CUDA graph holds)
  init_cache(batch, max_len)     -> per-layer KV buffers or recurrent states

Batches: ``{"tokens": [B, S] int}`` for prefill (and ``"labels"`` [B, S]
for the loss, -1 ignored), ``{"tokens": [B, 1]}`` for decode.  Training
runs on one rank (``pctx=None``); on the card the hybrid and rwkv families
do not train yet (their scans have no backward kernel).  The model runs
on CUDA unless it is built with ``device="cpu"``.
Built with a ``pctx`` (dense and moe families), a model holds one rank's
experts and tensor-parallel blocks, and its batches are that rank's
data-parallel rows (every model rank of a data-parallel group takes the
same rows).
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


def param_module(cfg: ModelConfig, *, device, dtype,
                 pctx=None) -> nn.Module:
    """The family's parameter module, uninitialised (one rank's shard of
    it with a ``pctx``)."""
    if cfg.family == "hybrid":
        return ssm.Zamba2(cfg, device=device, dtype=dtype)
    if cfg.family == "rwkv":
        return rwkv.RWKV6(cfg, device=device, dtype=dtype)
    return T.Transformer(cfg, device=device, dtype=dtype, pctx=pctx)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype
    pctx: object = None

    def init(self, generator: torch.Generator, shared=None) -> nn.Module:
        """Random parameters on the model's device, drawn from
        ``generator`` (a generator of that device).  ``shared`` (dense and
        moe families): ``transformer.shared_weights`` of the same seed,
        held as they are; only this rank's experts are drawn."""
        if self.cfg.family == "hybrid":
            return ssm.init_zamba2(self.cfg, generator=generator,
                                   device=self.device, dtype=self.dtype)
        if self.cfg.family == "rwkv":
            return rwkv.init_rwkv6(self.cfg, generator=generator,
                                   device=self.device, dtype=self.dtype)
        return T.init_transformer(self.cfg, generator=generator,
                                  device=self.device, dtype=self.dtype,
                                  pctx=self.pctx, shared=shared)

    def _embed(self, params, tokens) -> torch.Tensor:
        x = L.embed(params.embed, tokens.to(self.device))
        if self.cfg.tie_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.dtype)
        return x

    def hidden_train(self, params, batch: dict):
        """The stack without a cache: (final-normed hidden [B, S, D], the
        MoE aux losses summed, fp32)."""
        fam = self.cfg.family
        if self.pctx is not None:
            raise NotImplementedError(
                "training over ranks is not ported yet (ROADMAP.md queue 1 "
                "item 8b)")
        toks = batch["tokens"]
        x = self._embed(params, toks)
        if fam in ("hybrid", "rwkv"):
            if self.device.type == "cuda":
                scan = "mamba2_scan" if fam == "hybrid" else "rwkv6_scan"
                raise NotImplementedError(
                    f"{fam} training on the card needs the {scan} backward "
                    f"kernel (ROADMAP.md queue 2 item 1)")
            # the prefill, with a state that is thrown away: the plain
            # scans run under autograd on the CPU
            stack = ssm.zamba2_prefill if fam == "hybrid" else \
                rwkv.rwkv6_prefill
            cache = self.init_cache(*toks.shape, cache_dtype=self.dtype)
            h, _ = stack(params, self.cfg, x, cache)
            return h, torch.zeros((), dtype=torch.float32,
                                  device=self.device)
        return T.forward_hidden(params, self.cfg, x,
                                _positions(*toks.shape, self.device))

    def loss(self, params, batch: dict):
        """Mean token cross-entropy of the labels plus 0.01 x the MoE aux
        loss: (loss, {"ce", "aux"}), fp32 scalars."""
        h, aux = self.hidden_train(params, batch)
        if params.unembed is not None:
            w, tied = params.unembed, False
        else:
            w, tied = params.embed.emb, True
        ce = L.chunked_cross_entropy(h, w, batch["labels"].to(self.device),
                                     tied=tied,
                                     final_softcap=self.cfg.final_softcap)
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux}

    def init_cache(self, batch: int, max_len: int,
                   cache_dtype=torch.bfloat16) -> dict:
        kw = dict(device=self.device, dtype=cache_dtype)
        if self.cfg.family == "hybrid":
            return ssm.zamba2_init_state(self.cfg, batch, max_len, **kw)
        if self.cfg.family == "rwkv":
            return rwkv.rwkv6_init_state(self.cfg, batch, **kw)
        return T.init_cache(self.cfg, batch, max_len, pctx=self.pctx, **kw)

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
                                      cache, self.pctx)
        return logits[:, 0], cache

    def decode(self, params, batch: dict, cache: dict):
        """One decode token (:meth:`decode_step`), then the cache's host
        length advanced.  Raises on a full KV cache (on the card a write
        past its end would be a device-side fault)."""
        check_room(cache)
        logits, cache = self.decode_step(params, batch, cache)
        cache["len"] += 1
        return logits, cache

    def decode_step(self, params, batch: dict, cache: dict):
        """The device work of one decode token: reads the position from
        the cache's device scalar and advances it, and reads nothing of
        the host, so a CUDA graph of it replays at any position."""
        x = self._embed(params, batch["tokens"])
        fam = self.cfg.family
        if fam in ("hybrid", "rwkv"):
            step = ssm.zamba2_decode_step if fam == "hybrid" else \
                rwkv.rwkv6_decode_step
            h, cache = step(params, self.cfg, x, cache)
            logits = T.logits_fn(params, self.cfg, h, last_only=True)
        else:
            logits, cache = T.decode_step(params, self.cfg, x, cache,
                                          self.pctx)
        return logits[:, 0], cache


def check_room(cache: dict) -> None:
    """Raise when a decode cache has no room for one more token's k, v."""
    kv = cache.get("k")
    if not kv:
        return
    room = cache.get("max_len", kv[0].shape[1])
    if cache["len"] >= room:
        raise ValueError(f"decode cache full: {cache['len']} of {room} "
                         f"positions")


def build_model(cfg: ModelConfig, *, device=None,
                dtype: torch.dtype = torch.bfloat16, pctx=None) -> Model:
    """Dense, moe, hybrid and rwkv families; encdec and the embeddings
    input are later slices of the port, and so are the hybrid and rwkv
    families over ranks."""
    T.check_supported(cfg)
    if pctx is not None and cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} over a "
                                  f"ParallelContext is not ported yet")
    return Model(cfg=cfg, device=resolve_device(device), dtype=dtype,
                 pctx=pctx)


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


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
