"""Model API over the families the port serves: dense, moe, encdec
(SeamlessM4T), hybrid (Zamba2) and rwkv (RWKV-6).

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
for the loss, -1 ignored), ``{"tokens": [B, 1]}`` for decode; a config
with ``input_mode="embeddings"`` (Qwen2-VL's backbone behind the
reference's stub frontend) also takes ``{"embeds": [B, S, D],
"positions": [B, S, 3]}`` and ``{"embeds": [B, 1, D]}`` for decode
(:meth:`Model.decode_inputs`), unscaled.  The encoder-decoder (whose
config also says ``input_mode="embeddings"``: its encoder's) takes
``{"src_embeds": [B, S, D], "tgt_tokens": [B, S]}`` for prefill (and
``"labels"``) and ``{"tokens": [B, 1]}`` for decode; as in the reference,
its target tokens are embedded unscaled in prefill and training and
scaled by sqrt(d_model) in decode.  The model runs on CUDA unless it
is built with ``device="cpu"``, or on ``"meta"`` (shapes only, the dry
run: ``launch/dryrun.py``).
Built with a ``pctx``, a model holds one rank's experts and
tensor-parallel parts (every family: the hybrid's Mamba2 blocks in
``ssm``, RWKV-6's in ``rwkv``, the rest in ``layers``), and its batches
are that rank's data-parallel rows (every model rank of a data-parallel
group takes the same rows).  For the dense and moe families its loss is
then the mean over this rank's rows (the same value on every model rank),
differentiable through the exchanges: the trainer's gradient sync turns
the ranks' gradients into the global batch's
(``runtime.trainer.GradSync``); the hybrid, rwkv and encdec families
keep the residual whole on every model rank, so their loss is the whole
rows' mean on each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import _stub_embed
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rwkv, ssm
from repro_torch.models import transformer as T
from repro_torch.parallel.context import seq_sharded, shard_residual


def _positions(cfg: ModelConfig, b: int, s: int, device) -> torch.Tensor:
    """[B, S] positions, or [B, S, 3] (one id a M-RoPE section, all
    equal) under ``mrope_sections``, as the reference's
    ``_positions_for``."""
    pos = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    return pos[..., None].expand(b, s, 3) if cfg.mrope_sections else pos


def param_module(cfg: ModelConfig, *, device, dtype,
                 pctx=None) -> nn.Module:
    """The family's parameter module, uninitialised (one rank's shard of
    it with a ``pctx``)."""
    if cfg.family == "hybrid":
        return ssm.Zamba2(cfg, device=device, dtype=dtype, pctx=pctx)
    if cfg.family == "rwkv":
        return rwkv.RWKV6(cfg, device=device, dtype=dtype, pctx=pctx)
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
                                   device=self.device, dtype=self.dtype,
                                   pctx=self.pctx)
        if self.cfg.family == "rwkv":
            return rwkv.init_rwkv6(self.cfg, generator=generator,
                                   device=self.device, dtype=self.dtype,
                                   pctx=self.pctx)
        return T.init_transformer(self.cfg, generator=generator,
                                  device=self.device, dtype=self.dtype,
                                  pctx=self.pctx, shared=shared)

    def _embed(self, params, tokens, emb=None) -> torch.Tensor:
        """The tokens' embeddings; ``emb``: the table as the caller read
        it (under FSDP a read gathers it, so the loss reads a tied table
        once for the lookup and the unembedding)."""
        x = L.embed(params.embed.emb if emb is None else emb,
                    tokens.to(self.device))
        if self.cfg.tie_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.dtype)
        return x

    def _takes_tokens(self) -> bool:
        """Whether decode takes token ids: every family but the
        embeddings input of a decoder-only model (the encoder-decoder's
        embeddings input is its encoder's)."""
        return (self.cfg.input_mode != "embeddings"
                or self.cfg.family == "encdec")

    def _embeds(self, batch: dict):
        """The embeddings input of ``batch`` in the model's dtype (no
        sqrt(d_model) scale), or None for a token batch."""
        if not self._takes_tokens() and "embeds" in batch:
            return batch["embeds"].to(self.device, self.dtype)
        return None

    def embed_in(self, params, batch: dict, emb=None):
        """(x [B, S, D], positions): the tokens embedded (by ``emb`` if
        given, :meth:`_embed`), or the embeddings input with its own
        positions (the reference's ``embed_in``)."""
        x = self._embeds(batch)
        if x is None:
            x = self._embed(params, batch["tokens"], emb)
            return x, _positions(self.cfg, *x.shape[:2], self.device)
        pos = batch.get("positions")
        if pos is None:
            return x, _positions(self.cfg, *x.shape[:2], self.device)
        return x, pos.to(self.device)

    def _encdec_in(self, params, batch: dict, emb=None):
        """(source embeddings, target, positions) of an encoder-decoder
        batch: the target tokens embedded WITHOUT the sqrt(d_model) scale
        (the reference's prefill and training; its decode scales), by
        ``emb`` if given."""
        toks = batch["tgt_tokens"]
        return (batch["src_embeds"].to(self.device, self.dtype),
                L.embed(params.embed.emb if emb is None else emb,
                        toks.to(self.device)),
                _positions(self.cfg, *toks.shape, self.device))

    def decode_inputs(self, tokens: np.ndarray) -> dict:
        """The decode batch of the sampled tokens [B] int32 (host), as
        numpy arrays: ``{"tokens": [B, 1]}``, or for the embeddings input
        the stub frontend's ``{"embeds": [B, 1, D]}`` fp32 (the reference's
        ``ServeEngine._decode_batch``)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1, 1)
        if not self._takes_tokens():
            return {"embeds": _stub_embed(tokens, self.cfg.d_model)}
        return {"tokens": tokens}

    def decode_batch(self, tokens: torch.Tensor) -> dict:
        """The decode batch of sampled tokens [B] on the model's device:
        ``{"tokens": [B, 1] int32}``, or the stub embeddings of
        :meth:`decode_inputs` (made on the host) for the embeddings
        input."""
        if self._takes_tokens():
            return {"tokens": tokens.to(torch.int32)[:, None]}
        return {name: torch.from_numpy(val).to(self.device)
                for name, val in self.decode_inputs(
                    tokens.cpu().numpy()).items()}

    def hidden_train(self, params, batch: dict, emb=None):
        """The stack without a cache: (final-normed hidden [B, S, D], the
        MoE aux losses summed, fp32); ``emb``: the embedding table as the
        caller read it."""
        fam = self.cfg.family
        if fam == "encdec":
            src, tgt, positions = self._encdec_in(params, batch, emb)
            enc_out = T.encode(params, self.cfg, src, self.pctx)
            h = T.forward_hidden_encdec(params, self.cfg, tgt, positions,
                                        enc_out, self.pctx)
            return h, torch.zeros((), dtype=torch.float32,
                                  device=self.device)
        x, positions = self.embed_in(params, batch, emb)
        if fam in ("hybrid", "rwkv"):
            # the cache-free stacks, each block under remat: the scans'
            # autograd Functions run their backward kernels (plain versions
            # on the CPU)
            stack = ssm.zamba2_hidden if fam == "hybrid" else \
                rwkv.rwkv6_hidden
            return stack(params, self.cfg, x, self.pctx), torch.zeros(
                (), dtype=torch.float32, device=self.device)
        return T.forward_hidden(params, self.cfg, x, positions, self.pctx)

    def loss(self, params, batch: dict):
        """Mean token cross-entropy of the labels plus 0.01 x the MoE aux
        loss: (loss, {"ce", "aux"}), fp32 scalars.  Under sequence
        parallelism (the dense and moe families, whose stacks leave the
        hidden sharded over the model axis) each model rank takes the
        cross-entropy of its own positions, and the sums and counts are
        added over the model axis (*g*), so the loss is the same on every
        model rank.  A tied table is read once, for the lookup and the
        unembedding (under FSDP each read is a gather)."""
        tied = params._parameters.get("unembed") is None    # not read
        emb = params.embed.emb if tied else None
        h, aux = self.hidden_train(params, batch, emb)
        w = emb if tied else params.unembed
        labels = batch["labels"].to(self.device)
        if self.cfg.family in ("dense", "moe") and seq_sharded(
                self.pctx, labels.shape[1]):
            nll, cnt = L.chunked_nll(h, L.to_model(w, self.pctx),
                                     shard_residual(labels, self.pctx),
                                     tied=tied,
                                     final_softcap=self.cfg.final_softcap)
            tot = L.reduce_over_model(torch.stack([nll, cnt.to(nll.dtype)]),
                                      self.pctx)
            ce = tot[0] / torch.clamp(tot[1], min=1)
        else:
            ce = L.chunked_cross_entropy(h, w, labels, tied=tied,
                                         final_softcap=self.cfg.final_softcap)
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux}

    def init_cache(self, batch: int, max_len: int,
                   cache_dtype=torch.bfloat16) -> dict:
        kw = dict(device=self.device, dtype=cache_dtype)
        if self.cfg.family == "hybrid":
            return ssm.zamba2_init_state(self.cfg, batch, max_len,
                                         pctx=self.pctx, **kw)
        if self.cfg.family == "rwkv":
            return rwkv.rwkv6_init_state(self.cfg, batch, pctx=self.pctx,
                                         **kw)
        return T.init_cache(self.cfg, batch, max_len, pctx=self.pctx, **kw)

    def prefill(self, params, batch: dict, cache: dict):
        fam = self.cfg.family
        if fam == "encdec":
            logits, cache = T.prefill_encdec(
                params, self.cfg, *self._encdec_in(params, batch), cache,
                self.pctx)
            return logits[:, 0], cache
        x, positions = self.embed_in(params, batch)
        if fam in ("hybrid", "rwkv"):
            stack = ssm.zamba2_prefill if fam == "hybrid" else \
                rwkv.rwkv6_prefill
            h, cache = stack(params, self.cfg, x, cache, self.pctx)
            logits = T.logits_fn(params, self.cfg, h, last_only=True)
        else:
            logits, cache = T.prefill(params, self.cfg, x, positions,
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
        x = self._embeds(batch)
        if x is None:
            x = self._embed(params, batch["tokens"])
        fam = self.cfg.family
        if fam in ("hybrid", "rwkv"):
            step = ssm.zamba2_decode_step if fam == "hybrid" else \
                rwkv.rwkv6_decode_step
            h, cache = step(params, self.cfg, x, cache, self.pctx)
            logits = T.logits_fn(params, self.cfg, h, last_only=True)
        elif fam == "encdec":
            logits, cache = T.decode_step_encdec(params, self.cfg, x, cache,
                                                 self.pctx)
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
    """Dense, moe, encdec, hybrid and rwkv families, on one rank or over
    the ranks of a ``pctx``."""
    T.check_supported(cfg)
    return Model(cfg=cfg, device=resolve_device(device), dtype=dtype,
                 pctx=pctx)


def make_batch(cfg: ModelConfig, kind: str, batch: int, seq: int,
               rng_seed: int = 0, *, device=None) -> dict:
    """Synthetic batch from a numpy seed: the reference's tokens, or for
    the embeddings input its normal embeddings and [B, S, 3] positions,
    or for the encoder-decoder its normal source embeddings and target
    tokens (a decode batch of tokens), for the same seed."""
    dev = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    toks = rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    encdec = cfg.family == "encdec"
    embeds = cfg.input_mode == "embeddings" and not encdec
    if kind == "decode":
        out = ({"embeds": rng.normal(size=(batch, 1, cfg.d_model)).astype(
            np.float32)} if embeds else {"tokens": toks[:, :1]})
    elif encdec:
        out = {"src_embeds": rng.normal(
                   size=(batch, seq, cfg.d_model)).astype(np.float32),
               "tgt_tokens": toks, "labels": labels}
    elif embeds:
        out = {"embeds": rng.normal(size=(batch, seq, cfg.d_model)).astype(
                   np.float32),
               "positions": np.broadcast_to(
                   np.arange(seq, dtype=np.int32)[None, :, None],
                   (batch, seq, 3)).copy(),
               "labels": labels}
    else:
        out = {"tokens": toks, "labels": labels}
    return {key: torch.from_numpy(np.ascontiguousarray(val)).to(dev)
            for key, val in out.items()}


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def param_count_shape_only(cfg: ModelConfig) -> int:
    """Parameters of the whole model for ``cfg``, counted on the meta
    device (nothing allocated, nothing drawn)."""
    return param_count(param_module(cfg, device="meta",
                                    dtype=torch.float32))
