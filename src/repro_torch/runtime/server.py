"""Batched serving engine: prefill + KV-cache decode.

Port of ``src/repro/runtime/server.py`` for one rank.  Requests are padded
into batch slots, prefilled once, then decoded step by step; greedy or
temperature sampling through a seeded ``torch.Generator``.  ``generate`` is
a thin client of the continuous-batching scheduler: the whole batch arrives
at t=0 and drains as one cohort through :meth:`ServeEngine.start_cohort` /
:meth:`ServeEngine.step_cohort`, the loop the serving tier interleaves.
The plan-bound methods (plan reports, hot re-bind, bucket prefetch) come
with the port's multi-rank and planner slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.scheduler import BatchScheduler


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 = greedy
    eos_id: Optional[int] = None
    cache_dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass
class CohortState:
    """In-flight decode state of one cohort (one prefill's worth of
    requests, position-aligned): the KV cache, the last logits, and the
    sampling generator."""
    cache: dict
    logits: torch.Tensor
    generator: torch.Generator
    batch: int


class ServeEngine:
    def __init__(self, model, params, cfg: ServeConfig = ServeConfig(),
                 device=None):
        """``device=None`` means CUDA (raises without one); the model must
        have been built for the same device."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model built for {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0,
                      "nonfinite_logits": 0}

    # -- the step-level cohort API (what the BatchScheduler drives) ----------
    @torch.inference_mode()
    def start_cohort(self, prompts: np.ndarray,
                     max_new: Optional[int] = None, seed: int = 0):
        """Prefill one cohort of requests ([b, s] int32, already padded to
        one shared prompt_len) and sample its first tokens.  Returns
        ``(state, tokens, wall_s)``."""
        b, s = prompts.shape
        max_new = max_new or self.cfg.max_new_tokens
        t0 = time.monotonic()
        cache = self.model.init_cache(b, s + max_new, self.cfg.cache_dtype)
        tokens = torch.from_numpy(np.ascontiguousarray(prompts, np.int32))
        logits, cache = self.model.prefill(
            self.params, {"tokens": tokens.to(self.device)}, cache)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        state = CohortState(cache=cache, logits=logits, generator=gen,
                            batch=b)
        tokens = self._sample(state)
        return state, tokens, time.monotonic() - t0

    @torch.inference_mode()
    def step_cohort(self, state: CohortState, tokens: np.ndarray):
        """One decode round: consume the cohort's last sampled tokens,
        sample the next.  Returns ``(state, tokens, wall_s)``."""
        t0 = time.monotonic()
        dec_in = torch.from_numpy(
            np.asarray(tokens, np.int32)[:, None]).to(self.device)
        state.logits, state.cache = self.model.decode(
            self.params, {"tokens": dec_in}, state.cache)
        tokens = self._sample(state)
        return state, tokens, time.monotonic() - t0

    def _sample(self, state: CohortState) -> np.ndarray:
        logits = state.logits
        self.stats["nonfinite_logits"] += int(
            (~torch.isfinite(logits)).any().item())
        if self.cfg.temperature > 0:
            probs = torch.softmax(logits.float() / self.cfg.temperature,
                                  dim=-1)
            nxt = torch.multinomial(probs, 1,
                                    generator=state.generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32).cpu().numpy()

    def generate(self, prompts: np.ndarray, max_new: Optional[int] = None,
                 seed: int = 0) -> np.ndarray:
        """prompts: [B, S] int32 (already padded).  Returns [B, max_new].

        The whole batch arrives at t=0 and drains as one cohort through
        the scheduler: one code path with continuous batching, bit-exact
        either way under greedy decoding."""
        b, _ = prompts.shape
        max_new = max_new or self.cfg.max_new_tokens
        queue = RequestQueue()
        for i in range(b):
            queue.push(Request(rid=i, arrival_s=0.0,
                               prompt=np.asarray(prompts[i], np.int32),
                               max_new=max_new))
        sched = BatchScheduler(
            queue=queue,
            admission=AdmissionController(capacity=b),
            engine=self, eos_id=self.cfg.eos_id, seed=seed)
        sched.run_until_drained()
        out = np.zeros((b, max_new), np.int32)
        never_eos = 0
        for req in sched.completed:
            toks = req.tokens[:max_new]
            out[req.rid, :len(toks)] = toks
            never_eos += 0 if req.eos else 1
        self.stats["prefill_s"] += sched.wall["prefill_s"]
        self.stats["decode_s"] += sched.wall["decode_s"]
        self.stats["tokens"] += never_eos * max_new
        return out
