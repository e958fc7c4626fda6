"""Batched serving engine: prefill + KV-cache decode.

Port of ``src/repro/runtime/server.py``.  Requests are padded into batch
slots, prefilled once, then decoded step by step; greedy or temperature
sampling through a seeded ``torch.Generator``.

Over ranks (``pctx``), the engine keeps the reference's API: every rank is
given the GLOBAL prompts and returns the GLOBAL tokens, as the reference's
GSPMD engine does.  Every rank runs the same scheduler over all B requests;
the model step computes only the rank's data-parallel rows (dp index = pod
* data_size + data), and the sampled tokens are gathered over the dp ranks
before the scheduler sees them.  The phase walls are the slowest rank's, so
every rank's scheduler clock, and so every admission decision, agrees: no
rank skips a collective the others wait in.  ``generate`` is
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
import torch.distributed as dist

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
                 device=None, pctx=None):
        """``device=None`` means CUDA (raises without one); the model must
        have been built for the same device and the same ``pctx``."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model built for {model.device}, engine on "
                             f"{self.device}")
        if model.pctx is not pctx:
            raise ValueError("the model was built for another ParallelContext")
        self.pctx = pctx
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
        rows = self._my_rows(prompts)
        cache = self.model.init_cache(len(rows), s + max_new,
                                      self.cfg.cache_dtype)
        tokens = torch.from_numpy(np.ascontiguousarray(rows, np.int32))
        logits, cache = self.model.prefill(
            self.params, {"tokens": tokens.to(self.device)}, cache)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        state = CohortState(cache=cache, logits=logits, generator=gen,
                            batch=b)
        tokens = self._sample(state)
        return state, tokens, self._wall(t0)

    @torch.inference_mode()
    def step_cohort(self, state: CohortState, tokens: np.ndarray):
        """One decode round: consume the cohort's last sampled tokens,
        sample the next.  Returns ``(state, tokens, wall_s)``."""
        t0 = time.monotonic()
        dec_in = torch.from_numpy(
            self._my_rows(np.asarray(tokens, np.int32))[:, None]
        ).to(self.device)
        state.logits, state.cache = self.model.decode(
            self.params, {"tokens": dec_in}, state.cache)
        tokens = self._sample(state)
        return state, tokens, self._wall(t0)

    # -- data-parallel rows over ranks -------------------------------------------
    def _my_rows(self, rows):
        """This rank's block of the global batch rows."""
        if self.pctx is None:
            return rows
        dp = self.pctx.dp_size
        if len(rows) % dp:
            raise ValueError(f"batch {len(rows)} does not divide over {dp} "
                             f"data-parallel ranks")
        per = len(rows) // dp
        return rows[self.pctx.dp_index * per:(self.pctx.dp_index + 1) * per]

    def _dp_group(self):
        return self.pctx.mesh.group(*self.pctx.dp_axes)

    def _wall(self, t0: float) -> float:
        """The phase wall since ``t0``: the slowest data-parallel rank's."""
        wall = time.monotonic() - t0
        if self.pctx is None or self.pctx.dp_size == 1:
            return wall
        t = torch.tensor([wall], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._dp_group())
        return float(t.item())

    def _sample(self, state: CohortState) -> np.ndarray:
        logits = state.logits
        self.stats["nonfinite_logits"] += int(
            (~torch.isfinite(logits)).any().item())
        if self.cfg.temperature > 0:
            # inverse-CDF draws from one uniform per GLOBAL row, of which
            # this rank takes its rows' share: every row draws its own
            # number, the same one on any count of ranks
            u = self._my_rows(torch.rand(state.batch, dtype=torch.float64,
                                         generator=state.generator,
                                         device=self.device))
            cdf = torch.softmax(logits.double() / self.cfg.temperature,
                                dim=-1).cumsum(dim=-1)
            nxt = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None],
                                     right=True)[:, 0]
            nxt = nxt.clamp(max=logits.shape[-1] - 1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.to(torch.int32)
        if self.pctx is not None and self.pctx.dp_size > 1:
            parts = [torch.empty_like(nxt) for _ in range(self.pctx.dp_size)]
            dist.all_gather(parts, nxt, group=self._dp_group())
            nxt = torch.cat(parts)
        return nxt.cpu().numpy()

    def generate(self, prompts: np.ndarray, max_new: Optional[int] = None,
                 seed: int = 0) -> np.ndarray:
        """prompts: [B, S] int32 (already padded).  Returns [B, max_new].

        The whole batch arrives at t=0 and drains as one cohort through
        the scheduler: one code path with continuous batching, bit-exact
        either way under greedy decoding.  Over ranks every rank passes
        the global prompts and gets the global tokens."""
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
