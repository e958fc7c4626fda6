"""Decode as a CUDA graph, cached per cohort shape.

The torch counterpart of the reference's ``jax.jit(model.decode,
donate_argnums=(2,))`` (``src/repro/runtime/server.py:125-126``): one
decode step of a cohort is captured once as a CUDA graph and replayed every
round after, so the host issues one graph launch a round instead of the
step's thousand-odd kernels.  ``ServeEngine`` keeps one
:class:`DecodeGraphs` per bound plan (``_ServeLowering.decode``), so a graph
is captured once per (plan fingerprint, cohort rows, cache length).

A **slot** holds what a graph reads and writes at fixed addresses: the
cohort's cache (the prefill fills it in place), static input buffers (the
sampled tokens, or for the embeddings input their stub embeddings,
``Model.decode_inputs``, copied in every round), the static logits the
graph writes, and the graph.  ``start`` takes a free slot
of the cohort's shape or makes one; ``release`` hands it back when its
cohort retires, and a later cohort of the same shape replays the same graph.
A slot's first round runs eagerly: it warms up what a capture cannot do
(cuBLAS handles, lazy allocations) and advances the cache like any round.
The second round is captured, and since capture executes nothing, it is
replayed at once.  Warming up on a spare step of the live cache would
advance the Mamba2 and RWKV states twice.

Which path runs is a rule (:func:`decode_mode`): a CUDA device with no rank
mesh, or with nccl process groups, is graphed; CPU tensors and gloo groups
(which stage every exchange through the host) run every round eagerly.  A
capture or replay that fails raises.

The kernel wrappers count their launches in Python, which a replay never
reaches: each slot keeps the launches its capture recorded and adds them to
the wrappers' counts at every replay, so ``ops.launches()`` counts the
kernels that ran.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.models.api import check_room

FREE_SLOTS = 8          # free slots kept for later cohorts, over all shapes


def decode_mode(device: torch.device, pctx=None) -> tuple[str, str]:
    """``("graph" | "eager", reason)`` for decode on ``device`` under
    ``pctx``: the rule, not a switch."""
    if device.type != "cuda":
        return "eager", f"{device.type} tensors: no CUDA graph"
    if pctx is not None and getattr(pctx.mesh, "transport", None) == "card":
        return "eager", ("the card transport's exchanges meet their group "
                         "at host barriers, which a CUDA graph cannot "
                         "capture")
    if pctx is None or not dist.is_initialized():
        return "graph", "one rank on CUDA"
    backend = dist.get_backend()
    if backend == "nccl":
        return "graph", "nccl process groups: the exchanges are captured"
    return "eager", (f"{backend} process groups stage every exchange "
                     f"through the host, which a CUDA graph cannot capture")


@dataclasses.dataclass
class Slot:
    """One cohort shape's decode buffers and graph."""
    key: tuple                      # (cohort rows, cache length)
    cache: dict
    inputs: dict                    # the decode batch's static buffers
    logits: Optional[torch.Tensor] = None   # what the graph writes
    graph: Optional[object] = None  # torch.cuda.CUDAGraph
    launches: dict = dataclasses.field(default_factory=dict)
    rounds: int = 0                 # rounds of the cohort now in the slot


class DecodeGraphs:
    """Decode rounds of one plan's model, graphed or eager by
    :func:`decode_mode`.  ``stats`` (the engine's) counts ``captures``,
    ``replays`` and ``eager_rounds`` and the host seconds of the captures
    (``capture_s``)."""

    def __init__(self, model, params, *, mode: str, stats: dict):
        self.model = model
        self.params = params
        self.mode = mode
        self.stats = stats
        self._free: collections.OrderedDict = collections.OrderedDict()
        self._stream = None

    # -- slots -----------------------------------------------------------------
    def start(self, rows: int, max_len: int, cache_dtype) -> Slot:
        """A slot for a cohort of ``rows`` rows and cache length
        ``max_len``: a free one of that shape (its cache zeroed), else a
        new one."""
        key = (int(rows), int(max_len))
        for ident, slot in self._free.items():
            if slot.key == key:
                del self._free[ident]
                for t in _tensors(slot.cache):
                    t.zero_()
                slot.cache["len"] = 0
                slot.rounds = 0
                return slot
        cache = self.model.init_cache(rows, max_len, cache_dtype)
        inputs = {name: torch.zeros_like(torch.from_numpy(val),
                                         device=self.model.device)
                  for name, val in self.model.decode_inputs(
                      np.zeros(rows, np.int32)).items()}
        return Slot(key=key, cache=cache, inputs=inputs)

    def release(self, slot: Slot) -> None:
        """Keep ``slot`` for a later cohort of its shape (the oldest free
        slot goes beyond ``FREE_SLOTS``)."""
        self._free[id(slot)] = slot
        while len(self._free) > FREE_SLOTS:
            self._free.popitem(last=False)

    def close(self) -> None:
        """Free the slots kept for later cohorts, their graphs with them.
        A captured nccl exchange holds its communicator: free the graphs
        before the process group is destroyed."""
        self._free.clear()

    def adopt(self, slot: Slot) -> None:
        """Take over an in-flight slot of another plan's decoder: its
        cache and buffers stay, its graph (which runs that plan) goes, so
        the next rounds warm up and capture under this plan."""
        slot.graph = slot.logits = None
        slot.launches = {}
        slot.rounds = 0

    # -- one decode round ------------------------------------------------------
    def __call__(self, slot: Slot, tokens: np.ndarray) -> torch.Tensor:
        """One decode round of the cohort in ``slot`` on its last sampled
        ``tokens`` ([rows] int32, host).  Returns the logits [rows, V];
        under a graph they are the slot's static buffer, which the next
        round overwrites."""
        check_room(slot.cache)
        for name, val in self.model.decode_inputs(tokens).items():
            slot.inputs[name].copy_(torch.from_numpy(val))
        if self.mode == "eager":
            logits = self._step(slot)
            self.stats["eager_rounds"] += 1
        elif slot.graph is not None:
            slot.graph.replay()
            _add_launches(slot.launches)
            self.stats["replays"] += 1
            logits = slot.logits
        elif slot.rounds == 0:
            logits = self._warm_up(slot)
            self.stats["eager_rounds"] += 1
        else:
            self._capture(slot)
            slot.graph.replay()
            _add_launches(slot.launches)
            self.stats["replays"] += 1
            logits = slot.logits
        slot.cache["len"] += 1
        slot.rounds += 1
        return logits

    def _step(self, slot: Slot) -> torch.Tensor:
        logits, _ = self.model.decode_step(self.params, slot.inputs,
                                           slot.cache)
        return logits

    def _side(self) -> torch.cuda.Stream:
        """The stream this decoder warms up and captures on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.model.device)
        return self._stream

    def _warm_up(self, slot: Slot) -> torch.Tensor:
        """The slot's eager first round, on the capture stream."""
        main = torch.cuda.current_stream(self.model.device)
        side = self._side()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits = self._step(slot)
        main.wait_stream(side)
        logits.record_stream(main)
        return logits

    def _capture(self, slot: Slot) -> None:
        """Capture one step into ``slot.graph`` (nothing executes).  The
        launches the wrappers count while the step is captured are moved
        from their counts into ``slot.launches``."""
        main = torch.cuda.current_stream(self.model.device)
        side = self._side()
        before = ops.launches()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(main)
        # thread_local: the nccl watchdog thread may query its events while
        # this thread captures
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            logits = self._step(slot)
        main.wait_stream(side)
        self.stats["capture_s"] += time.perf_counter() - t0
        after = ops.launches()
        for op in ops.KERNEL_OPS:
            op.launches = before[op.__name__]
        slot.launches = {name: after[name] - before[name] for name in after
                         if after[name] != before[name]}
        slot.graph, slot.logits = graph, logits
        self.stats["captures"] += 1


def _add_launches(counts: dict) -> None:
    for op in ops.KERNEL_OPS:
        op.launches += counts.get(op.__name__, 0)


def _tensors(cache: dict):
    """The tensors of a decode cache (lists of per-layer buffers
    included)."""
    for value in cache.values():
        if isinstance(value, torch.Tensor):
            yield value
        elif isinstance(value, (list, tuple)):
            yield from (t for t in value if isinstance(t, torch.Tensor))
