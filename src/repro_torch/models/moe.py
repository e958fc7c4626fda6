"""MoE FFN layer on the MultiWrite hierarchical dispatch.

Port of ``src/repro/models/moe.py``: router -> top-k ->
``hierarchical_dispatch`` (three ``dispatch_pack`` launches) or
``baseline_dispatch`` -> per-expert gated FFN -> the combine the scheme pair
names (fp32 sums in a fixed order).  The expert products are batched matrix
products outside any kernel of the reference, so they go to ``torch.bmm``.

With a :class:`~repro_torch.parallel.context.ParallelContext` every rank
runs its own data-parallel rows (the reference's ``shard_map`` in_spec over
the dp axes) and holds ``per_rank`` experts: EP spans (pod, data) when the
arch has enough experts (DBRX: 16 over 2 x 2 ranks), else the data axis
alone.  The dispatch scheme, the return-path scheme and the pipeline chunk
count G are one decision, ``pctx.moe_pipeline_kwargs`` (a bound plan, the
planner under ``plan_policy="auto"``, or the fixed knobs).  G > 1 runs the
reference's double-buffered chunk pipeline: chunk k+1's dispatch is issued
before chunk k's expert FFN and combine.  On the card it runs on a second
stream that the layer owns, so its packs and exchanges can overlap chunk
k's expert products; each chunk's outputs equal the serial loop's.

Over a model axis every model rank of a data-parallel group routes and
dispatches the same rows (EP runs over the data axis of its own model
coordinate) and holds its block of F/m columns of each expert's hidden
width: the expert FFN ends in an ``all_reduce`` over the model axis, or,
under ``moe_deferred_tp_reduce``, the combine (linear in the expert
outputs) runs on the partial sums and one ``all_reduce`` follows it.

Gradients over ranks: the exchanges' backward returns each row's
cotangent to the rank that sent it, so an expert's gradient arrives summed
over the data-parallel ranks whose rows it served (the trainer divides it
by their count and keeps it out of the data-parallel mean); the aux loss's
mean over the dp ranks is differentiable (its backward the mean of the
cotangents).  Over a model axis the expert rows enter the column-parallel
products through *f*, and so do the gates where the combine runs on the
partial sums (``layers.to_model``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.core import collectives as cl
from repro_torch.core.h100 import moe_compute_s
from repro_torch.models import layers as L
from repro_torch.parallel import mesh as mesh_ops


class MoE(nn.Module):
    """Router [D, E] (fp32) and the gated-FFN weights of the experts
    ``[first, first + local)`` of E: w1/w3 [local, D, F], w2 [local, F, D]
    (all E when ``local`` is None); over ``tp = (m, r)`` model ranks, rank
    r's block of F/m of each expert's hidden width, or all of it where F
    does not divide over m (replicated, ``layers.splits``)."""

    def __init__(self, d: int, f: int, num_experts: int, *, device, dtype,
                 first: int = 0, local: int | None = None, tp=(1, 0)):
        super().__init__()
        local = num_experts if local is None else local
        m, r = tp
        self.first, self.d_ff = first, f
        self.split = L.splits(f, m)
        fl = f // m if self.split else f
        self.router = L.parameter((d, num_experts), device=device,
                                  dtype=torch.float32)
        self.w1 = L.parameter((local, d, fl), device=device, dtype=dtype)
        self.w3 = L.parameter((local, d, fl), device=device, dtype=dtype)
        self.w2 = L.parameter((local, fl, d), device=device, dtype=dtype)
        self.shards = ({"w1": (2, m, r), "w3": (2, m, r), "w2": (1, m, r)}
                       if self.split else {})

    def reset_parameters(self, generator: torch.Generator,
                         layer: int = 0) -> "MoE":
        """The router from ``generator``; each expert's w1, w3, w2 from a
        generator of its own, seeded from ``generator``'s seed, the layer
        and the expert index.  So a rank draws only its own experts, and
        they equal the same experts of the one-rank model."""
        d = self.router.shape[0]
        L.truncated_normal_(self.router, 1.0 / math.sqrt(d), generator)
        return self.reset_experts(generator.initial_seed(), layer)

    def reset_experts(self, seed: int, layer: int = 0) -> "MoE":
        """This module's experts alone, each from its own generator seeded
        from (``seed``, ``layer``, expert index)."""
        d = self.w1.shape[1]
        sc_d, sc_f = 1.0 / math.sqrt(d), 1.0 / math.sqrt(self.d_ff)

        def per_expert(name):     # the shard of one expert's 2-d weight
            sh = self.shards.get(name)
            return None if sh is None else (sh[0] - 1,) + sh[1:]
        for i in range(self.w1.shape[0]):
            gen = torch.Generator(device=self.w1.device)
            gen.manual_seed(expert_seed(seed, layer, self.first + i))
            L.truncated_normal_(self.w1[i], sc_d, gen,
                                shard=per_expert("w1"))
            L.truncated_normal_(self.w3[i], sc_d, gen,
                                shard=per_expert("w3"))
            L.truncated_normal_(self.w2[i], sc_f, gen,
                                shard=per_expert("w2"))
        return self

    def dispatch_stream(self) -> torch.cuda.Stream:
        """The stream the layer's G > 1 pipeline issues chunk k+1's
        dispatch on (made at first use, on the weights' card)."""
        stream = getattr(self, "_dispatch_stream", None)
        if stream is None:
            stream = self._dispatch_stream = torch.cuda.Stream(
                device=self.w1.device)
        return stream


def expert_seed(seed: int, layer: int, expert: int) -> int:
    """The seed of one expert's weights: a hash of (model seed, layer,
    expert) that does not depend on which rank draws it."""
    return int(np.random.SeedSequence([seed, layer, expert]
                                      ).generate_state(1, np.uint64)[0] >> 1)


def init_moe(d: int, f: int, num_experts: int, *, generator, device,
             dtype) -> MoE:
    return MoE(d, f, num_experts, device=device, dtype=dtype
               ).reset_parameters(generator)


def num_experts(params: nn.Module) -> int:
    """The experts of the MoE layers of a parameter module (0 without
    one)."""
    moe = next((sub for sub in params.modules() if isinstance(sub, MoE)),
               None)
    return 0 if moe is None else moe.router.shape[1]


def expert_axes(pctx, num_experts: int) -> tuple[str, ...]:
    """The axes the experts are sharded over (``moe_specs``' sharding):
    (pod, data), or data alone when there are fewer experts than ranks
    (the pods then hold the same experts)."""
    use_pod, _ = pctx.ep_ranks(num_experts)
    return (pctx.pod_axis, pctx.data_axis) if use_pod else (pctx.data_axis,)


def expert_shard(pctx, num_experts: int) -> tuple[int, int]:
    """(first, count) of the experts a rank holds: ``per_rank`` in a
    contiguous block, at the rank's EP index over :func:`expert_axes`; all
    of them without a context."""
    if pctx is None:
        return 0, num_experts
    _, ranks = pctx.ep_ranks(num_experts)
    if num_experts % ranks:
        raise ValueError(f"{num_experts} experts over {ranks} EP ranks")
    per_rank = num_experts // ranks
    axes = expert_axes(pctx, num_experts)
    return pctx.mesh.axis_index(*axes) * per_rank, per_rank


def _expert_ffn(w1, w3, w2, x, act_name: str, pctx=None):
    """Per-expert gated FFN on packed buffers x: [E, C, D]; w*: this rank's
    block of the hidden width, row-parallel over the model axis of
    ``pctx`` (summed over it inside)."""
    act = L.activation(act_name)
    x = L.to_model(x, pctx)
    h = act(torch.bmm(x, w1)) * torch.bmm(x, w3)
    return L.reduce_over_model(torch.bmm(h, w2), pctx)


def balanced_capacities(n_tokens: int, k: int, p: int, d: int,
                        per_rank: int, cf: float) -> cl.DispatchConfig:
    """Capacity factors sized from *balanced-routing expectations* with
    headroom ``cf`` (copied from the reference, Python ``round`` included):

      stage-1 slots/pod     ~ N * min(1, k/p)
      stage-2 slots/ep rank ~ (arrivals p*Cp) * min(1, (k/p)/d)
      expert slots          ~ N*k/per_rank  (total (token,expert) pairs)
    """
    pod_cap = min(1.0, k / p) * cf
    cp = max(1, int(round(n_tokens * pod_cap)))
    ep_cap = min(1.0, (k / p) / d) * cf
    cd = max(1, int(round(p * cp * ep_cap)))
    ce_target = max(1, int(round(n_tokens * k / per_rank * cf)))
    exp_cap = ce_target / (d * cd)
    return cl.DispatchConfig(num_experts=per_rank * p * d, top_k=k,
                             pod_capacity=pod_cap, ep_capacity=ep_cap,
                             expert_capacity=exp_cap)


def unicast_capacities(dcfg: cl.DispatchConfig, n_tokens: int, k: int,
                       ranks: int, per_rank: int,
                       cf: float) -> cl.DispatchConfig:
    """Rebase a :func:`balanced_capacities` config for the UNICAST
    (per-destination-RANK) packing of ``baseline_dispatch``: fair capacity
    is the balanced per-rank expectation (k/R), and ``expert_capacity``, a
    fraction of the incoming buffer, is renormalized from the hierarchical
    D*Cd buffer to the unicast R*Cr one (copied from the reference)."""
    rank_cap = min(1.0, k / ranks) * cf
    cr = max(1, int(round(n_tokens * rank_cap)))
    ce_target = max(1, int(round(n_tokens * k / per_rank * cf)))
    return dataclasses.replace(dcfg, pod_capacity=rank_cap,
                               expert_capacity=ce_target / (ranks * cr))


def load_balance_loss(logits, ids, num_experts: int):
    """Switch-style aux loss: E * sum_i f_i * P_i (local estimate)."""
    probs = torch.softmax(logits, dim=-1)                         # [N, E]
    experts = torch.arange(num_experts, device=ids.device)
    onehot = (ids[..., None] == experts).any(dim=1)
    f = onehot.float().mean(dim=0)
    return num_experts * torch.sum(f * probs.mean(dim=0))


def pipeline_config(pctx, cfg, n: int, d: int, d_ff: int,
                    itemsize: int) -> dict:
    """The round trip an MoE layer runs on ``n`` rows a rank of width ``d``
    (``itemsize`` bytes an element, expert hidden width ``d_ff``):
    ``{"moe_scheme", "moe_combine", "microbatch"}``.  The reference's
    order: the overlap context (priced at the H100's peak), the joint
    decision, G clamped to a divisor of ``n``, and the decision taken again
    at the G that runs."""
    ask = dict(tokens_per_rank=n, token_bytes=d * itemsize,
               compute_s=moe_compute_s(n, cfg.top_k, d, d_ff,
                                       tp=pctx.model_size))
    kw = pctx.moe_pipeline_kwargs(cfg.num_experts, cfg.top_k, **ask)
    g = math.gcd(max(1, int(kw["microbatch"])), n) or 1
    if g != int(kw["microbatch"]):
        kw = pctx.moe_pipeline_kwargs(cfg.num_experts, cfg.top_k,
                                      microbatch=g, **ask)
    return kw


def moe_ffn(params: MoE, x, cfg, pctx=None, capacity_factor=None, *,
            with_aux: bool = True, valid=None, reduce: bool = True):
    """x: [B, S, D] -> ([B, S, D], aux_loss).  With a ``pctx``, x holds this
    rank's data-parallel rows and ``params`` its experts.  ``with_aux=False``
    skips the aux loss (and its mean over the dp ranks) and returns None in
    its place: serving has no use for it.  With G > 1 chunks the aux is the
    mean over the chunks of each chunk's dp-mean.  ``valid`` [B] bool (None:
    every row): a row that is not valid is dispatched to no expert (the
    first pack's ``valid`` input), so it takes no capacity, and its output
    is zero.  ``reduce=False`` under ``moe_deferred_tp_reduce`` returns
    this rank's partial sum over the model axis (the caller reduces it);
    otherwise, and for a replicated expert width, the output is whole.

    Differentiable in x, the router and the experts: the packs run their
    backward kernel, the exchanges theirs (``parallel.mesh``), and
    gather_rows, the gates and the fp32 sums of the combine are autograd's
    own."""
    b, s, d = x.shape
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity
    n = b * s
    tokens = x.reshape(n, d)
    g = 1
    if pctx is None:
        epmesh = cl.EPMesh(pod_axis=None, ep_axis="_none", num_pods=1,
                           ep_per_pod=1)
        scheme = combine_scheme = "hierarchical"
    else:
        use_pod, _ = pctx.ep_ranks(cfg.num_experts)
        epmesh = cl.EPMesh(pod_axis=pctx.pod_axis if use_pod else None,
                           ep_axis=pctx.data_axis,
                           num_pods=pctx.num_pods if use_pod else 1,
                           ep_per_pod=pctx.data_size, ranks=pctx.mesh)
        kw = pipeline_config(pctx, cfg, n, d, params.d_ff,
                             x.element_size())
        scheme, combine_scheme = kw["moe_scheme"], kw["moe_combine"]
        g = kw["microbatch"]
    p, dd = epmesh.num_pods, epmesh.ep_per_pod
    per_rank = cfg.num_experts // (p * dd)
    # fractions of each stage's no-drop worst case, sized for the rank's
    # rows: each chunk's dispatch takes max(1, round(chunk rows * fraction))
    dcfg = balanced_capacities(n, cfg.top_k, p, dd, per_rank,
                               capacity_factor)
    if scheme == "baseline":
        dcfg = unicast_capacities(dcfg, n, cfg.top_k, p * dd, per_rank,
                                  capacity_factor)
    dispatch = (cl.hierarchical_dispatch if scheme == "hierarchical"
                else cl.baseline_dispatch)
    combine = {("hierarchical", "hierarchical"): cl.hierarchical_combine,
               ("hierarchical", "baseline"): cl.hierarchical_combine_unicast,
               ("baseline", "baseline"): cl.baseline_combine,
               }[(scheme, combine_scheme)]
    dp_group = (pctx.mesh.group(*pctx.dp_axes)
                if with_aux and pctx is not None and pctx.dp_size > 1
                else None)
    # deferred TP reduction: the combine is linear in the expert outputs,
    # so the row-parallel sum commutes through it, once on [N, D]; a
    # replicated expert width leaves no partial sums
    deferred = (pctx is not None and pctx.moe_deferred_tp_reduce
                and params.split)
    expert_ctx = None if deferred else L.model_ctx(params.split, pctx)

    rows_valid = (None if valid is None else
                  valid.to(torch.bool).repeat_interleave(s))    # [N]

    def dispatch_chunk(tok, tok_valid):
        """Router, top-k, the aux when asked for, and the dispatch."""
        logits = tok.float() @ params.router
        gates, ids = cl.route_topk(logits, cfg.top_k)
        aux = None
        if with_aux:
            aux = load_balance_loss(logits, ids, cfg.num_experts)
            if dp_group is not None:              # lax.pmean over dp axes
                aux = mesh_ops.mean(aux, dp_group, pctx.dp_size)
        return list(dispatch(tok, ids, gates, dcfg, epmesh,
                             valid=tok_valid)), aux

    def finish_chunk(pack):
        """The expert FFN and the combine.  Empties ``pack``, so that the
        packed rows are freed once the experts have read them, before the
        combine's exchanges (a Kimi-K2 rank's are 117 MB)."""
        exp_tok, exp_gate, st = pack
        pack.clear()
        exp_out = _expert_ffn(params.w1, params.w3, params.w2,
                              L.to_model(exp_tok, pctx) if deferred
                              else exp_tok, cfg.act, expert_ctx)
        del exp_tok
        if deferred:        # the combine multiplies partials by the gates
            exp_gate = L.to_model(exp_gate, pctx)
        out = combine(exp_out, exp_gate, st)
        if deferred and reduce:
            out = L.reduce_over_model(out, pctx)
        return out.to(x.dtype)

    if g == 1:
        pack, aux = dispatch_chunk(tokens, rows_valid)
        out = finish_chunk(pack)
    else:
        chunks = tokens.reshape(g, n // g, d)
        # the chunks are issued once each, in order
        chunk_valid = iter([None] * g if rows_valid is None
                           else rows_valid.reshape(g, n // g))
        issue, wait = _dispatch_hooks(
            chunks, lambda tok: dispatch_chunk(tok, next(chunk_valid)),
            params)
        outs, auxs = _pipeline(chunks, issue, wait, finish_chunk)
        out = torch.cat(outs)
        if with_aux:
            aux = (auxs[0] + torch.stack(auxs[1:]).sum()) / g
    return out.reshape(b, s, d), (aux if with_aux else None)


def _pipeline(chunks, issue, wait, finish_chunk):
    """The double-buffered chunk loop: chunk k+1's dispatch is issued before
    chunk k is finished (the reference's scan body), so every rank issues
    its exchanges in the same order.  ``issue(tok)`` dispatches a chunk and
    returns ``(pack, aux, handle)``; ``wait(handle)`` orders the chunk's
    finish after its dispatch.  Returns the outputs and the auxes, chunk by
    chunk."""
    outs, auxs = [], []
    pack, aux, handle = issue(chunks[0])
    auxs.append(aux)
    for k in range(1, len(chunks) + 1):
        if k < len(chunks):
            nxt = issue(chunks[k])
            auxs.append(nxt[1])
        wait(handle)
        outs.append(finish_chunk(pack))
        if k < len(chunks):
            pack, _, handle = nxt
    return outs, auxs


def _dispatch_hooks(chunks, dispatch_chunk, params):
    """``(issue, wait)`` of :func:`_pipeline` for ``dispatch_chunk``.  On
    the CPU the chunks run in issue order on one thread.  On the card every
    dispatch goes on the layer's own stream: its packs and
    ``all_to_all_single`` calls run there (NCCL makes the stream current at
    the call wait for the exchange), and an event makes the main stream
    wait before the chunk is finished, so chunk k+1's exchanges can overlap
    chunk k's expert products on the main stream.  Tensors made on the
    dispatch stream and read on the main one are recorded on it, so that
    the caching allocator does not hand their memory to the dispatch
    stream while the main stream may still read them."""
    if not chunks.is_cuda:
        return (lambda tok: (*dispatch_chunk(tok), None),
                lambda handle: None)
    main = torch.cuda.current_stream(chunks.device)
    side = params.dispatch_stream()
    side.wait_stream(main)                  # the tokens come from main

    def issue(tok):
        with torch.cuda.stream(side):
            pack, aux = dispatch_chunk(tok)
            done = torch.cuda.Event()
            done.record(side)
        for t in _tensors((pack, aux)):
            t.record_stream(main)
        return pack, aux, done

    return issue, main.wait_event


def _tensors(obj):
    """Every tensor in a nest of tuples and dataclasses (a dispatch's
    outputs and state)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _tensors(item)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
