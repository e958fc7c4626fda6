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
alone.  Only ``plan_policy="fixed"`` at one pipeline chunk is ported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core import collectives as cl
from repro_torch.models import layers as L


class MoE(nn.Module):
    """Router [D, E] (fp32) and the gated-FFN weights of the experts
    ``[first, first + local)`` of E: w1/w3 [local, D, F], w2 [local, F, D]
    (all E when ``local`` is None)."""

    def __init__(self, d: int, f: int, num_experts: int, *, device, dtype,
                 first: int = 0, local: int | None = None):
        super().__init__()
        local = num_experts if local is None else local
        self.first = first
        self.router = L.parameter((d, num_experts), device=device,
                                  dtype=torch.float32)
        self.w1 = L.parameter((local, d, f), device=device, dtype=dtype)
        self.w3 = L.parameter((local, d, f), device=device, dtype=dtype)
        self.w2 = L.parameter((local, f, d), device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator,
                         layer: int = 0) -> "MoE":
        """The router from ``generator``; each expert's w1, w3, w2 from a
        generator of its own, seeded from ``generator``'s seed, the layer
        and the expert index.  So a rank draws only its own experts, and
        they equal the same experts of the one-rank model."""
        _, d, f = self.w1.shape
        sc_d, sc_f = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        L.truncated_normal_(self.router, sc_d, generator)
        for i in range(self.w1.shape[0]):
            gen = torch.Generator(device=self.w1.device)
            gen.manual_seed(expert_seed(generator.initial_seed(), layer,
                                        self.first + i))
            L.truncated_normal_(self.w1[i], sc_d, gen)
            L.truncated_normal_(self.w3[i], sc_d, gen)
            L.truncated_normal_(self.w2[i], sc_f, gen)
        return self


def expert_seed(seed: int, layer: int, expert: int) -> int:
    """The seed of one expert's weights: a hash of (model seed, layer,
    expert) that does not depend on which rank draws it."""
    return int(np.random.SeedSequence([seed, layer, expert]
                                      ).generate_state(1, np.uint64)[0] >> 1)


def init_moe(d: int, f: int, num_experts: int, *, generator, device,
             dtype) -> MoE:
    return MoE(d, f, num_experts, device=device, dtype=dtype
               ).reset_parameters(generator)


def expert_shard(pctx, num_experts: int) -> tuple[int, int]:
    """(first, count) of the experts a rank holds: ``per_rank`` in a
    contiguous block, at the rank's EP index (``moe_specs``' sharding over
    (pod, data) or data alone); all of them without a context."""
    if pctx is None:
        return 0, num_experts
    use_pod, ranks = pctx.ep_ranks(num_experts)
    if num_experts % ranks:
        raise ValueError(f"{num_experts} experts over {ranks} EP ranks")
    per_rank = num_experts // ranks
    ep_axes = (pctx.pod_axis, pctx.data_axis) if use_pod else \
        (pctx.data_axis,)
    return pctx.mesh.axis_index(*ep_axes) * per_rank, per_rank


def _expert_ffn(w1, w3, w2, x, act_name: str):
    """Per-expert gated FFN on packed buffers x: [E, C, D]."""
    act = L.activation(act_name)
    h = act(torch.bmm(x, w1)) * torch.bmm(x, w3)
    return torch.bmm(h, w2)


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


def moe_ffn(params: MoE, x, cfg, pctx=None, capacity_factor=None, *,
            with_aux: bool = True):
    """x: [B, S, D] -> ([B, S, D], aux_loss).  With a ``pctx``, x holds this
    rank's data-parallel rows and ``params`` its experts.  ``with_aux=False``
    skips the aux loss (and its mean over the dp ranks) and returns None in
    its place: serving has no use for it."""
    b, s, d = x.shape
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity
    n = b * s
    tokens = x.reshape(n, d)
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
        kw = pctx.moe_pipeline_kwargs()
        scheme, combine_scheme = kw["moe_scheme"], kw["moe_combine"]
    p, dd = epmesh.num_pods, epmesh.ep_per_pod
    per_rank = cfg.num_experts // (p * dd)
    dcfg = balanced_capacities(n, cfg.top_k, p, dd, per_rank,
                               capacity_factor)
    if scheme == "baseline":
        dcfg = unicast_capacities(dcfg, n, cfg.top_k, p * dd, per_rank,
                                  capacity_factor)

    logits = tokens.float() @ params.router
    gates, ids = cl.route_topk(logits, cfg.top_k)
    aux = None
    if with_aux:
        aux = load_balance_loss(logits, ids, cfg.num_experts)
        if pctx is not None and pctx.dp_size > 1:   # lax.pmean over dp axes
            dist.all_reduce(aux, group=pctx.mesh.group(*pctx.dp_axes))
            aux = aux / pctx.dp_size
    dispatch = (cl.hierarchical_dispatch if scheme == "hierarchical"
                else cl.baseline_dispatch)
    exp_tok, exp_gate, st = dispatch(tokens, ids, gates, dcfg, epmesh)
    exp_out = _expert_ffn(params.w1, params.w3, params.w2, exp_tok, cfg.act)
    combine = {("hierarchical", "hierarchical"): cl.hierarchical_combine,
               ("hierarchical", "baseline"): cl.hierarchical_combine_unicast,
               ("baseline", "baseline"): cl.baseline_combine,
               }[(scheme, combine_scheme)]
    out = combine(exp_out, exp_gate, st)
    return out.reshape(b, s, d).to(x.dtype), aux
