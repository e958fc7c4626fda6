"""MoE FFN layer on the MultiWrite hierarchical dispatch.

Port of ``src/repro/models/moe.py`` for one rank (``pctx=None``): router ->
top-k -> ``hierarchical_dispatch`` (three ``dispatch_pack`` launches) ->
per-expert gated FFN -> ``hierarchical_combine`` (fp32 sums in a fixed
order).  The expert products are batched matrix products outside any kernel
of the reference, so they go to ``torch.bmm``.  The multi-rank path (a
``ParallelContext`` with pods and ep ranks) is a later slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import collectives as cl
from repro_torch.models import layers as L


class MoE(nn.Module):
    """Router [D, E] (fp32) and stacked gated-FFN expert weights:
    w1/w3 [E, D, F], w2 [E, F, D]."""

    def __init__(self, d: int, f: int, num_experts: int, *, device, dtype):
        super().__init__()
        self.router = L.parameter((d, num_experts), device=device,
                                  dtype=torch.float32)
        self.w1 = L.parameter((num_experts, d, f), device=device, dtype=dtype)
        self.w3 = L.parameter((num_experts, d, f), device=device, dtype=dtype)
        self.w2 = L.parameter((num_experts, f, d), device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> "MoE":
        _, d, f = self.w1.shape
        sc_d, sc_f = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        L.truncated_normal_(self.router, sc_d, generator)
        L.truncated_normal_(self.w1, sc_d, generator)
        L.truncated_normal_(self.w3, sc_d, generator)
        L.truncated_normal_(self.w2, sc_f, generator)
        return self


def init_moe(d: int, f: int, num_experts: int, *, generator, device,
             dtype) -> MoE:
    return MoE(d, f, num_experts, device=device, dtype=dtype
               ).reset_parameters(generator)


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


def load_balance_loss(logits, ids, num_experts: int):
    """Switch-style aux loss: E * sum_i f_i * P_i (local estimate)."""
    probs = torch.softmax(logits, dim=-1)                         # [N, E]
    experts = torch.arange(num_experts, device=ids.device)
    onehot = (ids[..., None] == experts).any(dim=1)
    f = onehot.float().mean(dim=0)
    return num_experts * torch.sum(f * probs.mean(dim=0))


def moe_ffn(params: MoE, x, cfg, pctx=None, capacity_factor=None):
    """x: [B, S, D] -> ([B, S, D], aux_loss)."""
    if pctx is not None:
        raise NotImplementedError("moe_ffn over a ParallelContext is the "
                                  "multi-rank slice of the port")
    b, s, d = x.shape
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity
    epmesh = cl.EPMesh(pod_axis=None, ep_axis="_none", num_pods=1,
                       ep_per_pod=1)
    dcfg = balanced_capacities(b * s, cfg.top_k, 1, 1, cfg.num_experts,
                               capacity_factor)
    out, aux = _moe_local(params, x.reshape(b * s, d), cfg, dcfg, epmesh)
    return out.reshape(b, s, d).to(x.dtype), aux


def _moe_local(params: MoE, tokens, cfg, dcfg, epmesh):
    """Single-rank path: the same dispatch code, no transports."""
    logits = tokens.float() @ params.router
    gates, ids = cl.route_topk(logits, cfg.top_k)
    aux = load_balance_loss(logits, ids, cfg.num_experts)
    exp_tok, exp_gate, st = cl.hierarchical_dispatch(
        tokens, ids, gates, dcfg, epmesh)
    exp_out = _expert_ffn(params.w1, params.w3, params.w2, exp_tok, cfg.act)
    return cl.hierarchical_combine(exp_out, exp_gate, st), aux
