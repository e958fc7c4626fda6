"""MultiWrite MoE dispatch / combine on tensors: the single-rank half.

Port of the MoE half of ``src/repro/core/collectives.py``.  The MultiWrite
dispatch sends ONE copy of each token per destination pod across the slow
axis (stage 1), relays replicate it inside the pod (stage 2), and each rank
groups its arrivals per local expert (stage 3); the combine walks the same
pack maps back with fp32 scatter-adds.  Every stage packs with the
bitmap-driven ``dispatch_pack`` kernel (three launches per dispatch).

This slice runs one rank (``num_pods == ep_per_pod == 1``): the stages keep
their packing and pack maps and the transports between them are identities.
Where the reference moves data with ``lax.all_to_all`` (``num_pods > 1`` or
``ep_per_pod > 1``) the port raises ``NotImplementedError``: that lowering
over ``torch.distributed`` is the multi-rank slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops

_MULTI_RANK = ("all_to_all transport across {} ranks is the multi-rank "
               "slice of the port; this slice runs one rank")


# ===========================================================================
# MoE routing
# ===========================================================================

def route_topk(logits: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k gating.  Returns (gates [.., k] fp32 normalized, ids [.., k]
    int32).  ``torch.topk`` promises no order among equal probabilities,
    where ``lax.top_k`` takes the lower index first, so the parity tests
    use distinct logits."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, ids.to(torch.int32)


# ===========================================================================
# Bitmap packing (cs_send analogue)
# ===========================================================================

def pack_by_bitmap(tokens: torch.Tensor, bitmap: torch.Tensor,
                   valid: torch.Tensor, num_dests: int, capacity: int):
    """Pack rows into per-destination send buffers, bitmap-driven (§4.1).

    tokens [N, H]; bitmap [N] int32 (bit d: destination d, d < 32); valid
    [N] bool; capacity C rows per destination (token order, overflow
    dropped).  Returns (out [D, C, H], src_idx [D, C] int32, -1 where empty).
    """
    return ops.dispatch_pack(tokens, bitmap, valid, num_dests=num_dests,
                             capacity=capacity)


def gather_rows(tokens: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """Gather rows by a pack map (-1 -> zeros)."""
    rows = tokens[src_idx.clamp(min=0).long()]
    keep = (src_idx >= 0).reshape(src_idx.shape + (1,) * (tokens.dim() - 1))
    return torch.where(keep, rows, torch.zeros((), dtype=tokens.dtype,
                                               device=tokens.device))


# ===========================================================================
# Hierarchical (MultiWrite) MoE dispatch / combine
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class EPMesh:
    """Static description of the expert-parallel mesh slice."""
    pod_axis: str | None        # slow axis; None = single level
    ep_axis: str                # fast axis
    num_pods: int
    ep_per_pod: int

    @property
    def num_ranks(self) -> int:
        return self.num_pods * self.ep_per_pod


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    num_experts: int
    top_k: int
    # capacity factors are vs. the no-drop worst case of each stage
    pod_capacity: float = 1.0
    ep_capacity: float = 1.0
    expert_capacity: float = 1.0


def expert_placement(cfg: DispatchConfig, mesh: EPMesh) -> int:
    """Experts are placed in contiguous blocks over (pod, ep) ranks."""
    if cfg.num_experts % mesh.num_ranks:
        raise ValueError(f"{cfg.num_experts} experts over {mesh.num_ranks} "
                         f"EP ranks")
    return cfg.num_experts // mesh.num_ranks


def _dest_coords(expert_ids: torch.Tensor, per_rank: int, ep_per_pod: int):
    """expert id -> (pod, ep) of owning rank."""
    rank = expert_ids // per_rank
    return rank // ep_per_pod, rank % ep_per_pod


def _bits(onehot: torch.Tensor) -> torch.Tensor:
    """[..., W] bool -> [...] int32 with bit w set where onehot[..., w]."""
    shifts = torch.arange(onehot.shape[-1], dtype=torch.int32,
                          device=onehot.device)
    return (onehot.to(torch.int32) << shifts).sum(dim=-1, dtype=torch.int32)


@dataclasses.dataclass
class DispatchState:
    """Pack maps threaded from dispatch to combine."""
    map_pod: torch.Tensor    # [P, Cp]  source row per stage-1 slot
    map_ep: torch.Tensor     # [D, Cd]  stage-1 flat slot per stage-2 slot
    map_exp: torch.Tensor    # [E_local, Ce] stage-2 flat slot per expert slot
    recv_src: torch.Tensor   # [P, Cp]  source row id as received
    n_tokens: int
    cfg: DispatchConfig
    mesh: EPMesh


def hierarchical_dispatch(tokens: torch.Tensor, expert_ids: torch.Tensor,
                          gates: torch.Tensor, cfg: DispatchConfig,
                          mesh: EPMesh):
    """MultiWrite MoE dispatch (paper §3.2 / §4).

    tokens [N, H]; expert_ids [N, K] int32; gates [N, K] fp32.
    Returns (expert_inputs [E_local, Ce, H], expert_gates [E_local, Ce],
    DispatchState with every pack map the combine needs).
    """
    n, h = tokens.shape
    k = expert_ids.shape[-1]
    dev = tokens.device
    per_rank = expert_placement(cfg, mesh)
    p, d = mesh.num_pods, mesh.ep_per_pod
    if not (per_rank <= 31 and d <= 31 and p <= 31):
        raise ValueError("bitmap words are int32: at most 31 destinations")
    pod_of, ep_of = _dest_coords(expert_ids, per_rank, d)      # [N, K]

    # ---- stage 1 pack: per destination pod, with ep bitmap metadata -------
    pods = torch.arange(p, device=dev)
    pod_bits = _bits((pod_of[..., None] == pods).any(dim=1))        # [N]
    # per-pod ep-rank bitmap: the §4.1 in-packet metadata the relay parses
    ep_onehot = ((pod_of[..., None] == pods)[..., None]
                 & (ep_of[..., None] == torch.arange(d, device=dev)
                    )[:, :, None, :])                               # [N,K,P,D]
    ep_bits = _bits(ep_onehot.any(dim=1))                           # [N, P]

    cp = max(1, int(round(n * cfg.pod_capacity)))
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    send_tok, map_pod = pack_by_bitmap(tokens, pod_bits, valid, p, cp)
    ep_bits_dst = torch.stack(
        [gather_rows(ep_bits[:, pp:pp + 1], map_pod[pp])[..., 0]
         for pp in range(p)])                                       # [P, Cp]
    meta_src = torch.where(map_pod >= 0, map_pod, -1)               # [P, Cp]
    ids_dst = gather_rows(expert_ids, map_pod.reshape(-1)).reshape(p, cp, k)
    gates_dst = gather_rows(gates, map_pod.reshape(-1)).reshape(p, cp, k)

    # ---- stage 1 transport over the pod axis ------------------------------
    if mesh.pod_axis is not None and p > 1:
        raise NotImplementedError(_MULTI_RANK.format(f"{p} pods"))
    recv_tok, recv_ep = send_tok, ep_bits_dst
    recv_src, recv_ids, recv_gates = meta_src, ids_dst, gates_dst

    # ---- stage 2: relay replication over the ep axis (cs_relay) ------------
    flat_tok = recv_tok.reshape(p * cp, h)
    flat_ep = recv_ep.reshape(p * cp)
    flat_valid = recv_src.reshape(p * cp) >= 0
    cd = max(1, int(round(p * cp * cfg.ep_capacity)))
    relay_tok, map_ep = pack_by_bitmap(flat_tok, flat_ep, flat_valid, d, cd)
    relay_ids = gather_rows(recv_ids.reshape(p * cp, k), map_ep.reshape(-1)
                            ).reshape(d, cd, k)
    relay_gates = gather_rows(recv_gates.reshape(p * cp, k),
                              map_ep.reshape(-1)).reshape(d, cd, k)
    if d > 1:
        raise NotImplementedError(_MULTI_RANK.format(f"{d} ep ranks"))
    got_tok, got_ids, got_gates = relay_tok, relay_ids, relay_gates
    got_valid = map_ep >= 0

    # ---- stage 3: local per-expert grouping (zero comm) --------------------
    my_rank = 0
    flat2_tok = got_tok.reshape(d * cd, h)
    flat2_ids = got_ids.reshape(d * cd, k)
    flat2_gates = got_gates.reshape(d * cd, k)
    flat2_valid = got_valid.reshape(d * cd)
    local_e = flat2_ids - my_rank * per_rank                        # [M, K]
    mine = (local_e >= 0) & (local_e < per_rank)
    # top-k ids are distinct, so a token hits each local expert at most
    # once and the sum of the bits is their OR
    exp_bits = torch.where(mine, 1 << local_e.clamp(0, 30), 0).sum(
        dim=-1, dtype=torch.int32)
    ce = max(1, int(round(d * cd * cfg.expert_capacity)))
    exp_tok, map_exp = pack_by_bitmap(flat2_tok, exp_bits, flat2_valid,
                                      per_rank, ce)
    exp_gate = _gate_for_expert(flat2_ids, flat2_gates, map_exp,
                                my_rank * per_rank, per_rank)

    state = DispatchState(map_pod=map_pod, map_ep=map_ep, map_exp=map_exp,
                          recv_src=recv_src, n_tokens=n, cfg=cfg, mesh=mesh)
    return exp_tok, exp_gate, state


def _gate_for_expert(ids: torch.Tensor, gates: torch.Tensor,
                     map_exp: torch.Tensor, base: int,
                     per_rank: int) -> torch.Tensor:
    """Gate value of each packed (expert, slot) row: the gate of the k-slot
    whose expert id is this expert."""
    e_local, ce = map_exp.shape
    rows_ids = gather_rows(ids, map_exp.reshape(-1)).reshape(e_local, ce, -1)
    rows_gates = gather_rows(gates, map_exp.reshape(-1)
                             ).reshape(e_local, ce, -1)
    experts = base + torch.arange(e_local, device=ids.device)
    want = rows_ids == experts[:, None, None]
    return torch.where(want, rows_gates, 0.0).sum(dim=-1)          # [E_l, Ce]


def _sum_rows_into(index: torch.Tensor, rows: torch.Tensor, num_slots: int,
                   width: int) -> torch.Tensor:
    """fp32 [num_slots, H]: slot m holds the sum of the ``rows`` whose
    ``index`` is m (the reference's ``.at[].add`` into ``num_slots + 1``
    rows, the last, for index -1, cut off).

    index [R, C] gives each of the R * C rows its slot; one group r holds a
    slot at most once, so a slot gathers at most ``width`` <= R rows.  No
    atomics: the index is inverted into a [num_slots, width] table (column
    j of slot m: the j-th group, in group order, that holds m; every write
    has its own destination), and the rows are gathered and added column by
    column.  So the fp32 sums come out in a fixed order, bit-identical from
    run to run, where ``index_add_`` on the card adds in whatever order its
    atomics land."""
    r, c = index.shape
    h = rows.shape[-1]
    dev = rows.device
    held = index >= 0
    slot = torch.where(held, index, num_slots).long()          # [R, C]
    # scatters only: an index assignment of a Python number copies it from
    # the host, and that copy waits for the stream
    if width == 1:
        col = torch.zeros_like(slot)
    else:
        occ = torch.zeros((r, num_slots + 1), dtype=torch.int32, device=dev)
        occ.scatter_(1, slot, 1)                  # group g holds slot m
        col = torch.where(held, (occ.cumsum(dim=0) - 1).gather(1, slot), 0)
    table = torch.full(((num_slots + 1) * width,), -1, dtype=torch.int32,
                       device=dev)
    table.scatter_(0, (slot * width + col).reshape(-1),
                   torch.arange(r * c, dtype=torch.int32, device=dev))
    table = table.reshape(num_slots + 1, width)
    flat = rows.reshape(r * c, h)
    out = gather_rows(flat, table[:num_slots, 0]).float()
    for j in range(1, width):
        out += gather_rows(flat, table[:num_slots, j]).float()
    return out


def hierarchical_combine(expert_out: torch.Tensor, exp_gate: torch.Tensor,
                         state: DispatchState) -> torch.Tensor:
    """Return path with relay-side partial reduction: per-(token, pod)
    partials are pre-reduced at the relay before crossing the pod axis.

    Returns [N, H] fp32 combined outputs aligned with the dispatch rows.
    """
    mesh = state.mesh
    p, d = mesh.num_pods, mesh.ep_per_pod
    cd = state.map_ep.shape[1]
    cp = state.map_pod.shape[1]
    e_local = state.map_exp.shape[0]
    if d > 1:
        raise NotImplementedError(_MULTI_RANK.format(f"{d} ep ranks"))
    if mesh.pod_axis is not None and p > 1:
        raise NotImplementedError(_MULTI_RANK.format(f"{p} pods"))

    # ---- apply gates, sum expert slots back into stage-2 slots: a token
    # sits in at most top_k of this rank's experts --------------------------
    weighted = expert_out * exp_gate[..., None]
    flat2 = _sum_rows_into(state.map_exp, weighted, d * cd,
                           min(state.cfg.top_k, e_local))
    # ---- relay-side reduction: sum per stage-1 slot over ep ranks ----------
    flat1 = _sum_rows_into(state.map_ep, flat2.reshape(d, cd, -1), p * cp, d)
    # ---- sum into source rows -----------------------------------------------
    return _sum_rows_into(state.map_pod, flat1.reshape(p, cp, -1),
                          state.n_tokens, p)
