"""MultiWrite collectives on tensors, over ``torch.distributed``.

Port of ``src/repro/core/collectives.py``.  The AllGather half (§3.1,
§5.2) gathers a model-axis-sharded activation within its split-TP domain:
:func:`multiwrite_allgather` routes part of each fragment over the idle
cross-domain links, one copy to the same-index partner, which relays it to
its domain peers, in rounds of one permutation each
(:meth:`~repro_torch.parallel.mesh.RankMesh.ppermute`);
:func:`planned_allgather` takes its scheme and split from a planner
decision; :func:`allgather_reference` is the plain domain ``all_gather``.
All three return ``[domain_size, *x.shape]``, bit-identical.

The MoE half: the MultiWrite
dispatch sends ONE copy of each token per destination pod across the slow
axis (stage 1), relays replicate it inside the pod (stage 2), and each rank
groups its arrivals per local expert (stage 3); the combine walks the same
pack maps back with fp32 sums in a fixed order.  Every stage packs with the
bitmap-driven ``dispatch_pack`` kernel (three launches per dispatch).  The
baseline (unicast) dispatch sends one copy per (token, destination rank)
instead, ``ceil(R / 31)`` packs and one more for the experts.

Transports: the reference's ``lax.all_to_all(split_axis=0, concat_axis=0,
tiled=True)`` on a named axis is :func:`_all_to_all`
(``dist.all_to_all_single``) on that axis's subgroup of the
:class:`EPMesh`'s rank mesh, and ``lax.axis_index`` is the rank's
coordinate on it.  With one pod and one ep rank (``pctx=None``) the
transports are identities and no process group is needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops


# ===========================================================================
# AllGather over split TP domains (§3.1, §5.2)
# ===========================================================================

def _domain_groups(n: int, num_domains: int) -> list[list[int]]:
    d = n // num_domains
    return [list(range(i * d, (i + 1) * d)) for i in range(num_domains)]


def _my_domain(ranks, axis_name: str, num_domains: int) -> list[int]:
    n = ranks.axis_size(axis_name)
    me = ranks.axis_index(axis_name)
    return _domain_groups(n, num_domains)[me // (n // num_domains)]


def allgather_reference(x: torch.Tensor, ranks, axis_name: str,
                        num_domains: int = 2) -> torch.Tensor:
    """Baseline: all_gather over the local TP domain only (paper §5.2
    traditional workflow), over the ``RankMesh`` ``ranks``.  Returns
    [domain_size, *x.shape]."""
    return ranks.all_gather(x, axis_name,
                            _my_domain(ranks, axis_name, num_domains))


def multiwrite_allgather(x: torch.Tensor, ranks, axis_name: str, *,
                         num_domains: int = 2, split: float = 0.5,
                         mode: str = "paired") -> torch.Tensor:
    """MultiWrite AllGather over a split-TP axis (paper §5.2 optimized).

    The axis of size ``n`` is split into ``num_domains`` equal TP domains
    (blocked).  Each rank all-gathers within its own domain, but routes a
    ``1 - split`` fraction of its fragment over the otherwise-idle
    cross-domain links: ONE copy to the same-index partner (the relay),
    which replicates to the source's domain peers.  The leading axis of
    ``x`` is split; ``mode`` is "paired" (the partner relays the whole
    cross chunk) or "full" (the cross chunk sliced over every
    opposite-domain rank).  Returns [domain_size, *x.shape], bit-identical
    to :func:`allgather_reference`."""
    if num_domains != 2:
        raise NotImplementedError("paired relaying is defined for 2 domains")
    n = ranks.axis_size(axis_name)
    half = n // 2
    rows = x.shape[0]
    cut = max(0, min(rows, int(round(rows * split))))
    if cut == rows:  # pure baseline
        return allgather_reference(x, ranks, axis_name, num_domains)
    if mode not in ("paired", "full"):
        raise ValueError(f"unknown mode {mode!r}")
    xd, xc = x[:cut], x[cut:]
    # direct part: intra-domain all_gather
    gd = allgather_reference(xd, ranks, axis_name, num_domains)
    relay = _paired_relay_gather if mode == "paired" else _full_relay_gather
    gc = relay(xc, ranks, axis_name, n, half)
    return torch.cat([gd, gc], dim=1)


def planned_allgather(x: torch.Tensor, ranks, axis_name: str, *,
                      num_domains: int = 2, planner=None, hw=None,
                      decision=None) -> torch.Tensor:
    """AllGather whose scheme and split come from a planner decision (§5.2
    dynamic workflow): ``decision`` (a bound plan's per-site verdict), or
    without one the process planner's choice for this fragment on the
    split-TP topology of the axis."""
    if decision is None:
        from repro_torch.core import planner as _planner_mod
        from repro_torch.core.topology import split_tp_full_mesh
        n = ranks.axis_size(axis_name)
        frag_bytes = x.numel() * x.element_size()
        topo, _ = split_tp_full_mesh(n, tp=max(1, n // num_domains))
        pl = planner or _planner_mod.default_planner()
        decision = pl.choose("allgather", frag_bytes, topo, hw,
                             executable_only=True, num_domains=num_domains)
    kw = decision.shard_map_kwargs
    if kw["mode"] is None:
        return allgather_reference(x, ranks, axis_name, num_domains)
    return multiwrite_allgather(x, ranks, axis_name, num_domains=num_domains,
                                split=kw["split"], mode=kw["mode"])


def _paired_relay_gather(xc: torch.Tensor, ranks, axis_name: str, n: int,
                         half: int) -> torch.Tensor:
    """Stage 1: swap cross chunks with the same-index partner (ONE copy on
    each cross link).  Stage 2: each relay forwards its partner's chunk to
    the partner's domain peers, one permutation round per peer offset —
    distinct links per round (§3.1 paired relaying)."""
    swap = [(i, (i + half) % n) for i in range(n)]
    xr = ranks.ppermute(xc, axis_name, swap)   # chunk of source partner(i)
    # round r: relay i, holding source s = (i + half) % n, forwards it to
    # the peer at offset r of s's domain
    received = []
    for r in range(1, half):
        perm = []
        for i in range(n):
            s = (i + half) % n
            base, idx = (s // half) * half, s % half
            perm.append((i, base + (idx + r) % half))
        received.append(ranks.ppermute(xr, axis_name, perm))
    # slots[r] holds source (idx - r) % half: source k sits at slot
    # (idx - k) % half (the rank index is a host int: static indexing)
    idx = ranks.axis_index(axis_name) % half
    slots = [xc] + received
    return torch.stack([slots[(idx - k) % half] for k in range(half)])


def _full_relay_gather(xc: torch.Tensor, ranks, axis_name: str, n: int,
                       half: int) -> torch.Tensor:
    """Full multi-path relaying (§3.1): the cross chunk is sliced over ALL
    ``half`` opposite-domain ranks; each relay forwards its slice to the
    source's domain peers.

    Stage 1, round r: rank i sends slice ``(idx(i) + r) % half`` to the
    opposite-domain rank of that index, one slice copy per cross link.
    Stage 2, round (r, f), f = 1..half-1: relay j forwards its round-r
    slice to the source's peer ``(t - r + f) % half``; rank q (index iq)
    thereby receives slice ``(iq + r - f) % half`` of its domain-mate
    ``(iq - f) % half``: every slice of every peer exactly once."""
    rows = xc.shape[0]
    pad = (-rows) % half
    if pad:
        xc = torch.cat([xc, xc.new_zeros((pad,) + tuple(xc.shape[1:]))])
    sliced = xc.reshape((half, xc.shape[0] // half) + tuple(xc.shape[1:]))
    idx = ranks.axis_index(axis_name) % half

    # stage 1
    landed = []
    for r in range(half):
        perm = [(i, (((i // half) ^ 1) * half) + (i % half + r) % half)
                for i in range(n)]
        landed.append(ranks.ppermute(sliced[(idx + r) % half], axis_name,
                                     perm))
    # stage 2
    out_rounds: list[list[torch.Tensor]] = [[] for _ in range(half)]
    for r in range(half):
        for f in range(1, half):
            perm = [(j, (((j // half) ^ 1) * half) + (j % half - r + f)
                     % half) for j in range(n)]
            out_rounds[f].append(ranks.ppermute(landed[r], axis_name, perm))

    # assembly: round r carries slice (idx + r - f) % half, so slice sl
    # sits at round (sl - idx + f) % half; gathered[f] is the chunk of peer
    # (idx - f) % half, so peer k sits at f = (idx - k) % half
    tail = tuple(xc.shape[1:])
    gathered = [sliced.reshape((-1,) + tail)]
    for f in range(1, half):
        gathered.append(torch.cat([out_rounds[f][(sl - idx + f) % half]
                                   for sl in range(half)]))
    out = torch.stack([gathered[(idx - k) % half] for k in range(half)])
    return out[:, :rows] if pad else out


# ===========================================================================
# MoE routing
# ===========================================================================

def route_topk(logits: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k gating.  Returns (gates [.., k] fp32 normalized, ids [.., k]
    int32).  Among equal probabilities the lower index comes first, as
    ``lax.top_k`` orders them: a stable descending sort cut to k."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :k], ids[..., :k]
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
    """Gather rows by a pack map (-1 -> zeros, filled in place)."""
    rows = tokens[src_idx.clamp(min=0).long()]
    keep = (src_idx >= 0).reshape(src_idx.shape + (1,) * (tokens.dim() - 1))
    return rows.masked_fill_(~keep, 0)


# ===========================================================================
# Hierarchical (MultiWrite) MoE dispatch / combine
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class EPMesh:
    """Static description of the expert-parallel mesh slice.  ``ranks``
    (a :class:`~repro_torch.parallel.mesh.RankMesh`) holds the axes'
    process groups; it may be None when both levels have one rank."""
    pod_axis: str | None        # slow axis; None = single level
    ep_axis: str                # fast axis
    num_pods: int
    ep_per_pod: int
    ranks: object = None

    @property
    def num_ranks(self) -> int:
        return self.num_pods * self.ep_per_pod

    def group(self, axis: str):
        if self.ranks is None:
            raise ValueError(f"a transport over {axis!r} needs a rank mesh")
        return self.ranks.group(axis)

    def axis_index(self, axis: str) -> int:
        if self.ranks is None:
            raise ValueError(f"the index on {axis!r} needs a rank mesh")
        return self.ranks.axis_index(axis)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`` over
    ``group``: the R equal blocks of dim 0 go one to each group rank, and
    the blocks received are stacked in group-rank order.  Metadata travels
    in its own dtype (bool, int32)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


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
                          mesh: EPMesh, valid: torch.Tensor | None = None):
    """MultiWrite MoE dispatch (paper §3.2 / §4).

    tokens [N, H]; expert_ids [N, K] int32; gates [N, K] fp32; valid [N]
    bool (None: every row), the rows the first pack may take.
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
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    send_tok, map_pod = pack_by_bitmap(tokens, pod_bits, valid, p, cp)
    ep_bits_dst = torch.stack(
        [gather_rows(ep_bits[:, pp:pp + 1], map_pod[pp])[..., 0]
         for pp in range(p)])                                       # [P, Cp]
    meta_src = torch.where(map_pod >= 0, map_pod, -1)               # [P, Cp]
    ids_dst = gather_rows(expert_ids, map_pod.reshape(-1)).reshape(p, cp, k)
    gates_dst = gather_rows(gates, map_pod.reshape(-1)).reshape(p, cp, k)

    # ---- stage 1 transport: all_to_all over the pod axis -------------------
    if mesh.pod_axis is not None and p > 1:
        pod = mesh.group(mesh.pod_axis)
        recv_tok = _all_to_all(send_tok, pod)                       # [P,Cp,H]
        recv_ep = _all_to_all(ep_bits_dst, pod)
        recv_src = _all_to_all(meta_src, pod)
        recv_ids = _all_to_all(ids_dst, pod)
        recv_gates = _all_to_all(gates_dst, pod)
    else:
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
        ep = mesh.group(mesh.ep_axis)
        got_tok = _all_to_all(relay_tok, ep)                        # [D,Cd,H]
        got_ids = _all_to_all(relay_ids, ep)
        got_gates = _all_to_all(relay_gates, ep)
        got_valid = _all_to_all(map_ep >= 0, ep)
    else:
        got_tok, got_ids, got_gates = relay_tok, relay_ids, relay_gates
        got_valid = map_ep >= 0

    # ---- stage 3: local per-expert grouping (zero comm) --------------------
    my_rank = _my_rank(mesh)
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


SUM_BLOCK_BYTES = 64 << 20    # a block of gathered rows in _sum_rows_into


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
    table = table.reshape(num_slots + 1, width)[:num_slots]
    flat = rows.reshape(r * c, h)
    out = torch.empty((num_slots, h), dtype=torch.float32, device=dev)
    # slots in blocks, so that a gather's temporary stays small beside the
    # [num_slots, H] sums (the stage-2 partials of a Kimi-K2 layer are
    # 470 MB a rank); each sum adds its rows in column order as before
    step = max(1, SUM_BLOCK_BYTES // max(1, h * flat.element_size()))
    for lo in range(0, num_slots, step):
        blk = out[lo:lo + step]
        blk.copy_(gather_rows(flat, table[lo:lo + step, 0]))
        for j in range(1, width):
            blk += gather_rows(flat, table[lo:lo + step, j])
    return out


def _my_rank(mesh: EPMesh) -> int:
    """This rank's index in the flattened (pod, ep) EP domain."""
    my_pod = (mesh.axis_index(mesh.pod_axis)
              if (mesh.pod_axis and mesh.num_pods > 1) else 0)
    my_ep = mesh.axis_index(mesh.ep_axis) if mesh.ep_per_pod > 1 else 0
    return my_pod * mesh.ep_per_pod + my_ep


def _back_to_relays(expert_out, exp_gate, state: DispatchState):
    """Gate the expert rows, sum each token's local experts into its
    stage-2 slot, and send the partials back over the ep axis to the relays
    that sent them: [D, Cd, H] fp32, block j from ep rank j."""
    mesh = state.mesh
    d = mesh.ep_per_pod
    cd = state.map_ep.shape[1]
    # a token sits in at most top_k of this rank's experts; the gated rows
    # are freed before the exchange
    flat2 = _sum_rows_into(state.map_exp, expert_out * exp_gate[..., None],
                           d * cd,
                           min(state.cfg.top_k, state.map_exp.shape[0]))
    flat2 = flat2.reshape(d, cd, -1)
    return _all_to_all(flat2, mesh.group(mesh.ep_axis)) if d > 1 else flat2


def _over_pod(x: torch.Tensor, mesh: EPMesh) -> torch.Tensor:
    """All_to_all over the pod axis of x [P, ...] (it is its own reverse)."""
    if mesh.pod_axis is not None and mesh.num_pods > 1:
        return _all_to_all(x, mesh.group(mesh.pod_axis))
    return x


def hierarchical_combine(expert_out: torch.Tensor, exp_gate: torch.Tensor,
                         state: DispatchState) -> torch.Tensor:
    """Return path with relay-side partial reduction: per-(token, pod)
    partials are pre-reduced at the relay before crossing the pod axis, ONE
    partial per (token, pod) on the slow axis.

    Returns [N, H] fp32 combined outputs aligned with the dispatch rows.
    A token's sum runs over its experts on each rank, then over the ep
    ranks of each pod (at the relay), then over the pods, each in index
    order.
    """
    mesh = state.mesh
    p, d = mesh.num_pods, mesh.ep_per_pod
    cp = state.map_pod.shape[1]
    back = _back_to_relays(expert_out, exp_gate, state)          # [D, Cd, H]
    # ---- relay-side reduction: sum per stage-1 slot over ep ranks ----------
    flat1 = _sum_rows_into(state.map_ep, back, p * cp, d)
    # ---- reverse pod a2a, then sum into source rows --------------------------
    home = _over_pod(flat1.reshape(p, cp, -1), mesh)
    return _sum_rows_into(state.map_pod, home, state.n_tokens, p)


def hierarchical_combine_unicast(expert_out: torch.Tensor,
                                 exp_gate: torch.Tensor,
                                 state: DispatchState) -> torch.Tensor:
    """Unicast return path for the hierarchical dispatch: NO relay-side
    reduction, every (token, ep-rank) partial crosses the pod axis on its
    own (up to ``ep_per_pod`` x the slow-axis bytes of
    :func:`hierarchical_combine`) and is reduced at the home rank.  The sums
    run in the same order as :func:`hierarchical_combine`'s (a missing
    partial is a zero row, and adding zero changes no sum), so the two give
    bit-identical outputs."""
    mesh = state.mesh
    p, d = mesh.num_pods, mesh.ep_per_pod
    cp = state.map_pod.shape[1]
    back = _back_to_relays(expert_out, exp_gate, state)          # [D, Cd, H]
    # ---- NO relay reduction: one slot per (stage-1 slot, ep rank) ----------
    sl = state.map_ep
    ep_of = torch.arange(d, dtype=sl.dtype, device=sl.device)[:, None]
    unred = _sum_rows_into(torch.where(sl >= 0, sl * d + ep_of, -1), back,
                           p * cp * d, 1)
    del back                                 # freed before the exchange
    # ---- reverse pod a2a: d unreduced partials per stage-1 slot ------------
    home = _over_pod(unred.reshape(p, cp, d, -1), mesh)
    # ---- reduce AFTER crossing, in ep order, then into source rows ----------
    red = home[:, :, 0]
    for j in range(1, d):
        red = red + home[:, :, j]
    return _sum_rows_into(state.map_pod, red, state.n_tokens, p)


# ===========================================================================
# Baseline (unicast) dispatch / combine: one copy per (token, dest rank)
# ===========================================================================

def _exchange_ranks(x: torch.Tensor, mesh: EPMesh, *,
                    back: bool = False) -> torch.Tensor:
    """The baseline's flattened-domain exchange of x [R, Cr, ...] (R =
    (pod, ep) ranks, row-major): an all_to_all over ep that splits axis 1
    of the [P, D, Cr, ...] view, then one over pod that splits axis 0
    (``back``: pod first, then ep)."""
    p, d = mesh.num_pods, mesh.ep_per_pod
    rest = x.shape[1:]
    x = x.reshape(p, d, *rest)
    for step in ((_over_pod, _over_ep) if back else (_over_ep, _over_pod)):
        x = step(x, mesh)
    return x.reshape(p * d, *rest)


def _over_ep(x: torch.Tensor, mesh: EPMesh) -> torch.Tensor:
    """All_to_all over ep of axis 1 of x [P, D, ...]: that axis goes to the
    front, is exchanged, and goes back."""
    if mesh.ep_per_pod == 1:
        return x
    return _all_to_all(x.movedim(1, 0), mesh.group(mesh.ep_axis)
                       ).movedim(0, 1)


@dataclasses.dataclass
class BaselineState:
    map_rank: torch.Tensor   # [R, Cr]  source row per destination-rank slot
    map_exp: torch.Tensor    # [E_local, Ce]
    n_tokens: int
    cfg: DispatchConfig
    mesh: EPMesh


def baseline_dispatch(tokens: torch.Tensor, expert_ids: torch.Tensor,
                      gates: torch.Tensor, cfg: DispatchConfig,
                      mesh: EPMesh, valid: torch.Tensor | None = None):
    """Unicast dispatch: pack one copy per (token, destination RANK) and
    exchange over the flattened (pod, ep) domain, so each token's copies to
    every remote rank cross the pod axis (the paper's baseline).  Packs in
    ``ceil(R / 31)`` bitmap words, then once per local expert.  ``valid``
    as :func:`hierarchical_dispatch`'s."""
    n, h = tokens.shape
    k = expert_ids.shape[-1]
    dev = tokens.device
    per_rank = expert_placement(cfg, mesh)
    p, d = mesh.num_pods, mesh.ep_per_pod
    r = p * d
    rank_of = expert_ids // per_rank                               # [N, K]
    rank_any = (rank_of[..., None]
                == torch.arange(r, device=dev)).any(dim=1)          # [N, R]
    cr = max(1, int(round(n * cfg.pod_capacity)))
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    outs, maps = [], []
    for w in range((r + 30) // 31):
        nd = min(31, r - w * 31)
        o, m = pack_by_bitmap(tokens, _bits(rank_any[:, w * 31:w * 31 + nd]),
                              valid, nd, cr)
        outs.append(o)
        maps.append(m)
    send_tok = torch.cat(outs)                                      # [R,Cr,H]
    map_rank = torch.cat(maps)                                      # [R, Cr]
    ids_send = gather_rows(expert_ids, map_rank.reshape(-1)).reshape(r, cr, k)
    gates_send = gather_rows(gates, map_rank.reshape(-1)).reshape(r, cr, k)

    got_tok = _exchange_ranks(send_tok, mesh)
    got_ids = _exchange_ranks(ids_send, mesh)
    got_gates = _exchange_ranks(gates_send, mesh)
    got_valid = _exchange_ranks(map_rank >= 0, mesh)

    my_rank = _my_rank(mesh)
    flat_tok = got_tok.reshape(r * cr, h)
    flat_ids = got_ids.reshape(r * cr, k)
    flat_gates = got_gates.reshape(r * cr, k)
    local_e = flat_ids - my_rank * per_rank
    mine = (local_e >= 0) & (local_e < per_rank)
    exp_bits = torch.where(mine, 1 << local_e.clamp(0, 30), 0).sum(
        dim=-1, dtype=torch.int32)
    ce = max(1, int(round(r * cr * cfg.expert_capacity)))
    exp_tok, map_exp = pack_by_bitmap(flat_tok, exp_bits,
                                      got_valid.reshape(r * cr), per_rank, ce)
    exp_gate = _gate_for_expert(flat_ids, flat_gates, map_exp,
                                my_rank * per_rank, per_rank)
    state = BaselineState(map_rank=map_rank, map_exp=map_exp, n_tokens=n,
                          cfg=cfg, mesh=mesh)
    return exp_tok, exp_gate, state


def baseline_combine(expert_out: torch.Tensor, exp_gate: torch.Tensor,
                     state: BaselineState) -> torch.Tensor:
    """Unicast combine: per-(token, expert-rank) outputs return one by one
    over both axes (pod, then ep; no relay reduction) and are summed at the
    source.  The sum runs over the ep ranks of each pod, then over the
    pods, as :func:`hierarchical_combine` adds them, so the two give
    bit-identical outputs."""
    mesh = state.mesh
    p, d = mesh.num_pods, mesh.ep_per_pod
    r = p * d
    cr = state.map_rank.shape[1]
    flat = _sum_rows_into(state.map_exp, expert_out * exp_gate[..., None],
                          r * cr,
                          min(state.cfg.top_k, state.map_exp.shape[0]))
    home = _exchange_ranks(flat.reshape(r, cr, -1), mesh, back=True)
    out = None
    for pod in range(p):
        rows = slice(pod * d, (pod + 1) * d)
        part = _sum_rows_into(state.map_rank[rows], home[rows],
                              state.n_tokens, d)
        out = part if out is None else out + part
    return out


# ===========================================================================
# Analytic pod-axis byte accounting
# ===========================================================================

def dispatch_pod_bytes(expert_ids, cfg: DispatchConfig, mesh: EPMesh,
                       h: int, elem_bytes: int = 2):
    """(baseline_bytes, multiwrite_bytes) crossing the pod axis per rank,
    the Table-1 quantity at pod scale.  expert_ids: [N, K] (numpy or a
    tensor), from a rank of pod 0."""
    ids = np.asarray(expert_ids.cpu() if isinstance(expert_ids, torch.Tensor)
                     else expert_ids)
    per_rank = cfg.num_experts // mesh.num_ranks
    rank = ids // per_rank
    pod = rank // mesh.ep_per_pod
    # ranks/pods distinct per token, restricted to REMOTE pods
    base = mw = 0
    for row_rank, row_pod in zip(rank, pod):
        remote = row_pod != 0
        base += len(set(row_rank[remote]))
        mw += len(set(row_pod[remote]))
    return base * h * elem_bytes, mw * h * elem_bytes
