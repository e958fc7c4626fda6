"""α–β bottleneck-link latency model (paper §3, §6).

The model maps a schedule's per-link byte ledger (from
:class:`~repro_torch.core.multiwrite.MultiWriteSimulator`) — or closed-form byte
counts — to end-to-end operator latency:

    t = alpha_base                         (operator startup, API->first byte)
      + max_link (bytes_link / bw_link)    (per-link serialization; concurrent
                                            links overlap — the *bottleneck
                                            link* sets the pace, paper §3.3)
      + [alpha_hop]                        (pipeline-fill cost of one relay
                                            stage, if the schedule relays)
      + max_node (relay_bytes / copy_bw)   (relay-side replication processing:
                                            the paper's AICPU packet
                                            copy/forward cost, §6.4)

Two regimes:

- ``ideal=True``  — zero overheads.  This is the paper's §3.1 derivation
  regime and the model reproduces it EXACTLY:
      baseline s/w | unicast-paired 3s/4w | multiwrite-paired s/2w
      unicast-full 3s/5w | multiwrite-full s/2w
  giving the claimed 50% (mw vs baseline), 33% (mw vs unicast-paired) and
  16.7% (mw vs unicast-full) latency reductions.

- calibrated — finite overheads fitted once against the paper's reported
  endpoints (Fig 6: ~30% at 16 MB; Fig 7: crossover ≈ 2 MB; Table 1), then
  used *predictively* everywhere else.  Calibration constants:

      alpha_base = 20 us   operator launch (warm) — HCCL-class startup
      alpha_hop  = 12 us   relay stage fill: bitmap parse + WQE re-post
      copy_bw    = 800 GB/s relay-node buffer copy (HBM-class memcpy)
      token      = 7168 B  dispatch payload/token (DeepSeek-V3 hidden 7168,
                           fp8 dispatch — the post-V3 regime the paper cites)
      rail_bw    = 25 GB/s 200 Gbps RoCE NIC (§6.1)
      hccs_bw    = 56 GB/s (§6.1)

Checks against the paper (see tests/test_paper_claims.py and
benchmarks/paper_figures.py):

  Fig 6 (16 MB):   model −30.0% vs baseline (paper ≈30%); −22.6% vs unicast
                   multipath (paper 17% — same ordering, within the run
                   variance the paper itself reports for unicast multipath).
  Fig 7:           crossover at ≈1.9 MB (paper: "around 2 MB").
  Table 1:         per-point agreement within ≈12% (w/ redundant) and ≈8%
                   (w/o redundant) across batch 64→2k.
  Fig 8:           qualitative shape reproduced: mw worse at batch 64,
                   ~parity at 128, gains at 1k/2k growing with batch.
"""

from __future__ import annotations

import dataclasses
import math

from .multiwrite import MultiWriteSimulator
from .plan import Ledger
from .topology import HCCS_LINK_BW, ROCE_LINK_BW


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Calibrated overhead constants (seconds / bytes-per-second)."""

    alpha_base: float = 20e-6     # operator startup
    alpha_hop: float = 12e-6      # relay-stage pipeline fill
    copy_bw: float = 800e9        # relay buffer copy bandwidth
    flow_interference: float = 1.0  # <1 derates a link shared by >=3
    # distinct concurrent unicast flows (paper: unicast multipath "more
    # susceptible to mutual interference"); 1.0 = mean behaviour.
    overlap_eff: float = 0.75     # fraction of the theoretical chunk-
    # pipeline overlap actually achieved (1 = perfect dispatch/compute/
    # combine overlap, 0 = chunks serialize).  Seeded conservatively;
    # telemetry fits it from Planner.decision_log measured rows
    # (repro_torch.telemetry.fit.fit_overlap_eff) like the link bandwidths.
    link_bw: tuple = ()           # MEASURED per-link bandwidth overrides
    # (((src, dst), bytes/s), ...) from recalibrated(); scoring prefers a
    # measured value over the topology's nominal one.  Stored as a sorted
    # tuple so the model stays hashable (it keys the planner's LRU cache).

    def ideal(self) -> "HardwareModel":
        return HardwareModel(alpha_base=0.0, alpha_hop=0.0,
                             copy_bw=math.inf, flow_interference=1.0,
                             overlap_eff=1.0)

    def recalibrated(self, measurements, topo=None) -> "HardwareModel":
        """Fold measured numbers back into the model (ROADMAP: online
        re-calibration).  ``measurements`` is a mapping — typically a
        parsed benchmark JSON — with any of the scalar constants
        (``alpha_base``, ``alpha_hop``, ``copy_bw``,
        ``flow_interference``) and/or ``"links"``: measured per-link
        bandwidths keyed by ``(src, dst)`` tuples or ``"src->dst"``
        strings.  Pass ``topo`` to reject measurements for links the
        fabric doesn't have (typo'd keys would otherwise be stored but
        never match a ledger — a silent no-op).  Returns a NEW model;
        since the model is part of the planner cache key, recalibrating
        invalidates stale decisions automatically."""
        measurements = dict(measurements)
        scalars = {k: float(measurements[k])
                   for k in ("alpha_base", "alpha_hop", "copy_bw",
                             "flow_interference", "overlap_eff")
                   if k in measurements}
        links = dict(self.link_bw)
        for key, bw in dict(measurements.get("links", {})).items():
            if isinstance(key, str):
                a, b = key.split("->")
                key = (int(a), int(b))
            key = tuple(key)
            if topo is not None and not topo.has_link(*key):
                raise KeyError(f"measured link {key} not in {topo.name}")
            links[key] = float(bw)
        return dataclasses.replace(
            self, link_bw=tuple(sorted(links.items())), **scalars)

    def measured_link_bw(self) -> dict:
        """The per-link overrides as a plain dict."""
        return dict(self.link_bw)

    def fingerprint(self) -> tuple:
        """Hashable identity of the calibration state.  The planner keys
        its LRU cache on this (not on the object), so an in-place
        ``planner.hw`` swap after :meth:`recalibrated` can never serve a
        decision scored under the old constants — and two value-equal
        models share cache entries."""
        return ("hw", self.alpha_base, self.alpha_hop, self.copy_bw,
                self.flow_interference, self.overlap_eff, self.link_bw)


IDEAL = HardwareModel(alpha_base=0.0, alpha_hop=0.0, copy_bw=math.inf,
                      overlap_eff=1.0)
DEFAULT = HardwareModel()


# ---------------------------------------------------------------------------
# Ledger-driven latency (works for ANY plan / schedule run on the simulator)
# ---------------------------------------------------------------------------

def ledger_wire_s(ledger: Ledger, hw: HardwareModel = DEFAULT) -> float:
    """Full-payload serialization time of one ledger: the bottleneck-link
    transfer plus relay-copy and software-forwarding-engine terms — no
    startup alphas, no compute stage (those are charged separately so the
    shared-pipeline scorer can combine several ledgers without
    double-counting)."""
    if not ledger.link_bytes:
        return 0.0
    measured = dict(hw.link_bw) if hw.link_bw else None
    link_time = 0.0
    for key, nbytes in ledger.link_bytes.items():
        bw = ledger.topo.link(*key).bw
        if measured is not None:
            bw = measured.get(key, bw)
        if ledger.flow_counts.get(key, 0) >= 3:
            bw *= hw.flow_interference
        link_time = max(link_time, nbytes / bw)
    relay_time = 0.0
    if ledger.relay_bytes:
        relay_time = max(ledger.relay_bytes.values()) / hw.copy_bw
    engine_time = 0.0
    for node, nbytes in ledger.engine_serial.items():
        # software forwarding engine (§6.4 AICPU): per-copy egress
        # serializes at the node's fastest egress link
        bw = max((ln.bw for ln in ledger.topo.links.values()
                  if ln.src == node), default=math.inf)
        engine_time = max(engine_time, nbytes / bw)
    return link_time + relay_time + engine_time


def ledger_fixed_s(ledger: Ledger, hw: HardwareModel = DEFAULT) -> float:
    """Payload-independent overheads of one ledger: per-chunk operator
    startup (``alpha_base * G``), schedule-specific setup and the relay
    pipeline-fill alpha."""
    g = max(1, ledger.stages)
    return (hw.alpha_base * g + ledger.alpha_extra_s
            + (hw.alpha_hop if ledger.relayed else 0.0))


def score_ledger(ledger: Ledger, hw: HardwareModel = DEFAULT) -> float:
    """End-to-end latency of any plan's :class:`~repro_torch.core.plan.Ledger`.

    This is THE scoring function of the planner: every registered
    CollectivePlan's simulated ledger runs through the same alpha-beta
    bottleneck model, so plan choice is an emergent property of the
    calibration (Fig 7's ~2 MB crossover falls out of ``alpha_hop`` and
    ``copy_bw`` — nothing scheme-specific is hard-coded here).

    Chunked ledgers (``stages == G > 1``) score in one of two modes:

    * serial (``overlap=False``) — the pre-pipeline chunk loop: G
      startup alphas plus the full wire+compute time, so G > 1 can only
      lose (memory, not latency, was the reason to microbatch).
    * pipelined (``overlap=True``) — dispatch of chunk k+1 overlaps the
      compute of chunk k (``ledger.compute_s``) and the combine of
      chunk k-1: the ideal G-chunk pipeline pays
      ``sum(stage)/G + (G-1) * max(stage)/G`` instead of the serial
      sum, derated by the calibrated ``hw.overlap_eff``.  The per-chunk
      ``alpha_base`` penalty grows linearly in G while the overlap win
      saturates, which is what makes SMALL G optimal.
    """
    if not ledger.link_bytes:
        return 0.0
    wire = ledger_wire_s(ledger, hw)
    g = max(1, ledger.stages)
    fixed = ledger_fixed_s(ledger, hw)
    compute = max(0.0, ledger.compute_s)
    serial = fixed + wire + compute
    if g <= 1 or not ledger.overlap:
        return serial
    eta = min(1.0, max(0.0, hw.overlap_eff))
    w, c = wire / g, compute / g
    pipelined = fixed + w + c + (g - 1) * max(w, c)
    return (1.0 - eta) * serial + eta * pipelined


def score_pipeline(ledgers, hw: HardwareModel = DEFAULT) -> float:
    """Combined latency of COUPLED collectives sharing one chunk pipeline
    (the moe_ffn dispatch -> expert FFN -> combine scan).

    Scoring each half alone and summing would double-count the compute
    stage and — worse — let each half pick its own microbatch G even
    though the executed pipeline chunks everything at ONE G.  This
    scorer is the shared-pipeline ledger of the joint sweep: every
    ledger's wire time is a pipeline stage, the (shared) compute stage
    is charged once, per-chunk alphas accumulate across ALL coupled
    collectives (G chunks now pay dispatch + combine startup each), and
    the pipelined bound pays ``sum(stage)/G + (G-1) * max(stage)/G``
    over the full stage set, derated by ``hw.overlap_eff`` exactly like
    :func:`score_ledger`.  All ledgers must agree on ``stages``; a
    single-ledger call reduces to :func:`score_ledger`.
    """
    ledgers = [l for l in ledgers if l.link_bytes]
    if not ledgers:
        return 0.0
    gs = {max(1, l.stages) for l in ledgers}
    if len(gs) != 1:
        raise ValueError(f"coupled ledgers disagree on chunk count: {gs}")
    g = gs.pop()
    wires = [ledger_wire_s(l, hw) for l in ledgers]
    fixed = sum(ledger_fixed_s(l, hw) for l in ledgers)
    # the compute stage BETWEEN the coupled collectives is one shared
    # quantity carried redundantly by each scenario — charge it once
    compute = max([0.0] + [l.compute_s for l in ledgers])
    serial = fixed + sum(wires) + compute
    if g <= 1 or not all(l.overlap for l in ledgers):
        return serial
    eta = min(1.0, max(0.0, hw.overlap_eff))
    per_chunk = [w / g for w in wires] + [compute / g]
    pipelined = fixed + sum(per_chunk) + (g - 1) * max(per_chunk)
    return (1.0 - eta) * serial + eta * pipelined


# ---------------------------------------------------------------------------
# Phase-level contention: the multi-commodity-flow view of one program phase
# ---------------------------------------------------------------------------
#
# Sites declared concurrent within one program phase (the MoE round trip
# and the grad-sync AllReduce of a training step; the collectives of one
# serving phase) put their bytes on the SAME physical links.  Scoring each
# site on its private ledger treats every rail as dedicated — two plans
# that each look fastest alone can saturate one shared rail together.
# The flow formulation ("Rethinking ML Collective Communication as a
# Multi-Commodity Flow Problem"): per-link demand SUMS across concurrent
# flows, and the phase pays the bottleneck of the summed demand.

def merge_ledgers(ledgers) -> tuple[Ledger, ...]:
    """Phase ledger(s): per-link bytes, flow counts, relay bytes and
    forwarding-engine bytes SUMMED across ``ledgers`` — the joint demand
    of sites concurrent in one phase.  Ledgers merge per fabric (one
    merged ledger per distinct topology fingerprint): sites on disjoint
    fabrics (the split-TP gather's model-axis mesh vs the EP cluster)
    share no physical link, so their demands never add.  The merged
    ledgers are pure demand accounting (``stages=1``, no overlap/compute
    context) — score them with :func:`ledger_wire_s`, not
    :func:`score_ledger`."""
    acc: dict[tuple, list] = {}
    order: list[tuple] = []
    for led in ledgers:
        if not led.link_bytes:
            continue
        fp = led.topo.fingerprint()
        if fp not in acc:
            acc[fp] = [led.topo, {}, {}, {}, {}]
            order.append(fp)
        _, lb, rb, fc, es = acc[fp]
        for k, v in led.link_bytes.items():
            lb[k] = lb.get(k, 0.0) + v
        for k, v in led.relay_bytes.items():
            rb[k] = rb.get(k, 0.0) + v
        for k, v in led.flow_counts.items():
            fc[k] = fc.get(k, 0) + v
        for k, v in led.engine_serial.items():
            es[k] = es.get(k, 0.0) + v
    return tuple(
        Ledger(topo=acc[fp][0], link_bytes=acc[fp][1],
               relay_bytes=acc[fp][2], flow_counts=acc[fp][3],
               engine_serial=acc[fp][4])
        for fp in order)


def phase_wire_s(ledgers, hw: HardwareModel = DEFAULT) -> float:
    """Shared-link serialization floor of concurrently executing
    ledgers: the bottleneck over the per-fabric MERGED demand
    (:func:`merge_ledgers`).  Disjoint fabrics proceed in parallel — the
    slowest sets the pace."""
    return max((ledger_wire_s(m, hw) for m in merge_ledgers(ledgers)),
               default=0.0)


def score_phase(entries, hw: HardwareModel = DEFAULT,
                background=()) -> float:
    """Contention-aware latency of one program phase.

    ``entries``: one ``(score_s, ledgers)`` pair per jointly-planned
    group executing concurrently in the phase — ``score_s`` the group's
    own (contention-free) combined score, ``ledgers`` its site ledgers.
    ``background``: extra ledgers whose bytes contend for the phase's
    links without contributing a latency term of their own (another
    phase's traffic under a continuous-batching SLO check).

    The model: concurrent groups overlap, so the phase pays its SLOWEST
    group — plus the EXCESS serialization of the shared rails.  The
    summed-demand bottleneck (:func:`phase_wire_s` over all ledgers) is
    compared against the largest single group's own wire floor; any
    excess is contention no overlap can hide and is charged on top:

        t_phase = max_g score_g + max(0, wire(sum of demands)
                                         - max_g wire(demands_g))

    With disjoint links the merged bottleneck equals the largest own
    bottleneck and the penalty vanishes — the phase scores exactly like
    independent planning.  Shared links make the penalty positive, and a
    scheme that routes around the shared rail can win jointly even when
    it loses on its private ledger.  Background demand only counts on
    fabrics the phase's OWN ledgers touch: traffic on a disjoint fabric
    shares no link with this phase and cannot slow it."""
    solo, contention = _phase_terms(entries, hw, background)[:2]
    return solo + contention


def phase_breakdown(entries, hw: HardwareModel = DEFAULT,
                    background=()) -> dict:
    """Reporting view of :func:`score_phase`: the solo (slowest-group)
    term, the merged shared-link wire floor and the contention excess,
    plus the final phase score."""
    solo, contention, merged = _phase_terms(entries, hw, background)
    return {"score_s": solo + contention, "solo_s": solo,
            "phase_wire_s": merged, "contention_s": contention}


def _phase_terms(entries, hw, background):
    """(solo_s, contention_s, merged_wire_s) of one phase."""
    entries = list(entries)
    solo = max((s for s, _ in entries), default=0.0)
    own_ledgers = [l for _, ls in entries for l in ls]
    own = max((phase_wire_s(ls, hw) for _, ls in entries), default=0.0)
    own_fps = {l.topo.fingerprint() for l in own_ledgers if l.link_bytes}
    merged = phase_wire_s(
        own_ledgers + [l for l in background
                       if l.topo.fingerprint() in own_fps], hw)
    return solo, max(0.0, merged - own), merged


def pipeline_overlap_endpoints(ledgers, hw: HardwareModel = DEFAULT
                               ) -> tuple[float, float]:
    """(serial_s, ideal_s) endpoints of a coupled pipeline's overlap
    interpolation (:func:`overlap_endpoints` generalized to the shared
    pipeline of :func:`score_pipeline`)."""
    serial = score_pipeline(
        ledgers, dataclasses.replace(hw, overlap_eff=0.0))
    ideal_ = score_pipeline(
        ledgers, dataclasses.replace(hw, overlap_eff=1.0))
    return serial, ideal_


def overlap_endpoints(ledger: Ledger,
                      hw: HardwareModel = DEFAULT) -> tuple[float, float]:
    """(serial_s, ideal_s) endpoints of a ledger's overlap interpolation:
    the score at ``overlap_eff`` 0 and 1.  ``measured`` times landing
    between them identify the achieved efficiency — the quantity
    ``repro_torch.telemetry.fit.fit_overlap_eff`` regresses from
    ``Planner.decision_log`` rows (equal endpoints carry no signal)."""
    serial = score_ledger(ledger, dataclasses.replace(hw, overlap_eff=0.0))
    ideal_ = score_ledger(ledger, dataclasses.replace(hw, overlap_eff=1.0))
    return serial, ideal_


def expert_compute_time_s(tokens_per_rank: int, top_k: int, d_model: int,
                          d_ff_shard: int,
                          peak_flops: float = None) -> float:
    """Modeled per-rank expert-FFN time for one MoE layer — the compute
    stage a pipelined dispatch/combine hides network chunks behind.

    Balanced routing sends ``tokens_per_rank * top_k`` (token, expert)
    pairs through each rank's experts; the gated FFN is three matmuls
    (w1, w3, w2) of ``2 * d_model * d_ff_shard`` FLOPs each, where
    ``d_ff_shard`` is the TP-local expert hidden width."""
    from .topology import TPU_PEAK_FLOPS
    if peak_flops is None:
        peak_flops = TPU_PEAK_FLOPS
    flops = tokens_per_rank * top_k * 3 * 2 * d_model * d_ff_shard
    return float(flops) / float(peak_flops)


def moe_overlap_compute_s(tokens_per_rank: int, top_k: int, d_model: int,
                          d_ff: int, tp: int = 1) -> float:
    """:func:`expert_compute_time_s` from the GLOBAL expert hidden width
    and the TP degree — the ONE derivation of the overlap context every
    surface shares (moe_ffn at trace time, train/serve reports, dryrun
    cells), so the shard math and its zero-guards cannot diverge."""
    return expert_compute_time_s(tokens_per_rank, top_k, d_model,
                                 max(1, d_ff // max(1, tp)))


def backward_compute_s(num_params: int, tokens_per_rank: int,
                       tp: int = 1, peak_flops: float = None) -> float:
    """Modeled per-rank backward-pass time — the compute stage a chunked
    gradient sync hides behind (gradient buckets become ready
    back-to-front as backprop proceeds, so chunk k's wire time overlaps
    the backward compute of the layers before it).

    Dense-transformer backward is ~2x the forward's ``2 * params *
    tokens`` matmul FLOPs; TP shards the parameter matmuls ``tp``
    ways."""
    from .topology import TPU_PEAK_FLOPS
    if peak_flops is None:
        peak_flops = TPU_PEAK_FLOPS
    flops = 4.0 * float(num_params) * float(tokens_per_rank)
    return flops / (float(peak_flops) * max(1, tp))


def ledger_latency(sim: MultiWriteSimulator | Ledger,
                   hw: HardwareModel = DEFAULT) -> float:
    """Latency of a simulator run (or a pre-built Ledger)."""
    if isinstance(sim, Ledger):
        return score_ledger(sim, hw)
    return score_ledger(Ledger.from_sim(sim), hw)


# ---------------------------------------------------------------------------
# Closed forms: AllGather on the split-TP full mesh (§3.1)
# ---------------------------------------------------------------------------

ALLGATHER_LINK_LOAD = {
    # scheme -> (bottleneck-link bytes as fraction of fragment s,
    #            relay rx+tx bytes as fraction of s,  uses relay stage)
    "baseline":          (1.0, 0.0, False),
    "unicast_paired":    (0.75, 1.5, True),   # 3 copies of (1-r)s, r=3/4
    "multiwrite_paired": (0.5, 2.0, True),    # 1 copy of (1-r)s,  r=1/2
    "unicast_full":      (0.6, 2.4, True),    # 6(1-r)s/4 on cross, r=3/5;
    #                     relay rx+tx: 2*3*(1-r)/4 per source * 4 sources
    "multiwrite_full":   (0.5, 2.0, True),    # 4(1-r)s/4 on cross, r=1/2
}


def allgather_latency(scheme: str, frag_bytes: float,
                      link_bw: float = HCCS_LINK_BW,
                      hw: HardwareModel = DEFAULT) -> float:
    """Closed-form AllGather latency for a TP=4 domain pair on the 8-node
    full mesh.  ``ideal`` regime (hw=IDEAL) reproduces §3.1 exactly."""
    load, relay, relayed = ALLGATHER_LINK_LOAD[scheme]
    t = hw.alpha_base + load * frag_bytes / link_bw
    if relayed:
        t += hw.alpha_hop
        if not math.isinf(hw.copy_bw):
            t += relay * frag_bytes / hw.copy_bw
    return t


def allgather_crossover_bytes(link_bw: float = HCCS_LINK_BW,
                              hw: HardwareModel = DEFAULT) -> float:
    """Message size where multiwrite_paired == baseline (Fig 7 crossover).

    alpha_hop + 2s/copy_bw + s/(2w) = s/w  =>  s* = alpha_hop / (1/(2w) - 2/copy_bw)
    """
    denom = 1.0 / (2 * link_bw) - 2.0 / hw.copy_bw
    if denom <= 0:
        return math.inf
    return hw.alpha_hop / denom


# ---------------------------------------------------------------------------
# Closed forms: MoE AlltoAll dispatch on the 2-server cluster (§3.2, §6.3)
# ---------------------------------------------------------------------------

TOKEN_BYTES = 7168            # DeepSeek-V3 hidden size, fp8 dispatch payload
DISPATCH_ALPHA_UNICAST = 40e-6   # fitted once to Table 1 'w/ redundant'
DISPATCH_ALPHA_MW = 25e-6        # fitted once to Table 1 'w/o redundant'
RELAY_SETUP_S = 55e-6         # relay pipeline establishment (fitted to the
#                               Fig 8 parity point at decode batch 128);
#                               also charged to the multiwrite dispatch
#                               plan's ledger so the planner reproduces
#                               Fig 8's small-batch unicast preference.


def expected_remote_copies(num_experts: int = 64, top_k: int = 8,
                           num_servers: int = 2, npus_per_server: int = 8,
                           dedup_per_npu: bool = False) -> float:
    """Expected number of rail crossings per token under balanced routing.

    Token-by-token unicast (the mode the paper says multicast competes
    with) crosses once per remote *expert*: top_k * (S-1)/S in expectation.
    With per-destination-NPU aggregation it crosses once per distinct
    remote NPU.  MultiWrite crosses once per remote *server* that holds at
    least one selected expert.
    """
    remote_frac = (num_servers - 1) / num_servers
    if not dedup_per_npu:
        return top_k * remote_frac
    # distinct remote NPUs: 1 - C(E - e_npu, k)/C(E, k) per remote NPU
    e_npu = num_experts // (num_servers * npus_per_server)
    p_hit = 1.0 - (math.comb(num_experts - e_npu, top_k)
                   / math.comb(num_experts, top_k))
    return (num_servers - 1) * npus_per_server * p_hit


def expected_remote_servers(num_experts: int = 64, top_k: int = 8,
                            num_servers: int = 2,
                            npus_per_server: int = 8) -> float:
    e_srv = num_experts // num_servers
    p_hit = 1.0 - (math.comb(num_experts - e_srv, top_k)
                   / math.comb(num_experts, top_k))
    return (num_servers - 1) * p_hit


def dispatch_cross_server_time(batch: int, redundant: bool,
                               token_bytes: int = TOKEN_BYTES,
                               rail_bw: float = ROCE_LINK_BW) -> float:
    """Table 1 model: cross-server (rail) transfer time for `batch` tokens
    per NPU. 'w/ redundant' = unicast token-by-token (one crossing per
    remote expert); 'w/o redundant' = MultiWrite (one crossing per remote
    server holding a selected expert)."""
    if redundant:
        copies = expected_remote_copies()
        alpha = DISPATCH_ALPHA_UNICAST
    else:
        copies = expected_remote_servers()
        alpha = DISPATCH_ALPHA_MW
    return alpha + batch * copies * token_bytes / rail_bw


def dispatch_e2e_time(batch: int, scheme: str,
                      token_bytes: int = TOKEN_BYTES,
                      rail_bw: float = ROCE_LINK_BW,
                      hccs_bw: float = HCCS_LINK_BW,
                      hw: HardwareModel = DEFAULT) -> float:
    """Fig 8 model: end-to-end dispatch latency.

    unicast:    alpha_u + rail serialization of redundant copies
    multiwrite: alpha_u + alpha_relay_setup + single-copy rail time
                + relay replication processing (copies through the relay's
                buffer at copy_bw) + relay egress forwarding on HCCS.

    Reproduces the Fig 8 pattern: relay costs dominate the (small) rail
    saving at decode batch 64, parity near 128, growing gains at 1k/2k.
    """
    rail_uni = batch * expected_remote_copies() * token_bytes / rail_bw
    if scheme == "unicast":
        return DISPATCH_ALPHA_UNICAST + rail_uni
    assert scheme == "multiwrite"
    rail_mw = batch * expected_remote_servers() * token_bytes / rail_bw
    deliveries = expected_remote_copies(dedup_per_npu=True)  # fan-out at relay
    relay_copy = batch * deliveries * token_bytes / hw.copy_bw
    # relay forwards each copy over a distinct HCCS link; its egress engine
    # serializes the per-token copies (AICPU data plane, §6.4):
    relay_fwd = batch * deliveries * token_bytes / hccs_bw
    return (DISPATCH_ALPHA_UNICAST + RELAY_SETUP_S + rail_mw
            + relay_copy + relay_fwd)


# ---------------------------------------------------------------------------
# Paper reference numbers (for benchmarks / tests)
# ---------------------------------------------------------------------------

TABLE1_PAPER_US = {
    # batch: (w/ redundant, w/o redundant) microseconds — paper Table 1
    64: (112.90, 43.77),
    128: (210.53, 66.63),
    1024: (1231.18, 320.52),
    2048: (2429.72, 622.10),
}

FIG6_MESSAGE_BYTES = 16 * 2**20          # 16 MB per rank
FIG7_MESSAGE_BYTES = [256 * 2**10, 2**20, 2 * 2**20, 8 * 2**20,
                      16 * 2**20, 64 * 2**20, 200 * 2**20]
FIG8_BATCHES = [64, 128, 1024, 2048]
