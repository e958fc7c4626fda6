"""Executable collective-communication schedules (paper §3.1, §3.2, §5.2).

A *schedule* is a function that drives a :class:`MultiWriteSimulator` to
perform one collective operation over a :class:`Topology`, producing

- the delivered buffers (for correctness assertions), and
- the per-link byte ledger (for the latency model).

Every schedule is exposed twice:

  * the low-level driver function below (the packet-level oracle the
    correctness tests exercise directly), and
  * a registered :class:`~repro_torch.core.plan.CollectivePlan` (bottom of
    this module) with declared knob grids and a
    ``simulate(scenario, payload_bytes) -> Ledger`` method — the unit
    the :class:`~repro_torch.core.planner.Planner` sweeps and scores.  Adding
    a scheme in a later PR is one driver + one ``register_plan`` call.

Schedules implemented (one per paper scheme):

AllGather on a full-mesh split into TP domains (§3.1 / §5.2):
  * :func:`allgather_baseline`            — intra-domain unicast only
  * :func:`allgather_unicast_multipath`   — paired relaying, unicast (3 copies
                                            cross the pair link)
  * :func:`allgather_multiwrite`          — paired relaying, MultiWrite (ONE
                                            copy crosses the pair link; the
                                            relay replicates)
  * :func:`allgather_full_multipath`      — full multi-path relaying in both
                                            unicast and multiwrite modes

AlltoAll dispatch on the oversubscribed cluster fabrics (§3.2 / §6.3):
  * :func:`dispatch_unicast`              — one unicast write per
                                            (token, destination NPU): k_remote
                                            redundant copies cross the rail
  * :func:`dispatch_multiwrite`           — one MultiWrite per token: a single
                                            copy per remote server (and rail
                                            stripe) crosses, replication at
                                            the rail relay (§3.2)

AlltoAll combine — the return path, planned as a first-class op:
  * :func:`combine_unicast`               — every expert partial returns
                                            individually (redundant dual)
  * :func:`combine_multiwrite`            — relay-side partial reduction:
                                            ONE reduced partial per (token,
                                            remote server, rail stripe)
                                            crosses back — the mirror of
                                            dispatch_multiwrite

Every AllGather schedule takes a ``split`` — the fraction of each fragment
sent over direct intra-domain links (paper §5.2 step (1): "split ratio is
dynamically calculated based on the measured bandwidth of both link types").
:func:`optimal_split` computes the ratio that equalizes path completion
times, which is what "arrives simultaneously to minimize overall latency"
requires.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Sequence

import numpy as np

from . import plan as plan_ir
from .multiwrite import MultiWriteSimulator
from .topology import Topology

# Buffer naming convention: AllGather output slot for source ``i`` is
# ``ag/<i>``; segment suffixes ``/d`` (direct part) and ``/x`` (cross part)
# keep the two data segments distinct (§5.2 step (1) splits them).


def _split_payload(data: np.ndarray, split: float) -> tuple[np.ndarray, np.ndarray]:
    """Split a 1-D byte payload into (direct, cross) segments."""
    n = data.shape[0]
    cut = int(round(n * split))
    return data[:cut], data[cut:]


def partner_of(node: int, domains: Sequence[Sequence[int]]) -> int:
    """Paired-relaying partner (§3.1): same index in the other domain."""
    (da, db) = domains
    if node in da:
        return db[list(da).index(node)]
    return da[list(db).index(node)]


def domain_of(node: int, domains: Sequence[Sequence[int]]) -> list[int]:
    for d in domains:
        if node in d:
            return list(d)
    raise ValueError(f"node {node} in no domain")


# ---------------------------------------------------------------------------
# AllGather schedules (§3.1, §5.2)
# ---------------------------------------------------------------------------

def allgather_baseline(sim: MultiWriteSimulator,
                       domains: Sequence[Sequence[int]],
                       payloads: Sequence[np.ndarray]) -> None:
    """Traditional AllGather: three concurrent unicast writes per node over
    direct intra-domain links (paper §5.2 baseline workflow, step (2))."""
    for dom in domains:
        for src in dom:
            for dst in dom:
                if dst == src:
                    continue
                sim.write(src, dst, f"ag/{src}", payloads[src], step=0)
            sim.memory[src][f"ag/{src}"] = np.array(payloads[src])  # local


def allgather_unicast_multipath(sim: MultiWriteSimulator,
                                domains: Sequence[Sequence[int]],
                                payloads: Sequence[np.ndarray],
                                split: float = 0.75) -> None:
    """Paired-relay multipath with *unicast* cross transfers (§3.1).

    Each node sends the direct segment on its intra-domain links and issues
    one unicast write PER PEER routed through its partner: three identical
    copies of the cross segment traverse the node->partner link.
    """
    for dom in domains:
        for src in dom:
            direct, cross = _split_payload(payloads[src], split)
            peers = [d for d in dom if d != src]
            for dst in peers:
                sim.write(src, dst, f"ag/{src}/d", direct, step=0)
            partner = partner_of(src, domains)
            # unicast: one write per destination; every copy crosses the
            # src->partner link, then the partner forwards (store&forward).
            for dst in peers:
                sim.write(src, partner, f"relay/{src}/{dst}", cross, step=0)
                sim.write(partner, dst, f"ag/{src}/x", cross, step=0)
                # store-and-forward processing at the relay (rx + tx), kept
                # in the same ledger the MultiWrite recursion feeds:
                sim.relay_bytes[partner] += 2 * int(cross.nbytes)
            sim.memory[src][f"ag/{src}/d"] = np.array(direct)
            sim.memory[src][f"ag/{src}/x"] = np.array(cross)


def allgather_multiwrite(sim: MultiWriteSimulator,
                         domains: Sequence[Sequence[int]],
                         payloads: Sequence[np.ndarray],
                         split: float = 0.5) -> None:
    """Paired-relay multipath with a single cross-TP MultiWrite (§5.2).

    Workflow (paper §5.2 optimized): (1) split each fragment by ``split``;
    (2) three standard unicast writes intra-domain plus ONE MultiWrite whose
    destination set is the three peers, first hop forced through the partner
    (the relay), which replicates — one copy on the bottleneck link.
    """
    for dom in domains:
        for src in dom:
            direct, cross = _split_payload(payloads[src], split)
            peers = [d for d in dom if d != src]
            for dst in peers:
                sim.write(src, dst, f"ag/{src}/d", direct, step=0)
            partner = partner_of(src, domains)
            sim.multiwrite(src, {dst: f"ag/{src}/x" for dst in peers},
                           cross, step=0, relay=partner)
            sim.memory[src][f"ag/{src}/d"] = np.array(direct)
            sim.memory[src][f"ag/{src}/x"] = np.array(cross)


def allgather_full_multipath(sim: MultiWriteSimulator,
                             domains: Sequence[Sequence[int]],
                             payloads: Sequence[np.ndarray],
                             split: float,
                             multicast: bool) -> None:
    """Full multi-path relaying (§3.1): every node in the opposite domain
    relays an equal slice of the cross segment.

    unicast mode:   one write per (relay, destination) — three copies of each
                    slice cross the src->relay link.
    multicast mode: one MultiWrite per relay — one copy per slice crosses.
    """
    for dom in domains:
        other = [d for d in domains if list(d) != list(dom)][0]
        for src in dom:
            direct, cross = _split_payload(payloads[src], split)
            peers = [d for d in dom if d != src]
            for dst in peers:
                sim.write(src, dst, f"ag/{src}/d", direct, step=0)
            # slice the cross segment over all opposite-domain relays
            slices = np.array_split(cross, len(other))
            for ri, relay in enumerate(other):
                sl = slices[ri]
                if sl.size == 0:
                    continue
                if multicast:
                    sim.multiwrite(src, {dst: f"ag/{src}/x{ri}" for dst in peers},
                                   sl, step=0, relay=relay)
                else:
                    for dst in peers:
                        sim.write(src, relay, f"relay/{src}/{dst}/{ri}", sl, step=0)
                        sim.write(relay, dst, f"ag/{src}/x{ri}", sl, step=0)
                        sim.relay_bytes[relay] += 2 * int(sl.nbytes)
            sim.memory[src][f"ag/{src}/d"] = np.array(direct)
            for ri in range(len(other)):
                sl = slices[ri]
                if sl.size:
                    sim.memory[src][f"ag/{src}/x{ri}"] = np.array(sl)


def check_allgather(sim: MultiWriteSimulator,
                    domains: Sequence[Sequence[int]],
                    payloads: Sequence[np.ndarray]) -> None:
    """Assert every node holds every domain-peer's full fragment."""
    for dom in domains:
        for node in dom:
            for src in dom:
                got = [v for k, v in sorted(sim.memory[node].items())
                       if k.startswith(f"ag/{src}")]
                assert got, f"node {node} missing fragment {src}"
                np.testing.assert_array_equal(np.concatenate(got), payloads[src])


# ---------------------------------------------------------------------------
# AlltoAll dispatch schedules (§3.2, §6.3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DispatchRouting:
    """MoE dispatch routing decisions for one batch.

    token_owner[t]   source NPU of token t
    token_dests[t]   sorted list of destination NPUs (expert owners) — the
                     per-token destination SET the bitmap metadata encodes.
    """
    token_owner: np.ndarray          # [T] int
    token_dests: list[list[int]]     # [T][<=k]


def make_routing(num_tokens_per_npu: int, num_npus: int, num_experts: int,
                 top_k: int, seed: int,
                 experts_per_npu: int | None = None,
                 skew: float = 0.0) -> DispatchRouting:
    """Random top-k routing, experts round-robin across NPUs.

    ``skew == 0`` is balanced (paper §6.1: 'expert load balancing is
    enabled').  ``skew > 0`` draws each token's experts from a Zipf-like
    popularity law p_e ∝ (e+1)^-skew — hot experts concentrate traffic on
    their owning NPUs (and rails), the imbalanced-MoE regime the planner
    prices through the scenario's ``skew`` knob."""
    if experts_per_npu is None:
        experts_per_npu = num_experts // num_npus
    assert experts_per_npu * num_npus == num_experts
    rng = np.random.default_rng(seed)
    owners = np.repeat(np.arange(num_npus), num_tokens_per_npu)
    probs = None
    if skew > 0.0:
        w = (np.arange(num_experts) + 1.0) ** -float(skew)
        probs = w / w.sum()
    dests: list[list[int]] = []
    for _ in owners:
        experts = rng.choice(num_experts, size=top_k, replace=False, p=probs)
        npus = sorted(set(int(e) // experts_per_npu for e in experts))
        dests.append(npus)
    return DispatchRouting(owners, dests)


def dispatch_unicast(sim: MultiWriteSimulator, routing: DispatchRouting,
                     token_bytes: int) -> None:
    """Baseline dispatch: one unicast write per (token, destination NPU).

    Under the rail-first forwarding table of :func:`two_server_cluster`,
    each remote-server copy crosses the source's rail link — k_remote
    redundant copies of the same token on the bottleneck (§3.2, Table 1
    'w/ redundant').
    """
    for t, (src, dests) in enumerate(zip(routing.token_owner, routing.token_dests)):
        payload = _token_payload(t, token_bytes)
        for dst in dests:
            if dst == int(src):
                sim.memory[dst][f"tok/{t}"] = payload
            else:
                sim.write(int(src), dst, f"tok/{t}", payload, step=0)


def dispatch_multiwrite(sim: MultiWriteSimulator, routing: DispatchRouting,
                        token_bytes: int) -> None:
    """MultiWrite dispatch (§3.2): ONE MultiWrite per token.

    ``partition_by_next_hop`` over the rail-first table groups all
    destinations on a remote server under the same-index relay, so exactly
    one copy crosses the rail; the relay replicates intra-server.
    """
    for t, (src, dests) in enumerate(zip(routing.token_owner, routing.token_dests)):
        payload = _token_payload(t, token_bytes)
        sim.multiwrite(int(src), {d: f"tok/{t}" for d in dests}, payload, step=0)


def _token_payload(token_id: int, token_bytes: int) -> np.ndarray:
    rng = np.random.default_rng(token_id + 1)
    return rng.integers(0, 256, size=token_bytes, dtype=np.uint8)


# ---------------------------------------------------------------------------
# AlltoAll combine schedules (the return path — dual of dispatch)
# ---------------------------------------------------------------------------

def combine_unicast(sim: MultiWriteSimulator, routing: DispatchRouting,
                    token_bytes: int) -> None:
    """Baseline combine: every expert NPU returns its weighted partial to
    the token owner individually — one rail crossing per (token, remote
    holder), the redundant-return dual of :func:`dispatch_unicast`.

    Unlike unicast dispatch (whose k copies all leave on the SOURCE's
    rail), unicast-combine crossings leave on each *holder's* rail, so
    the redundancy is spread across rails — which is exactly why the
    combine crossover sits at a different payload than dispatch and must
    be planned independently.
    """
    for t, (src, dests) in enumerate(zip(routing.token_owner,
                                         routing.token_dests)):
        src = int(src)
        payload = _token_payload(t, token_bytes)
        for d in dests:
            if d == src:
                sim.memory[src][f"par/{t}/{d}"] = payload
            else:
                sim.write(d, src, f"par/{t}/{d}", payload, step=0)


def combine_multiwrite(sim: MultiWriteSimulator, routing: DispatchRouting,
                       token_bytes: int) -> None:
    """Relay-reduced combine (mirror of :func:`dispatch_multiwrite`).

    Per (token, dispatch relay group): the holders forward their partials
    intra-server to the rail relay the dispatch replicated from; the
    relay REDUCES them (AICPU software data plane, like the dispatch
    relay's replication) and sends ONE reduced partial back across the
    rail.  The relay groups come from ``partition_by_next_hop`` on the
    OWNER's forwarding table — the same lookup the dispatch MultiWrite
    performs, so the two directions stripe identically by construction.
    Under a symmetric fabric the resulting link ledger is the exact
    reverse of the dispatch-multiwrite ledger.
    """
    topo = sim.topo
    for t, (src, dests) in enumerate(zip(routing.token_owner,
                                         routing.token_dests)):
        src = int(src)
        payload = _token_payload(t, token_bytes)
        nbytes = int(payload.nbytes)
        local = [d for d in dests if topo.server_of(d) == topo.server_of(src)]
        remote = [d for d in dests if topo.server_of(d) != topo.server_of(src)]
        for d in local:
            if d == src:
                sim.memory[src][f"par/{t}/{d}"] = payload
            else:
                sim.write(d, src, f"par/{t}/{d}", payload, step=0)
        for relay, ds in sorted(topo.partition_by_next_hop(src,
                                                           remote).items()):
            for d in ds:
                if d != relay:
                    sim.write(d, relay, f"red/{t}/{relay}/{d}", payload,
                              step=0)
                sim.relay_bytes[relay] += nbytes     # reduce: rx processing
            sim.relay_tx_bytes[relay] += nbytes      # reduced-partial egress
            sim.write(relay, src, f"par/{t}/{relay}", payload, step=0)


def check_combine(sim: MultiWriteSimulator, routing: DispatchRouting,
                  token_bytes: int) -> None:
    """Every owner received at least one partial per remote server holding
    its token, and one per local holder, all bit-exact."""
    topo = sim.topo
    for t, (src, dests) in enumerate(zip(routing.token_owner,
                                         routing.token_dests)):
        src = int(src)
        expect = _token_payload(t, token_bytes)
        got = [v for k, v in sim.memory[src].items()
               if k.startswith(f"par/{t}/")]
        servers = {topo.server_of(d) for d in dests}
        assert len(got) >= len(servers), (t, len(got), servers)
        for v in got:
            np.testing.assert_array_equal(v, expect)


def check_dispatch(sim: MultiWriteSimulator, routing: DispatchRouting,
                   token_bytes: int) -> None:
    """Every destination received exactly its tokens, bit-exact, once."""
    for t, dests in enumerate(routing.token_dests):
        expect = _token_payload(t, token_bytes)
        for d in dests:
            np.testing.assert_array_equal(sim.memory[d][f"tok/{t}"], expect)
            assert sim.delivery_count[(d, f"tok/{t}")] <= 1 or \
                int(routing.token_owner[t]) == d
    # no token delivered anywhere it was not routed
    for (node, buf), cnt in sim.delivery_count.items():
        if buf.startswith("tok/"):
            t = int(buf.split("/")[1])
            assert node in routing.token_dests[t], \
                f"token {t} spuriously delivered to {node}"


# ---------------------------------------------------------------------------
# Optimal split ratios (paper §5.2 step (1))
# ---------------------------------------------------------------------------

def optimal_split(scheme: str, num_relays: int = 1) -> float:
    """Fraction of the fragment to send on the direct path so both paths
    finish simultaneously (per-link serialization, uniform link bw ``w``).

    Derivations (§3.1, fragment size s, TP=4 so 3 peers):

    baseline              direct only                          -> 1.0
    unicast paired        direct r*s/w  == cross 3(1-r)s/w     -> r = 3/4
    multiwrite paired     direct r*s/w  == cross (1-r)s/w      -> r = 1/2
    unicast full          cross link carries 3p + 3p' = 6(1-r)s/4
                          (3 copies up per relay slice, 3 relayed-in slices)
                          r = 6(1-r)/4                         -> r = 3/5
    multiwrite full       cross link carries p + 3p' = 4(1-r)s/4
                          r = (1-r)                            -> r = 1/2

    Schemes registered by later PRs without an entry here fall back to
    their plan's declared knob seed (head of the split grid).
    """
    table = {
        "baseline": 1.0,
        "unicast_paired": 0.75,
        "multiwrite_paired": 0.5,
        "unicast_full": 0.6,
        "multiwrite_full": 0.5,
    }
    if scheme in table:
        return table[scheme]
    plan = plan_ir.PLAN_REGISTRY.get(("allgather", scheme))
    if plan is not None and "split" in plan.knobs:
        return plan.knobs["split"][0]
    raise KeyError(scheme)


# ---------------------------------------------------------------------------
# Plan registration: every scheme becomes a CollectivePlan in the registry
# ---------------------------------------------------------------------------

_AG_DRIVERS: dict[str, Callable] = {
    # scheme -> driver(sim, domains, payloads, split)
    "baseline": lambda sim, dom, pay, split: allgather_baseline(
        sim, dom, pay),
    "unicast_paired": allgather_unicast_multipath,
    "multiwrite_paired": allgather_multiwrite,
    "unicast_full": lambda sim, dom, pay, split: allgather_full_multipath(
        sim, dom, pay, split, multicast=False),
    "multiwrite_full": lambda sim, dom, pay, split: allgather_full_multipath(
        sim, dom, pay, split, multicast=True),
}


def register_allgather_driver(scheme: str, driver: Callable) -> None:
    """Legacy-driver hook for schemes registered by later PRs: makes the
    scheme callable through ALLGATHER_SCHEMES / run_allgather_scheme in
    addition to the plan registry."""
    _AG_DRIVERS[scheme] = driver


def run_allgather_scheme(scheme: str, sim: MultiWriteSimulator,
                         domains: Sequence[Sequence[int]],
                         payloads: Sequence[np.ndarray],
                         split: float | None = None) -> None:
    """Drive one AllGather scheme at its (or an explicit) split ratio."""
    if scheme not in _AG_DRIVERS:
        plan_ir.get_plan("allgather", scheme)   # raise if truly unknown
        raise KeyError(
            f"scheme {scheme!r} is registered as a plan but has no "
            f"simulator driver; add one via register_allgather_driver()")
    if split is None:
        split = optimal_split(scheme)
    _AG_DRIVERS[scheme](sim, domains, payloads, split)


def _split_grid(scheme: str, steps=(0.0, -0.125, 0.125, -0.25, 0.25)
                ) -> tuple[float, ...]:
    """Knob grid seeded on the §5.2 analytic optimum (seed listed first;
    1.0 excluded for relayed schemes — that degenerates to baseline)."""
    seed = optimal_split(scheme)
    grid = []
    for d in steps:
        v = round(min(0.96875, max(0.125, seed + d)), 5)
        if v not in grid:
            grid.append(v)
    return tuple(grid)


def _simulate_allgather(scheme: str):
    def simulate(scenario: plan_ir.AllGatherScenario, payload_bytes: float,
                 *, split: float) -> plan_ir.Ledger:
        probe = plan_ir.PROBE_FRAG_BYTES
        sim = MultiWriteSimulator(scenario.topo)
        payloads = [np.arange(probe, dtype=np.uint8) % 251
                    for _ in range(scenario.topo.num_nodes)]
        _AG_DRIVERS[scheme](sim, [list(d) for d in scenario.domains],
                            payloads, split)
        ledger = plan_ir.Ledger.from_sim(sim)
        return ledger.scaled(plan_ir.probe_scale(payload_bytes, probe))
    return simulate


def _ag_kwargs(mode):
    def kwargs_fn(*, split: float) -> dict:
        # what collectives.multiwrite_allgather / allgather_reference take
        return {"mode": mode, "split": (1.0 if mode is None else split)}
    return kwargs_fn


for _scheme, _mode, _exec in [
        ("baseline", None, True),
        ("unicast_paired", None, False),     # no shard_map lowering: paper
        ("multiwrite_paired", "paired", True),
        ("unicast_full", None, False),       # comparison schemes only
        ("multiwrite_full", "full", True),
]:
    plan_ir.register_plan(plan_ir.CollectivePlan(
        name=_scheme, op="allgather",
        knobs=({"split": (1.0,)} if _scheme == "baseline"
               else {"split": _split_grid(_scheme)}),
        simulate_fn=_simulate_allgather(_scheme),
        kwargs_fn=_ag_kwargs(_mode),
        executable=_exec))


@functools.lru_cache(maxsize=128)
def _moe_base_ledger(topo, num_experts: int, top_k: int, seed: int,
                     skew: float, probe_batch: int, op: str,
                     multiwrite: bool) -> plan_ir.Ledger:
    """Unscaled single-chunk ledger of one dispatch/combine probe run —
    cached so the microbatch knob sweep (which only re-labels stages and
    re-scales bytes) never re-runs the packet simulator.  Keyed on the
    fields the simulation actually reads (NOT the whole scenario:
    ``compute_s`` varies per batch and would fragment the cache across
    operating points that share one probe run).  Topologies hash by
    identity."""
    n_npus = topo.num_nodes
    if num_experts % n_npus:
        per_npu = max(1, num_experts // n_npus)
        num_experts = per_npu * n_npus
        top_k = min(top_k, num_experts)
    sim = MultiWriteSimulator(topo)
    routing = make_routing(probe_batch, n_npus, num_experts, top_k,
                           seed=seed, skew=skew)
    if op == "dispatch":
        fn = dispatch_multiwrite if multiwrite else dispatch_unicast
    else:
        fn = combine_multiwrite if multiwrite else combine_unicast
    fn(sim, routing, plan_ir.PROBE_TOKEN_BYTES)
    from .latency_model import RELAY_SETUP_S
    ledger = plan_ir.Ledger.from_sim(
        sim, alpha_extra_s=RELAY_SETUP_S if multiwrite else 0.0)
    if multiwrite:
        # the relay forwards (dispatch: replicates; combine: reduces) in
        # SOFTWARE (§6.4 AICPU data plane): its egress copies serialize
        # through one engine — the term that makes Fig 8's small-batch
        # unicast preference emerge (cf. dispatch_e2e_time's relay_fwd)
        ledger = dataclasses.replace(
            ledger, engine_serial=dict(sim.relay_tx_bytes))
    return ledger


def _simulate_moe(op: str, multiwrite: bool):
    def simulate(scenario, payload_bytes: float,
                 *, microbatch: int = 1) -> plan_ir.Ledger:
        batch = max(1, int(round(payload_bytes / scenario.token_bytes)))
        probe_batch = min(batch, plan_ir.PROBE_BATCH)
        ledger = _moe_base_ledger(scenario.topo, scenario.num_experts,
                                  scenario.top_k, scenario.seed,
                                  scenario.skew, probe_batch, op,
                                  multiwrite)
        probe_bytes = probe_batch * plan_ir.PROBE_TOKEN_BYTES
        ledger = ledger.scaled(
            plan_ir.probe_scale(batch * scenario.token_bytes, probe_bytes))
        g = max(1, int(microbatch))
        # G > 1 is the double-buffered moe_ffn pipeline (overlap=True):
        # scoring pays max(stage) + (G-1)*bottleneck derated by
        # hw.overlap_eff instead of the serial G*sum.  compute_s is the
        # scenario's expert-FFN stage the chunks hide behind (charged to
        # G == 1 too, so the comparison is apples-to-apples).
        return dataclasses.replace(
            ledger, stages=g, overlap=g > 1,
            compute_s=float(getattr(scenario, "compute_s", 0.0)))
    return simulate


def _simulate_dispatch(multiwrite: bool):
    return _simulate_moe("dispatch", multiwrite)


def _dispatch_kwargs(scheme: str):
    def kwargs_fn(*, microbatch: int = 1) -> dict:
        # what models/moe.moe_ffn consumes (pctx-level knobs)
        return {"moe_scheme": scheme, "microbatch": int(microbatch)}
    return kwargs_fn


# The microbatch grid (G = pipeline chunks, mapping onto
# pctx.moe_microbatch).  The latency model's pipelined scoring mode
# (score_ledger on overlap=True ledgers) lets G > 1 genuinely win when
# the scenario carries an overlap context (compute_s > 0): chunked
# dispatch hides behind the previous chunk's expert FFN.  Without
# overlap context the per-chunk alpha keeps G == 1 optimal — the grid
# head — so scenario-free sweeps behave exactly as before.  Powers of
# two only: moe_ffn clamps the chosen G to a divisor of the local token
# count via gcd, and pow-2 G always divides pow-2 batches.
MICROBATCH_GRID = (1, 2, 4, 8)

plan_ir.register_plan(plan_ir.CollectivePlan(
    name="unicast", op="dispatch",
    knobs={"microbatch": MICROBATCH_GRID},
    simulate_fn=_simulate_dispatch(multiwrite=False),
    kwargs_fn=_dispatch_kwargs("baseline")))
plan_ir.register_plan(plan_ir.CollectivePlan(
    name="multiwrite", op="dispatch",
    knobs={"microbatch": MICROBATCH_GRID},
    simulate_fn=_simulate_dispatch(multiwrite=True),
    kwargs_fn=_dispatch_kwargs("hierarchical")))


def _simulate_combine(multiwrite: bool):
    return _simulate_moe("combine", multiwrite)


def _combine_kwargs(scheme: str):
    def kwargs_fn(*, microbatch: int = 1) -> dict:
        # what models/moe.moe_ffn consumes (return-path lowering selector)
        return {"moe_combine": scheme, "microbatch": int(microbatch)}
    return kwargs_fn


def _simulate_linkprobe(scenario, payload_bytes: float) -> plan_ir.Ledger:
    """Ledger of the directed p2p microbenchmark: the payload on every
    link from ``src_server`` to ``dst_server`` at once (and nothing
    else), so the record's bottleneck ROLE is exactly that direction and
    the telemetry fitter regresses its bandwidth even though no real
    collective ever bottlenecks there."""
    topo = scenario.topo
    links = [k for k in topo.links
             if topo.server_of(k[0]) == scenario.src_server
             and topo.server_of(k[1]) == scenario.dst_server]
    if not links:
        raise ValueError(
            f"no links {scenario.src_server}->{scenario.dst_server} "
            f"in {topo.name}")
    return plan_ir.Ledger(
        topo=topo,
        link_bytes={k: float(payload_bytes) for k in links},
        relay_bytes={}, flow_counts={k: 1 for k in links})


plan_ir.register_plan(plan_ir.CollectivePlan(
    name="p2p", op="linkprobe", knobs={},
    simulate_fn=_simulate_linkprobe,
    kwargs_fn=lambda **kw: {}))


plan_ir.register_plan(plan_ir.CollectivePlan(
    name="unicast", op="combine",
    knobs={"microbatch": MICROBATCH_GRID},
    simulate_fn=_simulate_combine(multiwrite=False),
    kwargs_fn=_combine_kwargs("baseline")))
plan_ir.register_plan(plan_ir.CollectivePlan(
    name="multiwrite", op="combine",
    knobs={"microbatch": MICROBATCH_GRID},
    simulate_fn=_simulate_combine(multiwrite=True),
    kwargs_fn=_combine_kwargs("hierarchical")))


# ---------------------------------------------------------------------------
# Gradient-sync schedules: AllReduce / ReduceScatter as planner ops
# ---------------------------------------------------------------------------
#
# Unlike the MoE ops (whose routing is data-dependent, so their ledgers
# come from the packet simulator), reduce collectives are fully regular:
# every node holds the same payload and the schedule is a fixed
# communication pattern.  The ledgers below are therefore built
# ANALYTICALLY — closed-form per-link byte loads charged onto the real
# fabric links (via ``topo.path`` so missing direct links store-and-
# forward exactly like the packet oracle would) — which keeps the
# planner sweep free of per-payload simulation.  Byte loads and step
# counts follow the classic scheme family (ring, recursive-doubling
# tree, hierarchical RS->exchange->AG; cf. "Network-Offloaded
# Bandwidth-Optimal Broadcast and Allgather" / "In-Network Collective
# Operations", PAPERS.md), plus a multiwrite variant that reuses the
# combine-wire reduce-direction accounting (relay-side reduction, one
# copy per rail, software-engine egress serialization).

# Per-ring/tree-step launch cost beyond the generic per-stage alpha_base
# (one step is covered by alpha_base itself; the rest land here).  A
# fraction of alpha_base: steps within one fused collective don't re-pay
# the full operator launch, just the per-round synchronization.
REDUCE_STEP_ALPHA_S = 5e-6


def _reduce_step_alpha(steps: int) -> float:
    return max(0, int(steps) - 1) * REDUCE_STEP_ALPHA_S


def _charge_path(topo: Topology, link_bytes: dict, flow_counts: dict,
                 relay_bytes: dict, src: int, dst: int,
                 nbytes: float) -> None:
    """Charge ``nbytes`` from src to dst along the fabric's forwarding
    path; intermediate hops pay store-and-forward relay processing."""
    path = topo.path(src, dst)
    for a, b in zip(path, path[1:]):
        link_bytes[(a, b)] = link_bytes.get((a, b), 0.0) + nbytes
        flow_counts[(a, b)] = flow_counts.get((a, b), 0) + 1
    for mid in path[1:-1]:
        relay_bytes[mid] = relay_bytes.get(mid, 0.0) + 2.0 * nbytes


def _ring_order(topo: Topology) -> list[int]:
    """Serpentine node order: ascend even servers, descend odd ones, so
    every intra hop is a full-mesh link and every server boundary is
    crossed at a matching NPU index (a direct rail link)."""
    meta = topo.meta
    order: list[int] = []
    for s in range(meta.num_servers):
        idx = (range(meta.npus_per_server) if s % 2 == 0
               else range(meta.npus_per_server - 1, -1, -1))
        order.extend(s * meta.npus_per_server + i for i in idx)
    return order


def reduce_ring_ledger(topo: Topology, nbytes: float,
                       phases: int = 2) -> plan_ir.Ledger:
    """Flat bandwidth-optimal ring: ``phases == 2`` is AllReduce
    (reduce-scatter pass + allgather pass), ``phases == 1`` is
    ReduceScatter alone.  Every directed ring edge carries
    ``phases * (R-1)/R * N``; the whole load crosses every server
    boundary — which is exactly why the flat ring (what an unannotated
    GSPMD psum lowers to) is the scheme to beat on multi-server
    fabrics."""
    R = topo.num_nodes
    if R < 2:
        return plan_ir.Ledger(topo=topo, link_bytes={}, relay_bytes={},
                              flow_counts={})
    per_edge = float(phases) * nbytes * (R - 1) / R
    order = _ring_order(topo)
    link_bytes: dict = {}
    flows: dict = {}
    relay: dict = {}
    for u, v in zip(order, order[1:] + order[:1]):
        _charge_path(topo, link_bytes, flows, relay, u, v, per_edge)
    return plan_ir.Ledger(
        topo=topo, link_bytes=link_bytes, relay_bytes=relay,
        flow_counts=flows, relayed=bool(relay),
        alpha_extra_s=_reduce_step_alpha(phases * (R - 1)))


def reduce_tree_depth(topo: Topology) -> int:
    """Rounds of the dimension-ordered recursive-doubling tree:
    ``ceil(log2 P)`` intra rounds then ``ceil(log2 S)`` inter rounds
    (non-power-of-two counts round up — stragglers fold in)."""
    meta = topo.meta
    intra = (int(math.ceil(math.log2(meta.npus_per_server)))
             if meta.npus_per_server > 1 else 0)
    inter = (int(math.ceil(math.log2(meta.num_servers)))
             if meta.num_servers > 1 else 0)
    return intra + inter


def reduce_tree_ledger(topo: Topology, nbytes: float) -> plan_ir.Ledger:
    """Recursive-doubling butterfly tree: every round each node
    exchanges the FULL payload with its XOR partner and reduces —
    log-depth, so it is the latency-optimal endpoint of the scheme
    family (the bandwidth-optimal halving/doubling variant coincides
    with ``hierarchical``'s byte accounting on these fabrics).  Rounds
    serialize through each node's NIC, so the cumulative per-class load
    (``intra_rounds * N`` intra, ``inter_rounds * N`` on the rails) is
    charged onto one representative link per class."""
    meta = topo.meta
    S, P = meta.num_servers, meta.npus_per_server
    intra_rounds = int(math.ceil(math.log2(P))) if P > 1 else 0
    inter_rounds = int(math.ceil(math.log2(S))) if S > 1 else 0
    link_bytes: dict = {}
    flows: dict = {}
    relay: dict = {}
    for s in range(S):
        for i in range(P):
            u = s * P + i
            if intra_rounds:
                v = s * P + (i + 1) % P
                _charge_path(topo, link_bytes, flows, relay, u, v,
                             intra_rounds * nbytes)
            if inter_rounds:
                v = ((s + 1) % S) * P + i
                _charge_path(topo, link_bytes, flows, relay, u, v,
                             inter_rounds * nbytes)
    return plan_ir.Ledger(
        topo=topo, link_bytes=link_bytes, relay_bytes=relay,
        flow_counts=flows, relayed=bool(relay),
        alpha_extra_s=_reduce_step_alpha(reduce_tree_depth(topo)))


def reduce_hierarchical_ledger(topo: Topology, nbytes: float,
                               phases: int = 2) -> plan_ir.Ledger:
    """Hierarchical reduce: intra-server ring ReduceScatter, inter-server
    ring exchange of the 1/P shard over same-index rail peers, then
    (``phases == 2``) intra-server ring AllGather.  Rail links carry only
    ``2 (S-1)/S * N/P`` — the P-fold cross-server saving over the flat
    ring.  Degrades to the intra ring alone on single-server fabrics."""
    meta = topo.meta
    S, P = meta.num_servers, meta.npus_per_server
    link_bytes: dict = {}
    flows: dict = {}
    relay: dict = {}
    steps = 0
    shard = nbytes / P if P > 1 else nbytes
    if P > 1:
        per_edge = float(phases) * nbytes * (P - 1) / P
        for s in range(S):
            order = [s * P + i for i in range(P)]
            for u, v in zip(order, order[1:] + order[:1]):
                _charge_path(topo, link_bytes, flows, relay, u, v, per_edge)
        steps += phases * (P - 1)
    if S > 1:
        per_edge = 2.0 * shard * (S - 1) / S
        for i in range(P):
            order = [s * P + i for s in range(S)]
            for u, v in zip(order, order[1:] + order[:1]):
                _charge_path(topo, link_bytes, flows, relay, u, v, per_edge)
        steps += 2 * (S - 1)
    return plan_ir.Ledger(
        topo=topo, link_bytes=link_bytes, relay_bytes=relay,
        flow_counts=flows, relayed=bool(relay),
        alpha_extra_s=_reduce_step_alpha(steps))


def reduce_multiwrite_ledger(topo: Topology, nbytes: float,
                             scatter_only: bool = False) -> plan_ir.Ledger:
    """MultiWrite reduce: the combine-wire reduce-direction accounting
    applied to gradient sync.  The payload is sliced 1/P by NPU index;
    slice ``i``'s peers funnel it intra-server to relay ``i``, the relay
    REDUCES (AICPU software data plane, like combine_multiwrite) and
    exchanges ONE reduced copy per rail with its same-index peers, then
    replicates the global slice back intra-server (AllReduce) or
    scatters the 1/R sub-slices (ReduceScatter).  Relay rx processing
    lands in ``relay_bytes``; relay egress serializes through one
    forwarding engine (``engine_serial``), and the schedule pays the
    Fig 8 relay-pipeline establishment cost."""
    from .latency_model import RELAY_SETUP_S
    meta = topo.meta
    S, P = meta.num_servers, meta.npus_per_server
    R = topo.num_nodes
    slice_b = nbytes / P
    link_bytes: dict = {}
    flows: dict = {}
    relay: dict = {}
    engine: dict = {}

    def charge(u, v, b):
        _charge_path(topo, link_bytes, flows, relay, u, v, b)

    for s in range(S):
        for i in range(P):
            r = s * P + i                      # relay owning slice i
            for j in range(P):                 # intra funnel j -> relay
                if j != i:
                    charge(s * P + j, r, slice_b)
            relay[r] = relay.get(r, 0.0) + (P - 1) * slice_b
            if S > 1:                          # rail exchange, one copy each
                for s2 in range(S):
                    if s2 != s:
                        charge(r, s2 * P + i, slice_b)
                relay[r] += (S - 1) * slice_b
            egress = (S - 1) * slice_b
            if scatter_only:                   # scatter 1/R sub-slices back
                for j in range(P):
                    if j != i:
                        charge(r, s * P + j, nbytes / R)
                egress += (P - 1) * nbytes / R
            else:                              # replicate global slice back
                for j in range(P):
                    if j != i:
                        charge(r, s * P + j, slice_b)
                egress += (P - 1) * slice_b
            engine[r] = engine.get(r, 0.0) + egress
    return plan_ir.Ledger(
        topo=topo, link_bytes=link_bytes, relay_bytes=relay,
        flow_counts=flows, relayed=True, alpha_extra_s=RELAY_SETUP_S,
        engine_serial=engine)


def reduce_scatter_a2a_ledger(topo: Topology, nbytes: float
                              ) -> plan_ir.Ledger:
    """Direct AlltoAll ReduceScatter: every node sends each peer its
    1/R shard in one step (latency-optimal; redundant-free by
    construction).  Cross-server transfers to non-matching indices
    store-and-forward through the rail-first table, and the per-link
    flow fan-in drives the interference derate."""
    R = topo.num_nodes
    link_bytes: dict = {}
    flows: dict = {}
    relay: dict = {}
    shard = nbytes / R
    for u in range(R):
        for v in range(R):
            if u != v:
                _charge_path(topo, link_bytes, flows, relay, u, v, shard)
    return plan_ir.Ledger(
        topo=topo, link_bytes=link_bytes, relay_bytes=relay,
        flow_counts=flows, relayed=bool(relay))


_REDUCE_LEDGERS: dict[tuple[str, str], Callable] = {
    # (op, scheme) -> builder(topo, nbytes)
    ("allreduce", "ring"):
        lambda topo, n: reduce_ring_ledger(topo, n, phases=2),
    ("allreduce", "tree"): reduce_tree_ledger,
    ("allreduce", "hierarchical"):
        lambda topo, n: reduce_hierarchical_ledger(topo, n, phases=2),
    ("allreduce", "multiwrite"):
        lambda topo, n: reduce_multiwrite_ledger(topo, n),
    ("allreduce", "compressed"):
        # int8 error-feedback ring (compression.compressed_psum): wire
        # bytes quartered, same step structure.  Lossy — registered for
        # comparison sweeps, never auto-bound (executable=False).
        lambda topo, n: reduce_ring_ledger(topo, n / 4.0, phases=2),
    ("reduce_scatter", "ring"):
        lambda topo, n: reduce_ring_ledger(topo, n, phases=1),
    ("reduce_scatter", "a2a"): reduce_scatter_a2a_ledger,
    ("reduce_scatter", "multiwrite"):
        lambda topo, n: reduce_multiwrite_ledger(topo, n,
                                                 scatter_only=True),
}


def _simulate_reduce(op: str, scheme: str):
    builder = _REDUCE_LEDGERS[(op, scheme)]

    def simulate(scenario, payload_bytes: float,
                 *, microbatch: int = 1) -> plan_ir.Ledger:
        ledger = builder(scenario.topo, float(payload_bytes))
        g = max(1, int(microbatch))
        # G > 1 chunks the gradient into G buckets synced back-to-front
        # as the backward pass produces them (overlap=True): the
        # pipelined scoring mode hides earlier chunks' wire time behind
        # the scenario's remaining backward compute, exactly like the
        # MoE dispatch pipeline.
        return dataclasses.replace(
            ledger, stages=g, overlap=g > 1,
            compute_s=float(getattr(scenario, "compute_s", 0.0)))
    return simulate


def _reduce_kwargs(scheme: str):
    def kwargs_fn(*, microbatch: int = 1) -> dict:
        # what collectives.planned_psum consumes
        return {"reduce_scheme": scheme, "microbatch": int(microbatch)}
    return kwargs_fn


for _op, _scheme, _exec in [
        ("allreduce", "ring", True),          # lax.psum's own lowering
        ("allreduce", "tree", True),          # ppermute butterfly
        ("allreduce", "hierarchical", True),  # hierarchical_psum
        ("allreduce", "multiwrite", True),    # hierarchical_psum lowering
        ("allreduce", "compressed", False),   # lossy: explicit opt-in only
        ("reduce_scatter", "ring", True),     # lax.psum_scatter
        ("reduce_scatter", "a2a", True),      # lax.psum_scatter tiled
        ("reduce_scatter", "multiwrite", False),   # accounting-only
]:
    plan_ir.register_plan(plan_ir.CollectivePlan(
        name=_scheme, op=_op,
        knobs={"microbatch": MICROBATCH_GRID},
        simulate_fn=_simulate_reduce(_op, _scheme),
        kwargs_fn=_reduce_kwargs(_scheme),
        executable=_exec))


class _SchemeView(dict):
    """Back-compat view: ALLGATHER_SCHEMES[name](sim, domains, payloads)
    runs the registered plan's driver at its analytic-seed split."""

    def __missing__(self, key):
        plan_ir.get_plan("allgather", key)   # raises with a useful message
        return lambda sim, dom, pay: run_allgather_scheme(key, sim, dom, pay)


ALLGATHER_SCHEMES: dict[str, Callable] = _SchemeView()
for _scheme in _AG_DRIVERS:
    ALLGATHER_SCHEMES[_scheme] = (
        lambda sim, dom, pay, _s=_scheme: run_allgather_scheme(
            _s, sim, dom, pay))
