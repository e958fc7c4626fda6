"""Topology models for MultiWrite routing and latency analysis.

A :class:`Topology` is a directed multigraph of nodes (accelerators) and
links, each link with a bandwidth (bytes/s).  It provides the *unicast
forwarding table* that MultiWrite reuses (paper §4.1: "we fully reuse the
unicast forwarding table that each node already employs").

Topologies are generated by a parametric **fabric family**:

- :class:`ClusterSpec` — ``num_servers x npus_per_server`` servers with a
  full-mesh intra-server fabric and rail-optimized inter-server links,
  generalized over the paper's fixed 2x8 deployment: ``rails_per_npu``
  parallel rails (striped in the forwarding override), 3+ servers
  (rail-first routing between every server pair), per-rail ``inter_bw``
  and a per-link ``asymmetry`` map.  Every generated topology carries
  structured :class:`ClusterMeta` (server grouping, rail count) instead
  of the old hard-coded ``npus_per_server=8`` free functions.
- :func:`full_mesh`          — paper §3.1 (8-NPU HCCS full mesh).
- :func:`two_server_cluster` — paper §3.2 / §6.1 (2 x 8 rail-optimized);
  now a thin ``ClusterSpec`` wrapper.
- :func:`tpu_pods`           — TPU adaptation (pod ≡ server, DCN ≡ RoCE).

Named fabrics live in the :data:`FABRICS` registry; :func:`get_fabric`
resolves a registered name or parses an inline spec string
(``"4x8"``, ``"2x8r2"``, ``"2x8r2@25,12.5:56"`` — see
:func:`parse_fabric`).  The planner fingerprints topologies, so every
registered fabric is automatically a planner scenario.

All bandwidths are bytes/second.  Latency modelling lives in
``latency_model.py``; this module is purely structural.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Iterable, Mapping, Sequence


# ---------------------------------------------------------------------------
# Hardware constants (paper §6.1 + prompt-supplied TPU v5e numbers)
# ---------------------------------------------------------------------------
HCCS_LINK_BW = 56e9          # bytes/s, Huawei Cache Coherence System per link
ROCE_LINK_BW = 200e9 / 8     # 200 Gbps RoCE NIC -> 25 GB/s
TPU_ICI_LINK_BW = 50e9       # bytes/s per ICI link (prompt constant)
TPU_DCN_LINK_BW = 6.25e9     # bytes/s per chip inter-pod (50 Gbps class DCN)
TPU_PEAK_FLOPS = 197e12      # bf16 per chip
TPU_HBM_BW = 819e9           # bytes/s per chip


@dataclasses.dataclass(frozen=True)
class Link:
    """A directed physical link ``src -> dst`` with bandwidth ``bw`` bytes/s."""

    src: int
    dst: int
    bw: float

    @property
    def key(self) -> tuple[int, int]:
        return (self.src, self.dst)


@dataclasses.dataclass(frozen=True)
class FailureState:
    """Declarative fault set composable onto any :class:`Topology`.

    The paper motivates this directly: multicast's management plane is
    fragile, so MultiWrite must degrade gracefully when a rail or relay
    misbehaves.  A FailureState names *what is broken*; the planner and
    router decide what survives:

    - ``dead_links``     — directed ``(src, dst)`` links that carry no
      traffic at all (rail blackout).  Removed from the failed topology.
    - ``degraded_links`` — ``((src, dst), factor)`` pairs; the link stays
      up at ``bw * factor`` (multiplicative, matching
      :class:`ClusterSpec.asymmetry` — ``0.5`` = half bandwidth).
    - ``dead_relays``    — nodes whose software forwarding / multiwrite
      relay engine is down: the node still terminates its own traffic but
      never *transits* packets for others, and any plan whose ledger
      charges its forwarding engine is infeasible.
    - ``lost_npus``      — nodes gone entirely (host down).  They stay in
      the node set (fabric metadata is immutable) but all their links are
      removed; a collective spanning a lost NPU is unplannable and
      surfaces as ``NoFeasiblePlanError``.

    Instances are frozen/hashable and normalization happens in
    ``__post_init__``, so equal fault sets always compare and hash equal
    regardless of input ordering or container type.
    """

    dead_links: frozenset = frozenset()
    degraded_links: tuple = ()
    dead_relays: frozenset = frozenset()
    lost_npus: frozenset = frozenset()

    def __post_init__(self):
        object.__setattr__(self, "dead_links", frozenset(
            (int(a), int(b)) for a, b in self.dead_links))
        deg = self.degraded_links
        if isinstance(deg, Mapping):
            deg = deg.items()
        object.__setattr__(self, "degraded_links", tuple(sorted(
            ((int(a), int(b)), float(f)) for (a, b), f in deg)))
        object.__setattr__(self, "dead_relays",
                           frozenset(int(n) for n in self.dead_relays))
        object.__setattr__(self, "lost_npus",
                           frozenset(int(n) for n in self.lost_npus))
        for (_, _), f in self.degraded_links:
            if not (0.0 < f):
                raise ValueError(f"degraded-link factor must be > 0, got {f} "
                                 "(use dead_links for a fully dark link)")

    def __bool__(self) -> bool:
        return bool(self.dead_links or self.degraded_links
                    or self.dead_relays or self.lost_npus)

    def key(self) -> tuple:
        """Deterministic hashable identity (feeds the topology fingerprint)."""
        return (tuple(sorted(self.dead_links)), self.degraded_links,
                tuple(sorted(self.dead_relays)),
                tuple(sorted(self.lost_npus)))

    def link_is_dead(self, key: tuple[int, int]) -> bool:
        """True when the directed link carries no traffic under this state."""
        src, dst = key
        return (key in self.dead_links or src in self.lost_npus
                or dst in self.lost_npus)

    def relay_is_dead(self, node: int) -> bool:
        """True when ``node`` cannot forward/replicate for other nodes."""
        return node in self.dead_relays or node in self.lost_npus

    def merged(self, other: "FailureState") -> "FailureState":
        """Union of two fault sets (degradation factors multiply on
        links degraded by both)."""
        deg = dict(self.degraded_links)
        for key, f in other.degraded_links:
            deg[key] = deg.get(key, 1.0) * f
        return FailureState(
            dead_links=self.dead_links | other.dead_links,
            degraded_links=deg,
            dead_relays=self.dead_relays | other.dead_relays,
            lost_npus=self.lost_npus | other.lost_npus)


NO_FAILURES = FailureState()


def same_fabric_fingerprint(a: tuple, b: tuple) -> bool:
    """True when two topology fingerprints describe the same physical
    fabric — identical name, node count and server/rail grouping — even
    if one carries a :class:`FailureState` (or recalibrated bandwidths).
    Used by the bind guard so a failover plan for a degraded variant of
    the serving fabric is not rejected as foreign."""
    return a[:2] == b[:2] and a[3:6] == b[3:6]


@dataclasses.dataclass(frozen=True)
class ClusterMeta:
    """Structured grouping metadata carried by every :class:`Topology`.

    ``num_servers * npus_per_server == num_nodes``; nodes are blocked by
    server (node ``n`` lives on server ``n // npus_per_server``).
    ``rails_per_npu == 0`` marks a single-server fabric with no
    inter-server rails (full mesh).
    """

    num_servers: int = 1
    npus_per_server: int = 0
    rails_per_npu: int = 0


class Topology:
    """Directed graph of nodes + links with unicast forwarding tables.

    Forwarding tables are computed by bandwidth-weighted shortest path
    (Dijkstra on 1/bw edge costs, hop count then node id as tie-breaks) and
    may be partially overridden by ``fwd_override`` — the paper's
    "preconfigured mapping rules" (§4.1).  ``next_hop(u, d)`` returns the
    neighbor ``u`` forwards to for destination ``d`` — exactly the lookup
    MultiWrite relays perform.

    ``meta`` carries the fabric-family grouping (server of each node, rail
    count) so schedules never assume a server width.
    """

    def __init__(self, num_nodes: int, links: Iterable[Link],
                 name: str = "topology",
                 fwd_override: Mapping[tuple[int, int], int] | None = None,
                 meta: ClusterMeta | None = None,
                 failures: FailureState | None = None,
                 ) -> None:
        self.name = name
        self.failures = failures if failures is not None else NO_FAILURES
        self.num_nodes = int(num_nodes)
        self.meta = meta or ClusterMeta(num_servers=1,
                                        npus_per_server=self.num_nodes,
                                        rails_per_npu=0)
        if self.meta.num_servers * self.meta.npus_per_server != self.num_nodes:
            raise ValueError(f"meta {self.meta} inconsistent with "
                             f"{self.num_nodes} nodes")
        self.links: dict[tuple[int, int], Link] = {}
        for ln in links:
            if not (0 <= ln.src < num_nodes and 0 <= ln.dst < num_nodes):
                raise ValueError(f"link {ln} out of range for {num_nodes} nodes")
            if ln.src == ln.dst:
                raise ValueError(f"self-link {ln}")
            self.links[ln.key] = ln
        self._adj: dict[int, list[Link]] = {n: [] for n in range(num_nodes)}
        for ln in self.links.values():
            self._adj[ln.src].append(ln)
        self._fwd: dict[int, dict[int, int]] | None = None
        self._override = dict(fwd_override or {})
        for (src, dst), hop in self._override.items():
            if (src, hop) not in self.links:
                raise ValueError(
                    f"fwd_override ({src},{dst})->{hop}: no link {src}->{hop}")
        self._fp: tuple | None = None

    # -- structural queries -------------------------------------------------
    def neighbors(self, node: int) -> list[int]:
        return sorted(ln.dst for ln in self._adj[node])

    def link(self, src: int, dst: int) -> Link:
        return self.links[(src, dst)]

    def has_link(self, src: int, dst: int) -> bool:
        return (src, dst) in self.links

    # -- fabric metadata (replaces the npus_per_server=8 free functions) ----
    def server_of(self, node: int) -> int:
        """Server (pod) holding ``node``, from the fabric metadata."""
        return node // self.meta.npus_per_server

    def same_index_peer(self, node: int, dst_server: int) -> int:
        """Rail-0 (same-index) peer of ``node`` on ``dst_server`` (§3.2)."""
        p = self.meta.npus_per_server
        return dst_server * p + node % p

    def rail_peers(self, node: int, dst_server: int) -> list[int]:
        """All rail peers of ``node`` on ``dst_server`` (multi-rail fabrics
        stripe cross-server traffic over these)."""
        p = self.meta.npus_per_server
        r = max(1, self.meta.rails_per_npu)
        idx = node % p
        return [dst_server * p + (idx + j) % p for j in range(r)]

    def server_nodes(self, server: int) -> list[int]:
        p = self.meta.npus_per_server
        return list(range(server * p, (server + 1) * p))

    def fingerprint(self) -> tuple:
        """Hashable identity: name, shape, fabric meta and the exact
        per-link bandwidth assignment (hashed) — distinguishes asymmetric
        fabrics whose bandwidth *multisets* coincide."""
        if self._fp is None:
            links_h = hash(tuple(sorted(
                (k, ln.bw) for k, ln in self.links.items())))
            fp = (self.name, self.num_nodes, len(self.links),
                  self.meta.num_servers, self.meta.npus_per_server,
                  self.meta.rails_per_npu, links_h)
            if self.failures:
                # only failed topologies grow the extra element, so every
                # healthy fingerprint (and everything keyed on it — planner
                # caches, calibration fabric keys, bound plans) is unchanged
                # and a recovered fabric flips back to its original identity.
                fp = fp + (("failures",) + self.failures.key(),)
            self._fp = fp
        return self._fp

    def with_link_bws(self, measurements: Mapping, name: str | None = None,
                      ) -> "Topology":
        """New topology with measured per-link bandwidths folded in — the
        structural half of online re-calibration (ROADMAP).  Keys are
        ``(src, dst)`` tuples or ``"src->dst"`` strings (benchmark JSON);
        unknown links raise.  The new fingerprint invalidates planner
        cache entries automatically."""
        meas: dict[tuple[int, int], float] = {}
        for key, bw in dict(measurements).items():
            if isinstance(key, str):
                a, b = key.split("->")
                key = (int(a), int(b))
            meas[tuple(key)] = float(bw)
        for key in meas:
            if key not in self.links:
                raise KeyError(f"measured link {key} not in {self.name}")
        links = [dataclasses.replace(ln, bw=meas.get(k, ln.bw))
                 for k, ln in self.links.items()]
        return Topology(self.num_nodes, links,
                        name=name or f"{self.name}_recal",
                        fwd_override=self._override, meta=self.meta,
                        failures=self.failures)

    def with_failures(self, failures: FailureState,
                      name: str | None = None) -> "Topology":
        """The surviving-capacity graph: this topology with ``failures``
        applied (composed onto any failures already present).

        Dead and lost-NPU links are removed, degraded links keep their
        scaled bandwidth, and forwarding overrides that route into a dead
        link or *through* a dead relay fall back to Dijkstra on the
        survivors (the multi-commodity-flow view: routing recomputes from
        remaining capacity, not a fixed schedule).  The node set — and
        hence the fabric metadata — is unchanged, so plans, rails and
        server grouping keep their meaning; the fingerprint grows a
        failure element so every planner/calibration cache keyed on it
        segregates automatically.  An empty failure set returns ``self``
        unchanged, and the name is kept for metric-label continuity.
        """
        merged = self.failures.merged(failures)
        if not merged:
            return self
        # self.links already carry self.failures' scaling, so only the
        # INCREMENTAL factors apply here; `merged` is the identity.
        degraded = dict(failures.degraded_links)
        links = []
        for key, ln in self.links.items():
            if merged.link_is_dead(key):
                continue
            f = degraded.get(key)
            links.append(ln if f is None else
                         dataclasses.replace(ln, bw=ln.bw * f))
        surviving = {ln.key for ln in links}
        override = {}
        for (src, dst), hop in self._override.items():
            if src in merged.lost_npus or dst in merged.lost_npus:
                continue
            if (src, hop) not in surviving:
                continue
            if hop != dst and merged.relay_is_dead(hop):
                continue
            override[(src, dst)] = hop
        return Topology(self.num_nodes, links, name=name or self.name,
                        fwd_override=override, meta=self.meta,
                        failures=merged)

    # -- unicast forwarding table (reused by MultiWrite, §4.1) --------------
    def _build_forwarding(self) -> None:
        fwd: dict[int, dict[int, int]] = {}
        for src in range(self.num_nodes):
            dist: dict[int, tuple[float, int, int]] = {src: (0.0, 0, -1)}
            first_hop: dict[int, int] = {}
            pq: list[tuple[float, int, int, int, int]] = [(0.0, 0, -1, src, -1)]
            seen: set[int] = set()
            while pq:
                d, hops, fh_key, u, fh = heapq.heappop(pq)
                if u in seen:
                    continue
                seen.add(u)
                if u != src:
                    first_hop[u] = fh
                    if self.failures.relay_is_dead(u):
                        # a dead relay engine still terminates its own
                        # traffic but never forwards for others: settle it
                        # as a destination, don't relax through it.
                        continue
                for ln in sorted(self._adj[u], key=lambda l: l.dst):
                    v = ln.dst
                    if v in seen:
                        continue
                    nfh = v if u == src else fh
                    cand = (d + 1.0 / ln.bw, hops + 1, nfh)
                    if v not in dist or cand < dist[v]:
                        dist[v] = cand
                        heapq.heappush(pq, (*cand, v, nfh))
            fwd[src] = first_hop
        self._fwd = fwd

    def next_hop(self, node: int, dest: int) -> int:
        """Unicast forwarding lookup: from ``node``, first hop toward ``dest``."""
        if node == dest:
            raise ValueError("next_hop queried for self")
        ov = self._override.get((node, dest))
        if ov is not None:
            return ov
        if self._fwd is None:
            self._build_forwarding()
        assert self._fwd is not None
        try:
            return self._fwd[node][dest]
        except KeyError as e:
            raise ValueError(f"no route {node} -> {dest} in {self.name}") from e

    def path(self, src: int, dst: int, max_hops: int = 64) -> list[int]:
        """Full unicast path src..dst (inclusive), following next_hop."""
        out = [src]
        cur = src
        for _ in range(max_hops):
            if cur == dst:
                return out
            cur = self.next_hop(cur, dst)
            out.append(cur)
        raise RuntimeError(f"routing loop {src}->{dst} in {self.name}: {out}")

    def partition_by_next_hop(self, node: int,
                              dests: Sequence[int]) -> dict[int, list[int]]:
        """Group a destination set by next hop (paper §4.3.3 rule 3).

        Destinations equal to ``node`` itself are grouped under ``node``
        (local delivery).  The number of distinct keys excluding ``node`` is
        the number of packet copies injected on ``node``'s egress links.
        """
        groups: dict[int, list[int]] = {}
        for d in dests:
            hop = node if d == node else self.next_hop(node, d)
            groups.setdefault(hop, []).append(d)
        return groups


# ---------------------------------------------------------------------------
# The fabric family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Parametric fabric: servers of full-mesh NPUs + rail-optimized
    inter-server links (paper §3.2 generalized).

    ``rails_per_npu = r`` gives every NPU ``r`` parallel rails per remote
    server, landing on peers ``(idx + j) % npus_per_server`` for
    ``j < r``.  The forwarding override *stripes* cross-server traffic:
    destination ``(sb, jd)`` routes via rail ``jd % r`` — so
    ``partition_by_next_hop`` splits a remote server's destination set
    into up to ``r`` groups, one MultiWrite copy per busy rail.
    ``r = 1`` reduces to the paper's same-index rule.

    ``inter_bw`` is a scalar or a per-rail tuple (heterogeneous NICs);
    ``asymmetry`` maps ``(src, dst)`` links to bandwidth *scale factors*
    applied after generation (degraded/asymmetric links, §3.2's "where
    the physical bottleneck sits").
    """

    num_servers: int = 2
    npus_per_server: int = 8
    rails_per_npu: int = 1
    intra_bw: float = HCCS_LINK_BW
    inter_bw: float | tuple[float, ...] = ROCE_LINK_BW
    asymmetry: Mapping[tuple[int, int], float] = dataclasses.field(
        default_factory=dict)
    name: str = ""

    def __post_init__(self):
        if self.num_servers < 1 or self.npus_per_server < 1:
            raise ValueError(f"degenerate cluster {self}")
        r = self.rails_per_npu
        if self.num_servers > 1 and not (1 <= r <= self.npus_per_server):
            raise ValueError(
                f"rails_per_npu={r} must be in [1, {self.npus_per_server}]")

    @property
    def num_nodes(self) -> int:
        return self.num_servers * self.npus_per_server

    def rail_bw(self, rail: int) -> float:
        if isinstance(self.inter_bw, (tuple, list)):
            return float(self.inter_bw[rail % len(self.inter_bw)])
        return float(self.inter_bw)

    def default_name(self) -> str:
        n = f"{self.num_servers}x{self.npus_per_server}"
        if self.rails_per_npu > 1:
            n += f"r{self.rails_per_npu}"
        if self.asymmetry:
            n += "_asym"
        return n

    def build(self) -> Topology:
        """Generate the Topology: full-mesh intra-server links, striped
        rail links between every server pair, rail-first forwarding
        override, asymmetry scales applied last."""
        p, s, r = self.npus_per_server, self.num_servers, self.rails_per_npu
        links: list[Link] = []
        override: dict[tuple[int, int], int] = {}
        for sv in range(s):
            base = sv * p
            for a, b in itertools.permutations(range(p), 2):
                links.append(Link(base + a, base + b, self.intra_bw))
        for sa in range(s):
            for sb in range(s):
                if sa == sb:
                    continue
                for i in range(p):
                    src = sa * p + i
                    for j in range(r):
                        rail = sb * p + (i + j) % p
                        links.append(Link(src, rail, self.rail_bw(j)))
                    for jd in range(p):
                        dst = sb * p + jd
                        override[(src, dst)] = sb * p + (i + jd % max(1, r)) % p
        asym = dict(self.asymmetry)
        if asym:
            links = [dataclasses.replace(ln, bw=ln.bw * asym[ln.key])
                     if ln.key in asym else ln for ln in links]
        return Topology(self.num_nodes, links,
                        name=self.name or self.default_name(),
                        fwd_override=override,
                        meta=ClusterMeta(num_servers=s, npus_per_server=p,
                                         rails_per_npu=r))


def parse_fabric(spec: str) -> ClusterSpec:
    """Parse an inline fabric spec: ``"SxP[rR][@INTER[:INTRA]]"``.

    ``S`` servers x ``P`` NPUs/server, ``R`` rails per NPU (default 1).
    ``INTER`` is the inter-server bandwidth in GB/s — comma-separated for
    per-rail values; ``INTRA`` the intra-server GB/s.  Examples::

        4x8             four servers, eight NPUs each
        2x8r2           two rails per NPU
        2x8@12.5        12.5 GB/s rails
        2x8r2@25,12.5:56  per-rail 25/12.5 GB/s rails, 56 GB/s HCCS
    """
    body, _, bws = spec.partition("@")
    try:
        shape, rsep, rails = body.partition("r")
        if rsep and not rails:
            raise ValueError("empty rail count")
        servers_s, _, npus_s = shape.partition("x")
        kw: dict = {"num_servers": int(servers_s),
                    "npus_per_server": int(npus_s),
                    "rails_per_npu": int(rails) if rails else 1,
                    "name": spec}
        if bws:
            inter_s, _, intra_s = bws.partition(":")
            inter = tuple(float(v) * 1e9 for v in inter_s.split(","))
            kw["inter_bw"] = inter[0] if len(inter) == 1 else inter
            if intra_s:
                kw["intra_bw"] = float(intra_s) * 1e9
        return ClusterSpec(**kw)
    except (ValueError, TypeError) as e:
        raise ValueError(
            f"bad fabric spec {spec!r} (want 'SxP[rR][@INTER[:INTRA]]', "
            f"e.g. '4x8', '2x8r2', '2x8r2@25,12.5:56')") from e


# ---------------------------------------------------------------------------
# Fabric registry: every entry doubles as a planner scenario
# ---------------------------------------------------------------------------

FABRICS: dict[str, Callable[[], Topology]] = {}


def register_fabric(name: str, builder: Callable[[], Topology]) -> None:
    FABRICS[name] = builder


def fabric_names() -> list[str]:
    return sorted(FABRICS)


def get_fabric(spec: str) -> Topology:
    """Resolve a registered fabric name, else parse an inline spec."""
    builder = FABRICS.get(spec)
    if builder is not None:
        return builder()
    return parse_fabric(spec).build()


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def full_mesh(num_nodes: int = 8, link_bw: float = HCCS_LINK_BW,
              name: str = "full_mesh") -> Topology:
    """Paper §3.1: every node pair has a dedicated bidirectional link."""
    links = [Link(a, b, link_bw)
             for a, b in itertools.permutations(range(num_nodes), 2)]
    return Topology(num_nodes, links, name=name)


def split_tp_full_mesh(num_nodes: int = 8, tp: int = 4,
                       link_bw: float = HCCS_LINK_BW,
                       ) -> tuple[Topology, list[list[int]]]:
    """Paper §3.1 experiment config: full mesh split into ``num_nodes//tp``
    TP domains.  Returns (topology, domains)."""
    topo = full_mesh(num_nodes, link_bw, name=f"full_mesh_tp{tp}")
    domains = [list(range(i, i + tp)) for i in range(0, num_nodes, tp)]
    return topo, domains


def two_server_cluster(npus_per_server: int = 8, num_servers: int = 2,
                       intra_bw: float = HCCS_LINK_BW,
                       inter_bw: float = ROCE_LINK_BW,
                       name: str = "two_server") -> Topology:
    """Paper §3.2/§6.1: full-mesh HCCS inside each server; rail-optimized
    inter-server RoCE (each NPU's NIC reaches only the same-index NPU on
    remote servers — the deployment shape the paper's "same-index NPU"
    relay language describes).

    Cross-server routes are overridden rail-first ("get onto the
    destination server via your own rail, then hop intra-server"), so that
    ``partition_by_next_hop`` at a source groups ALL destinations on a
    remote server under the single same-index peer — one rail crossing per
    MultiWrite, replication at the relay, exactly §3.2.  Plain unicast
    dispatch under the same table sends k copies of a token over the same
    rail, which is the redundant-bottleneck baseline of Table 1.

    Now a single-rail instance of the :class:`ClusterSpec` fabric family.
    """
    return ClusterSpec(num_servers=num_servers,
                       npus_per_server=npus_per_server,
                       intra_bw=intra_bw, inter_bw=inter_bw,
                       name=name).build()


def tpu_pods(chips_per_pod: int = 16, num_pods: int = 2,
             ici_bw: float = TPU_ICI_LINK_BW,
             dcn_bw: float = TPU_DCN_LINK_BW,
             name: str = "tpu_pods") -> Topology:
    """TPU adaptation for the collective cost ledger.

    The intra-pod ICI torus is abstracted as a full mesh of per-chip logical
    paths at one ICI link bandwidth each (XLA pipelines ring collectives
    across the torus; per-link serialization is what the latency model
    accounts).  Inter-pod traffic is rail-optimized per chip over DCN at
    ``dcn_bw`` — the oversubscribed slow axis, the paper's §3.2 shape with
    pod ≡ server and DCN ≡ RoCE.
    """
    return two_server_cluster(npus_per_server=chips_per_pod,
                              num_servers=num_pods,
                              intra_bw=ici_bw, inter_bw=dcn_bw, name=name)


def server_of(topo: Topology, node: int) -> int:
    """Server of ``node`` — derived from the topology's fabric metadata
    (the old free function hard-coded ``npus_per_server=8``)."""
    return topo.server_of(node)


def same_index_peer(topo: Topology, node: int, dst_server: int) -> int:
    """Rail (same-index) peer of ``node`` on ``dst_server`` (§3.2) — from
    the topology's fabric metadata."""
    return topo.same_index_peer(node, dst_server)


# -- registered fabrics (planner scenarios; bench_fabrics sweeps these) -----
register_fabric("mesh8", lambda: full_mesh(8))
register_fabric("2x8", lambda: two_server_cluster())
register_fabric("4x8", lambda: ClusterSpec(num_servers=4, name="4x8").build())
register_fabric("2x8r2", lambda: ClusterSpec(rails_per_npu=2,
                                             name="2x8r2").build())
# asymmetric: the return-direction rails (server 1 -> server 0) run at
# half bandwidth — the combine path hits the bottleneck the dispatch
# path does not (paper §3.2's "where the physical bottleneck sits").
register_fabric("2x8asym", lambda: ClusterSpec(
    asymmetry={(8 + i, i): 0.5 for i in range(8)}, name="2x8asym").build())
register_fabric("tpu_2x16", lambda: tpu_pods())
