"""The MultiWrite semantic: recursive multi-destination one-sided write.

Faithful implementation of paper §4.3:

    MultiWrite(S, M, B_S) with M = {(D_1, B_1) ... (D_n, B_n)} atomically
    writes buffer B_S of node S to buffer B_i at every destination D_i.

Execution model (§4.3.3), identical logic at every node:
  1. a node receives a MultiWrite targeting destination set M;
  2. if |M| == 1 → degenerate to a standard write;
  3. if |M| > 1  → partition M into subsets by next-hop relay (from the
     *unicast* forwarding table, §4.1) and issue one child MultiWrite per
     subset, with the bitmap metadata rewritten to that subset.

This module provides :class:`MultiWriteSimulator`, a packet-level executor
over a :class:`~repro_torch.core.topology.Topology` that

- maintains per-node memories (dict buffers) so semantic properties
  (per-destination atomicity, exactly-once delivery, statelessness) are
  directly testable;
- keeps a per-link **byte ledger** — the quantity the whole paper is about:
  redundant bytes on bottleneck links.  The ledger feeds
  ``latency_model.py``.

The simulator is intentionally pure-python/NumPy: it is the semantic oracle
against which the JAX ``shard_map`` collectives (collectives.py) and the
Pallas dispatch kernels are validated.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Mapping, Sequence

import numpy as np

from . import bitmap as bm
from .topology import Topology


@dataclasses.dataclass(frozen=True)
class WriteRecord:
    """One hop of one (Multi)Write packet, for the ledger/trace."""

    src: int
    dst: int
    nbytes: int
    dest_bitmap: int      # metadata carried on this hop (post-rewrite)
    step: int             # schedule step the packet belongs to
    is_multiwrite: bool   # |M| > 1 on this hop


class DeliveryError(AssertionError):
    pass


class MultiWriteSimulator:
    """Packet-level executor for write / multiwrite over a Topology."""

    def __init__(self, topo: Topology) -> None:
        self.topo = topo
        # node -> buffer name -> np.ndarray
        self.memory: list[dict[str, np.ndarray]] = [
            {} for _ in range(topo.num_nodes)]
        self.trace: list[WriteRecord] = []
        # (src,dst) -> bytes carried, and same restricted to distinct payloads
        self.link_bytes: dict[tuple[int, int], int] = defaultdict(int)
        self._payload_seen: dict[tuple[int, int], set[bytes]] = defaultdict(set)
        self.link_unique_bytes: dict[tuple[int, int], int] = defaultdict(int)
        self.delivery_count: dict[tuple[int, str], int] = defaultdict(int)
        # node -> bytes moved through it as a relay (rx + tx of forwarded
        # traffic) — drives the AICPU-style relay processing cost (§6.4).
        self.relay_bytes: dict[int, int] = defaultdict(int)
        # tx-only component of relay_bytes: what the relay's forwarding
        # engine serializes onto egress links (§6.4 data plane) — plans
        # whose relays forward in software charge this separately.
        self.relay_tx_bytes: dict[int, int] = defaultdict(int)
        self.max_hops = 0

    # -- the standard write (baseline primitive) ----------------------------
    def write(self, src: int, dst: int, buf_name: str, data: np.ndarray,
              step: int = 0, *, _meta: int | None = None,
              _mw: bool = False) -> None:
        """One-sided unicast write src -> dst following the forwarding table.

        Multi-hop routes inject the payload on every traversed link (that is
        what store-and-forward relaying costs — and what the ledger must
        see).
        """
        data = np.asarray(data)
        nbytes = int(data.nbytes)
        meta = bm.encode([dst], self.topo.num_nodes) if _meta is None else _meta
        path = self.topo.path(src, dst)
        self.max_hops = max(self.max_hops, len(path) - 1)
        for a, b in zip(path[:-1], path[1:]):
            self._account(a, b, data, nbytes, meta, step, _mw)
        for mid in path[1:-1]:  # store-and-forward relays on multi-hop routes
            self.relay_bytes[mid] += 2 * nbytes
            self.relay_tx_bytes[mid] += nbytes
        self._deliver(dst, buf_name, data)

    # -- MultiWrite (§4.3) ---------------------------------------------------
    def multiwrite(self, src: int, dests: Mapping[int, str] | Sequence[tuple[int, str]],
                   data: np.ndarray, step: int = 0,
                   relay: int | None = None) -> None:
        """MultiWrite(S, M, B_S).

        Args:
          src: source node S.
          dests: destination-memory pairs M — mapping node -> buffer name.
          data: source buffer content B_S.
          step: schedule step tag for the ledger.
          relay: optional explicit first hop (schedule-level path selection,
            as used by the paired-relaying AllGather §3.1/§5.2).  The
            recursion below the first hop always follows the plain unicast
            forwarding table — same code at every node (§4.3.3).
        """
        data = np.asarray(data)
        pairs = dict(dests).items() if isinstance(dests, Mapping) else list(dests)
        m = {int(d): str(buf) for d, buf in pairs}
        if not m:
            return
        if relay is not None and relay != src:
            meta = bm.encode(m.keys(), self.topo.num_nodes)
            nbytes = int(data.nbytes)
            # The hint names the relay, not the route: on fabrics without a
            # direct src->relay link (e.g. cross-server non-rail peers) the
            # packet follows the unicast forwarding table to the relay,
            # paying store-and-forward at every intermediate node.
            hop_path = self.topo.path(src, relay)
            self.max_hops = max(self.max_hops, len(hop_path) - 1)
            for a, b in zip(hop_path[:-1], hop_path[1:]):
                self._account(a, b, data, nbytes, meta, step, len(m) > 1)
            for mid in hop_path[1:-1]:
                self.relay_bytes[mid] += 2 * nbytes
                self.relay_tx_bytes[mid] += nbytes
            if set(m) != {relay}:
                self.relay_bytes[relay] += nbytes  # rx at relay
            self._recurse(relay, m, data, step, origin=src)
        else:
            self._recurse(src, m, data, step, origin=src)

    def _recurse(self, node: int, m: dict[int, str], data: np.ndarray,
                 step: int, origin: int) -> None:
        nbytes = int(data.nbytes)
        # Rule 2: degenerate to a standard write.
        if len(m) == 1:
            ((dst, buf),) = m.items()
            if dst == node:
                self._deliver(dst, buf, data)
            else:
                if node != origin:
                    self.relay_bytes[node] += nbytes  # tx of forwarded data
                    self.relay_tx_bytes[node] += nbytes
                self.write(node, dst, buf, data, step,
                           _meta=bm.encode([dst], self.topo.num_nodes),
                           _mw=False)
            return
        # Rule 3: partition by next hop; one child MultiWrite per subset,
        # metadata rewritten to the subset (§4.1 "update of in-packet
        # metadata at relay nodes").
        groups = self.topo.partition_by_next_hop(node, list(m.keys()))
        for hop, subset in sorted(groups.items()):
            sub = {d: m[d] for d in subset}
            if hop == node:
                # local delivery for ourselves if we are a destination
                for d, buf in sub.items():
                    self._deliver(d, buf, data)
                continue
            meta = bm.encode(sub.keys(), self.topo.num_nodes)
            self._account(node, hop, data, nbytes, meta, step,
                          len(sub) > 1)
            if node != origin:
                self.relay_bytes[node] += nbytes  # tx of forwarded data
                self.relay_tx_bytes[node] += nbytes
            if len(sub) == 1 and hop in sub:
                self._deliver(hop, sub[hop], data)
            else:
                # the relay re-executes the same three rules (statelessness:
                # everything it needs is in (meta, payload)) and first
                # receives the payload into its relay buffer.
                self.relay_bytes[hop] += nbytes  # rx at next relay
                self._recurse(hop, sub, data, step, origin=origin)

    # -- internals -----------------------------------------------------------
    def _account(self, a: int, b: int, data: np.ndarray, nbytes: int,
                 meta: int, step: int, is_mw: bool) -> None:
        if not self.topo.has_link(a, b):
            raise ValueError(f"packet on nonexistent link {a}->{b}")
        nbytes_wire = nbytes + bm.metadata_bytes(self.topo.num_nodes)
        self.link_bytes[(a, b)] += nbytes_wire
        key = data.tobytes()
        if key not in self._payload_seen[(a, b)]:
            self._payload_seen[(a, b)].add(key)
            self.link_unique_bytes[(a, b)] += nbytes_wire
        self.trace.append(WriteRecord(a, b, nbytes_wire, meta, step, is_mw))

    def _deliver(self, node: int, buf: str, data: np.ndarray) -> None:
        self.delivery_count[(node, buf)] += 1
        if self.delivery_count[(node, buf)] > 1:
            prev = self.memory[node][buf]
            if not np.array_equal(prev, data):
                raise DeliveryError(
                    f"conflicting duplicate delivery at node {node} buf {buf}")
        # per-destination atomicity: the whole buffer lands at once.
        self.memory[node][buf] = np.array(data, copy=True)

    # -- ledger views ---------------------------------------------------------
    def redundant_bytes(self) -> dict[tuple[int, int], int]:
        """Per-link duplicate payload bytes (total - unique): the quantity
        MultiWrite exists to eliminate."""
        return {k: self.link_bytes[k] - self.link_unique_bytes.get(k, 0)
                for k in self.link_bytes}

    def bytes_crossing(self, pred) -> int:
        """Total bytes on links selected by ``pred(src,dst) -> bool``."""
        return sum(v for (a, b), v in self.link_bytes.items() if pred(a, b))

    def reset_ledger(self) -> None:
        self.trace.clear()
        self.link_bytes.clear()
        self.link_unique_bytes.clear()
        self._payload_seen.clear()
        self.delivery_count.clear()
        self.max_hops = 0
