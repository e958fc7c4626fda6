"""Link-failure detection from probe evidence (the telemetry DETECTOR).

The paper motivates MultiWrite's graceful degradation with multicast's
management-plane fragility; this module supplies the *detection* half of
the fault-tolerance arc: per-rail point-to-point probes under the
bounded-retry :class:`~repro_torch.telemetry.probe.ProbePolicy`, consecutive
timeouts counted as strikes, ``strikes`` consecutive misses declaring
the directed link dead, and any later success reviving it (asymmetric
hysteresis: K strikes to kill, one success to heal — a flapping link is
re-declared only after K fresh consecutive misses).

The detector always probes the HEALTHY base topology's rails — including
links currently declared dead — because recovery can only be noticed by
probing the very link the effective (failed) topology no longer has.
:meth:`FailureDetector.failures` yields the accumulated
:class:`~repro_torch.core.topology.FailureState`, which the
:class:`~repro_torch.telemetry.monitor.DriftMonitor` composes onto the base
fabric via ``with_failures`` and feeds to the planner.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import plan as plan_ir
from repro_torch.core.topology import FailureState, Topology

from .probe import ProbePolicy, measure_safely

# detector probes are small and frequent: enough bytes that a healthy
# rail's serialization dominates alpha, small enough to stay cheap
RAIL_PROBE_BYTES = 1 << 20

# detector attempts retry once with a short backoff — a scan is a health
# check, not a calibration; the K-strike hysteresis absorbs flakiness
DETECT_POLICY = ProbePolicy(retries=1, backoff_s=0.005)


def rail_probe_ledger(topo: Topology, key: tuple[int, int],
                      payload_bytes: float = RAIL_PROBE_BYTES
                      ) -> plan_ir.Ledger:
    """Single-link probe ledger: ``payload_bytes`` over exactly one
    directed link — finer than the server-pair ``linkprobe`` plan (which
    stripes all rails of a direction and would indict the whole
    direction when one rail is dark)."""
    return plan_ir.Ledger(topo=topo, link_bytes={key: float(payload_bytes)},
                          relay_bytes={}, flow_counts={key: 1})


class FailureDetector:
    """Declares directed inter-server links dead after ``strikes``
    consecutive probe timeouts, and revives them on the next success.

    The detector only watches *rails* (inter-server links): the paper's
    failure surface is the RoCE/management plane, intra-server full-mesh
    links are not individually probeable at this granularity, and a dead
    intra link surfaces as drift instead.
    """

    def __init__(self, base_topo: Topology, *, strikes: int = 2,
                 payload_bytes: float = RAIL_PROBE_BYTES,
                 policy: ProbePolicy = DETECT_POLICY) -> None:
        self.base_topo = base_topo
        self.strikes = max(1, int(strikes))
        self.payload_bytes = float(payload_bytes)
        self.policy = policy
        self.rails: tuple = tuple(sorted(
            key for key in base_topo.links
            if base_topo.server_of(key[0]) != base_topo.server_of(key[1])))
        self._strikes: dict[tuple[int, int], int] = {}
        self._dead: set = set()
        self.events: list[dict] = []

    def dead_links(self) -> frozenset:
        return frozenset(self._dead)

    def failures(self) -> FailureState:
        """The accumulated fault set, ready for ``with_failures``."""
        return FailureState(dead_links=self._dead)

    def scan(self, executor) -> bool:
        """One probe pass over every rail of the base topology; returns
        True when the dead-link set changed (the monitor's cue to
        recompute the surviving-capacity graph)."""
        from . import metrics as _metrics
        reg = _metrics.default_registry()
        changed = False
        for key in self.rails:
            ledger = rail_probe_ledger(self.base_topo, key,
                                       self.payload_bytes)
            measured = measure_safely(
                executor, "linkprobe", "p2p", self.payload_bytes,
                self.base_topo, policy=self.policy, ledger=ledger,
                knobs={}, src_server=self.base_topo.server_of(key[0]),
                dst_server=self.base_topo.server_of(key[1]),
                src_node=key[0], dst_node=key[1])
            if measured is None:
                n = self._strikes.get(key, 0) + 1
                self._strikes[key] = n
                if n >= self.strikes and key not in self._dead:
                    self._dead.add(key)
                    changed = True
                    self.events.append({"kind": "link_dead", "link": key,
                                        "strikes": n})
                    reg["repro_failures_detected_total"].inc(
                        fabric=self.base_topo.name, kind="link")
            else:
                self._strikes[key] = 0
                if key in self._dead:
                    self._dead.discard(key)
                    changed = True
                    self.events.append({"kind": "link_recovered",
                                        "link": key})
                    reg["repro_failures_recovered_total"].inc(
                        fabric=self.base_topo.name, kind="link")
        reg["repro_failed_links"].set(len(self._dead),
                                      fabric=self.base_topo.name)
        return changed
