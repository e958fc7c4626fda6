"""Long-term soak harness: scripted degradations against the live loop.

The paper's headline evidence is "long-term stress tests on commercially
deployed devices" — this driver is our equivalent, built on SimProbe's
injectable :class:`GroundTruth`.  One bound collective program serves
for N simulated hours while the harness mutates the fabric truth on a
scripted schedule (rail slowdowns, asymmetric single-direction
slowdowns, recoveries), runs one full telemetry cycle per epoch, and
scrapes its own Prometheus exporter over real HTTP each epoch — the
same bytes an operator's scrape job would pull.

End-to-end assertions over the whole run:

    detection     every injected event trips a recalibration within
                  ``--detect-within`` epochs
    convergence   after a class-uniform event, the trusted "inter" fit
                  lands within 20% of the injected true rail bandwidth
    flips         the planner's post-cycle decision for the monitored
                  dispatch cell equals a fresh ORACLE planner scored on
                  the hidden truth (grace window while drift is being
                  detected), and at least one genuine scheme flip occurs
    stale         stale-bound-plan warnings fire EXACTLY once per
                  changed-program recalibration (re-bind resets the
                  one-shot)
    slo           the scraped per-cell SLO classification transitions
                  good -> poor (stale model at the degradation epoch)
                  -> good (post-recalibration)

Writes ``results/calibration_torch/STRESS_soak.json`` with the full timeline.

    PYTHONPATH=src python -m repro_torch.launch.stress            # full soak
    PYTHONPATH=src python -m repro_torch.launch.stress --smoke    # CI gate
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from repro_torch.core.planner import Planner, bucket_payload
from repro_torch.core.topology import get_fabric
from repro_torch.telemetry import (CalibrationStore, DriftMonitor, GroundTruth,
                             MetricsExporter, SimProbe, parse_text,
                             reset_default_registry, scrape)
from repro_torch.telemetry.probe import link_class

TOKEN_BYTES = 7168
FLIP_BATCH = 64            # the Fig 8 cell bench_calibration validates:
#   unicast healthy, multiwrite under a 4x rail slowdown (2x8)
SLO_BATCH = 512            # large-payload cell whose SLO the scrape tracks


# ---------------------------------------------------------------------------
# truth mutations (the degradation schedule's vocabulary)
# ---------------------------------------------------------------------------

def apply_event(truth: GroundTruth, topo, event: dict) -> GroundTruth:
    kind = event["kind"]
    if kind == "degrade":
        return truth.degraded(topo, event.get("factor", 4.0))
    if kind == "recover":
        # drop every per-link override AND any blackout: healthy again
        return dataclasses.replace(truth, link_bw=(), dead_links=())
    if kind == "asym":
        # one rail DIRECTION slows down (src_server -> everyone else);
        # the return direction stays healthy — the per-role fit case
        factor = float(event.get("factor", 4.0))
        src_server = int(event.get("src_server", 0))
        cur = dict(truth.link_bw)
        links = {}
        for key, ln in topo.links.items():
            if (link_class(topo, *key) == "inter"
                    and topo.server_of(key[0]) == src_server):
                links[key] = cur.get(key, ln.bw) / factor
        return truth.with_links(links)
    raise ValueError(f"unknown stress event kind {event['kind']!r}")


def true_inter_bw(truth: GroundTruth, topo) -> float:
    """Mean bandwidth the truth's inter-server links actually deliver."""
    cur = dict(truth.link_bw)
    bws = [cur.get(key, ln.bw) for key, ln in topo.links.items()
           if link_class(topo, *key) == "inter"]
    return sum(bws) / len(bws) if bws else 0.0


def build_schedule(epochs: int, smoke: bool) -> list[dict]:
    """Scripted degradation schedule over ``epochs`` probe cycles."""
    if smoke:
        return [{"epoch": 1, "kind": "degrade", "factor": 4.0},
                {"epoch": max(3, epochs - 2), "kind": "recover"}]
    marks = [(0.12, {"kind": "degrade", "factor": 4.0}),
             (0.33, {"kind": "recover"}),
             (0.55, {"kind": "asym", "factor": 4.0, "src_server": 0}),
             (0.78, {"kind": "recover"})]
    return [{"epoch": max(1, int(frac * epochs)), **ev}
            for frac, ev in marks]


# ---------------------------------------------------------------------------
# the soak loop
# ---------------------------------------------------------------------------

def _metric(parsed: dict, name: str, **labels) -> float:
    """One scraped sample, 0.0 when the series has no samples yet."""
    want = tuple(sorted((k, str(v)) for k, v in labels.items()))
    for (n, lbls), v in parsed.items():
        if n == name and tuple(l for l in lbls
                               if l[0] in labels) == want:
            return v
    return 0.0


def run_soak(*, fabric: str = "2x8", epochs: int = 48,
             epoch_minutes: float = 10.0, noise: float = 0.01,
             seed: int = 0, detect_within: int = 2,
             smoke: bool = False, out_path: str | None = None,
             port: int = 0) -> dict:
    reset_default_registry()
    topo = get_fabric(fabric)
    planner = Planner()
    store = CalibrationStore(":memory:")
    monitor = DriftMonitor(planner, store, topo)
    truth = GroundTruth(noise=noise, seed=seed)
    schedule = build_schedule(epochs, smoke)
    by_epoch = {ev["epoch"]: ev for ev in schedule}

    # the bound program: a prefill/decode serving shape — prefill sits at
    # the Fig 8 flip cell (scheme changes under a rail slowdown), decode
    # stays small-payload unicast
    from repro_torch.core import plan as plan_ir
    program = plan_ir.CollectiveProgram(
        name="stress_serve",
        sites=(*plan_ir.moe_sites("prefill", num_experts=64, top_k=8,
                                  tokens_per_rank=FLIP_BATCH,
                                  token_bytes=TOKEN_BYTES),
               *plan_ir.moe_sites("decode", num_experts=64, top_k=8,
                                  tokens_per_rank=4,
                                  token_bytes=TOKEN_BYTES)))
    eplan = planner.plan_program(program, topo)
    flip_payload = float(FLIP_BATCH) * TOKEN_BYTES
    slo_bucket = bucket_payload(float(SLO_BATCH) * TOKEN_BYTES)

    exporter = MetricsExporter(port).start()
    stale_warned = [False]
    stale_warnings: list[int] = []

    def check_stale(epoch: int) -> bool:
        """The launcher-style one-shot stale check (run twice per epoch
        to PROVE the warning cannot double-fire)."""
        stale = planner.plan_is_stale(eplan)
        if stale and not stale_warned[0]:
            stale_warned[0] = True
            stale_warnings.append(epoch)
            from repro_torch.telemetry import default_registry
            default_registry()["repro_plan_stale_total"].inc(
                program=program.name, fingerprint=eplan.fingerprint)
            print(f"epoch {epoch}: WARNING bound plan "
                  f"{eplan.fingerprint} is stale (replan chose "
                  f"different decisions)")
        return bool(stale)

    timeline: list[dict] = []
    recal_epochs: list[int] = []
    changed_recals: list[int] = []
    prev_scrape: dict = {}
    prev_plan: str | None = None
    t_wall = time.monotonic()
    try:
        for epoch in range(epochs):
            event = by_epoch.get(epoch)
            if event is not None:
                truth = apply_event(truth, topo, event)
                print(f"epoch {epoch}: injected {event['kind']} "
                      f"(true inter bw now "
                      f"{true_inter_bw(truth, topo) / 1e9:.2f} GB/s)")
            # fresh probe rng per epoch: run-to-run jitter, not one
            # frozen noise draw replayed forever
            probe = SimProbe(dataclasses.replace(truth,
                                                 seed=seed + 1000 + epoch))
            recal = monitor.run_cycle(probe)
            if recal is not None:
                recal_epochs.append(epoch)
                if any(p["changed"] for p in recal.get("programs", [])):
                    changed_recals.append(epoch)
            # one-shot stale surface + hot re-bind (checked twice: the
            # second call must never warn again)
            was_stale = check_stale(epoch)
            check_stale(epoch)
            if was_stale:
                eplan = monitor.replanned(program.name) or \
                    planner.plan_program(program, topo)
                stale_warned[0] = False
            # post-cycle planner verdict vs a fresh oracle on the truth
            decision = planner.choose("dispatch", flip_payload, topo)
            oracle = Planner(hw=truth.true_hw()).choose(
                "dispatch", flip_payload, topo)
            # the operator's view: scrape our own exporter over HTTP
            parsed = parse_text(scrape(exporter.url))
            slo_deltas = {
                cls: (_metric(parsed, "repro_slo_class_total",
                              op="dispatch", payload_bucket=slo_bucket,
                              slo=cls)
                      - _metric(prev_scrape, "repro_slo_class_total",
                                op="dispatch", payload_bucket=slo_bucket,
                                slo=cls))
                for cls in ("good", "acceptable", "poor")}
            # epoch class = WORST class observed this epoch (SLOs report
            # the tail, not the mode — one poor probe among good ones
            # makes the cell poor)
            slo_class = next((cls for cls in ("poor", "acceptable", "good")
                              if slo_deltas.get(cls, 0) > 0), None)
            row = {
                "epoch": epoch,
                "sim_time_h": round(epoch * epoch_minutes / 60.0, 3),
                "event": event,
                "true_inter_gbps": true_inter_bw(truth, topo) / 1e9,
                "drift_pct": round(100 * monitor.drift(), 2),
                "recalibrated": recal is not None,
                "fits": recal["fits"] if recal else None,
                "planner_plan": decision.plan,
                "oracle_plan": oracle.plan,
                "flipped": (prev_plan is not None
                            and decision.plan != prev_plan),
                "bound_fingerprint": eplan.fingerprint,
                "stale_warned": was_stale,
                "slo_class": slo_class,
                "scrape": {
                    "drift_ratio": _metric(parsed, "repro_drift_ratio",
                                           op="dispatch"),
                    "recalibrations": _metric(
                        parsed, "repro_recalibrations_total"),
                    "decision_flips": sum(
                        v for (n, lbls), v in parsed.items()
                        if n == "repro_planner_decision_flips_total"),
                    "slo_deltas": slo_deltas,
                },
            }
            timeline.append(row)
            prev_scrape = parsed
            prev_plan = decision.plan
    finally:
        exporter.stop()

    # -- the five end-to-end assertions -------------------------------------
    failures: list[str] = []

    def check(name: str, ok: bool, detail: str) -> dict:
        if not ok:
            failures.append(f"{name}: {detail}")
        return {"name": name, "ok": bool(ok), "detail": detail}

    # 1. detection latency: every event trips a recal within the window
    latencies = {}
    for ev in schedule:
        hit = next((r for r in recal_epochs
                    if ev["epoch"] <= r <= ev["epoch"] + detect_within),
                   None)
        latencies[ev["epoch"]] = (None if hit is None
                                  else hit - ev["epoch"])
    a_detect = check(
        "detection",
        all(v is not None for v in latencies.values()),
        f"recal latency per event epoch: {latencies} "
        f"(window {detect_within})")

    # 2. convergence: after a class-uniform event, the trusted inter fit
    #    lands within 20% of the injected truth
    conv = []
    for ev in schedule:
        if ev["kind"] not in ("degrade", "recover"):
            continue
        rows = [r for r in timeline
                if r["recalibrated"] and r["fits"]
                and ev["epoch"] <= r["epoch"] <= ev["epoch"]
                + detect_within]
        if not rows:
            conv.append((ev["epoch"], None, None, False))
            continue
        fit = rows[-1]["fits"].get("inter", {})
        fitted = fit.get("bw_gbps", 0.0) * 1e9
        true_bw = (rows[-1]["true_inter_gbps"]) * 1e9
        ok = (fit.get("trusted", False) and true_bw > 0
              and abs(fitted - true_bw) / true_bw <= 0.20)
        conv.append((ev["epoch"], round(fitted / 1e9, 2),
                     round(true_bw / 1e9, 2), ok))
    a_conv = check(
        "convergence", all(c[-1] for c in conv),
        f"(event_epoch, fitted_gbps, true_gbps, ok): {conv}")

    # 3. decision flips match the oracle: outside detection grace
    #    windows the fitted planner and the truth oracle must agree,
    #    and at least one genuine scheme flip must have happened
    grace = {e for ev in schedule
             for e in range(ev["epoch"],
                            ev["epoch"] + detect_within + 1)}
    mismatches = [r["epoch"] for r in timeline
                  if r["epoch"] not in grace
                  and r["planner_plan"] != r["oracle_plan"]]
    n_flips = sum(1 for r in timeline if r["flipped"])
    a_flips = check(
        "flips", not mismatches and n_flips >= 1,
        f"planner-vs-oracle mismatches at epochs {mismatches}; "
        f"{n_flips} genuine flip(s) observed")

    # 4. stale warnings: exactly once per changed-program recalibration
    a_stale = check(
        "stale", stale_warnings == changed_recals,
        f"stale warnings at {stale_warnings}, changed-program recals "
        f"at {changed_recals}")

    # 5. SLO transition good -> poor -> good around the first degrade
    deg = next(ev["epoch"] for ev in schedule if ev["kind"] == "degrade")
    classes = [r["slo_class"] for r in timeline]
    pre = [c for c in classes[:deg] if c]
    post = [c for c in classes[deg + 1:] if c]
    a_slo = check(
        "slo",
        bool(pre) and pre[-1] == "good"
        and classes[deg] == "poor"
        and "good" in post,
        f"classes around degrade@{deg}: pre={pre[-2:]} "
        f"at={classes[deg]} post={post[:3]}")

    assertions = [a_detect, a_conv, a_flips, a_stale, a_slo]

    # 6. asymmetric-degradation windows settle after ONE recalibration:
    #    per-role fit attribution books each probe against the truly
    #    bottlenecking direction, so the slow direction's fit converges
    #    instead of alternating with the healthy return rail and
    #    re-tripping the drift threshold every epoch
    for ev in schedule:
        if ev["kind"] != "asym":
            continue
        nxt = min((e["epoch"] for e in schedule
                   if e["epoch"] > ev["epoch"]), default=epochs)
        in_window = [e for e in recal_epochs if ev["epoch"] <= e < nxt]
        assertions.append(check(
            "asym_window", len(in_window) <= 1,
            f"recalibrations during asym window "
            f"[{ev['epoch']}, {nxt}): {in_window} (churn if > 1)"))

    result = {
        "config": {"fabric": fabric, "epochs": epochs,
                   "epoch_minutes": epoch_minutes,
                   "sim_hours": round(epochs * epoch_minutes / 60.0, 2),
                   "noise": noise, "seed": seed, "smoke": smoke,
                   "detect_within": detect_within,
                   "flip_batch": FLIP_BATCH, "slo_batch": SLO_BATCH},
        "ts": time.time(),
        "wall_s": round(time.monotonic() - t_wall, 2),
        "schedule": schedule,
        "assertions": assertions,
        "ok": not failures,
        "timeline": timeline,
    }
    if out_path is None:
        out_path = os.path.join(os.path.dirname(__file__), "..", "..",
                                "..", "results", "calibration_torch",
                                "STRESS_soak.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    for a in result["assertions"]:
        print(f"[{'ok' if a['ok'] else 'FAIL'}] {a['name']}: {a['detail']}")
    print(f"soak: {epochs} epoch(s) over "
          f"{result['config']['sim_hours']}h simulated, "
          f"{len(recal_epochs)} recalibration(s), "
          f"{len(stale_warnings)} stale warning(s) -> {out_path}")
    if failures:
        for fmsg in failures:
            print(f"STRESS FAILURE: {fmsg}", file=sys.stderr)
    return result


# ---------------------------------------------------------------------------
# failure-events soak: rail blackout -> detect -> reroute -> hot re-bind
# ---------------------------------------------------------------------------

def run_failure_soak(*, fabric: str = "2x8", epochs: int = 8,
                     noise: float = 0.01, seed: int = 0,
                     detect_within: int = 2,
                     out_path: str | None = None, port: int = 0) -> dict:
    """The fault-tolerance arc end-to-end: a rail goes DARK mid-serve
    (both directions of one inter-server link stop carrying probe
    traffic), the FailureDetector declares it dead within
    ``detect_within`` cycles, the planner retargets the bound program
    around it on the surviving capacity graph, the staged replacement
    plan hot-swaps in at a step boundary with ZERO cold retraces, no
    executed plan ever charges the dark rail outside the detection
    grace window, and recovery flips the decisions back.

    Writes ``results/calibration_torch/STRESS_failover.json``.
    """
    from repro_torch.core.planner import ledger_infeasible, plan_site_ledgers
    from repro_torch.core.topology import FailureState
    from repro_torch.parallel.context import PlanBinder
    from repro_torch.telemetry.failover import FailureDetector

    reset_default_registry()
    topo = get_fabric(fabric)
    planner = Planner()
    store = CalibrationStore(":memory:")
    detector = FailureDetector(topo, strikes=min(2, detect_within))
    monitor = DriftMonitor(planner, store, topo, detector=detector)
    truth = GroundTruth(noise=noise, seed=seed)

    # the blacked-out rail: the first inter-server link, both directions
    # (a dark cable is dark both ways)
    rail = detector.rails[0]
    blackout = {rail, (rail[1], rail[0])}
    blackout_epoch = 1
    restore_epoch = max(blackout_epoch + detect_within + 2, epochs - 3)
    schedule = [
        {"epoch": blackout_epoch, "kind": "blackout",
         "links": sorted(blackout)},
        {"epoch": restore_epoch, "kind": "restore"},
    ]
    by_epoch = {ev["epoch"]: ev for ev in schedule}

    from repro_torch.core import plan as plan_ir
    program = plan_ir.CollectiveProgram(
        name="stress_serve",
        sites=(*plan_ir.moe_sites("prefill", num_experts=64, top_k=8,
                                  tokens_per_rank=FLIP_BATCH,
                                  token_bytes=TOKEN_BYTES),
               *plan_ir.moe_sites("decode", num_experts=64, top_k=8,
                                  tokens_per_rank=4,
                                  token_bytes=TOKEN_BYTES)))
    eplan = planner.plan_program(program, topo)

    def decisions_of(plan) -> dict:
        return {role: (plan.decisions[role].plan,
                       tuple(plan.decisions[role].knobs))
                for role in sorted(plan.decisions)}

    pre_blackout = decisions_of(eplan)
    plan_topos = {eplan.fingerprint: topo}

    # the "traced lowering": the failure soak runs no real model, so the
    # artifact is a build receipt — what matters is WHEN builds happen
    # (stage time, off the step path) and that swaps never build
    trace_log: list[str] = []

    def trace_fn(plan):
        trace_log.append(plan.fingerprint)
        return {"fingerprint": plan.fingerprint}

    binder = PlanBinder(trace_fn, plan=eplan)

    # live queued traffic rides through the blackout: a seeded open-loop
    # Poisson stream drains through the continuous-batching scheduler
    # (virtual clock) WHILE the fault arc runs.  Epochs whose active
    # plan still charges the dark rail quadruple the virtual step time
    # (the degraded fabric); the drain must lose nothing.
    from repro_torch.serving import (AdmissionController, BatchScheduler,
                               PlannerProbe, RequestQueue, TrafficConfig,
                               TrafficGenerator)
    traffic_window_s = 0.25          # virtual serving time per soak epoch
    n_traffic = 120
    sprobe = PlannerProbe(topo, token_bytes=TOKEN_BYTES)
    traffic_tpot_slo = sprobe.decode_step_s(FLIP_BATCH) * 1.15
    queue = RequestQueue()
    for req in TrafficGenerator(TrafficConfig(
            arrival_rate_rps=n_traffic / (0.6 * epochs * traffic_window_s),
            num_requests=n_traffic, prompt_lens=(128,), max_news=(16,),
            seed=seed + 77)).requests():
        queue.push(req)
    sched = BatchScheduler(
        queue=queue,
        admission=AdmissionController(sprobe, capacity=FLIP_BATCH,
                                      policy="planner",
                                      tpot_slo_s=traffic_tpot_slo,
                                      ttft_slo_s=0.08),
        probe=sprobe)
    deg_start = deg_end = None

    exporter = MetricsExporter(port).start()
    timeline: list[dict] = []
    swap_epochs: list[int] = []
    detect_log: list[dict] = []
    recal_epochs: list[int] = []
    t_wall = time.monotonic()
    try:
        for epoch in range(epochs):
            # step boundary: a staged re-bind lands HERE, never mid-epoch
            if binder.swap_if_pending():
                swap_epochs.append(epoch)
            event = by_epoch.get(epoch)
            if event is not None:
                if event["kind"] == "blackout":
                    truth = truth.with_dead(blackout)
                    print(f"epoch {epoch}: rail "
                          f"{rail[0]}<->{rail[1]} went DARK")
                else:
                    truth = dataclasses.replace(truth, dead_links=())
                    print(f"epoch {epoch}: rail restored")
            probe = SimProbe(dataclasses.replace(truth,
                                                 seed=seed + 1000 + epoch))
            n_det = len(detector.events)
            recal = monitor.run_cycle(probe)
            if recal is not None:
                recal_epochs.append(epoch)
            for ev in detector.events[n_det:]:
                detect_log.append({"epoch": epoch, **{
                    k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in ev.items()}})
            # stage the latest retargeted plan (no-op when it is already
            # the active one); its lowering builds NOW, off the step path
            staged = monitor.staged_plan(program.name)
            staged_now = False
            if staged is not None:
                plan_topos.setdefault(staged.fingerprint, monitor.topo)
                staged_now = binder.stage(staged)
            # feasibility audit of the ACTIVE plan against hidden TRUTH
            truth_failures = FailureState(
                dead_links=set(truth.dead_links))
            active = binder.plan
            ledgers = plan_site_ledgers(
                active, plan_topos[active.fingerprint])
            violations = sorted(
                role for role, led in ledgers.items()
                if ledger_infeasible(led, truth_failures) is not None)
            # serve this epoch's slice of the request stream under the
            # fabric the active plan actually gets: dark-rail epochs run
            # at 4x virtual step time until the failover swap lands
            if violations and deg_start is None:
                deg_start = sched.now
            if not violations and deg_start is not None and deg_end is None:
                deg_end = sched.now
            sched.step_time_scale = 4.0 if violations else 1.0
            sched.run_for(traffic_window_s)
            parsed = parse_text(scrape(exporter.url))
            timeline.append({
                "epoch": epoch,
                "event": event,
                "truth_dead": sorted(truth.dead_links),
                "detector_dead": sorted(detector.dead_links()),
                "active_fingerprint": active.fingerprint,
                "active_decisions": decisions_of(active),
                "swapped": epoch in swap_epochs,
                "staged": staged_now,
                "violations": violations,
                "recalibrated": recal is not None,
                "traffic": {"now_s": sched.now,
                            "completed": len(sched.completed),
                            "queue_depth": len(queue),
                            "in_flight": sched.in_flight,
                            "degraded": bool(violations)},
                "scrape": {
                    "failed_links": _metric(parsed, "repro_failed_links",
                                            fabric=fabric),
                    "rebinds": sum(
                        v for (n, _), v in parsed.items()
                        if n == "repro_plan_rebind_total"),
                    "cold_retraces": sum(
                        v for (n, _), v in parsed.items()
                        if n == "repro_rebind_cold_retrace_total"),
                    "infeasible_masked": sum(
                        v for (n, _), v in parsed.items()
                        if n == "repro_plan_infeasible_total"),
                },
            })
    finally:
        exporter.stop()

    # post-recovery drain: whatever the blackout backed up must finish
    # on the healthy fabric
    sched.step_time_scale = 1.0
    sched.run_until_drained()
    if deg_start is not None and deg_end is None:
        deg_end = sched.now

    failures_list: list[str] = []

    def check(name: str, ok: bool, detail: str) -> dict:
        if not ok:
            failures_list.append(f"{name}: {detail}")
        return {"name": name, "ok": bool(ok), "detail": detail}

    # 1. detection: both directions of the dark rail declared dead
    #    within the window, and revived within the window after restore
    dead_at = {tuple(e["link"]): e["epoch"] for e in detect_log
               if e["kind"] == "link_dead"}
    revived_at = {tuple(e["link"]): e["epoch"] for e in detect_log
                  if e["kind"] == "link_recovered"}
    a_detect = check(
        "detection",
        all(blackout_epoch <= dead_at.get(k, 10 ** 9)
            <= blackout_epoch + detect_within for k in blackout)
        and all(restore_epoch <= revived_at.get(k, 10 ** 9)
                <= restore_epoch + detect_within for k in blackout),
        f"dead_at={dead_at} revived_at={revived_at} "
        f"(blackout@{blackout_epoch}, restore@{restore_epoch}, "
        f"window {detect_within})")

    # 2. reroute: the failover swap lands within one step of detection
    #    and the swapped-in plan's ledgers avoid the dark rail
    first_dead = min(dead_at.values(), default=None)
    failover_swap = next((e for e in swap_epochs
                          if e > blackout_epoch), None)
    all_violations = [(r["epoch"], r["violations"]) for r in timeline
                      if r["violations"]]
    a_reroute = check(
        "reroute",
        first_dead is not None and failover_swap is not None
        and failover_swap <= first_dead + 1
        and all(not r["violations"] for r in timeline
                if failover_swap <= r["epoch"] < restore_epoch),
        f"first link declared dead @{first_dead}, failover swap "
        f"@{failover_swap}, post-swap violations: {all_violations}")

    # 3. no infeasible execution outside the detection grace window
    #    (the plan bound when the rail dies keeps executing until the
    #    detector has evidence — that window is bounded, not zero)
    grace = set(range(blackout_epoch,
                      (failover_swap if failover_swap is not None
                       else blackout_epoch + detect_within + 2)))
    bad = [(r["epoch"], r["violations"]) for r in timeline
           if r["violations"] and r["epoch"] not in grace]
    a_exec = check(
        "no_dead_exec", not bad and len(grace) <= detect_within + 2,
        f"dead-link executions outside grace {sorted(grace)}: {bad}")

    # 4. hot re-bind: exactly one swap per transition, all lowerings
    #    built at stage time — zero cold retraces at swap time
    a_rebind = check(
        "rebind",
        binder.swaps == 2 and binder.cold_retraces == 0
        and len(trace_log) == binder.cache_misses,
        f"swaps={binder.swaps} (want 2: failover + failback) "
        f"cold_retraces={binder.cold_retraces} "
        f"builds={len(trace_log)} cache_misses={binder.cache_misses}")

    # 5. flip-back: after recovery the active plan's DECISIONS equal the
    #    pre-blackout plan's (fingerprints may differ — calibration
    #    refits during the blackout legitimately move hw identity)
    final = timeline[-1]["active_decisions"]
    a_flip = check(
        "flipback", final == pre_blackout
        and any(e.get("kind") == "failback" for e in monitor.events),
        f"final decisions {final} vs pre-blackout {pre_blackout}; "
        f"monitor events: "
        f"{[e.get('kind') for e in monitor.events]}")

    # 6. traffic: the dark-rail drain loses NOTHING — every arrived
    #    request is admitted and completes; the degraded window's TTFT
    #    spike stays bounded by the window itself (no unbounded
    #    starvation); and after recovery the TTFT tail returns to the
    #    healthy band
    from repro_torch.serving.scheduler import _pctl
    from repro_torch.telemetry.metrics import default_registry
    reg = default_registry()
    admitted_m = reg["repro_requests_total"].value(outcome="admitted")
    completed_m = reg["repro_requests_total"].value(outcome="completed")
    pre = [r.ttft_s for r in sched.completed
           if deg_start is None or r.first_token_s < deg_start]
    # recovery is judged on requests that ARRIVED after the degraded
    # window closed (first-token timing alone still carries the
    # blackout backlog's queueing tail)
    post = [r.ttft_s for r in sched.completed
            if deg_end is not None and r.arrival_s >= deg_end]
    pre_p99 = _pctl(pre, 99)
    post_p99 = _pctl(post, 99)
    spike = max((r.ttft_s for r in sched.completed), default=0.0)
    deg_len = ((deg_end - deg_start)
               if deg_start is not None and deg_end is not None else 0.0)
    a_traffic = check(
        "traffic",
        len(sched.completed) == n_traffic and len(queue) == 0
        and sched.in_flight == 0 and admitted_m == completed_m == n_traffic
        and deg_len > 0 and pre and post
        and spike <= deg_len + max(10 * pre_p99, 0.05)
        # 2.5x, not 1x: post-drain concurrency is higher than the light
        # pre-blackout warmup, so iterations are legitimately longer
        and post_p99 <= 2.5 * pre_p99 and post_p99 <= 0.5 * spike,
        f"completed={len(sched.completed)}/{n_traffic} "
        f"(metrics admitted={admitted_m:.0f} completed={completed_m:.0f}), "
        f"degraded window {deg_len * 1e3:.0f}ms, max TTFT "
        f"{spike * 1e3:.1f}ms, p99 TTFT pre/post "
        f"{pre_p99 * 1e3:.1f}/{post_p99 * 1e3:.1f}ms")

    result = {
        "config": {"fabric": fabric, "epochs": epochs, "noise": noise,
                   "seed": seed, "detect_within": detect_within,
                   "blackout_rail": sorted(blackout),
                   "blackout_epoch": blackout_epoch,
                   "restore_epoch": restore_epoch,
                   "traffic": {"requests": n_traffic,
                               "window_s": traffic_window_s,
                               "tpot_slo_s": traffic_tpot_slo}},
        "ts": time.time(),
        "wall_s": round(time.monotonic() - t_wall, 2),
        "schedule": schedule,
        "detections": detect_log,
        "swap_epochs": swap_epochs,
        "recal_epochs": recal_epochs,
        "assertions": [a_detect, a_reroute, a_exec, a_rebind, a_flip,
                       a_traffic],
        "ok": not failures_list,
        "timeline": timeline,
    }
    if out_path is None:
        out_path = os.path.join(os.path.dirname(__file__), "..", "..",
                                "..", "results", "calibration_torch",
                                "STRESS_failover.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    for a in result["assertions"]:
        print(f"[{'ok' if a['ok'] else 'FAIL'}] {a['name']}: {a['detail']}")
    print(f"failure soak: {epochs} epoch(s), blackout@{blackout_epoch} "
          f"restore@{restore_epoch}, {binder.swaps} swap(s), "
          f"{binder.cold_retraces} cold retrace(s) -> {out_path}")
    if failures_list:
        for fmsg in failures_list:
            print(f"STRESS FAILURE: {fmsg}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fabric", default="2x8")
    ap.add_argument("--hours", type=float, default=8.0,
                    help="simulated soak duration")
    ap.add_argument("--epoch-minutes", type=float, default=10.0,
                    help="simulated probe cadence (one telemetry cycle "
                         "per epoch)")
    ap.add_argument("--noise", type=float, default=0.01,
                    help="lognormal measurement jitter sigma")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--detect-within", type=int, default=2,
                    help="max epochs between an injected event and its "
                         "recalibration")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: 6-epoch soak with one degradation + "
                         "recovery")
    ap.add_argument("--failure-events", action="store_true",
                    help="run the fault-tolerance arc instead: rail "
                         "blackout -> detect -> reroute -> hot re-bind "
                         "-> recover (results/calibration_torch/STRESS_failover.json)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="failure-events soak length (default 10)")
    ap.add_argument("--out", default=None,
                    help="result JSON path (default "
                         "results/calibration_torch/STRESS_soak.json)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="exporter port the soak scrapes (0 = ephemeral)")
    args = ap.parse_args(argv)
    if args.failure_events:
        result = run_failure_soak(
            fabric=args.fabric, epochs=args.epochs or 10,
            noise=args.noise, seed=args.seed,
            detect_within=args.detect_within, out_path=args.out,
            port=args.metrics_port)
        return 0 if result["ok"] else 1
    epochs = (6 if args.smoke
              else max(4, int(args.hours * 60 / args.epoch_minutes)))
    result = run_soak(fabric=args.fabric, epochs=epochs,
                      epoch_minutes=args.epoch_minutes, noise=args.noise,
                      seed=args.seed, detect_within=args.detect_within,
                      smoke=args.smoke, out_path=args.out,
                      port=args.metrics_port)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
