"""Per-link-group alpha/beta regression over probe sweeps (the FIT).

Each probe record carries the bottleneck bytes of the plan it timed at
two granularities: per link CLASS (``class_bytes``: ``intra`` =
in-server full mesh, ``inter`` = rails) and per directed link ROLE
(``role_bytes``: one role per ordered server pair, ``inter:0>1`` vs
``inter:1>0``) — the refinement that keeps an asymmetric fabric's
forward and return rails on separate fit lines instead of collapsing
both directions to one "inter" bandwidth.  For a link group ``c`` the
latency model predicts

    t  =  alpha  +  x_c / bw_c  (+ small relay/engine terms)

for every record whose class-``c`` bytes dominate, so an ordinary
least-squares fit of measured time against ``x_c`` over the payload
sweep recovers ``1/bw_c`` as the slope and the startup alpha as the
intercept — the paper's "measured bandwidth of both link types" (§5.2)
obtained from the live system rather than a datasheet.

The fit is guarded: iterative outlier rejection (relative-residual
trim) and a confidence floor (point count, distinct payloads, R²,
positive slope) — an untrusted class contributes nothing, so a noisy or
short sweep degrades to "keep the nominal model" instead of poisoning
the planner.

:func:`fit_measurements` emits exactly the ``measurements`` mapping
``HardwareModel.recalibrated`` accepts: per-link bandwidth overrides for
every link of each trusted class, plus ``alpha_base`` when a relay-free
sweep pinned it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.latency_model import DEFAULT, HardwareModel
from repro_torch.core.plan import BASELINE_PLAN
from repro_torch.core.topology import Topology

from .probe import link_class, link_role
from .store import CalibrationStore, topo_key

LINK_CLASSES = ("intra", "inter")
# minimum points for the overlap-efficiency fit (decision-log rows with
# a measured time AND a non-degenerate serial/ideal bracket)
OVERLAP_MIN_POINTS = 3

# confidence floor defaults: a fit below any of these is not trusted
MIN_POINTS = 3
MIN_DISTINCT_PAYLOADS = 3
R2_FLOOR = 0.9
REL_OUTLIER = 0.35          # relative residual above this is rejected


@dataclasses.dataclass(frozen=True)
class FitResult:
    """One link class's fitted alpha/beta line."""

    link_class: str
    bw: float                  # bytes/s (1 / slope)
    alpha_s: float             # intercept
    n_used: int
    n_total: int
    n_rejected: int
    r2: float
    trusted: bool
    reason: str = ""           # why not trusted (empty when trusted)
    alpha_clean: bool = False  # intercept from relay-free single-stage
    #                            records only (safe to map to alpha_base)

    def report(self) -> dict:
        return {"class": self.link_class, "bw_gbps": self.bw / 1e9,
                "alpha_us": self.alpha_s * 1e6, "n_used": self.n_used,
                "n_rejected": self.n_rejected, "r2": round(self.r2, 4),
                "trusted": self.trusted, "reason": self.reason}


def _least_squares(x: np.ndarray, y: np.ndarray) -> tuple[float, float, float]:
    """(slope, intercept, r2) of y ~ slope*x + intercept."""
    slope, intercept = np.polyfit(x, y, 1)
    pred = slope * x + intercept
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    return float(slope), float(intercept), r2


def _dominant_class(rec: dict) -> str:
    """The link class whose serialization dominates this record — the
    stored bottleneck class (computed against nominal bandwidths at
    probe time)."""
    return rec.get("bottleneck_class", "intra")


def _dominant_role(rec: dict) -> str:
    """The directed link ROLE dominating this record; old-schema records
    without role fields fall back to the class (== role for intra)."""
    return rec.get("bottleneck_role", _dominant_class(rec))


def is_fit_record(rec: dict) -> bool:
    """Only each op's BASELINE plan feeds the regression: baselines are
    pure-serialization probes (t = alpha + bytes/bw, at most a small
    store-and-forward term), while the multiwrite plans add their own
    payload-linear relay/engine terms — points from different plans
    would fall on different lines and collapse the fit.  The fitted
    bandwidths then score EVERY plan through the shared latency model."""
    return rec.get("plan") == BASELINE_PLAN.get(rec.get("op"))


def fit_link_class(records: Sequence[dict], cls: str, *,
                   min_points: int = MIN_POINTS,
                   min_payloads: int = MIN_DISTINCT_PAYLOADS,
                   r2_floor: float = R2_FLOOR,
                   rel_outlier: float = REL_OUTLIER,
                   bytes_field: str = "class_bytes",
                   dominant_fn=None) -> Optional[FitResult]:
    """LS fit of one link GROUP (class or directed role) over the
    records that bottleneck on it.  Returns None when no record
    regresses against this group at all."""
    dominant_fn = dominant_fn or _dominant_class
    xs, ys, clean = [], [], []
    for r in records:
        if dominant_fn(r) != cls:
            continue
        x = float(r.get(bytes_field, {}).get(cls, 0.0))
        if x <= 0:
            continue
        xs.append(x)
        ys.append(float(r["measured_s"]))
        clean.append(not r.get("relayed", True)
                     and int(r.get("stages", 1)) == 1)
    if not xs:
        return None
    x = np.asarray(xs)
    y = np.asarray(ys)
    n_total = len(xs)

    def untrusted(reason, slope=0.0, intercept=0.0, r2=0.0, used=0, rej=0):
        bw = 1.0 / slope if slope > 0 else 0.0
        return FitResult(cls, bw, intercept, used, n_total, rej, r2,
                         trusted=False, reason=reason)

    if n_total < 2:
        return untrusted(f"{n_total} point(s): cannot regress", used=n_total)
    slope, intercept, r2 = _least_squares(x, y)
    keep = np.ones(n_total, bool)
    if slope > 0:
        rel = np.abs(y - (slope * x + intercept)) / np.maximum(y, 1e-12)
        keep = rel <= rel_outlier
        if keep.sum() >= 2 and keep.sum() < n_total:
            slope, intercept, r2 = _least_squares(x[keep], y[keep])
    n_used = int(keep.sum())
    n_rej = n_total - n_used
    if slope <= 0:
        return untrusted("non-positive slope (bw unidentifiable)",
                         slope, intercept, r2, n_used, n_rej)
    if n_used < min_points:
        return untrusted(f"{n_used} < {min_points} points after rejection",
                         slope, intercept, r2, n_used, n_rej)
    if len(np.unique(x[keep])) < min_payloads:
        return untrusted("payload sweep too narrow",
                         slope, intercept, r2, n_used, n_rej)
    if r2 < r2_floor:
        return untrusted(f"r2 {r2:.3f} < floor {r2_floor}",
                         slope, intercept, r2, n_used, n_rej)
    alpha_clean = all(c for c, k in zip(clean, keep) if k)
    return FitResult(cls, 1.0 / slope, max(0.0, intercept), n_used, n_total,
                     n_rej, r2, trusted=True, alpha_clean=alpha_clean)


def fit_link_classes(records: Sequence[dict], *,
                     classes: Sequence[str] = LINK_CLASSES,
                     baseline_only: bool = True,
                     **floor_kw) -> dict[str, FitResult]:
    if baseline_only:
        records = [r for r in records if is_fit_record(r)]
    out = {}
    for cls in classes:
        fit = fit_link_class(records, cls, **floor_kw)
        if fit is not None:
            out[cls] = fit
    return out


def fit_link_roles(records: Sequence[dict], *,
                   baseline_only: bool = True,
                   **floor_kw) -> dict[str, FitResult]:
    """Per-ROLE (directed) alpha/beta fits — the per-link refinement of
    :func:`fit_link_classes`.  Each ordered server pair's rails regress
    on their own line, so an asymmetric fabric (``2x8asym``: the return
    rails run at half bandwidth) fits both directions separately instead
    of collapsing them onto one "inter" slope.  The ``intra`` role is
    identical to the class fit and skipped here."""
    if baseline_only:
        records = [r for r in records if is_fit_record(r)]
    roles = sorted({_dominant_role(r) for r in records
                    if r.get("role_bytes")} - {"intra"})

    def inter_roles(rec: dict) -> list:
        return [k for k, v in rec.get("role_bytes", {}).items()
                if k != "intra" and v > 0]

    out = {}
    for role in roles:
        # a record witnesses a DIRECTED line cleanly only when its
        # ledger charges that one inter direction (the per-direction
        # p2p sweep).  A bidirectional record's measured time is set by
        # whichever direction is truly slower — under asymmetric
        # degradation that need not be the direction carrying the most
        # bytes, so such records sit on the WRONG line and poison the
        # regression (observed: the healthy return direction never
        # reaches a trusted fit, and recalibration churns every cycle).
        # When single-direction evidence exists, regress on it alone;
        # fabrics without direction probes keep the old mixed pool.
        sole = [r for r in records
                if _dominant_role(r) == role and len(inter_roles(r)) == 1]
        pool = sole if sole else records
        fit = fit_link_class(pool, role, bytes_field="role_bytes",
                             dominant_fn=_dominant_role, **floor_kw)
        if fit is not None:
            out[role] = fit
    return out


def fit_measurements(records: Sequence[dict], topo: Topology,
                     **floor_kw) -> tuple[dict, dict[str, FitResult]]:
    """(measurements, fits): the ``measurements`` dict feeds
    ``HardwareModel.recalibrated`` directly — per-link bandwidths for
    every link of each TRUSTED group, plus ``alpha_base`` when a
    relay-free sweep pinned the intercept.  Links take the directed
    per-ROLE fit when one cleared the confidence floor (asymmetric
    fabrics keep both rail directions distinct); the class-level fit is
    the fallback for every link of a NOMINALLY-UNIFORM class, while a
    heterogeneous class's unfitted directions keep their nominal
    bandwidth (see the inline rationale).  The returned ``fits`` dict
    carries both levels (classes under ``intra``/``inter``, roles under
    ``inter:a>b``).  Empty dict = nothing trustworthy, keep the current
    model."""
    fits = fit_link_classes(records, **floor_kw)
    role_fits = fit_link_roles(records, **floor_kw)
    # classes whose NOMINAL link bandwidths are uniform: their links are
    # interchangeable a priori, so the class fit generalizes to every
    # link (incl. directions that never bottlenecked — a uniform
    # degradation on a 4x8 fabric must override ALL 96 inter links even
    # though only a couple of directed roles ever set the max).  A
    # heterogeneous class (asymmetric / mixed-rail fabric) is different:
    # its class line is dominated by whichever direction bottlenecks,
    # carries no evidence about the others, and would mislabel them —
    # there only directed ROLE fits apply and unfitted links keep
    # nominal.
    nominal_by_class: dict[str, set] = {}
    for key, ln in topo.links.items():
        nominal_by_class.setdefault(link_class(topo, *key), set()).add(ln.bw)
    links = {}
    measurements: dict = {}
    for key in topo.links:
        cls = link_class(topo, *key)
        rf = role_fits.get(link_role(topo, *key))
        cf = fits.get(cls)
        if rf is not None and rf.trusted:
            links[key] = rf.bw
        elif cf is not None and cf.trusted and \
                len(nominal_by_class[cls]) == 1:
            links[key] = cf.bw
    intra = fits.get("intra")
    if (intra is not None and intra.trusted and intra.alpha_clean
            and intra.alpha_s > 0):
        measurements["alpha_base"] = intra.alpha_s
    if links:
        measurements["links"] = links
    elif "alpha_base" not in measurements:
        measurements = {}
    return measurements, {**fits, **role_fits}


def fit_overlap_eff(decision_rows: Sequence[dict], *,
                    min_points: int = OVERLAP_MIN_POINTS,
                    rel_span_floor: float = 0.02) -> Optional[float]:
    """Achieved overlap efficiency from ``Planner.decision_log`` rows.

    Every pipelined (``microbatch > 1``) decision is logged with its
    serial (``overlap_eff=0``) and ideal (``overlap_eff=1``) score
    endpoints; a measured execution time landing between them identifies
    the efficiency the pipeline actually achieved:

        eta  =  (serial - measured) / (serial - ideal)

    clamped to [0, 1].  Rows without a measurement, or whose endpoints
    coincide (non-pipelined decisions carry no overlap signal, gated by
    ``rel_span_floor``), contribute nothing.  Returns the MEDIAN eta
    over the contributing rows — robust to the odd straggler-polluted
    measurement — or None below ``min_points`` (keep the current
    calibration).  The result feeds ``HardwareModel.recalibrated`` as
    the ``overlap_eff`` scalar, closing the loop the same way the link
    bandwidth fits do."""
    etas = []
    for row in decision_rows:
        m = row.get("measured_s")
        s = row.get("predicted_serial_s")
        i = row.get("predicted_ideal_s")
        if m is None or not s or i is None:
            continue
        span = float(s) - float(i)
        if span <= rel_span_floor * float(s):
            continue
        etas.append(min(1.0, max(0.0, (float(s) - float(m)) / span)))
    if len(etas) < min_points:
        return None
    return float(np.median(etas))


# ---------------------------------------------------------------------------
# store -> HardwareModel (memoized — the ParallelContext / dryrun surface)
# ---------------------------------------------------------------------------

_HW_CACHE: dict[tuple, HardwareModel] = {}


def calibrated_hw(store: CalibrationStore, topo: Topology,
                  base: HardwareModel = DEFAULT) -> HardwareModel:
    """The hardware model the store's measurements imply for ``topo``:
    ``base`` recalibrated with the fitted per-class bandwidths, or
    ``base`` unchanged when the store has nothing trustworthy for this
    fabric.  Fits use the LATEST record per (op, plan, payload bucket),
    so re-probed buckets supersede stale history.  Memoized on (store
    instance + revision, fabric, base) — distinct ':memory:' stores
    never alias."""
    key = (store.version(), topo.fingerprint(), base.fingerprint())
    hit = _HW_CACHE.get(key)
    if hit is not None:
        return hit
    records = list(store.latest_by_key(fabric=topo_key(topo)).values())
    measurements, _ = fit_measurements(records, topo)
    hw = base.recalibrated(measurements, topo) if measurements else base
    if len(_HW_CACHE) > 64:
        _HW_CACHE.clear()
    _HW_CACHE[key] = hw
    return hw
