"""Parallelism context: the fixed-policy subset of the reference's
``src/repro/parallel/context.py::ParallelContext``.

A :class:`ParallelContext` travels with a model.  ``pctx=None`` means one
rank.  Axis roles over a :class:`~repro_torch.parallel.mesh.RankMesh`:

  pod    slow axis: data parallel, and the outer level of the MultiWrite
         hierarchical EP dispatch;
  data   fast axis: data parallel, and EP for MoE layers;
  model  tensor parallel (only a size of 1 is ported).

Only ``plan_policy="fixed"`` is ported: ``moe_scheme`` and ``moe_combine``
are taken verbatim and the pipeline runs one chunk.  The planner, the plan
IR, ``plan_policy="auto"`` and the G > 1 chunk pipeline are the next slice
of the port (queue 1 item 3); asking for any of them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.parallel.mesh import RankMesh

_PLANNER_SLICE = ("is the planner slice of the port (queue 1 item 3); this "
                  "slice takes plan_policy='fixed' only")


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: RankMesh
    pod_axis: Optional[str] = None    # None on a single-pod mesh
    data_axis: str = "data"
    model_axis: str = "model"
    plan_policy: str = "fixed"
    moe_scheme: str = "hierarchical"  # hierarchical (MultiWrite) | baseline
    moe_combine: Optional[str] = None  # hierarchical | baseline | None =
    #                                    follow moe_scheme
    moe_microbatch: int = 1           # dispatch chunks G (1 only)
    moe_deferred_tp_reduce: bool = False
    execution_plan: Optional[object] = None
    fabric: Optional[object] = None
    calibration: Optional[object] = None

    def __post_init__(self):
        if self.plan_policy != "fixed":
            raise NotImplementedError(
                f"plan_policy={self.plan_policy!r} {_PLANNER_SLICE}")
        for name in ("execution_plan", "fabric", "calibration"):
            if getattr(self, name) is not None:
                raise NotImplementedError(f"{name} {_PLANNER_SLICE}")
        if self.moe_microbatch != 1:
            raise NotImplementedError(
                f"moe_microbatch={self.moe_microbatch}: the G > 1 chunk "
                f"pipeline {_PLANNER_SLICE}")
        if self.moe_deferred_tp_reduce or self.model_size != 1:
            raise NotImplementedError(
                "tensor parallelism inside experts (model axis above 1, "
                "moe_deferred_tp_reduce) is queue 1 item 6 of the port")
        if self.moe_scheme not in ("hierarchical", "baseline"):
            raise ValueError(f"moe_scheme {self.moe_scheme!r}")
        if self.moe_combine not in (None, "hierarchical", "baseline"):
            raise ValueError(f"moe_combine {self.moe_combine!r}")
        if self.pod_axis is None and self.mesh.axis_size("pod") != 1:
            raise ValueError("a mesh with pods needs pod_axis='pod'")

    # -- derived -------------------------------------------------------------
    @property
    def dp_axes(self) -> tuple[str, ...]:
        return ((self.pod_axis, self.data_axis) if self.pod_axis
                else (self.data_axis,))

    @property
    def num_pods(self) -> int:
        return self.mesh.axis_size(self.pod_axis) if self.pod_axis else 1

    @property
    def data_size(self) -> int:
        return self.mesh.axis_size(self.data_axis)

    @property
    def model_size(self) -> int:
        return self.mesh.axis_size(self.model_axis)

    @property
    def dp_size(self) -> int:
        return self.mesh.axis_size(*self.dp_axes)

    @property
    def dp_index(self) -> int:
        """Which data-parallel rows are this rank's: pod * data + d."""
        return self.mesh.axis_index(*self.dp_axes)

    def ep_ranks(self, num_experts: int) -> tuple[bool, int]:
        """(use_pod_axis, total EP ranks) for an MoE layer: EP spans the pod
        axis only when there are enough experts (the paper's large-EP
        regime); otherwise EP = data axis and pod stays pure DP."""
        if self.pod_axis and num_experts >= self.num_pods * self.data_size:
            return True, self.num_pods * self.data_size
        return False, self.data_size

    # -- the MoE round trip ----------------------------------------------------
    def moe_pipeline_kwargs(self) -> dict:
        """``{"moe_scheme", "moe_combine"}`` of every MoE layer under
        ``plan_policy="fixed"``: the declared knobs, normalized as the
        reference's ``_norm_moe_kwargs`` does.  The combine follows the
        dispatch scheme unless set, and the baseline (unicast) dispatch
        forces the unicast return path (no relay state exists for a
        relay-reduced combine).  The pipeline runs one chunk."""
        combine = self.moe_combine or self.moe_scheme
        if self.moe_scheme == "baseline":
            combine = "baseline"
        return {"moe_scheme": self.moe_scheme, "moe_combine": combine}
