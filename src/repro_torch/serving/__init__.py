"""Serving tier: request queue, seeded traffic, planner-informed admission
and the iteration-level scheduler (own copies of the reference's
``repro.serving``; the scheduler drives a live ``ServeEngine`` or, with
``engine=None``, simulates on the planner's predicted step times)."""

from repro_torch.core.plan import batch_bucket
from repro_torch.serving.admission import (AdmissionController,
                                           AdmissionDecision, PlannerProbe)
from repro_torch.serving.queue import DEADLINE_CLASSES, Request, RequestQueue
from repro_torch.serving.scheduler import BatchScheduler
from repro_torch.serving.traffic import TrafficConfig, TrafficGenerator

__all__ = ["AdmissionController", "AdmissionDecision", "BatchScheduler",
           "DEADLINE_CLASSES", "PlannerProbe", "Request", "RequestQueue",
           "TrafficConfig", "TrafficGenerator", "batch_bucket"]
