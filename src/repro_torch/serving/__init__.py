"""Serving tier: request queue, admission and the iteration-level
scheduler (own copies of the reference's ``repro.serving``, engine mode)."""

from repro_torch.serving.admission import AdmissionController, AdmissionDecision
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.scheduler import BatchScheduler, batch_bucket

__all__ = ["AdmissionController", "AdmissionDecision", "BatchScheduler",
           "Request", "RequestQueue", "batch_bucket"]
