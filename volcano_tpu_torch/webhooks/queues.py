"""Queue admission (reference webhooks/admission/queues/).

Validate: weight >= 1, consistent hierarchy path/weights, no deletion
while podgroups reference the queue, no deleting/modifying protected
states. Mutate: default weight, reclaimable, normalized hierarchy
annotations.
"""

from __future__ import annotations

from ..api.types import HIERARCHY_ANNOTATION, HIERARCHY_WEIGHT_ANNOTATION
from ..client.store import AdmissionError
from ..models import Queue
from .router import AdmissionService, register_admission_service


def validate_queue(verb: str, queue: Queue, cluster,
                   opts=None) -> Queue:
    if verb == "delete":
        # protect the CONFIGURED default queue (the reference protects its
        # configured default): with --default-queue=team-x, deleting
        # team-x would break every queue-less job submission
        default_queue = opts.default_queue if opts is not None else "default"
        if queue.name == default_queue:
            raise AdmissionError(
                f"`{default_queue}` queue can not be deleted")
        for pg in cluster.list("podgroups"):
            if (pg.spec.queue or "default") == queue.name:
                raise AdmissionError(
                    f"queue {queue.name} has podgroup bound to it, "
                    f"cannot be deleted")
        return queue

    if queue.spec.weight < 1:
        raise AdmissionError("'weight' must be >= 1")
    hierarchy = (queue.annotations or {}).get(HIERARCHY_ANNOTATION)
    weights = (queue.annotations or {}).get(HIERARCHY_WEIGHT_ANNOTATION)
    if hierarchy or weights:
        if not (hierarchy and weights):
            raise AdmissionError(
                "both hierarchy and hierarchy-weights must be set")
        paths = hierarchy.split("/")
        wparts = weights.split("/")
        if len(paths) != len(wparts):
            raise AdmissionError(
                f"hierarchy {hierarchy} and weights {weights} must have "
                f"the same depth")
        for w in wparts:
            try:
                if float(w) <= 0:
                    raise ValueError
            except ValueError:
                raise AdmissionError(
                    f"hierarchy weight {w!r} must be a positive number")
        if paths[0] != "root":
            raise AdmissionError("hierarchy must start from 'root'")
        # a queue's path must not be a prefix of another queue's path
        for other in cluster.list("queues"):
            if other.name == queue.name:
                continue
            oh = (other.annotations or {}).get(HIERARCHY_ANNOTATION)
            if not oh:
                continue
            if oh.startswith(hierarchy + "/") or hierarchy.startswith(oh + "/"):
                raise AdmissionError(
                    f"hierarchy {hierarchy} conflicts with queue "
                    f"{other.name}'s hierarchy {oh}")
    return queue


def mutate_queue(verb: str, queue: Queue, cluster,
                 opts=None) -> Queue:
    if verb != "create":
        return queue
    if not queue.spec.weight:
        queue.spec.weight = 1
    if queue.spec.reclaimable is None:
        queue.spec.reclaimable = True
    return queue


def register() -> None:
    register_admission_service(AdmissionService(
        path="/queues/mutate", kind="queues", verbs=["create"],
        func=mutate_queue))
    register_admission_service(AdmissionService(
        path="/queues/validate", kind="queues", verbs=["create", "delete"],
        func=validate_queue))
