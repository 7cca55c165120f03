"""Pod admission gate (reference webhooks/admission/pods/admit_pod.go:39-130).

Pods belonging to a PodGroup that has not reached Inqueue are rejected:
this delays pod creation until the scheduler admits the gang, keeping
cluster pressure proportional to admitted work.
"""

from __future__ import annotations

from ..api.types import POD_GROUP_ANNOTATION
from ..client.store import AdmissionError
from ..models import Pod, PodGroupPhase
from .router import AdmissionService, register_admission_service


def validate_pod(verb: str, pod: Pod, cluster,
                 opts=None) -> Pod:
    if verb != "create":
        return pod
    # scope to the CONFIGURED scheduler name (admit_pod.go checks the
    # configured scheduler-names list): under --scheduler-name the gate
    # must follow the renamed control plane, not the literal default
    scheduler_name = opts.scheduler_name if opts is not None else "volcano"
    if pod.scheduler_name != scheduler_name:
        return pod
    pg_name = (pod.annotations or {}).get(POD_GROUP_ANNOTATION)
    if not pg_name:
        return pod  # bare pod: podgroup controller will wrap it
    pg = cluster.try_get("podgroups", pg_name, pod.namespace)
    if pg is None:
        return pod  # group not created yet; controller orders creation
    if pg.status.phase == PodGroupPhase.PENDING:
        raise AdmissionError(
            f"failed to create pod <{pod.namespace}/{pod.name}>, "
            f"because the podgroup phase is Pending")
    return pod


def register() -> None:
    register_admission_service(AdmissionService(
        path="/pods/validate", kind="pods", verbs=["create"],
        func=validate_pod))
