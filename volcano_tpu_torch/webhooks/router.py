"""Admission router (reference pkg/webhooks/router/admission.go:30).

AdmissionServices register (kind, verbs, func); the WebhookManager adapts
them onto the ClusterStore's interceptor chain — the in-process equivalent
of the reference's HTTPS ValidatingWebhookConfiguration path. A real
deployment would serve the same handlers over TLS.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List

from ..client.store import AdmissionError, ClusterStore


@dataclass
class AdmissionOptions:
    """Per-control-plane admission config (the webhook-manager binary's
    flags): instance state, NOT module globals, so multiple control
    planes in one process can't clobber each other."""
    scheduler_name: str = "volcano"
    default_queue: str = "default"


@dataclass
class AdmissionService:
    path: str
    kind: str                     # store bucket name, e.g. "jobs"
    verbs: List[str]              # subset of {create, update, delete}
    func: Callable                # (verb, obj, store, opts) -> obj (raise AdmissionError to deny)


_services: List[AdmissionService] = []


def register_admission_service(svc: AdmissionService) -> None:
    _services.append(svc)


def list_services() -> List[AdmissionService]:
    return list(_services)


class WebhookManager:
    """cmd/webhook-manager equivalent: binds every registered admission
    service to a cluster store."""

    def __init__(self, cluster: ClusterStore, scheduler_name: str = "volcano",
                 default_queue: str = "default"):
        self.cluster = cluster
        self.scheduler_name = scheduler_name
        self.opts = AdmissionOptions(scheduler_name=scheduler_name,
                                     default_queue=default_queue)

    def run(self) -> None:
        cluster = self.cluster
        opts = self.opts

        def interceptor(verb: str, kind: str, obj):
            for svc in _services:
                if svc.kind == kind and verb in svc.verbs:
                    obj = svc.func(verb, obj, cluster, opts)
            return obj

        cluster.add_interceptor(interceptor)
