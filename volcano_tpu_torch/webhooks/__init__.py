"""Admission webhooks (reference pkg/webhooks), in process: the
services run as the store's interceptor chain (``start_webhooks``). The
TLS admission server (``serve_webhooks``) arrives with the networked
client."""

from . import jobs, pods, queues  # noqa: F401
from .router import (  # noqa: F401
    AdmissionService, WebhookManager, list_services,
    register_admission_service,
)

_registered = False


def register_all() -> None:
    global _registered
    if _registered:
        return
    jobs.register()
    pods.register()
    queues.register()
    _registered = True


def start_webhooks(cluster, scheduler_name: str = "volcano",
                   default_queue: str = "default") -> WebhookManager:
    """Register all admission services and bind them to the store."""
    register_all()
    wm = WebhookManager(cluster, scheduler_name,
                        default_queue=default_queue)
    wm.run()
    return wm
