"""Admission webhooks (reference pkg/webhooks): in process, the services
run as the store's interceptor chain (``start_webhooks``); over the wire,
``serve_webhooks`` serves them as the reference's TLS webhook-manager
does (``cryptography`` is imported only to generate a certificate)."""

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


def serve_webhooks(cluster, host: str = "127.0.0.1", port: int = 0,
                   cert_path=None, key_path=None, client_ca_path=None,
                   scheduler_name: str = "volcano",
                   default_queue: str = "default"):
    """Register all admission services and serve them over TLS (the
    reference's webhook-manager deployment shape). Returns the server;
    call .start_background() or .serve_forever(). Pass client_ca_path to
    require mutual TLS — any non-loopback deployment should (the k8s
    manifest wires it)."""
    from .router import AdmissionOptions
    from .server import AdmissionServer

    register_all()
    return AdmissionServer(cluster, host=host, port=port,
                           cert_path=cert_path, key_path=key_path,
                           client_ca_path=client_ca_path,
                           opts=AdmissionOptions(
                               scheduler_name=scheduler_name,
                               default_queue=default_queue))
