"""HTTPS admission boundary (reference cmd/webhook-manager/app/
{server.go:37-98, certificate.go}).

The in-process interceptor chain (router.WebhookManager) is the test seam;
this module is the served network boundary the reference deploys: a TLS
server exposing every registered AdmissionService at its path, speaking an
AdmissionReview-shaped JSON protocol:

    request:  {"request": {"operation": "CREATE"|"UPDATE"|"DELETE",
                           "kind": "<store bucket>", "object": {...}}}
    response: {"response": {"allowed": bool, "status": {"message": str},
                            "object": {...}}}   # object = mutated result

Certificates are generated self-signed at startup when not supplied
(certificate.go does the same CA bootstrap); objects cross the wire as
plain JSON and are rebuilt into the typed models via the dataclass codec
below (the reference gets this from k8s codegen).
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import ssl
import threading
import typing
from typing import Optional, Tuple

from ..client.store import AdmissionError
from .router import list_services


# -- dataclass <-> dict codec ------------------------------------------------

def to_wire(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_wire(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    if isinstance(obj, bytes):
        return obj.decode("latin1")
    if hasattr(obj, "value") and obj.__class__.__module__.endswith(
            ("scheduling", "bus", "batch")):
        return obj.value  # enums
    return obj


def _resolve(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return _resolve(args[0]) if len(args) == 1 else (None, None)
    return tp, origin


def from_wire(tp, data):
    """Best-effort reconstruction of a (possibly nested) dataclass from
    plain JSON; unknown keys are dropped, enums coerced by value."""
    tp, origin = _resolve(tp)
    if data is None or tp is None:
        return data
    if dataclasses.is_dataclass(tp):
        if not isinstance(data, dict):
            return data
        hints = typing.get_type_hints(tp)
        kwargs = {}
        for f in dataclasses.fields(tp):
            if f.name in data:
                kwargs[f.name] = from_wire(hints.get(f.name), data[f.name])
        return tp(**kwargs)
    if isinstance(tp, type) and issubclass(tp, __import__("enum").Enum):
        try:
            return tp(data)
        except ValueError:
            return data
    if origin in (list, tuple):
        (item_tp,) = typing.get_args(tp) or (None,)
        return [from_wire(item_tp, v) for v in data]
    if origin is dict:
        return data
    return data


#: wire kind -> model class (the store bucket names admission services use)
def _model_for(kind: str):
    from .. import models

    return {
        "jobs": models.Job,
        "pods": models.Pod,
        "queues": models.Queue,
        "podgroups": models.PodGroup,
        "commands": models.Command,
    }.get(kind)


# -- self-signed certificates (certificate.go) -------------------------------

def generate_self_signed_cert(cert_dir: Optional[str] = None,
                              common_name: str = "volcano-webhook"
                              ) -> Tuple[str, str]:
    """Write key.pem/cert.pem under cert_dir (a fresh private tmpdir when
    None); returns their paths. The key file is owner-readable only."""
    import datetime
    import os
    import tempfile

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("localhost"), x509.DNSName(common_name)]),
                critical=False)
            .sign(key, hashes.SHA256()))
    if cert_dir is None:
        cert_dir = tempfile.mkdtemp(prefix="volcano-webhook-certs-")
    else:
        os.makedirs(cert_dir, mode=0o700, exist_ok=True)
        os.chmod(cert_dir, 0o700)
    key_path = os.path.join(cert_dir, "key.pem")
    cert_path = os.path.join(cert_dir, "cert.pem")
    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    return cert_path, key_path


# -- the served boundary -----------------------------------------------------

class AdmissionServer:
    """TLS admission server over the registered AdmissionServices.

    Client authentication: pass ``client_ca_path`` to require mutual TLS
    (the reference's webhook is authenticated by the API server; a bare
    deployment of this one would otherwise accept admission traffic from
    anyone who can reach the port — ADVICE r2 #5). The default, no client
    verification, is for dev/loopback use only — the default bind address
    stays 127.0.0.1 for that reason.
    """

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0,
                 cert_path: Optional[str] = None,
                 key_path: Optional[str] = None,
                 cert_dir: Optional[str] = None,
                 client_ca_path: Optional[str] = None,
                 opts=None):
        from .router import AdmissionOptions

        if cert_path is None or key_path is None:
            cert_path, key_path = generate_self_signed_cert(cert_dir)
        self.cert_path = cert_path
        self.cluster = cluster
        opts = opts or AdmissionOptions()
        services = {svc.path: svc for svc in list_services()}

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                svc = services.get(self.path)
                if svc is None:
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    review = json.loads(self.rfile.read(length))
                    req = review.get("request") or {}
                    verb = (req.get("operation") or "CREATE").lower()
                    model = _model_for(svc.kind)
                    obj = from_wire(model, req.get("object"))
                    if verb in svc.verbs:
                        out = svc.func(verb, obj, cluster, opts)
                    else:
                        # verbs the service didn't register for pass
                        # through unchanged, like the interceptor chain
                        out = obj
                    body = {"response": {"allowed": True,
                                         "object": to_wire(out)}}
                except AdmissionError as e:
                    body = {"response": {"allowed": False,
                                         "status": {"message": str(e)}}}
                except Exception as e:  # noqa: BLE001 — malformed review
                    body = {"response": {"allowed": False,
                                         "status": {"message":
                                                    f"bad request: {e}"}}}
                raw = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert_path, key_path)
        if client_ca_path is not None:
            # mutual TLS: only clients presenting a cert signed by this
            # CA may drive admission
            ctx.load_verify_locations(cafile=client_ca_path)
            ctx.verify_mode = ssl.CERT_REQUIRED
        self._httpd.socket = ctx.wrap_socket(self._httpd.socket,
                                             server_side=True)
        self.address = self._httpd.server_address

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        th = threading.Thread(target=self.serve_forever, daemon=True)
        th.start()
        return th

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
