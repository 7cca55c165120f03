"""The port's deployed process table on the CPU: the control plane
(``python -m volcano_tpu_torch.standalone --device cpu --sidecar SOCK``)
beside its solver sidecar (``python -m volcano_tpu_torch.parallel.sidecar
SOCK``), as installer_torch/ deploys them.

- A control plane built as the binary builds it with ``--sidecar``
  schedules nothing on the host before its sidecar first answers: each
  cycle's allocate fails with the typed reason ``sidecar_unavailable``
  and the breaker counts it; once a server answers, the next cycle binds
  through it. This deliberately deviates from the JAX package, whose
  client finishes such a cycle on the host oracle (ROADMAP Queue C).
- A client expecting the card raises on a reply naming another device;
  preempt through a sidecar that is not there raises too.
- The server creates its socket only after its device setup, and
  removes it when it stops; ``Standalone.run`` holds its first turn until
  the socket exists.
- The admission server's certificate: its key, names and file modes.

No JAX twin: the JAX package falls back to the host here by design. A
server on the CPU stands in for the card's by naming ``cuda:0`` in its
replies (no card here; phase ``deploy`` of chip_smoke.py runs the real
pair on one).
"""

from __future__ import annotations

import os
import signal
import socket
import ssl
import threading
import time

import pytest

from torch_helpers import build_node, build_pod, build_pod_group, pkg_mod
from test_torch_sidecar import _preempt


def _control_plane(path):
    """The Standalone the binary builds from ``--device cpu --sidecar
    PATH`` (inline binds, no metrics port), with 4 nodes and an enqueued
    2-pod gang in its store."""
    from volcano_tpu_torch.standalone import Standalone
    sa = Standalone(device="cpu", sidecar_path=path, metrics_port=0,
                    async_effectors=False)
    m = pkg_mod("torch", "models")
    ann = pkg_mod("torch", "api").POD_GROUP_ANNOTATION
    for i in range(4):
        sa.store.create("nodes", build_node(m, f"n{i}", {
            "cpu": "4", "memory": "8Gi"}))
    sa.store.create("podgroups", build_pod_group(
        m, "pg", "default", 2, "default", phase=m.PodGroupPhase.INQUEUE))
    for i in range(2):
        sa.store.create("pods", build_pod(
            m, ann, "default", f"p{i}", "", "Pending",
            {"cpu": "1", "memory": "1Gi"}, "pg"))
    return sa


def _bound(sa) -> dict:
    return {p.name: p.node_name for p in sa.store.list("pods")
            if p.node_name}


def _serve(path, device_name=None):
    """A port SolverServer on the CPU in a daemon thread, its replies
    naming ``device_name`` when given."""
    sc = pkg_mod("torch", "parallel.sidecar")
    server = sc.SolverServer(path, device="cpu")
    if device_name is not None:
        server.device_name = device_name
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    deadline = time.time() + 30
    while True:
        # a connection, not the file: a dead server's file may be there
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.connect(path)   # the server accepts it and sees EOF
            break
        except OSError:
            assert time.time() < deadline and th.is_alive()
            time.sleep(0.01)
        finally:
            probe.close()
    return th, server


def _dead_socket(path):
    """The socket file a server killed by SIGKILL leaves: nothing
    listens on it."""
    dead = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    dead.bind(path)
    dead.close()
    assert os.path.exists(path)


def _stop(th, server, client=None):
    if client is not None:
        client.close()   # the server leaves a connection at its EOF
    server.stop()
    th.join(timeout=10)
    assert not th.is_alive()


@pytest.mark.parametrize("socket_file", ["missing", "stale"])
def test_no_host_bind_before_the_sidecar_answers(tmp_path, socket_file):
    """No sidecar yet, or only the socket a killed one left: each cycle
    fails typed and binds nothing until a server answers."""
    path = str(tmp_path / "solver.sock")
    if socket_file == "stale":
        _dead_socket(path)
    sa = _control_plane(path)
    try:
        for k in (1, 2):
            sa.scheduler.run_once()
            t = sa.scheduler.last_cycle_timing
            assert _bound(sa) == {}
            assert t.get("allocate_error") == 1.0
            assert t["allocate_fault_reason"] == "sidecar_unavailable"
            assert "host_fallback" not in t
            assert sa.cache.breaker._consecutive_failures == k
        assert sa.cache.sidecar.on_card and sa.cache.sidecar.device is None
        th, server = _serve(path, device_name="cuda:0")
        try:
            sa.scheduler.run_once()
        finally:
            _stop(th, server, sa.cache.sidecar)
        t = sa.scheduler.last_cycle_timing
        assert len(_bound(sa)) == 2
        assert "host_fallback" not in t and "allocate_error" not in t
        assert t["sidecar_shipped_chunks"] > 0 and "sidecar_launches" in t
        assert sa.cache.sidecar.device == "cuda:0"
        assert sa.cache.breaker._consecutive_failures == 0
        assert server.answered == 1
    finally:
        sa.stop()


def test_breaker_opens_typed_while_the_sidecar_is_gone(tmp_path):
    """Past the breaker's threshold the cycle is refused typed, still
    without a host bind."""
    path = str(tmp_path / "solver.sock")
    sa = _control_plane(path)
    try:
        for _ in range(sa.cache.breaker.failure_threshold):
            sa.scheduler.run_once()
        assert sa.cache.breaker.state == "open"
        sa.scheduler.run_once()
        t = sa.scheduler.last_cycle_timing
        assert t["allocate_fault_reason"] == "breaker_open"
        assert t.get("allocate_error") == 1.0 and "host_fallback" not in t
        assert t["breaker_state"] == 2.0 and _bound(sa) == {}
    finally:
        sa.stop()


def test_preempt_through_a_missing_sidecar_raises(tmp_path):
    sc = pkg_mod("torch", "parallel.sidecar")
    client = sc.SidecarSolver(str(tmp_path / "none.sock"), device="cuda")
    with pytest.raises(sc.SidecarUnavailable) as e:
        _preempt("torch", client)
    assert e.value.reason == "sidecar_unavailable"


def test_the_client_expects_the_card_by_default(tmp_path):
    sc = pkg_mod("torch", "parallel.sidecar")
    client = sc.SidecarSolver(str(tmp_path / "s.sock"))
    assert client.expected == "cuda" and client.on_card
    assert client.device is None


@pytest.mark.parametrize("expected,named,ok", [
    ("cuda", "cuda:0", True), ("cuda", None, False), ("cuda", "cpu", False),
    (None, "cpu", True)])
def test_a_reply_naming_another_device_raises(tmp_path, expected, named,
                                              ok):
    """A client built expecting a device holds every reply to it; one
    built without keeps learning the device from the replies."""
    from test_torch_sidecar import _problem
    sc = pkg_mod("torch", "parallel.sidecar")
    path = str(tmp_path / "s.sock")
    th, server = _serve(path)
    server.device_name = named or ""
    client = sc.SidecarSolver(path, device=expected)
    assert client.on_card == (expected == "cuda")
    (fbuf, ibuf, layout), params = _problem()
    try:
        if ok:
            a, _, info = client.solve(fbuf, ibuf, layout, params)
            assert (a >= 0).any() and info["shipped_chunks"] > 0
        else:
            with pytest.raises(sc.SidecarDeviceMismatch):
                client.solve(fbuf, ibuf, layout, params)
    finally:
        _stop(th, server, client)
    assert client.device == (named or None)


def test_socket_appears_only_after_device_setup(tmp_path):
    """``serve_forever`` binds only once ``prepare`` returned, and the
    socket is gone once the server stopped; the control plane's ``run``
    holds its first turn until the socket exists."""
    sc = pkg_mod("torch", "parallel.sidecar")
    path = str(tmp_path / "s.sock")
    server = sc.SolverServer(path, device="cpu")
    release, entered = threading.Event(), threading.Event()
    prepare = server.prepare

    def slow_prepare():
        entered.set()
        assert release.wait(30)
        prepare()

    server.prepare = slow_prepare
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    assert entered.wait(30)
    time.sleep(0.2)
    assert not os.path.exists(path)
    sa = _control_plane(path)
    turns = []
    sa.run_once = lambda drain_effects=True: (turns.append(1),
                                              sa._stop.set())
    runner = threading.Thread(target=sa.run, daemon=True)
    try:
        runner.start()
        time.sleep(0.3)
        assert turns == [] and runner.is_alive()
        release.set()
        runner.join(timeout=30)
        assert not runner.is_alive() and turns == [1]
        assert os.path.exists(path)
    finally:
        release.set()
        sa.stop()
        _stop(th, server)
    assert not os.path.exists(path)


def test_the_binary_removes_a_dead_servers_socket_first(tmp_path,
                                                        monkeypatch):
    """The sidecar binary removes the socket a killed predecessor left
    before its device setup (a readiness probe tests for the file), then
    serves, and exits 0 with the socket gone."""
    sc = pkg_mod("torch", "parallel.sidecar")
    path = str(tmp_path / "solver.sock")
    _dead_socket(path)
    seen = []

    class CpuServer(sc.SolverServer):
        def __init__(self, p):
            super().__init__(p, device="cpu")

        def prepare(self):
            seen.append(os.path.exists(path))
            super().prepare()

    def shut_down():
        client = sc.SidecarSolver(path, device=None)
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                client.shutdown_server()
                return
            except OSError:
                time.sleep(0.01)

    monkeypatch.setattr(sc, "SolverServer", CpuServer)
    # the binary's SIGTERM handler stays out of the test process
    monkeypatch.setattr(signal, "signal", lambda *args: None)
    stopper = threading.Thread(target=shut_down, daemon=True)
    stopper.start()
    assert sc.main([path]) == 0
    stopper.join(timeout=30)
    assert seen == [False] and not os.path.exists(path)


def test_webhook_certificate_key_and_names(tmp_path):
    """The admission server's certificate: a 2048-bit RSA key in a 0600
    file under a 0700 directory, self-signed for its CN with the SANs
    localhost and the CN (the image holds ``cryptography``)."""
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.serialization import (
        load_pem_private_key)

    from volcano_tpu_torch.webhooks.server import generate_self_signed_cert
    cert, key = generate_self_signed_cert(str(tmp_path / "certs"),
                                          common_name="vt-webhook")
    decoded = ssl._ssl._test_decode_cert(cert)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)   # the key is the certificate's
    with open(key, "rb") as f:
        bits = load_pem_private_key(f.read(), password=None).key_size
    assert {"subject": decoded["subject"], "issuer": decoded["issuer"],
            "san": decoded["subjectAltName"], "bits": bits,
            "mode": os.stat(key).st_mode & 0o777,
            "dir_mode": os.stat(os.path.dirname(key)).st_mode & 0o777} == {
        "subject": ((("commonName", "vt-webhook"),),),
        "issuer": ((("commonName", "vt-webhook"),),),
        "san": (("DNS", "localhost"), ("DNS", "vt-webhook")),
        "bits": 2048, "mode": 0o600, "dir_mode": 0o700}


@pytest.mark.cuda
def test_card_server_binds_once_its_kernel_is_loaded(tmp_path):
    """On the card the server loads the kernel library (building it if
    needed) and opens the CUDA context before its socket exists."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from volcano_tpu_torch.ops import fused_choice as fc
    from test_torch_sidecar import _problem
    sc = pkg_mod("torch", "parallel.sidecar")
    path = str(tmp_path / "card.sock")
    server = sc.SolverServer(path)
    server.bind()
    assert os.path.exists(path) and fc._lib is not None
    assert server.build_s is not None and server.device_name.startswith(
        "cuda")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    client = sc.SidecarSolver(path, device="cuda")
    (fbuf, ibuf, layout), params = _problem(n_nodes=64, n_jobs=16,
                                            tasks_per_job=8)
    try:
        _, _, info = client.solve(fbuf, ibuf, layout, params)
    finally:
        _stop(th, server, client)
    assert info["launches"] > 0 and client.device.startswith("cuda")
    assert not os.path.exists(path)
