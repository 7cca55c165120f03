"""The port's TLS admission boundary (volcano_tpu_torch/webhooks/server.py,
``serve_webhooks``), on the CPU: the six cases of
tests/test_webhook_server.py through the port (the served cases need
``cryptography`` to generate a certificate and skip without it, as the
reference's do), and the wire codec's dicts equal to the JAX package's
for the same job.

Tolerance: exact.
"""

import json
import ssl
import urllib.request

import pytest

from volcano_tpu_torch.client import ClusterStore
from volcano_tpu_torch.webhooks import serve_webhooks
from volcano_tpu_torch.webhooks.server import from_wire, to_wire


@pytest.fixture(scope="module")
def server():
    # self-signed cert bootstrap needs pyca/cryptography, which the
    # runtime image may not carry — TLS coverage skips cleanly there
    pytest.importorskip("cryptography")
    from volcano_tpu_torch.models import Queue, QueueSpec

    cluster = ClusterStore()
    cluster.create("queues", Queue(name="default",
                                   spec=QueueSpec(weight=1)))
    srv = serve_webhooks(cluster, cert_path=None, key_path=None)
    srv.start_background()
    yield srv
    srv.shutdown()


def _post(server, path, review):
    host, port = server.address[:2]
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE  # self-signed in the test
    req = urllib.request.Request(
        f"https://{host}:{port}{path}",
        data=json.dumps(review).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
        return json.loads(resp.read())


def test_tls_cert_generated(server):
    with open(server.cert_path) as f:
        assert "BEGIN CERTIFICATE" in f.read()


def test_mutate_then_validate_job(server):
    from volcano_tpu_torch.models import Job, JobSpec, TaskSpec

    job = Job(name="j1", namespace="d",
              spec=JobSpec(tasks=[TaskSpec(
                  name="", replicas=2, template={
                  "spec": {"containers": [{"name": "c",
                                           "requests": {"cpu": "1"}}]}})]))
    out = _post(server, "/jobs/mutate",
                {"request": {"operation": "CREATE", "kind": "jobs",
                             "object": to_wire(job)}})
    assert out["response"]["allowed"]
    mutated = out["response"]["object"]
    # defaults filled in (mutate_job.go:111-160)
    assert mutated["spec"]["queue"] == "default"
    assert mutated["spec"]["tasks"][0]["name"] == "task-0"
    assert mutated["spec"]["min_available"] == 2

    out = _post(server, "/jobs/validate",
                {"request": {"operation": "CREATE", "kind": "jobs",
                             "object": mutated}})
    assert out["response"]["allowed"]


def test_invalid_job_denied_over_the_wire(server):
    from volcano_tpu_torch.models import Job, JobSpec, TaskSpec

    bad = Job(name="j2", namespace="d",
              spec=JobSpec(min_available=5,
                           tasks=[TaskSpec(
                               name="t", replicas=2, template={
                  "spec": {"containers": [{"name": "c",
                                           "requests": {"cpu": "1"}}]}})]))
    out = _post(server, "/jobs/validate",
                {"request": {"operation": "CREATE", "kind": "jobs",
                             "object": to_wire(bad)}})
    assert not out["response"]["allowed"]
    assert "minAvailable" in out["response"]["status"]["message"]


def test_unknown_path_404(server):
    with pytest.raises(Exception):
        _post(server, "/nope", {"request": {}})


def test_wire_codec_roundtrip():
    from volcano_tpu_torch.models import Job, JobSpec, LifecyclePolicy, TaskSpec

    job = Job(name="j", namespace="n", spec=JobSpec(
        min_available=1, queue="q",
        tasks=[TaskSpec(name="t", replicas=3)],
        policies=[LifecyclePolicy(action="RestartJob", event="PodFailed")]))
    back = from_wire(Job, to_wire(job))
    assert back.spec.tasks[0].replicas == 3
    assert back.spec.policies[0].action == "RestartJob"
    assert back.spec.queue == "q"


def test_wire_dicts_equal_the_jax_package():
    pytest.importorskip("jax")  # the JAX reference
    from torch_helpers import pkg_mod

    def wire(pkg):
        m = pkg_mod(pkg, "models")
        job = m.Job(name="j", namespace="n", uid="job-j",
                    creation_timestamp=3.0, spec=m.JobSpec(
                        min_available=2, queue="q",
                        tasks=[m.TaskSpec(name="t", replicas=3)],
                        policies=[m.LifecyclePolicy(
                            action=m.Action.RESTART_JOB,
                            event=m.Event.POD_FAILED)]))
        job.status.state.last_transition_time = 4.0
        server = pkg_mod(pkg, "webhooks.server")
        return server.to_wire(job), server.from_wire(
            type(job), server.to_wire(job))

    (tw, tback), (jw, jback) = wire("torch"), wire("jax")
    assert json.dumps(tw, sort_keys=True) == json.dumps(jw, sort_keys=True)
    assert json.dumps(pkg_mod("jax", "webhooks.server").to_wire(jback),
                      sort_keys=True) == json.dumps(
        pkg_mod("torch", "webhooks.server").to_wire(tback), sort_keys=True)


class TestMutualTLS:
    """client_ca_path (wired by installer/volcano-tpu-development.yaml):
    an uncerted client must be rejected at the TLS layer; a client
    presenting a cert signed by the CA drives admission normally."""

    def test_uncerted_client_rejected_certed_accepted(self, tmp_path):
        pytest.importorskip("cryptography")
        from volcano_tpu_torch.client import ClusterStore
        from volcano_tpu_torch.models import Queue, QueueSpec
        from volcano_tpu_torch.webhooks.server import generate_self_signed_cert

        # a self-signed client cert doubles as its own CA
        client_cert, client_key = generate_self_signed_cert(
            str(tmp_path), common_name="admission-client")
        cluster = ClusterStore()
        cluster.create("queues", Queue(name="default",
                                       spec=QueueSpec(weight=1)))
        srv = serve_webhooks(cluster, client_ca_path=client_cert)
        srv.start_background()
        try:
            host, port = srv.address[:2]
            review = {"request": {"operation": "CREATE", "object": {
                "name": "q2", "spec": {"weight": 2}}}}
            url = f"https://{host}:{port}/queues/validate"

            # no client cert: rejected at the TLS layer. TLS1.3 surfaces
            # the rejection either at handshake (SSLError) or at first
            # write (urllib wraps it in URLError) — but never as an HTTP
            # response: the request must not reach admission
            import urllib.error
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            req = urllib.request.Request(
                url, data=json.dumps(review).encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises((ssl.SSLError,
                                urllib.error.URLError)) as ei:
                urllib.request.urlopen(req, context=ctx, timeout=10)
            assert not isinstance(ei.value, urllib.error.HTTPError)

            # with the cert: admission answers
            ctx2 = ssl.create_default_context()
            ctx2.check_hostname = False
            ctx2.verify_mode = ssl.CERT_NONE
            ctx2.load_cert_chain(client_cert, client_key)
            with urllib.request.urlopen(
                    urllib.request.Request(
                        url, data=json.dumps(review).encode(),
                        headers={"Content-Type": "application/json"}),
                    context=ctx2, timeout=10) as resp:
                body = json.loads(resp.read())
            assert body["response"]["allowed"] is True
        finally:
            srv.shutdown()
