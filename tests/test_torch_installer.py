"""installer_torch/, the port's deployment beside installer/ (the JAX
package's), on the CPU.

- TestInstallerRender: tests/test_admission_cli.py's TestInstallerRender
  retargeted at installer_torch/helm — the render stream parses, the
  committed renders are byte-identical fresh renders, a values overlay
  works from another cwd, and the placeholder CA is valid PEM (admission
  fails closed).
- The deployment runs the port only: no file names a module of the JAX
  package, ``JAX_PLATFORMS`` or a TPU resource; the solver asks for one
  NVIDIA GPU and the control plane for none; ``--device cpu`` stands
  beside every ``--sidecar``; every command line of the compose file and
  of the rendered manifest parses with the port's own parsers.
- The control plane's readiness probe reaches its metrics server, which
  binds 127.0.0.1, from inside the container.
"""

from __future__ import annotations

import os
import re
import shlex
import ssl
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parent.parent
INSTALLER = ROOT / "installer_torch"
RENDER = INSTALLER / "helm" / "render.sh"
MANIFEST = INSTALLER / "volcano-tpu-torch-development.yaml"
COMPOSE = INSTALLER / "docker-compose.yaml"


class TestInstallerRender:
    """installer_torch/helm (the helm-chart analog): templates are the
    single source; the committed flat manifests must be byte-identical
    renders, every variable must substitute, and value overlays must work
    from an arbitrary cwd (dash's `.` PATH-searches bare filenames)."""

    def test_render_stream_parses(self):
        out = subprocess.run(["sh", str(RENDER)], capture_output=True,
                             text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert "${" not in out.stdout
        docs = [d for d in yaml.safe_load_all(out.stdout) if d]
        kinds = sorted(d["kind"] for d in docs)
        assert "Deployment" in kinds and "Service" in kinds
        # the parameterized deployment serves the store for vcctl/HA
        assert "--serve-store" in out.stdout

    def test_committed_manifests_are_fresh_renders(self, tmp_path):
        out = subprocess.run(["sh", str(RENDER), "-o", str(tmp_path)],
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        pairs = [
            ("volcano-tpu-torch.yaml", MANIFEST),
            ("prometheus.yaml", INSTALLER / "monitoring" / "prometheus.yaml"),
            ("grafana.yaml", INSTALLER / "monitoring" / "grafana.yaml"),
        ]
        for rendered, committed in pairs:
            got = (tmp_path / rendered).read_text()
            assert got == committed.read_text(), (
                f"{committed} drifted from its template; re-run "
                "installer_torch/helm/render.sh -o and commit")

    def test_overlay_values_from_other_cwd(self, tmp_path):
        values = tmp_path / "my-values.env"
        values.write_text("VT_NAMESPACE=custom-ns\n")
        out = subprocess.run(["sh", str(RENDER), "my-values.env"],
                             cwd=tmp_path, capture_output=True, text=True,
                             timeout=60)
        assert out.returncode == 0, out.stderr
        assert "custom-ns" in out.stdout
        assert "volcano-tpu-torch-system" not in out.stdout
        # monitoring discovery follows the namespace too
        assert out.stdout.count("namespace: custom-ns") >= 8

    def test_placeholder_ca_is_valid_pem_fail_closed(self, tmp_path):
        secret = [d for d in yaml.safe_load_all(MANIFEST.read_text())
                  if d and d["kind"] == "Secret"][0]
        ca = secret["stringData"]["ca.crt"]
        assert "BEGIN CERTIFICATE" in ca
        # compose mounts the same placeholder
        assert (INSTALLER / "certs" / "ca.crt").read_text() == ca
        # loadable: a stock deploy must start (fail closed at the TLS
        # layer), not crash-loop on an empty/invalid PEM
        pem = tmp_path / "ca.pem"
        pem.write_text(ca)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_verify_locations(cafile=str(pem))


def _files():
    return sorted(p for p in INSTALLER.rglob("*") if p.is_file())


def test_no_file_names_the_jax_package_or_the_tpu():
    assert len(_files()) == 12
    for path in _files():
        text = path.read_text()
        for bad in (r"\bvolcano_tpu\.", "JAX_PLATFORMS", "google.com/tpu",
                    "gke-tpu"):
            assert not re.search(bad, text), (path, bad)


def _containers():
    """{name: container} of the rendered manifest's Deployment."""
    dep = [d for d in yaml.safe_load_all(MANIFEST.read_text())
           if d and d["kind"] == "Deployment"
           and d["metadata"]["name"] == "volcano-tpu-torch"][0]
    spec = dep["spec"]["template"]["spec"]
    assert spec["nodeSelector"] == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    return {c["name"]: c for c in spec["containers"]}, spec


def _compose():
    return yaml.safe_load(COMPOSE.read_text())["services"]


def test_only_the_solver_asks_for_a_gpu():
    containers, spec = _containers()
    assert containers["solver"]["resources"]["limits"] == {
        "nvidia.com/gpu": "1"}
    cp = containers["control-plane"]
    assert "nvidia.com/gpu" not in yaml.safe_dump(cp)
    assert {"name": "CUDA_VISIBLE_DEVICES", "value": ""} in cp["env"]
    # the solver is ready once its socket exists; its kernel builds into
    # a volume at the checkout's build/kernels
    assert containers["solver"]["readinessProbe"]["exec"]["command"] == [
        "test", "-S", "/run/volcano/solver.sock"]
    mounts = {m["name"]: m["mountPath"]
              for m in containers["solver"]["volumeMounts"]}
    assert mounts["kernel-build"].endswith("/build/kernels")
    assert {"name": "kernel-build", "emptyDir": {}} in spec["volumes"]
    services = _compose()
    assert services["solver"]["deploy"]["resources"]["reservations"][
        "devices"] == [{"driver": "nvidia", "count": 1,
                        "capabilities": ["gpu"]}]
    assert any(v.startswith("kernel-build:") and v.endswith("/build/kernels")
               for v in services["solver"]["volumes"])
    assert "deploy" not in services["control-plane"]
    assert services["control-plane"]["environment"] == {
        "CUDA_VISIBLE_DEVICES": ""}


def command_lines():
    """(where, argv) of every command the compose file and the rendered
    manifest run."""
    out = [(f"compose {name}", shlex.split(svc["command"]))
           for name, svc in _compose().items()]
    containers, _ = _containers()
    out += [(f"manifest {name}", [str(a) for a in c["command"]])
            for name, c in containers.items()]
    return out


def _parser(module):
    from volcano_tpu_torch import standalone
    from volcano_tpu_torch.parallel import sidecar
    return {"volcano_tpu_torch.standalone": standalone.build_parser,
            "volcano_tpu_torch.parallel.sidecar": sidecar.build_parser,
            }[module]()


@pytest.mark.parametrize("where", ["compose solver", "compose control-plane",
                                   "manifest solver",
                                   "manifest control-plane"])
def test_command_lines_parse_with_the_port_parsers(where):
    argv = dict(command_lines())[where]
    assert argv[:2] == ["python", "-m"]
    args = _parser(argv[2]).parse_args(argv[3:])
    if argv[2].endswith("sidecar"):
        assert args.socket_path == "/run/volcano/solver.sock"
        return
    # --device cpu stands beside every --sidecar
    assert args.sidecar == "/run/volcano/solver.sock"
    assert args.device == "cpu"
    assert args.serve_webhooks and args.webhook_client_ca \
        == "/etc/volcano/certs/ca.crt"


def test_device_cpu_beside_every_sidecar_flag():
    lines = command_lines()
    assert sum("--sidecar" in argv for _, argv in lines) == 2
    for where, argv in lines:
        if "--sidecar" in argv:
            i = argv.index("--device")
            assert argv[i + 1] == "cpu", where
    # the quick start's control plane too
    readme = (INSTALLER / "README.md").read_text()
    starts = [m.start() for m in re.finditer(
        r"python -m volcano_tpu_torch\.standalone", readme)]
    assert starts and all("--device cpu" in readme[s:s + 60]
                          for s in starts)
    assert os.access(RENDER, os.X_OK)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_control_plane_readiness_probe_reaches_the_loopback_server(
        tmp_path):
    """The metrics server binds 127.0.0.1, so a kubelet's httpGet on the
    pod IP would never see it: the probe runs inside the container, and
    passes exactly when /healthz answers. Compose publishes no metrics
    port for the same reason."""
    from volcano_tpu_torch.metrics.server import MetricsServer
    port = _free_port()
    overlay = tmp_path / "values.env"
    overlay.write_text(f"VT_METRICS_PORT={port}\n")
    out = subprocess.run(["sh", str(RENDER), str(overlay)],
                         capture_output=True, text=True, timeout=60,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    dep = [d for d in yaml.safe_load_all(out.stdout)
           if d and d["kind"] == "Deployment"
           and d["metadata"]["name"] == "volcano-tpu-torch"][0]
    cp = {c["name"]: c for c in dep["spec"]["template"]["spec"][
        "containers"]}["control-plane"]
    assert "httpGet" not in yaml.safe_dump(dep)
    argv = [str(a) for a in cp["readinessProbe"]["exec"]["command"]]
    assert argv[0] == "python"
    argv[0] = sys.executable

    def probe() -> int:
        return subprocess.run(argv, capture_output=True,
                              timeout=60).returncode

    assert probe() != 0          # nothing serves yet
    server = MetricsServer(port=port)
    server.start()
    try:
        assert probe() == 0
    finally:
        server.stop()
    svc = _compose()["control-plane"]
    cmd = shlex.split(svc["command"])
    metrics_port = cmd[cmd.index("--metrics-port") + 1]
    assert not any(str(p).split(":")[-1] == metrics_port
                   for p in svc.get("ports", []))
