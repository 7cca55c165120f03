"""Job plugins: env, svc, ssh (reference controllers/job/plugins/).

Hooks: on_pod_create / on_job_add / on_job_delete / on_job_update
(plugins/interface/interface.go:30-44). They make gang-scheduled
distributed workloads wire themselves up: env injects task indices, svc
publishes a hosts table + headless service, ssh provisions a job-scoped
keypair for passwordless MPI.
"""

from __future__ import annotations

import base64
import hashlib
from typing import Callable, Dict, List

from ...client.store import NotFoundError
from ...models import ConfigMap, NetworkPolicy, Secret, Service
from ...models.batch import TASK_SPEC_KEY

CONFIG_MAP_TASK_INDEX_ENV = "VC_TASK_INDEX"
TASK_INDEX_ENV = "VK_TASK_INDEX"


def _task_index(pod) -> str:
    return pod.name.rsplit("-", 1)[-1]


class EnvPlugin:
    """Injects VC_TASK_INDEX / VK_TASK_INDEX env vars
    (plugins/env/env.go:45-85)."""

    def __init__(self, arguments=None, cluster=None):
        self.cluster = cluster

    def name(self) -> str:
        return "env"

    def on_pod_create(self, pod, job) -> None:
        idx = _task_index(pod)
        for c in pod.containers + pod.init_containers:
            envs = c.setdefault("env", [])
            envs.append({"name": TASK_INDEX_ENV, "value": idx})
            envs.append({"name": CONFIG_MAP_TASK_INDEX_ENV, "value": idx})

    def on_job_add(self, job) -> None:
        job.status.controlled_resources["plugin-env"] = "env"

    def on_job_delete(self, job) -> None:
        job.status.controlled_resources.pop("plugin-env", None)

    def on_job_update(self, job) -> None:
        pass


class SvcPlugin:
    """Headless service + hosts ConfigMap (+ optional NetworkPolicy)
    (plugins/svc/svc.go:257-345)."""

    def __init__(self, arguments=None, cluster=None):
        self.cluster = cluster
        self.arguments = arguments or []
        self.disable_network_policy = "--disable-network-policy=true" in (
            arguments or [])

    def name(self) -> str:
        return "svc"

    def _cm_name(self, job) -> str:
        return f"{job.name}-svc"

    def generate_hosts(self, job) -> Dict[str, str]:
        """Per-task FQDN lists: '<jobname>-<task>-<idx>.<jobname>'
        (svc.go:311-345)."""
        hosts = {}
        for ts in job.spec.tasks:
            lines = [f"{job.name}-{ts.name}-{i}.{job.name}"
                     for i in range(ts.replicas)]
            hosts[f"{ts.name}.host"] = "\n".join(lines)
        return hosts

    def on_job_add(self, job) -> None:
        cm = ConfigMap(name=self._cm_name(job), namespace=job.namespace,
                       data=self.generate_hosts(job),
                       owner_references=[{"kind": "Job", "name": job.name,
                                          "uid": job.uid}])
        self.cluster.apply("configmaps", cm)
        svc = Service(name=job.name, namespace=job.namespace,
                      spec={"clusterIP": "None",
                            "selector": {"volcano.sh/job-name": job.name},
                            "ports": [{"name": "placeholder", "port": 1}]},
                      owner_references=[{"kind": "Job", "name": job.name,
                                         "uid": job.uid}])
        self.cluster.apply("services", svc)
        if not self.disable_network_policy:
            # intra-job network isolation: only pods of the same job (or
            # unlabeled infrastructure) may reach the job's pods
            # (svc.go:257-304 CreateNetworkPolicyIfNotExist)
            np_obj = NetworkPolicy(
                name=job.name, namespace=job.namespace,
                spec={
                    "podSelector": {"matchLabels": {
                        "volcano.sh/job-name": job.name}},
                    "ingress": [{"from": [{"podSelector": {"matchLabels": {
                        "volcano.sh/job-name": job.name}}}]}],
                    "policyTypes": ["Ingress"],
                },
                owner_references=[{"kind": "Job", "name": job.name,
                                   "uid": job.uid}])
            self.cluster.apply("networkpolicies", np_obj)
            job.status.controlled_resources["plugin-svc-networkpolicy"] = job.name
        job.status.controlled_resources["plugin-svc"] = "svc"

    def on_pod_create(self, pod, job) -> None:
        # mount the hosts configmap + stable hostname/subdomain
        pod.annotations["volcano.sh/svc-configmap"] = self._cm_name(job)
        pod.annotations["volcano.sh/hostname"] = pod.name
        pod.annotations["volcano.sh/subdomain"] = job.name

    def on_job_delete(self, job) -> None:
        for kind, name in (("configmaps", self._cm_name(job)),
                           ("services", job.name),
                           ("networkpolicies", job.name)):
            try:
                self.cluster.delete(kind, name, job.namespace)
            except NotFoundError:
                pass
        job.status.controlled_resources.pop("plugin-svc", None)
        job.status.controlled_resources.pop("plugin-svc-networkpolicy", None)

    def on_job_update(self, job) -> None:
        cm = self.cluster.try_get("configmaps", self._cm_name(job),
                                  job.namespace)
        if cm is not None:
            cm.data = self.generate_hosts(job)
            self.cluster.update("configmaps", cm)


class SSHPlugin:
    """Job-scoped keypair in a Secret, mounted for passwordless MPI
    (plugins/ssh/ssh.go:64-215). Key material is deterministic test-grade
    (derived from the job UID), not cryptographic — the control-plane shape
    is what matters here; production would call out to a real keygen."""

    def __init__(self, arguments=None, cluster=None):
        self.cluster = cluster

    def name(self) -> str:
        return "ssh"

    def _secret_name(self, job) -> str:
        return f"{job.name}-ssh"

    def on_job_add(self, job) -> None:
        seed = hashlib.sha256(job.uid.encode()).hexdigest()
        private = base64.b64encode(f"ssh-private-{seed}".encode())
        public = base64.b64encode(f"ssh-public-{seed}".encode())
        secret = Secret(
            name=self._secret_name(job), namespace=job.namespace,
            data={"id_rsa": private, "id_rsa.pub": public,
                  "authorized_keys": public,
                  "config": b"StrictHostKeyChecking no\nUserKnownHostsFile /dev/null\n"},
            owner_references=[{"kind": "Job", "name": job.name,
                               "uid": job.uid}])
        self.cluster.apply("secrets", secret)
        job.status.controlled_resources["plugin-ssh"] = "ssh"

    def on_pod_create(self, pod, job) -> None:
        pod.annotations["volcano.sh/ssh-secret"] = self._secret_name(job)

    def on_job_delete(self, job) -> None:
        try:
            self.cluster.delete("secrets", self._secret_name(job),
                                job.namespace)
        except NotFoundError:
            pass
        job.status.controlled_resources.pop("plugin-ssh", None)

    def on_job_update(self, job) -> None:
        pass


_PLUGIN_BUILDERS: Dict[str, Callable] = {
    "env": EnvPlugin,
    "svc": SvcPlugin,
    "ssh": SSHPlugin,
}


def get_plugin(name: str, arguments: List[str], cluster):
    builder = _PLUGIN_BUILDERS.get(name)
    if builder is None:
        return None
    return builder(arguments, cluster)


def register_plugin_builder(name: str, builder: Callable) -> None:
    _PLUGIN_BUILDERS[name] = builder
