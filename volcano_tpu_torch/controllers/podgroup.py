"""PodGroup controller (reference pg_controller.go:65-111).

Auto-creates a PodGroup for bare pods that use the volcano scheduler but
carry no group annotation (normal-pod compatibility).
"""

from __future__ import annotations

import logging
from typing import List, Optional

from ..api.types import POD_GROUP_ANNOTATION
from ..client.store import ClusterStore
from ..models import Pod, PodGroup, PodGroupSpec
from .framework import Controller, ControllerOption

log = logging.getLogger(__name__)


class PodGroupController(Controller):
    def __init__(self):
        self.cluster: Optional[ClusterStore] = None
        self.scheduler_name = "volcano"
        self.default_queue = "default"
        self.queue: List[str] = []  # pod keys

    def name(self) -> str:
        return "pg-controller"

    def initialize(self, opt: ControllerOption) -> None:
        self.cluster = opt.cluster
        self.scheduler_name = opt.scheduler_name
        self.default_queue = opt.default_queue

    def run(self) -> None:
        self.cluster.watch("pods", self._on_pod)

    def _on_pod(self, event, pod: Pod, old) -> None:
        if event != "add":
            return
        if pod.scheduler_name != self.scheduler_name:
            return
        if (pod.annotations or {}).get(POD_GROUP_ANNOTATION):
            return
        self.queue.append(f"{pod.namespace}/{pod.name}")

    def process_all(self) -> None:
        keys, self.queue = self.queue, []
        for key in keys:
            ns, name = key.split("/", 1)
            pod = self.cluster.try_get("pods", name, ns)
            if pod is None:
                continue
            try:
                self._ensure_podgroup(pod)
            except Exception:
                log.exception("failed to create podgroup for %s", key)

    def _ensure_podgroup(self, pod: Pod) -> None:
        pg_name = f"podgroup-{pod.uid}"
        if self.cluster.try_get("podgroups", pg_name, pod.namespace) is None:
            owner = pod.owner_references[0] if pod.owner_references else \
                {"kind": "Pod", "name": pod.name, "uid": pod.uid}
            self.cluster.create("podgroups", PodGroup(
                name=pg_name, namespace=pod.namespace,
                spec=PodGroupSpec(min_member=1, queue=self.default_queue,
                                  priority_class_name=pod.priority_class_name),
                owner_references=[owner]))
        pod.annotations[POD_GROUP_ANNOTATION] = pg_name
        self.cluster.update("pods", pod)
