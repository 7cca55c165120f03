"""Conformance plugin (reference plugins/conformance/conformance.go:44-66).

Never evict system-critical pods or anything in kube-system.
"""

from __future__ import annotations

from ..framework import Plugin

_CRITICAL_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")


def _evictable(task) -> bool:
    pod = task.pod
    if pod.namespace == "kube-system":
        return False
    if pod.priority_class_name in _CRITICAL_PRIORITY_CLASSES:
        return False
    return True


class ConformancePlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return "conformance"

    def on_session_open(self, ssn) -> None:
        def evictable_fn(evictor, evictees):
            return [t for t in evictees if _evictable(t)]

        ssn.add_preemptable_fn(self.name(), evictable_fn)
        ssn.add_reclaimable_fn(self.name(), evictable_fn)

    def on_session_close(self, ssn) -> None:
        pass
