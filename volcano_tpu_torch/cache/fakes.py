"""Fake effectors (reference pkg/scheduler/util/test_utils.go:94-160).

Recorded binds/evictions make the whole solve loop hermetic: tests build a
cache, run actions, then compare FakeBinder.binds against expectations.
"""

from __future__ import annotations

from typing import Dict, List


class FakeBinder:
    def __init__(self):
        self.binds: Dict[str, str] = {}   # "ns/pod" -> node
        self.channel: List[str] = []
        # the pod objects themselves, for callers that must resync the
        # cache mirror after a write-free run (Scheduler.shadow_cycle)
        self.bound_pods: List[object] = []

    def bind(self, pod, hostname: str) -> None:
        key = f"{pod.namespace}/{pod.name}"
        self.binds[key] = hostname
        self.channel.append(key)
        self.bound_pods.append(pod)


class FakeEvictor:
    def __init__(self):
        self.evicts: List[str] = []
        self.channel: List[str] = []
        self.evicted_pods: List[object] = []

    def evict(self, pod, reason: str) -> None:
        key = f"{pod.namespace}/{pod.name}"
        self.evicts.append(key)
        self.channel.append(key)
        self.evicted_pods.append(pod)


class RecordingBinder:
    """FakeBinder generalized into a decorator: record every bind like
    FakeBinder does AND forward to an inner binder (``inner=None`` keeps
    pure FakeBinder semantics). ``on_bind(pod, hostname)`` is the sim
    decision-recorder seam — it fires only after the inner binder
    succeeded, so recorded binds are exactly the ones that reached the
    cluster."""

    def __init__(self, inner=None, on_bind=None):
        self.inner = inner
        self.on_bind = on_bind
        self.binds: Dict[str, str] = {}
        self.channel: List[str] = []

    def bind(self, pod, hostname: str) -> None:
        if self.inner is not None:
            self.inner.bind(pod, hostname)
        key = f"{pod.namespace}/{pod.name}"
        self.binds[key] = hostname
        self.channel.append(key)
        if self.on_bind is not None:
            self.on_bind(pod, hostname)


class RecordingEvictor:
    """FakeEvictor as a decorator (see RecordingBinder)."""

    def __init__(self, inner=None, on_evict=None):
        self.inner = inner
        self.on_evict = on_evict
        self.evicts: List[str] = []
        self.channel: List[str] = []

    def evict(self, pod, reason: str) -> None:
        if self.inner is not None:
            self.inner.evict(pod, reason)
        key = f"{pod.namespace}/{pod.name}"
        self.evicts.append(key)
        self.channel.append(key)
        if self.on_evict is not None:
            self.on_evict(pod, reason)


class FakeStatusUpdater:
    def update_pod_condition(self, pod, condition: dict) -> None:
        pass

    def update_pod_group(self, pg) -> None:
        pass


class FakeVolumeBinder:
    def allocate_volumes(self, task, hostname: str) -> None:
        pass

    def bind_volumes(self, task) -> None:
        pass

    def revert_volumes(self, task) -> None:
        pass
