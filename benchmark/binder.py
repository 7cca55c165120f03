"""The benchmark's effectors: FakeBinder's ``bind(pod, hostname)`` and
FakeEvictor's ``evict(pod, reason)``, each call stamped with
``time.perf_counter()`` and the cycle it came in."""

from __future__ import annotations

import time


class StampingBinder:
    """Records (cycle, "ns/pod", node, perf_counter) for every bind; the
    cluster store is not written, as with FakeBinder."""

    def __init__(self):
        self.cycle = -1
        self.records: list = []

    def bind(self, pod, hostname: str) -> None:
        self.records.append((self.cycle, f"{pod.namespace}/{pod.name}",
                             hostname, time.perf_counter()))


class StampingEvictor:
    """Records (cycle, "ns/pod", reason, perf_counter) for every eviction;
    the cluster store is not written, as with FakeEvictor: the pod stays
    Releasing in the cache until the traffic releases it
    (``World.release``)."""

    def __init__(self):
        self.cycle = -1
        self.records: list = []

    def evict(self, pod, reason: str) -> None:
        self.records.append((self.cycle, f"{pod.namespace}/{pod.name}",
                             reason, time.perf_counter()))
