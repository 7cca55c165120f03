"""The benchmark's bind effector: FakeBinder's ``bind(pod, hostname)``,
each bind stamped with ``time.perf_counter()`` and the cycle it came in."""

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
