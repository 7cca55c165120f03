"""QueueInfo and NamespaceInfo (reference api/{queue_info,namespace_info}.go)."""

from __future__ import annotations

from typing import Dict, Optional

from .types import (
    HIERARCHY_ANNOTATION,
    HIERARCHY_WEIGHT_ANNOTATION,
    NAMESPACE_WEIGHT_KEY,
)

DEFAULT_NAMESPACE_WEIGHT = 1


class QueueInfo:
    """Scheduling view of a Queue CR (queue_info.go:27-77)."""

    __slots__ = ("uid", "name", "weight", "hierarchy", "weights", "queue")

    def __init__(self, queue):
        self.uid = queue.name
        self.name = queue.name
        self.weight = queue.spec.weight
        ann = queue.annotations or {}
        # '/root/sci' and '1/2' style hierarchical path + weights
        self.hierarchy = ann.get(HIERARCHY_ANNOTATION, "")
        self.weights = ann.get(HIERARCHY_WEIGHT_ANNOTATION, "")
        self.queue = queue

    def clone(self) -> "QueueInfo":
        return QueueInfo(self.queue)

    @property
    def reclaimable(self) -> bool:
        """Queues are reclaimable unless explicitly opted out."""
        r = self.queue.spec.reclaimable
        return True if r is None else bool(r)

    @property
    def capability(self):
        return self.queue.spec.capability

    def __repr__(self) -> str:
        return f"Queue({self.name} weight={self.weight})"


class NamespaceInfo:
    """Namespace weight from ResourceQuota annotation (namespace_info.go)."""

    __slots__ = ("name", "weight")

    def __init__(self, name: str, weight: int = DEFAULT_NAMESPACE_WEIGHT):
        self.name = name
        self.weight = weight

    def get_weight(self) -> int:
        return self.weight if self.weight and self.weight > 0 else DEFAULT_NAMESPACE_WEIGHT


class NamespaceCollection:
    """Tracks quota-derived weights per namespace (namespace_info.go:58-135).

    The reference keeps a heap of quota items; we keep the max weight across
    live quotas, which is the observable behavior (Snapshot takes the head)."""

    def __init__(self, name: str):
        self.name = name
        self._quota_weights: Dict[str, int] = {}

    @staticmethod
    def _quota_weight(quota) -> Optional[int]:
        ann = (quota.annotations or {})
        raw = ann.get(NAMESPACE_WEIGHT_KEY)
        if raw is None:
            return None
        try:
            w = int(raw)
        except (TypeError, ValueError):
            return None
        return w if w > 0 else None

    def update(self, quota) -> None:
        w = self._quota_weight(quota)
        self._quota_weights[quota.name] = w if w is not None else DEFAULT_NAMESPACE_WEIGHT

    def delete(self, quota) -> None:
        self._quota_weights.pop(quota.name, None)

    def snapshot(self) -> NamespaceInfo:
        weight = max(self._quota_weights.values(), default=DEFAULT_NAMESPACE_WEIGHT)
        return NamespaceInfo(self.name, weight)
