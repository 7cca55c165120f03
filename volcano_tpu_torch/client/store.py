"""In-memory cluster store: the API-server/informer seam.

The reference's "distributed communication backend" is the Kubernetes API
server plus client-go informer watch streams. This build replaces that
with this process-local object store: typed buckets with
create/update/delete plus synchronous watch listeners. The scheduler cache,
controllers, webhooks and CLI all talk to a ClusterStore; in tests it is
this in-memory implementation (the reference's fake-clientset
pattern, pkg/client/clientset/versioned/fake).

Admission plugs in as a create/update interceptor chain, mirroring the
webhook-manager's mutate/validate path.
"""

from __future__ import annotations

import fnmatch
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..metrics import tracing

Listener = Callable[[str, Any, Optional[Any]], None]  # (event, obj, old) event in {add, update, delete}
Interceptor = Callable[[str, str, Any], Any]  # (verb, kind, obj) -> obj (may raise AdmissionError)

KINDS = (
    "pods", "nodes", "podgroups", "queues", "priorityclasses",
    "resourcequotas", "jobs", "commands", "services", "configmaps",
    "secrets", "pvcs", "leases", "networkpolicies", "bindintents",
    "migrationintents",
)


class AdmissionError(Exception):
    """Raised by an admission interceptor to deny a write."""


class NotFoundError(KeyError):
    pass


class ConflictError(Exception):
    """Stale-object write (resource_version mismatch)."""


class FencedError(ConflictError):
    """A mutating write carried a stale lease fencing token: the writer is
    no longer (or never was) the lease holder the store knows, so the
    write is refused before touching any state. Subclasses ConflictError
    so untyped callers degrade to conflict handling (a fence IS an
    optimistic-concurrency rejection — of the writer's leadership rather
    than one object's version)."""


class ResumeGapError(Exception):
    """A watch resume asked for events the server can no longer replay
    (the journal's window moved past the client's high-water mark); the
    client falls back to its crash-only resync path."""


class ShardUnavailableError(Exception):
    """The store shard owning the requested object is down (crashed and
    not yet recovered). Per-item containment applies: in a bulk wave the
    down shard's items carry this error while the other shards' items
    commit — a dead shard costs its objects, not the wave."""


class ReplicaReadOnlyError(Exception):
    """A mutating op (create/update/apply/delete/bulk_apply) reached a
    read replica. Replicas serve list/get/watch with explicit staleness;
    every write — and with it fencing, leases and conditional-update
    arbitration — belongs to the primary, so the op fails CLOSED with
    this typed error instead of forking the object's history."""


class ReplicaLagError(Exception):
    """An rv-bounded read (``min_rv=`` on list) timed out before the
    replica applied that resource_version: the caller asked for
    read-your-writes freshness the replica cannot yet prove. The caller
    retries, raises its bound, or falls back to the primary."""


def _key(obj) -> str:
    ns = getattr(obj, "namespace", None)
    return f"{ns}/{obj.name}" if ns is not None else obj.name


class ClusterStore:
    """Typed object buckets + watch listeners. Writes serialize under one
    reentrant lock: the normal control flow is single-threaded (ordering
    deterministic, informer-delta semantics testable), but the job-updater
    fan-out and async effectors may write concurrently — each write
    (admission + mutation + listener delivery) is atomic under the lock,
    like one API-server request."""

    def __init__(self):
        import threading
        self._buckets: Dict[str, Dict[str, Any]] = {k: {} for k in KINDS}
        self._listeners: Dict[str, List[Listener]] = {k: [] for k in KINDS}
        self._interceptors: List[Interceptor] = []
        self._lock = threading.RLock()
        self._rv = 0
        # fencing arbitration clock (injectable so HA tests drive lease
        # expiry deterministically); only consulted for fenced writes
        self.clock: Callable[[], float] = time.time
        # global rv of the LAST event committed per kind — the watch-resume
        # seam (server.EventJournal) needs "has anything happened to this
        # kind since rv X" answerable without scanning a journal
        self._kind_rv: Dict[str, int] = {k: 0 for k in KINDS}

    def locked(self):
        """The store's write lock, for callers that need a consistent
        multi-read view against concurrent writers (e.g. the scheduler
        cache's snapshot — the reference's SchedulerCache.Mutex)."""
        return self._lock

    # -- admission ----------------------------------------------------------

    def add_interceptor(self, fn: Interceptor) -> None:
        self._interceptors.append(fn)

    def _admit(self, verb: str, kind: str, obj):
        for fn in self._interceptors:
            obj = fn(verb, kind, obj)
        return obj

    # -- watch --------------------------------------------------------------

    def watch(self, kind: str, listener: Listener, replay: bool = True) -> None:
        """Subscribe to a bucket; replay=True delivers existing objects as
        adds first (informer list-then-watch semantics)."""
        with self._lock:
            self._listeners[kind].append(listener)
            if replay:
                for obj in list(self._buckets[kind].values()):
                    listener("add", obj, None)

    def unwatch(self, kind: str, listener: Listener) -> None:
        """Drop a subscription (a disconnected remote watcher must not keep
        receiving — and leaking — events; the in-process consumers never
        unsubscribe)."""
        with self._lock:
            try:
                self._listeners[kind].remove(listener)
            except ValueError:
                pass

    def _notify(self, kind: str, event: str, obj, old=None) -> None:
        self._kind_rv[kind] = self._rv
        for fn in list(self._listeners[kind]):
            fn(event, obj, old)

    def last_event_rv(self, kind: str) -> int:
        """Global resource_version at which this kind last committed an
        event (0 = never). Deletes count: they bump the global rv too."""
        with self._lock:
            return self._kind_rv[kind]

    # -- lease fencing ------------------------------------------------------

    def _check_fence(self, fencing: Optional[dict]) -> None:
        """Refuse a mutating write whose lease fencing token is stale.

        The token names the Lease the writer holds ({lock, holder, epoch});
        the STORE's current lease record arbitrates — a deposed leader's
        view of its own leadership is exactly what cannot be trusted. The
        write is fenced out when the lease is gone, held by someone else,
        re-acquired since (epoch = lease_transitions at acquisition), or
        expired by the store's own clock (split-brain where no standby has
        taken over yet must still not commit). Unfenced writes (no token)
        pass untouched: fencing is opt-in per writer via FencedStore.

        A sharded member store delegates to its fence arbiter (the shard
        holding the "leases" bucket, client/sharded.py): a pod write on
        shard 3 is arbitrated by the lease record on shard 0 — the
        sharded store's top-level mutation mutex makes the check atomic
        with the write, exactly like this store's own lock does."""
        if not fencing:
            return
        arbiter = getattr(self, "_fence_arbiter", None)
        if arbiter is not None:
            arbiter._check_fence(fencing)
            return
        name = fencing.get("lock", "")
        lease = self._buckets["leases"].get(name)
        holder = fencing.get("holder")
        epoch = fencing.get("epoch", -1)
        reason = None
        if lease is None:
            reason = f"lease {name!r} does not exist"
        elif lease.holder_identity != holder:
            reason = (f"lease {name!r} is held by "
                      f"{lease.holder_identity!r}, not {holder!r}")
        elif int(epoch) != int(lease.lease_transitions):
            reason = (f"lease {name!r} was re-acquired (epoch "
                      f"{lease.lease_transitions} != token epoch {epoch})")
        elif self.clock() - lease.renew_time > lease.lease_duration_seconds:
            reason = (f"lease {name!r} expired "
                      f"{self.clock() - lease.renew_time:.1f}s ago")
        if reason is not None:
            try:
                from ..metrics import metrics
                metrics.fenced_writes_total.inc(
                    labels={"holder": str(holder)})
            except Exception:  # noqa: BLE001 — accounting never masks the fence
                pass
            raise FencedError(f"write fenced: {reason}")

    # -- CRUD ---------------------------------------------------------------

    def create(self, kind: str, obj, fencing: Optional[dict] = None):
        with tracing.traced("vc.store.write", kind=kind, event="add"), \
                self._lock:
            self._check_fence(fencing)
            obj = self._admit("create", kind, obj)
            key = _key(obj)
            bucket = self._buckets[kind]
            if key in bucket:
                raise ConflictError(f"{kind} {key} already exists")
            self._rv += 1
            if hasattr(obj, "resource_version"):
                obj.resource_version = self._rv
            bucket[key] = obj
            self._notify(kind, "add", obj)
            return obj

    def update(self, kind: str, obj, fencing: Optional[dict] = None):
        with tracing.traced("vc.store.write", kind=kind, event="update"), \
                self._lock:
            self._check_fence(fencing)
            obj = self._admit("update", kind, obj)
            key = _key(obj)
            bucket = self._buckets[kind]
            old = bucket.get(key)
            if old is None:
                raise NotFoundError(f"{kind} {key} not found")
            # Optimistic concurrency: a writer presenting a stale copy
            # loses (k8s resourceVersion precondition). Only enforced when
            # the caller hands in a *different* object carrying a version —
            # in-place updates of the stored object (the informer-cache
            # pattern) and fresh objects with version 0 carry no
            # precondition.
            if (obj is not old
                    and getattr(obj, "resource_version", 0)
                    and getattr(old, "resource_version", 0)
                    and obj.resource_version != old.resource_version):
                raise ConflictError(
                    f"{kind} {key}: stale resource_version "
                    f"{obj.resource_version} != {old.resource_version}")
            self._rv += 1
            if hasattr(obj, "resource_version"):
                obj.resource_version = self._rv
            bucket[key] = obj
            self._notify(kind, "update", obj, old)
            return obj

    def apply(self, kind: str, obj, fencing: Optional[dict] = None):
        """Create-or-update."""
        with self._lock:
            key = _key(obj)
            if key in self._buckets[kind]:
                return self.update(kind, obj, fencing=fencing)
            return self.create(kind, obj, fencing=fencing)

    def delete(self, kind: str, name: str, namespace: Optional[str] = None,
               fencing: Optional[dict] = None):
        with tracing.traced("vc.store.write", kind=kind, event="delete"), \
                self._lock:
            self._check_fence(fencing)
            key = f"{namespace}/{name}" if namespace is not None else name
            bucket = self._buckets[kind]
            obj = bucket.pop(key, None)
            if obj is None:
                raise NotFoundError(f"{kind} {key} not found")
            self._admit("delete", kind, obj)
            # deletes advance the global rv like every other event, so a
            # resuming watcher's high-water mark orders them correctly
            self._rv += 1
            self._notify(kind, "delete", obj)
            return obj

    def bulk_apply(self, items, fencing: Optional[dict] = None,
                   _sync: bool = True) -> List[Any]:
        """Batch mutation: many objects under ONE lock hold (and, on the
        durable store, one journal batch — a single fsync covers the
        whole wave). ``items`` is an iterable of ``(kind, obj)`` or
        ``(kind, obj, verb)`` with verb in {"apply", "create",
        "update"}; default "apply".

        Per-item containment, not a transaction: each object commits (or
        fails) independently, in order, and the result list carries the
        applied object OR the exception instance at that item's position
        — a rejected pod in a 500-pod ingest wave costs that pod, not
        the wave. The wire op (StoreServer ``bulk_apply``) carries the
        same contract in one frame each way.

        ``_sync=False`` defers the batch-end fsync to the caller (the
        sharded store runs one batch per touched shard and then fsyncs
        every touched WAL in parallel — N shards cost one fsync's wall
        time, not N)."""
        results: List[Any] = []
        with self._lock:
            self._batch_begin()
            try:
                for item in items:
                    kind, obj = item[0], item[1]
                    verb = item[2] if len(item) > 2 else "apply"
                    try:
                        if verb == "create":
                            results.append(self.create(kind, obj,
                                                       fencing=fencing))
                        elif verb == "update":
                            results.append(self.update(kind, obj,
                                                       fencing=fencing))
                        elif verb == "apply":
                            results.append(self.apply(kind, obj,
                                                      fencing=fencing))
                        else:
                            raise ValueError(
                                f"bulk_apply verb {verb!r} not in "
                                "('apply', 'create', 'update')")
                    except Exception as e:  # noqa: BLE001 — per-item result
                        results.append(e)
            finally:
                self._batch_end(sync=_sync)
        return results

    def _batch_begin(self) -> None:
        """Journal-batch seam (no-op in memory; the durable store defers
        fsync until _batch_end so a bulk write costs one sync)."""

    def _batch_end(self, sync: bool = True) -> None:
        pass

    def get(self, kind: str, name: str, namespace: Optional[str] = None):
        with self._lock:
            key = f"{namespace}/{name}" if namespace is not None else name
            obj = self._buckets[kind].get(key)
            if obj is None:
                raise NotFoundError(f"{kind} {key} not found")
            return obj

    def try_get(self, kind: str, name: str, namespace: Optional[str] = None):
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None,
             name_glob: Optional[str] = None) -> List[Any]:
        out = []
        with self._lock:
            objs = list(self._buckets[kind].values())
        for obj in objs:
            if namespace is not None and getattr(obj, "namespace", None) != namespace:
                continue
            if label_selector:
                labels = getattr(obj, "labels", {}) or {}
                if any(labels.get(k) != v for k, v in label_selector.items()):
                    continue
            if name_glob is not None and not fnmatch.fnmatch(obj.name, name_glob):
                continue
            out.append(obj)
        return out


class FencedStore:
    """Store proxy attaching the writer's lease fencing token to every
    mutating op (create/update/apply/delete); reads and watch pass
    through untouched. ``token_provider`` returns the current token
    ({lock, holder, epoch}) or None when the writer holds no lease — in
    which case mutations FAIL CLOSED with FencedError locally: a deposed
    leader whose elector already observed the loss must not fall back to
    writing unfenced. Wraps both the in-memory ClusterStore (which
    validates under its own lock) and RemoteClusterStore (which carries
    the token on the wire for the StoreServer to validate)."""

    def __init__(self, store, token_provider: Callable[[], Optional[dict]]):
        self._store = store
        self._token_provider = token_provider

    def _token(self) -> dict:
        token = self._token_provider()
        if token is None:
            raise FencedError(
                "write fenced: this writer holds no lease")
        return token

    def create(self, kind: str, obj):
        return self._store.create(kind, obj, fencing=self._token())

    def update(self, kind: str, obj):
        return self._store.update(kind, obj, fencing=self._token())

    def apply(self, kind: str, obj):
        return self._store.apply(kind, obj, fencing=self._token())

    def delete(self, kind: str, name: str, namespace: Optional[str] = None):
        return self._store.delete(kind, name, namespace,
                                  fencing=self._token())

    def bulk_apply(self, items):
        return self._store.bulk_apply(items, fencing=self._token())

    def __getattr__(self, name):
        # reads (get/try_get/list/watch/locked/...) forward unfenced
        return getattr(self._store, name)
