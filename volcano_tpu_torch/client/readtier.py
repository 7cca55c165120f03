"""ReadTierStore: split one store surface into a fenced write path and
a replica read path (the controllers-off-the-primary half of fan-out
trees).

Controllers, standby mirrors, schedulers and dashboards are steady-state
READERS: their list/watch/bulk_watch volume dwarfs their mutations, and
all of it otherwise lands on the writer quorum. This
wrapper sends every mutation to ``write_store`` (the primary — fencing,
leases and conditional-write arbitration untouched) and every read to
``read_store`` (a replica, in-process mirror or remote endpoint), with
the staleness contract made explicit instead of hoped for:

- **read-your-writes via min_rv**: each acked mutation's ``applied_rv``
  stamp advances a high-water mark, and every subsequent read demands
  it (``min_rv=``) — the replica blocks until it has applied that rv or
  fails typed, so a controller can never act on a view that predates
  its own last sync. The stamp is read from the write client's
  ``applied_hwm()`` when it keeps one (RemoteClusterStore), else from
  the in-process store's rv under its lock.
- **primary kinds**: coordination state that arbitrates LIVENESS —
  leases and the takeover-recovery intents — is always read from the
  primary. min_rv only bounds this wrapper's OWN writes; a lease
  renewed by another process must be seen fresh, not eventually.
- **typed fallback**: a lagging (ReplicaLagError) or unreachable read
  replica degrades reads to the primary, counted, never silently
  stale. Other typed errors (NotFoundError, ...) are real answers and
  propagate.

``FencedStore`` composes on top (it wraps mutations with the fencing
token and forwards reads via ``__getattr__``), so the HA controller
manager stacks FencedStore(ReadTierStore(primary, replica)) without
either wrapper knowing about the other.
"""

from __future__ import annotations

import inspect
import logging
import threading
from typing import Optional

from .server import applied_rv_of
from .store import ReplicaLagError

log = logging.getLogger(__name__)

#: kinds whose reads always go to the primary: they arbitrate liveness
#: (leases) or takeover recovery (intents), where another writer's
#: update must be seen fresh — a min_rv bound only covers OUR writes
PRIMARY_KINDS = ("leases", "bindintents", "migrationintents")

#: default block budget a read demands from the replica before the
#: typed fallback to the primary engages
DEFAULT_READ_WAIT_S = 5.0


def _accepts_min_rv(fn) -> bool:
    try:
        return "min_rv" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins/mocks: assume not
        return False


class ReadTierStore:
    """See module docstring. ``write_store`` is the primary surface
    (in-process store or RemoteClusterStore to it); ``read_store`` is
    the replica surface (a ReplicaStore's ``.store`` mirror, or a
    RemoteClusterStore to any replica in the tree)."""

    def __init__(self, write_store, read_store,
                 primary_kinds=PRIMARY_KINDS,
                 wait_s: float = DEFAULT_READ_WAIT_S):
        self.write_store = write_store
        self.read_store = read_store
        self.primary_kinds = tuple(primary_kinds)
        self.wait_s = float(wait_s)
        self._hwm_lock = threading.Lock()
        self._hwm = None
        self._read_min_rv = _accepts_min_rv(read_store.list)
        self.reads_replica = 0    # reads the replica answered
        self.read_fallbacks = 0   # reads that degraded to the primary

    # -- the read-your-writes bound ------------------------------------------

    def _note_write(self) -> None:
        """Advance the hwm to at least this mutation's applied rv."""
        hwm_fn = getattr(self.write_store, "applied_hwm", None)
        if hwm_fn is not None:
            rv = hwm_fn()
        else:
            with self.write_store.locked():
                rv = applied_rv_of(self.write_store)
        if rv is None:
            return
        with self._hwm_lock:
            self._hwm = self._merge_hwm(self._hwm, rv)

    @staticmethod
    def _merge_hwm(cur, new):
        if cur is None:
            return new
        if isinstance(new, dict) or isinstance(cur, dict):
            cur = cur if isinstance(cur, dict) else {"0": int(cur)}
            new = new if isinstance(new, dict) else {"0": int(new)}
            out = dict(cur)
            for sh, rv in new.items():
                out[sh] = max(int(rv), int(out.get(sh, 0)))
            return out
        return max(int(cur), int(new))

    def applied_hwm(self):
        with self._hwm_lock:
            return self._hwm

    # -- mutations: the fenced write path ------------------------------------

    def create(self, kind, obj, fencing=None):
        out = self.write_store.create(kind, obj, fencing=fencing)
        self._note_write()
        return out

    def update(self, kind, obj, fencing=None):
        out = self.write_store.update(kind, obj, fencing=fencing)
        self._note_write()
        return out

    def apply(self, kind, obj, fencing=None):
        out = self.write_store.apply(kind, obj, fencing=fencing)
        self._note_write()
        return out

    def delete(self, kind, name, namespace=None, fencing=None):
        out = self.write_store.delete(kind, name, namespace,
                                      fencing=fencing)
        self._note_write()
        return out

    def bulk_apply(self, items, fencing=None, **kw):
        out = self.write_store.bulk_apply(items, fencing=fencing, **kw)
        self._note_write()
        return out

    # -- reads: the replica path ---------------------------------------------

    def _read(self, kind: str, op, primary_op):
        """One read: the replica with min_rv=hwm, the primary for
        primary kinds or after a typed/unreachable replica failure."""
        if kind in self.primary_kinds:
            return primary_op()
        try:
            if self._read_min_rv:
                resp = op(min_rv=self.applied_hwm())
            else:
                resp = op()
        except (ReplicaLagError, ConnectionError, OSError) as e:
            self.read_fallbacks += 1
            log.warning("read-tier %s read failed (%s: %s); falling "
                        "back to the primary", kind, type(e).__name__, e)
            return primary_op()
        self.reads_replica += 1
        return resp

    def get(self, kind, name, namespace=None):
        def replica_get(min_rv=None):
            if min_rv is not None:
                return self.read_store.get(kind, name, namespace,
                                           min_rv=min_rv,
                                           wait_s=self.wait_s)
            return self.read_store.get(kind, name, namespace)

        return self._read(
            kind, replica_get,
            lambda: self.write_store.get(kind, name, namespace))

    def try_get(self, kind, name, namespace=None):
        from .store import NotFoundError
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def list(self, kind, namespace=None, label_selector=None,
             name_glob=None):
        def replica_list(min_rv=None):
            if min_rv is not None:
                return self.read_store.list(kind, namespace,
                                            label_selector, name_glob,
                                            min_rv=min_rv,
                                            wait_s=self.wait_s)
            return self.read_store.list(kind, namespace, label_selector,
                                        name_glob)

        return self._read(
            kind, replica_list,
            lambda: self.write_store.list(kind, namespace,
                                          label_selector, name_glob))

    # -- streams + locks: the replica's mirror is the subscription -----------

    def watch(self, kind, listener, replay: bool = True):
        return self.read_store.watch(kind, listener, replay=replay)

    def unwatch(self, kind, listener):
        return self.read_store.unwatch(kind, listener)

    def bulk_watch(self, subs, **kw):
        return self.read_store.bulk_watch(subs, **kw)

    def locked(self):
        return self.read_store.locked()

    def last_event_rv(self, kind: str) -> int:
        return self.read_store.last_event_rv(kind)

    def __getattr__(self, name):
        # everything else (interceptors, fencing internals, clock, the
        # lease arbitration surface) belongs to the primary
        return getattr(self.write_store, name)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"ReadTierStore(write={self.write_store!r}, "
                f"read={self.read_store!r})")


__all__ = ["ReadTierStore", "PRIMARY_KINDS", "DEFAULT_READ_WAIT_S"]
