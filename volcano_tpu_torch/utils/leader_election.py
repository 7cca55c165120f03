"""Leader election on a Lease object (reference cmd/scheduler/app/server.go:
85-145, cmd/controller-manager/app/server.go:98-127).

The reference elects via a client-go resourcelock against the API server;
here the lock is a Lease record in the ClusterStore (the build's API-server
seam), with the same lease-duration/renew-deadline/retry-period contract and
the same observable behavior: exactly one elector runs its callback at a
time, a crashed leader's lease expires and a standby takes over.

``step()`` drives one acquire-or-renew attempt with an injectable clock so
tests are deterministic; ``run()`` is the wall-clock loop.
"""

from __future__ import annotations

import copy
import threading
import time
import uuid
from typing import Callable, Optional

from ..client.store import ConflictError, NotFoundError
# Lease lives with the models, where a wire codec between HA processes
# would reconstruct it
from ..models import Lease
from ..models.core import LEASE_DURATION  # noqa: F401 — re-export

RENEW_DEADLINE = 10.0   # server.go:51
RETRY_PERIOD = 5.0      # server.go:52


class LeaseLock:
    """Get/create/update a named Lease in the cluster store."""

    def __init__(self, store, name: str):
        self.store = store
        self.name = name

    def get(self) -> Optional[Lease]:
        try:
            # a copy, so the elector's mutations never leak into the store and
            # the carried resource_version acts as a write precondition
            return copy.copy(self.store.get("leases", self.name))
        except Exception:
            return None

    def create_or_update(self, lease: Lease) -> Lease:
        # A lease the elector read as absent (version 0) must go through
        # create so two racing first-acquirers conflict instead of the second
        # overwriting the first via the version-0 update bypass.
        if lease.resource_version:
            return self.store.update("leases", lease)
        return self.store.create("leases", lease)


class LeaderElector:
    """Acquire the lease, keep renewing, report leadership changes."""

    def __init__(self, lock: LeaseLock, identity: Optional[str] = None,
                 lease_duration: float = LEASE_DURATION,
                 renew_deadline: float = RENEW_DEADLINE,
                 retry_period: float = RETRY_PERIOD,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.time):
        # hostname_uuid uniquifier (server.go:108-110)
        self.identity = identity or f"{uuid.uuid4().hex[:8]}_{uuid.uuid4()}"
        self.lock = lock
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.clock = clock
        self.is_leader = False
        self._last_renew = 0.0
        # fencing: the lease_transitions value of OUR acquisition — the
        # write epoch carried by every fenced store write (FencedStore),
        # so the store can reject a deposed leader's late commit even when
        # the same identity later re-acquires (epoch bumps per transition)
        self.fence_epoch: Optional[int] = None

    # -- one protocol step (testable) ---------------------------------------

    def step(self) -> bool:
        """Try to acquire or renew; returns current leadership."""
        now = self.clock()
        lease = self.lock.get()
        if (self.is_leader and lease is not None
                and lease.holder_identity == self.identity
                and now - self._last_renew < self.retry_period):
            # freshly renewed: don't re-write the lease on every call
            return True
        held_by_other = (
            lease is not None and lease.holder_identity
            and lease.holder_identity != self.identity
            and now < lease.renew_time + lease.lease_duration_seconds)
        if held_by_other:
            if self.is_leader:
                self._lose()
            return False

        if self.is_leader and now - self._last_renew > self.renew_deadline:
            # failed to renew within the deadline: step down (the lease may
            # already have been taken over)
            self._lose()
            return False

        new = lease or Lease(name=self.lock.name)
        if new.holder_identity != self.identity:
            new.lease_transitions += 1
            new.acquire_time = now
        new.holder_identity = self.identity
        new.renew_time = now
        new.lease_duration_seconds = self.lease_duration
        try:
            # chaos seam: a crash (or drop) exactly between deciding to
            # renew and committing the renewal — the window where a
            # deposed-leader split brain is born (resilience/faultinject)
            from ..resilience.faultinject import faults
            faults.fire("lease_renew")
            self.lock.create_or_update(new)
        except ConflictError:
            # another elector wrote the lease between our read and our write:
            # the write with the stale resource_version loses (no split brain)
            cur = self.lock.get()
            if cur is not None and cur.holder_identity == self.identity:
                self._last_renew = now
                self.fence_epoch = cur.lease_transitions
                self._win()
                return True
            if self.is_leader:
                self._lose()
            return False
        except Exception:
            return self.is_leader
        self._last_renew = now
        self.fence_epoch = new.lease_transitions
        self._win()
        return True

    def _win(self) -> None:
        if not self.is_leader:
            self.is_leader = True
            if self.on_started_leading is not None:
                self.on_started_leading()

    def _lose(self) -> None:
        self.is_leader = False
        if self.on_stopped_leading is not None:
            self.on_stopped_leading()

    def fencing_token(self) -> Optional[dict]:
        """The token every fenced store write must carry ({lock, holder,
        epoch}; see client.store.FencedStore), or None when this elector
        does not currently believe it leads — FencedStore then fails the
        write closed instead of writing unfenced."""
        if not self.is_leader or self.fence_epoch is None:
            return None
        return {"lock": self.lock.name, "holder": self.identity,
                "epoch": self.fence_epoch}

    def release(self) -> None:
        """Voluntarily give up the lease (clean shutdown)."""
        lease = self.lock.get()
        if lease is not None and lease.holder_identity == self.identity:
            lease.renew_time = 0.0
            lease.holder_identity = ""
            try:
                self.lock.create_or_update(lease)
            except (ConflictError, NotFoundError):
                pass  # already taken over or deleted; nothing to release
        if self.is_leader:
            self._lose()

    # -- wall-clock loop ----------------------------------------------------

    def run(self, stop: threading.Event,
            release_on_stop: bool = True) -> None:
        """Renew until ``stop``; ``release_on_stop=False`` leaves the
        release to the caller — the SIGTERM contract releases only AFTER
        the async bind effectors drained, so a standby cannot take over
        with this leader's binds still in flight."""
        while not stop.is_set():
            self.step()
            stop.wait(self.retry_period)
        if release_on_stop:
            self.release()
