"""Crash-safe migration waves: the write-ahead migration-intent journal
and its takeover reconciliation pass.

The rescheduler executes a plan as per-source-node eviction waves through
the fenced Statement machinery. Before a wave's evictions dispatch, the
whole wave is persisted as ONE ``migrationintents`` store object (the
bind-intent pattern applied to the *eviction* side of a migration), so a
leader crash mid-plan leaves a durable record of exactly what was in
flight.

Reconciliation is deliberately asymmetric to bind recovery: a swallowed
BIND is re-driven (the gang must complete as decided), but a swallowed
EVICTION is **abandoned** — the next reschedule pass re-solves against
fresh cluster state, and re-driving a stale eviction could kill a pod
whose migration stopped making sense the moment the landscape changed.
Abandon-don't-redrive means a crash can only under-migrate, never
double-evict, and the bind side of every migration (the replacement
pod's placement) rides the allocate path's own bind-intent journal.
``reconcile_migration_intents`` is the pass a new leader runs before its
first cycle (Scheduler.run_with_leader_election calls it right after
resilience.reconcile_bind_intents).
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import List, Optional

from ..client.store import FencedError, NotFoundError
from ..models import MigrationIntent

log = logging.getLogger(__name__)

#: sweeps an intent survives with unsettled evictions before it is
#: presumed contained/rolled back and dropped (same rationale as
#: recovery.SWEEP_GENERATIONS: async effectors may land a cycle late)
SWEEP_GENERATIONS = 2


class MigrationIntentJournal:
    """Write-ahead journal of decided migration waves. ``cluster`` should
    be the writer's FENCED store handle so a deposed leader cannot
    journal new waves; reads pass through unfenced."""

    def __init__(self, cluster, identity: str = "", clock=time.time):
        self.cluster = cluster
        self.identity = identity
        self.clock = clock
        self._seq = 0
        self._gen = 0
        #: waves THIS process wrote and has not yet confirmed:
        #: (name, gen, moves)
        self._pending: List[tuple] = []

    def record(self, moves) -> Optional[MigrationIntent]:
        """Persist one intent for a decided wave of MoveCandidates.
        A FencedError propagates: a deposed leader must not migrate."""
        quads = [[m.namespace, m.name, m.from_node, m.to_node]
                 for m in moves]
        if not quads:
            return None
        fencing = None
        token_provider = getattr(self.cluster, "_token_provider", None)
        if token_provider is not None:
            fencing = token_provider()
        self._seq += 1
        intent = MigrationIntent(
            name=f"mi-{uuid.uuid4().hex[:8]}-{self._seq}",
            moves=quads,
            holder=(fencing or {}).get("holder", self.identity),
            epoch=int((fencing or {}).get("epoch", 0)),
            created=self.clock(),
        )
        self.cluster.create("migrationintents", intent)
        self._pending.append((intent.name, self._gen, quads))
        try:
            from ..metrics import metrics
            metrics.reschedule_intents_total.inc(
                labels={"event": "recorded"})
        except Exception:  # noqa: BLE001
            pass
        return intent

    def _settled(self, quads) -> bool:
        """A wave is settled once every decided eviction is visible in
        pod truth: the pod is gone, terminating (deletion_timestamp
        stamped), or already replaced off its source node."""
        for ns, name, from_node, _to in quads:
            pod = self.cluster.try_get("pods", name, ns)
            if pod is None or pod.deletion_timestamp is not None:
                continue
            if pod.node_name and pod.node_name != from_node:
                continue  # already rebound elsewhere
            return False
        return True

    def sweep(self) -> int:
        """Confirm-and-delete waves whose evictions all landed, plus
        waves old enough that their statement must have committed or
        discarded. Returns how many cleared."""
        self._gen += 1
        keep, cleared = [], 0
        for name, gen, quads in self._pending:
            try:
                settled = self._settled(quads)
            except Exception:  # noqa: BLE001 — store away: retry next cycle
                log.exception("migration-intent sweep could not read "
                              "pod truth")
                keep.append((name, gen, quads))
                continue
            if self._gen - gen < SWEEP_GENERATIONS and not settled:
                keep.append((name, gen, quads))
                continue
            try:
                self.cluster.delete("migrationintents", name)
            except NotFoundError:
                pass
            except FencedError:
                keep.append((name, gen, quads))
                break  # deposed mid-sweep: recovery cleans up
            except Exception:  # noqa: BLE001 — retry next cycle
                log.exception("migration-intent sweep failed for %s", name)
                keep.append((name, gen, quads))
                continue
            cleared += 1
        self._pending = keep
        if cleared:
            try:
                from ..metrics import metrics
                metrics.reschedule_intents_total.inc(
                    cleared, labels={"event": "confirmed"})
            except Exception:  # noqa: BLE001
                pass
        return cleared


def reconcile_migration_intents(cluster, fencing_token=None) -> dict:
    """The takeover pass (run at leadership acquisition alongside
    reconcile_bind_intents, BEFORE the first cycle).

    Every surviving intent is settled against pod truth per decided
    eviction:

    - pod gone, terminating, or rebound off its source -> **settled**
      (the wave landed; replacements flow through the normal pipeline);
    - pod still running on its source -> **abandoned** (the eviction
      never dispatched; the remainder of the dead leader's plan is
      dropped, never re-driven — see module docstring).

    The intent is deleted afterwards in every case, so the successor
    starts with a clean migration ledger whose decision trace matches
    pod truth exactly.
    """
    token = fencing_token() if callable(fencing_token) else fencing_token
    summary = {"intents": 0, "settled": 0, "abandoned": 0}
    try:
        intents = cluster.list("migrationintents")
    except Exception:  # noqa: BLE001 — store down: retry next acquisition
        log.exception("migration-intent recovery could not list intents")
        raise
    intents.sort(key=lambda i: (i.created, i.name))
    from ..metrics import metrics
    for intent in intents:
        summary["intents"] += 1
        for ns, name, from_node, _to in intent.moves:
            pod = cluster.try_get("pods", name, ns)
            if pod is None or pod.deletion_timestamp is not None \
                    or (pod.node_name and pod.node_name != from_node):
                outcome = "settled"
            else:
                outcome = "abandoned"
            summary[outcome] += 1
            metrics.reschedule_intents_total.inc(
                labels={"event": outcome})
        try:
            cluster.delete("migrationintents", intent.name, fencing=token)
        except NotFoundError:
            pass
    if summary["intents"]:
        log.warning("migration-intent recovery: %s", summary)
    return summary
