"""Crash-safe bind recovery: the write-ahead intent journal + the
takeover reconciliation pass.

The gang transaction boundary (framework/statement.py) decides a wave of
binds in session memory, then applies them through the cache effectors.
A crash between the decision and the last store write loses or
half-applies the wave: the reference survives this because the API
server holds pod truth and the next scheduler instance re-lists, but a
half-bound GANG is still wrong — some members run, the rest re-queue,
and nothing records what the dead leader had decided.

``BindIntentJournal`` closes that window Omega-style (PAPERS.md): before
any bind effect dispatches, the whole decided task->node map is
persisted as ONE ``bindintents`` store object carrying the writer's
lease fencing token. ``reconcile_bind_intents`` runs at leadership
acquisition (scheduler.run_with_leader_election): every surviving intent
is settled against pod truth — bindings the store already shows are
adopted, bindings the crash swallowed are re-driven with the NEW
leader's fencing token (completing the gang exactly as the dead leader
decided, so the recovered bind set is byte-identical to an
uninterrupted run), and the intent is deleted. Zero duplicates (only
unbound pods are re-driven) and zero lost gang members (every decided
binding either landed or is re-driven).

In steady state intents are garbage-collected by ``sweep()`` — called
once per scheduling cycle by the leader — which deletes an intent once
every binding is visible in the store (async effectors may lag a cycle)
or after two sweeps, whichever comes first. The journal is leader-only
(``SchedulerCache.bind_journal`` is None outside
run_with_leader_election), so non-HA embeddings pay nothing.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import List, Optional

from ..client.store import FencedError, NotFoundError
from ..models import BindIntent

log = logging.getLogger(__name__)

#: sweeps an intent survives with unbound pods before it is presumed
#: failed (its statement unwound session-side) and dropped — two, not
#: one, because pipelined async effectors may land a cycle late
SWEEP_GENERATIONS = 2


class BindIntentJournal:
    """Write-ahead journal of decided binds (see module docstring).

    ``cluster`` should be the writer's FENCED store handle so a deposed
    leader cannot journal new intents; reads pass through unfenced.
    """

    def __init__(self, cluster, identity: str = "",
                 clock=time.time):
        self.cluster = cluster
        self.identity = identity
        self.clock = clock
        self._seq = 0
        self._gen = 0
        #: intents THIS process wrote and has not yet confirmed:
        #: (name, gen, bindings)
        self._pending: List[tuple] = []

    def record(self, tasks) -> Optional[BindIntent]:
        """Persist one intent for a decided wave of allocate tasks
        (task.node_name already set). Returns the stored intent, or None
        for an empty wave. A FencedError propagates: a deposed leader
        must not journal, let alone bind."""
        bindings = [[t.namespace, t.name, t.node_name]
                    for t in tasks if t.node_name]
        if not bindings:
            return None
        fencing = None
        token_provider = getattr(self.cluster, "_token_provider", None)
        if token_provider is not None:
            fencing = token_provider()
        self._seq += 1
        intent = BindIntent(
            name=f"bi-{uuid.uuid4().hex[:8]}-{self._seq}",
            job=tasks[0].job,
            bindings=bindings,
            holder=(fencing or {}).get("holder", self.identity),
            epoch=int((fencing or {}).get("epoch", 0)),
            created=self.clock(),
        )
        self.cluster.create("bindintents", intent)
        self._pending.append((intent.name, self._gen, bindings))
        try:
            from ..metrics import metrics
            metrics.bind_intents_total.inc(labels={"event": "recorded"})
        except Exception:  # noqa: BLE001
            pass
        return intent

    def _settled(self, bindings) -> bool:
        for ns, name, _node in bindings:
            pod = self.cluster.try_get("pods", name, ns)
            if pod is not None and not pod.node_name:
                return False  # bind effect still in flight (or failed)
        return True

    def sweep(self) -> int:
        """Confirm-and-delete intents whose bindings are all visible in
        the store (the pod's own bound state IS the confirmation — no
        extra ack write races the async effectors), plus intents old
        enough that their effects must have either landed or unwound.
        Only touches intents THIS process recorded; a dead leader's
        intents are the recovery pass's job. Returns how many cleared."""
        self._gen += 1
        keep, cleared = [], 0
        for name, gen, bindings in self._pending:
            try:
                settled = self._settled(bindings)
            except Exception:  # noqa: BLE001 — store away: retry next cycle
                log.exception("bind-intent sweep could not read pod truth")
                keep.append((name, gen, bindings))
                continue
            if self._gen - gen < SWEEP_GENERATIONS and not settled:
                keep.append((name, gen, bindings))
                continue
            try:
                self.cluster.delete("bindintents", name)
            except NotFoundError:
                pass
            except FencedError:
                # deposed mid-sweep: stop writing; recovery cleans up
                keep.append((name, gen, bindings))
                break
            except Exception:  # noqa: BLE001 — retry next cycle
                log.exception("bind-intent sweep failed for %s", name)
                keep.append((name, gen, bindings))
                continue
            cleared += 1
        self._pending = keep
        if cleared:
            try:
                from ..metrics import metrics
                metrics.bind_intents_total.inc(
                    cleared, labels={"event": "confirmed"})
            except Exception:  # noqa: BLE001
                pass
        return cleared


def reconcile_bind_intents(cluster, fencing_token=None) -> dict:
    """The takeover reconciliation pass (run at leadership acquisition,
    BEFORE the first scheduling cycle).

    For every surviving intent, settle each decided binding against pod
    truth:

    - pod already bound to the intended node -> **adopted** (the crash
      happened post-collect; the watch stream folds it into the mirror);
    - pod exists, unbound -> **redriven**: the bind is applied now with
      the NEW leader's fencing token, completing the gang exactly as
      decided (zero lost members, and identical to the uninterrupted
      run's bind set);
    - pod bound elsewhere -> **conflict** (left alone — pod truth wins);
    - pod gone -> **lost** (retired/evicted between decision and
      recovery; nothing to do).

    The intent is deleted afterwards in every case. ``fencing_token`` is
    a dict or a provider callable; re-driven writes carry it so this
    pass is itself fenced out if leadership is lost mid-recovery.
    """
    token = fencing_token() if callable(fencing_token) else fencing_token
    summary = {"intents": 0, "adopted": 0, "redriven": 0,
               "conflicts": 0, "lost": 0}
    try:
        intents = cluster.list("bindintents")
    except Exception:  # noqa: BLE001 — store down: retry next acquisition
        log.exception("bind-intent recovery could not list intents")
        raise
    intents.sort(key=lambda i: (i.created, i.name))
    from ..metrics import metrics
    for intent in intents:
        summary["intents"] += 1
        for ns, name, node in intent.bindings:
            pod = cluster.try_get("pods", name, ns)
            if pod is None:
                outcome = "lost"
            elif pod.node_name == node:
                outcome = "adopted"
            elif pod.node_name:
                outcome = "conflict"
                log.warning(
                    "bind intent %s: pod %s/%s bound to %r, intent said "
                    "%r — pod truth wins", intent.name, ns, name,
                    pod.node_name, node)
            else:
                # the decided bind never reached the store: drive it now,
                # exactly as the dead leader's binder would have
                pod.node_name = node
                pod.phase = "Running"
                cluster.update("pods", pod, fencing=token)
                outcome = "redriven"
            key = "conflicts" if outcome == "conflict" else outcome
            summary[key] += 1
            metrics.recovery_intents_total.inc(
                labels={"outcome": outcome})
        try:
            cluster.delete("bindintents", intent.name, fencing=token)
        except NotFoundError:
            pass
    if summary["intents"]:
        log.warning("bind-intent recovery: %s", summary)
    return summary
