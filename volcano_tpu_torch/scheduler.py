"""Scheduler: the periodic session loop (reference pkg/scheduler/scheduler.go:39-110).

Each cycle: load (possibly hot-reloaded) conf -> OpenSession -> run each
configured action -> CloseSession. The conf file is watched by mtime (the
reference uses fsnotify; polling keeps this dependency-free).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from . import actions as _actions  # noqa: F401  (registers actions)
from . import plugins as _plugins  # noqa: F401  (registers plugins)
from .cache import SchedulerCache
from .conf import DEFAULT_SCHEDULER_CONF, load_scheduler_conf
from .framework import close_session, get_action, open_session
from .metrics import metrics, tracing
from .resilience import ActionTimeout

log = logging.getLogger(__name__)

DEFAULT_SCHEDULE_PERIOD = 1.0  # seconds (options.go:83)


#: actions of the JAX package this package does not run yet, with the
#: ROADMAP item that ports each (none: every action is ported)
UNPORTED_ACTIONS: dict = {}


def check_conf_ported(conf) -> None:
    """Raise NotImplementedError for a conf that names an action or an
    action mode this package does not have yet: at conf loading, so it
    can never degrade into a host fallback later."""
    from .framework.interface import check_mode_ported
    from .framework import Arguments

    for name in conf.actions:
        item = UNPORTED_ACTIONS.get(name)
        if item is not None:
            raise NotImplementedError(
                f"action {name!r} is not ported yet (ROADMAP {item})")
    for c in conf.configurations:
        check_mode_ported(Arguments(c.arguments).get("mode", ""))


class Scheduler:
    def __init__(self, cache: SchedulerCache,
                 scheduler_conf: Optional[str] = None,
                 conf_path: Optional[str] = None,
                 period: float = DEFAULT_SCHEDULE_PERIOD,
                 percentage_of_nodes_to_find: int = 100,
                 compile_cache_dir: Optional[str] = None,
                 prewarm: bool = False,
                 pipeline_solver: bool = True,
                 action_deadline_s: Optional[float] = None,
                 breaker_failures: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 solver_mode: Optional[str] = None,
                 sharded_byte_budget: int = 0,
                 reschedule_interval: int = 0,
                 reschedule_max_moves: Optional[int] = None,
                 reschedule_max_disruption: Optional[int] = None,
                 reschedule_min_improvement: Optional[float] = None):
        if solver_mode not in (None, "packed", "sharded", "auto"):
            raise ValueError(f"solver_mode must be None, 'packed', "
                             f"'sharded' or 'auto': {solver_mode!r}")
        # adaptive host-loop node sampling knob, instance-scoped
        # (cmd/scheduler/app/options/options.go:37-40)
        from .utils import NodeSampler
        self.node_sampler = NodeSampler(percentage_of_nodes_to_find)
        self.cache = cache
        self.period = period
        self.conf_path = conf_path
        self._conf_mtime = 0.0
        self._conf_text = scheduler_conf or DEFAULT_SCHEDULER_CONF
        self._conf_bad_text: Optional[str] = None
        self.actions = []
        self.tiers = []
        self.configurations = []
        self.load_conf()
        # resilience wiring (resilience/): the device-path circuit breaker
        # lives on the CACHE so sessions and all solver-dispatching
        # actions share one failure account, and the optional per-action
        # deadline watchdog contains hung actions (None = actions run
        # inline, exactly the pre-watchdog path)
        from .resilience import ActionWatchdog, CircuitBreaker
        if getattr(cache, "breaker", None) is None:
            cache.breaker = CircuitBreaker(
                "device-solver", failure_threshold=breaker_failures,
                cooldown_s=breaker_cooldown_s)
        self.action_deadline_s = action_deadline_s
        self._watchdog = ActionWatchdog(action_deadline_s) \
            if action_deadline_s else None
        # solver-mode preference (None keeps per-action conf routing):
        # "packed" pins the single-device solver, "sharded" the node-axis
        # sharded solver over the sharded arena, "auto" shards exactly when
        # the padded problem's device-resident footprint exceeds the byte
        # budget (framework.interface.Action.resolve_mode)
        if solver_mode:
            cache.solver_mode = solver_mode
        if sharded_byte_budget:
            cache.sharded_byte_budget = int(sharded_byte_budget)
        # compile-and-dispatch pipeline (ops.precompile): the kernel build
        # directory (explicit dir or $VOLCANO_COMPILE_CACHE_DIR), the
        # background next-bucket pre-warm, and the allocate action's
        # dispatch/collect overlap. All three are pure-latency features —
        # decisions are identical with them on or off
        from .ops import precompile as _pc
        self.compile_cache_dir = _pc.configure_compilation_cache(
            compile_cache_dir)
        cache.pipeline_solver = bool(pipeline_solver)
        if prewarm and getattr(cache, "prewarmer", None) is None:
            cache.prewarmer = _pc.BucketPrewarmer()
        if prewarm or self.compile_cache_dir:
            _pc.watcher.install()
        self._compile_totals = _pc.watcher.session_totals()
        # last-exported delta-watch counter snapshot (client/remote.py
        # delta_stats accumulates forever; the registry counters get the
        # per-export increment)
        self._delta_totals: dict = {}
        # reschedule_* deployment flags: a positive interval opts the
        # global rescheduler in without a conf edit (load_conf appends the
        # action when the conf's actions string doesn't name it); the
        # bounding knobs become the action's defaults, per-action conf
        # arguments still win (reschedule/action.py DEFAULTS)
        self._reschedule_enabled = reschedule_interval > 0
        flags = {"interval": int(reschedule_interval)
                 if reschedule_interval > 0 else None,
                 "max_moves": reschedule_max_moves,
                 "max_disruption_per_job": reschedule_max_disruption,
                 "min_improvement": reschedule_min_improvement}
        flags = {k: v for k, v in flags.items() if v is not None}
        if flags:
            cache.reschedule_opts = dict(
                getattr(cache, "reschedule_opts", None) or {}, **flags)
            self.load_conf()  # re-apply: the first load ran pre-flag

    # -- conf hot reload (scheduler.go:112-170) -----------------------------

    def load_conf(self) -> None:
        text = self._conf_text
        if self.conf_path and os.path.exists(self.conf_path):
            mtime = os.path.getmtime(self.conf_path)
            if mtime != self._conf_mtime:
                self._conf_mtime = mtime
                with open(self.conf_path) as f:
                    text = f.read()
        if text == self._conf_bad_text:
            return  # known-bad reload, already logged: keep the last good
        try:
            conf = load_scheduler_conf(text)
            check_conf_ported(conf)
            acts = []
            for name in conf.actions:
                action = get_action(name)
                if action is None:
                    raise ValueError(f"failed to find action {name}")
                acts.append(action)
        except NotImplementedError:
            raise  # an unported option is not a malformed conf
        except Exception:
            if not self.actions:
                raise  # first load: there is no last-good conf to keep
            # last-good retention: a malformed hot-reloaded conf must not
            # raise out of every cycle until someone fixes the file —
            # keep scheduling on the previous conf, log once per change
            self._conf_bad_text = text
            metrics.conf_load_errors.inc()
            log.exception("scheduler conf reload failed; keeping the "
                          "last good conf")
            return
        self._conf_bad_text = None
        self._conf_text = text
        self.actions = acts
        self.tiers = conf.tiers
        self.configurations = conf.configurations
        # reschedule_interval opt-in: append the rescheduler when the
        # conf's actions string doesn't name it (and keep it appended
        # across hot reloads); a conf that DOES name `reschedule` places
        # it explicitly and is left alone
        if getattr(self, "_reschedule_enabled", False) \
                and all(a.name() != "reschedule" for a in self.actions):
            self.actions = list(self.actions) + [get_action("reschedule")]

    # -- the loop -----------------------------------------------------------

    def run_once(self) -> None:
        # Keep collector pauses out of the scheduling cycle: a 10k-pod
        # burst churns enough objects that a mid-replay gen-2 GC adds
        # hundreds of ms of jitter to exactly the latency the e2e
        # histogram tracks. Collection happens between cycles instead
        # (run() sleeps out the remainder of the period; see _maybe_gc).
        import gc
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            self._run_once_inner()
        finally:
            if gc_was_enabled:
                gc.enable()

    def _maybe_gc(self) -> None:
        """Between-cycles housekeeping: collect the young generations every
        cycle, and the full heap periodically — gen 2 never auto-collects
        while GC is disabled inside cycles, so without the periodic full
        pass promoted cyclic garbage would accumulate for the life of the
        process."""
        import gc
        self._gc_cycles = getattr(self, "_gc_cycles", 0) + 1
        full = self._gc_cycles % 20 == 0
        with tracing.traced("vc.gc", full=int(full)):
            if full:
                gc.collect()
            else:
                gc.collect(1)

    def _run_once_inner(self) -> None:
        # the phase keys of last_cycle_timing are the durations of the
        # cycle's spans (metrics.tracing), recorded or not
        timing = {}
        with tracing.span("vc.cycle") as cycle:
            with tracing.span("vc.open") as opened:
                self.load_conf()
                ssn = open_session(self.cache, self.tiers,
                                   self.configurations)
                ssn.node_sampler = self.node_sampler
            timing["open_ms"] = opened.ms
            try:
                for epoch, action in enumerate(self.actions):
                    name = action.name()
                    with tracing.span("vc.action", name=name) as acted:
                        ssn._action_epoch = epoch
                        try:
                            self._execute_action(ssn, action)
                        except ActionTimeout:
                            # deadline breach: the watchdog already dumped
                            # stacks; roll the abandoned action's
                            # statements back, fence its epoch so a zombie
                            # commit becomes a discard, and run the
                            # REMAINING actions of this cycle
                            ssn._contained_epochs.add(epoch)
                            n = ssn.discard_open_statements()
                            timing[f"{name}_timeout"] = 1.0
                            metrics.action_timeouts_total.inc(
                                labels={"action": name})
                            log.error("action %s exceeded its deadline; "
                                      "contained (%d open statement(s) "
                                      "discarded), running the remaining "
                                      "actions", name, n)
                        except Exception:
                            # a throwing action is contained the same way:
                            # its uncommitted statements discard and the
                            # cycle goes on (the reference contains
                            # per-cycle errors identically — one bad action
                            # must not starve backfill forever)
                            n = ssn.discard_open_statements()
                            timing[f"{name}_error"] = 1.0
                            metrics.action_failures_total.inc(
                                labels={"action": name})
                            log.exception("action %s failed; contained "
                                          "(%d open statement(s) "
                                          "discarded), running the "
                                          "remaining actions", name, n)
                    timing[f"{name}_ms"] = acted.ms
                    metrics.action_scheduling_latency.observe(
                        acted.ms * 1e3, labels={"action": name})
                # the allocate action's internal decomposition when it ran
                # in solver mode (flatten/solve/replay)
                for k, v in (ssn.solver_options.get("timing") or {}).items():
                    timing[k] = v
            finally:
                with tracing.span("vc.close") as closed:
                    close_session(ssn)
                timing["close_ms"] = closed.ms
        timing["total_ms"] = cycle.ms
        self._export_pipeline_metrics(timing)
        self.last_cycle_timing = timing
        metrics.e2e_scheduling_latency.observe(cycle.ms)

    def _execute_action(self, ssn, action) -> None:
        """Run one action, inline or under the deadline watchdog; the
        slow_action fault point lets the chaos harness simulate a hang."""
        from .resilience import faults

        epoch = ssn._action_epoch

        def run():
            faults.fire("slow_action")
            if epoch in ssn._contained_epochs:
                return  # abandoned while it waited: never starts
            action.execute(ssn)

        if self._watchdog is None:
            run()
        else:
            parent = tracing.current()

            def pinned():
                with tracing.adopt(parent):
                    ssn.pin_action_epoch(epoch)
                    run()

            self._watchdog.run(action.name(), pinned)

    #: timing keys exported per cycle as the volcano_session_phase_ms
    #: gauge — the cycle's flatten/upload/solve/replay decomposition
    #: (upload = pack + delta_plan host share)
    _PHASE_KEYS = ("open_ms", "flatten_ms", "pack_ms", "delta_plan_ms",
                   "dispatch_ms", "overlap_ms", "readback_ms", "solve_ms",
                   "replay_ms", "close_ms", "total_ms")

    def _export_pipeline_metrics(self, timing: dict) -> None:
        """Surface per-phase latency and the flatten / ordering / arena /
        breaker accounting in both the metrics registry and
        last_cycle_timing, so a cycle that degrades (a flatten or ordering
        fallback, a full re-ship, a host fallback) is observable, not a
        mystery spike in total_ms."""
        for key in self._PHASE_KEYS:
            if key in timing:
                metrics.session_phase_ms.set(
                    timing[key], labels={"phase": key[:-3]})
        # event-sourced flatten accounting (ops.arrays FlattenCache
        # ledger): which assembly path this cycle took, how many rows the
        # event patch touched, the patch-vs-full latency split, and the
        # fallback ladder's reason counters — exported alongside the
        # per-phase gauges because a cycle silently degrading from
        # O(events) to O(cluster) is exactly the regression these exist
        # to catch
        fc = getattr(self.cache, "flatten_cache", None)
        if fc is not None and getattr(fc, "events_enabled", False) \
                and "flatten_mode" in timing:
            mode = timing["flatten_mode"]
            metrics.flatten_cycles_total.inc(labels={"mode": mode})
            metrics.flatten_events_applied.set(
                timing.get("flatten_events_applied", 0.0))
            rows = timing.get("flatten_rows_patched", 0.0)
            metrics.flatten_rows_patched.set(rows)
            if rows:
                metrics.flatten_rows_patched_total.inc(rows)
            if "flatten_patch_ms" in timing:
                metrics.flatten_patch_ms.set(timing["flatten_patch_ms"])
            if "flatten_full_ms" in timing:
                metrics.flatten_full_ms.set(timing["flatten_full_ms"])
            reason = timing.get("flatten_fallback_reason")
            if reason:
                metrics.flatten_fallbacks_total.inc(
                    labels={"reason": str(reason)})
        # event-sourced ordering accounting (ops.ordering OrderCache):
        # same shape as the flatten family — which path the cycle's
        # ordering pass took, how many job entries it patched, the
        # event-vs-full latency split, and the typed fallback counters
        ocache = getattr(self.cache, "order_cache", None)
        if ocache is not None and "order_mode" in timing:
            mode = timing["order_mode"]
            metrics.order_cycles_total.inc(labels={"mode": mode})
            patched = timing.get("order_entries_patched", 0.0)
            metrics.order_entries_patched.set(patched)
            if patched and mode == "event":
                metrics.order_entries_patched_total.inc(patched)
            if "order_ms" in timing:
                if mode in ("reuse", "event"):
                    metrics.order_ms.set(timing["order_ms"])
                else:
                    metrics.order_full_ms.set(timing["order_ms"])
            reason = timing.get("order_fallback_reason")
            if reason:
                metrics.order_fallbacks_total.inc(
                    labels={"reason": str(reason)})
        # delta-watch wire accounting (client/remote.py delta_stats):
        # patch frames applied straight onto the mirror vs object-path
        # bytes, the decode-vs-apply ms split, and the interning-table
        # peak — the numbers that say whether the delta negotiation is
        # engaged and what it is saving. Fallback REASONS are counted at
        # the fallback site itself (volcano_delta_fallbacks_total).
        ds = getattr(getattr(self.cache, "cluster", None),
                     "delta_stats", None)
        if ds is not None and (ds["frames"] or ds["bytes_object"]):
            prev = self._delta_totals
            for key, counter in (
                    ("frames", metrics.delta_frames_total),
                    ("events", metrics.delta_patches_applied_total),
                    ("fields", metrics.delta_fields_applied_total)):
                d = ds[key] - prev.get(key, 0)
                if d > 0:
                    counter.inc(d)
            for key, mode in (("bytes_delta", "delta"),
                              ("bytes_object", "object")):
                d = ds[key] - prev.get(key, 0)
                if d > 0:
                    metrics.delta_stream_bytes_total.inc(
                        d, labels={"mode": mode})
            metrics.delta_decode_ms.set(ds["decode_ms"])
            metrics.delta_apply_ms.set(ds["apply_ms"])
            metrics.delta_vocab_size.set(ds["vocab"])
            self._delta_totals = {
                k: ds[k] for k in ("frames", "events", "fields",
                                   "bytes_delta", "bytes_object")}
            timing["delta_events_applied"] = float(ds["events"])
            timing["delta_decode_ms"] = ds["decode_ms"]
            timing["delta_apply_ms"] = ds["apply_ms"]
        # device-resident arena accounting (ops.device_cache), exported
        # per solver mode: a sharded session's bytes land on the sharded
        # arena's series, never on the packed one. Bytes shipped per
        # steady session and the hit rate say whether the delta upload is
        # engaged (per-cycle bytes come from the allocate action's timing;
        # the gauges are each arena's cumulative view)
        active_mode = timing.get("arena_mode")
        for mode, attr in (("packed", "device_cache"),
                           ("sharded", "sharded_device_cache")):
            dc = getattr(self.cache, attr, None)
            if dc is None or not dc.sessions:
                continue
            lbl = {"mode": mode}
            if mode == active_mode or active_mode is None:
                timing["arena_hit_rate"] = dc.arena_hit_rate
            per_cycle = (timing.get("arena_bytes_shipped",
                                    dc.last_shipped_bytes)
                         if mode == active_mode else dc.last_shipped_bytes)
            metrics.arena_bytes_shipped.set(per_cycle, labels=lbl)
            metrics.arena_bytes_shipped_total.set(
                dc.total_shipped_bytes, labels=lbl)
            metrics.arena_hit_rate.set(dc.arena_hit_rate, labels=lbl)
            metrics.arena_sessions_total.set(
                dc.delta_sessions, labels={"outcome": "delta", **lbl})
            metrics.arena_sessions_total.set(
                dc.full_ships, labels={"outcome": "full", **lbl})
            metrics.arena_invalidations_total.set(
                dc.invalidations, labels=lbl)
            metrics.arena_params_repins_total.set(
                dc.params_repins, labels=lbl)
            if mode == "sharded":
                for d, b in enumerate(dc.last_shard_bytes):
                    metrics.arena_shard_bytes_shipped.set(
                        b, labels={"shard": str(d)})
        # the cycle's compile accounting (ops.precompile): kernel builds
        # and cold first solves on the session thread since the last cycle
        from .ops.precompile import watcher
        c, secs = watcher.session_totals()
        prev_c, prev_s = self._compile_totals
        self._compile_totals = (c, secs)
        timing["session_compiles"] = float(c - prev_c)
        timing["session_compile_s"] = secs - prev_s
        timing["compile_cache_hits"] = float(watcher.cache_hits)
        pw = getattr(self.cache, "prewarmer", None)
        if pw is not None:
            timing["prewarm_completions"] = float(pw.completions)
        br = getattr(self.cache, "breaker", None)
        if br is not None:
            # the degradation ladder made observable per cycle: 0=closed
            # (device path live), 1=half-open probe, 2=open (host oracle)
            timing["breaker_state"] = float(br.state_code)
            timing["breaker_fallback_cycles"] = float(br.fallback_cycles)

    def shadow_cycle(self) -> None:
        """One write-free scheduling cycle against the live mirror: the
        warm-standby trick. The full session pipeline — snapshot, flatten,
        solve, replay — runs with every effector swapped for a fake, so
        the standby's kernel library, flatten/order caches, device arena
        and first-solve keys are exactly as hot as the leader's, and the
        first post-takeover cycle neither re-ships its arena nor flattens
        cold. Afterwards every mirror mutation the fake-committed
        binds/evicts made is resynced from store truth, and podgroups are
        re-read, so the mirror is as before the shadow ran."""
        import copy

        from .cache.fakes import (
            FakeBinder, FakeEvictor, FakeStatusUpdater, FakeVolumeBinder,
        )

        cache = self.cache
        saved = (cache.binder, cache.evictor, cache.status_updater,
                 cache.volume_binder, cache.bind_journal,
                 getattr(cache, "decision_recorder", None))
        shadow_binder, shadow_evictor = FakeBinder(), FakeEvictor()
        cache.binder, cache.evictor = shadow_binder, shadow_evictor
        cache.status_updater = FakeStatusUpdater()
        cache.volume_binder = FakeVolumeBinder()
        cache.bind_journal = None
        cache.decision_recorder = None
        # JobInfo clones SHARE the pod_group object with the mirror (and,
        # in-process, with the store): give each job a private copy so
        # the shadow session's phase flips/conditions can't leak out.
        # Under the store lock: watch deliveries mutate cache.jobs
        # concurrently.
        with cache.cluster.locked():
            for job in list(cache.jobs.values()):
                if job.pod_group is not None:
                    job.set_pod_group(copy.deepcopy(job.pod_group))
        try:
            self.load_conf()
            ssn = open_session(self.cache, self.tiers, self.configurations)
            ssn.node_sampler = self.node_sampler
            try:
                for epoch, action in enumerate(self.actions):
                    ssn._action_epoch = epoch
                    try:
                        self._execute_action(ssn, action)
                    except Exception:
                        ssn.discard_open_statements()
                        log.exception("shadow cycle action %s failed "
                                      "(contained)", action.name())
            finally:
                close_session(ssn)
        except Exception:
            log.exception("shadow cycle failed")
        finally:
            # drain BEFORE restoring: an async bind effect reads
            # cache.binder at run time, and must still see the fake
            try:
                cache.wait_for_effects()
            except Exception:  # noqa: BLE001
                log.exception("shadow cycle effect drain failed")
            (cache.binder, cache.evictor, cache.status_updater,
             cache.volume_binder, cache.bind_journal,
             cache.decision_recorder) = saved
            # undo the fake-committed mirror mutations from store truth;
            # resync the STORED task (its node_name reflects the fake
            # bind) so the node-side accounting unwinds too
            from .api import TaskInfo
            for pod in list(shadow_binder.bound_pods) \
                    + list(shadow_evictor.evicted_pods):
                ti = TaskInfo(pod)
                cache.resync_task(cache._stored_task(ti) or ti)
            cache.process_resync_tasks()
            try:
                for pg in cache.cluster.list("podgroups"):
                    cache.set_pod_group(pg)
            except Exception:  # noqa: BLE001 — store briefly away: mirror
                log.exception("shadow cycle podgroup refresh failed")
            # re-baseline the compile accounting: first solves during the
            # shadow belong to the standby era, so the first REAL
            # post-takeover cycle reports session_compiles == 0 when the
            # warm-up did its job
            from .ops.precompile import watcher
            self._compile_totals = watcher.session_totals()

    def run_with_leader_election(self, stop, lock_name: str = "volcano",
                                 identity: Optional[str] = None,
                                 lease_duration: Optional[float] = None,
                                 renew_deadline: Optional[float] = None,
                                 retry_period: Optional[float] = None,
                                 warm_standby: bool = True) -> None:
        """HA mode (cmd/scheduler/app/server.go:85-145): only the lease
        holder schedules; standbys poll the lease and take over on expiry.
        The lease timings are overridable (tests shrink them to fail over
        in seconds; the defaults match the reference's 15/10/5).

        Crash-safe failover ladder:

        - **fencing** — every effector write carries this elector's lease
          token (cache.install_fencing); a deposed leader's late commit
          is a FencedError, not a split-brain bind;
        - **bind-intent journal** — the leader journals each decided bind
          wave before dispatching it (resilience/recovery.py), and sweeps
          confirmed intents once per cycle;
        - **recovery** — at every leadership acquisition the surviving
          intents reconcile against pod truth (adopt / re-drive), then the
          migration intents (reschedule/intent.py), BEFORE the first cycle;
        - **warm standby** — the mirror subscribes immediately (not at
          first leadership) and, with ``warm_standby``, the standby runs
          write-free shadow cycles so takeover starts with a warm arena,
          flatten and first-solve keys;
        - **drain-then-release** — on stop, the lease is released only
          after the async bind effectors drained.

        Lease renewal runs on its own thread at the elector's retry period
        (like client-go's renew loop), so a long scheduling cycle or a long
        schedule-period can't blow the renew deadline."""
        import threading

        from .reschedule import reconcile_migration_intents
        from .resilience.recovery import (
            BindIntentJournal, reconcile_bind_intents,
        )
        from .utils import (
            LEASE_DURATION, RENEW_DEADLINE, RETRY_PERIOD, LeaderElector,
            LeaseLock,
        )

        # a read-tiered cache cluster (client.readtier.ReadTierStore)
        # still arbitrates its lease — and replays the dead leader's
        # intents — against the PRIMARY: takeover truth never rides a
        # replica's staleness
        store = getattr(self.cache.cluster, "write_store",
                        self.cache.cluster)
        elector = LeaderElector(
            LeaseLock(store, lock_name), identity=identity,
            lease_duration=lease_duration or LEASE_DURATION,
            renew_deadline=renew_deadline or RENEW_DEADLINE,
            retry_period=retry_period or RETRY_PERIOD)
        self._elector = elector
        self.cache.install_fencing(elector.fencing_token)
        journal = BindIntentJournal(self.cache.fenced_cluster,
                                    identity=elector.identity)
        renewer = threading.Thread(target=elector.run,
                                   args=(stop,), kwargs={
                                       "release_on_stop": False},
                                   name="leader-elector", daemon=True)
        renewer.start()
        # warm standby: the mirror subscribes NOW, leader or not
        self.cache.run()
        self.cache.wait_for_cache_sync()
        was_leader = False
        last_shadow = 0.0
        while not stop.is_set():
            if elector.is_leader:
                if not was_leader:
                    # takeover: settle the dead leader's journaled binds
                    # before scheduling anything, then settle-or-abandon
                    # its in-flight migration waves (reschedule/intent.py:
                    # swallowed evictions are ABANDONED, never re-driven)
                    try:
                        reconcile_bind_intents(store, elector.fencing_token)
                        reconcile_migration_intents(store,
                                                    elector.fencing_token)
                    except Exception:
                        log.exception("bind/migration-intent recovery "
                                      "failed; retrying before the first "
                                      "cycle")
                        stop.wait(0.05)
                        continue
                    self.cache.bind_journal = journal
                    was_leader = True
                self.cache.process_resync_tasks()
                try:
                    self.run_once()
                except Exception:
                    log.exception("scheduling cycle failed")
                journal.sweep()
                self._maybe_gc()
                stop.wait(self.period)
            else:
                if was_leader:
                    was_leader = False
                    self.cache.bind_journal = None
                if warm_standby \
                        and time.time() - last_shadow >= self.period:
                    self.shadow_cycle()
                    last_shadow = time.time()
                stop.wait(0.05)
        # SIGTERM contract: land the in-flight binds, then hand the lease
        # over — the standby must not take over around live writes
        self.cache.wait_for_effects()
        elector.release()
        renewer.join(timeout=2 * elector.retry_period)

    def run(self, stop_after: Optional[int] = None) -> None:
        """Run the periodic loop; stop_after bounds cycles for tests.

        The loop deliberately never blocks on the cache's async bind
        effectors: with async_effectors on, cycle N's store writes drain
        on the effector pool while cycle N+1 opens its session — the
        snapshot clone and the effector-side accounting both run behind
        the cache lock, so the overlap is race-free and the next snapshot
        always sees a consistent mirror (the writes it may not yet see
        are exactly the ones an informer-fed reference scheduler would
        also still have in flight)."""
        self.cache.run()
        self.cache.wait_for_cache_sync()
        cycles = 0
        while stop_after is None or cycles < stop_after:
            start = time.time()
            self.cache.process_resync_tasks()
            try:
                self.run_once()
            except Exception:
                log.exception("scheduling cycle failed")
            cycles += 1
            if stop_after is not None and cycles >= stop_after:
                break
            self._maybe_gc()
            elapsed = time.time() - start
            if elapsed < self.period:
                time.sleep(self.period - elapsed)
