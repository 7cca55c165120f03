"""Prometheus-style metrics registry (reference pkg/scheduler/metrics/).

A dependency-free implementation of counters/gauges/histograms with labels
and text exposition, covering the reference's metric set
(metrics.go:41-128, queue.go, job.go, namespace.go).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

VOLCANO_NAMESPACE = "volcano"


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


#: one lock for all metric mutations: observations come from the scheduler
#: thread, the async effector pool, and the job-updater fan-out; the
#: read-modify-write ops below are not atomic under the GIL
_metrics_lock = threading.Lock()


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Iterable[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = list(label_names)


class Counter(_Metric):
    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple, float] = {}

    def inc(self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None):
        k = _label_key(labels)
        with _metrics_lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for k, v in sorted(self._values.items()):
            out.append(f"{self.name}{_fmt_labels(k)} {v}")
        return out


class Gauge(_Metric):
    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, labels: Optional[Dict[str, str]] = None):
        self._values[_label_key(labels)] = value

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def delete(self, labels: Optional[Dict[str, str]] = None):
        self._values.pop(_label_key(labels), None)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for k, v in sorted(self._values.items()):
            out.append(f"{self.name}{_fmt_labels(k)} {v}")
        return out


_DEF_BUCKETS = tuple(0.001 * (2 ** i) for i in range(15))  # 1ms .. ~16s


class Histogram(_Metric):
    def __init__(self, name, help_, label_names=(), buckets=_DEF_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple, List[int]] = {}
        self._sum: Dict[Tuple, float] = {}
        self._n: Dict[Tuple, int] = {}

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None):
        k = _label_key(labels)
        with _metrics_lock:
            self._observe_locked(k, value)

    def _observe_locked(self, k, value: float):
        # per-BUCKET tallies with one bisect (cumulative sums are computed
        # at collect time): observe() runs once per bind on the replay hot
        # path, where the previous 15-increment linear scan was measurable
        # at 10k tasks/cycle
        counts = self._counts.setdefault(k, [0] * len(self.buckets))
        i = bisect.bisect_left(self.buckets, value)
        if i < len(self.buckets):
            counts[i] += 1
        self._sum[k] = self._sum.get(k, 0.0) + value
        self._n[k] = self._n.get(k, 0) + 1

    def observe_many(self, values, labels: Optional[Dict[str, str]] = None):
        """Batch observe: one lock/key resolution for a whole wave of
        samples (the batched bind effector observes per task; a 10k-pod
        burst is 10k samples)."""
        values = list(values)
        if not values:
            return
        k = _label_key(labels)
        with _metrics_lock:
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            total = 0.0
            nb = len(self.buckets)
            for value in values:
                i = bisect.bisect_left(self.buckets, value)
                if i < nb:
                    counts[i] += 1
                total += value
            self._sum[k] = self._sum.get(k, 0.0) + total
            self._n[k] = self._n.get(k, 0) + len(values)

    def get_count(self, labels=None) -> int:
        return self._n.get(_label_key(labels), 0)

    def get_sum(self, labels=None) -> float:
        return self._sum.get(_label_key(labels), 0.0)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for k in sorted(self._n):
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[k][i]
                lk = k + (("le", repr(b)),)
                out.append(f"{self.name}_bucket{_fmt_labels(lk)} {cum}")
            out.append(f"{self.name}_bucket{_fmt_labels(k + (('le', '+Inf'),))} {self._n[k]}")
            out.append(f"{self.name}_sum{_fmt_labels(k)} {self._sum[k]}")
            out.append(f"{self.name}_count{_fmt_labels(k)} {self._n[k]}")
        return out


def _fmt_labels(k: Tuple) -> str:
    if not k:
        return ""
    inner = ",".join(f'{name}="{val}"' for name, val in k)
    return "{" + inner + "}"


class Registry:
    def __init__(self):
        self._metrics: List[_Metric] = []

    def register(self, m):
        self._metrics.append(m)
        return m

    def expose(self) -> str:
        lines: List[str] = []
        for m in self._metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


registry = Registry()

# -- scheduler metrics (metrics.go:41-128) ----------------------------------

e2e_scheduling_latency = registry.register(Histogram(
    "volcano_e2e_scheduling_latency_milliseconds",
    "E2e scheduling latency in milliseconds"))
action_scheduling_latency = registry.register(Histogram(
    "volcano_action_scheduling_latency_microseconds",
    "Action scheduling latency", ["action"]))
plugin_scheduling_latency = registry.register(Histogram(
    "volcano_plugin_scheduling_latency_microseconds",
    "Plugin scheduling latency", ["plugin", "OnSession"]))
task_scheduling_latency = registry.register(Histogram(
    "volcano_task_scheduling_latency_milliseconds",
    "Task scheduling latency"))
schedule_attempts = registry.register(Counter(
    "volcano_schedule_attempts_total",
    "Number of attempts to schedule pods, by the result", ["result"]))
pod_schedule_errors = registry.register(Counter(
    "volcano_pod_schedule_errors", "Pods that failed to schedule"))
pod_schedule_successes = registry.register(Counter(
    "volcano_pod_schedule_successes", "Pods that scheduled"))
unschedule_task_count = registry.register(Gauge(
    "volcano_unschedule_task_count", "Unschedulable task count", ["job_id"]))
unschedule_job_count = registry.register(Gauge(
    "volcano_unschedule_job_count", "Unschedulable job count"))
preemption_victims = registry.register(Gauge(
    "volcano_preemption_victims", "Number of selected preemption victims"))
preemption_attempts = registry.register(Counter(
    "volcano_total_preemption_attempts",
    "Total preemption attempts in the cluster"))

# -- queue metrics (queue.go) ----------------------------------------------

queue_allocated_milli_cpu = registry.register(Gauge(
    "volcano_queue_allocated_milli_cpu", "Allocated CPU by queue", ["queue_name"]))
queue_allocated_memory_bytes = registry.register(Gauge(
    "volcano_queue_allocated_memory_bytes", "Allocated memory by queue", ["queue_name"]))
queue_request_milli_cpu = registry.register(Gauge(
    "volcano_queue_request_milli_cpu", "Requested CPU by queue", ["queue_name"]))
queue_request_memory_bytes = registry.register(Gauge(
    "volcano_queue_request_memory_bytes", "Requested memory by queue", ["queue_name"]))
queue_deserved_milli_cpu = registry.register(Gauge(
    "volcano_queue_deserved_milli_cpu", "Deserved CPU by queue", ["queue_name"]))
queue_deserved_memory_bytes = registry.register(Gauge(
    "volcano_queue_deserved_memory_bytes", "Deserved memory by queue", ["queue_name"]))
queue_share = registry.register(Gauge(
    "volcano_queue_share", "Share of queue", ["queue_name"]))
queue_weight = registry.register(Gauge(
    "volcano_queue_weight", "Weight of queue", ["queue_name"]))
queue_overused = registry.register(Gauge(
    "volcano_queue_overused", "Whether queue is overused", ["queue_name"]))
queue_pod_group_inqueue_count = registry.register(Gauge(
    "volcano_queue_pod_group_inqueue_count", "Inqueue PodGroup count", ["queue_name"]))
queue_pod_group_pending_count = registry.register(Gauge(
    "volcano_queue_pod_group_pending_count", "Pending PodGroup count", ["queue_name"]))
queue_pod_group_running_count = registry.register(Gauge(
    "volcano_queue_pod_group_running_count", "Running PodGroup count", ["queue_name"]))
queue_pod_group_unknown_count = registry.register(Gauge(
    "volcano_queue_pod_group_unknown_count", "Unknown PodGroup count", ["queue_name"]))

# -- compile pipeline (ops.precompile): kernel builds and cold first solves -

solver_compile_total = registry.register(Counter(
    "volcano_solver_compile_total",
    "Kernel builds and cold first solves at a new (layout, flags) key, "
    "by observing thread class", ["thread"]))
solver_compile_seconds_total = registry.register(Counter(
    "volcano_solver_compile_seconds_total",
    "Seconds spent in kernel builds and cold first solves, by thread "
    "class", ["thread"]))
compile_cache_hits_total = registry.register(Counter(
    "volcano_compile_cache_hits_total",
    "Kernel builds served by a library already in the build directory"))
prewarm_completions_total = registry.register(Counter(
    "volcano_prewarm_completions_total",
    "Background bucket pre-warm completions"))

# -- cycle phase latency (scheduler._export_pipeline_metrics) -------------

session_phase_ms = registry.register(Gauge(
    "volcano_session_phase_milliseconds",
    "Per-phase latency of the last scheduling cycle", ["phase"]))

# -- device-resident arena metrics (ops.device_cache + ops.pipeline) --------

arena_bytes_shipped = registry.register(Gauge(
    "volcano_arena_bytes_shipped",
    "Wire bytes shipped to the device-resident arena by the last "
    "scheduling session (dirty chunks only in steady state), per solver "
    "mode (packed = single-device arena, sharded = node-axis mesh arena)",
    ["mode"]))
arena_bytes_shipped_total = registry.register(Gauge(
    "volcano_arena_bytes_shipped_total",
    "Cumulative wire bytes shipped to the device-resident arena, per "
    "solver mode", ["mode"]))
arena_hit_rate = registry.register(Gauge(
    "volcano_arena_hit_rate",
    "Fraction of sessions served by a delta against the resident arena "
    "(1.0 = no full re-ship since the first session), per solver mode",
    ["mode"]))
arena_sessions_total = registry.register(Gauge(
    "volcano_arena_sessions_total",
    "Arena sessions by outcome (delta = dirty-chunk ship, full = "
    "full padded-buffer upload) and solver mode", ["outcome", "mode"]))
arena_invalidations_total = registry.register(Gauge(
    "volcano_arena_invalidations_total",
    "Soft arena invalidations after collect failures (next session "
    "full-ships and re-validates pinned params), per solver mode",
    ["mode"]))
arena_params_repins_total = registry.register(Gauge(
    "volcano_arena_params_repins_total",
    "Device score-params uploads (content change or failed "
    "re-validation; steady sessions serve the pinned copy), per solver "
    "mode", ["mode"]))
arena_shard_bytes_shipped = registry.register(Gauge(
    "volcano_arena_shard_bytes_shipped",
    "Wire bytes shipped to one mesh shard by the last sharded session "
    "(node-axis dirty chunks owned by the shard + its copy of the "
    "replicated task/job delta)", ["shard"]))

# -- event-sourced flatten metrics (ops.arrays FlattenCache ledger) ---------

flatten_cycles_total = registry.register(Counter(
    "volcano_flatten_cycles_total",
    "Scheduling-cycle flattens by assembly mode: event = ledger-driven "
    "row patch (O(events)), incremental = prefix/suffix re-diff, cold = "
    "full rebuild", ["mode"]))
flatten_events_applied = registry.register(Gauge(
    "volcano_flatten_events_applied",
    "Mirror deltas consumed by the last flatten's event ledger (watch "
    "deliveries + snapshot-seam re-cuts since the previous flatten)"))
flatten_rows_patched = registry.register(Gauge(
    "volcano_flatten_rows_patched",
    "Padded buffer rows (task rows + node rows) patched in place by the "
    "last event-mode flatten; 0 on a quiet cluster"))
flatten_rows_patched_total = registry.register(Counter(
    "volcano_flatten_rows_patched_total",
    "Cumulative rows patched by event-mode flattens"))
flatten_patch_ms = registry.register(Gauge(
    "volcano_flatten_patch_milliseconds",
    "Wall time of the last EVENT-mode flatten (validate epoch, patch "
    "dirty rows, reuse the assembly)"))
flatten_full_ms = registry.register(Gauge(
    "volcano_flatten_full_milliseconds",
    "Wall time of the last full-pass flatten (incremental re-diff or "
    "cold rebuild)"))
flatten_fallbacks_total = registry.register(Counter(
    "volcano_flatten_fallbacks_total",
    "Event-path declines into the full re-diff, by reason (epoch_"
    "mismatch, node_relayout, job_layout, task_count, vocab_growth, "
    "session_mutations, ...)", ["reason"]))

# -- event-sourced ordering metrics (ops.ordering OrderCache) ---------------

order_cycles_total = registry.register(Counter(
    "volcano_order_cycles_total",
    "Scheduling-cycle ordering passes by mode: reuse = quiet-cycle walk "
    "reuse (zero work), event = ledger-driven patch of dirty jobs only, "
    "full = full keyed re-sort, legacy = comparator-only conf (cache "
    "stands down)", ["mode"]))
order_entries_patched = registry.register(Gauge(
    "volcano_order_entries_patched",
    "Jobs re-filtered/re-keyed/re-sorted by the last ordering pass; 0 on "
    "a quiet cluster, the full job count on a fallback cycle"))
order_entries_patched_total = registry.register(Counter(
    "volcano_order_entries_patched_total",
    "Cumulative job entries patched by event-mode ordering passes"))
order_ms = registry.register(Gauge(
    "volcano_order_milliseconds",
    "Wall time of the last EVENT-path ordering pass (reuse or "
    "dirty-entry patch + index walk)"))
order_full_ms = registry.register(Gauge(
    "volcano_order_full_milliseconds",
    "Wall time of the last full-sort ordering pass (fallback or "
    "comparator-only collection)"))
order_fallbacks_total = registry.register(Counter(
    "volcano_order_fallbacks_total",
    "Event-path ordering declines into the full sort, by reason (epoch_"
    "mismatch, conf_reload, key_context, session_mutations, queue_"
    "membership, comparator_only, ...)", ["reason"]))

# -- delta watch metrics (client/codec.py delta dialect, client/remote.py) --

delta_frames_total = registry.register(Counter(
    "volcano_delta_frames_total",
    "Wire frames received on negotiated delta watch streams (patch and "
    "interleaved object frames alike)"))
delta_patches_applied_total = registry.register(Counter(
    "volcano_delta_patches_applied_total",
    "Column-patch events applied straight onto mirrored objects (no "
    "full-object decode)"))
delta_fields_applied_total = registry.register(Counter(
    "volcano_delta_fields_applied_total",
    "Individual field writes applied by column patches"))
delta_stream_bytes_total = registry.register(Counter(
    "volcano_delta_stream_bytes_total",
    "Watch-stream wire bytes by mode: delta = frames on a negotiated "
    "delta stream, object = plain object frames — the like-for-like "
    "bytes comparison between the two paths", ["mode"]))
delta_decode_ms = registry.register(Gauge(
    "volcano_delta_decode_milliseconds",
    "Cumulative wall time resolving patch columns (table lookups + raw-"
    "value decodes) on this client's delta streams"))
delta_apply_ms = registry.register(Gauge(
    "volcano_delta_apply_milliseconds",
    "Cumulative wall time applying resolved patches (field writes + "
    "listener dispatch) on this client's delta streams"))
delta_vocab_size = registry.register(Gauge(
    "volcano_delta_vocab_size",
    "Peak interning-table size across this client's delta streams "
    "(capped at codec.DELTA_VOCAB_MAX; overflow falls back typed)"))
delta_fallbacks_total = registry.register(Counter(
    "volcano_delta_fallbacks_total",
    "Typed delta-stream fallbacks to the object path, by reason (delta_"
    "gap, vocab_overflow, unknown_field, schema_skew)", ["reason"]))

# -- resilience metrics (resilience/, scheduler containment, store client) --

breaker_state = registry.register(Gauge(
    "volcano_breaker_state",
    "Circuit breaker state (0=closed, 1=half_open, 2=open)", ["breaker"]))
breaker_transitions_total = registry.register(Counter(
    "volcano_breaker_transitions_total",
    "Circuit breaker state transitions", ["breaker", "to"]))
breaker_fallback_cycles_total = registry.register(Counter(
    "volcano_breaker_fallback_cycles_total",
    "Scheduling cycles served by the host oracle while the device "
    "breaker was not closed", ["breaker"]))
conf_load_errors = registry.register(Counter(
    "volcano_conf_load_errors",
    "Scheduler conf hot-reload failures (last good conf retained)"))
action_failures_total = registry.register(Counter(
    "volcano_action_failures_total",
    "Scheduling actions contained after raising", ["action"]))
action_timeouts_total = registry.register(Counter(
    "volcano_action_timeouts_total",
    "Scheduling actions contained after a deadline breach", ["action"]))
faults_injected_total = registry.register(Counter(
    "volcano_faults_injected_total",
    "Faults fired by the injection harness", ["point"]))
fenced_writes_total = registry.register(Counter(
    "volcano_fenced_writes_total",
    "Mutating store writes rejected by lease fencing (split-brain "
    "attempts made visible)", ["holder"]))
bind_intents_total = registry.register(Counter(
    "volcano_bind_intents_total",
    "Bind-intent journal activity (recorded / confirmed)", ["event"]))
recovery_intents_total = registry.register(Counter(
    "volcano_recovery_intents_total",
    "Bind-intent bindings reconciled at leadership takeover, by outcome "
    "(adopted / redriven / conflict / lost)", ["outcome"]))
job_retry_total = registry.register(Counter(
    "volcano_job_retry_total",
    "Job controller re-enqueues after a failed sync (capped exponential "
    "backoff per job key)", ["job_id"]))
watch_reconnects_total = registry.register(Counter(
    "volcano_watch_reconnects_total",
    "Watch streams resumed in place after a break", ["kind"]))
store_request_retries_total = registry.register(Counter(
    "volcano_store_request_retries_total",
    "Store client requests retried after a connection failure"))

# -- store admission metrics (resilience/overload.py AdmissionGate) ---------
# the StoreServer exports these through its process's registry; the
# retry-budget pair is CLIENT-side (RemoteClusterStore's token bucket)

store_admission_inflight = registry.register(Gauge(
    "volcano_store_admission_inflight",
    "Requests (and held streams) currently dispatched per admission "
    "lane; system is unbounded, the bounded lanes queue then shed",
    ["lane"]))
store_admission_queued = registry.register(Gauge(
    "volcano_store_admission_queued",
    "Requests waiting in one admission lane's bounded FIFO (granted "
    "round-robin across client flows; shed typed when the queue fills "
    "or the queue-wait deadline passes)", ["lane"]))
store_admission_sheds_total = registry.register(Counter(
    "volcano_store_admission_sheds_total",
    "Requests shed at the admission gate, by lane and reason "
    "(queue_full, queue_wait, deadline, streams, fault). Every shed is "
    "a typed OverloadedError with a retry-after hint — never a hang, "
    "never a silent drop", ["lane", "reason"]))
store_admission_deadline_expired_total = registry.register(Counter(
    "volcano_store_admission_deadline_expired_total",
    "Requests rejected because their wire deadline (deadline_ms "
    "header) had already expired on arrival or lapsed while queued — "
    "work nobody is waiting for anymore, not worth a thread", ["lane"]))
store_admission_retry_budget = registry.register(Gauge(
    "volcano_store_admission_retry_budget",
    "Client-side retry-budget token balance (refilled at ~10% of "
    "recent request volume; each Overloaded retry spends one)"))
store_admission_retry_budget_exhausted_total = registry.register(Counter(
    "volcano_store_admission_retry_budget_exhausted_total",
    "Overloaded retries refused client-side because the retry budget "
    "was dry (typed RetryBudgetExhausted to the caller; system-lane "
    "ops bypass the budget)"))

# -- durable store metrics (client/durable.py + client/server.py) -----------

store_watch_dropped_total = registry.register(Counter(
    "volcano_store_watch_dropped_total",
    "Slow watchers dropped by the store server (event queue overflow or "
    "send stall past the timeout); the client resumes via its rv "
    "high-water mark"))
store_wal_appends_total = registry.register(Counter(
    "volcano_store_wal_appends_total",
    "Mutation records appended to the store write-ahead log"))
store_wal_append_seconds = registry.register(Histogram(
    "volcano_store_wal_append_seconds",
    "Latency of one WAL append (encode + write + policy fsync)"))
store_wal_fsyncs_total = registry.register(Counter(
    "volcano_store_wal_fsyncs_total",
    "WAL fsyncs (every commit under fsync=every, one per bulk_apply "
    "batch, at most one per interval under fsync=interval)"))
store_wal_size_bytes = registry.register(Gauge(
    "volcano_store_wal_size_bytes",
    "Bytes in the active WAL segment (resets at every snapshot "
    "rotation)"))
store_wal_snapshots_total = registry.register(Counter(
    "volcano_store_wal_snapshots_total",
    "Store snapshots written (WAL compactions)"))
store_wal_snapshot_bytes = registry.register(Gauge(
    "volcano_store_wal_snapshot_bytes",
    "Size of the newest store snapshot"))
store_wal_snapshot_timestamp = registry.register(Gauge(
    "volcano_store_wal_snapshot_timestamp_seconds",
    "Unix time the newest store snapshot was written (snapshot age = "
    "now - this)"))
store_wal_recovery_ms = registry.register(Gauge(
    "volcano_store_wal_recovery_milliseconds",
    "Wall time of the last store recovery (snapshot load + WAL tail "
    "replay)"))
store_wal_recovery_records = registry.register(Gauge(
    "volcano_store_wal_recovery_records",
    "WAL records replayed on top of the snapshot by the last recovery"))

# -- sharded store metrics (client/sharded.py) ------------------------------
# the volcano_store_wal_* family above additionally carries a
# shard=<idx> label when the WAL belongs to a sharded member store

store_shard_events_total = registry.register(Counter(
    "volcano_store_shard_events_total",
    "Events committed per store shard (rate = per-shard events/sec)",
    ["shard"]))
store_shard_journal_window = registry.register(Gauge(
    "volcano_store_shard_journal_window",
    "Events currently replayable from one shard's watch-resume journal "
    "(the span of its since: window, sampled every 64 commits)",
    ["shard"]))
store_shard_watch_queue_depth = registry.register(Gauge(
    "volcano_store_shard_watch_queue_depth",
    "Events from one shard sitting in router watch queues, not yet on "
    "the wire (sustained growth = a slow watcher about to be dropped)",
    ["shard"]))
store_shard_dropped_total = registry.register(Counter(
    "volcano_store_shard_dropped_events_total",
    "Events discarded per shard when a condemned (overflowed/stalled) "
    "watch stream was dropped", ["shard"]))

# -- multi-process shard workers (client/shardproc.py) ----------------------
# set by the ShardProcSupervisor in the router process

store_shard_worker_up = registry.register(Gauge(
    "volcano_store_shard_worker_up",
    "1 when the shard's worker process is alive and serving, 0 while "
    "it is down/restarting (its ops contained with "
    "ShardUnavailableError)", ["shard"]))
store_shard_worker_pid = registry.register(Gauge(
    "volcano_store_shard_worker_pid",
    "OS pid of the shard's worker process", ["shard"]))
store_shard_worker_restarts_total = registry.register(Counter(
    "volcano_store_shard_worker_restarts_total",
    "Times the supervisor restarted this shard's worker process "
    "(capped-exponential-backoff respawn on the same port + data dir)",
    ["shard"]))
store_shard_worker_uptime_seconds = registry.register(Gauge(
    "volcano_store_shard_worker_uptime_seconds",
    "Seconds since the shard's worker process last came READY "
    "(0 while down)", ["shard"]))
store_shard_ingest_events_per_sec = registry.register(Gauge(
    "volcano_store_shard_ingest_events_per_sec",
    "Committed mutations per second on this shard's worker, sampled "
    "from its rv progression by the supervisor's liveness polls",
    ["shard"]))

# -- read replica metrics (client/replica.py) -------------------------------

replica_applied_rv = registry.register(Gauge(
    "volcano_replica_applied_rv",
    "Primary resource_version this replica's mirror reflects, per "
    "shipped WAL lineage (shard '0' for an unsharded primary)",
    ["shard"]))
replica_lag_records = registry.register(Gauge(
    "volcano_replica_lag_records",
    "WAL records the primary has committed that this replica has not "
    "yet applied (primary rv seen on the ship stream - applied rv)",
    ["shard"]))
replica_lag_seconds = registry.register(Gauge(
    "volcano_replica_lag_seconds",
    "Age of the replica's applied state while it lags (now - the WAL "
    "commit stamp of the last applied record; 0 when caught up)",
    ["shard"]))
replica_bootstraps_total = registry.register(Counter(
    "volcano_replica_bootstraps_total",
    "Replica snapshot bootstraps by reason: initial (startup), "
    "out_of_window (fell past the primary's retained-segment window), "
    "apply_gap (rv discontinuity detected — a lost or duplicated "
    "shipped record). Every hole ends here, never in a silent skip",
    ["reason"]))
replica_ship_bytes_total = registry.register(Counter(
    "volcano_replica_ship_bytes_total",
    "Wire bytes received on the WAL ship stream(s)", ["shard"]))
replica_watchers = registry.register(Gauge(
    "volcano_replica_watchers",
    "Watch/bulk_watch streams currently served by this replica"))
replica_upstream_depth = registry.register(Gauge(
    "volcano_replica_upstream_depth",
    "This replica's depth in the fan-out tree: 1 tails the primary "
    "directly, N tails a depth-(N-1) replica"))
replica_upstream_rv = registry.register(Gauge(
    "volcano_replica_upstream_rv",
    "Newest upstream resource_version seen on this replica's ship "
    "stream(s), per lineage — the rv its lag is measured against",
    ["shard"]))
replica_ship_served_streams = registry.register(Gauge(
    "volcano_replica_ship_served_streams",
    "Downstream ship streams this replica is currently re-serving "
    "(its children in the fan-out tree)"))
replica_ship_served_records_total = registry.register(Counter(
    "volcano_replica_ship_served_records_total",
    "WAL records this replica relayed to downstream replicas — "
    "traffic the primary never saw"))
replica_ship_served_bootstraps_total = registry.register(Counter(
    "volcano_replica_ship_served_bootstraps_total",
    "Bootstrap requests this replica answered from its own mirror "
    "state (mid-tree re-bootstraps that never touched the primary)"))

# -- global rescheduler metrics (reschedule/) -------------------------------

reschedule_plans_total = registry.register(Counter(
    "volcano_reschedule_plans_total",
    "Defragmentation plans by outcome: executed, pre-solve skips "
    "(empty / fits / no_hole / skipped_breaker / solve_failed) and "
    "post-solve plan rejections (rejected_no_gain / rejected_no_hole / "
    "rejected_fits / rejected_empty / rejected_budget)", ["outcome"]))
reschedule_moves_total = registry.register(Counter(
    "volcano_reschedule_moves_total",
    "Migration moves by stage (proposed = raw solved-vs-incumbent diff, "
    "selected = survived budget/caps/feasibility, executed = evictions "
    "dispatched, capped = cut by bounding)", ["stage"]))
reschedule_fragmentation = registry.register(Gauge(
    "volcano_reschedule_fragmentation",
    "Stranded-free-capacity fraction at the last plan (pre = measured, "
    "post = projected over the selected moves)", ["phase"]))
reschedule_plan_solve_ms = registry.register(Gauge(
    "volcano_reschedule_plan_solve_milliseconds",
    "Wall time of the last defrag solve (snapshot + flatten + device "
    "solve + readback)"))
reschedule_intents_total = registry.register(Counter(
    "volcano_reschedule_intents_total",
    "Migration-intent journal activity (recorded / confirmed / settled "
    "/ abandoned)", ["event"]))

# -- cluster simulator metrics (sim/) ---------------------------------------

sim_cycles_total = registry.register(Counter(
    "volcano_sim_cycles_total",
    "Virtual scheduling cycles executed by the cluster simulator"))
sim_decisions_total = registry.register(Counter(
    "volcano_sim_decisions_total",
    "Decisions captured by the sim decision recorder", ["kind"]))
sim_replay_divergences_total = registry.register(Counter(
    "volcano_sim_replay_divergences_total",
    "Golden-trace verifications that found a divergence"))

# -- job / namespace metrics -----------------------------------------------

job_share = registry.register(Gauge(
    "volcano_job_share", "Share of job", ["job_ns", "job_id"]))
job_retry_counts = registry.register(Counter(
    "volcano_job_retry_counts", "Job retry counts", ["job_id"]))
namespace_share = registry.register(Gauge(
    "volcano_namespace_share", "Share of namespace", ["namespace_name"]))
namespace_weight = registry.register(Gauge(
    "volcano_namespace_weight", "Weight of namespace", ["namespace_name"]))


def update_queue_metrics(queue_name: str, allocated, request, deserved=None,
                         share: Optional[float] = None):
    queue_allocated_milli_cpu.set(allocated.milli_cpu, {"queue_name": queue_name})
    queue_allocated_memory_bytes.set(allocated.memory, {"queue_name": queue_name})
    queue_request_milli_cpu.set(request.milli_cpu, {"queue_name": queue_name})
    queue_request_memory_bytes.set(request.memory, {"queue_name": queue_name})
    if deserved is not None:
        queue_deserved_milli_cpu.set(deserved.milli_cpu, {"queue_name": queue_name})
        queue_deserved_memory_bytes.set(deserved.memory, {"queue_name": queue_name})
    if share is not None:
        queue_share.set(share, {"queue_name": queue_name})

