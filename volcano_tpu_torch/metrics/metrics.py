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

# -- resilience metrics (resilience/, scheduler containment, store fencing) -

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
