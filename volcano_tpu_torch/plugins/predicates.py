"""Predicates plugin (reference plugins/predicates/predicates.go:100-255).

Wraps the k8s filter set the reference uses: NodeUnschedulable, NodeAffinity
(+ nodeSelector), TaintToleration, NodePorts, pod-count, and (optionally)
InterPodAffinity. Two forms:

- host predicate fn registered on the session (exact per-pair semantics for
  backfill/preempt/reclaim paths and tests);
- for the allocate solver, the same constraints are flattened into
  sig_masks by ops.flatten_snapshot (signature gather), so the plugin's job
  there is only to declare that the mask set is active.
"""

from __future__ import annotations

import logging

from ..api import FitError, TaskStatus
from ..api.device_info import (
    add_gpu_index, get_gpu_index, gpu_resource_of_pod, predicate_gpu,
    remove_gpu_index,
)
from ..api.unschedule_info import (
    GPU_SHARING_FAILED, NODE_AFFINITY_FAILED, NODE_PORTS_FAILED,
    NODE_UNSCHEDULABLE, POD_AFFINITY_FAILED, POD_COUNT_FAILED,
    PVC_NOT_FOUND, TAINT_FAILED, VOLUME_BINDING_FAILED,
)
from ..framework import Plugin
from ..framework.event import EventHandler
from ..ops.arrays import (
    _match_node_selector, _node_affinity_match, _tolerates,
)

logger = logging.getLogger(__name__)


class PredicateError(Exception):
    def __init__(self, fit_error: FitError):
        super().__init__(fit_error.error())
        self.fit_error = fit_error


def _has_required_pod_affinity(pod) -> bool:
    """True when the pod carries requiredDuringScheduling inter-pod
    (anti-)affinity terms — feasibility then depends on in-flight placements,
    which only the sequential host loop tracks."""
    aff = pod.affinity or {}
    for kind in ("podAffinity", "podAntiAffinity"):
        if (aff.get(kind) or {}).get(
                "requiredDuringSchedulingIgnoredDuringExecution"):
            return True
    return False


def _pod_affinity_ok(pod, node, tasks_on_node) -> bool:
    """Minimal inter-pod affinity/anti-affinity: requiredDuringScheduling
    terms with matchLabels over topologyKey kubernetes.io/hostname."""
    aff = pod.affinity or {}
    for kind, want in (("podAffinity", True), ("podAntiAffinity", False)):
        spec = aff.get(kind) or {}
        for term in spec.get("requiredDuringSchedulingIgnoredDuringExecution", []):
            sel = (term.get("labelSelector") or {}).get("matchLabels", {})
            matched = any(
                all((t.pod.labels or {}).get(k) == v for k, v in sel.items())
                for t in tasks_on_node)
            if want and not matched:
                return False
            if not want and matched:
                return False
    return True


class PredicatesPlugin(Plugin):
    def __init__(self, arguments=None):
        from ..framework import Arguments

        self.arguments = arguments or {}
        # predicate.GPUSharingEnable (predicates.go:100-133)
        args = (self.arguments if isinstance(self.arguments, Arguments)
                else Arguments(self.arguments))
        self.gpu_sharing = args.get_bool("predicate.GPUSharingEnable", False)

    def name(self) -> str:
        return "predicates"

    def on_session_open(self, ssn) -> None:
        ssn.solver_options["predicates"] = True
        # The batched kernel's feasibility masks are precomputed per node and
        # cannot see in-flight same-session placements, so required inter-pod
        # (anti-)affinity must run the sequential host loop. Scoped per job
        # (one affine pod must not downgrade the whole cluster's cycle):
        # allocate solves the other jobs on device and routes only these
        # through the host loop. Mirrors predicates.go:171-237
        # InterPodAffinity being a full k8s filter in the reference.
        # Only pending tasks matter: _pod_affinity_ok evaluates the incoming
        # pod's terms, never existing pods' (no anti-affinity symmetry), so a
        # long-Running affine pod must not downgrade any cycle to host mode.
        # PVC-carrying jobs join the same host routing: the kernel's sig
        # masks don't know claim node pins, and a wrong-node replay would
        # silently discard the gang every cycle (claim pins also depend on
        # in-flight same-session assumptions, which only the host loop's
        # volume-binding predicate tracks).
        def _has_claim(pod):
            return any((v.get("persistentVolumeClaim") or {}).get(
                "claimName") for v in getattr(pod, "volumes", None) or [])

        host_only = {
            job.uid for job in ssn.jobs.values()
            if any(_has_required_pod_affinity(t.pod) or _has_claim(t.pod)
                   for t in job.task_status_index.get(
                       TaskStatus.PENDING, {}).values())}
        if host_only:
            ssn.solver_options["host_only_jobs"] = host_only
        if self.gpu_sharing:
            # per-card feasibility depends on in-flight card assignments,
            # which only the host loop tracks — but that's a property of
            # GPU-REQUESTING jobs, not the cycle: route exactly those jobs
            # through the host loop (the same per-job mechanism as
            # affinity/PVC above) and keep everything else on the device
            # path. One GPU job must not downgrade a 10k-pod cycle.
            gpu_jobs = {
                job.uid for job in ssn.jobs.values()
                if any(gpu_resource_of_pod(t.pod) > 0
                       for t in job.task_status_index.get(
                           TaskStatus.PENDING, {}).values())}
            if gpu_jobs:
                host_only = set(ssn.solver_options.get("host_only_jobs")
                                or ()) | gpu_jobs
                ssn.solver_options["host_only_jobs"] = host_only
            # evict-then-discard undo must restore the card the pod actually
            # occupies, not re-run first-fit: uid -> (node_name, card id)
            released_cards = {}

            def on_allocate(event):
                """Pick a card, annotate the pod, join its pod_map
                (predicates.go:117-133 AllocateFunc)."""
                task = event.task
                pod = task.pod
                if gpu_resource_of_pod(pod) <= 0:
                    return
                node_info = ssn.nodes.get(task.node_name)
                if node_info is None:
                    return
                restored = released_cards.pop(pod.uid, None)
                if restored is not None and restored[0] == task.node_name:
                    dev_id = restored[1]
                else:
                    dev_id = predicate_gpu(pod, node_info)
                if dev_id < 0:
                    # node-level gpu memory was just accounted for this task
                    # but no card fits: surface the inconsistency instead of
                    # silently leaving the pod without a card assignment
                    # (predicates.go:117-133 logs the allocate error)
                    logger.error(
                        "gpu allocate: no card on node <%s> fits pod <%s/%s> "
                        "(node accounting and card assignment now disagree)",
                        task.node_name, pod.namespace, pod.name)
                    return
                add_gpu_index(pod, dev_id)
                dev = node_info.gpu_devices.get(dev_id)
                if dev is not None:
                    dev.pod_map[pod.uid] = pod

            def on_deallocate(event):
                """Free the card on statement undo / eviction
                (predicates.go:145-160 DeallocateFunc)."""
                task = event.task
                pod = task.pod
                if gpu_resource_of_pod(pod) <= 0:
                    return
                node_info = ssn.nodes.get(task.node_name)
                dev_id = get_gpu_index(pod)
                if node_info is not None:
                    if dev_id >= 0:
                        released_cards[pod.uid] = (task.node_name, dev_id)
                    dev = node_info.gpu_devices.get(dev_id)
                    if dev is not None:
                        dev.pod_map.pop(pod.uid, None)
                remove_gpu_index(pod)

            ssn.add_event_handler(EventHandler(
                allocate_func=on_allocate, deallocate_func=on_deallocate))

        def predicate_fn(task, node_info):
            node = node_info.node
            pod = task.pod
            reasons = []
            if node is None or not node_info.ready:
                reasons.append(NODE_UNSCHEDULABLE)
            else:
                max_tasks = node_info.allocatable.max_task_num
                if max_tasks and len(node_info.tasks) >= max_tasks:
                    reasons.append(POD_COUNT_FAILED)
                if not _match_node_selector(pod.node_selector or {}, node) \
                        or not _node_affinity_match(pod.affinity, node):
                    reasons.append(NODE_AFFINITY_FAILED)
                if not _tolerates(pod.tolerations, node):
                    reasons.append(TAINT_FAILED)
                if pod.ports():
                    taken = set()
                    for other in node_info.tasks.values():
                        taken.update(other.pod.ports())
                    if set(pod.ports()) & taken:
                        reasons.append(NODE_PORTS_FAILED)
                if pod.affinity and not _pod_affinity_ok(
                        pod, node, list(node_info.tasks.values())):
                    reasons.append(POD_AFFINITY_FAILED)
                if self.gpu_sharing and gpu_resource_of_pod(pod) > 0 \
                        and predicate_gpu(pod, node_info) < 0:
                    # no single card has enough idle memory (gpu.go:27-55)
                    reasons.append(GPU_SHARING_FAILED)
                if getattr(pod, "volumes", None):
                    # volume-binding filter: a claim pinned to another node
                    # excludes this one (the k8s CheckVolumeBinding
                    # predicate the reference wires in)
                    vb = getattr(getattr(ssn, "cache", None),
                                 "volume_binder", None)
                    if getattr(vb, "missing_claims", lambda p: ())(pod):
                        reasons.append(PVC_NOT_FOUND)
                    elif getattr(vb, "node_ok", None) is not None \
                            and not vb.node_ok(pod, node.name):
                        reasons.append(VOLUME_BINDING_FAILED)
            if reasons:
                raise PredicateError(FitError(task, node_info.name, reasons))

        ssn.add_predicate_fn(self.name(), predicate_fn)

    def on_session_close(self, ssn) -> None:
        pass
