"""Kubelet stand-in: completes graceful pod termination.

The evictor only *requests* deletion (sets deletion_timestamp and leaves the
pod bound, cache.go:139-169 semantics); in a real cluster the kubelet runs
the grace period and then removes the pod. This framework's ClusterStore IS
the cluster, so the controller-manager runs this stand-in — without it an
evicted pod would stay Releasing forever and the preemptor/reclaimer would
never bind (the freed space stays FutureIdle, never Idle).

No reference counterpart file: the kubelet lives outside volcano's tree.
"""

from __future__ import annotations

import time

from .framework import Controller, ControllerOption


class KubeletStandin(Controller):
    """grace_seconds defaults to the kubelet's 30s termination grace. The
    gap between it and the 1s schedule period matters: evictions must
    outpace the job controller's replacement pods (which re-enter the
    pending pool as soon as the victim is finalized), or a reclaim/preempt
    stand-off between a saturated queue and its claimant never converges —
    the same attrition dynamic a real cluster gets from kubelet timing."""

    def __init__(self, grace_seconds: float = 30.0, clock=time.time):
        # clock is the kubelet's time source: wall clock in a live control
        # plane, the virtual clock in the trace-driven simulator
        # (the virtual cluster of sim/) so termination grace elapses in
        # virtual seconds and runs stay reproducible
        self.grace_seconds = grace_seconds
        self.clock = clock
        self.cluster = None

    def name(self) -> str:
        return "kubelet-standin"

    def initialize(self, opt: ControllerOption) -> None:
        self.cluster = opt.cluster

    def run(self) -> None:
        pass  # no watches: termination is scanned, like kubelet sync loops

    def process_all(self) -> None:
        now = self.clock()
        for pod in list(self.cluster.list("pods")):
            ts = pod.deletion_timestamp
            if ts is None or now < ts + self.grace_seconds:
                continue
            try:
                self.cluster.delete("pods", pod.name, pod.namespace)
            except KeyError:
                pass  # already removed
