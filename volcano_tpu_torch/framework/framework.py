"""open_session / close_session (reference framework/framework.go:30-64)."""

from __future__ import annotations

import logging
import time
from typing import List

from ..conf import Tier
from ..metrics import tracing
from .arguments import Arguments
from .job_updater import JobUpdater
from .registry import get_plugin_builder
from .session import Session, job_status

log = logging.getLogger(__name__)


def open_session(cache, tiers: List[Tier], configurations=None) -> Session:
    from .. import plugins  # noqa: F401  (registers builtin plugins)
    ssn = Session(cache, cache.snapshot())
    ssn.tiers = tiers
    ssn.configurations = configurations or []

    for tier in tiers:
        for opt in tier.plugins:
            builder = get_plugin_builder(opt.name)
            if builder is None:
                log.warning("failed to get plugin %s", opt.name)
                continue
            plugin = builder(Arguments(opt.arguments))
            ssn.plugins[plugin.name()] = plugin
            with tracing.span("vc.open.plugin",
                              plugin=plugin.name()) as opened:
                plugin.on_session_open(ssn)
            _metrics_plugin(plugin.name(), "OnSessionOpen", opened.ms)

    # NOTE: the reference's openSession contains a JobValid filter
    # (session.go:121-138), but it runs BEFORE plugins register their
    # jobValidFns, so it never fires; the real filtering happens inside each
    # action (allocate/backfill check ssn.JobValid). We mirror that: no
    # filtering here — enqueue must still see pod-less Pending podgroups.
    return ssn


def close_session(ssn: Session) -> None:
    for name, plugin in ssn.plugins.items():
        t0 = time.perf_counter()
        plugin.on_session_close(ssn)
        _metrics_plugin(name, "OnSessionClose",
                        (time.perf_counter() - t0) * 1e3)

    # decision-trace hook: the recorder reads the session AFTER plugins
    # closed (conditions/fit errors final) and BEFORE teardown — this is
    # where pipeline statements and per-job unschedulability summaries
    # enter the sim's golden trace (sim/recorder.py)
    rec = getattr(ssn, "decision_recorder", None)
    if rec is not None:
        try:
            rec.observe_session(ssn)
        except Exception:
            log.exception("decision recorder observe_session failed")

    ju = JobUpdater(ssn)
    ju.update_all()

    ssn.jobs = {}
    ssn.nodes = {}
    ssn.plugins = {}
    ssn.event_handlers = []
    ssn._tier_cache = {}
    for reg in list(ssn.__dict__):
        if reg.endswith("_fns"):
            setattr(ssn, reg, {})


def _metrics_plugin(plugin: str, phase: str, ms: float) -> None:
    from ..metrics import metrics
    metrics.plugin_scheduling_latency.observe(
        ms / 1e3, labels={"plugin": plugin, "OnSession": phase})
