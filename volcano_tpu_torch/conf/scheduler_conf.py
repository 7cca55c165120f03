"""Scheduler configuration: actions string + plugin tiers + per-action args.

Mirrors reference pkg/scheduler/conf/scheduler_conf.go:20-76 and the YAML
unmarshalling in pkg/scheduler/util.go:31-95, including the rejection of
hierarchical DRF combined with the proportion plugin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml


@dataclass
class PluginOption:
    name: str
    # tri-state enables: None means default-on (defaults.go:22-76)
    enabled_job_order: Optional[bool] = None
    enabled_namespace_order: Optional[bool] = None
    enabled_job_ready: Optional[bool] = None
    enabled_job_pipelined: Optional[bool] = None
    enabled_task_order: Optional[bool] = None
    enabled_preemptable: Optional[bool] = None
    enabled_reclaimable: Optional[bool] = None
    enabled_queue_order: Optional[bool] = None
    enabled_predicate: Optional[bool] = None
    enabled_best_node: Optional[bool] = None
    enabled_node_order: Optional[bool] = None
    enabled_target_job: Optional[bool] = None
    enabled_reserved_nodes: Optional[bool] = None
    enabled_job_enqueued: Optional[bool] = None
    arguments: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class Configuration:
    """Per-action arguments block (conf/scheduler_conf.go:66-76)."""
    name: str
    arguments: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfiguration:
    actions: List[str] = field(default_factory=list)
    tiers: List[Tier] = field(default_factory=list)
    configurations: List[Configuration] = field(default_factory=list)

    def arg_of_action(self, name: str) -> Optional[Configuration]:
        for c in self.configurations:
            if c.name == name:
                return c
        return None


# Default configuration (util.go defaultSchedulerConf)
DEFAULT_SCHEDULER_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""

_CAMEL = {
    "enabledJobOrder": "enabled_job_order",
    "enabledNamespaceOrder": "enabled_namespace_order",
    "enabledJobReady": "enabled_job_ready",
    "enabledJobPipelined": "enabled_job_pipelined",
    "enabledTaskOrder": "enabled_task_order",
    "enabledPreemptable": "enabled_preemptable",
    "enabledReclaimable": "enabled_reclaimable",
    "enabledQueueOrder": "enabled_queue_order",
    "enabledPredicate": "enabled_predicate",
    "enabledBestNode": "enabled_best_node",
    "enabledNodeOrder": "enabled_node_order",
    "enabledTargetJob": "enabled_target_job",
    "enabledReservedNodes": "enabled_reserved_nodes",
    "enabledJobEnqueued": "enabled_job_enqueued",
}


def load_scheduler_conf(text: str) -> SchedulerConfiguration:
    """Parse the scheduler YAML. Raises ValueError on the hdrf+proportion
    conflict like the reference (util.go:73-85)."""
    raw = yaml.safe_load(text) or {}
    conf = SchedulerConfiguration()
    actions = raw.get("actions", "")
    conf.actions = [a.strip() for a in actions.split(",") if a.strip()]

    has_hdrf, has_proportion = False, False
    for tier_raw in raw.get("tiers", []) or []:
        tier = Tier()
        for p in tier_raw.get("plugins", []) or []:
            opt = PluginOption(name=p["name"], arguments=dict(p.get("arguments") or {}))
            for yaml_key, attr in _CAMEL.items():
                if yaml_key in p:
                    setattr(opt, attr, bool(p[yaml_key]))
            if opt.name == "drf" and opt.arguments.get("drf.enableHierarchy"):
                has_hdrf = True
            if opt.name == "proportion":
                has_proportion = True
            tier.plugins.append(opt)
        conf.tiers.append(tier)

    if has_hdrf and has_proportion:
        raise ValueError(
            "proportion and drf with hierarchy are incompatible")

    for c in raw.get("configurations", []) or []:
        conf.configurations.append(
            Configuration(name=c["name"], arguments=dict(c.get("arguments") or {})))
    return conf
