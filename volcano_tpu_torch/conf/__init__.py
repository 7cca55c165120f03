"""Scheduler configuration types + YAML parsing (reference pkg/scheduler/conf
+ pkg/scheduler/util.go:31-95)."""

from .scheduler_conf import (  # noqa: F401
    Configuration, PluginOption, SchedulerConfiguration, Tier,
    DEFAULT_SCHEDULER_CONF, load_scheduler_conf,
)
