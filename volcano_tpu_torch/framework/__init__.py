"""Scheduler framework (reference pkg/scheduler/framework)."""

from .arguments import Arguments  # noqa: F401
from .event import Event, EventHandler  # noqa: F401
from .framework import close_session, open_session  # noqa: F401
from .interface import Action, Plugin, ValidateResult  # noqa: F401
from .job_updater import JobUpdater  # noqa: F401
from .registry import (  # noqa: F401
    get_action, get_plugin_builder, list_actions, list_plugins,
    register_action, register_plugin_builder,
)
from .session import Session, job_status  # noqa: F401
from .statement import Statement  # noqa: F401
