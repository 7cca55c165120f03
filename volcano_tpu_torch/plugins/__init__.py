"""Scheduling plugins + factory (reference pkg/scheduler/plugins)."""

from ..framework import register_plugin_builder
from .binpack import BinpackPlugin  # noqa: F401
from .conformance import ConformancePlugin  # noqa: F401
from .gang import GangPlugin  # noqa: F401
from .nodeorder import NodeOrderPlugin  # noqa: F401
from .predicates import PredicateError, PredicatesPlugin  # noqa: F401
from .priority import PriorityPlugin  # noqa: F401


def register_all() -> None:
    """plugins/factory.go:32-46."""
    register_plugin_builder("gang", GangPlugin)
    register_plugin_builder("priority", PriorityPlugin)
    register_plugin_builder("predicates", PredicatesPlugin)
    register_plugin_builder("nodeorder", NodeOrderPlugin)
    register_plugin_builder("binpack", BinpackPlugin)
    register_plugin_builder("conformance", ConformancePlugin)
    try:
        from .drf import DRFPlugin
        register_plugin_builder("drf", DRFPlugin)
    except ImportError:
        pass
    try:
        from .proportion import ProportionPlugin
        register_plugin_builder("proportion", ProportionPlugin)
    except ImportError:
        pass
    try:
        from .reservation import ReservationPlugin
        register_plugin_builder("reservation", ReservationPlugin)
    except ImportError:
        pass


register_all()
