"""Plugin and action registries (reference framework/plugins.go:21-72)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

_plugin_builders: Dict[str, Callable] = {}
_actions: Dict[str, object] = {}


def register_plugin_builder(name: str, builder: Callable) -> None:
    _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[Callable]:
    return _plugin_builders.get(name)


def register_action(action) -> None:
    _actions[action.name()] = action


def get_action(name: str):
    if name not in _actions:
        from .. import actions  # noqa: F401  (registers builtin actions)
    return _actions.get(name)


def list_plugins():
    return sorted(_plugin_builders)


def list_actions():
    return sorted(_actions)
