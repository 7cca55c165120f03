"""Typed plugin-argument extraction (reference framework/arguments.go)."""

from __future__ import annotations

from typing import Any, Dict


class Arguments(dict):
    """Plugin arguments map with typed getters. Getters keep the caller's
    default when the key is missing or unparsable, like the reference."""

    def get_int(self, key: str, default: int) -> int:
        if key not in self:
            return default
        try:
            return int(self[key])
        except (TypeError, ValueError):
            return default

    def get_float(self, key: str, default: float) -> float:
        if key not in self:
            return default
        try:
            return float(self[key])
        except (TypeError, ValueError):
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        if key not in self:
            return default
        v = self[key]
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            return v.strip().lower() in ("1", "t", "true", "yes", "y")
        return bool(v)
