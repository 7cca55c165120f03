"""Action and Plugin interfaces (reference framework/interface.go:20-41)."""

from __future__ import annotations

from typing import Optional


class Action:
    def name(self) -> str:
        raise NotImplementedError

    def initialize(self) -> None:
        pass

    def execute(self, ssn) -> None:
        raise NotImplementedError

    def un_initialize(self) -> None:
        pass

    def resolve_mode(self, ssn, default: str = "solver") -> str:
        """Execution mode for this action: per-action YAML configuration
        ('mode' argument), overridden to 'host' when a plugin demands
        host-only state tracking (GPU sharing card assignment). A mode this
        package does not have yet raises NotImplementedError here, before
        any dispatch, so it never degrades into the host fallback."""
        from .arguments import Arguments

        mode = default
        for conf in ssn.configurations:
            if conf.name == self.name():
                mode = Arguments(conf.arguments).get("mode", default)
        check_mode_ported(mode)
        if getattr(ssn, "solver_mode", None) not in (None, "packed"):
            raise NotImplementedError(
                f"solver mode {ssn.solver_mode!r} needs the sharded solver, "
                "which is not ported yet (ROADMAP A7)")
        if ssn.solver_options.get("force_host_allocate"):
            mode = "host"
        return mode


#: action modes of the JAX package this package does not run yet, with the
#: ROADMAP item that ports each
UNPORTED_MODES = {"sharded": "A7"}


def check_mode_ported(mode: str) -> None:
    item = UNPORTED_MODES.get(mode)
    if item is not None:
        raise NotImplementedError(
            f"action mode {mode!r} is not ported yet (ROADMAP {item})")


class Plugin:
    def name(self) -> str:
        raise NotImplementedError

    def on_session_open(self, ssn) -> None:
        raise NotImplementedError

    def on_session_close(self, ssn) -> None:
        raise NotImplementedError


class ValidateResult:
    """Result of a JobValid fn (api/types.go ValidateResult)."""

    __slots__ = ("passed", "reason", "message")

    def __init__(self, passed: bool, reason: str = "", message: str = ""):
        self.passed = passed
        self.reason = reason
        self.message = message
