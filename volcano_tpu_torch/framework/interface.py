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
        ('mode' argument), then the deployment-level solver-mode
        preference when the conf left the mode implicit, overridden to
        'host' when a plugin demands host-only state tracking (GPU sharing
        card assignment). A mode this package does not have raises
        NotImplementedError here, before any dispatch, so it never
        degrades into the host fallback."""
        from .arguments import Arguments

        mode = default
        configured = False
        for conf in ssn.configurations:
            if conf.name == self.name():
                m = Arguments(conf.arguments).get("mode", None)
                if m is not None:
                    mode, configured = m, True
                else:
                    mode = default
        check_mode_ported(mode)
        if not configured:
            pref = getattr(ssn, "solver_mode", None)
            if pref in ("packed", "sharded", "auto"):
                mode = self._preferred_mode(ssn, pref, default)
        if ssn.solver_options.get("force_host_allocate"):
            mode = "host"
        return mode

    @staticmethod
    def _preferred_mode(ssn, pref: str, default: str) -> str:
        """The solver-mode decision rule. 'packed' keeps the single-device
        solver; 'sharded' always dispatches the node-axis sharded solver
        over the sharded arena; 'auto' picks sharded exactly when the
        padded problem's device-resident footprint — one full upload at
        the current layout, measured from whichever arena served the last
        session — exceeds the per-device byte budget
        (``sharded_byte_budget``). The first session (no layout measured
        yet) and a zero/unset budget run packed."""
        if pref == "sharded":
            return "sharded"
        if pref == "packed":
            return default
        budget = int(getattr(ssn, "sharded_byte_budget", 0) or 0)
        if budget <= 0:
            return default
        est = 0
        for attr in ("device_cache", "sharded_device_cache"):
            c = getattr(ssn, attr, None)
            if c is not None:
                try:
                    est = max(est, c.full_upload_bytes())
                except Exception:  # noqa: BLE001 — sizing is advisory
                    pass
        return "sharded" if est > budget else default


#: action modes of the JAX package this package does not run yet, with the
#: ROADMAP item that ports each (none since the sharded mode, A7)
UNPORTED_MODES: dict = {}


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
