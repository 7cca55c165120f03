"""Job controller (reference pkg/controllers/job)."""

from .controller import JobController, apply_policies  # noqa: F401
from .plugins import EnvPlugin, SSHPlugin, SvcPlugin, get_plugin  # noqa: F401
from .state import (  # noqa: F401
    POD_RETAIN_PHASE_NONE, POD_RETAIN_PHASE_SOFT, new_state,
)
