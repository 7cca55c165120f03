"""Global rescheduler: periodic device-solved defragmentation with
bounded, fenced migration plans (see reschedule/action.py).

Public surface:

- ``RescheduleAction`` — the scheduler action (registered as
  ``reschedule``; wire it into the conf's actions string or enable it
  with ``Scheduler(reschedule_interval=N)``);
- ``build_plan`` / ``MigrationPlan`` / ``MoveCandidate`` — pure plan
  bounding (budget, per-job disruption caps, no-op rejection);
- ``stranded_fraction`` / ``largest_free_slot`` — the host-side
  fragmentation metrics;
- ``MigrationIntentJournal`` / ``reconcile_migration_intents`` — the
  crash-safe wave journal and its takeover reconciliation pass.
"""

from .action import DEFAULTS, RescheduleAction  # noqa: F401
from .intent import (  # noqa: F401
    MigrationIntentJournal, reconcile_migration_intents,
)
from .plan import (  # noqa: F401
    MIGRATION_REASON, MigrationPlan, MoveCandidate, build_plan,
    largest_free_slot, stranded_fraction,
)
