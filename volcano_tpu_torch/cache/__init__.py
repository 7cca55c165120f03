"""Cluster-state cache + effector seams (reference pkg/scheduler/cache)."""

from .cache import (  # noqa: F401
    DefaultBinder, DefaultEvictor, DefaultStatusUpdater, DefaultVolumeBinder,
    SchedulerCache,
)
from .fakes import (  # noqa: F401
    FakeBinder, FakeEvictor, FakeStatusUpdater, FakeVolumeBinder,
    RecordingBinder, RecordingEvictor,
)
from .interface import Binder, Cache, Evictor, StatusUpdater, VolumeBinder  # noqa: F401
