"""Continuous-batching slot scheduler (``scheduler.SlotScheduler``) and
the maintenance trigger (``scheduler.Cadence``)."""
from repro_torch.sched.scheduler import Cadence, SlotScheduler  # noqa: F401
