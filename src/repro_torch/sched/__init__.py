"""Continuous-batching slot scheduler (``scheduler.SlotScheduler``)."""
from repro_torch.sched.scheduler import SlotScheduler  # noqa: F401
