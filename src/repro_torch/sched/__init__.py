"""Continuous-batching slot scheduler with FIFO and SLO admission
(``scheduler.SlotScheduler``, ``scheduler.shed_and_select``), the
maintenance trigger (``scheduler.Cadence``) and the injectable
``scheduler.ManualClock``."""
from repro_torch.sched.scheduler import (ADMISSION_POLICIES,  # noqa: F401
                                         Cadence, ManualClock,
                                         SlotScheduler, shed_and_select)
