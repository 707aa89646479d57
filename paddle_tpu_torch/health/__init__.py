"""Run health — counterpart of ``paddle_tpu/health``: the on-device
sentinel (``make_train_step(sentinel=True)`` and ``guard_step`` for pure
steps), the skip -> restore -> abort ladder (``HealthMonitor`` over
``distributed.checkpoint.AsyncCheckpointer``) and the in-process hang
watchdog, and the imperative ``Sentinel`` with ``health_state_tensors``
(``jit.TrainStep(sentinel=...)``)."""

from .monitor import (AnomalyRecord, HealthAbortError, HealthAction,
                      HealthMonitor)
from .sentinel import (Sentinel, guard_step, health_state_tensors,
                       pack_health, sentinel_check, sentinel_init,
                       tree_where, unpack_health)
from .watchdog import (HUNG_EXIT_RC, HangWatchdog, WatchdogAlarm, current,
                       install, section, touch, uninstall)

__all__ = ["Sentinel", "health_state_tensors", "guard_step", "sentinel_init", "sentinel_check", "tree_where",
           "pack_health", "unpack_health", "HealthMonitor", "HealthAction",
           "HealthAbortError", "AnomalyRecord", "HangWatchdog",
           "WatchdogAlarm", "HUNG_EXIT_RC", "install", "uninstall",
           "current", "touch", "section"]
