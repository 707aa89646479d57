"""Run health — counterpart of ``paddle_tpu/health``: the on-device
sentinel and the in-process hang watchdog."""

from .sentinel import pack_health, sentinel_check, sentinel_init, \
    unpack_health
from .watchdog import (HUNG_EXIT_RC, HangWatchdog, WatchdogAlarm, current,
                       install, section, touch, uninstall)

__all__ = ["sentinel_init", "sentinel_check", "pack_health",
           "unpack_health", "HangWatchdog", "WatchdogAlarm", "HUNG_EXIT_RC",
           "install", "uninstall", "current", "touch", "section"]
