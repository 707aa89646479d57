"""On-device run-health sentinel — counterpart of ``paddle_tpu/health``."""

from .sentinel import pack_health, sentinel_check, sentinel_init, \
    unpack_health

__all__ = ["sentinel_init", "sentinel_check", "pack_health",
           "unpack_health"]
