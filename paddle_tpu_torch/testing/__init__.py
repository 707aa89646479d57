"""Testing utilities — the port's fault-injection (chaos) harness lives in
``paddle_tpu_torch.testing.chaos``."""

from . import chaos  # noqa: F401

__all__ = ["chaos"]
