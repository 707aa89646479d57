from . import sequence_parallel_utils  # noqa: F401
from ..recompute import recompute  # noqa: F401
