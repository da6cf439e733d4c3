"""Host-side utilities of the port: trace ranges and timers
(:mod:`~zaftpu_torch.utils.profiling`), the operator disk cache and the
host fetch (:mod:`~zaftpu_torch.utils.fetch`)."""

from zaftpu_torch.utils.profiling import (  # noqa: F401
    TransformStats, annotate, timed)
