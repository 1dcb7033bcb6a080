"""Host-side run utilities of the port (counterpart of ``ubpl_tpu/utils``):
the leveled logger, the JSON run logs, the run report, the preemption
guard, profiler traces and debug drawings."""
from .jsonlog import json_save                 # noqa: F401
from .logger import Logger                     # noqa: F401
