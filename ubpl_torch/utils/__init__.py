"""Host-side run utilities of the port (counterpart of ``ubpl_tpu/utils``):
the leveled logger and the JSON run logs."""
from .jsonlog import json_save                 # noqa: F401
from .logger import Logger                     # noqa: F401
