from . import pipe  # noqa: F401
from . import executor  # noqa: F401  (registers the "conv_fwd" engines)
from . import ssd_ops  # noqa: F401  (registers the SSD detection op set)
