from . import compute  # noqa: F401  (registers the "be" base)
from . import backends  # noqa: F401  (registers the cuda/interp backends)
from . import ipc  # noqa: F401  (registers the ipc remote backend)
