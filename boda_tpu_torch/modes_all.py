"""Import every module that registers CLI modes (the mode census lives here)."""

# Registration happens at import time via @register("mode", ...) decorators.
# Keep this list sorted. The port's other modes arrive with the slices that
# need them (ROADMAP.md).

import importlib

from . import rtc  # noqa: F401  (registers the "be" backends: cuda, interp)

_MODE_MODULES = [
    "boda_tpu_torch.modes.cnet",
    "boda_tpu_torch.modes.prof",
    "boda_tpu_torch.modes.rtc",
    "boda_tpu_torch.modes.surgery_modes",
    "boda_tpu_torch.modes.test_compute",
]

for _m in _MODE_MODULES:
    importlib.import_module(_m)
