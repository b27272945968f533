"""Import every module that registers CLI modes (the mode census lives here)."""

# Registration happens at import time via @register("mode", ...) decorators.
# Keep this list sorted. The port's other modes arrive with the slices that
# need them (ROADMAP.md).

import importlib

from . import rtc  # noqa: F401  (registers the "be" backends: cuda, interp, ipc)

_MODE_MODULES = [
    "boda_tpu_torch.modes.apps",
    "boda_tpu_torch.modes.basic",
    "boda_tpu_torch.modes.calib",
    "boda_tpu_torch.modes.cnet",
    "boda_tpu_torch.modes.cnn_prof",
    "boda_tpu_torch.modes.detect",
    "boda_tpu_torch.modes.ipc_modes",
    "boda_tpu_torch.modes.lmdb_modes",
    "boda_tpu_torch.modes.net_trace",
    "boda_tpu_torch.modes.net_tune",
    "boda_tpu_torch.modes.prof",
    "boda_tpu_torch.modes.rtc",
    "boda_tpu_torch.modes.serve_bench",
    "boda_tpu_torch.modes.surgery_modes",
    "boda_tpu_torch.modes.test_cmds",
    "boda_tpu_torch.modes.test_compute",
    "boda_tpu_torch.modes.train_bench",
    "boda_tpu_torch.modes.train_lmdb",
    "boda_tpu_torch.modes.zmq_modes",
]

for _m in _MODE_MODULES:
    importlib.import_module(_m)
