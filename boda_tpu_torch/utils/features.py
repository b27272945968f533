"""Runtime feature detection (the analog of build-feature gating).

Counterpart of ``boda_tpu/utils/features.py``: a feature is an optional
Python module a mode may need, detected at run time, or the reference's nets
directory (``ref_nets``), which a config file names as ``ref_nets_dir``.
"""

from __future__ import annotations

import importlib
from functools import lru_cache


@lru_cache(maxsize=None)
def is_feature_enabled(name: str) -> bool:
    if name in ("lmdb", "zmq", "torch", "PIL"):
        try:
            importlib.import_module(name)
            return True
        except ImportError:
            return False
    if name == "ref_nets":  # the reference's nets/ zoo (prototxt fixtures)
        import os

        from ..config import _ENV
        d = _ENV.get("ref_nets_dir", "")
        return bool(d) and os.path.isdir(d)
    raise ValueError(f"unknown feature name {name!r}")
