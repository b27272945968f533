"""Runtime feature detection (the analog of build-feature gating).

Counterpart of ``boda_tpu/utils/features.py``: a feature is an optional
Python module a mode may need, detected at run time.
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
    raise ValueError(f"unknown feature name {name!r}")
