"""Mode dispatch: one entry point, many subcommands.

Counterpart of ``boda_tpu/cli.py``: argv -> lexp -> registry-instantiated
mode object -> ``main()``, plus generated help. Run as
``python -m boda_tpu_torch <mode> --k=v ...``.
"""

from __future__ import annotations

import sys

from . import modes_all  # noqa: F401  (imports register all modes)
from .config import ConfigError, default_cfg_init, help_str, instantiate, run_mode
from .utils.lexp import LexpError, lexp_from_argv


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    default_cfg_init()
    try:
        if not argv or argv[0] in ("help", "--help", "-h"):
            sys.stdout.write(help_str("mode"))
            if len(argv) > 1:
                sys.stdout.write("\n" + help_str("mode", argv[1]))
            return 0
        if len(argv) >= 2 and argv[1] in ("--help", "-h"):
            sys.stdout.write(help_str("mode", argv[0]))
            return 0
        # run_mode: the mode's output dir is where a nested stream sink writes
        run_mode(instantiate("mode", lexp_from_argv(argv), check_unused_keys=True))
        return 0
    except (ConfigError, LexpError, ValueError, RuntimeError) as e:
        sys.stderr.write(f"error: {e}\n")
        return 1
    except SystemExit as e:  # a mode's own failure exit (test_compute)
        return int(e.code or 0)


if __name__ == "__main__":
    sys.exit(main())
