"""Basic utility modes (help/selftest style).

Counterpart of ``boda_tpu/modes/basic.py``; ``compsup`` lists the port's
registered modes and their Fields.
"""

from __future__ import annotations

import sys

from ..config import Field, Mode, register


@register("mode", "noop", help="do nothing (dispatch smoke test)")
class Noop(Mode):
    msg = Field(str, default="noop ok", help="message to print")

    def main(self) -> None:
        sys.stdout.write(self.msg + "\n")


@register("mode", "compsup", help="shell-completion support: list modes/fields")
class Compsup(Mode):
    """ref compsup_t (boda_help.cc:24): emit completion words for the shell.
    With no args, print all mode ids; with a mode name, print its fields."""
    arg = Field(str, default="", help="mode name to complete fields for")

    def main(self) -> None:
        from ..config import class_fields, get_class, registered_tids
        if not self.arg:
            for tid in registered_tids("mode"):
                sys.stdout.write(tid + "\n")
            return
        cls = get_class("mode", self.arg)
        for f in class_fields(cls):
            sys.stdout.write(f"--{f.name.replace('_', '-')}=\n")
