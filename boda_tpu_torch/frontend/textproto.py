"""Generic protobuf text-format parser (for Caffe prototxt files).

Counterpart of ``boda_tpu/frontend/textproto.py``, copied: pure Python, with
the same error texts (the golden commands compare them).

Parity target: the prototxt half of ``parse_and_upgrade_net_param_from_text_file``
(ref src/caffepb.cc:329). Instead of compiled proto classes, parses the text
format generically into nested dicts: every field name maps to a LIST of its
occurrences (protobuf fields are repeatable); message values are dicts.

Grammar: message = { field }*; field = name ( ":" scalar | message-block );
message-block = "{" message "}"; comments start with '#'.
"""

from __future__ import annotations


class TextProtoError(ValueError):
    pass


class _Lexer:
    def __init__(self, s: str, fn: str = "<string>"):
        self.s = s
        self.i = 0
        self.fn = fn
        self.line = 1

    def _skip_ws(self):
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == "#":
                while self.i < len(self.s) and self.s[self.i] != "\n":
                    self.i += 1
            elif c in " \t\r\n,;":
                if c == "\n":
                    self.line += 1
                self.i += 1
            else:
                break

    def peek(self) -> str:
        self._skip_ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def next_token(self) -> str:
        self._skip_ws()
        if self.i >= len(self.s):
            return ""
        c = self.s[self.i]
        if c in "{}:":
            self.i += 1
            return c
        if c in "\"'":
            return self._string(c)
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in " \t\r\n{}:#,;":
            self.i += 1
        return self.s[start:self.i]

    def _string(self, q: str) -> str:
        out = []
        self.i += 1
        while True:
            if self.i >= len(self.s):
                raise TextProtoError(f"{self.fn}:{self.line}: unterminated string")
            c = self.s[self.i]
            if c == q:
                self.i += 1
                break
            if c == "\\":
                self.i += 1
                esc = self.s[self.i]
                out.append({"n": "\n", "t": "\t", "r": "\r"}.get(esc, esc))
                self.i += 1
            else:
                out.append(c)
                self.i += 1
        return "\x00STR\x00" + "".join(out)  # marker distinguishes from idents

    def err(self, msg: str):
        raise TextProtoError(f"{self.fn}:{self.line}: {msg}")


def _coerce(tok: str):
    if tok.startswith("\x00STR\x00"):
        return tok[5:]
    if tok in ("true", "True"):
        return True
    if tok in ("false", "False"):
        return False
    try:
        return int(tok, 0)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # enum identifier


def _parse_message(lx: _Lexer, depth: int = 0) -> dict:
    msg: dict = {}
    while True:
        c = lx.peek()
        if c == "":
            if depth:
                lx.err("unexpected end of file inside message")
            return msg
        if c == "}":
            if not depth:
                lx.err("unmatched '}'")
            lx.next_token()
            return msg
        name = lx.next_token()
        if not name or name in "{}:":
            lx.err(f"expected field name, got {name!r}")
        c = lx.peek()
        if c == ":":
            lx.next_token()
            if lx.peek() == "{":  # allow "name: { ... }"
                lx.next_token()
                val = _parse_message(lx, depth + 1)
            else:
                val = _coerce(lx.next_token())
        elif c == "{":
            lx.next_token()
            val = _parse_message(lx, depth + 1)
        else:
            lx.err(f"expected ':' or '{{' after field {name!r}")
        msg.setdefault(name, []).append(val)
    return msg


def parse_textproto(s: str, fn: str = "<string>") -> dict:
    return _parse_message(_Lexer(s, fn))


def parse_textproto_file(fn: str) -> dict:
    import os
    if not os.path.exists(fn):  # clean error, not a traceback (ref ifs_open)
        raise ValueError(
            f"can't open prototxt file {os.path.basename(fn)!r}: no such file")
    with open(fn) as f:
        # basename in diagnostics: error text stays machine-independent (the
        # golden harness pins exact error strings)
        return parse_textproto(f.read(), os.path.basename(fn))


# -- convenience accessors -------------------------------------------------------

def get1(msg: dict, name: str, default=None):
    v = msg.get(name)
    return v[0] if v else default


def getl(msg: dict, name: str) -> list:
    return msg.get(name, [])
