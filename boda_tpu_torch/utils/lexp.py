"""lexp — the universal config-value tree.

A "list expression" is either a *leaf* string value or a parenthesized list of
``name=value`` pairs: ``(k=v,k2=(a=b,c=()))``. It is the single value format
used everywhere: CLI flags, nested option strings, XML command files.

Behavioral parity target: reference ``src/lexp.{H,cc}`` (parse rules, escape
rules, use-count based unused-key detection, ``%(name)`` string templating).
Fresh implementation; no code derived from the reference. Copied unchanged
from ``boda_tpu/utils/lexp.py`` (pure Python).

Syntax rules:
  * A value beginning with ``(`` is a list; otherwise it is a leaf.
  * Inside a leaf, the characters ``, = ( )`` terminate the value unless
    escaped with a backslash; ``\\X`` yields literal ``X`` in the cooked value.
  * A list is ``(`` [name ``=`` value {``,`` name ``=`` value}] [``,``] ``)``.
  * Names are raw (no escapes) and must be non-empty, without special chars.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Iterator, Optional


class LexpError(ValueError):
    """Parse or usage error for lexp values."""


_SPECIAL = set(",=()")


@dataclass
class Lexp:
    """Either a leaf (``leaf_val`` is a str) or a list node (``kids``)."""

    leaf_val: Optional[str] = None
    kids: list[tuple[str, "Lexp"]] = field(default_factory=list)
    src: str = ""          # raw source text (for error messages)
    use_cnt: int = 0       # client-managed; nodes left at 0 => unused-key error

    # -- basic structure ----------------------------------------------------
    @property
    def is_leaf(self) -> bool:
        return self.leaf_val is not None

    def get_kid(self, name: str) -> Optional["Lexp"]:
        for k, v in self.kids:
            if k == name:
                return v
        return None

    def add(self, name: str, val: "Lexp | str") -> "Lexp":
        if isinstance(val, str):
            val = Lexp(leaf_val=val, src=val)
        self.kids.append((name, val))
        return self

    def deep_inc_use_cnt(self) -> None:
        self.use_cnt += 1
        for _, v in self.kids:
            v.deep_inc_use_cnt()

    # -- rendering -----------------------------------------------------------
    def _esc_leaf(self) -> str:
        assert self.leaf_val is not None
        out = []
        for c in self.leaf_val:
            if c in _SPECIAL or c == "\\":
                out.append("\\")
            out.append(c)
        return "".join(out)

    def __str__(self) -> str:
        if self.is_leaf:
            return self._esc_leaf()
        return "(" + ",".join(f"{k}={v}" for k, v in self.kids) + ")"

    def as_dict(self):
        """Recursive plain-python view: leaf -> str, list -> dict (dup keys kept last)."""
        if self.is_leaf:
            return self.leaf_val
        return {k: v.as_dict() for k, v in self.kids}

    def walk(self, path: str = "") -> Iterator[tuple[str, "Lexp"]]:
        yield path, self
        for k, v in self.kids:
            yield from v.walk(f"{path}.{k}" if path else k)


def _parse_value(s: str, pos: int) -> tuple[Lexp, int]:
    if pos < len(s) and s[pos] == "(":
        return _parse_list(s, pos)
    # leaf: consume until an unescaped special char. Balanced parens inside a
    # leaf are allowed (so %(var) templating refs parse unescaped, matching
    # the reference's CLI usage like --fn=%(models_dir)/x).
    out = []
    start = pos
    depth = 0
    while pos < len(s):
        c = s[pos]
        if c == "\\":
            if pos + 1 >= len(s):
                raise LexpError(
                    f"lexp parse error: escape '\\' at end of input in {s!r}")
            out.append(s[pos + 1])
            pos += 2
            continue
        if c == "(":
            depth += 1
        elif c == ")":
            if depth == 0:
                break
            depth -= 1
        elif c in ",=" and depth == 0:
            break
        out.append(c)
        pos += 1
    if depth:
        raise LexpError(
            f"lexp parse error: unbalanced '(' inside leaf value in {s!r}")
    return Lexp(leaf_val="".join(out), src=s[start:pos]), pos


def _parse_name(s: str, pos: int) -> tuple[str, int]:
    start = pos
    while pos < len(s) and s[pos] not in _SPECIAL and s[pos] != "\\":
        pos += 1
    if pos == start:
        raise LexpError(
            f"lexp parse error: expected name at char {start} of {s!r}")
    return s[start:pos], pos


def _parse_list(s: str, pos: int) -> tuple[Lexp, int]:
    assert s[pos] == "("
    start = pos
    pos += 1
    node = Lexp(kids=[])
    while True:
        if pos >= len(s):
            raise LexpError(
                f"lexp parse error: unterminated list starting at char {start} of {s!r}")
        if s[pos] == ")":
            pos += 1
            break
        name, pos = _parse_name(s, pos)
        if pos >= len(s) or s[pos] != "=":
            raise LexpError(
                f"lexp parse error: expected '=' after name {name!r} at char {pos} of {s!r}")
        pos += 1
        val, pos = _parse_value(s, pos)
        node.kids.append((name, val))
        if pos < len(s) and s[pos] == ",":
            pos += 1
        elif pos < len(s) and s[pos] != ")":
            raise LexpError(
                f"lexp parse error: expected ',' or ')' at char {pos} of {s!r}")
    node.src = s[start:pos]
    return node, pos


def parse_lexp(s: str) -> Lexp:
    """Parse a full string as one lexp value (leaf or list)."""
    val, pos = _parse_value(s, 0)
    if pos != len(s):
        raise LexpError(
            f"lexp parse error: trailing characters at char {pos} of {s!r}")
    val.src = s
    return val


def parse_lexp_leaf_str(s: str) -> Lexp:
    """Treat the entire string as a raw leaf (no special-char interpretation)."""
    return Lexp(leaf_val=s, src=s)


def make_list_lexp(**kwargs: "str | Lexp") -> Lexp:
    node = Lexp(kids=[])
    for k, v in kwargs.items():
        node.add(k, v)
    return node


# -- CLI conversion ----------------------------------------------------------

def lexp_from_argv(argv: list[str]) -> Lexp:
    """Convert CLI args into a mode-invocation lexp.

    ``<mode> --k=v --flag pos1 pos2`` becomes
    ``(mode=<mode>,k=v,flag=1,boda_pos_args_=(_0=pos1,_1=pos2))``.
    ``--k`` with no ``=`` means ``k=1``. Values after ``--k=`` are parsed as
    lexps (so ``--rtc='(be=tpu)'`` nests).
    """
    node = Lexp(kids=[])
    pos_args: list[str] = []
    for a in argv:
        if a.startswith("--"):
            body = a[2:]
            if "=" in body:
                k, v = body.split("=", 1)
                node.add(k.replace("-", "_"), parse_lexp(v))
            else:
                node.add(body.replace("-", "_"), "1")
        else:
            pos_args.append(a)
    if pos_args:
        mode = pos_args.pop(0)
        node.kids.insert(0, ("mode", Lexp(leaf_val=mode, src=mode)))
    if pos_args:
        pa = Lexp(kids=[])
        for i, p in enumerate(pos_args):
            pa.add(f"_{i}", parse_lexp(p))
        node.add("boda_pos_args_", pa)
    return node


# -- XML command files -------------------------------------------------------

def lexp_from_xml(elem: ET.Element) -> Lexp:
    """An XML element maps to a list lexp: attributes + child elements as kids.

    Text-only children become leaves. Mirrors the reference's XML command-file
    support (ref src/lexp.cc parse_lexp_xml_file)."""
    node = Lexp(kids=[])
    for k, v in elem.attrib.items():
        node.add(k, parse_lexp(v))
    for child in elem:
        if len(child) == 0 and not child.attrib:
            node.add(child.tag, parse_lexp_leaf_str(child.text or ""))
        else:
            node.add(child.tag, lexp_from_xml(child))
    return node


def parse_lexp_xml_file(fn: str, elem_path: str = "") -> Lexp:
    root = ET.parse(fn).getroot()
    if elem_path:
        for part in elem_path.split("/"):
            nxt = root.find(part)
            if nxt is None:
                raise LexpError(f"xml element path {elem_path!r} not found in {fn!r}")
            root = nxt
    return lexp_from_xml(root)


# -- unused-key detection ------------------------------------------------------

def check_unused(l: Lexp, path: str = "") -> list[str]:
    """Return paths of all nodes with use_cnt==0 (skipping used subtrees' roots)."""
    unused = []
    if l.use_cnt == 0:
        unused.append(path or "<root>")
        return unused  # whole subtree unused; report root only
    for k, v in l.kids:
        unused.extend(check_unused(v, f"{path}.{k}" if path else k))
    return unused


# -- %(name) string templating -------------------------------------------------

def str_format_find_all_refs(fmt: str) -> list[str]:
    refs = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "%":
            if i + 1 < len(fmt) and fmt[i + 1] == "%":
                i += 2
                continue
            if i + 1 >= len(fmt) or fmt[i + 1] != "(":
                raise LexpError(f"str_format: '%' must be followed by '(' or '%' in {fmt!r}")
            end = fmt.find(")", i + 2)
            if end == -1:
                raise LexpError(f"str_format: unterminated %%(ref in {fmt!r}")
            refs.append(fmt[i + 2:end])
            i = end + 1
        else:
            i += 1
    return refs


def str_format_from_nvm(fmt: str, nvm: dict) -> str:
    """Expand ``%(name)`` refs from nvm; ``%%`` is a literal ``%``."""
    out = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%":
            if i + 1 < len(fmt) and fmt[i + 1] == "%":
                out.append("%")
                i += 2
                continue
            if i + 1 >= len(fmt) or fmt[i + 1] != "(":
                raise LexpError(f"str_format: '%' must be followed by '(' or '%' in {fmt!r}")
            end = fmt.find(")", i + 2)
            if end == -1:
                raise LexpError(f"str_format: unterminated %%(ref in {fmt!r}")
            ref = fmt[i + 2:end]
            if ref not in nvm:
                raise LexpError(f"str_format: ref %({ref}) not found in name/value map"
                                f" (have: {sorted(nvm)})")
            v = nvm[ref]
            out.append(v.leaf_val if isinstance(v, Lexp) else str(v))
            i = end + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)
