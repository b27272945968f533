"""Declarative config schema, polymorphic factory registry, and init engine.

Counterpart of ``boda_tpu/config.py`` (itself modelled on the reference's
NESI reflection system, ref src/nesi.{H,cc}): every component with
parameters declares typed fields with defaults/required/help; instances are
created polymorphically by a type-id string through a registry; values come
uniformly from CLI flags or nested lexp strings; strict
unused-key errors catch typos; help text is generated from the declarations.

Usage::

    @register("mode", "cnet_ana", help="per-layer shape/FLOPs analysis")
    class CnetAna(Mode):
        model = Field(str, default="", help="zoo model name")
        def main(self): ...

    obj = instantiate("mode", parse_lexp("(mode=cnet_ana,model=resnet50)"))
"""

from __future__ import annotations

import os
from typing import Optional

from .utils.dims import Dims
from .utils.lexp import Lexp, check_unused, parse_lexp, str_format_from_nvm


class ConfigError(ValueError):
    """User-facing config error (bad value, missing required, unused key...)."""


class Field:
    """A declared config field on a registered class.

    ``ftype`` is one of: ``str``, ``int``, ``float``, ``bool``, ``Dims``,
    ``"filename"`` (a string with ``%(var)`` references expanded from the
    global env), ``"lexp"`` (the raw value, parsed later), a registered base key string (polymorphic nested object, e.g. ``"backend"``), or
    ``(list, T)`` / ``(dict, T)`` for sequences/maps of any of the above.
    Defaults are given in lexp *string* form so help text shows them verbatim.
    """

    _order_counter = 0

    def __init__(self, ftype, default: Optional[str] = None, req: bool = False,
                 help: str = ""):
        self.ftype = ftype
        self.default = default
        self.req = req
        self.help = help
        self.name: str = ""  # set by decorator
        Field._order_counter += 1
        self.order = Field._order_counter

    def type_str(self) -> str:
        t = self.ftype
        if isinstance(t, tuple):
            return f"{t[0].__name__}[{t[1] if isinstance(t[1], str) else t[1].__name__}]"
        if isinstance(t, str):
            return t
        return t.__name__


# registry: base_key -> {"tid_vn": str, "classes": {tid: cls}, "base_cls": type}
_REGISTRY: dict[str, dict] = {}


def register_base(base_key: str, tid_vn: str = "mode"):
    """Declare ``cls`` as a polymorphic base; subclasses select by ``tid_vn=<tid>``."""
    def deco(cls):
        _REGISTRY[base_key] = {"tid_vn": tid_vn, "classes": {}, "base_cls": cls}
        cls._base_key = base_key
        return cls
    return deco


def register(base_key: str, tid: str, help: str = ""):
    """Register a concrete class under ``base_key`` with type-id ``tid``."""
    def deco(cls):
        if base_key not in _REGISTRY:
            raise RuntimeError(f"register: unknown base key {base_key!r}")
        _REGISTRY[base_key]["classes"][tid] = cls
        cls._tid = tid
        cls._base_key = base_key
        cls._help = help
        return cls
    return deco


def registered_tids(base_key: str) -> list[str]:
    return sorted(_REGISTRY[base_key]["classes"])


def get_class(base_key: str, tid: str):
    reg = _REGISTRY.get(base_key)
    if reg is None:
        raise ConfigError(f"unknown registry base {base_key!r}")
    cls = reg["classes"].get(tid)
    if cls is None:
        raise ConfigError(
            f"unknown {base_key} type id {tid!r}; valid values: {registered_tids(base_key)}")
    return cls


def class_fields(cls) -> list[Field]:
    """All Field declarations in MRO order (base first), deduped by name."""
    seen: dict[str, Field] = {}
    for klass in reversed(cls.__mro__):
        for k, v in vars(klass).items():
            if isinstance(v, Field):
                v.name = k
                seen[k] = v
    return sorted(seen.values(), key=lambda f: f.order)


# -- environment (global config vars for %() filename expansion) ---------------

_ENV: dict[str, str] = {}


def get_env() -> dict[str, str]:
    """A copy of the global env (boda_tpu: config.py:129)."""
    return dict(_ENV)


def run_mode(mode) -> None:
    """Run a mode with its ``boda_output_dir`` visible in the global env, so
    nested non-mode components resolve relative output filenames under the
    mode's output dir (boda_tpu: config.py:133; ref boda_output_dir
    semantics, src/has_main.H)."""
    prev = _ENV.get("boda_output_dir")
    _ENV["boda_output_dir"] = mode.boda_output_dir
    try:
        mode.main()
    finally:
        if prev is None:
            _ENV.pop("boda_output_dir", None)
        else:
            _ENV["boda_output_dir"] = prev


def load_cfg_file(fn: str) -> None:
    """Load root attributes of an XML config file as global env vars."""
    import xml.etree.ElementTree as ET
    root = ET.parse(fn).getroot()
    _ENV.update(root.attrib)


def default_cfg_init(repo_root: Optional[str] = None) -> None:
    """The env every run starts from; ``boda_tpu_cfg.xml`` at the repo root,
    where present, adds to it. (boda_tpu's ``ref_nets_dir`` belongs to the
    prototxt frontend, which the port does not have yet.)"""
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _ENV.setdefault("boda_dir", repo_root)
    _ENV.setdefault("boda_test_dir", os.path.join(repo_root, "testdata"))
    _ENV.setdefault("boda_output_dir", ".")
    _ENV.setdefault("models_dir", os.path.join(repo_root, "models"))
    cfg = os.path.join(repo_root, "boda_tpu_cfg.xml")
    if os.path.exists(cfg):
        load_cfg_file(cfg)


# -- value conversion -----------------------------------------------------------

def _conv_scalar(ftype, l: Lexp, path: str):
    if not l.is_leaf:
        raise ConfigError(f"{path}: expected a leaf value, got list {l}")
    v = l.leaf_val
    try:
        if ftype is str:
            return v
        if ftype is int:
            return int(v, 0)
        if ftype is float:
            return float(v)
        if ftype is bool:
            if v in ("1", "true", "True"):
                return True
            if v in ("0", "false", "False"):
                return False
            raise ValueError(f"bad bool {v!r}")
        if ftype is Dims:
            raise ConfigError(f"{path}: Dims requires a list value")
    except (ValueError, TypeError) as e:
        raise ConfigError(f"{path}: can't convert {v!r} to {ftype.__name__}: {e}") from None
    raise ConfigError(f"{path}: unsupported field type {ftype!r}")


def _conv_value(ftype, l: Lexp, path: str):
    l.use_cnt += 1
    if ftype == "filename":
        if not l.is_leaf:
            raise ConfigError(f"{path}: expected a filename leaf, got list")
        return str_format_from_nvm(l.leaf_val, _ENV)
    if ftype == "lexp":
        l.deep_inc_use_cnt()
        return l
    if isinstance(ftype, str):  # polymorphic nested object by registry key
        return instantiate(ftype, l, _path=path)
    if isinstance(ftype, tuple):
        kind, et = ftype
        if l.is_leaf:
            raise ConfigError(f"{path}: expected a list value for {kind.__name__}, got leaf"
                              f" {l.leaf_val!r}")
        if kind is list:
            return [_conv_value(et, v, f"{path}.{k}") for k, v in l.kids]
        if kind is dict:
            return {k: _conv_value(et, v, f"{path}.{k}") for k, v in l.kids}
        raise ConfigError(f"{path}: unsupported container {kind!r}")
    if ftype is Dims:
        if l.is_leaf:
            raise ConfigError(f"{path}: Dims requires a list value like (img=1,chan=3)")
        l.deep_inc_use_cnt()
        names, sizes, tn = [], [], "float32"
        for k, v in l.kids:
            if k == "__tn__":
                tn = v.leaf_val
            else:
                names.append(k)
                try:
                    sizes.append(int(v.leaf_val))
                except (TypeError, ValueError):
                    raise ConfigError(f"{path}.{k}: bad dim size {v}") from None
        return Dims.make(names, sizes, tn)
    if isinstance(ftype, type) and hasattr(ftype, "_base_key") and \
            not isinstance(getattr(ftype, "_tid", None), str):
        # a concrete base class used directly: instantiate via its registry
        return instantiate(ftype._base_key, l, _path=path)
    return _conv_scalar(ftype, l, path)


def _parse_default(f: Field) -> Lexp:
    """Scalar defaults are raw leaves (may contain %() parens); structured
    defaults (lists/maps/Dims/nested objects) are parsed as lexps."""
    from .utils.lexp import parse_lexp_leaf_str
    t = f.ftype
    structured = isinstance(t, (tuple,)) or t is Dims or \
        (isinstance(t, str) and t != "filename") or f.default.startswith("(")
    return parse_lexp(f.default) if structured else parse_lexp_leaf_str(f.default)


def init_fields(obj, l: Lexp, path: str = "") -> None:
    """Initialize all declared fields of ``obj`` from list-lexp ``l``."""
    if l.is_leaf:
        raise ConfigError(f"{path or type(obj).__name__}: expected a list value, "
                          f"got leaf {l.leaf_val!r}")
    fields = class_fields(type(obj))
    fmap = {f.name: f for f in fields}
    for f in fields:
        kid = l.get_kid(f.name)
        fpath = f"{path}.{f.name}" if path else f.name
        if kid is None:
            if f.default is not None:
                setattr(obj, f.name, _conv_value(f.ftype, _parse_default(f), fpath))
            elif f.req:
                raise ConfigError(f"{fpath}: missing required value "
                                  f"(type={f.type_str()}; help: {f.help})")
            else:
                setattr(obj, f.name, None)
        else:
            setattr(obj, f.name, _conv_value(f.ftype, kid, fpath))
    # duplicate keys: last wins but all are 'used'
    for k, v in l.kids:
        if k in fmap:
            v.use_cnt = max(v.use_cnt, 1)


def instantiate(base_key: str, l: Lexp, check_unused_keys: bool = False,
                _path: str = ""):
    """Create+init a registered object from a lexp (polymorphic by tid field)."""
    reg = _REGISTRY.get(base_key)
    if reg is None:
        raise ConfigError(f"unknown registry base {base_key!r}")
    tid_vn = reg["tid_vn"]
    if l.is_leaf:
        # a bare leaf is shorthand for (tid_vn=<leaf>)
        tid = l.leaf_val
        l = Lexp(kids=[])
    else:
        l.use_cnt += 1
        tk = l.get_kid(tid_vn)
        if tk is None:
            raise ConfigError(
                f"{_path or base_key}: missing {tid_vn}= type selector; "
                f"valid values: {registered_tids(base_key)}")
        tk.use_cnt += 1
        tid = tk.leaf_val
    cls = get_class(base_key, tid)
    obj = cls.__new__(cls)
    init_fields(obj, l, _path or tid)
    if hasattr(obj, "base_setup"):
        obj.base_setup()
    if check_unused_keys:
        unused = check_unused(l)
        if unused:
            raise ConfigError(
                f"unused config key(s) (typo?): {', '.join(unused)}")
    return obj


def make(base_key: str, tid: str, **kw):
    """Programmatic construction: kwargs are python values assigned directly;
    unset fields get their declared defaults."""
    cls = get_class(base_key, tid)
    obj = cls.__new__(cls)
    for f in class_fields(cls):
        if f.name in kw:
            setattr(obj, f.name, kw.pop(f.name))
        elif f.default is not None:
            setattr(obj, f.name, _conv_value(f.ftype, _parse_default(f), f.name))
        elif f.req:
            raise ConfigError(f"{tid}: missing required field {f.name!r}")
        else:
            setattr(obj, f.name, None)
    if kw:
        raise ConfigError(f"{tid}: unknown field(s) {sorted(kw)}")
    if hasattr(obj, "base_setup"):
        obj.base_setup()
    return obj


# -- help generation --------------------------------------------------------------

def help_str(base_key: str, tid: Optional[str] = None) -> str:
    reg = _REGISTRY[base_key]
    out = []
    if tid is None:
        out.append(f"{base_key} — registered type ids (select with {reg['tid_vn']}=<tid>):")
        for t in registered_tids(base_key):
            out.append(f"  {t:28s} {getattr(reg['classes'][t], '_help', '')}")
        return "\n".join(out) + "\n"
    cls = get_class(base_key, tid)
    out.append(f"{tid} — {getattr(cls, '_help', '')}")
    for f in class_fields(cls):
        d = "REQUIRED" if f.req else (f"default={f.default!r}" if f.default is not None
                                      else "optional")
        out.append(f"  --{f.name:<24s} [{f.type_str():<12s}] ({d}) {f.help}")
    return "\n".join(out) + "\n"


# -- the universal mode base --------------------------------------------------------

@register_base("mode", tid_vn="mode")
class Mode:
    """Base for all CLI subcommands (ref has_main_t, src/has_main.H:13)."""

    boda_output_dir = Field(str, default=".", help="directory for output files")

    def main(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def out_path(self, fn: str) -> str:
        os.makedirs(self.boda_output_dir, exist_ok=True)
        return os.path.join(self.boda_output_dir, fn)
