"""MCA-style parameter registry.

TPU-native re-design of PaRSEC's OpenMPI-style Modular Component Architecture
parameter system (reference: parsec/utils/mca_param.c, parsec/utils/mca_param.h).
Any component registers named, typed, documented parameters; values are resolved
with the same priority order as the reference (mca_param.c lookup chain):

    1. explicit programmatic set (``set``)            [highest]
    2. command line ``--mca <name> <value>`` (``parse_cmdline``)
    3. environment variable ``PARSEC_MCA_<name>``
    4. parameter file (``read_paramfile``)            (ref: mca_parse_paramfile.c)
    5. registered default                             [lowest]

``help_text()`` renders auto-generated help like ``--parsec-help``
(ref: parsec/utils/help-mca-param.txt machinery).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

_ENV_PREFIX = "PARSEC_MCA_"


@dataclass
class _Param:
    name: str
    default: Any
    type: type
    help: str
    component: str = ""
    read_only: bool = False
    # value layers, priority descending
    explicit: Any = None
    has_explicit: bool = False
    cmdline: Any = None
    has_cmdline: bool = False
    filevalue: Any = None
    has_filevalue: bool = False
    on_change: List[Callable[[Any], None]] = field(default_factory=list)

    def resolve(self) -> Any:
        if self.has_explicit:
            return self.explicit
        if self.has_cmdline:
            return self.cmdline
        env = os.environ.get(_ENV_PREFIX + self.name)
        if env is not None:
            return _coerce(env, self.type)
        if self.has_filevalue:
            return self.filevalue
        return self.default


def _coerce(value: Any, ty: type) -> Any:
    if ty is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if ty is int:
        return int(value)
    if ty is float:
        return float(value)
    return value


class ParamRegistry:
    """Process-wide MCA parameter registry (ref: mca_param.c globals)."""

    def __init__(self) -> None:
        self._params: Dict[str, _Param] = {}
        self._lock = threading.Lock()

    def register(
        self,
        name: str,
        default: Any,
        help: str = "",
        type: Optional[type] = None,
        component: str = "",
        read_only: bool = False,
    ) -> str:
        """Register a parameter; idempotent (same name keeps first registration).

        Mirrors parsec_mca_param_reg_int_name / _reg_string_name
        (parsec/utils/mca_param.h).
        """
        with self._lock:
            if name in self._params:
                return name
            ty = type if type is not None else (default.__class__ if default is not None else str)
            self._params[name] = _Param(
                name=name, default=default, type=ty, help=help,
                component=component, read_only=read_only,
            )
            return name

    def get(self, name: str, default: Any = None) -> Any:
        p = self._params.get(name)
        if p is None:
            return default
        return p.resolve()

    def set(self, name: str, value: Any) -> None:
        p = self._require(name)
        if p.read_only:
            raise ValueError(f"MCA parameter {name!r} is read-only")
        p.explicit = _coerce(value, p.type)
        p.has_explicit = True
        for cb in p.on_change:
            cb(p.explicit)

    def unset(self, name: str) -> None:
        p = self._require(name)
        p.has_explicit = False

    def is_default(self, name: str) -> bool:
        """True when no layer (set()/cmdline/env/paramfile) overrides the
        registered default — lets components pick transport-aware defaults
        while user choices always win."""
        p = self._params.get(name)
        if p is None:
            return True
        return not (p.has_explicit or p.has_cmdline or p.has_filevalue
                    or os.environ.get(_ENV_PREFIX + name) is not None)

    def on_change(self, name: str, cb: Callable[[Any], None]) -> None:
        self._require(name).on_change.append(cb)

    def _require(self, name: str) -> _Param:
        if name not in self._params:
            # auto-register untyped, like the reference's lazy env lookup
            self.register(name, None, type=str)
        return self._params[name]

    def parse_cmdline(self, argv: List[str]) -> List[str]:
        """Consume ``--mca <name> <value>`` / ``--parsec-mca`` pairs, return the rest.

        Mirrors the command-line processing in parsec_init (parsec/parsec.c:433-500).
        """
        rest: List[str] = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a in ("--mca", "--parsec-mca") and i + 2 < len(argv) + 1:
                name, value = argv[i + 1], argv[i + 2]
                p = self._require(name)
                p.cmdline = _coerce(value, p.type if p.type is not type(None) else str)
                p.has_cmdline = True
                i += 3
            else:
                rest.append(a)
                i += 1
        return rest

    def read_paramfile(self, path: str) -> None:
        """``name = value`` per line, '#' comments (ref: mca_parse_paramfile.c / keyval_lex.l)."""
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                if "=" not in line:
                    continue
                name, value = (s.strip() for s in line.split("=", 1))
                p = self._require(name)
                p.filevalue = _coerce(value, p.type)
                p.has_filevalue = True

    def names(self) -> List[str]:
        return sorted(self._params)

    def help_text(self) -> str:
        lines = []
        for name in self.names():
            p = self._params[name]
            lines.append(f"--mca {name} <{p.type.__name__}>  (default: {p.default!r})")
            if p.help:
                lines.append(f"    {p.help}")
        return "\n".join(lines)


#: The process-wide registry (ref: mca_param.c static tables).
params = ParamRegistry()

register = params.register
get = params.get
set = params.set
unset = params.unset
is_default = params.is_default
parse_cmdline = params.parse_cmdline
