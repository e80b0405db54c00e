"""PTG source parser: a JDF-flavored task-graph language.

Plays the role of the reference's JDF front end (lexer parsec.l, grammar
parsec.y, AST jdf.h) re-imagined for a Python/PyTorch host language:
parameter ranges, affinity, guarded dataflow expressions, and per-device
bodies — but expressions are Python expressions and bodies are Python over
torch tensors, so a ``[type=CUDA]`` body's operations run on the card.

Source shape (one taskpool per file/string)::

    %global NT
    %global descA          // a data collection

    T(k)
      k = 0 .. NT-1        // inclusive range, like JDF
      : descA(k)           // affinity (owner-computes)
      priority = NT - k
      RW  X <- (k == 0) ? descA(k) : X T(k-1)
          ->  (k < NT-1) ? X T(k+1) : descA(k)
      READ Y <- descB(k)
      CTL c -> c T(k+1)
    BODY [type=CUDA]
      X = X + Y
    END

Guards use the JDF C-ternary form ``(cond) ? EP : EP`` or a plain guarded
endpoint ``(cond) ? EP``; conditions and index expressions are Python.
Endpoints: ``FLOW Class(exprs)`` (peer task), ``Collection(exprs)`` (memory),
``NEW`` (scratch), ``NULL``. Bodies end with ``END``; multiple BODY blocks
give per-device chores (ref: __parsec_chore_t incarnations). ``type=TPU``
is read as ``type=CUDA``, so sources written for the TPU runtime parse
unchanged.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

FLOW_READ = "READ"
FLOW_WRITE = "WRITE"
FLOW_RW = "RW"
FLOW_CTL = "CTL"

_ACCESS_KEYWORDS = {"READ": FLOW_READ, "WRITE": FLOW_WRITE, "RW": FLOW_RW,
                    "CTL": FLOW_CTL, "IN": FLOW_READ, "OUT": FLOW_WRITE,
                    "INOUT": FLOW_RW}

MAX_LOCAL_COUNT = 16   # mirrors the ptgpp negative test too_many_local_vars
MAX_FLOW_COUNT = 16    # mirrors too_many_write_flows-style limits


class PTGSyntaxError(SyntaxError):
    """Compile-time rejection, the analogue of parsec-ptgpp fatal errors."""

    def __init__(self, msg: str, line_no: int = 0, line: str = "") -> None:
        where = f" (line {line_no}: {line.strip()!r})" if line_no else ""
        super().__init__(msg + where)
        self.line_no = line_no


@dataclass
class Endpoint:
    """One side of a dep: a peer task flow, a memory reference, NEW or NULL."""
    kind: str                      # 'task' | 'memory' | 'new' | 'null'
    name: str = ""                 # task class or collection name
    flow: str = ""                 # peer flow name (task endpoints)
    index_exprs: List[str] = field(default_factory=list)


@dataclass
class DepSpec:
    direction: str                 # 'in' | 'out'
    guard: Optional[str] = None    # python expression or None
    endpoint: Optional[Endpoint] = None
    else_endpoint: Optional[Endpoint] = None   # ternary alternative
    line_no: int = 0
    dtt: Optional[str] = None          # [type = NAME] named datatype
    dtt_remote: Optional[str] = None   # [type_remote = NAME] wire-only


@dataclass
class FlowSpec:
    name: str
    access: str
    deps: List[DepSpec] = field(default_factory=list)


@dataclass
class RangeSpec:
    param: str
    lo_expr: str
    hi_expr: str                  # inclusive, like JDF
    step_expr: str = "1"


@dataclass
class BodySpec:
    device: str = "CPU"           # CPU | CUDA
    source: str = ""
    line_no: int = 0
    evaluate: Optional[str] = None   # [evaluate = fn]: chore gate, resolved
                                     # from taskpool globals


@dataclass
class TaskClassSpec:
    name: str
    params: List[str]
    #: header property block ``NAME(m, n) [ make_key_fn = f ... ]``
    #: (ref: udf.jdf make_key_fn/startup_fn/time_estimate properties)
    header_props: Dict[str, str] = field(default_factory=dict)
    ranges: List[RangeSpec] = field(default_factory=list)
    affinity: Optional[Endpoint] = None
    priority_expr: Optional[str] = None
    properties: Dict[str, str] = field(default_factory=dict)
    flows: List[FlowSpec] = field(default_factory=list)
    bodies: List[BodySpec] = field(default_factory=list)

    def flow(self, name: str) -> Optional[FlowSpec]:
        for f in self.flows:
            if f.name == name:
                return f
        return None


@dataclass
class ProgramSpec:
    globals: List[str] = field(default_factory=list)
    task_classes: List[TaskClassSpec] = field(default_factory=list)
    name: str = "ptg"
    #: host-language prologue executed into program globals at instantiate
    #: time (the JDF inline-C escape 'extern "C" %{...%}', jdf2c.c:54)
    prologue: str = ""

    def task_class(self, name: str) -> Optional[TaskClassSpec]:
        for tc in self.task_classes:
            if tc.name == name:
                return tc
        return None


_RE_GLOBAL = re.compile(r"^%global\s+(\w+)\s*$")
_RE_OPTION = re.compile(r"^%option\s+(\w+)\s*=\s*(\S+)\s*$")
_RE_HEADER = re.compile(r"^(\w+)\s*\(\s*([\w\s,]*)\)\s*(?:\[([^\]]*)\])?\s*$")
_RE_RANGE = re.compile(r"^(\w+)\s*=\s*(.+?)\s*\.\.\s*(.+?)(?:\s*\.\.\s*(.+?))?\s*$")
_RE_AFFINITY = re.compile(r"^:\s*(\w+)\s*\(([^)]*)\)\s*$")
_RE_PROPERTY = re.compile(r"^(\w+)\s*=\s*(.+)$")
_RE_BODY = re.compile(r"^BODY(?:\s*\[([^\]]*)\])?\s*$")


def _strip_comment(line: str) -> str:
    # '//' comments, but not inside strings (bodies handled separately)
    idx = line.find("//")
    return line[:idx] if idx >= 0 else line


def _match_call(text: str) -> Optional[Tuple[str, str]]:
    """``NAME(exprs)`` with BALANCED parens -> (name, inner) or None.
    The old regex form ``\\(([^)]*)\\)`` broke on nested parentheses in
    index expressions (e.g. ``T(((a*i+b) % N), 0)``); endpoints accept
    the same nesting the expression splitter already does."""
    m = re.match(r"^(\w+)\s*\(", text)
    if not m:
        return None
    depth, start = 0, m.end() - 1
    for i in range(start, len(text)):
        if text[i] == "(":
            depth += 1
        elif text[i] == ")":
            depth -= 1
            if depth == 0:
                if text[i + 1:].strip():
                    return None          # trailing junk after the call
                return m.group(1), text[start + 1:i]
    return None                          # unbalanced


def _parse_endpoint(text: str, line_no: int, line: str) -> Endpoint:
    text = text.strip()
    if text == "NEW":
        return Endpoint("new")
    if text == "NULL":
        return Endpoint("null")
    parts = text.split(None, 1)
    if len(parts) == 2 and re.fullmatch(r"\w+", parts[0]):
        call = _match_call(parts[1])
        if call is not None:
            # "X T(k-1)" — flow then class
            return Endpoint("task", name=call[0], flow=parts[0],
                            index_exprs=_split_exprs(call[1]))
    call = _match_call(text)
    if call is not None:
        return Endpoint("memory", name=call[0],
                        index_exprs=_split_exprs(call[1]))
    raise PTGSyntaxError(f"cannot parse dependency endpoint {text!r}",
                         line_no, line)


def _split_exprs(text: str) -> List[str]:
    """Split comma-separated expressions, respecting nested parens."""
    out, depth, cur = [], 0, []
    for ch in text:
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
            continue
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


_RE_DEP_ATTRS = re.compile(r"\[([^\]]*)\]\s*$")
_RE_DEP_ATTR = re.compile(r"(\w+)\s*=\s*(\w+)")


def _parse_attr_block(body: str, allowed, what: str, line_no: int,
                      line: str) -> Dict[str, str]:
    """Shared '[key = NAME ...]' attribute grammar (deps, BODY, task
    headers). Malformed blocks and unknown keys are parse errors — a
    silently-dropped attribute is wrong results later."""
    if not re.fullmatch(r"(?:\s*\w+\s*=\s*\w+\s*)*", body):
        raise PTGSyntaxError(
            f"malformed {what} attribute block [{body}] "
            f"(expected 'key = NAME' pairs)", line_no, line)
    pairs = _RE_DEP_ATTR.findall(body)
    attrs: Dict[str, str] = {}
    for k, v in pairs:
        if k not in allowed:
            raise PTGSyntaxError(f"unknown {what} attribute {k!r}",
                                 line_no, line)
        if k in attrs and attrs[k] != v:
            raise PTGSyntaxError(
                f"conflicting {what} attribute {k!r}: "
                f"{attrs[k]!r} vs {v!r}", line_no, line)
        attrs[k] = v
    return attrs


def _parse_dep(direction: str, text: str, line_no: int, line: str) -> DepSpec:
    """Parse '(guard) ? EP : EP' | '(guard) ? EP' | 'EP', with an optional
    trailing attribute block '[type = NAME type_data = NAME]' (the JDF dep
    datatype annotations, ref: jdf.h datatype properties)."""
    text = text.strip()
    dep = DepSpec(direction=direction, line_no=line_no)
    am = _RE_DEP_ATTRS.search(text)
    if am:
        text = text[:am.start()].strip()
        attrs = _parse_attr_block(am.group(1),
                                  ("type", "type_data", "type_remote"),
                                  "dep", line_no, line)
        t, td = attrs.get("type"), attrs.get("type_data")
        if t is not None and td is not None and t != td:
            raise PTGSyntaxError(
                f"conflicting type/type_data {t!r} vs {td!r}", line_no, line)
        dep.dtt = t if t is not None else td
        dep.dtt_remote = attrs.get("type_remote")
    if "?" in text:
        qpos = _top_level_find(text, "?")
        if qpos < 0:
            raise PTGSyntaxError("malformed ternary guard", line_no, line)
        guard = text[:qpos].strip()
        if guard.startswith("(") and guard.endswith(")"):
            guard = guard[1:-1]
        rest = text[qpos + 1:]
        cpos = _top_level_find(rest, ":")
        dep.guard = guard
        if cpos >= 0:
            dep.endpoint = _parse_endpoint(rest[:cpos], line_no, line)
            dep.else_endpoint = _parse_endpoint(rest[cpos + 1:], line_no, line)
        else:
            dep.endpoint = _parse_endpoint(rest, line_no, line)
    else:
        dep.endpoint = _parse_endpoint(text, line_no, line)
    if direction == "out":
        # NEW/NULL are input-only, in ANY branch of a guarded dep (ref:
        # ptgpp errors, tests/dsl/ptg/ptgpp/output_{NULL,NEW}[_true,_false])
        for ep in (dep.endpoint, dep.else_endpoint):
            if ep is None:
                continue
            if ep.kind == "null":
                raise PTGSyntaxError(
                    "NULL data only supported in IN dependencies",
                    line_no, line)
            if ep.kind == "new":
                raise PTGSyntaxError(
                    "Automatic data allocation with NEW only supported "
                    "in IN dependencies", line_no, line)
    return dep


def _top_level_find(text: str, ch: str) -> int:
    depth = 0
    for i, c in enumerate(text):
        if c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
        elif c == ch and depth == 0:
            return i
    return -1


def parse(source: str, name: str = "ptg") -> ProgramSpec:
    """Parse PTG source into a :class:`ProgramSpec` (the jdf.h AST role)."""
    prog = ProgramSpec(name=name)
    lines = source.splitlines()
    i = 0
    cur: Optional[TaskClassSpec] = None
    cur_flow: Optional[FlowSpec] = None

    def err(msg: str) -> PTGSyntaxError:
        return PTGSyntaxError(msg, i + 1, lines[i] if i < len(lines) else "")

    while i < len(lines):
        raw = lines[i]
        line = _strip_comment(raw).strip()
        if not line:
            i += 1
            continue
        if line in ("%{", "%prologue"):
            # '%{ ... %}' / '%prologue ... %}': host-language helper block,
            # executed into program globals when the taskpool instantiates
            # (the reference JDF's inline-C prologue, jdf2c.c:54) — a .jdf-
            # style file can carry its own helper functions and constants
            block: List[str] = []
            i += 1
            while i < len(lines) and lines[i].strip() != "%}":
                block.append(lines[i])
                i += 1
            if i >= len(lines):
                raise err("unterminated %{ prologue block (missing %})")
            prog.prologue += "\n".join(block) + "\n"
            i += 1
            continue
        m = _RE_GLOBAL.match(line)
        if m:
            prog.globals.append(m.group(1))
            i += 1
            continue
        m = _RE_OPTION.match(line)
        if m:
            if m.group(1) == "name":
                prog.name = m.group(2)
            i += 1
            continue
        m = _RE_BODY.match(line)
        if m:
            if cur is None:
                raise err("BODY outside a task class")
            device, evaluate = "CPU", None
            if m.group(1):
                attrs = _parse_attr_block(m.group(1), ("type", "evaluate"),
                                          "BODY", i + 1, raw)
                device = attrs.get("type", "CPU").upper()
                evaluate = attrs.get("evaluate")
            if device == "TPU":
                device = "CUDA"     # the accelerator body of TPU sources
            if device not in ("CPU", "CUDA"):
                raise err(f"unknown body device type {device!r}")
            body_lines: List[str] = []
            i += 1
            start = i
            while i < len(lines) and lines[i].strip() != "END":
                body_lines.append(lines[i])
                i += 1
            if i >= len(lines):
                raise err("BODY without END")
            cur.bodies.append(BodySpec(device=device,
                                       source="\n".join(body_lines),
                                       line_no=start, evaluate=evaluate))
            cur_flow = None
            i += 1
            continue
        # dep continuation lines: "<- ..." / "-> ..."
        if line.startswith("<-") or line.startswith("->"):
            if cur_flow is None:
                raise err("dependency line outside a flow declaration")
            direction = "in" if line.startswith("<-") else "out"
            cur_flow.deps.append(_parse_dep(direction, line[2:], i + 1, raw))
            i += 1
            continue
        # flow declaration: "RW X <- ... " (first dep may be inline)
        first_word = line.split(None, 1)[0].upper()
        if first_word in _ACCESS_KEYWORDS and cur is not None:
            rest = line.split(None, 1)[1] if " " in line else ""
            fm = re.match(r"^(\w+)\s*(.*)$", rest)
            if not fm:
                raise err("malformed flow declaration")
            fname = fm.group(1)
            if cur.flow(fname) is not None:
                raise err(f"duplicate flow {fname!r} in task class {cur.name}")
            if len(cur.flows) >= MAX_FLOW_COUNT:
                raise err(f"too many flows in task class {cur.name} "
                          f"(max {MAX_FLOW_COUNT})")
            cur_flow = FlowSpec(fname, _ACCESS_KEYWORDS[first_word])
            cur.flows.append(cur_flow)
            tail = fm.group(2).strip()
            if tail:
                if not (tail.startswith("<-") or tail.startswith("->")):
                    raise err("expected '<-' or '->' after flow name")
                direction = "in" if tail.startswith("<-") else "out"
                cur_flow.deps.append(_parse_dep(direction, tail[2:], i + 1, raw))
            i += 1
            continue
        m = _RE_AFFINITY.match(line)
        if m and cur is not None:
            cur.affinity = Endpoint("memory", name=m.group(1),
                                    index_exprs=_split_exprs(m.group(2)))
            i += 1
            continue
        m = _RE_RANGE.match(line)
        if m and cur is not None and m.group(1) in cur.params:
            step = m.group(4) if m.group(4) else "1"
            cur.ranges.append(RangeSpec(m.group(1), m.group(2), m.group(3), step))
            i += 1
            continue
        m = _RE_HEADER.match(line)
        if m and (cur is None or cur.bodies or not cur.params or True):
            # a new task class header, optionally with a property block
            # (ref: udf.jdf '[ make_key_fn = ud_make_key ]')
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            if len(params) != len(set(params)):
                raise err(f"duplicate parameter names in {m.group(1)}")
            if len(params) > MAX_LOCAL_COUNT:
                raise err(f"too many task parameters (max {MAX_LOCAL_COUNT})")
            props: Dict[str, str] = {}
            if m.group(3):
                props = _parse_attr_block(
                    m.group(3), ("make_key_fn", "startup_fn", "time_estimate"),
                    "task-class", i + 1, raw)
            cur = TaskClassSpec(name=m.group(1), params=params,
                                header_props=props)
            prog.task_classes.append(cur)
            cur_flow = None
            i += 1
            continue
        m = _RE_PROPERTY.match(line)
        if m and cur is not None:
            if m.group(1) == "priority":
                cur.priority_expr = m.group(2).strip()
            else:
                cur.properties[m.group(1)] = m.group(2).strip()
            i += 1
            continue
        raise err(f"cannot parse line: {line!r}")

    _validate(prog)
    return prog


def _validate(prog: ProgramSpec) -> None:
    """Compile-time sanity checks (the ptgpp negative-test battery role)."""
    if not prog.task_classes:
        raise PTGSyntaxError("no task classes defined")
    names = [tc.name for tc in prog.task_classes]
    if len(names) != len(set(names)):
        raise PTGSyntaxError(f"duplicate task class names: {names}")
    for tc in prog.task_classes:
        if not tc.bodies:
            raise PTGSyntaxError(f"task class {tc.name} has no BODY")
        ranged = {r.param for r in tc.ranges}
        missing = [p for p in tc.params if p not in ranged]
        if missing:
            raise PTGSyntaxError(
                f"task class {tc.name}: parameters {missing} have no range")
        for f in tc.flows:
            # WRITE-only flows are scratch outputs (ref: write_check.jdf's
            # "WRITE A1 -> ..." — allocated at run time, body fills them);
            # READ/RW flows must name where their data comes from
            if f.access not in (FLOW_CTL, FLOW_WRITE) and \
                    not any(d.direction == "in" for d in f.deps):
                raise PTGSyntaxError(
                    f"task class {tc.name}: data flow {f.name!r} has no input dep")
            for d in f.deps:
                for ep in (d.endpoint, d.else_endpoint):
                    if ep is None or ep.kind != "task":
                        continue
                    peer = prog.task_class(ep.name)
                    if peer is None:
                        raise PTGSyntaxError(
                            f"{tc.name}.{f.name}: unknown task class {ep.name!r}",
                            d.line_no)
                    pf = peer.flow(ep.flow)
                    if pf is None:
                        raise PTGSyntaxError(
                            f"{tc.name}.{f.name}: task class {ep.name} has no "
                            f"flow {ep.flow!r}", d.line_no)
                    if len(ep.index_exprs) != len(peer.params):
                        raise PTGSyntaxError(
                            f"{tc.name}.{f.name}: {ep.name} takes "
                            f"{len(peer.params)} params, got "
                            f"{len(ep.index_exprs)}", d.line_no)
