"""Compiled-HLO dependence analysis: proves the ring/EP overlap story
without multi-chip hardware.

The claim under test (`distributed/ring.py`): per-step communication
(`ppermute` of the visiting target shard, EP `all-to-all` routing) can
overlap the per-shard fold compute. XLA's latency-hiding scheduler
turns a collective into an async `collective-permute-start`/`-done` pair
and hoists independent compute between them — but ONLY when the def-use
graph allows it: the collective must neither consume the fold's outputs
nor feed its inputs within the same loop iteration. That graph property
is hardware-independent and visible in the virtual-mesh (CPU) compiled
HLO, where the same loop body carries a synchronous `collective-permute`
(the CPU backend does no async scheduling — verified empirically: 0
start/done pairs in CPU HLO).

So the test we CAN run everywhere is structural: parse the compiled loop
body, build the operand graph, and assert the collectives are
schedule-independent of the heavy compute (dot/sort/gather/reduce/fusion
ops). If a refactor ever threads the fold's result into the permuted
carry (serializing the ring), this fails.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence, Set

# opcodes that carry the real work in an optimized module; everything
# else (tuples, copies, broadcasts, parameters…) is bookkeeping
COMPUTE_OPCODES = (
    "fusion",
    "dot",
    "sort",
    "gather",
    "scatter",
    "reduce",
    "convolution",
)

COLLECTIVE_OPCODES = (
    "collective-permute",
    "all-to-all",
    "all-gather",
    "all-reduce",
    "reduce-scatter",
)


@dataclasses.dataclass
class HloOp:
    name: str
    opcode: str
    operands: List[str]


_OP_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")


def _split_opcode(rest: str) -> tuple:
    """From `f32[8]{0} add(%a, %b), meta` or `(f32[2], s32[]) tuple(...)`
    extract (opcode, operand_text)."""
    rest = rest.strip()
    i = 0
    if rest.startswith("("):
        # tuple-shaped result type: skip the balanced parens
        depth = 0
        for i, ch in enumerate(rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    i += 1
                    break
        rest = rest[i:].strip()
    else:
        # scalar/array type is the first whitespace-free token
        sp = rest.find(" ")
        if sp < 0:
            return "", ""
        rest = rest[sp + 1 :].strip()
    par = rest.find("(")
    if par < 0:
        return rest, ""
    opcode = rest[:par].strip()
    # operand list = balanced-paren region right after the opcode
    depth = 0
    end = par
    for j in range(par, len(rest)):
        if rest[j] == "(":
            depth += 1
        elif rest[j] == ")":
            depth -= 1
            if depth == 0:
                end = j
                break
    return opcode, rest[par + 1 : end]


def parse_computations(hlo_text: str) -> Dict[str, List[HloOp]]:
    """Parse an HLO module's computations into op lists (operand names
    only — attribute references like `to_apply=` are excluded)."""
    comps: Dict[str, List[HloOp]] = {}
    cur: List[HloOp] | None = None
    cur_name = None
    for line in hlo_text.splitlines():
        stripped = line.strip()
        # computation headers (`%name (params) -> type {`) never contain
        # ` = `; op lines always do. `/*index=5*/` comments mean a bare
        # `=` check would misclassify wide-tuple headers.
        if stripped.endswith("{") and " = " not in stripped.split("{")[0]:
            header = stripped[:-1].strip()
            # `%fused_computation.1 (param_0: f32[8]) -> f32[8] {`;
            # the entry computation prefixes an ENTRY keyword —
            # `ENTRY %main.42 (...) -> ... {` — skip it so the row
            # carries the real computation name (review r5)
            if header.startswith("ENTRY"):
                header = header[len("ENTRY"):].strip()
            m = re.match(r"%?([\w.\-]+)", header)
            if m:
                cur_name = m.group(1)
                cur = []
                comps[cur_name] = cur
            continue
        if stripped == "}":
            cur = None
            continue
        if cur is None:
            continue
        m = _OP_RE.match(line)
        if not m:
            continue
        name, rest = m.group(1), m.group(2)
        opcode, operand_text = _split_opcode(rest)
        if not opcode:
            continue
        operands = re.findall(r"%([\w.\-]+)", operand_text)
        cur.append(HloOp(name=name, opcode=opcode, operands=operands))
    return comps


def _reachable(ops: List[HloOp], roots: Set[str], forward: bool) -> Set[str]:
    """Transitive closure over the operand graph. forward=False walks
    ancestors (operands), True walks descendants (users)."""
    by_name = {o.name: o for o in ops}
    users: Dict[str, Set[str]] = {o.name: set() for o in ops}
    for o in ops:
        for src in o.operands:
            if src in users:
                users[src].add(o.name)
    seen: Set[str] = set()
    frontier = list(roots)
    while frontier:
        cur = frontier.pop()
        if cur in seen or cur not in by_name:
            continue
        seen.add(cur)
        nxt = users[cur] if forward else set(by_name[cur].operands)
        frontier.extend(nxt - seen)
    return seen


@dataclasses.dataclass
class OverlapReport:
    computation: str
    collective: str  # op name
    opcode: str
    n_compute_ops: int  # heavy ops in the same computation
    n_independent: int  # heavy ops neither feeding nor fed by it
    compute_ancestors: int  # heavy ops the collective depends on
    compute_descendants: int  # heavy ops depending on the collective

    @property
    def overlappable(self) -> bool:
        """True when a scheduler may run the collective concurrently with
        at least one heavy compute op, and the collective does not wait
        on any heavy compute (it can be issued at iteration start)."""
        return self.n_independent > 0 and self.compute_ancestors == 0


def overlap_reports(
    hlo_text: str,
    collective_opcodes: Sequence[str] = ("collective-permute", "all-to-all"),
) -> List[OverlapReport]:
    """One report per collective op found anywhere in the module."""
    out = []
    for comp_name, ops in parse_computations(hlo_text).items():
        compute = {o.name for o in ops if o.opcode in COMPUTE_OPCODES}
        if not compute:
            continue
        for o in ops:
            if not any(o.opcode.startswith(c) for c in collective_opcodes):
                continue
            anc = _reachable(ops, {o.name}, forward=False) - {o.name}
            dec = _reachable(ops, {o.name}, forward=True) - {o.name}
            out.append(
                OverlapReport(
                    computation=comp_name,
                    collective=o.name,
                    opcode=o.opcode,
                    n_compute_ops=len(compute),
                    n_independent=len(compute - anc - dec),
                    compute_ancestors=len(compute & anc),
                    compute_descendants=len(compute & dec),
                )
            )
    return out


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_COLL_LINE_RE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s+"
    r"(collective-permute|all-to-all|all-reduce|all-gather|reduce-scatter)"
    r"[\w.\-]*\("
)


def shape_bytes(type_text: str) -> int:
    """Total bytes of an HLO result type: `f32[8,16]{1,0}` or a tuple
    `(f32[2]{0}, s32[4]{0})`. Unknown dtypes contribute zero."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", type_text):
        dt = _DTYPE_BYTES.get(m.group(1))
        if dt is None:
            continue
        n = 1
        for d in m.group(2).split(","):
            if d:
                n *= int(d)
        total += n * dt
    return total


@dataclasses.dataclass
class CollectiveTraffic:
    computation: str
    opcode: str
    bytes: int  # per-device result bytes (shard_map HLO is per-device)


def collective_traffic(hlo_text: str) -> List[CollectiveTraffic]:
    """Every collective op in the module with its per-device result
    bytes — the auditable input to the multi-host scaling model
    (bytes per collective per iteration). Compile the program with max_iters=1 so
    loop-body collectives appear exactly once per modeled iteration."""
    rows: List[CollectiveTraffic] = []
    comp = None
    for line in hlo_text.splitlines():
        s = line.strip()
        if s.endswith("{") and " = " not in s.split("{")[0]:
            if s.startswith("ENTRY"):
                s = s[len("ENTRY"):].strip()
            m = re.match(r"%?([\w.\-]+)", s)
            comp = m.group(1) if m else comp
            continue
        m = _COLL_LINE_RE.search(line)
        if m:
            rows.append(
                CollectiveTraffic(
                    computation=comp or "",
                    opcode=m.group(2),
                    bytes=shape_bytes(m.group(1)),
                )
            )
    return rows


def assert_overlappable(hlo_text: str, collective_opcodes=None) -> List[OverlapReport]:
    """Assert every collective in the module is schedule-independent of
    heavy compute (see OverlapReport.overlappable); returns the reports."""
    kw = {}
    if collective_opcodes is not None:
        kw["collective_opcodes"] = collective_opcodes
    reports = overlap_reports(hlo_text, **kw)
    if not reports:
        raise AssertionError("no collectives found in HLO module")
    bad = [r for r in reports if not r.overlappable]
    if bad:
        lines = [
            f"{r.computation}/{r.collective} ({r.opcode}): "
            f"{r.compute_ancestors} compute ancestors, "
            f"{r.n_independent}/{r.n_compute_ops} independent"
            for r in bad
        ]
        raise AssertionError(
            "collective(s) serialized against compute:\n" + "\n".join(lines)
        )
    return reports
