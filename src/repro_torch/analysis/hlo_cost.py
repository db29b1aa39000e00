"""HLO cost model over optimized HLO text.

Why this exists: ``compiled.cost_analysis()`` on the CPU (dry-run) backend
counts each while-loop BODY once, ignoring the trip count — a scanned
126-layer model reports ~1 layer of FLOPs.  The optimized HLO text carries
``backend_config={"known_trip_count":{"n":"126"}}`` on each while op, so we
walk the call graph ourselves and multiply.

What it produces (per-device, since the SPMD-partitioned module is
per-device):
  * flops            — 2*prod(result)*prod(contracted) per dot (+conv est.),
                       the standard MFU convention (elementwise excluded);
  * hbm_bytes        — post-fusion traffic model: every top-level
                       instruction reads its operands and writes its result
                       (fusions count only at their boundary); dynamic-slice
                       / dynamic-update-slice / gather count only the slice
                       actually touched (XLA performs them in place);
  * collective_bytes — per collective kind, result-shape bytes x trip
                       multiplier (async -start counted, -done skipped).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16, "token": 0, "opaque": 0,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_ARRAY_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _array_bytes(type_str: str) -> int:
    """Sum bytes over every array in a (possibly tuple) type string."""
    total = 0
    for m in _ARRAY_RE.finditer(type_str):
        dt = m.group(1)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if m.group(2):
            for d in m.group(2).split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _array_elems_first(type_str: str) -> list[tuple[str, list[int]]]:
    out = []
    for m in _ARRAY_RE.finditer(type_str):
        dims = [int(d) for d in m.group(2).split(",")] if m.group(2) else []
        out.append((m.group(1), dims))
    return out


@dataclass
class Instruction:
    name: str
    result_type: str
    op: str
    operands: list[str]
    raw: str
    attrs: str


@dataclass
class Computation:
    name: str
    instructions: list[Instruction] = field(default_factory=list)
    symbols: dict[str, str] = field(default_factory=dict)  # name -> type str


_COMP_HDR = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{\s*$")
_INSTR = re.compile(
    r"^\s*(ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^=]*?\)|[\w\[\],{}\/ ]+?))\s+"
    r"([\w\-]+)\((.*)$")
_OPERAND = re.compile(r"%([\w.\-]+)")
_TRIP = re.compile(r"known_trip_count[^0-9]*(\d+)")
_CALLS = re.compile(r"(?:calls|to_apply|body)=%?([\w.\-]+)")
_COND = re.compile(r"condition=%?([\w.\-]+)")
_BRANCHES = re.compile(r"branch_computations=\{([^}]*)\}")


def parse_module(text: str) -> tuple[dict[str, Computation], str]:
    comps: dict[str, Computation] = {}
    entry = ""
    cur: Computation | None = None
    comment = re.compile(r"/\*.*?\*/")
    for line in text.splitlines():
        line = comment.sub("", line)
        stripped = line.strip()
        if cur is None:
            m = _COMP_HDR.match(stripped)
            if m and "(" in stripped:
                cur = Computation(m.group(2))
                if m.group(1):
                    entry = m.group(2)
                continue
        else:
            if stripped == "}" or stripped.startswith("} "):
                comps[cur.name] = cur
                cur = None
                continue
            m = _INSTR.match(line)
            if m:
                _, name, rtype, op, rest = m.groups()
                rtype = rtype.strip()
                # operands = %refs inside the top-level parens; attrs after
                depth = 1
                args_end = len(rest)
                for i, ch in enumerate(rest):
                    if ch == "(":
                        depth += 1
                    elif ch == ")":
                        depth -= 1
                        if depth == 0:
                            args_end = i
                            break
                args = rest[:args_end]
                attrs = rest[args_end + 1:]
                operands = _OPERAND.findall(args)
                cur.instructions.append(
                    Instruction(name, rtype, op, operands, line, attrs))
                cur.symbols[name] = rtype
    return comps, entry


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    collective_counts: dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for k in COLLECTIVES:
            self.collective_bytes[k] += other.collective_bytes[k] * mult
            self.collective_counts[k] += other.collective_counts[k] * mult

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


_SKIP_BYTES = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "while", "conditional", "call", "after-all", "add-dependency",
    "partition-id", "replica-id", "iota", "reshape", "custom-call",
    "rng-bit-generator", "rng-get-and-update-state", "copy-start",
    "copy-done", "opt-barrier",
}


def _dot_flops(instr: Instruction, symbols: dict[str, str]) -> float:
    result = _array_elems_first(instr.result_type)
    if not result:
        return 0.0
    out_elems = 1
    for d in result[0][1]:
        out_elems *= d
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", instr.raw)
    if not m or not instr.operands:
        return 2.0 * out_elems  # degenerate
    lhs_type = symbols.get(instr.operands[0], "")
    lhs = _array_elems_first(lhs_type)
    contracted = 1
    if lhs:
        dims = lhs[0][1]
        for ci in m.group(1).split(","):
            if ci and int(ci) < len(dims):
                contracted *= dims[int(ci)]
    return 2.0 * out_elems * contracted


def _conv_flops(instr: Instruction, symbols: dict[str, str]) -> float:
    result = _array_elems_first(instr.result_type)
    if not result or len(instr.operands) < 2:
        return 0.0
    out_elems = 1
    for d in result[0][1]:
        out_elems *= d
    kernel = _array_elems_first(symbols.get(instr.operands[1], ""))
    k_elems = 1
    if kernel:
        for d in kernel[0][1]:
            k_elems *= d
        # per-output flops ~ 2 * kernel_elems / out_features (rough)
        if kernel[0][1]:
            k_elems //= max(kernel[0][1][-1], 1)
    return 2.0 * out_elems * max(k_elems, 1)


_PARAM_IDX = re.compile(r"parameter\((\d+)\)")

# pure dtype/layout plumbing: free inside a fusion on the TPU target (the
# CPU backend materializes f32 legalization copies around bf16 dots; a TPU
# compile fuses the conversion into the consumer)
_PASS_THROUGH = {"convert", "bitcast", "reshape", "copy", "reduce-precision"}


def _fusion_bytes(ins: Instruction, symbols: dict[str, str],
                  inner: "Computation") -> float:
    """HBM traffic of one fusion: each operand read once (sliced operands
    charged at slice size; in-place dynamic-update-slice targets charged
    zero), output written once (root DUS writes only the update).  Operand
    identity is resolved THROUGH convert/bitcast/reshape chains, so the CPU
    backend's bf16<->f32 legalization round-trips are not charged as
    full-buffer traffic (DESIGN.md hardware-adaptation note)."""
    # parameter index -> name inside the fused computation
    idx_to_name: dict[int, str] = {}
    by_name: dict[str, Instruction] = {}
    for fi in inner.instructions:
        by_name[fi.name] = fi
        if fi.op == "parameter":
            m = _PARAM_IDX.search(fi.raw)
            if m:
                idx_to_name[int(m.group(1))] = fi.name

    def resolve(name: str) -> str:
        """Follow pass-through ops up to the producing source."""
        seen = 0
        while name in by_name and by_name[name].op in _PASS_THROUGH \
                and by_name[name].operands and seen < 64:
            name = by_name[name].operands[0]
            seen += 1
        return name

    # usage map: source name -> consuming non-pass-through instructions
    uses: dict[str, list[Instruction]] = {}
    for fi in inner.instructions:
        if fi.op in _PASS_THROUGH or fi.op == "parameter":
            continue
        for o in fi.operands:
            src = resolve(o)
            uses.setdefault(src, []).append(fi)

    charged = 0.0
    for i, operand in enumerate(ins.operands):
        pname = idx_to_name.get(i)
        psize = _array_bytes(symbols.get(operand, ""))
        u = uses.get(pname, []) if pname else []
        if u and all(fi.op in ("dynamic-slice", "gather") for fi in u):
            charged += sum(min(_array_bytes(fi.result_type), psize) for fi in u)
        elif u and all(fi.op == "dynamic-update-slice" and fi.operands
                       and resolve(fi.operands[0]) == pname for fi in u):
            charged += 0.0  # in-place update target: aliased, not read
        else:
            charged += psize

    # output: resolve the ROOT through pass-through wrappers
    root = inner.instructions[-1] if inner.instructions else None
    if root is not None:
        rname = resolve(root.name)
        rins = by_name.get(rname)
        if rins is not None and rins.op == "dynamic-update-slice" \
                and len(rins.operands) > 1:
            charged += _array_bytes(inner.symbols.get(
                resolve(rins.operands[1]), inner.symbols.get(rins.operands[1], "")))
            return charged
    charged += _array_bytes(ins.result_type)
    return charged


def _instr_bytes(instr: Instruction, symbols: dict[str, str]) -> float:
    op = instr.op
    out_b = _array_bytes(instr.result_type)
    if op == "dynamic-slice":
        return 2.0 * out_b
    if op == "dynamic-update-slice":
        upd = _array_bytes(symbols.get(instr.operands[1], "")) if len(
            instr.operands) > 1 else 0
        return 2.0 * upd
    if op == "gather":
        idx = _array_bytes(symbols.get(instr.operands[1], "")) if len(
            instr.operands) > 1 else 0
        return 2.0 * out_b + idx
    if op == "scatter":
        upd = _array_bytes(symbols.get(instr.operands[-1], ""))
        return 3.0 * upd + out_b * 0  # read-modify-write of touched slices
    in_b = sum(_array_bytes(symbols.get(o, "")) for o in instr.operands)
    return in_b + out_b


def _src_itemsize(name: str, by_name: dict[str, Instruction],
                  comps: dict[str, Computation], depth: int = 0) -> int | None:
    """Itemsize of the ultimate data source of ``name``, following top-level
    convert/bitcast/reshape/copy chains and convert-only fusions (the CPU
    backend's f32 legalization of bf16 payloads — a TPU compile ships the
    narrow dtype on the wire)."""
    if depth > 16 or name not in by_name:
        return None
    ins = by_name[name]
    if ins.op in _PASS_THROUGH and ins.operands:
        return _src_itemsize(ins.operands[0], by_name, comps, depth + 1)
    if ins.op == "fusion":
        m = _CALLS.search(ins.raw)
        if m and m.group(1) in comps:
            inner = comps[m.group(1)]
            body_ops = {fi.op for fi in inner.instructions}
            if body_ops <= (_PASS_THROUGH | {"parameter"}):
                if ins.operands:
                    return _src_itemsize(ins.operands[0], by_name, comps,
                                         depth + 1)
    arrays = _array_elems_first(ins.result_type)
    if arrays:
        return _DTYPE_BYTES.get(arrays[0][0])
    return None


def _walk(comp: Computation, comps: dict[str, Computation], mult: float,
          acc: Cost, visited_stack: tuple = ()) -> None:
    if comp.name in visited_stack:  # defensive: no recursion in HLO anyway
        return
    by_name = {i.name: i for i in comp.instructions}
    for ins in comp.instructions:
        base = ins.op.replace("-start", "")
        if ins.op.endswith("-done"):
            continue
        if base in COLLECTIVES:
            b = _array_bytes(ins.result_type)
            # dtype-normalize: charge at the source payload's itemsize when
            # the operand is a legalization upcast of a narrower dtype
            arrays = _array_elems_first(ins.result_type)
            if arrays and ins.operands:
                res_item = _DTYPE_BYTES.get(arrays[0][0])
                src_item = _src_itemsize(ins.operands[0], by_name, comps)
                if res_item and src_item and src_item < res_item:
                    b = b * src_item / res_item
            acc.collective_bytes[base] += b * mult
            acc.collective_counts[base] += mult
            acc.hbm_bytes += 2.0 * b * mult  # payload read + write
            continue
        if ins.op == "while":
            trip = 1.0
            m = _TRIP.search(ins.raw)
            if m:
                trip = float(m.group(1))
            body = _CALLS.search(ins.attrs or ins.raw)
            if body and body.group(1) in comps:
                _walk(comps[body.group(1)], comps, mult * trip, acc,
                      (*visited_stack, comp.name))
            cond = _COND.search(ins.raw)
            if cond and cond.group(1) in comps:
                _walk(comps[cond.group(1)], comps, mult * trip, acc,
                      (*visited_stack, comp.name))
            continue
        if ins.op == "conditional":
            m = _BRANCHES.search(ins.raw)
            if m:
                for b in _OPERAND.findall(m.group(1)):
                    if b in comps:
                        _walk(comps[b], comps, mult, acc,
                              (*visited_stack, comp.name))
            continue
        if ins.op == "call":
            m = _CALLS.search(ins.raw)
            if m and m.group(1) in comps:
                _walk(comps[m.group(1)], comps, mult, acc,
                      (*visited_stack, comp.name))
            continue
        if ins.op == "fusion":
            m = _CALLS.search(ins.raw)
            if m and m.group(1) in comps:
                inner = comps[m.group(1)]
                for fi in inner.instructions:
                    if fi.op == "dot":
                        acc.flops += _dot_flops(fi, inner.symbols) * mult
                    elif fi.op == "convolution":
                        acc.flops += _conv_flops(fi, inner.symbols) * mult
                acc.hbm_bytes += _fusion_bytes(ins, comp.symbols, inner) * mult
            else:
                acc.hbm_bytes += _instr_bytes(ins, comp.symbols) * mult
            continue
        if ins.op == "dot":
            acc.flops += _dot_flops(ins, comp.symbols) * mult
            acc.hbm_bytes += _instr_bytes(ins, comp.symbols) * mult
            continue
        if ins.op == "convolution":
            acc.flops += _conv_flops(ins, comp.symbols) * mult
            acc.hbm_bytes += _instr_bytes(ins, comp.symbols) * mult
            continue
        if ins.op in _SKIP_BYTES:
            continue
        acc.hbm_bytes += _instr_bytes(ins, comp.symbols) * mult
    return


def xla_cost_analysis(compiled) -> dict:
    """Normalize ``Compiled.cost_analysis()`` across JAX versions: newer
    releases return the properties dict directly, 0.4.x wraps it in a
    one-element list (one entry per executable module)."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        return ca[0] if ca else {}
    return ca


def analyze_text(text: str) -> Cost:
    comps, entry = parse_module(text)
    acc = Cost()
    if entry and entry in comps:
        _walk(comps[entry], comps, 1.0, acc)
    return acc


def top_contributors(text: str, k: int = 12) -> list[tuple[float, float, str, str, str]]:
    """(bytes, mult, op, name, result_type) of the k largest HBM contributors
    — the §Perf diagnosis tool."""
    comps, entry = parse_module(text)
    tops: list[tuple[float, float, str, str, str]] = []

    def walk(comp: Computation, mult: float) -> None:
        for ins in comp.instructions:
            base = ins.op.replace("-start", "")
            if ins.op.endswith("-done"):
                continue
            if base in COLLECTIVES:
                b = 2.0 * _array_bytes(ins.result_type) * mult
                tops.append((b, mult, base, ins.name, ins.result_type[:60]))
                continue
            if ins.op == "while":
                m = _TRIP.search(ins.raw)
                trip = float(m.group(1)) if m else 1.0
                b = _CALLS.search(ins.attrs or ins.raw)
                if b and b.group(1) in comps:
                    walk(comps[b.group(1)], mult * trip)
                continue
            if ins.op in ("conditional", "call"):
                m = _CALLS.search(ins.raw)
                if m and m.group(1) in comps:
                    walk(comps[m.group(1)], mult)
                continue
            if ins.op == "fusion":
                m = _CALLS.search(ins.raw)
                if m and m.group(1) in comps:
                    b = _fusion_bytes(ins, comp.symbols, comps[m.group(1)]) * mult
                else:
                    b = _instr_bytes(ins, comp.symbols) * mult
                tops.append((b, mult, ins.op, ins.name, ins.result_type[:60]))
                continue
            if ins.op in _SKIP_BYTES:
                continue
            tops.append((_instr_bytes(ins, comp.symbols) * mult, mult, ins.op,
                         ins.name, ins.result_type[:60]))

    if entry in comps:
        walk(comps[entry], 1.0)
    tops.sort(key=lambda t: -t[0])
    return tops[:k]
