"""Collective-payload audit of compiled sharded programs.

The multi-host scaling argument (BASELINE.json: >= 0.7 efficiency 1 -> 4
hosts) rests on the per-solve collective volume staying small relative to
NVLink/network bandwidth. This module extracts every cross-device collective from a
compiled XLA program's HLO and reports its payload size, so the dryrun can
PRINT the numbers instead of asserting them by argument (VERDICT r3 weak #4
/ next-round item 4).

Usage:
    lowered = jax.jit(f).lower(*args)
    compiled = lowered.compile()
    for rec in collective_payloads(compiled):
        print(rec)
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["collective_payloads", "summarize_collectives"]

_COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                   "all-to-all", "collective-permute")

# `%all-reduce.31 = (f32[29000]{0}, ...) all-reduce(` or
# `%ag = bf16[8,128]{1,0} all-gather(`
_LINE_RE = re.compile(
    r"=\s*(\(?)([a-z0-9\[\],{}\s\/#_.:()-]*?)\s*"
    r"(" + "|".join(_COLLECTIVE_OPS) + r")(-start|-done)?\(")
_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}


def _shape_bytes(shape_txt: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_txt):
        nbytes = _DTYPE_BYTES.get(dt)
        if nbytes is None:
            continue
        n = 1
        if dims:
            n = int(np.prod([int(x) for x in dims.split(",") if x]))
        total += n * nbytes
    return total


def collective_payloads(compiled) -> list[dict]:
    """[{op, count, bytes}] per collective opcode in the compiled HLO.

    `bytes` is the summed payload (result-shape bytes) over every instance
    of that opcode; `-start/-done` async pairs are counted once (on start).
    """
    txt = compiled.as_text()
    agg: dict[str, dict] = {}
    for line in txt.splitlines():
        m = _LINE_RE.search(line)
        if not m:
            continue
        shape_txt, op, phase = m.group(2), m.group(3), m.group(4)
        if phase == "-done":
            continue
        b = _shape_bytes(shape_txt)
        rec = agg.setdefault(op, {"op": op, "count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += b
    return sorted(agg.values(), key=lambda r: -r["bytes"])


def summarize_collectives(compiled, label: str) -> str:
    """One-line audit. Payloads are PER STATIC HLO INSTRUCTION — an
    instruction inside a while body (e.g. one CG iteration's psum) executes
    once per iteration, so per-solve volume = payload x iteration count."""
    recs = collective_payloads(compiled)
    if not recs:
        return f"{label}: no cross-device collectives"
    parts = [f"{r['op']} x{r['count']} = {r['bytes'] / 1e3:.1f} kB"
             for r in recs]
    total = sum(r["bytes"] for r in recs)
    return (f"{label}: {', '.join(parts)} "
            f"(total {total / 1e3:.1f} kB per static instance)")
