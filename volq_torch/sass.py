"""Static instruction counts of the port's built kernels, from their SASS.

    python3 -m volq_torch.sass warp_march [--match TEXT] [--json PATH]

Builds the named kernel source if needed (``_build.load``), disassembles
the library with ``cuobjdump -sass`` and prints, for every kernel function
whose demangled name contains ``--match``: its instruction count, its
registers and local (spill) bytes (``cuobjdump -res-usage``), and each loop
-- a backward branch and the code it jumps back over -- with its
instruction count, nested loops included, and that count by instruction
class (shared / global loads and stores, fp32 arithmetic, conversions,
special functions, integer, compares and selects, barriers, branches, the
asynchronous copies -- cp.async, TMA, mbarriers -- and the tensor-core
products, mma.sync's HMMA and wgmma's HGMMA), and the whole function's
count by class.  A loop body's count is static: code that a forward branch
skips is counted too.  A backward branch need not close a loop (code laid
out after the function's exit may jump back to where it was called from),
so each function also gets its cycles: the strongly connected parts of its
control-flow graph, the instructions that can run more than once in one
run of it.  Needs the CUDA toolkit (``cuobjdump``), not a card.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

CLASSES = (
    ("lds", ("LDS", "LDSM")),
    ("sts", ("STS",)),
    ("ldg", ("LDG", "LD", "LDC", "LDL")),
    ("stg", ("STG", "ST", "STL", "RED", "ATOM", "ATOMG", "ATOMS")),
    ("cp_async", ("LDGSTS", "LDGDEPBAR", "DEPBAR")),
    ("tma", ("UTMALDG", "UTMASTG", "UTMAPF", "UBLKCP")),
    ("mbarrier", ("SYNCS",)),
    ("mma", ("HMMA", "HGMMA", "WARPGROUP")),
    ("fp32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSET", "FSWZADD")),
    ("convert", ("F2F", "F2FP", "F2I", "I2F", "FRND", "I2FP", "F2IP")),
    ("mufu", ("MUFU",)),
    ("int", ("IADD3", "IMAD", "LEA", "SHF", "LOP3", "IABS", "IMNMX",
             "VIMNMX", "FLO", "POPC", "BREV", "PRMT", "SGXT", "IMUL",
             "LEA.HI", "UIADD3", "UIMAD", "ULEA", "USHF", "ULOP3")),
    ("compare", ("ISETP", "FSETP", "PLOP3", "SEL", "FSEL", "P2R", "R2P",
                 "UISETP", "USEL", "VOTE", "VOTEU")),
    ("move", ("MOV", "UMOV", "S2R", "S2UR", "CS2R", "R2UR", "SHFL",
              "IMAD.MOV")),
    ("barrier", ("BAR", "MEMBAR", "WARPSYNC", "BSSY", "BSYNC", "NANOSLEEP")),
    ("branch", ("BRA", "BRX", "EXIT", "RET", "CALL", "JMP")),
)
_CLASS = {op: name for name, ops in CLASSES for op in ops}

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                   r"([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_\w+):")
_TARGET = re.compile(r"(0x[0-9a-f]+|`?\(?(\.L_\w+)\)?`?)\s*$")


def classify(op: str) -> str:
    """An opcode's class, by its longest dotted prefix that has one."""
    parts = op.split(".")
    for n in range(len(parts), 0, -1):
        cls = _CLASS.get(".".join(parts[:n]))
        if cls:
            return cls
    return "other"


def parse(text: str) -> dict:
    """``cuobjdump -sass`` text -> {mangled name: [(addr, opcode, operands,
    label or None, guard or None)]}, the label being one that starts at
    that address and the guard the predicate (``@P0``, ``@!UP1``) the
    instruction runs under."""
    funcs, cur, pending = {}, None, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            pending = None
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending = m.group(1)
            continue
        m = _INSN.match(line)
        if m:
            guard = m.group(2).strip() if m.group(2) else None
            cur.append((int(m.group(1), 16), m.group(3), m.group(4).strip(),
                        pending, guard))
            pending = None
    return funcs


def loops(insns) -> list:
    """Loops of one function: each backward branch (``BRA`` to an address
    or label before it; not the branch to itself that pads a function's
    end) gives [start index, end index]."""
    out = []
    for i, (_, op, args, _, _) in enumerate(insns):
        if op.split(".")[0] != "BRA":
            continue
        j = _target(insns, args)
        if j is not None and j < i:
            out.append((j, i))
    return sorted(set(out))


def _target(insns, args):
    """Index of the instruction that a branch's operands ``args`` name, or
    None."""
    m = _TARGET.search(args)
    if not m:
        return None
    if m.group(2):
        return next((i for i, ins in enumerate(insns)
                     if ins[3] == m.group(2)), None)
    a = int(m.group(1), 16)
    return next((i for i, ins in enumerate(insns) if ins[0] == a), None)


def successors(insns) -> list:
    """The control-flow graph of one function, an instruction a node:
    [indices that may run next] for each instruction.  A branch goes to
    its target, and on to the next instruction too unless it is a bare
    ``BRA target`` (no guard, no condition operand); ``CALL`` to its
    target and on; an unguarded ``EXIT`` or ``RET`` ends; an indirect
    branch (``BRX``, ``JMX``) may go to any labelled instruction."""
    labelled = [i for i, ins in enumerate(insns) if ins[3]]
    out = []
    for i, (_, op, args, _, guard) in enumerate(insns):
        head = op.split(".")[0]
        nxt = [i + 1] if i + 1 < len(insns) else []
        if head in ("BRA", "CALL", "JMP"):
            j = _target(insns, args)
            bare = (head != "CALL" and guard is None and "," not in args
                    and j is not None)
            out.append(([j] if j is not None else []) + ([] if bare else nxt))
        elif head in ("BRX", "JMX"):
            out.append(labelled + nxt)
        elif head in ("EXIT", "RET"):
            out.append(nxt if guard else [])
        else:
            out.append(nxt)
    return out


def cycles(insns) -> list:
    """The instructions that can run more than once in one run of the
    function: the strongly connected components of ``successors``' graph,
    reachable from its first instruction, that hold a cycle.  Each a sorted
    list of indices; the components in the order of their first one."""
    succ = successors(insns)
    index, low, on, stack, comps = {}, {}, set(), [], []
    for root in (0,) if insns else ():
        work = [(root, 0)]
        index[root] = low[root] = 0
        stack.append(root)
        on.add(root)
        while work:                      # Tarjan's, without recursion
            v, k = work.pop()
            if k < len(succ[v]):
                work.append((v, k + 1))
                w = succ[v][k]
                if w not in index:
                    index[w] = low[w] = len(index)
                    stack.append(w)
                    on.add(w)
                    work.append((w, 0))
                elif w in on:
                    low[v] = min(low[v], index[w])
                continue
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1 or v in succ[v]:
                    comps.append(sorted(comp))
    return sorted(comps)


def summary(insns) -> dict:
    """Instruction count, counts by class and by opcode (its first dotted
    part), and loops (with theirs) of one function."""
    recs = []
    spans = loops(insns)
    for j, i in spans:
        body = insns[j:i + 1]
        depth = sum(1 for a, b in spans if a <= j and i <= b) - 1
        recs.append({"start": insns[j][0], "end": insns[i][0],
                     "insns": len(body), "depth": depth, **_counts(body)})
    cyc = [{"first": insns[c[0]][0], "last": insns[c[-1]][0],
            "insns": len(c), **_counts([insns[k] for k in c])}
           for c in cycles(insns)]
    return {"insns": len(insns), **_counts(insns), "loops": recs,
            "cycles": cyc}


def _counts(insns) -> dict:
    """Counts of ``insns`` by class and by opcode (its first dotted part)."""
    classes: dict[str, int] = {}
    ops: dict[str, int] = {}
    for _, op, _, _, _ in insns:
        c, o = classify(op), op.split(".")[0]
        classes[c] = classes.get(c, 0) + 1
        ops[o] = ops.get(o, 0) + 1
    return {"classes": dict(sorted(classes.items())),
            "opcodes": dict(sorted(ops.items()))}


def demangle(names) -> dict:
    """Mangled -> demangled names (c++filt where present)."""
    names = list(names)
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    if not filt or not names:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("cuobjdump not found (CUDA toolkit needed)")


def resources(lib: Path) -> dict:
    """{mangled name: {"REG": n, "LOCAL": bytes, "SHARED": bytes, ...}}."""
    text = subprocess.run([_cuobjdump(), "-res-usage", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function\s+(\S+?):?\s*$", line)
        if m:
            cur = m.group(1)
            continue
        if cur and "REG:" in line:
            out[cur] = {k: int(v) for k, v in
                        re.findall(r"([A-Z]+):(\d+)", line)}
            cur = None
    return out


def analyse(name: str, match: str = "") -> list:
    """Build kernel source ``name`` if needed and summarise its kernel
    functions whose demangled name contains ``match``."""
    from volq_torch import _build
    _build.load(name)
    lib = _build._lib_path(name)
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs = parse(text)
    dem = demangle(funcs)
    res = resources(lib)
    out = []
    for mangled, insns in funcs.items():
        if match not in dem[mangled]:
            continue
        out.append({"function": dem[mangled], "mangled": mangled,
                    "resources": res.get(mangled, {}), **summary(insns)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", help="kernel source under csrc/, e.g. "
                    "warp_march")
    ap.add_argument("--match", default="", help="only functions whose "
                    "demangled name contains this")
    ap.add_argument("--json", help="also write the records here")
    a = ap.parse_args(argv)
    recs = analyse(a.source, a.match)
    for r in recs:
        rs = r["resources"]
        print(f"[sass] {r['function']}: {r['insns']} instructions, "
              f"{rs.get('REG', '?')} registers, local {rs.get('LOCAL', '?')}"
              f" B")
        print("[sass]   all: " + " ".join(
            f"{k} {v}" for k, v in r["classes"].items()))
        for lp in r["loops"]:
            print(f"[sass]   loop {lp['start']:#06x}-{lp['end']:#06x} depth "
                  f"{lp['depth']}: {lp['insns']} instructions "
                  + " ".join(f"{k} {v}" for k, v in lp["classes"].items()))
        for cy in r["cycles"]:
            print(f"[sass]   cycle {cy['first']:#06x}..{cy['last']:#06x}: "
                  f"{cy['insns']} instructions "
                  + " ".join(f"{k} {v}" for k, v in cy["classes"].items()))
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        Path(a.json).write_text(json.dumps(recs, indent=1))
    return 0 if recs else 1


if __name__ == "__main__":
    sys.exit(main())
