#!/usr/bin/env python3
"""What the walk kernels K1/K4 (``csrc/traverse.cu``) and K5/K6
(``csrc/traverse_shared.cu``), which share the walk of ``csrc/walk.cuh``,
compile to: the SASS instruction counts of each kernel's loop.

    python3 walk_sass.py [--out DIR]

Builds the kernel library from this checkout's ``raytracebvh_tpu_torch/
csrc`` (as the wrappers do at first use), disassembles it with the
toolkit's ``cuobjdump -sass`` and counts the instructions of each walk
kernel's loop: the node step (box test, link choice, loop control) and the
triangle block (the Moeller-Trumbore test a step runs at a leaf whose box
it hits) apart, with the opcodes of the node step; ptxas' register and
spill lines come from the build log.  The listings go to ``--out``
(default ``build/walk_sass``).  Nothing runs on the GPU, but ``nvcc`` and
``cuobjdump`` must be there: it exits non-zero without them.  To count
another commit's kernels, run this file from a checkout of that commit.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

WALK_KERNELS = ("traverse_kernel", "traverse_shared_kernel")


# ----------------------------------------------------------------- SASS --

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"(0x[0-9a-f]+)|\(?(\.L_x_\d+)\)?\s*$")


def sass_functions(text):
    """name -> [(address, predicate, opcode, operands, target)] of each
    function in a ``cuobjdump -sass`` listing; ``target`` is the address a
    BRA or CALL goes to (labels resolved), else None."""
    funcs, name, insns, labels = {}, None, [], {}
    pending = []
    for line in text.splitlines():
        if "Function :" in line:
            if name is not None:
                funcs[name] = _resolve(insns, labels)
            name = line.split(":", 1)[1].strip()
            insns, labels, pending = [], {}, []
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if not m or name is None:
            continue
        addr = int(m.group(1), 16)
        for label in pending:
            labels[label] = addr
        pending = []
        text_ = m.group(2).strip()
        pred = ""
        if text_.startswith("@"):
            pred, text_ = text_.split(None, 1)
        op, _, rest = text_.partition(" ")
        insns.append((addr, pred, op, rest.strip()))
    if name is not None:
        funcs[name] = _resolve(insns, labels)
    return funcs


def _resolve(insns, labels):
    out = []
    for addr, pred, op, rest in insns:
        target = None
        if op.startswith(("BRA", "CALL")):
            m = _TARGET.search(rest)
            if m:
                target = (int(m.group(1), 16) if m.group(1)
                          else labels.get(m.group(2)))
        out.append((addr, pred, op, rest, target))
    return out


def _is_wide_load(op):
    return op.startswith(("LDG", "LDS", "LD.")) and ".128" in op


def walk_loop_counts(insns):
    """Instruction counts of a walk kernel's loop (NOPs left out): the loop
    is the smallest backward branch's range that holds the node record's
    two 128-bit loads and the triangle's two (its third load is the one
    float it uses); the triangle block is the largest range a forward
    branch inside it skips that holds the MUFU.RCP of 1 / det.  Returns a
    dict, or None where no such loop is found."""
    idx = {a: i for i, (a, *_r) in enumerate(insns)}
    loops = []
    for i, (addr, pred, op, rest, target) in enumerate(insns):
        if op.startswith("BRA") and target is not None and target <= addr:
            lo = idx.get(target)
            if lo is None:
                continue
            body = insns[lo:i + 1]
            if sum(_is_wide_load(x[2]) for x in body) >= 4:
                loops.append((lo, i))
    if not loops:
        return None
    lo, hi = min(loops, key=lambda r: r[1] - r[0])
    body = [x for x in insns[lo:hi + 1] if not x[2].startswith("NOP")]
    rcp = [i for i in range(lo, hi + 1) if insns[i][2].startswith("MUFU.RCP")]
    tri = None
    for i in range(lo, hi + 1):
        addr, pred, op, rest, target = insns[i]
        if not (op.startswith("BRA") and pred and target is not None
                and target > addr):
            continue
        j = idx.get(target)
        if j is None or j > hi + 1 or not rcp or not i < rcp[0] < j:
            continue
        if tri is None or j - i > tri[1] - tri[0]:
            tri = (i + 1, j)
    tri_insns = [x for x in insns[tri[0]:tri[1]]
                 if not x[2].startswith("NOP")] if tri else []
    tri_addrs = {x[0] for x in tri_insns}
    node = [x for x in body if x[0] not in tri_addrs]
    ops = collections.Counter(x[2].split(".")[0] for x in node)
    calls = [x for x in tri_insns if x[2].startswith("CALL")]
    return dict(loop=len(body), node_step=len(node),
                triangle_block=len(tri_insns),
                triangle_loads=sum(_is_wide_load(x[2]) for x in tri_insns),
                calls_in_triangle_block=len(calls),
                fmnmx=sum(x[2].startswith("FMNMX") for x in node),
                fsetp=ops["FSETP"], fsel=ops["FSEL"], branches=ops["BRA"],
                node_opcodes=dict(ops.most_common()),
                first=insns[lo][0], last=insns[hi][0])


def sass_report(lib_path, out_dir):
    """Print ptxas' lines and the loop counts of each walk kernel in the
    library at ``lib_path``; write its listings under ``out_dir``."""
    from raytracebvh_tpu_torch import _kernels

    cuobjdump = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "kernels.sass").write_text(text)
    log = Path(lib_path).with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(log):
        if ("Compiling entry function" in line
                and any(k in line for k in WALK_KERNELS)):
            print(f"  ptxas: {line.strip()}")
            for nxt in log[i + 1:i + 4]:
                if "registers" in nxt or "spill" in nxt:
                    print(f"  ptxas:   {nxt.strip()}")
    for name, insns in sorted(sass_functions(text).items()):
        if not any(k in name for k in WALK_KERNELS):
            continue
        m = re.search(r"(traverse(?:_shared)?_kernel)ILb([01])E", name)
        any_hit = "true" if m.group(2) == "1" else "false"
        short = f"{m.group(1)}<{any_hit}>"
        path = out_dir / f"{m.group(1)}_{any_hit}.sass"
        path.write_text("\n".join(
            f"{a:06x} {p:6s} {op} {rest}"
            + (f"  -> {t:06x}" if t is not None else "")
            for a, p, op, rest, t in insns) + "\n")
        c = walk_loop_counts(insns)
        print(f"  {short}: {len(insns)} instructions; "
              + ("no walk loop found" if c is None else
                 f"loop {c['loop']} (0x{c['first']:x}-0x{c['last']:x}): node "
                 f"step {c['node_step']}, triangle block "
                 f"{c['triangle_block']} "
                 f"({c['triangle_loads']} 128-bit loads, "
                 f"{c['calls_in_triangle_block']} calls); node step FMNMX "
                 f"{c['fmnmx']}, FSETP {c['fsetp']}, FSEL {c['fsel']}, BRA "
                 f"{c['branches']}; opcodes {c['node_opcodes']}")
              + f" -> {path}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/walk_sass",
                   help="where the listings go")
    args = p.parse_args(argv)
    from raytracebvh_tpu_torch import _kernels

    try:
        path = _kernels.build()
    except RuntimeError as e:
        print(f"walk_sass: {e}", file=sys.stderr)
        return 2
    sass_report(path, Path(args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
