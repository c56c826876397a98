"""Count the instructions of a kernel's hottest loop in its SASS, as the
card runs it: the loop (a backward branch and its target) with the most
instructions of its own, outside the loops nested in it; those
instructions by opcode, and their count over the elements one lane
handles in an iteration (instructions an element).

    python -m ggml_cuda_experiments_tpu_torch.tools.sass_loop \\
        --kernel q80_matvec_kernel --elements 128 [--lib PATH | --sass FILE]

``--lib`` is a built kernel library (default: this checkout's, built if
missing), read with ``cuobjdump -sass``; ``--sass`` a saved dump. Every
function whose name holds ``--kernel`` is counted (a template's instances
one by one). The body is counted statically: a branch taken only at a
tile's end, or to refill a ring, counts as if it ran every iteration.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def functions(sass: str) -> dict:
    """{name: [(address, opcode, operands)]} of a ``cuobjdump -sass`` dump."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def hottest_loop(insns: list) -> tuple[int, int, list]:
    """(head, tail, body): of the loops (a backward branch from tail to
    head), the one with the most instructions of its own, and those
    instructions (the loops nested in it left out)."""
    loops = []
    for addr, op, args in insns:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    best = (0, 0, [])
    for head, tail in loops:
        inner = [(h, t) for h, t in loops
                 if head <= h and t <= tail and (h, t) != (head, tail)]
        own = [i for i in insns if head <= i[0] <= tail
               and not any(h <= i[0] <= t for h, t in inner)]
        if len(own) > len(best[2]):
            best = (head, tail, own)
    return best


def report(sass: str, kernel: str, elements: int) -> list:
    rows = []
    for name, insns in functions(sass).items():
        if kernel not in name:
            continue
        head, tail, body = hottest_loop(insns)
        ops = collections.Counter(op.split(".")[0] for _, op, _ in body)
        rows.append({"function": name, "instructions": len(insns),
                     "loop": [hex(head), hex(tail)], "body": len(body),
                     "elements": elements,
                     "per_element": len(body) / elements,
                     "by_opcode": dict(ops.most_common())})
        print(f"{name}: {len(insns)} instructions; loop {hex(head)}-"
              f"{hex(tail)}: {len(body)} instructions for {elements} "
              f"elements a lane = {len(body) / elements:.2f} an element")
        print("  " + ", ".join(f"{k} {v}" for k, v in ops.most_common()))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True,
                    help="substring of the function name")
    ap.add_argument("--elements", type=int, required=True,
                    help="elements a lane handles in one iteration")
    ap.add_argument("--lib", default=None)
    ap.add_argument("--sass", default=None, help="a saved cuobjdump dump")
    args = ap.parse_args(argv)
    if args.sass:
        sass = Path(args.sass).read_text()
    else:
        if args.lib is None:
            from ggml_cuda_experiments_tpu_torch.ops import _build
            args.lib = str(_build.build())
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([tool, "-sass", args.lib], capture_output=True,
                              text=True, check=True).stdout
    rows = report(sass, args.kernel, args.elements)
    if not rows:
        print(f"no function holds {args.kernel!r}", file=sys.stderr)
        return 1
    print(json.dumps({"sass_loop": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
