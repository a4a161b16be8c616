"""Instruction counts of the port's compiled kernels, read from their SASS.

    python -m rays1bench_tpu_torch.bench.sass

Builds the kernels (kernels/build.py), disassembles each library with
`cuobjdump -sass`, and prints for each kernel its instruction total and,
for every loop (a branch back to an earlier address, with the instructions
from its target to it), the loop's length and its counts of FP32 adds and
multiplies (FADD, FMUL), fused multiply-adds (FFMA), special-function ops
(MUFU), shared loads (LDS) and branches (BRA). The closest-hit sweep is the
loop with four LDS per unrolled sphere. The full listings go beside the
libraries, as <library>.sass. Needs the CUDA toolkit.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess

from rays1bench_tpu_torch.kernels import build

CLASSES = ("FADD", "FMUL", "FFMA", "MUFU", "LDS", "BRA")
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")


def parse(text):
    """{function: [(address, opcode, operands)]} from cuobjdump -sass."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def loops(instrs):
    """[(start, end, Counter of opcode classes, length)] for each backward
    branch."""
    out = []
    for addr, op, args in instrs:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            body = [o for a, o, _ in instrs if lo <= a <= addr]
            count = collections.Counter(
                c for o in body for c in CLASSES if o.split(".")[0] == c)
            out.append((lo, addr, count, len(body)))
    return out


def main():
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib in build.build_all():
        text = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        lib.with_suffix(".sass").write_text(text)
        for func, instrs in parse(text).items():
            print(f"[sass] {lib.name} {func}: {len(instrs)} instructions",
                  flush=True)
            for lo, hi, count, n in loops(instrs):
                counts = " ".join(f"{c} {count[c]}" for c in CLASSES)
                print(f"[sass]   loop {lo:#06x}-{hi:#06x}: {n} instructions, "
                      f"{counts}", flush=True)


if __name__ == "__main__":
    main()
