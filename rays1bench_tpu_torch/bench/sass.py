"""Instruction counts of the port's compiled kernels, read from their SASS.

    python -m rays1bench_tpu_torch.bench.sass [--parent DIR]

Builds the kernels (kernels/build.py), disassembles each library with
`cuobjdump -sass`, and prints for each kernel its instruction total, the
distinct opcodes of its shared atomics (ATOMS.ADD... is a native add,
ATOMS.CAST.SPIN a compare-and-swap loop) and, for every loop (a branch back
to an earlier address, with the instructions from its target to it), the
loop's length and its counts of FP32 adds and multiplies (FADD, FMUL),
fused multiply-adds (FFMA), special-function ops (MUFU), scalar shared
loads (LDS, LDS.64), 128-bit shared loads (LDS.128), shared atomics
(ATOMS), local-memory stores and loads (STL, LDL: a per-thread array or a
spill) and branches (BRA). The closest-hit sweep is the loop with one
LDS.128 per unrolled sphere in the respawn kernel (the interleaved
float4 {cx, cy, cz, radius_sq} rows, in the respawn, one-shot and index
kernels), and with four LDS per sphere in the phase kernel. The full
listings go beside the libraries, as <library>.sass.

--parent DIR (a parent's kernels/csrc, unpacked with git archive) builds
the parent's sources with the same flags and prints, for each kernel,
whether its instructions equal the parent's, function by function in
order (the functions' names hold a hash of the source path). Needs the
CUDA toolkit.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import tempfile

from rays1bench_tpu_torch.kernels import build

CLASSES = ("FADD", "FMUL", "FFMA", "MUFU", "LDS", "LDS.128", "ATOMS", "STL",
           "LDL", "BRA")
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


def op_class(op: str):
    """The CLASSES entry an opcode counts under, or None."""
    base = op.split(".")[0]
    if base == "LDS" and ".128" in op:
        return "LDS.128"
    return base if base in CLASSES else None


def loops(instrs):
    """[(start, end, Counter of opcode classes, length)] for each backward
    branch."""
    out = []
    for addr, op, args in instrs:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            body = [o for a, o, _ in instrs if lo <= a <= addr]
            count = collections.Counter(op_class(o) for o in body)
            out.append((lo, addr, count, len(body)))
    return out


def disassemble(lib):
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def same_as_parent(text, parent_dir, source):
    """Whether the functions of `text` (cuobjdump -sass of a tree's library)
    have the instructions of parent_dir/source built with the same flags,
    in order; None where the parent has no such source."""
    src = os.path.join(parent_dir, source)
    if not os.path.exists(src):
        return None
    with tempfile.TemporaryDirectory() as d:
        lib = os.path.join(d, "parent.so")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                       capture_output=True, text=True, check=True)
        parent = disassemble(lib)
    body = lambda t: [[(a, o, x) for a, o, x in f]
                      for f in parse(t).values()]
    return body(parent) == body(text)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a directory holding a parent's "
                    "kernels/csrc, to compare each kernel's SASS with")
    args = ap.parse_args(argv)
    for (name, source), lib in zip(build.KERNELS, build.build_all()):
        text = disassemble(lib)
        lib.with_suffix(".sass").write_text(text)
        if args.parent:
            same = same_as_parent(text, args.parent, source)
            print(f"[sass] {name}: instructions "
                  + {None: "(no parent source)", True: "equal to the "
                     "parent's", False: "differ from the parent's"}[same],
                  flush=True)
        for func, instrs in parse(text).items():
            atoms = collections.Counter(o for _, o, _ in instrs
                                        if o.startswith("ATOMS"))
            print(f"[sass] {lib.name} {func}: {len(instrs)} instructions"
                  + (f"; shared atomics {dict(atoms)}" if atoms else ""),
                  flush=True)
            for lo, hi, count, n in loops(instrs):
                counts = " ".join(f"{c} {count[c]}" for c in CLASSES)
                print(f"[sass]   loop {lo:#06x}-{hi:#06x}: {n} instructions, "
                      f"{counts}", flush=True)


if __name__ == "__main__":
    main()
