"""Instruction counts of the port's compiled kernels, read from their SASS.

    python -m rays1bench_tpu_torch.bench.sass [--parent DIR]

Builds the kernels (kernels/build.py), disassembles each library with
`cuobjdump -sass`, and prints for each kernel its instruction total, its
registers and stack frame (from ptxas's report beside the library), the
distinct opcodes of its shared atomics (ATOMS.ADD... is a native add,
ATOMS.CAST.SPIN a compare-and-swap loop) and, for every loop (a branch back
to an earlier address, with the instructions from its target to it), the
loop's length and its counts of FP32 adds and multiplies (FADD, FMUL),
fused multiply-adds (FFMA), special-function ops (MUFU), scalar shared
loads (LDS, LDS.64), 128-bit shared loads (LDS.128), shared atomics
(ATOMS), local-memory stores and loads (STL, LDL: a per-thread array or a
spill), warp votes (VOTE: a flat loop's refill), reconvergence barriers
(BSYNC) and branches (BRA). Then, for each
closest-hit sweep (a loop with one LDS.128 per unrolled sphere, the
interleaved float4 {cx, cy, cz, radius_sq} rows of every kernel), the
instructions of each sphere test on its miss path (from its LDS.128 to the
next, taking every forward branch that lands inside that span: the skip
around the root) and the loops around the sweep: a flat loop has one, a
loop nest whose bounce loop closes with a BSYNC more. The full listings go
beside the libraries, as <library>.sass.

--parent DIR (a parent's kernels/csrc, unpacked with git archive) builds
the parent's sources with the same flags and prints, for each function of
the parent's library, the tree's function with the same instructions (the
functions' names hold a hash of the source path, and a template flag the
parent lacked, such as kIters, renames them), or, where none has them, a
tree function whose loops have the same instructions (addresses aside)
and the two instruction totals. Needs the CUDA toolkit.
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
           "LDL", "VOTE", "BSYNC", "BRA")
SWEEP_UNROLL = 8  # r1b::kSweepUnroll: LDS.128 in a sweep loop's body
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
        lo = target(args)
        if op.startswith("BRA") and lo is not None and lo < addr:
            body = [o for a, o, _ in instrs if lo <= a <= addr]
            count = collections.Counter(op_class(o) for o in body)
            out.append((lo, addr, count, len(body)))
    return out


def target(args):
    """A branch's target address, or None."""
    m = re.search(r"0x([0-9a-f]+)", args)
    return int(m.group(1), 16) if m else None


def sweeps(instrs, found):
    """[(start, end, [instructions of each sphere test on the miss path],
    [loops around the sweep])] for each innermost loop of `found` (loops())
    with SWEEP_UNROLL LDS.128 in its body."""
    out = []
    for lo, hi, count, _ in found:
        inner = any(lo <= a and b <= hi and (a, b) != (lo, hi)
                    for a, b, _, _ in found)
        if count["LDS.128"] != SWEEP_UNROLL or inner:
            continue
        body = [(a, o, x) for a, o, x in instrs if lo <= a <= hi]
        loads = [i for i, (_, o, _) in enumerate(body)
                 if op_class(o) == "LDS.128"]
        tests = []
        for k, i in enumerate(loads):
            stop = loads[k + 1] if k + 1 < len(loads) else len(body)
            stop_addr = body[stop][0] if stop < len(body) else hi + 1
            steps, j = 0, i
            while j < stop:
                a, o, x = body[j]
                steps += 1
                to = target(x) if o.startswith("BRA") else None
                if to is not None and a < to <= stop_addr:
                    j = next(n for n, (b, _, _) in enumerate(body) if b >= to)
                else:
                    j += 1
            tests.append(steps)
        around = [loop for loop in found if loop[0] <= lo and loop[1] >= hi
                  and (loop[0], loop[1]) != (lo, hi)]
        out.append((lo, hi, tests, around))
    return out


def ptxas_report(text):
    """{function: (registers, stack frame bytes)} from ptxas -v output."""
    out, cur, stack = {}, None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur, stack = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            stack = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), stack)
            cur = None
    return out


def disassemble(lib):
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def loop_bodies(instrs):
    """The instructions of each loop (loops()), branch addresses stripped."""
    strip = lambda x: re.sub(r"0x[0-9a-f]+", "", x)
    return [[(o, strip(x)) for a, o, x in instrs if lo <= a <= hi]
            for lo, hi, _, _ in loops(instrs)]


def parent_matches(text, parent_dir, source):
    """For each function of parent_dir/source built with the tree's flags:
    (its instruction count, the tree function of `text` with the same
    instructions or None, and failing that a tree function whose loops
    have the same instructions, with its count, or None). None where the
    parent has no such source."""
    src = os.path.join(parent_dir, source)
    if not os.path.exists(src):
        return None
    with tempfile.TemporaryDirectory() as d:
        lib = os.path.join(d, "parent.so")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                       capture_output=True, text=True, check=True)
        parent = parse(disassemble(lib))
    tree = parse(text)
    out = {}
    for pf, pins in parent.items():
        same = next((tf for tf, tins in tree.items() if tins == pins), None)
        loops_same = None if same else next(
            ((tf, len(tins)) for tf, tins in tree.items()
             if loops(tins) and loop_bodies(tins) == loop_bodies(pins)),
            None)
        out[pf] = (len(pins), same, loops_same)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a directory holding a parent's "
                    "kernels/csrc, to compare each kernel's SASS with")
    args = ap.parse_args(argv)
    for (name, source), lib in zip(build.KERNELS, build.build_all()):
        text = disassemble(lib)
        lib.with_suffix(".sass").write_text(text)
        if args.parent:
            matches = parent_matches(text, args.parent, source)
            if matches is None:
                print(f"[sass] {name}: no parent source", flush=True)
            for pf, (n, same, loops_same) in (matches or {}).items():
                if same:
                    what = f"instructions equal to the tree's {same}"
                elif loops_same:
                    what = (f"loops' instructions equal to the tree's "
                            f"{loops_same[0]} ({n} instructions against "
                            f"{loops_same[1]})")
                else:
                    what = "no tree function with its instructions or loops"
                print(f"[sass] {name}: parent {pf}: {what}", flush=True)
        log = lib.with_suffix(".log")
        ptxas = ptxas_report(log.read_text()) if log.exists() else {}
        for func, instrs in parse(text).items():
            atoms = collections.Counter(o for _, o, _ in instrs
                                        if o.startswith("ATOMS"))
            regs, stack = ptxas.get(func, ("?", "?"))
            print(f"[sass] {lib.name} {func}: {len(instrs)} instructions; "
                  f"{regs} registers, stack {stack} B"
                  + (f"; shared atomics {dict(atoms)}" if atoms else ""),
                  flush=True)
            found = loops(instrs)
            for lo, hi, count, n in found:
                counts = " ".join(f"{c} {count[c]}" for c in CLASSES)
                print(f"[sass]   loop {lo:#06x}-{hi:#06x}: {n} instructions, "
                      f"{counts}", flush=True)
            for lo, hi, tests, around in sweeps(instrs, found):
                outer = "; ".join(
                    f"{a:#06x}-{b:#06x} ({n} instructions, VOTE "
                    f"{c['VOTE']}, BSYNC {c['BSYNC']}, STL {c['STL']}, LDL "
                    f"{c['LDL']})"
                    for a, b, c, n in around)
                print(f"[sass]   sweep {lo:#06x}-{hi:#06x}: a sphere test on "
                      f"the miss path {' '.join(map(str, tests))} "
                      f"instructions, one LDS.128 each; {len(around)} "
                      f"loop(s) around it: {outer or 'none'}", flush=True)


if __name__ == "__main__":
    main()
