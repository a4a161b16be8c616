"""Results table generation (rays1bench_tpu/bench/report.py, copied: it
imports nothing of JAX, and the port keeps its own copy).

The analog of the reference's update_readme.py (reference:
update_readme.py:14-69): parse `version|time|rays|mrays/s|` records from
out_<scene>.txt files (the port's, the JAX package's and the reference's
share the format) and emit a markdown table with speedups relative to the
first row, bolding the last row, like the reference's README tables.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional


@dataclasses.dataclass
class Record:
    version: str
    seconds: float
    rays: int
    mrays: float


def parse_record(text: str) -> Record:
    """Parse one pipe-delimited record (common.h:64-76 format)."""
    parts = text.strip().split("|")
    return Record(
        version=parts[0],
        seconds=float(parts[1].rstrip("s")),
        rays=int(parts[2]),
        mrays=float(parts[3].split()[0]),
    )


def collect(dirs: List[str], scene: str) -> List[Record]:
    """Read out_<scene>.txt from each directory, in order (update_readme.py:14)."""
    records = []
    for d in dirs:
        path = os.path.join(d, f"out_{scene}.txt")
        if os.path.exists(path):
            with open(path) as f:
                records.append(parse_record(f.read()))
    return records


def markdown_table(records: List[Record], baseline: Optional[Record] = None) -> str:
    """Render the reference-style results table: version | time | total rays |
    mrays/s | speedup, speedup vs the first row (update_readme.py:25-44),
    last row bolded."""
    base = baseline or (records[0] if records else None)
    lines = ["| version | time | total rays | mrays/s | speedup |",
             "|---|---|---|---|---|"]
    for i, r in enumerate(records):
        bold = "**" if i == len(records) - 1 else ""
        speedup = r.mrays / base.mrays if base and base.mrays else 0.0
        lines.append(
            f"| {bold}{r.version}{bold} | {r.seconds:.3f} s | {r.rays:,} | "
            f"{bold}{r.mrays:.3f}{bold} | {speedup:.2f} |")
    return "\n".join(lines)


def render_template(template_path: str, out_path: str,
                    substitutions: dict) -> None:
    """Copy template -> out, replacing __PLACEHOLDER__ keys
    (update_readme.py:49-69)."""
    with open(template_path) as f:
        text = f.read()
    for key, value in substitutions.items():
        text = text.replace(key, value)
    with open(out_path, "w") as f:
        f.write(text)
