"""Results report generator CLI (rays1bench_tpu/bench/report_cli.py).

    python -m rays1bench_tpu_torch.bench.report_cli --dirs DIR[,DIR...]
        [--scenes large,medium,small] [--no-reference] [--out FILE]
        [--template FILE] [--readme-template FILE --readme-out FILE]

The analog of the reference's update_readme.py: collect pipe-delimited
out_<scene>.txt records (the port's, the JAX package's, the reference's;
one format) and print per-scene tables with speedups, the reference's
published rows first. With --template the __RESULTS_*__ placeholders of a
prose template are filled instead, from --dirs alone (build_subs takes
the full-workload, gradient and scaling records as arguments).

Unlike the JAX CLI, it writes only where the caller points it: the JAX
defaults --out RESULTS.md and --readme-out README.md regenerate the repo's
own files from the TPU records, so here there is no default output file
(the text goes to stdout) and no default record directory.
"""

from __future__ import annotations

import argparse
import os

from rays1bench_tpu_torch.bench import report

# Published reference results (README.md:40-84; machine: i9 9900K 8c/16t,
# MSVC 2019; see BASELINE.md), the comparison rows.
REFERENCE_PUBLISHED = {
    "large": [
        report.Record("ref step1 (scalar)", 58.601, 25_236_618, 0.431),
        report.Record("ref step12 (AVX2)", 3.842, 25_241_334, 6.570),
        report.Record("ref step13 (16 threads)", 10.628, 630_931_100, 59.362),
    ],
    "medium": [
        report.Record("ref step1 (scalar)", 6.017, 23_083_633, 3.837),
        report.Record("ref step12 (AVX2)", 1.051, 23_087_117, 21.960),
        report.Record("ref step13 (16 threads)", 2.679, 577_132_771, 215.403),
    ],
    "small": [
        report.Record("ref step1 (scalar)", 0.973, 17_005_555, 17.483),
        report.Record("ref step12 (AVX2)", 0.501, 16_572_334, 33.057),
        report.Record("ref step13 (16 threads)", 1.289, 414_187_797, 321.238),
    ],
}

# The reference's published best at the full workload (step13 MT, 250 spp @
# 50 bounces): the full-workload tables lead with it.
REFERENCE_FULL = {
    "large": [report.Record("ref step13 (i9 9900K, 16 threads)", 10.628,
                            630_931_100, 59.362)],
    "medium": [report.Record("ref step13 (i9 9900K, 16 threads)", 2.679,
                             577_132_771, 215.403)],
    "small": [report.Record("ref step13 (i9 9900K, 16 threads)", 1.289,
                            414_187_797, 321.238)],
}

SCENE_LABELS = {"large": "large (484 spheres)", "medium": "medium (46 spheres)",
                "small": "small (5 spheres)"}


def scene_table(dirs, scene, include_reference=True) -> str:
    recs = list(REFERENCE_PUBLISHED.get(scene, [])) if include_reference else []
    recs += report.collect(dirs, scene)
    return report.markdown_table(recs) if recs else ""


def full_table(dirs, scene, include_reference=True) -> str:
    """Full-workload (250 spp @ 50 bounces) table: the reference's published
    step13 row first, then the records."""
    recs = list(REFERENCE_FULL.get(scene, [])) if include_reference else []
    recs += report.collect(dirs, scene)
    return report.markdown_table(recs) if recs else ""


def headline_table(dirs, scenes, label="These records") -> str:
    """One row per scene: the last record against the reference's published
    best. `label` names the records' column; the JAX CLI's names its TPU."""
    lines = [f"| Scene | {label} | Reference best "
             "(i9 9900K, 16 threads) | Ratio |", "|---|---|---|---|"]
    for scene in scenes:
        ours = report.collect(dirs, scene)
        ref = REFERENCE_FULL[scene][0]
        if not ours:
            continue
        r = ours[-1]
        lines.append(f"| {SCENE_LABELS.get(scene, scene)} | "
                     f"**{r.mrays:.1f} mrays/s** | {ref.mrays:.1f} | "
                     f"{r.mrays / ref.mrays:.2f}× |")
    return "\n".join(lines)


def scaling_table(path) -> str:
    """Scaling-sweep records (`label|devices|seconds|rays|mrays|eff|` one
    per line, written by bench/scaling.py --record) -> markdown."""
    if not path or not os.path.exists(path):
        return ""
    lines = ["| workload / engine | devices | mrays/s | efficiency |",
             "|---|---|---|---|"]
    with open(path) as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 6 or not parts[0]:
                continue
            try:
                mrays, eff = float(parts[4]), float(parts[5])
            except ValueError:
                continue
            lines.append(f"| {parts[0]} | {parts[1]} | {mrays:.2f}"
                         f" | {eff:.0%} |")
    return "\n".join(lines)


def grad_table(path) -> str:
    """Gradient-step records (`label|s_per_step|steps_per_sec|` one per
    line) -> markdown."""
    if not path or not os.path.exists(path):
        return ""
    lines = ["| workload | s/step | steps/s |", "|---|---|---|"]
    with open(path) as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 3 or not parts[0]:
                continue
            lines.append(f"| {parts[0]} | {float(parts[1].rstrip('s')):.4f} s"
                         f" | **{float(parts[2]):.1f}** |")
    return "\n".join(lines)


def generate(dirs, scenes, include_reference=True) -> str:
    lines = ["# Benchmark results", ""]
    for scene in scenes:
        table = scene_table(dirs, scene, include_reference)
        if not table:
            continue
        lines += [f"## {scene}", "", table, ""]
    return "\n".join(lines)


def build_subs(dirs, scenes, include_reference=True, full_dirs=None,
               grad_path=None, scaling_path=None,
               label="These records") -> dict:
    """Every template placeholder, from records only: __RESULTS_<SCENE>__,
    __RESULTS_FULL_<SCENE>__ (full_dirs, default dirs), __RESULTS_GRAD__,
    __RESULTS_SCALING__ and __RESULTS_HEADLINE_FULL__ (the last of
    full_dirs against the reference's published rows)."""
    full_dirs = list(full_dirs or dirs)
    subs = {f"__RESULTS_{s.upper()}__": scene_table(dirs, s,
                                                    include_reference)
            for s in scenes}
    for s in scenes:
        subs[f"__RESULTS_FULL_{s.upper()}__"] = full_table(
            full_dirs, s, include_reference)
    subs["__RESULTS_GRAD__"] = grad_table(grad_path)
    subs["__RESULTS_SCALING__"] = scaling_table(scaling_path)
    subs["__RESULTS_HEADLINE_FULL__"] = headline_table(full_dirs[-1:], scenes,
                                                       label)
    return subs


def generate_from_template(template_path, out_path, dirs, scenes,
                           include_reference=True, **kw) -> str:
    """Fill a template's __RESULTS_*__ placeholders into out_path (the
    reference's update_readme.py flow, update_readme.py:49-69)."""
    report.render_template(template_path, out_path,
                           build_subs(dirs, scenes, include_reference, **kw))
    with open(out_path) as f:
        return f.read()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rays1bench_tpu_torch.bench.report_cli")
    ap.add_argument("--dirs", required=True,
                    help="comma-separated dirs with out_<scene>.txt records")
    ap.add_argument("--scenes", default="large,medium,small")
    ap.add_argument("--no-reference", action="store_true",
                    help="omit the published reference rows")
    ap.add_argument("--out", default="",
                    help="also write the text here (default: stdout only)")
    ap.add_argument("--template", default="",
                    help="prose template with __RESULTS_*__ placeholders "
                         "(needs --out)")
    ap.add_argument("--readme-template", default="",
                    help="also fill this template into --readme-out")
    ap.add_argument("--readme-out", default="")
    args = ap.parse_args(argv)
    if args.template and not args.out:
        ap.error("--template needs --out")
    if bool(args.readme_template) != bool(args.readme_out):
        ap.error("--readme-template and --readme-out go together")
    dirs = args.dirs.split(",")
    scenes = args.scenes.split(",")
    include = not args.no_reference
    if args.template:
        text = generate_from_template(args.template, args.out, dirs, scenes,
                                      include)
    else:
        text = generate(dirs, scenes, include)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
    print(text)
    if args.readme_template:
        generate_from_template(args.readme_template, args.readme_out, dirs,
                               scenes, include)
        print(f"(wrote {args.readme_out} from {args.readme_template})")


if __name__ == "__main__":
    main()
