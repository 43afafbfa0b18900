"""CLI: `python -m repro_torch.analysis [paths...]` (vedalint for the port).

Exit codes: 0 clean, 1 findings, 2 usage error. `--format json` prints
the machine-readable report (`--output` writes it to a file as well).
Suppress a finding inline with `# vedalint: disable=<rule-id> -- <why>`,
or `// vedalint: disable=<rule-id> -- <why>` in a CUDA source.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.engine import AnalysisConfig, analyze_paths, write_json
from repro_torch.analysis.rules import all_rules, rule_ids

DEFAULT_PATHS = ["src/repro_torch", "tools", "chip_smoke.py"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="vedalint: static analysis of the PyTorch port's Python "
                    "and CUDA sources")
    parser.add_argument(
        "paths", nargs="*", default=DEFAULT_PATHS,
        help="files or directories to analyze (default: "
             + " ".join(DEFAULT_PATHS) + ")")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--output", metavar="FILE",
                        help="also write the JSON report here")
    parser.add_argument("--rules", metavar="ID[,ID...]",
                        help="run only these rule ids")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    parser.add_argument("--smem-assume", action="append", default=[],
                        metavar="NAME=N",
                        help="assumed value of a static __shared__ dim or "
                             "element type the scanner cannot resolve "
                             "(repeatable)")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}\n    {rule.summary}")
        return 0

    config = AnalysisConfig()
    for spec in args.smem_assume:
        name, _, val = spec.partition("=")
        if not name or not val.isdigit():
            parser.error(f"--smem-assume wants NAME=N, got {spec!r}")
        config.smem_assume[name] = int(val)
    if args.rules:
        wanted = frozenset(r.strip() for r in args.rules.split(",")
                           if r.strip())
        unknown = wanted - set(rule_ids())
        if unknown:
            parser.error(f"unknown rule ids: {sorted(unknown)}; "
                         f"known: {rule_ids()}")
        config.rules = wanted

    report = analyze_paths(args.paths, config)
    if args.output:
        write_json(report, args.output)
    if args.format == "json":
        print(json.dumps(report.to_json(), indent=2, sort_keys=True))
    else:
        print(report.render_text())
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
