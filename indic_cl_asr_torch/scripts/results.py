"""CLI for offline results analysis (reference: results.py entry points):
summary.json and the PDF families of analysis/results.py:generate_report.

Usage:
  python -m indic_cl_asr_torch.scripts.results --out results_report outputs/<run_id> [more run dirs...]
  # run labels default to directory names; override with name=dir pairs:
  python -m indic_cl_asr_torch.scripts.results --out report ewc=outputs/abc naive=outputs/def
"""

import argparse
import json
import os

from ..analysis.results import generate_report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+", help="run dir or name=dir")
    ap.add_argument("--out", default="results_report")
    ap.add_argument("--languages", nargs="*", default=None)
    ap.add_argument(
        "--family", action="append", default=[],
        help="ablation dir spec name=substr[,substr...] — e.g. "
        "--family ewc=ewc,naive emits ewc_ablation/ over matching runs "
        "(reference results/ dir structure)",
    )
    args = ap.parse_args(argv)

    run_dirs = {}
    for spec in args.runs:
        if "=" in spec:
            name, d = spec.split("=", 1)
        else:
            name, d = os.path.basename(os.path.normpath(spec)), spec
        run_dirs[name] = d
    families = {}
    for spec in args.family:
        name, pats = spec.split("=", 1)
        families[name] = pats.split(",")
    summaries = generate_report(
        run_dirs, args.out, args.languages, families=families
    )
    print(json.dumps(
        {name: {dec: s[dec]["bwt"] for dec in s} for name, s in
         summaries.items()},
        indent=2,
    ))
    print(f"report written to {args.out}/")
    return summaries


if __name__ == "__main__":
    main()
