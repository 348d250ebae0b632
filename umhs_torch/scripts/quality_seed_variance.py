"""Run-to-run quality spread of the port over seeds (the twin of
scripts/quality_seed_variance.py).

    python -m umhs_torch.scripts.quality_seed_variance [--seeds 42 43 44]
        [--steps 3000] [--image-size 256] [--views 16] [--out PATH] [--device cuda|cpu]

Runs umhs_torch.scripts.quality_reference_scale once per seed, each in a
process of its own, at the reduced envelope given (the same code path as the
reference-scale run), and reports the mean, min, max and sample stdev over
the seeds of every eval_all_images metric, as the JAX script does. Writes
the JSON to --out (outputs/seed_variance.json under the working directory by
default; docs/seed_variance.json is the JAX package's run) and prints the
summary. Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

REPO = Path(__file__).resolve().parents[2]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 44])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--out", type=Path, default=Path("outputs") / "seed_variance.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def seed_command(args: argparse.Namespace, seed: int, out: Path) -> List[str]:
    """The command line of one seed's run."""
    return [
        sys.executable, "-m", "umhs_torch.scripts.quality_reference_scale",
        "--steps", str(args.steps), "--image-size", str(args.image_size),
        "--views", str(args.views), "--seed", str(seed), "--out", str(out),
        "--device", args.device,
    ]


def summarize(per_seed: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """Per metric: mean, min, max and sample stdev over the seeds, rounded
    as scripts/quality_seed_variance.py rounds them (stdev 0 for one seed)."""
    runs = list(per_seed.values())
    summary = {}
    for m in sorted(runs[0]):
        vals = [r[m] for r in runs]
        summary[m] = {
            "mean": round(statistics.fmean(vals), 5),
            "min": round(min(vals), 5),
            "max": round(max(vals), 5),
            "stdev": round(statistics.stdev(vals), 6) if len(vals) > 1 else 0.0,
        }
    return summary


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    out = args.out.resolve()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    per_seed = {}
    with tempfile.TemporaryDirectory(prefix="umhs_seedvar_") as tmp:
        for seed in args.seeds:
            seed_out = Path(tmp) / f"seed{seed}.json"
            cmd = seed_command(args, seed, seed_out)
            print(f"# seed {seed}: {' '.join(cmd)}", file=sys.stderr)
            subprocess.run(cmd, check=True, env=env)
            per_seed[str(seed)] = json.loads(seed_out.read_text())["eval_all_images"]
    summary = summarize(per_seed)
    result = {
        "config": {
            "steps": args.steps,
            "image_size": args.image_size,
            "views": args.views,
            "seeds": args.seeds,
            "device": args.device,
            "note": "reduced envelope of umhs_torch.scripts.quality_reference_scale; "
                    "same code path as the reference-scale run",
        },
        "per_seed": per_seed,
        "summary": summary,
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2))
    print(json.dumps(summary))
    print(f"# wrote {out}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
