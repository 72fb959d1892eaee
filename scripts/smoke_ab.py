"""Time ``chip_smoke.py`` of two checkouts on one NVIDIA card, in
alternating turns (base, new, new, base, ...), each turn a fresh process
through ``scripts/smoke_wall_profile.py``.

    python3 scripts/smoke_ab.py --base DIR --new DIR [--pairs 2] [--budget 3000]

DIR holds a checkout, e.g. a ``git archive`` of a commit unpacked into a
git-ignored directory. Each turn writes its stamped output to
``chiprun_out/<label>_stamped.log`` and its summary to
``chiprun_out/<label>.out``, and prints its exit code, its wall, the
script's own ``total`` line and its ``walls by phase`` line. A turn is
skipped once ``--budget`` seconds have gone. Prints the card's name and
power limit first; exits non-zero when a turn fails.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True)
    ap.add_argument("--new", required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--budget", type=float, default=3000.0)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    turns = []
    for i in range(args.pairs):
        pair = [("base", args.base), ("new", args.new)]
        turns += [(f"{label}{i + 1}", root) for label, root in (pair if i % 2 == 0 else pair[::-1])]
    t0, failed = time.time(), False
    for label, root in turns:
        spent = time.time() - t0
        if spent > args.budget:
            print(f"{label}: skipped, {spent:.0f} s spent", flush=True)
            continue
        r = subprocess.run([sys.executable, str(REPO / "scripts" / "smoke_wall_profile.py"),
                            "--root", root, "--out", f"chiprun_out/{label}_stamped.log",
                            "--top", "12"], capture_output=True, text=True)
        (REPO / "chiprun_out" / f"{label}.out").write_text(r.stdout + r.stderr)
        stamped = (REPO / "chiprun_out" / f"{label}_stamped.log").read_text().splitlines()
        keep = [ln for ln in stamped if " total " in ln or "walls by phase" in ln]
        print(f"==== {label} ({root}): rc {r.returncode}, {time.time() - t0 - spent:.1f} s",
              flush=True)
        for ln in keep:
            print(ln[:1200], flush=True)
        failed |= r.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
