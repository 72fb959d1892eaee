"""Where ``chip_smoke.py``'s wall goes, line by line.

Runs ``python3 -u chip_smoke.py`` from the directory it is given (the repo
root by default), prefixes each line of its output (stdout and stderr
merged) with the seconds since the start, writes the stamped lines to
``--out``, and prints the script's own last lines, then the largest gaps
between two lines: the time spent before each of those lines printed.
Exits with the script's exit code.

    python3 scripts/smoke_wall_profile.py [--root DIR] [--out chiprun_out/smoke_stamped.log] \\
        [--top 40]
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="chiprun_out/smoke_stamped.log")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args()

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    t0 = time.perf_counter()
    with out.open("w") as f:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=args.root,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            t = time.perf_counter() - t0
            rows.append((t, line.rstrip("\n")))
            f.write(f"{t:8.1f} {line}")
            f.flush()
        rc = proc.wait()
    for t, line in rows[-4:]:
        print(f"{t:8.1f} {line[:400]}")
    gaps = sorted(((t - (rows[i - 1][0] if i else 0.0), t, line)
                   for i, (t, line) in enumerate(rows)), reverse=True)[:args.top]
    print(f"the {len(gaps)} largest gaps (s before the line, s since the start, the line):")
    for dt, t, line in sorted(gaps, key=lambda g: g[1]):
        print(f"{dt:7.1f} {t:8.1f} {line[:160]}")
    print(f"exit {rc}, {rows[-1][0] if rows else 0.0:.1f} s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
