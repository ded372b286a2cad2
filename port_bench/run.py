"""The benchmark of adapt_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload cbox-pt --seed 7 --seconds 50 --trace 0

Run from the root of a checkout. Prints the compared numbers with their
limits as the last lines of standard error, and one JSON result line as
the last line of standard output. Exits with 2 and prints no result when
the cell's CUDA cards are missing, a file it needs is missing, or a
forbidden module (jax, jaxlib, flax, adapt_tpu) was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from port_bench import harness
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             args.trace, T_START)
    except (harness.Refused, ImportError, FileNotFoundError) as err:
        print(f"refused: {err}", file=sys.stderr)
        return 2
    for name, v in result["checks"].items():
        print(f"{name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
