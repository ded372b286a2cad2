"""The control of a cell's check: the traffic driver's reference computed
in bfloat16 put in the program's place, judged by the same comparison and
limits as the program's film. It has to come out not correct.

    python3 port_bench/control.py --workload cbox-pt --passes 222 \\
        --seeds 11 12 13

--passes: the passes a run's film holds (warm-up and window). Prints one
JSON line a seed with the numbers compared, their limits and `correct`.
Only the sampled pixels enter the comparison, so only they are rendered.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def numbers(workload, seed, passes, device, bench=None, base=None):
    """{name: value} of the control's film against the reference's."""
    import torch
    from port_bench import assets, harness
    base = base or harness.HERE
    _w, config, traffic, limits = harness.cell(
        bench or harness.manifest(), workload, base)
    drv = harness.driver(traffic, base)
    assets.ensure(harness.ROOT, config["assets"])
    sc, pix = harness.reference_pixels(drv, config, limits, seed, device)
    s32 = harness.seed32(seed)
    ref = drv.reference(sc, s32, passes, pix)
    low = drv.reference(sc, s32, passes, pix, dtype=torch.bfloat16)
    got = harness.compare(low, ref)
    return {k: v for k, v in got.items() if k in limits}, limits


def main(argv=None):
    ap = argparse.ArgumentParser(description="the check's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--passes", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        got, limits = numbers(args.workload, seed, args.passes, "cuda")
        print(json.dumps({
            "seed": seed, "correct": all(got[k] <= limits[k] for k in got),
            "checks": {k: {"value": v, "limit": limits[k]}
                       for k, v in got.items()}}), flush=True)


if __name__ == "__main__":
    main()
