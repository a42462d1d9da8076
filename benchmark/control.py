"""The readings the limits of ``correct`` are set from, on the card:

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 ...

For each seed, in one process: the cell's set-up, one episode of its
traffic (the same steps and frames checked as a run checks), then the
comparisons twice over the same held states: the program's numbers, and
the controls', which put the reference in the program's place computed in
bfloat16, the precision below the configurations' float32: the whole step
(``bfloat16``, the control the limits are set against) or only its pair
sums (``bfloat16_pairs``).  A limit lies above every program reading and
below the least reading of the ``bfloat16`` control.  Each side is judged
as a run judges the program (``harness.judge``): the program has to come
out correct and every control not.  One JSON line a seed and side on
standard output, with its ``correct`` (also written to
``chiprun_out/control_<cell>.jsonl`` when that directory is there); exit
1 if a side comes out otherwise.  The benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def readings(cell: str, seed: int, device, overrides=None) -> dict:
    """The numbers of one seed, ``program``'s and each control's, each
    side with its ``correct`` (the start's number is the program's on
    every side: no control redoes the first binning)."""
    from benchlib import catalog, checks, harness
    from benchlib.trace import Tracer
    ctx = harness.Ctx(catalog.cell(cell), seed, device, False, overrides)
    ctx.controls = (None, *checks.CONTROLS)
    drv = catalog.module("drivers", ctx.traffic["driver"])
    names = ctx.cell["spec"].get("metric_names", {})
    ctx.end_to_end = tuple(names.get(k, k) for k in drv.END_TO_END)
    st = drv.setup(ctx)
    ctx.window = drv.window(ctx, st, 0.0, Tracer(False, 0))
    drv.finish(ctx, st)
    start = {k: v for k, v in ctx.numbers.items() if k == "start"}
    out = {c or "program": {**start, **ctx.readings[c]}
           for c in ctx.controls}
    limits = ctx.cell["spec"]["limits"]
    for side in out.values():
        side["correct"] = harness.judge(side, limits)[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, CHECKOUT]
    from benchlib import harness
    device = harness.card(1)
    if device is None:
        return 3
    harness.build_kernels()
    out_dir = os.path.join(CHECKOUT, "chiprun_out")
    sink = open(os.path.join(out_dir, f"control_{args.workload}.jsonl"),
                "a") if os.path.isdir(out_dir) else None
    wrong = 0
    for seed in args.seeds:
        r = readings(args.workload, seed, device)
        for side in r:
            wrong += r[side]["correct"] != (side == "program")
            line = json.dumps(dict(workload=args.workload, seed=seed,
                                   side=side, **r[side]))
            print(line, flush=True)
            if sink:
                print(line, file=sink, flush=True)
    if sink:
        sink.close()
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
