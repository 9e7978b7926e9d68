"""The control of a cell's check: the plain reference put in the
program's place with one guarantee of the configuration broken (each
driver's ``control``), judged by the same ``check`` as a run.  A sound
check fails it on every seed.

    python3 gbbench/control.py --workload <cell> --seeds 1,2,3 [--trials 12]
        [--scale <s>] [--device cuda|cpu]

prints one JSON line per seed: the compared numbers of the reference
(the lower reading of a sound run is 0 for an exact comparison) and of
the control, each with its limit.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed, trials, device, config=None):
    """(checks of the control, failed) for ``trials`` trials of ``cell``
    on the graph of ``seed``."""
    from gbbench import gen, spec

    _, cfg, trf, _, _ = spec.cell(cell)
    drv = spec.driver(trf["driver"])
    graph = gen.build(cfg if config is None else config, seed, device)
    state = drv.prepare(graph, trf, seed)
    kept = [(i, drv.control(graph, state, i, device))
            for i in range(1, trials + 1)]
    return drv.check(graph, state, kept, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--scale", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    from gbbench import spec

    cfg = spec.cell(args.workload)[1]
    if args.scale is not None:
        cfg = dict(cfg, scale=args.scale)
    for seed in (int(s) for s in args.seeds.split(",")):
        checks, failed = readings(args.workload, seed, args.trials,
                                  args.device, cfg)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "scale": cfg["scale"], "trials": args.trials,
                          "control_failed": failed, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
