"""The benchmark's command:

    python3 gbbench/run.py --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card (see ``harness.run``) and
prints its result as the last line of standard output, each compared
number beside its limit as the last lines of standard error.  It refuses
to run without as many CUDA devices as the cell asks for, without the
program in its checkout, or where the JAX package or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".gbbench_cache")


def fail(msg, code):
    print(f"gbbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    sys.path[0] = ROOT  # the checkout, not this directory
    import torch

    from gbbench import harness, spec

    try:
        work = spec.cell(args.workload)[0]
    except (OSError, KeyError, ValueError) as e:
        return fail(f"no such cell: {e}", 2)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(work["chips"]):
        return fail(f"{args.workload} needs {work['chips']} CUDA device(s); "
                    f"found {torch.cuda.device_count()}", 3)
    try:
        import graphblas_tpu_torch
    except ImportError as e:
        return fail(f"the program is not in this checkout: {e}", 5)
    if not os.path.abspath(graphblas_tpu_torch.__file__).startswith(
            ROOT + os.sep):
        return fail("graphblas_tpu_torch was loaded from outside the "
                    f"checkout: {graphblas_tpu_torch.__file__}", 5)

    result, checks, notes = harness.run(args.workload, args.seed,
                                        args.seconds, args.trace, T_START)
    for line in notes:
        print(f"gbbench: {line}", file=sys.stderr)
    if result is None:
        return fail(f"modules loaded that the run may not load: {checks}", 4)
    result["checks"] = checks  # the last key
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
