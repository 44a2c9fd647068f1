"""One run of one benchmark cell on this machine's CUDA card(s):

    python3 benchmark/run.py --workload gcn6.gh --seed 1 --seconds 20 --trace 0

Prints the result as the last line of standard output (one JSON object)
and the numbers checked against the reference, beside their limits, as
the last lines of standard error.  Exits with another code than 0, and
prints no result, where the machine lacks the cards the cell asks for, a
run fails, or a forbidden module (JAX or the JAX package) was loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout, not this directory: benchmark.* by package


def main(argv=None) -> int:
    from benchmark import harness

    args = harness.build_parser().parse_args(argv)
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"no result: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
