"""The control of a cell: the reference in the precision below the one its
configuration states (TF32 for float32 with TF32 off), standing in for
the program, judged exactly as a run judges the program.  It has to come
out not correct; its numbers are the upper readings the limits are set
below (PERF.md, section 2).

    python3 -m cnabench.control --workload <name> --seeds 11 12 13 \\
        [--program]

prints one JSON line per seed: the control's numbers and whether the
cell's limits hold them.  With ``--program`` it prints the program's
numbers for the same seeds instead (set-up, one job or build a pick, no
timed window): the lower readings.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings


def control_precision(config):
    """The precision below the one the configuration states: TF32 for
    float32 with TF32 off, the only one the configurations state."""
    from .reference import Precision

    if (config["dtype"], config["tf32"]) != ("float32", False):
        raise ValueError("no control for a configuration of "
                         f"{config['dtype']} with tf32={config['tf32']}")
    return Precision("tf32")


def control_numbers(bench, workload, seed, device, config_overrides=None,
                    traffic_overrides=None):
    from . import kinds, run

    _, config, traffic, limits = run.cell_files(bench, workload)
    config.update(config_overrides or {})
    traffic.update(traffic_overrides or {})
    kind = kinds.load(traffic["job"])(config, traffic, seed, device)
    kind.prepare()
    out = kind.control(control_precision(config), device)
    numbers, _ = kind.judge(out, device)
    rows = [r for r in run.hold(numbers, limits) if r[1] is not None]
    return numbers, all(r[4] for r in rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    from . import run

    run._environment()
    import torch

    if not torch.cuda.is_available():
        print("cnabench.control: no CUDA card", file=sys.stderr)
        return 3
    warnings.filterwarnings("ignore")
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.program:
            res, _, numbers = run.run_cell(bench, args.workload, seed,
                                           args.seconds, False)
            rec = dict(subject="program", correct=res["correct"],
                       numbers=numbers, metrics=res["metrics"])
        else:
            numbers, ok = control_numbers(bench, args.workload, seed, "cuda")
            rec = dict(subject="control", correct=ok, numbers=numbers)
        rec.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
