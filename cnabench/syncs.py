"""Where one job of a cell waits for the card: its synchronizing calls
beside the program's ``host_reads`` counter.

    python3 -m cnabench.syncs --workload bench100k.assoc --seed <n> \\
        [--jobs 1]

Runs the cell through ``cnabench.run.run_cell``, traced, with a window of
``--jobs`` jobs, each under ``torch.cuda.set_sync_debug_mode("warn")``,
and prints one JSON line: the synchronizing calls PyTorch flagged (each
with the source line that made it and the innermost open span), how many
of them are the program's counted reads (``fetch`` and ``scalar`` of
``utils/transfer.py``), and the ``host_reads`` the spans counted, per
job.  On the CPU PyTorch flags nothing and only the counter is read.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings
from pathlib import Path

from . import kinds
from .run import ROOT, _environment, load_json, run_cell

COUNTED = ("fetch", "scalar")  # the program's counted reads


def audit(workload, seed, jobs=1, device="cuda", config_overrides=None):
    """dict of the flagged synchronizing calls and the counted host reads
    of ``jobs`` jobs after the cell's set-up."""
    import torch

    from cna_tpu_torch.utils import profiling

    on_card = torch.device(device).type == "cuda"
    flagged = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            phases = profiling.open_phases()
            flagged.append((*_caller(), phases[-1] if phases else None))

    load = kinds.load

    def audited(name):
        class Audited(load(name)):
            audit = False  # the set-up's warm-up job is not audited

            def setup(self, ct):
                super().setup(ct)
                self.audit = on_card

            def run(self, i):
                if self.audit:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    return super().run(i)
                finally:
                    if self.audit:
                        torch.cuda.set_sync_debug_mode(0)
        return Audited

    bench = load_json(ROOT / "BENCHMARK.json")
    kinds.load = audited
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            result, _, _ = run_cell(
                bench, workload, seed, 0, True, device=device,
                config_overrides=config_overrides,
                traffic_overrides={"trace_from": 0, "trace_jobs": jobs})
    finally:
        kinds.load = load
    n = result["attempted"]
    reads = sum(p.get("host_reads", 0)
                for p in profiling.last_session().phases)
    sites = {}
    for site, _, phase in flagged:
        key = f"{site} [{phase}]"
        sites[key] = sites.get(key, 0) + 1
    counted = sum(c for _, c, _ in flagged)
    return {"workload": workload, "seed": seed, "jobs": n,
            "device": result["device"]["kind"],
            "correct": result["correct"],
            "host_reads_per_job": reads / n,
            "flagged_per_job": len(flagged) / n,
            "flagged_in_reads_per_job": counted / n,
            "sites": dict(sorted(sites.items(), key=lambda kv: -kv[1]))}


def _caller():
    """(``file:line`` of the innermost frame of the program, or of the
    benchmark's kinds, on the stack, whether that frame is a counted read
    of ``utils/transfer.py``).  A counted read's site carries its
    caller's."""
    frame = sys._getframe(2)
    sites, counted = [], False
    while frame is not None and len(sites) < 2:
        parts = Path(frame.f_code.co_filename).parts
        if "cna_tpu_torch" in parts:
            rel = parts[parts.index("cna_tpu_torch") + 1:]
            sites.append(f"{'/'.join(rel)}:{frame.f_lineno}")
            if len(sites) == 1:
                counted = (rel[-1] == "transfer.py"
                           and frame.f_code.co_name in COUNTED)
        elif "kinds" in parts and "cnabench" in parts:
            sites.append(f"cnabench/kinds/{parts[-1]}:{frame.f_lineno}")
        if sites and not counted:
            break
        frame = frame.f_back
    return " < ".join(sites) or "?", counted


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)
    _environment()
    warnings.filterwarnings("ignore")
    print(json.dumps(audit(args.workload, args.seed, args.jobs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
