"""assoc.host_s: mean seconds per association outside the `nam`,
`residualize` and `test` phases: the entry point's input checks and
conversions and the per-cell write-back into `obs`."""


def read(run):
    if run.job != "association" or not run.phases:
        return None
    rest = [w - sum(p.get(k, 0.0) for k in ("nam", "residualize", "test"))
            for w, p in zip(run.walls, run.phases)]
    return sum(rest) / len(rest)
