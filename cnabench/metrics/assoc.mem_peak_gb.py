"""assoc.mem_peak_gb: the largest `mem_peak` of the window's
associations, in GB (1e9 bytes): the allocator's peak of the process
(`torch.cuda.max_memory_allocated()`, never reset, so set-up counts too)
read when an association closes.  Counted on a card only: a CPU run, or a
program without the counter, gives nothing to read."""

from cnabench import counters


def read(run):
    if run.job != "association":
        return None
    peaks = [p["mem_peak"] for p in counters.spans("association") or ()
             if p.get("mem_peak")]
    return max(peaks) / 1e9 if peaks else None
