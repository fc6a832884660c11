"""``ivf_score`` (``csrc/ivf_score.cu``): the exact top-k of each slot's
query rows against its probed fine blocks.

Operations: ``2 * rows * candidates * d`` summed over the slots of a
launch - the live query rows of a slot times the live rows of the blocks
it probes, times the coordinates that are not padding.  Bytes: the block
layout, the slot and probe lists and the block counts read once, the
(distance, id) top-k of every query row written once.  The arithmetic of
``chip_smoke.py``'s ``ivf_bound``.
"""

TARGETS = (("cna_tpu_torch.pp.ivf_fine", "score_blocks"),)


def count(args, kwargs):
    names = ("x4", "sel_ids", "probe_ids", "blk_counts", "blk_csum", "k",
             "g", "q_blocks")
    bound = dict(zip(names, args))
    bound.update(kwargs)
    x4, sel, probes = bound["x4"], bound["sel_ids"], bound["probe_ids"]
    counts, k = bound["blk_counts"], int(bound["k"])
    g, q_blocks = int(bound.get("g", 128)), int(bound.get("q_blocks", 1))

    def thunk():
        import torch

        d = int((x4 != 0).any(dim=0).any(dim=0).sum())
        qblk = (sel.long()[:, None] * q_blocks
                + torch.arange(q_blocks, device=x4.device))
        rows = counts[qblk].long().sum(dim=1)
        cands = counts[probes.long()].long().sum(dim=1)
        flops = 2.0 * float((rows * cands).sum()) * d
        nbytes = (4.0 * x4.numel()
                  + 4.0 * (sel.numel() + probes.numel() + 2 * counts.numel())
                  + 8.0 * sel.shape[0] * q_blocks * g * k)
        return flops, nbytes

    return thunk
