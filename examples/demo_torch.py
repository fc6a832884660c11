"""End-to-end cna_tpu_torch demo: ``examples/demo.py`` on the PyTorch port.

Generates the synthetic multi-sample dataset (the reference's
demo/makedata.ipynb recipe), builds the cell-cell graph on the card,
runs case/control association with a sex covariate and batch correction,
and renders the UMAP overlay + per-cluster violin figure.  Needs
matplotlib and h5py.

Run:  python examples/demo_torch.py [--out demo_out] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--cpu", action="store_true",
                    help="compute on the CPU (default: the CUDA card)")
    ap.add_argument("--cells-per-sample", type=int, default=200)
    args = ap.parse_args()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    import pandas as pd

    import cna_tpu_torch as ct

    if args.cpu:
        ct.config.set_device("cpu")

    os.makedirs(args.out, exist_ok=True)

    # 1. data: 50 samples x 200 cells x 50 genes, case/sex covariates,
    #    5 batches (reference makedata.ipynb cells 2-5)
    print("generating data…")
    d, samplem = ct.data.synthetic_dataset(
        cells_per_sample=args.cells_per_sample)
    print(d)

    # 2. preprocessing on the device: PCA -> kNN graph -> UMAP layout
    print("building graph…")
    ct.pp.pca(d, n_comps=50)
    ct.pp.neighbors(d, n_neighbors=15)
    print("computing UMAP layout…")
    ct.pp.umap(d)

    # 3. association: case status, controlling for sex + batch
    print("running association…")
    res = ct.tl.association(
        d, samplem["case"].astype(float), "id",
        covs=samplem[["male"]].astype(float),
        batches=samplem["batch"],
        show_progress=True, return_full=True, seed=0)
    print(f"\nglobal p-value: {res.p:.4g}   (k = {res.k} NAM PCs, "
          f"r2 = {res.r2:.3f})")
    n_sig = int((d.obs["coef_fdr"] <= 0.05).sum())
    print(f"cells in FDR<=5% neighborhoods: {n_sig} / {d.n_obs}")

    # 4. figures
    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    ct.pl.umap_ncorr(d, fdr_thresh=0.05, ax=axes[0])
    axes[0].set_title(f"case-associated neighborhoods (p={res.p:.3g})")
    d.obs["population"] = pd.cut(
        np.argmax(d.X[:, [0, 25, 12]], axis=1), 3,
        labels=["pop1", "pop2", "pop3"])
    ct.pl.violinplot(d, "population", ax=axes[1])
    fig.tight_layout()
    fig.savefig(os.path.join(args.out, "association.png"), dpi=110)
    print(f"wrote {args.out}/association.png")

    # 5. write the annotated dataset
    d.write(os.path.join(args.out, "demo.h5ad"))
    print(f"wrote {args.out}/demo.h5ad")


if __name__ == "__main__":
    main()
