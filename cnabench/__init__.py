"""The benchmark of cna_tpu_torch on one NVIDIA card (see README.md).

Nothing in this package imports ``jax`` or ``cna_tpu``; the reference
(``cnabench.reference``) imports nothing of ``cna_tpu_torch`` either.
"""
