"""Compute ops: SpMM tiers and the self-adjoint loop, top-k MIPS, metrics,
CSR search and BPR sampling. Kernel wrappers live in
``spmm_pallas.py`` and ``topk_pallas.py`` (named after the JAX modules whose
Pallas kernels they replace)."""
