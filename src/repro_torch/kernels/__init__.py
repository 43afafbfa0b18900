# Hand-written Hopper (sm_90a) kernels for the compute hot spots. Each
# subpackage has kernel.py (build + ctypes launch of its csrc/*.cu) and
# ops.py (the wrapper every caller uses, with the plain PyTorch version
# beside it: CPU tensors take the plain version, CUDA tensors the kernel);
# `_build.py` compiles and loads every csrc/*.cu:
#
#   lda_gibbs    fused collapsed-Gibbs score + Gumbel-max resample
#   alias_mh     AliasLDA stale alias-table proposals + S Metropolis-Hastings rounds
#
# each with a single-model entry and a batched one over M stacked models.
