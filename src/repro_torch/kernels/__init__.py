# Hand-written Hopper (sm_90a) kernels for the compute hot spots. Each
# subpackage has kernel.py (build + ctypes launch of its csrc/*.cu) and
# ops.py (the wrapper every caller uses, with the plain PyTorch version
# beside it: CPU tensors take the plain version, CUDA tensors the kernel,
# any other device raises; the served wrappers, decode_attn, chunk_scan and
# alias_mh, also take the plain version on `meta` tensors, whose only
# caller is the dry run's shape propagation, `launch.dryrun`);
# `_build.py` compiles and loads every csrc/*.cu:
#
#   lda_gibbs    fused collapsed-Gibbs score + Gumbel-max resample
#   alias_mh     AliasLDA stale alias-table proposals + S Metropolis-Hastings rounds
#   chunk_scan   chunked diagonal-decay recurrence (Mamba2 / RWKV6 prefill)
#   decode_attn  one-token GQA flash-decode over a (ring) KV cache
#
# lda_gibbs and alias_mh each have a single-model entry and a batched one
# over M stacked models.

#: Devices on which the served wrappers run their plain versions.
PLAIN_DEVICES = ("cpu", "meta")
