"""PyTorch + CUDA port of tendermint_tpu's batched Ed25519 commit verification.

`ValidatorSet.verify_commit` -> `crypto.batch.verify_batch` -> the RLC
Pippenger MSM (ops/msm_torch.py: the fused schedule on every RLC flush, the
unfused one as its differential reference), the streamed flush planner for
flushes above the lane budget, and the per-signature ladder
(ops/ed25519_torch.py). Every point add, doubling chain and square chain
runs on hand-written CUDA kernels (csrc/point_kernels.cu via ops/cuda_fe.py),
and so do the fused MSM's chunk trees, Fenwick sums and bucket fold
(csrc/msm_kernels.cu via ops/cuda_msm.py). The package imports torch and
numpy and nothing of the JAX package; it keeps its own copies of the
host-only pieces it needs.
"""
