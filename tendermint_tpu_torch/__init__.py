"""PyTorch + CUDA port of tendermint_tpu's batched Ed25519 commit verification.

Slice 1: `ValidatorSet.verify_commit` -> `crypto.batch.verify_batch` -> the
unfused RLC Pippenger MSM (ops/msm_torch.py) and the per-signature ladder
(ops/ed25519_torch.py), with every point add, doubling chain and square
chain on hand-written CUDA kernels (csrc/point_kernels.cu via
ops/cuda_fe.py). The package imports torch and numpy and nothing of the JAX
package; it keeps its own copies of the host-only pieces it needs.
"""
