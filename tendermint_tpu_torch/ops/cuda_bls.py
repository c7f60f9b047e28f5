"""CUDA kernels of the BLS12-381 path and their plain torch versions.

The counterpart of the Pallas kernels in tendermint_tpu/ops/pallas_bls.py.
Two hand-written Hopper kernels (csrc/bls_kernels.cu, field arithmetic in
csrc/fp381.cuh):

- `fp381_mul(a, b)`           the Montgomery product a * b * 2^-396 mod p of
                              two (..., 33, n) batches, limb for limb as
                              the reference's fp381._mul_rows_loop: a warp
                              a product on FP_FEW_PRODUCTS products or
                              fewer (the Miller loop's launches,
                              the fold's top levels), a thread a product
                              above (the fold's wide levels)
- `fp12_sparse_mul(f, line)`  an Fp12 value (6, 2, 33, n) times a sparse
                              Miller line (c0, c3, c5) (3, 2, 33, n), as
                              pallas_bls.sparse_mul12

Each wrapper, for a tensor on the CPU, returns its plain version (`*_plain`).
For a CUDA tensor it checks dtype, shape, device and contiguity, allocates
the output, launches the kernel on the current stream, raises if the launch
failed, and adds one to `LAUNCHES[name]`. There is no fallback from a CUDA
tensor to the plain version. The library is built with nvcc for sm_90a at
first use (`cuda_fe.build_library`).
"""

from __future__ import annotations

import ctypes

import torch

from tendermint_tpu_torch.ops import cuda_fe
from tendermint_tpu_torch.ops import fp381 as F
from tendermint_tpu_torch.ops import tower

NL = F.NLIMBS

LAUNCHES = {"fp381_mul": 0, "fp12_sparse_mul": 0}

SOURCES = ("fp381.cuh", "bls_kernels.cu")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions.

_DIAG_CACHE: dict = {}


def _diag_index(device) -> torch.Tensor:
    key = str(device)
    t = _DIAG_CACHE.get(key)
    if t is None:
        i = torch.arange(NL)
        t = (i[:, None] + i[None, :]).reshape(-1).to(device)
        _DIAG_CACHE[key] = t
    return t


def fp381_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The torch form of the reference's fp381._mul_np over (..., 33, n):
    the 65-limb schoolbook product (the 33 x 33 outer product summed onto
    its diagonals), 33 interleaved Montgomery steps, 3 carry passes over the
    top 33 limbs. The partial sums are the same integers in another order,
    which the reference's < 2^31 bound allows."""
    a, b = torch.broadcast_tensors(a, b)
    lead, n = a.shape[:-2], a.shape[-1]
    outer = (a.unsqueeze(-2) * b.unsqueeze(-3)).reshape(*lead, NL * NL, n)
    prod = torch.zeros(*lead, 2 * NL, n, dtype=torch.int32, device=a.device)
    prod.index_add_(len(lead), _diag_index(a.device), outer)
    p_col = F.const("p", a.device)
    for i in range(NL):
        m = ((prod[..., i : i + 1, :] & F.MASK) * F.PPRIME) & F.MASK
        prod[..., i : i + NL, :] += m * p_col
        prod[..., i + 1, :] += prod[..., i, :] >> F.RADIX
    return F.carry(prod[..., NL:, :], 3)


def fp12_sparse_mul_plain(f: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """pallas_bls.sparse_mul12 over the plain Fp2 ops (the 18 Karatsuba
    products through fp381_mul_plain)."""
    return tower.sparse_mul12_formula(f, line, fp381_mul_plain)


# ---------------------------------------------------------------------------
# Build, bind and launch.


def _bind(lib) -> None:
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tm_fp381_mul.argtypes = [vp, vp, vp, i64, i64, vp]
    lib.tm_fp381_mul_few.argtypes = [vp, vp, vp, i64, i64, vp]
    lib.tm_fp12_sparse_mul.argtypes = [vp, vp, vp, i64, vp]
    for fn in (lib.tm_fp381_mul, lib.tm_fp381_mul_few, lib.tm_fp12_sparse_mul):
        fn.restype = ci


def build() -> ctypes.CDLL:
    """The BLS kernel library (csrc/bls_kernels.cu)."""
    return cuda_fe.build_library("bls_kernels", SOURCES, _bind)


def _field(x: torch.Tensor, what: str, lead: tuple = None) -> None:
    """Checks an int32 contiguous (..., 33, n) batch."""
    if x.dim() < 2 or x.shape[-2] != NL:
        raise ValueError(f"{what}: expected (..., {NL}, n), got {tuple(x.shape)}")
    if lead is not None and tuple(x.shape[:-2]) != lead:
        raise ValueError(f"{what}: expected leading shape {lead}, got {tuple(x.shape)}")
    cuda_fe._check(x, tuple(x.shape[:-2]) + (NL,), what)


# The largest product count of the card sweep (tools/fp_probe.py and
# chip_smoke.py's fp381_mul sweep: the Miller loop's 8-216 products on 2
# lanes, the fold's levels of 6 x 1 ... 6 x 8,192) at which the few-product
# kernel beat the thread kernel (1,536:
# 0.0038 vs 0.0043 ms; 3,072: 0.0052 vs 0.0045; profiler, NVIDIA H100 80GB
# HBM3, 700 W).
FP_FEW_PRODUCTS = 1536


def fp381_mul_entry(products: int) -> str:
    """The fp381_mul kernel that `products` products launch: a warp a
    product on FP_FEW_PRODUCTS products or fewer, a thread a product
    above."""
    return "tm_fp381_mul_few" if products <= FP_FEW_PRODUCTS else "tm_fp381_mul"


def fp381_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-396 mod p for two contiguous int32 batches of one shape
    (..., 33, n); every leading index and lane is one independent product."""
    if a.device.type == "cpu":
        return fp381_mul_plain(a, b)
    if b.shape != a.shape or b.device != a.device:
        raise ValueError(f"fp381_mul: b {tuple(b.shape)} on {b.device} vs a "
                         f"{tuple(a.shape)} on {a.device}")
    _field(a, "fp381_mul a")
    _field(b, "fp381_mul b")
    out = torch.empty_like(a)
    lanes = a.shape[-1]
    if a.numel():
        groups = a.numel() // (NL * lanes)
        fn = getattr(build(), fp381_mul_entry(groups * lanes))
        with cuda_fe._on_card(a):
            cuda_fe._launched("fp381_mul", fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), lanes,
                                              groups, cuda_fe._stream(a)), LAUNCHES)
    return out


def fp12_sparse_mul(f: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """f (6, 2, 33, n) times the sparse line (c0, c3, c5) (3, 2, 33, n) ->
    (6, 2, 33, n)."""
    if f.device.type == "cpu":
        return fp12_sparse_mul_plain(f, line)
    if line.device != f.device or line.shape[-1] != f.shape[-1]:
        raise ValueError(f"fp12_sparse_mul: line {tuple(line.shape)} on {line.device} vs f "
                         f"{tuple(f.shape)} on {f.device}")
    _field(f, "fp12_sparse_mul f", (6, 2))
    _field(line, "fp12_sparse_mul line", (3, 2))
    out = torch.empty_like(f)
    if f.numel():
        with cuda_fe._on_card(f):
            cuda_fe._launched("fp12_sparse_mul", build().tm_fp12_sparse_mul(
                f.data_ptr(), line.data_ptr(), out.data_ptr(), f.shape[-1],
                cuda_fe._stream(f)), LAUNCHES)
    return out
