"""Carry state from the JAX package into the port, through numpy only.

- `a_coords_to_tensor`: decompressed A coordinates as the JAX package's
  `msm_jax.decompress_rows` returns them ((x, y, z, t), each (20, m) int32)
  -> the port's (4, 20, m) int32 point tensor.
- `fill_a_cache_from_coords`: the same coordinates -> entries of the port's
  device A cache (crypto/batch.py), so a cached-A flush runs on them.
- `validator_set_from_rows`: (pubkey bytes, voting power) rows -> a port
  ValidatorSet of ed25519 or bls12_381 keys.
- `fp381_to_tensor`, `bls_point_to_tensor`: fp381 limb blocks (33, n) and
  bls12_msm point triples (X, Y, Z) -> (33, n) / (3, 33, n) tensors.
- `fp2_rows_to_tensor`, `fp12_rows_to_tensor`: pallas_bls row lists (an Fp2
  is a pair of 33 limb rows, an Fp12 six Fp2) -> (..., 2, 33, n) tensors.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve


def a_coords_to_tensor(coords: Sequence[np.ndarray], device=None) -> torch.Tensor:
    arr = np.stack([np.asarray(c, dtype=np.int32) for c in coords])
    if arr.shape[:2] != (4, 20):
        raise ValueError(f"expected 4 coordinates of (20, m) limbs, got {arr.shape}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(resolve(device))


def fill_a_cache_from_coords(rows: np.ndarray, coords: Sequence[np.ndarray], ok,
                             device=None) -> None:
    """rows (m, 32) uint8 pubkey encodings; coords/ok as decompress_rows
    returns them."""
    from tendermint_tpu_torch.crypto import batch

    batch.fill_a_cache(np.asarray(rows, dtype=np.uint8), a_coords_to_tensor(coords, device),
                       np.asarray(ok, dtype=bool))


def validator_set_from_rows(rows: Iterable[Tuple[bytes, int]], key_type: str = "ed25519"):
    from tendermint_tpu_torch.crypto.keys import Bls12381PubKey, Ed25519PubKey
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    key = {"ed25519": Ed25519PubKey, "bls12_381": Bls12381PubKey}[key_type]
    return ValidatorSet([Validator(key(bytes(pk)), int(power)) for pk, power in rows])


def fp381_to_tensor(limbs, device=None) -> torch.Tensor:
    """(..., 33, n) fp381 limbs (numpy) -> the same int32 tensor."""
    from tendermint_tpu_torch.ops import fp381

    arr = np.asarray(limbs)
    if arr.ndim < 2 or arr.shape[-2] != fp381.NLIMBS:
        raise ValueError(f"expected (..., 33, n) limbs, got {arr.shape}")
    return fp381.to_tensor(arr, resolve(device))


def bls_point_to_tensor(pt: Sequence[np.ndarray], device=None) -> torch.Tensor:
    """A bls12_msm point triple (X, Y, Z), each (33, n) -> (3, 33, n)."""
    if len(pt) != 3:
        raise ValueError(f"expected 3 coordinates, got {len(pt)}")
    return fp381_to_tensor(np.stack([np.asarray(c) for c in pt]), device)


def fp2_rows_to_tensor(rows, device=None) -> torch.Tensor:
    """A pallas_bls Fp2 (two lists of 33 limb rows) -> (2, 33, n)."""
    return fp381_to_tensor(np.stack([np.stack([np.asarray(r) for r in comp]) for comp in rows]),
                           device)


def fp12_rows_to_tensor(f, device=None) -> torch.Tensor:
    return torch.stack([fp2_rows_to_tensor(c, device) for c in f])
