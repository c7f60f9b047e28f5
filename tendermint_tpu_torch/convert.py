"""Carry state from the JAX package into the port, through numpy only.

- `a_coords_to_tensor`: decompressed A coordinates as the JAX package's
  `msm_jax.decompress_rows` returns them ((x, y, z, t), each (20, m) int32)
  -> the port's (4, 20, m) int32 point tensor.
- `fill_a_cache_from_coords`: the same coordinates -> entries of the port's
  device A cache (crypto/batch.py), so a cached-A flush runs on them.
- `validator_set_from_rows`: (pubkey bytes, voting power) rows -> a port
  ValidatorSet.
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


def validator_set_from_rows(rows: Iterable[Tuple[bytes, int]]):
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    return ValidatorSet([Validator(Ed25519PubKey(bytes(pk)), int(power)) for pk, power in rows])
