"""Device resolution for the port's entry points.

Every entry point takes `device=None`. None means the CUDA card. Asking for
CUDA on a host without one raises: there is no silent CPU path. The CPU runs
only when the caller asks for it (`device="cpu"`), as the tests do.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tendermint_tpu_torch: no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
