"""Light-block providers: the port's copy of tendermint_tpu/light/provider.py
(reference light/provider/provider.go, light/provider/errors.go,
light/provider/mock) without the RPC-backed HTTPProvider, which waits for
an RPC port (ROADMAP A8).
"""

from __future__ import annotations

from typing import Dict, Optional

from tendermint_tpu_torch.types.light import LightBlock


class ProviderError(Exception):
    pass


class ErrLightBlockNotFound(ProviderError):
    """reference: light/provider/errors.go ErrLightBlockNotFound."""


class ErrNoResponse(ProviderError):
    """reference: light/provider/errors.go ErrNoResponse."""


class ErrBadLightBlock(ProviderError):
    """reference: light/provider/errors.go ErrBadLightBlock."""


class Provider:
    """reference: light/provider/provider.go:14."""

    def chain_id(self) -> str:
        raise NotImplementedError

    async def light_block(self, height: Optional[int]) -> LightBlock:
        """Fetch the light block at height (None → latest). Raises
        ErrLightBlockNotFound / ErrNoResponse / ErrBadLightBlock."""
        raise NotImplementedError


class MockProvider(Provider):
    """In-memory provider for tests and in-process wiring
    (reference: light/provider/mock/mock.go)."""

    def __init__(self, chain_id: str, blocks: Dict[int, LightBlock]):
        self._chain_id = chain_id
        self.blocks = dict(blocks)
        self.calls = 0

    def chain_id(self) -> str:
        return self._chain_id

    def add(self, lb: LightBlock) -> None:
        self.blocks[lb.height] = lb

    async def light_block(self, height: Optional[int]) -> LightBlock:
        self.calls += 1
        if not self.blocks:
            raise ErrNoResponse("mock has no blocks")
        if height is None:
            height = max(self.blocks)
        lb = self.blocks.get(height)
        if lb is None:
            raise ErrLightBlockNotFound(f"height {height}")
        return lb
