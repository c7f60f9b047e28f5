"""Light-block providers: the port's copy of tendermint_tpu/light/provider.py,
whole (reference light/provider/provider.go, light/provider/errors.go,
light/provider/http/http.go (RPC-backed), light/provider/mock).
"""

from __future__ import annotations

from typing import Dict, Optional

from tendermint_tpu_torch.types.light import (
    LightBlock,
    commit_from_json,
    header_from_json,
    validator_set_from_json,
    SignedHeader,
)


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


class HTTPProvider(Provider):
    """RPC-backed provider (reference: light/provider/http/http.go:38).

    Talks to a node's JSON-RPC /commit + /validators routes. Accepts either an
    HTTPClient/LocalClient from tendermint_tpu_torch.rpc.client or any object with
    async commit(height) / validators(height) methods."""

    def __init__(self, chain_id: str, client):
        self._chain_id = chain_id
        self.client = client

    def chain_id(self) -> str:
        return self._chain_id

    async def light_block(self, height: Optional[int]) -> LightBlock:
        try:
            com = await self.client.commit(height=height)
        except Exception as e:
            raise ErrNoResponse(f"commit({height}): {e}") from e
        sh_json = com.get("signed_header")
        if not sh_json or "header" not in sh_json:
            raise ErrLightBlockNotFound(f"no signed header at height {height}")
        try:
            header = header_from_json(sh_json["header"])
            commit = commit_from_json(sh_json["commit"])
        except (KeyError, ValueError) as e:
            raise ErrBadLightBlock(f"malformed signed header: {e}") from e
        if height is not None and header.height != height:
            # reference: light/provider/http/http.go validateHeight
            raise ErrBadLightBlock(
                f"node returned height {header.height}, requested {height}"
            )
        try:
            vals = await self.client.validators(height=header.height)
        except Exception as e:
            raise ErrNoResponse(f"validators({header.height}): {e}") from e
        try:
            valset = validator_set_from_json(vals)
        except (KeyError, ValueError) as e:
            raise ErrBadLightBlock(f"malformed validator set: {e}") from e
        lb = LightBlock(SignedHeader(header, commit), valset)
        try:
            lb.validate_basic(self._chain_id)
        except ValueError as e:
            raise ErrBadLightBlock(str(e)) from e
        return lb


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
