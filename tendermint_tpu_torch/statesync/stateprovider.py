"""Light-client-backed state provider: conjures a trusted sm.State + commit
at the snapshot height without replay.

reference: statesync/stateprovider.go — StateProvider iface (:27),
lightClientStateProvider (:46), AppHash (:86), Commit (:102), State (:112).

The port's copy of tendermint_tpu/statesync/stateprovider.py, with a
`device` that goes to the light client, so its commit checks route as the
node's other flushes do.
"""

from __future__ import annotations

from typing import List, Optional

from tendermint_tpu_torch.light import Client, HTTPProvider, LightStore, TrustOptions
from tendermint_tpu_torch.libs.kvdb import MemDB
from tendermint_tpu_torch.state.sm_state import State
from tendermint_tpu_torch.types.basic import NANOS
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.params import (
    BlockParams,
    ConsensusParams,
    EvidenceParams,
)


class StateProvider:
    """reference: statesync/stateprovider.go:27."""

    async def app_hash(self, height: int) -> bytes:
        raise NotImplementedError

    async def commit(self, height: int) -> Commit:
        raise NotImplementedError

    async def state(self, height: int) -> State:
        raise NotImplementedError


class LightClientStateProvider(StateProvider):
    """Verifies everything through a light client over 2+ RPC endpoints
    (reference: statesync/stateprovider.go:46 NewLightClientStateProvider).

    rpc_clients: objects with async commit/validators/consensus_params/genesis
    methods (HTTPClient or LocalClient); the first is the light primary, the
    rest are witnesses. `device` goes to the light Client (None: the host arm
    below 256 rows, the card above)."""

    def __init__(
        self,
        chain_id: str,
        rpc_clients: List,
        trust_height: int,
        trust_hash: bytes,
        trust_period_ns: int,
        device=None,
    ):
        if not rpc_clients:
            raise ValueError("at least one RPC server is required")
        self.chain_id = chain_id
        self.rpc_clients = rpc_clients
        providers = [HTTPProvider(chain_id, c) for c in rpc_clients]
        self.light = Client(
            chain_id,
            TrustOptions(trust_period_ns, trust_height, trust_hash),
            providers[0],
            providers[1:],
            LightStore(MemDB()),
            device=device,
        )
        self._initialized = False

    async def _ensure(self) -> None:
        if not self._initialized:
            await self.light.initialize()
            self._initialized = True

    async def app_hash(self, height: int) -> bytes:
        """AppHash at height H lives in header H+1
        (reference: stateprovider.go:86)."""
        await self._ensure()
        lb = await self.light.verify_light_block_at_height(height + 1)
        return lb.header.app_hash

    async def commit(self, height: int) -> Commit:
        """reference: stateprovider.go:102."""
        await self._ensure()
        lb = await self.light.verify_light_block_at_height(height)
        return lb.signed_header.commit

    async def state(self, height: int) -> State:
        """Build the post-snapshot state from three consecutive verified
        light blocks (reference: stateprovider.go:112)."""
        await self._ensure()
        last = await self.light.verify_light_block_at_height(height)
        cur = await self.light.verify_light_block_at_height(height + 1)
        nxt = await self.light.verify_light_block_at_height(height + 2)

        params = await self._consensus_params(height + 1)
        return State(
            chain_id=self.chain_id,
            initial_height=await self._initial_height(),
            last_block_height=last.height,
            last_block_id=last.signed_header.commit.block_id,
            last_block_time_ns=last.time_ns,
            last_validators=last.validator_set,
            validators=cur.validator_set,
            next_validators=nxt.validator_set,
            last_height_validators_changed=nxt.height,
            consensus_params=params,
            last_height_consensus_params_changed=cur.height,
            last_results_hash=cur.header.last_results_hash,
            app_hash=cur.header.app_hash,
        )

    async def _initial_height(self) -> int:
        for client in self.rpc_clients:
            try:
                resp = await client.genesis()
                return int(resp["genesis"].get("initial_height", 1))
            except Exception:
                continue
        return 1

    async def _consensus_params(self, height: int) -> ConsensusParams:
        last_err: Optional[Exception] = None
        for client in self.rpc_clients:
            try:
                resp = await client.consensus_params(height=height)
                cp = resp["consensus_params"]
                return ConsensusParams(
                    block=BlockParams(
                        max_bytes=int(cp["block"]["max_bytes"]),
                        max_gas=int(cp["block"]["max_gas"]),
                    ),
                    evidence=EvidenceParams(
                        max_age_num_blocks=int(cp["evidence"]["max_age_num_blocks"]),
                        max_age_duration_ns=int(cp["evidence"]["max_age_duration"]),
                    ),
                )
            except Exception as e:  # try the next endpoint
                last_err = e
        raise RuntimeError(f"failed to fetch consensus params: {last_err}")
