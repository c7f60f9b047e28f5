"""The handshake that syncs the app with the chain on boot (reference
consensus/replay.go:200): the port's copy of `Handshaker` and its null pools
from tendermint_tpu/consensus/replay.py.

ABCI Info, then the app height against the store and state heights, then
the stored blocks replayed into the app (exec_commit_block), for every crash
window:
- store == state == app: nothing to do;
- app behind: blocks app_height+1..store_height replayed into the app;
- store == state+1 (a crash between SaveBlock and ApplyBlock): the last
  block applied through a real executor, or, when the app already committed
  it, the state rebuilt from the saved ABCI responses by a mock app
  (reference consensus/replay.go:414).
The executor checks that block's LastCommit on `device` (None: the
reference's routing). The replay console is cli/main.py's `replay` and
`replay-console` commands.
"""

from __future__ import annotations

import dataclasses
import logging
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.state.execution import (
    BlockExecutor,
    exec_commit_block,
    validator_updates_from_abci,
)
from tendermint_tpu_torch.state.sm_state import State
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.validator_set import ValidatorSet

logger = logging.getLogger("tendermint_tpu_torch.consensus.replay")


class HandshakeError(Exception):
    pass


class _StoredResponsesApp(abci.Application):
    """Mock app that replays saved ABCI responses (reference:
    consensus/replay_stubs.go mockProxyApp)."""

    def __init__(self, app_hash: bytes, abci_responses):
        self.app_hash = app_hash
        self.responses = abci_responses
        self._tx_count = 0

    def deliver_tx(self, req):
        r = self.responses.deliver_txs[self._tx_count]
        self._tx_count += 1
        return r

    def end_block(self, req):
        return self.responses.end_block or abci.ResponseEndBlock()

    def commit(self):
        return abci.ResponseCommit(data=self.app_hash)


class _NullMempool:
    def lock(self):
        pass

    def unlock(self):
        pass

    def update(self, *a):
        pass

    def reap_max_bytes_max_gas(self, *a):
        return []


class _NullEvPool:
    def pending_evidence(self, mb):
        return []

    def check_evidence(self, state, ev):
        pass

    def update(self, state, ev):
        pass


class Handshaker:
    def __init__(
        self,
        state_store: StateStore,
        state: State,
        block_store,
        genesis: GenesisDoc,
        event_bus=None,
        device=None,
    ):
        self.device = device
        self.state_store = state_store
        self.initial_state = state
        self.block_store = block_store
        self.genesis = genesis
        self.event_bus = event_bus
        self.n_blocks = 0

    def handshake(self, proxy_app) -> State:
        """proxy_app: AppConns. Returns the synced state."""
        info = proxy_app.query.info(abci.RequestInfo(version="0.1.0"))
        app_height = info.last_block_height
        app_hash = info.last_block_app_hash
        if app_height < 0:
            raise HandshakeError(f"got a negative last block height ({app_height}) from the app")
        logger.info("ABCI handshake: app height %d hash %s", app_height, app_hash.hex()[:16])
        state = self.replay_blocks(self.initial_state, proxy_app, app_hash, app_height)
        logger.info("completed ABCI handshake: height %d", state.last_block_height)
        return state

    def replay_blocks(
        self, state: State, proxy_app, app_hash: bytes, app_height: int
    ) -> State:
        """(reference: consensus/replay.go:284 ReplayBlocks)"""
        store_height = self.block_store.height
        state_height = state.last_block_height

        # InitChain at genesis.
        if app_height == 0 and state_height == 0:
            validators = [
                abci.ValidatorUpdate(v.pub_key.type_name(), v.pub_key.bytes(), v.power)
                for v in self.genesis.validators
            ]
            res = proxy_app.consensus.init_chain(
                abci.RequestInitChain(
                    time_ns=self.genesis.genesis_time_ns,
                    chain_id=self.genesis.chain_id,
                    consensus_params=self.genesis.consensus_params,
                    validators=validators,
                    app_state_bytes=self.genesis.app_state,
                    initial_height=self.genesis.initial_height,
                )
            )
            if store_height == 0:
                updates = {}
                if res.app_hash:
                    updates["app_hash"] = res.app_hash
                if res.validators:
                    vals = validator_updates_from_abci(res.validators)
                    vs = ValidatorSet(vals)
                    updates["validators"] = vs
                    updates["next_validators"] = vs.copy_increment_proposer_priority(1)
                elif not self.genesis.validators:
                    raise HandshakeError("validator set is nil in genesis and still empty after InitChain")
                if res.consensus_params is not None:
                    updates["consensus_params"] = res.consensus_params
                if updates:
                    state = dataclasses.replace(state, **updates)
                self.state_store.save(state)
            app_hash = res.app_hash or app_hash

        if store_height == 0:
            return state

        if store_height < app_height:
            raise HandshakeError(
                f"app block height ({app_height}) is higher than the store ({store_height})"
            )
        if store_height < state_height:
            raise HandshakeError(
                f"store height ({store_height}) below state height ({state_height})"
            )
        if store_height > state_height + 1:
            raise HandshakeError(
                f"store height ({store_height}) more than one ahead of state ({state_height})"
            )

        if store_height == state_height:
            # replay into app only
            return self._replay_into_app(state, proxy_app, app_height, store_height, final_apply=False)

        # store_height == state_height + 1: crashed between SaveBlock and ApplyBlock
        if app_height == store_height:
            # app committed the last block but state didn't: recompute state
            # from saved ABCI responses without re-executing.
            return self._update_state_from_stored_responses(state, store_height, app_hash)
        # replay through app, applying the final block for real
        state = self._replay_into_app(state, proxy_app, app_height, store_height - 1, final_apply=False)
        return self._apply_stored_block(state, proxy_app, store_height)

    def _replay_into_app(
        self, state: State, proxy_app, app_height: int, end_height: int, final_apply: bool
    ) -> State:
        app_hash = b""
        for h in range(app_height + 1, end_height + 1):
            block = self.block_store.load_block(h)
            if block is None:
                raise HandshakeError(f"missing block {h} in store")
            logger.info("replaying block %d into app", h)
            app_hash = exec_commit_block(proxy_app.consensus, block, state)
            self.n_blocks += 1
        return state

    def _apply_stored_block(self, state: State, proxy_app, height: int) -> State:
        block = self.block_store.load_block(height)
        meta = self.block_store.load_block_meta(height)
        if block is None or meta is None:
            raise HandshakeError(f"missing block {height} in store")

        ex = BlockExecutor(
            self.state_store, proxy_app.consensus, _NullMempool(), _NullEvPool(),
            event_bus=self.event_bus, block_store=self.block_store, device=self.device,
        )
        self.n_blocks += 1
        return ex.apply_block(state, meta[0], block)

    def _update_state_from_stored_responses(self, state: State, height: int, app_hash: bytes) -> State:
        responses = self.state_store.load_abci_responses(height)
        if responses is None:
            raise HandshakeError(f"no saved ABCI responses for height {height}; cannot sync state")
        block = self.block_store.load_block(height)
        meta = self.block_store.load_block_meta(height)
        mock = _StoredResponsesApp(app_hash, responses)
        client = LocalClient(mock)

        ex = BlockExecutor(self.state_store, client, _NullMempool(), _NullEvPool(),
                           block_store=self.block_store, device=self.device)
        self.n_blocks += 1
        return ex.apply_block(state, meta[0], block)
