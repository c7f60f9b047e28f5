"""BlockExecutor, the only writer of state (reference state/execution.go:25):
the port's copy of tendermint_tpu/state/execution.py.

apply_block (reference state/execution.go:126-201): validate, run the txs
on the app (BeginBlock, DeliverTx each, EndBlock), save the ABCI responses,
update the validators (effective at H+2) and the params, app Commit with
the mempool locked and then updated, evidence update, save the state, fire
the events, prune to the retain height. The fail points sit at the
reference's four ordering points (state/execution.go:143,150,181,189).

validate_block checks the last commit with
`state.last_validators.verify_commit(..., device=self.device)`: the batched
flush of crypto/batch.py, on the card from 256 rows when `device` is None
(the reference's routing), on the plain kernels for `device="cpu"`. A
commit made from votes a deferred VoteSet flush already verified is
answered from the verified-row memo. The node hands it the state metrics
(`metrics=`: block_processing_time) and the tx tracker (`tx_tracker=`: the
delivered stage).
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import List, Sequence, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import ABCIClient
from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes
from tendermint_tpu_torch.libs import fail
from tendermint_tpu_torch.state.sm_state import State, results_hash
from tendermint_tpu_torch.state.store import ABCIResponses, StateStore
from tendermint_tpu_torch.types.basic import BlockID
from tendermint_tpu_torch.types.block import Block, Commit
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.validator_set import Validator

logger = logging.getLogger("tendermint_tpu_torch.state")


class BlockValidationError(Exception):
    pass


def validator_updates_from_abci(updates: Sequence[abci.ValidatorUpdate]) -> List[Validator]:
    out = []
    for u in updates:
        pk = pubkey_from_type_and_bytes(u.pub_key_type, u.pub_key_bytes)
        out.append(Validator(pk, u.power))
    return out


class BlockExecutor:
    def __init__(
        self,
        state_store: StateStore,
        proxy_app: ABCIClient,  # the consensus connection
        mempool,
        evidence_pool,
        event_bus=None,
        block_store=None,
        metrics=None,
        tx_tracker=None,
        device=None,
    ):
        """device: where validate_block's commit checks run (None: the
        reference's routing, the card from 256 rows). metrics:
        libs/metrics.StateMetrics (block_processing_time); tx_tracker:
        libs/txtrace.TxTracker (each tracked tx's terminal `delivered`)."""
        self.device = device
        self.metrics = metrics
        self.tx_tracker = tx_tracker
        self.state_store = state_store
        self.proxy_app = proxy_app
        self.mempool = mempool
        self.evpool = evidence_pool
        self.event_bus = event_bus
        self.block_store = block_store

    # -- proposal creation (reference: state/execution.go:94) ---------------

    def create_proposal_block(
        self, height: int, state: State, commit: Commit, proposer_addr: bytes, time_ns: int
    ) -> Block:
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence = self.evpool.pending_evidence(state.consensus_params.evidence.max_bytes) if self.evpool else []
        # leave room for header/commit/evidence (reference: types.MaxDataBytes)
        data_max = max_bytes - 2048 - len(evidence) * 512
        txs = self.mempool.reap_max_bytes_max_gas(data_max, max_gas)
        return state.make_block(height, txs, commit, evidence, proposer_addr, time_ns)

    # -- validation (reference: state/validation.go:15) ---------------------

    def validate_block(self, state: State, block: Block, trust_last_commit: bool = False) -> None:
        """trust_last_commit=True skips the LastCommit signature check (all
        structural checks still run) — used by fast sync, whose pool already
        verified the same signatures in a cross-block device batch. The
        reference re-verifies here (state/validation.go:15 after
        VerifyCommitLight in the v0 reactor); skipping the duplicate work is a
        deliberate improvement, safe because the batch covered +2/3 power."""
        block.validate_basic()
        h = block.header
        if h.version != state.version:
            raise BlockValidationError(f"wrong Block.Header.Version. Expected {state.version}, got {h.version}")
        if h.chain_id != state.chain_id:
            raise BlockValidationError(f"wrong Block.Header.ChainID. Expected {state.chain_id}, got {h.chain_id}")
        expected_height = state.last_block_height + 1 if state.last_block_height > 0 else state.initial_height
        if h.height != expected_height:
            raise BlockValidationError(f"wrong Block.Header.Height. Expected {expected_height}, got {h.height}")
        if h.last_block_id != state.last_block_id:
            raise BlockValidationError("wrong Block.Header.LastBlockID")
        if h.app_hash != state.app_hash:
            raise BlockValidationError("wrong Block.Header.AppHash")
        if h.consensus_hash != state.consensus_params.hash():
            raise BlockValidationError("wrong Block.Header.ConsensusHash")
        if h.last_results_hash != state.last_results_hash:
            raise BlockValidationError("wrong Block.Header.LastResultsHash")
        if h.validators_hash != state.validators.hash():
            raise BlockValidationError("wrong Block.Header.ValidatorsHash")
        if h.next_validators_hash != state.next_validators.hash():
            raise BlockValidationError("wrong Block.Header.NextValidatorsHash")

        # LastCommit verification — the batched hot path.
        if block.header.height == state.initial_height:
            if block.last_commit.size() != 0:
                raise BlockValidationError("initial block can't have LastCommit signatures")
        else:
            if state.last_validators is None:
                raise BlockValidationError("no last validators to verify commit")
            if not trust_last_commit:
                state.last_validators.verify_commit(
                    state.chain_id, state.last_block_id, block.header.height - 1, block.last_commit,
                    device=self.device,
                )
            elif block.last_commit.block_id != state.last_block_id or (
                block.last_commit.height != block.header.height - 1
            ):
                raise BlockValidationError("wrong LastCommit block id/height")

        if not state.validators.has_address(h.proposer_address):
            raise BlockValidationError("block proposer is not in the validator set")

        # evidence checks
        if self.evpool is not None:
            for ev in block.evidence:
                self.evpool.check_evidence(state, ev)

    # -- the apply pipeline -------------------------------------------------

    def apply_block(
        self, state: State, block_id: BlockID, block: Block, trust_last_commit: bool = False
    ) -> State:
        """(reference: state/execution.go:126 ApplyBlock)"""
        import time as _time

        _t0 = _time.perf_counter()
        try:
            return self._apply_block(state, block_id, block, trust_last_commit)
        finally:
            if self.metrics is not None:
                self.metrics.block_processing_time.observe(_time.perf_counter() - _t0)

    def _apply_block(
        self, state: State, block_id: BlockID, block: Block, trust_last_commit: bool = False
    ) -> State:
        self.validate_block(state, block, trust_last_commit=trust_last_commit)

        abci_responses = self._exec_block_on_proxy_app(state, block)

        fail.fail_point("save_abci_responses")
        self.state_store.save_abci_responses(block.header.height, abci_responses)
        fail.fail_point("after_save_abci_responses")

        end = abci_responses.end_block
        validator_updates = validator_updates_from_abci(end.validator_updates) if end else []

        new_state = self._update_state(state, block_id, block, abci_responses, validator_updates)

        # Lock mempool, commit app state, update mempool (reference:
        # state/execution.go:204 Commit).
        app_hash, retain_height = self._commit(new_state, block, abci_responses.deliver_txs)

        # Update evidence pool with the new committed state.
        if self.evpool is not None:
            self.evpool.update(new_state, block.evidence)

        fail.fail_point("before_save_state")
        new_state = replace(new_state, app_hash=app_hash)
        self.state_store.save(new_state)
        fail.fail_point("after_save_state")

        # Events + pruning
        if self.event_bus is not None:
            self._fire_events(block, block_id, abci_responses, validator_updates)
        if retain_height > 0 and self.block_store is not None:
            try:
                pruned = self.block_store.prune_blocks(retain_height)
                self.state_store.prune_states(retain_height)
                logger.info("pruned blocks", extra={"pruned": pruned, "retain_height": retain_height})
            except Exception as e:  # pruning failures must not kill consensus
                logger.error("failed to prune blocks: %s", e)
        return new_state

    def _exec_block_on_proxy_app(self, state: State, block: Block) -> ABCIResponses:
        """BeginBlock → DeliverTx×N → EndBlock (reference: state/execution.go:255)."""
        commit_info = self._last_commit_info(state, block)
        byz = self._byzantine_validators(block)
        begin = self.proxy_app.begin_block(
            abci.RequestBeginBlock(
                hash=block.hash(),
                header=block.header,
                last_commit_info=commit_info,
                byzantine_validators=byz,
            )
        )
        deliver_txs: List[abci.ResponseDeliverTx] = []
        invalid = 0
        deliver_async = getattr(self.proxy_app, "deliver_tx_async", None)
        if deliver_async is not None and block.txs:
            # pipelined delivery: queue every tx before waiting on responses,
            # FIFO-matched by the socket client (reference:
            # state/execution.go:308 DeliverTxAsync)
            futures = [deliver_async(abci.RequestDeliverTx(tx=tx)) for tx in block.txs]
            flush = getattr(self.proxy_app, "flush", None)
            if flush is not None:
                flush()
            results = [f.result(timeout=60) for f in futures]
        else:
            results = [
                self.proxy_app.deliver_tx(abci.RequestDeliverTx(tx=tx)) for tx in block.txs
            ]
        for res in results:
            if res.code != abci.CODE_TYPE_OK:
                invalid += 1
            deliver_txs.append(res)
        tt = self.tx_tracker
        if tt is not None and tt.enabled and block.txs:
            # tracked journeys end here with the app's verdict; foreign txs
            # (blocks synced from elsewhere) were never `received` and are
            # skipped inside record_delivered
            tt.record_delivered(block.header.height, block.txs, deliver_txs)
        end = self.proxy_app.end_block(abci.RequestEndBlock(height=block.header.height))
        if invalid:
            logger.info("executed block with %d invalid txs", invalid)
        return ABCIResponses(deliver_txs=deliver_txs, begin_block=begin, end_block=end)

    def _last_commit_info(self, state: State, block: Block) -> abci.LastCommitInfo:
        votes: List[Tuple[bytes, int, bool]] = []
        if block.header.height > state.initial_height and state.last_validators is not None:
            for i, val in enumerate(state.last_validators.validators):
                signed = False
                if i < len(block.last_commit.signatures):
                    signed = not block.last_commit.signatures[i].absent()
                votes.append((val.address, val.voting_power, signed))
        return abci.LastCommitInfo(round=block.last_commit.round, votes=votes)

    def _byzantine_validators(self, block: Block) -> List[abci.EvidenceABCI]:
        out = []
        for ev in block.evidence:
            if isinstance(ev, DuplicateVoteEvidence):
                out.append(
                    abci.EvidenceABCI(
                        type=1,
                        validator_address=ev.address(),
                        validator_power=ev.validator_power,
                        height=ev.height,
                        time_ns=ev.timestamp_ns,
                        total_voting_power=ev.total_voting_power,
                    )
                )
        return out

    def _update_state(
        self,
        state: State,
        block_id: BlockID,
        block: Block,
        abci_responses: ABCIResponses,
        validator_updates: List[Validator],
    ) -> State:
        """(reference: state/execution.go:403 updateState)"""
        height = block.header.height
        n_valset = state.next_validators.copy()
        last_height_vals_changed = state.last_height_validators_changed
        if validator_updates:
            n_valset.update_with_change_set(validator_updates)
            last_height_vals_changed = height + 1 + 1  # effective H+2
        n_valset.increment_proposer_priority(1)

        params = state.consensus_params
        last_height_params_changed = state.last_height_consensus_params_changed
        end = abci_responses.end_block
        if end is not None and end.consensus_param_updates is not None:
            params = end.consensus_param_updates
            params.validate_basic()
            last_height_params_changed = height + 1

        return State(
            chain_id=state.chain_id,
            initial_height=state.initial_height,
            last_block_height=height,
            last_block_id=block_id,
            last_block_time_ns=block.header.time_ns,
            next_validators=n_valset,
            validators=state.next_validators.copy(),
            last_validators=state.validators.copy(),
            last_height_validators_changed=last_height_vals_changed,
            consensus_params=params,
            last_height_consensus_params_changed=last_height_params_changed,
            last_results_hash=results_hash(abci_responses.deliver_txs),
            app_hash=b"",  # set after Commit
            version=state.version,
        )

    def _commit(self, state: State, block: Block, deliver_txs) -> Tuple[bytes, int]:
        """(reference: state/execution.go:204 Commit)"""
        self.mempool.lock()
        try:
            fail.fail_point("before_app_commit")
            res = self.proxy_app.commit()
            fail.fail_point("after_app_commit")
            self.mempool.update(block.header.height, list(block.txs), list(deliver_txs))
            return res.data, res.retain_height
        finally:
            self.mempool.unlock()

    def _fire_events(self, block, block_id, abci_responses, validator_updates) -> None:
        self.event_bus.publish_new_block(block, block_id, abci_responses)
        for i, tx in enumerate(block.txs):
            self.event_bus.publish_tx(block.header.height, i, tx, abci_responses.deliver_txs[i])
        if validator_updates:
            self.event_bus.publish_validator_set_updates(validator_updates)


def exec_commit_block(proxy_app: ABCIClient, block: Block, state: State, store=None) -> bytes:
    """Replay helper: execute + commit a block against the app without
    touching state (reference: state/execution.go:529 ExecCommitBlock)."""

    class _NullMempool:
        def lock(self):
            pass

        def unlock(self):
            pass

        def update(self, *a, **k):
            pass

        def reap_max_bytes_max_gas(self, *a):
            return []

    ex = BlockExecutor.__new__(BlockExecutor)
    ex.proxy_app = proxy_app
    ex.mempool = _NullMempool()
    # handshake replay re-delivers already-committed blocks; their journeys
    # (if any) ended long ago: never re-stamp them
    ex.tx_tracker = None
    responses = ex._exec_block_on_proxy_app(state, block)
    res = proxy_app.commit()
    del responses
    return res.data
