"""The port's BlockExecutor, evidence pool and FilePV against the JAX
package's, on the same seeded inputs (tolerance 0): proposal blocks,
apply_block's state (with validator updates), app and results hashes and
store bytes, validate_block's rejections, the evidence pool's add, check and
pending lists, and the private validator's signatures and double-sign
guard. The executor's commit checks run on the port's host arm
(device="cpu", 4 rows).
"""

import dataclasses
import os

import pytest

from tendermint_tpu_torch import convert
from tests.test_torch_consensus_util import Pkg, seeds

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

REF, PORT = Pkg("ref"), Pkg("port")
SEED = 20261021
CHAIN = "exec-chain"
TS = 1_700_000_500_000_000_000
TXS = [b"a=1", b"b=2", b"c", b"dd=44"]
NEW_VAL = seeds(1, SEED + 9)[0]


def _setup(P, val_updates: bool = False):
    """Genesis of 4 validators through the Handshaker, a kvstore app (with
    validator updates at height 1 if asked), a mempool holding TXS, and the
    executor."""
    A = P.abci
    keys = seeds(4, SEED)

    class App(P.kvstore.KVStoreApplication):
        def end_block(self, req):
            if not val_updates or req.height != 1:
                return A.ResponseEndBlock()
            vals = self.vals
            return A.ResponseEndBlock(validator_updates=[
                A.ValidatorUpdate("ed25519", P.keys.gen_ed25519(NEW_VAL).pub_key().bytes(), 5),
                A.ValidatorUpdate("ed25519", vals[1].pub_key.bytes(), 30)])

    gen = P.genesis.GenesisDoc(chain_id=CHAIN, genesis_time_ns=TS - 10**9, validators=[
        P.genesis.GenesisValidator(P.keys.gen_ed25519(k).pub_key(), 10) for k in keys])
    gen.validate_and_complete()
    state = P.sm_state.state_from_genesis(gen)
    app = App()
    app.vals = state.validators.validators
    proxy = P.multi.AppConns(P.multi.local_client_creator(app))
    store = P.state_store.StateStore(P.kvdb.MemDB())
    bs = P.blockstore.BlockStore(P.kvdb.MemDB())
    store.save(state)
    state = P.replay.Handshaker(store, state, bs, gen).handshake(proxy)
    mp = P.mempool.Mempool(proxy.mempool)
    for tx in TXS:
        mp.check_tx(tx)
    evpool = P.evidence_pool.EvidencePool(P.kvdb.MemDB(), store, bs)
    evpool.set_state(state)
    kw = {"device": "cpu"} if P is PORT else {}
    ex = P.execution.BlockExecutor(store, proxy.consensus, mp, evpool, block_store=bs, **kw)
    by_addr = {P.keys.gen_ed25519(k).pub_key().address(): k for k in keys}
    privs = [by_addr[v.address] for v in state.validators.validators]
    return dict(P=P, state=state, ex=ex, store=store, bs=bs, app=app, mp=mp, evpool=evpool,
                privs=privs)


def _commit(env, block, parts, bad=()):
    """Every validator's precommit for the block, signed with the
    reference's keys (OpenSSL); rows in `bad` get a flipped byte."""
    P = env["P"]
    bid = P.basic.BlockID(block.hash(), parts.header)
    vals = env["state"].validators.validators
    stub = P.block.Commit(block.header.height, 0, bid, [
        P.block.CommitSig(P.basic.BlockIDFlag.COMMIT, v.address, TS + i, b"")
        for i, v in enumerate(vals)])
    sigs = []
    for i, seed in enumerate(env["privs"]):
        sig = REF.keys.gen_ed25519(seed).sign(stub.vote_sign_bytes(CHAIN, i))
        sigs.append(sig[:3] + bytes([sig[3] ^ 1]) + sig[4:] if i in bad else sig)
    return P.block.Commit(stub.height, 0, bid, [
        dataclasses.replace(cs, signature=s) for cs, s in zip(stub.signatures, sigs)])


def _height(env, h, commit, time_ns):
    P, st = env["P"], env["state"]
    block = env["ex"].create_proposal_block(h, st, commit, st.validators.validators[0].address,
                                            time_ns)
    return block, P.part_set.PartSet.from_data(block.encode())


def _run(P, val_updates: bool):
    env = _setup(P, val_updates)
    out = []
    empty = P.block.Commit(0, 0, P.basic.BlockID(), ())
    block, parts = _height(env, 1, empty, TS)
    out.append(block.encode())
    env["ex"].validate_block(env["state"], block)
    st = env["ex"].apply_block(env["state"], P.basic.BlockID(block.hash(), parts.header), block)
    env["bs"].save_block(block, parts, _commit(env, block, parts))
    out += [st.to_json(), st.app_hash, st.last_results_hash, env["app"].app_hash,
            sorted(env["store"].db.iterate_prefix(b"")), env["mp"].size()]
    commit = _commit(env, block, parts)
    env["state"] = st
    block2, parts2 = _height(env, 2, commit, TS + 10**9)
    out.append(block2.encode())
    st2 = env["ex"].apply_block(st, P.basic.BlockID(block2.hash(), parts2.header), block2)
    out += [st2.to_json(), st2.app_hash, sorted(env["store"].db.iterate_prefix(b""))]
    return out


@pytest.mark.parametrize("val_updates", [False, True])
def test_proposal_blocks_and_apply_block(val_updates):
    """Two heights: create_proposal_block's bytes, apply_block's state
    JSON (validators effective at H+2), app hash, results hash, the state
    store's bytes and the mempool after update; the second height's
    LastCommit verified on the port's host arm."""
    assert _run(PORT, val_updates) == _run(REF, val_updates)


def _reject(P, case):
    env = _setup(P)
    empty = P.block.Commit(0, 0, P.basic.BlockID(), ())
    block, parts = _height(env, 1, empty, TS)
    st = env["ex"].apply_block(env["state"], P.basic.BlockID(block.hash(), parts.header), block)
    env["state"] = st
    commit = _commit(env, block, parts, bad=(1, 2) if case == "bad_last_commit_sig" else ())
    block2, _ = _height(env, 2, commit, TS + 10**9)
    if case == "wrong_height":
        block2 = st.make_block(3, block2.txs, commit, (), block2.header.proposer_address,
                               TS + 10**9)
    elif case == "wrong_app_hash":
        block2 = dataclasses.replace(block2, header=dataclasses.replace(
            block2.header, app_hash=b"\x5a" * 8))
    with pytest.raises(Exception) as e:
        env["ex"].validate_block(st, block2)
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("case", ["bad_last_commit_sig", "wrong_height", "wrong_app_hash"])
def test_validate_block_rejections(case):
    got, want = _reject(PORT, case), _reject(REF, case)
    assert got == want
    assert got[0] == ("CommitVerifyError" if case == "bad_last_commit_sig"
                      else "BlockValidationError"), got


def _evidence_run(P):
    env = _setup(P)
    st, vals = env["state"], env["state"].validators
    out = []

    def conflicting(idx, height, tamper=False):
        jv = []
        for h in (b"\x21", b"\x43"):
            v = REF.vote.Vote(type=REF.basic.SignedMsgType.PREVOTE, height=height, round=0,
                              block_id=REF.basic.BlockID(h * 32, REF.basic.PartSetHeader(
                                  1, h * 32)),
                              timestamp_ns=TS, validator_address=vals.validators[idx].address,
                              validator_index=idx)
            sig = REF.keys.gen_ed25519(env["privs"][idx]).sign(v.sign_bytes(CHAIN))
            jv.append(v.with_signature(sig[:-1] + bytes([sig[-1] ^ 1]) if tamper else sig))
        ev = REF.evidence.DuplicateVoteEvidence.from_votes(
            jv[0], jv[1], TS - 10**9, vals.total_voting_power(), 10)
        return ev if P is REF else convert.evidence_from_reference(ev)

    pool = env["evpool"]
    for idx, tamper in ((2, False), (3, False), (1, True)):
        ev = conflicting(idx, 1, tamper)
        try:
            pool.add_evidence(ev)
            out.append(("added", pool.is_pending(ev)))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    out.append([e.encode() for e in pool.pending_evidence(-1)])
    out.append([e.encode() for e in pool.pending_evidence(700)])
    ev = conflicting(0, 1)
    pool.add_evidence_from_consensus(ev, TS, vals)
    out.append([e.encode() for e in pool.pending_evidence(-1)])
    committed = conflicting(2, 1)
    pool.update(st, [committed])
    out += [pool.is_committed(committed), pool.is_pending(committed),
            [e.encode() for e in pool.pending_evidence(-1)]]
    for case in (committed, conflicting(1, 1, tamper=True)):
        try:
            pool.check_evidence(st, case)
            out.append("ok")
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    block = env["ex"].create_proposal_block(1, st, P.block.Commit(0, 0, P.basic.BlockID(), ()),
                                            vals.validators[0].address, TS)
    out.append(block.encode())
    return out


def test_evidence_pool_add_check_and_pending():
    assert _evidence_run(PORT) == _evidence_run(REF)


def _pv_run(P, tmp):
    seed = seeds(1, SEED + 3)[0]
    os.makedirs(tmp, exist_ok=True)
    pv = P.file_pv.FilePV.generate(os.path.join(tmp, "key.json"), os.path.join(tmp, "state.json"),
                                   seed=seed)
    T = P.basic.SignedMsgType
    bid = P.basic.BlockID(b"\x61" * 32, P.basic.PartSetHeader(2, b"\x62" * 32))
    other = P.basic.BlockID(b"\x71" * 32, P.basic.PartSetHeader(2, b"\x72" * 32))
    addr = pv.get_pub_key().address()
    out = []

    def vote(t, h, r, b, ts):
        return P.vote.Vote(type=t, height=h, round=r, block_id=b, timestamp_ns=ts,
                           validator_address=addr, validator_index=0)

    def attempt(fn):
        try:
            res = fn()
            out.append(res.encode())
        except Exception as e:
            out.append((type(e).__name__, str(e)))

    prop = P.proposal.Proposal(3, 0, -1, bid, TS)
    attempt(lambda: pv.sign_proposal(CHAIN, prop))
    attempt(lambda: pv.sign_proposal(CHAIN, dataclasses.replace(prop, timestamp_ns=TS + 5)))
    attempt(lambda: pv.sign_proposal(CHAIN, dataclasses.replace(prop, block_id=other)))
    attempt(lambda: pv.sign_vote(CHAIN, vote(T.PREVOTE, 3, 0, bid, TS)))
    attempt(lambda: pv.sign_vote(CHAIN, vote(T.PREVOTE, 3, 0, bid, TS)))  # identical: re-sign
    attempt(lambda: pv.sign_vote(CHAIN, vote(T.PREVOTE, 3, 0, bid, TS + 77)))  # timestamp only
    attempt(lambda: pv.sign_vote(CHAIN, vote(T.PREVOTE, 3, 0, other, TS)))  # double sign
    attempt(lambda: pv.sign_vote(CHAIN, vote(T.PRECOMMIT, 3, 0, bid, TS)))
    attempt(lambda: pv.sign_vote(CHAIN, vote(T.PREVOTE, 3, 0, bid, TS)))  # step regression
    attempt(lambda: pv.sign_vote(CHAIN, vote(T.PREVOTE, 2, 5, bid, TS)))  # height regression
    attempt(lambda: pv.sign_vote(CHAIN, vote(T.PREVOTE, 3, 1, P.basic.BlockID(), TS)))
    for name in ("key.json", "state.json"):
        with open(os.path.join(tmp, name)) as f:
            out.append(f.read())
    again = P.file_pv.FilePV.load(os.path.join(tmp, "key.json"), os.path.join(tmp, "state.json"))
    attempt(lambda: again.sign_vote(CHAIN, vote(T.PREVOTE, 3, 1, other, TS)))
    return out, pv


def test_file_pv_signatures_and_double_sign_guard(tmp_path):
    got, _ = _pv_run(PORT, str(tmp_path / "p"))
    want, jpv = _pv_run(REF, str(tmp_path / "j"))
    assert got == want
    assert sum(isinstance(x, tuple) and x[0] == "DoubleSignError" for x in got) == 5
    carried = convert.file_pv_from_reference(jpv)
    T = PORT.basic.SignedMsgType
    v = PORT.vote.Vote(type=T.PREVOTE, height=3, round=1, block_id=PORT.basic.BlockID(),
                       timestamp_ns=TS + 9, validator_address=carried.get_pub_key().address(),
                       validator_index=0)
    assert carried.sign_vote(CHAIN, v).timestamp_ns == TS  # the reference's last vote, re-signed
