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
- `light_block_from_reference_bytes`: the JAX package's
  `types/light.light_block_to_bytes` output -> a port LightBlock (a chain
  built in the reference, carried into the port by its bytes).
- `vote_from_reference`, `evidence_from_reference`, `block_from_reference`:
  a Vote, a DuplicateVoteEvidence or a Block of the JAX package -> the
  port's, through its canonical bytes (encoded there, decoded here).
- `validator_set_from_reference`: a ValidatorSet of the JAX package -> the
  port's, with each validator's key type, power, address and proposer
  priority, and the same proposer.
- `scheduler_config_from_reference`, `light_service_config_from_reference`,
  `slo_config_from_reference`: the JAX package's SchedulerConfig /
  LightServiceConfig / SLOConfig -> the port's config.py dataclasses, field
  by field; `consensus_config_from_reference` and
  `mempool_config_from_reference` likewise; `config_from_reference` the
  whole Config, every section.
- `signed_tx_from_reference`: a types/signed_tx.SignedTx of the JAX package
  -> the port's, field by field (the envelope bytes are shared as they are).
- `genesis_from_reference`, `state_from_reference`: a GenesisDoc or a State
  of the JAX package -> the port's, through the JSON both write alike.
- `proposal_from_reference`: a Proposal through its wire bytes.
- `file_pv_from_reference`: a FilePV with the same key, files and last-sign
  state.
- `proof_op_from_reference`: a crypto/proof_ops.ProofOp through its
  protobuf bytes.
- `node_key_from_reference`, `node_info_from_reference`,
  `bit_array_from_reference`: a p2p NodeKey (the same key, so the same
  node ID), a NodeInfo (through the handshake's wire bytes) and a
  libs/bits.BitArray (through its bytes).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.device import resolve
from tendermint_tpu_torch.types.light import light_block_from_bytes


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


# The port's types/light.py shares the JAX package's JSON codec field for
# field, so the reference's light_block_to_bytes output decodes as it is.
light_block_from_reference_bytes = light_block_from_bytes


def vote_from_reference(vote):
    from tendermint_tpu_torch.types.vote import Vote

    return Vote.decode(vote.encode())


def evidence_from_reference(ev):
    from tendermint_tpu_torch.types.evidence import decode_evidence

    return decode_evidence(ev.encode())


def block_from_reference(block):
    from tendermint_tpu_torch.types.block import Block

    return Block.decode(block.encode())


def validator_set_from_reference(vals):
    """The reference's objects are read, never imported: each validator's
    pub_key (type_name(), bytes()), voting_power, address and
    proposer_priority, and the proposer's address."""
    from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet

    out = ValidatorSet([
        Validator(pubkey_from_type_and_bytes(v.pub_key.type_name(), v.pub_key.bytes()),
                  v.voting_power, v.address, v.proposer_priority)
        for v in vals.validators])
    if vals.proposer is not None:
        out.proposer = out.get_by_address(vals.proposer.address)[1]
    return out


def _dataclass_from(cls, ref):
    from dataclasses import fields

    return cls(**{f.name: getattr(ref, f.name) for f in fields(cls)})


def scheduler_config_from_reference(ref):
    """A SchedulerConfig of the JAX package -> the port's, field by field."""
    from tendermint_tpu_torch.config import SchedulerConfig

    return _dataclass_from(SchedulerConfig, ref)


def light_service_config_from_reference(ref):
    """A LightServiceConfig of the JAX package -> the port's, field by field."""
    from tendermint_tpu_torch.config import LightServiceConfig

    return _dataclass_from(LightServiceConfig, ref)


def slo_config_from_reference(ref):
    """An SLOConfig of the JAX package -> the port's, field by field."""
    from tendermint_tpu_torch.config import SLOConfig

    return _dataclass_from(SLOConfig, ref)


def consensus_config_from_reference(ref):
    """A ConsensusConfig of the JAX package -> the port's, field by field."""
    from tendermint_tpu_torch.config import ConsensusConfig

    return _dataclass_from(ConsensusConfig, ref)


def mempool_config_from_reference(ref):
    """A MempoolConfig of the JAX package -> the port's, field by field."""
    from tendermint_tpu_torch.config import MempoolConfig

    return _dataclass_from(MempoolConfig, ref)


def config_from_reference(ref):
    """A whole Config of the JAX package -> the port's: every section field
    by field, and root_dir."""
    from dataclasses import fields

    from tendermint_tpu_torch.config import Config

    out = Config()
    for f in fields(Config):
        if f.name == "root_dir":
            out.root_dir = ref.root_dir
        else:
            setattr(out, f.name, _dataclass_from(type(getattr(out, f.name)), getattr(ref, f.name)))
    return out


def signed_tx_from_reference(env):
    from tendermint_tpu_torch.types.signed_tx import SignedTx

    return SignedTx(env.pubkey, env.signature, env.payload)


def genesis_from_reference(gen):
    """A GenesisDoc through its JSON, which both packages write and read
    alike."""
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    return GenesisDoc.from_json(gen.to_json())


def state_from_reference(state):
    """A State through the state store's JSON encoding."""
    from tendermint_tpu_torch.state.sm_state import State

    return State.from_json(state.to_json())


def proposal_from_reference(proposal):
    from tendermint_tpu_torch.types.proposal import Proposal

    return Proposal.decode(proposal.encode())


def file_pv_from_reference(pv):
    """A FilePV with the reference's key, files and last-sign state (read,
    not imported: priv_key.bytes() and last_sign_state's five fields)."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
    from tendermint_tpu_torch.privval.file_pv import FilePV, FilePVLastSignState

    out = FilePV(Ed25519PrivKey(pv.priv_key.bytes()), pv.key_file, None)
    s = pv.last_sign_state
    out.last_sign_state = FilePVLastSignState(s.height, s.round, s.step, s.signature,
                                              s.sign_bytes)
    out.state_file = pv.state_file
    return out


def proof_op_from_reference(op):
    """A ProofOp through its protobuf encoding (encoded there, decoded here)."""
    from tendermint_tpu_torch.crypto.proof_ops import ProofOp

    return ProofOp.decode(op.encode())


def node_key_from_reference(nk):
    """A p2p NodeKey with the same ed25519 key (read: priv_key.bytes())."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
    from tendermint_tpu_torch.p2p.key import NodeKey

    return NodeKey(Ed25519PrivKey(nk.priv_key.bytes()))


def node_info_from_reference(ni):
    """A NodeInfo through the bytes the transport's handshake exchanges."""
    from tendermint_tpu_torch.p2p.node_info import NodeInfo

    return NodeInfo.decode(ni.encode())


def bit_array_from_reference(ba):
    """A BitArray of the same size and bits, through to_bytes."""
    from tendermint_tpu_torch.libs.bits import BitArray

    return BitArray.from_bytes(ba.size(), ba.to_bytes())
