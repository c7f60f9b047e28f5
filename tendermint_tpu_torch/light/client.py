"""Light client: trust-minimized header tracking, the port's copy of
tendermint_tpu/light/client.py (reference light/client.go: NewClient :113,
initializeWithTrustOptions :292, VerifyLightBlockAtHeight :415,
verifySequential :553, verifySkipping :643, backwards :860,
detectDivergence light/detector.go:33, replacePrimaryWithWitness :1018).

Every commit check runs through light/verifier.py on the Client's `device`
(None: the card), one flush a check: a bisection step over a 10k-validator
chain is two flushes, not 20,000 serial verifies.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import List, Optional

from tendermint_tpu_torch.light import verifier
from tendermint_tpu_torch.light.provider import Provider, ProviderError
from tendermint_tpu_torch.light.store import LightStore
from tendermint_tpu_torch.light.verifier import (
    DEFAULT_TRUST_LEVEL,
    ErrNewValSetCantBeTrusted,
    LightError,
)
from tendermint_tpu_torch.types.basic import NANOS
from tendermint_tpu_torch.types.light import LightBlock
from tendermint_tpu_torch.types.validator_set import Fraction

logger = logging.getLogger(__name__)

SEQUENTIAL = "sequential"
SKIPPING = "skipping"

DEFAULT_MAX_CLOCK_DRIFT_NS = 10 * NANOS  # reference: light/client.go:40
DEFAULT_PRUNING_SIZE = 1000  # reference: light/client.go:36


class ErrConflictingHeaders(LightError):
    """A witness reported a different header for a verified height —
    possible attack (reference: light/errors.go ErrConflictingHeaders)."""

    def __init__(self, witness_index: int, height: int):
        self.witness_index = witness_index
        self.height = height
        self.conflicting_blocks: list = []
        super().__init__(f"witness #{witness_index} has a different header at height {height}")


class ErrNoWitnesses(LightError):
    """reference: light/errors.go errNoWitnesses."""


@dataclass
class TrustOptions:
    """Subjective initialization root (reference: light/trust_options.go)."""

    period_ns: int
    height: int
    hash: bytes

    def validate(self) -> None:
        if self.period_ns <= 0:
            raise ValueError("negative or zero trusting period")
        if self.height <= 0:
            raise ValueError("negative or zero height")
        if len(self.hash) != 32:
            raise ValueError(f"expected hash size to be 32 bytes, got {len(self.hash)}")


def _now_ns() -> int:
    return time.time_ns()


class Client:
    """reference: light/client.go:113. `device` is where every commit check
    runs (None: the card; "cpu" on request)."""

    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: List[Provider],
        trusted_store: LightStore,
        verification_mode: str = SKIPPING,
        trust_level: Fraction = DEFAULT_TRUST_LEVEL,
        max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
        pruning_size: int = DEFAULT_PRUNING_SIZE,
        device=None,
    ):
        trust_options.validate()
        if verification_mode == SKIPPING:
            verifier.validate_trust_level(trust_level)
        elif verification_mode != SEQUENTIAL:
            raise ValueError(f"unknown verification mode {verification_mode!r}")
        self.chain_id = chain_id
        self.trust_options = trust_options
        self.primary = primary
        self.witnesses = list(witnesses)
        # Conflicting headers retained after divergence detection, for
        # operator inspection / evidence submission (see
        # _compare_with_witnesses).
        self.conflicting_blocks: list = []
        self.store = trusted_store
        self.mode = verification_mode
        self.trust_level = trust_level
        self.max_clock_drift_ns = max_clock_drift_ns
        self.pruning_size = pruning_size
        self.device = device
        self._lock = asyncio.Lock()
        self._initialized = False

    # ------------------------------------------------------------- lifecycle

    async def initialize(self, now_ns: Optional[int] = None) -> LightBlock:
        """Fetch + pin the root of trust (reference: light/client.go:292
        initializeWithTrustOptions); checks the stored root against the trust
        options on restart (reference: checkTrustedHeaderUsingOptions :237)."""
        now_ns = now_ns if now_ns is not None else _now_ns()
        async with self._lock:
            existing = self.store.light_block(self.trust_options.height)
            if existing is not None and existing.hash() == self.trust_options.hash:
                self._initialized = True
                return existing
            lb = await self.primary.light_block(self.trust_options.height)
            if lb.hash() != self.trust_options.hash:
                raise LightError(
                    f"expected header's hash {self.trust_options.hash.hex()}, "
                    f"but got {lb.hash().hex()}"
                )
            lb.validate_basic(self.chain_id)
            if verifier.header_expired(lb.signed_header, self.trust_options.period_ns, now_ns):
                raise verifier.ErrOldHeaderExpired(
                    lb.time_ns + self.trust_options.period_ns, now_ns
                )
            # The commit must actually be signed by +2/3 of its own valset.
            lb.validator_set.verify_commit_light(
                self.chain_id, lb.signed_header.commit.block_id, lb.height,
                lb.signed_header.commit, device=self.device,
            )
            await self._compare_with_witnesses(lb)
            self.store.save_light_block(lb)
            self._initialized = True
            return lb

    async def _ensure_initialized(self, now_ns: int) -> None:
        if not self._initialized:
            raise LightError("client not initialized — call initialize() first")

    # ------------------------------------------------------------ public API

    async def trusted_light_block(self, height: int) -> Optional[LightBlock]:
        return self.store.light_block(height)

    async def update(self, now_ns: Optional[int] = None) -> Optional[LightBlock]:
        """Verify the latest header from primary
        (reference: light/client.go:465 Update)."""
        now_ns = now_ns if now_ns is not None else _now_ns()
        latest = await self._fetch_from_primary(None)
        last = self.store.latest_light_block()
        if last is not None and latest.height <= last.height:
            return None
        return await self.verify_light_block(latest, now_ns)

    async def verify_light_block_at_height(
        self, height: int, now_ns: Optional[int] = None
    ) -> LightBlock:
        """reference: light/client.go:415 VerifyLightBlockAtHeight."""
        if height <= 0:
            raise ValueError("height must be positive")
        now_ns = now_ns if now_ns is not None else _now_ns()
        await self._ensure_initialized(now_ns)
        existing = self.store.light_block(height)
        if existing is not None:
            return existing
        lb = await self._fetch_from_primary(height)
        return await self.verify_light_block(lb, now_ns)

    async def verify_light_block(self, new_lb: LightBlock, now_ns: int) -> LightBlock:
        """Verify a light block obtained elsewhere
        (reference: light/client.go:497 VerifyHeader)."""
        await self._ensure_initialized(now_ns)
        async with self._lock:
            existing = self.store.light_block(new_lb.height)
            if existing is not None:
                if existing.hash() != new_lb.hash():
                    raise LightError(
                        f"existing trusted header {existing.hash().hex()} does not "
                        f"match new one {new_lb.hash().hex()} at height {new_lb.height}"
                    )
                return existing
            new_lb.validate_basic(self.chain_id)

            first = self.store.first_light_block()
            if first is not None and new_lb.height < first.height:
                await self._backwards(first, new_lb, now_ns)
            else:
                closest = self.store.light_block_before(new_lb.height + 1)
                if closest is None:
                    raise LightError("no trusted state to verify from")
                if self.mode == SEQUENTIAL:
                    await self._verify_sequential(closest, new_lb, now_ns)
                else:
                    await self._verify_skipping(closest, new_lb, now_ns)

            await self._compare_with_witnesses(new_lb)
            self.store.save_light_block(new_lb)
            self.store.prune(self.pruning_size)
            return new_lb

    # -------------------------------------------------------- verify drivers

    async def _verify_sequential(
        self, trusted: LightBlock, target: LightBlock, now_ns: int
    ) -> None:
        """Verify every height between trusted and target
        (reference: light/client.go:553 verifySequential)."""
        current = trusted
        for h in range(trusted.height + 1, target.height + 1):
            inter = target if h == target.height else await self._fetch_from_primary(h)
            verifier.verify_adjacent(
                self.chain_id,
                current.signed_header,
                inter.signed_header,
                inter.validator_set,
                self.trust_options.period_ns,
                now_ns,
                self.max_clock_drift_ns,
                device=self.device,
            )
            if h != target.height:
                self.store.save_light_block(inter)
            current = inter

    async def _verify_skipping(
        self, trusted: LightBlock, target: LightBlock, now_ns: int
    ) -> None:
        """Bisection (reference: light/client.go:643 verifySkipping): try a
        non-adjacent jump; when the trusted valset can't vouch (+1/3 overlap
        missing), bisect to the midpoint and retry."""
        current = trusted
        to_verify = [target]
        while to_verify:
            candidate = to_verify[-1]
            try:
                if candidate.height == current.height + 1:
                    verifier.verify_adjacent(
                        self.chain_id,
                        current.signed_header,
                        candidate.signed_header,
                        candidate.validator_set,
                        self.trust_options.period_ns,
                        now_ns,
                        self.max_clock_drift_ns,
                        device=self.device,
                    )
                else:
                    verifier.verify_non_adjacent(
                        self.chain_id,
                        current.signed_header,
                        current.validator_set,
                        candidate.signed_header,
                        candidate.validator_set,
                        self.trust_options.period_ns,
                        now_ns,
                        self.max_clock_drift_ns,
                        self.trust_level,
                        device=self.device,
                    )
            except ErrNewValSetCantBeTrusted:
                pivot = (current.height + candidate.height) // 2
                if pivot in (current.height, candidate.height):
                    raise LightError(
                        f"bisection stuck between heights {current.height} and "
                        f"{candidate.height}"
                    )
                mid = await self._fetch_from_primary(pivot)
                if mid.height != pivot:
                    raise LightError(
                        f"primary returned height {mid.height} for requested "
                        f"pivot {pivot}"
                    )
                to_verify.append(mid)
                continue
            # verified
            to_verify.pop()
            if candidate.height != target.height:
                self.store.save_light_block(candidate)
            current = candidate

    async def _backwards(
        self, first_trusted: LightBlock, target: LightBlock, now_ns: int
    ) -> None:
        """Walk the hash chain down from the first trusted header
        (reference: light/client.go:860 backwards)."""
        trusted = first_trusted
        for h in range(first_trusted.height - 1, target.height - 1, -1):
            inter = target if h == target.height else await self._fetch_from_primary(h)
            # validate_basic pins the block's valset to header.ValidatorsHash and
            # the commit to the header hash — without it a primary could attach
            # an attacker valset to a genuine header and poison the store.
            inter.validate_basic(self.chain_id)
            verifier.verify_backwards(
                self.chain_id, inter.signed_header, trusted.signed_header
            )
            if h != target.height:
                self.store.save_light_block(inter)
            trusted = inter

    # ------------------------------------------------------------- witnesses

    async def _compare_with_witnesses(self, lb: LightBlock) -> None:
        """Cross-check a verified header against all witnesses; a conflicting
        witness means a possible attack (reference: light/detector.go:33
        detectDivergence). Witnesses that don't respond are skipped; witnesses
        that conflict are removed and the error surfaced."""
        if not self.witnesses:
            return
        conflicts = []
        for i, w in enumerate(list(self.witnesses)):
            try:
                other = await w.light_block(lb.height)
            except ProviderError:
                continue
            if other.hash() != lb.hash():
                conflicts.append((i, w, other))
        if conflicts:
            # Keep the conflicting evidence available for operator
            # inspection (the reference builds LightClientAttackEvidence and
            # reports it to the honest providers, light/detector.go:116; we
            # record the diverging headers and surface them on the error).
            for i, w, other in conflicts:
                logger.error(
                    "witness %s reports conflicting header at height %d: "
                    "primary hash %s vs witness hash %s — possible light-client attack",
                    w,
                    lb.height,
                    lb.hash().hex(),
                    other.hash().hex(),
                )
                self.conflicting_blocks.append(other)
            for _, w, _other in conflicts:
                self.witnesses.remove(w)
            err = ErrConflictingHeaders(conflicts[0][0], lb.height)
            err.conflicting_blocks = [c[2] for c in conflicts]
            raise err

    async def _fetch_from_primary(self, height: Optional[int]) -> LightBlock:
        """Fetch from primary, replacing it with a witness on failure
        (reference: light/client.go:1004 lightBlockFromPrimary +
        :1018 replacePrimaryWithWitness)."""
        try:
            return await self.primary.light_block(height)
        except ProviderError as e:
            logger.warning("primary %s failed (%s); trying witnesses", self.primary, e)
            while self.witnesses:
                w = self.witnesses[0]
                try:
                    lb = await w.light_block(height)
                except ProviderError:
                    self.witnesses.pop(0)
                    continue
                # promote witness to primary; demote old primary to witness
                self.witnesses.pop(0)
                self.witnesses.append(self.primary)
                self.primary = w
                return lb
            raise ErrNoWitnesses(f"primary failed and no witness responded: {e}") from e

    # -------------------------------------------------------------- cleanup

    def first_trusted_height(self) -> Optional[int]:
        lb = self.store.first_light_block()
        return lb.height if lb else None

    def last_trusted_height(self) -> Optional[int]:
        lb = self.store.latest_light_block()
        return lb.height if lb else None
