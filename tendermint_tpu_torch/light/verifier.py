"""Stateless light-client verification: the port's copy of
tendermint_tpu/light/verifier.py (reference light/verifier.go:
VerifyNonAdjacent :32, VerifyAdjacent :95, Verify :139, VerifyBackwards
:160, verifyNewHeaderAndVals :176, HeaderExpired :210).

Both commit checks are types/validator_set.py's batched light checks, each
one flush over the commit's rows. verify_non_adjacent submits the trusting
check and the light check before it finishes either, so both flushes are
queued on the card before the host syncs. Every entry takes `device=None`
(the card) and passes it down; errors and messages are the JAX package's.
"""

from __future__ import annotations

from tendermint_tpu_torch.types.light import SignedHeader
from tendermint_tpu_torch.types.validator_set import (
    CommitVerifyError,
    Fraction,
    NotEnoughVotingPowerError,
    ValidatorSet,
)

# 1/3 — the default trust level (reference: light/trust_options.go,
# DefaultTrustLevel light/verifier.go:21)
DEFAULT_TRUST_LEVEL = Fraction(1, 3)


class LightError(Exception):
    pass


class ErrOldHeaderExpired(LightError):
    """Trusted header is outside the trusting period
    (reference: light/errors.go ErrOldHeaderExpired)."""

    def __init__(self, expired_at_ns: int, now_ns: int):
        self.expired_at_ns = expired_at_ns
        self.now_ns = now_ns
        super().__init__(f"old header has expired at {expired_at_ns} (now: {now_ns})")


class ErrNewValSetCantBeTrusted(LightError):
    """< trust-level of the trusted valset signed the new header — the caller
    should bisect (reference: light/errors.go ErrNewValSetCantBeTrusted)."""


class ErrInvalidHeader(LightError):
    """New header can't be trusted for a non-recoverable reason."""


def validate_trust_level(level: Fraction) -> None:
    """reference: light/verifier.go:222 ValidateTrustLevel — must be in (1/3, 1]."""
    if (
        level.numerator * 3 < level.denominator
        or level.numerator > level.denominator
        or level.denominator == 0
    ):
        raise ValueError(f"trustLevel must be within (1/3, 1], given {level}")


def header_expired(h: SignedHeader, trusting_period_ns: int, now_ns: int) -> bool:
    """reference: light/verifier.go:210 HeaderExpired."""
    return h.header.time_ns + trusting_period_ns <= now_ns


def _verify_new_header_and_vals(
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusted: SignedHeader,
    now_ns: int,
    max_clock_drift_ns: int,
) -> None:
    """reference: light/verifier.go:176 verifyNewHeaderAndVals."""
    try:
        untrusted.validate_basic(trusted.header.chain_id)
    except ValueError as e:
        raise ErrInvalidHeader(f"untrusted header invalid: {e}") from e

    if untrusted.height <= trusted.height:
        raise ErrInvalidHeader(
            f"expected new header height {untrusted.height} to be greater than "
            f"one of old header {trusted.height}"
        )
    if untrusted.header.time_ns <= trusted.header.time_ns:
        raise ErrInvalidHeader(
            f"expected new header time {untrusted.header.time_ns} to be after "
            f"old header time {trusted.header.time_ns}"
        )
    if untrusted.header.time_ns >= now_ns + max_clock_drift_ns:
        raise ErrInvalidHeader(
            f"new header has a time from the future {untrusted.header.time_ns} "
            f"(now: {now_ns}; max clock drift: {max_clock_drift_ns})"
        )
    vh = untrusted_vals.hash()
    if untrusted.header.validators_hash != vh:
        raise ErrInvalidHeader(
            f"expected new header validators ({untrusted.header.validators_hash.hex()}) "
            f"to match those supplied ({vh.hex()})"
        )


def verify_non_adjacent(
    chain_id: str,
    trusted: SignedHeader,
    trusted_next_vals: ValidatorSet,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    device=None,
) -> None:
    """Skipping verification (reference: light/verifier.go:32 VerifyNonAdjacent).

    Trusts the new header if +trust_level of the *trusted* valset signed it
    (batched verify_commit_light_trusting) AND +2/3 of the new valset signed it
    (batched verify_commit_light)."""
    if untrusted.height == trusted.height + 1:
        raise ValueError("headers must be non adjacent in height")
    if header_expired(trusted, trusting_period_ns, now_ns):
        raise ErrOldHeaderExpired(trusted.header.time_ns + trusting_period_ns, now_ns)
    _verify_new_header_and_vals(untrusted, untrusted_vals, trusted, now_ns, max_clock_drift_ns)

    # Both checks are submitted before either is synced: their flushes are
    # independent, so both are queued on the card before the host waits
    # (Go runs them one after the other, light/verifier.go:56,80).
    try:
        fin_trusting = trusted_next_vals.begin_verify_commit_light_trusting(
            chain_id, untrusted.commit, trust_level, device=device
        )
        fin_light = untrusted_vals.begin_verify_commit_light(
            chain_id, untrusted.commit.block_id, untrusted.height, untrusted.commit,
            device=device,
        )
    except CommitVerifyError as e:
        raise ErrInvalidHeader(f"invalid commit: {e}") from e

    try:
        fin_trusting()
    except NotEnoughVotingPowerError as e:
        # recoverable: the caller should bisect (reference: light/verifier.go:73)
        raise ErrNewValSetCantBeTrusted(str(e)) from e
    except CommitVerifyError as e:
        # any other commit defect (double vote, malformed sig) is terminal
        raise ErrInvalidHeader(f"invalid commit: {e}") from e

    try:
        fin_light()
    except CommitVerifyError as e:
        raise ErrInvalidHeader(f"invalid commit: {e}") from e


def verify_adjacent(
    chain_id: str,
    trusted: SignedHeader,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int,
    device=None,
) -> None:
    """Sequential verification (reference: light/verifier.go:95 VerifyAdjacent).

    The new valset is pinned by the trusted header's NextValidatorsHash."""
    if untrusted.height != trusted.height + 1:
        raise ValueError("headers must be adjacent in height")
    if header_expired(trusted, trusting_period_ns, now_ns):
        raise ErrOldHeaderExpired(trusted.header.time_ns + trusting_period_ns, now_ns)
    _verify_new_header_and_vals(untrusted, untrusted_vals, trusted, now_ns, max_clock_drift_ns)

    if untrusted.header.validators_hash != trusted.header.next_validators_hash:
        raise ErrInvalidHeader(
            f"expected old header next validators "
            f"({trusted.header.next_validators_hash.hex()}) to match those from "
            f"new header ({untrusted.header.validators_hash.hex()})"
        )

    try:
        untrusted_vals.verify_commit_light(
            chain_id, untrusted.commit.block_id, untrusted.height, untrusted.commit,
            device=device,
        )
    except CommitVerifyError as e:
        raise ErrInvalidHeader(f"invalid commit: {e}") from e


def verify(
    chain_id: str,
    trusted: SignedHeader,
    trusted_next_vals: ValidatorSet,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    device=None,
) -> None:
    """Dispatch on adjacency (reference: light/verifier.go:139 Verify)."""
    if untrusted.height != trusted.height + 1:
        verify_non_adjacent(
            chain_id, trusted, trusted_next_vals, untrusted, untrusted_vals,
            trusting_period_ns, now_ns, max_clock_drift_ns, trust_level, device=device,
        )
    else:
        verify_adjacent(
            chain_id, trusted, untrusted, untrusted_vals,
            trusting_period_ns, now_ns, max_clock_drift_ns, device=device,
        )


def verify_backwards(chain_id: str, untrusted: SignedHeader, trusted: SignedHeader) -> None:
    """Verify an older header against a trusted newer one via the hash chain
    (reference: light/verifier.go:160 VerifyBackwards)."""
    if untrusted.header.chain_id != chain_id:
        raise ErrInvalidHeader("header belongs to another chain")
    if untrusted.header.time_ns >= trusted.header.time_ns:
        raise ErrInvalidHeader(
            f"expected older header time {untrusted.header.time_ns} to be before "
            f"newer header time {trusted.header.time_ns}"
        )
    if untrusted.hash() != trusted.header.last_block_id.hash:
        raise ErrInvalidHeader(
            f"older header hash {untrusted.hash().hex()} does not match trusted "
            f"header's last block {trusted.header.last_block_id.hash.hex()}"
        )
