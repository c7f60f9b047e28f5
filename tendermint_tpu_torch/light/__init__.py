"""Light client: trust-minimized header verification, the port's copy of
tendermint_tpu/light/ (reference light/: client.go, verifier.go, store/,
provider/, detector.go). The light service, its coalescer, the proxy and
HTTPProvider are not ported yet (ROADMAP A2, A8).
"""

from tendermint_tpu_torch.light.client import (  # noqa: F401
    Client,
    ErrConflictingHeaders,
    ErrNoWitnesses,
    SEQUENTIAL,
    SKIPPING,
    TrustOptions,
)
from tendermint_tpu_torch.light.provider import (  # noqa: F401
    ErrBadLightBlock,
    ErrLightBlockNotFound,
    ErrNoResponse,
    MockProvider,
    Provider,
)
from tendermint_tpu_torch.light.store import LightStore  # noqa: F401
from tendermint_tpu_torch.light.verifier import (  # noqa: F401
    DEFAULT_TRUST_LEVEL,
    ErrInvalidHeader,
    ErrNewValSetCantBeTrusted,
    ErrOldHeaderExpired,
    LightError,
    verify,
    verify_adjacent,
    verify_backwards,
    verify_non_adjacent,
)
