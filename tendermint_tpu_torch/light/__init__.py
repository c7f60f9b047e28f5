"""Light client: trust-minimized header verification, the port's copy of
tendermint_tpu/light/ (reference light/: client.go, verifier.go, store/,
provider/, detector.go), and the light service with its coalescer
(light/service.py, light/coalescer.py). The proxy (light/proxy.py) is
imported by its users, as in the reference.
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
    HTTPProvider,
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
