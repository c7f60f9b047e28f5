"""State sync: bootstrap a node from an app snapshot instead of replay.

reference: statesync/ — syncer.go, reactor.go, chunks.go, snapshots.go,
stateprovider.go. The port's copy of tendermint_tpu/statesync/; the light
checks of the state provider run where the node's other flushes run (the
host arm below 256 rows, the card above), and a device error on them
propagates instead of rejecting the snapshot (ROADMAP D1).
"""

from tendermint_tpu_torch.statesync.chunks import Chunk, ChunkQueue  # noqa: F401
from tendermint_tpu_torch.statesync.reactor import StatesyncReactor  # noqa: F401
from tendermint_tpu_torch.statesync.snapshots import Snapshot, SnapshotPool  # noqa: F401
from tendermint_tpu_torch.statesync.stateprovider import (  # noqa: F401
    LightClientStateProvider,
    StateProvider,
)
from tendermint_tpu_torch.statesync.syncer import (  # noqa: F401
    ErrNoSnapshots,
    SyncError,
    Syncer,
)
