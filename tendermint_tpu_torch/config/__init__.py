"""The port's configuration: config/config.py (the dataclass tree) and
config/toml.py (config.toml read and write). Every name of config.py is
re-exported here, so `from tendermint_tpu_torch.config import X` reads as
it did when the configuration was one module."""

from tendermint_tpu_torch.config.config import (  # noqa: F401
    BaseConfig,
    Config,
    ConsensusConfig,
    CryptoConfig,
    FastSyncConfig,
    InstrumentationConfig,
    LightServiceConfig,
    MempoolConfig,
    OverloadConfig,
    P2PConfig,
    RPCConfig,
    SchedulerConfig,
    SLOConfig,
    StateSyncConfig,
    default_config,
    test_config,
)
