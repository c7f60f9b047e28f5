"""ABCI: the application interface (types, the in-process client and the
kvstore app), the port's copy of tendermint_tpu/abci/."""
