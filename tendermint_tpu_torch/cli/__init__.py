"""The command line (cli/main.py) and the abci-cli console
(cli/abci_console.py): the port's copy of tendermint_tpu/cli/."""
