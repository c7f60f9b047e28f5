"""Node assembly (reference node/): node.py builds a standalone Node, and
overload.py its overload controller; the port's copy of tendermint_tpu/node/."""
