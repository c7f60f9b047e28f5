"""Blocksync: the batched commit check of a run of downloaded blocks."""
