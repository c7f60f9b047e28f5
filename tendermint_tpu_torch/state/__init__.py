"""The replicated state, its store and the block executor (reference state/)."""
