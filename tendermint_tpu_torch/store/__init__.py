"""The block store (reference store/)."""
