"""The node's connections to its application (reference proxy/)."""
