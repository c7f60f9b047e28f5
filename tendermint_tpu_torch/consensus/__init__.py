"""The consensus state machine, its messages, round state, WAL and the
handshake with the application (reference consensus/)."""
