"""The mempool core (reference mempool/)."""
