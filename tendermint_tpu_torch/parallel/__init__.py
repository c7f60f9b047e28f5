"""Multi-device verification: the sharded mesh (parallel/sharded.py), its
telemetry (parallel/telemetry.py) and its health model (parallel/health.py)."""
