"""Multi-device telemetry and health (parallel/telemetry.py, parallel/health.py).
The sharded mesh itself is ROADMAP A6."""
