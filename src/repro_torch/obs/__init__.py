"""Telemetry of the port (the ``--trace-dir`` summary so far)."""
