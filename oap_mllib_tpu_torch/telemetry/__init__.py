"""Telemetry of the port: the fleet rollups of a world's streamed passes."""
