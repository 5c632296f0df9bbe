"""Launchers of the port (counterpart of src/repro/launch)."""
