"""Launchers of the port (so far: ``serve``)."""
