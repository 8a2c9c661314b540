"""Launchers of the port: ``serve``, ``train`` and the ``mesh`` factories."""
