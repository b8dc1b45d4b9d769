"""Command-line launchers of the port (``python -m repro_torch.launch.<name>``),
and the meshes and batch / cache specs they run on (``mesh``, ``specs``)."""
