"""Launchers (``python -m repro_torch.launch.serve`` / ``.train``) and the
search mesh of the sharded layout across processes (``launch.mesh``)."""
