"""Launchers (``python -m repro_torch.launch.serve`` / ``.train``), the
meshes (``launch.mesh``: the search mesh of the sharded layout and the
LM's meshes, across processes), and the LM's specs and steps on them
(``shardings``, ``input_specs``, ``steps``)."""
