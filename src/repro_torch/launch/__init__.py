"""Command-line entry points of the port: ``python -m
repro_torch.launch.train`` and ``python -m repro_torch.launch.serve``.
Importing this package touches no device."""
