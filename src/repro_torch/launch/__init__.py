"""Launchers: the serving entry point, ``python -m
repro_torch.launch.serve``, and the training entry point, ``python -m
repro_torch.launch.train``."""
