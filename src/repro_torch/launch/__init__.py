"""Launchers: the mesh factory, the multi-pod dry-run (``python -m
repro_torch.launch.dryrun``), training (``python -m
repro_torch.launch.train``) and serving (``python -m
repro_torch.launch.serve``).  Importing this package touches no process
group."""
from repro_torch.launch.mesh import (ici_links, make_mesh,
                                     make_production_mesh, mesh_num_chips)
