"""Production and host mesh builders, re-exported from the canonical mesh
module.

All mesh helpers (the production and host builders, the 1-D data mesh of
the multi-device paths, and the PartSpec partition arithmetic) live in
``repro_torch.core.mesh``; this module mirrors the reference's
``repro.launch.mesh`` shim for the launch stack. The builders need an
initialised process group: ``launch.dryrun`` starts a fake world of 256 or
512 ranks for the production mesh.
"""
from __future__ import annotations

from repro_torch.core.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
