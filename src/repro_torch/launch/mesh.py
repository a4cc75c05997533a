"""Host mesh builder, re-exported from the canonical mesh module.

All mesh helpers (the host builder, the 1-D data mesh of the multi-device
paths, and the PartSpec partition arithmetic) live in
``repro_torch.core.mesh``; this module mirrors the reference's
``repro.launch.mesh`` shim for the launch stack. The reference's
``make_production_mesh`` (256 chips) belongs to launch analysis, ROADMAP
queue 1 item 16.
"""
from __future__ import annotations

from repro_torch.core.mesh import make_host_mesh

__all__ = ["make_host_mesh"]
