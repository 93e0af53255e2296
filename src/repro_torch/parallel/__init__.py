"""Multi-device layout of the port: a mesh of torch devices
(:mod:`repro_torch.parallel.mesh`)."""
from repro_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
