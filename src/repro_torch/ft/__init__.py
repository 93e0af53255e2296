"""Fault tolerance of the port (``src/repro/ft``): the straggler policy
the trainer consults, and elastic re-meshing (``ft/elastic.py``)."""
from repro_torch.ft.elastic import choose_mesh_shape, remesh_state, survivors_mesh
from repro_torch.ft.straggler import Action, StragglerPolicy

__all__ = ["Action", "StragglerPolicy", "choose_mesh_shape", "remesh_state",
           "survivors_mesh"]
