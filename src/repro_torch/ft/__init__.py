"""Fault tolerance of the port (``src/repro/ft``): the straggler policy
the trainer consults.  ``ft/elastic.py`` (re-meshing) comes with the
mesh rules."""
from repro_torch.ft.straggler import Action, StragglerPolicy

__all__ = ["Action", "StragglerPolicy"]
