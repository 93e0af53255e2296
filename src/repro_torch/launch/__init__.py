"""Command-line entry points of the port (``src/repro/launch``)."""
