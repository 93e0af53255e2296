"""Retrieval of the port (``src/repro/retrieval``): the kNN-LM datastore."""
