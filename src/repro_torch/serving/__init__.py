"""Serving of the port (``src/repro/serving``): the batched decode engine
and KV-cache sizing."""
