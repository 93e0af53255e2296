"""Models of the port (``src/repro/models``): the dense decoder kind, its
layers, rotary embeddings, attention with the paper's kNN decode
attention, and the serving step functions with the approx top-k
sampler."""
