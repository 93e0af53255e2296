"""Models of the port (``src/repro/models``): every layer kind of the
reference, its layers, rotary embeddings, attention with the paper's kNN
decode attention, the serving step functions with the approx top-k
sampler, and the training step (loss, gradients, AdamW)."""
