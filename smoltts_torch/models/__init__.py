"""DualAR model pieces: dimensions, init, embeddings, heads and layers."""
