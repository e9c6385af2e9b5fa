"""Neural network modules: encoder, VQ codebook, GRU loops, vocoder."""
