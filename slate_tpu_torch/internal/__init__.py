"""Internal layers of the port: precision tiers, masks, the CUDA kernels and their dispatch."""
