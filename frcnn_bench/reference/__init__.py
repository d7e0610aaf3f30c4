"""The benchmark's plain reference of Faster R-CNN: float32 PyTorch with no
kernel, cache or batching trick of the measured program, and nothing
imported from it or from JAX."""
