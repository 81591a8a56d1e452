"""PyTorch and CUDA port of the JAX package ``repro`` (see README.md)."""
