"""Local AdaAlter in PyTorch and CUDA: the port of the JAX package ``repro``."""
