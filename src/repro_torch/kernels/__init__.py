"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``_build.launches`` counts the launches of each kernel."""
