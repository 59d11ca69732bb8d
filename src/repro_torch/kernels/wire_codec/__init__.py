"""Offload wire codec: CUDA (``cuda.py``), plain PyTorch (``ref.py``),
dispatch by tensor device and wire-size accounting (``ops.py``)."""
