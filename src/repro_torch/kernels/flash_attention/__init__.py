"""Causal / sliding-window flash attention: CUDA (``cuda.py``), plain
PyTorch (``ref.py``), dispatch by tensor device (``ops.py``)."""
