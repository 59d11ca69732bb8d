"""Bilateral-grid blur kernel: CUDA (``cuda.py``), plain PyTorch
(``ref.py``), dispatch by tensor device (``ops.py``)."""
