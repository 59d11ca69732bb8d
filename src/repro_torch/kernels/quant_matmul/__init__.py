"""int8 GEMM kernel: CUDA (``cuda.py``), plain PyTorch (``ref.py``),
entry points and the quantized face NN (``ops.py``)."""
