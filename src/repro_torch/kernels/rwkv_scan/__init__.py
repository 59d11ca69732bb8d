"""RWKV6 WKV recurrence from the zero state: CUDA (``cuda.py``), plain
PyTorch (``ref.py``), dispatch by tensor device (``ops.py``)."""
