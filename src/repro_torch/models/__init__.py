"""The LM stack: layers, attention, RWKV6, model assembly."""
