"""Core mechanisms of the port: cascades with capacity compaction and the
quantization primitives."""
