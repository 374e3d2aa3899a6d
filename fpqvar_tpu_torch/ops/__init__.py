"""Quantization math, rotation, resizing and the kernel wrappers."""
