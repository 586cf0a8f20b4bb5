"""Tensor ops of the render path, plus the kernel wrappers."""
