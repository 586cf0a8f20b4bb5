"""Fractal model (child frames, root frame)."""
