"""Builds and loads the hand-written CUDA kernels (``build.py``)."""
