"""Tensor primitives."""
