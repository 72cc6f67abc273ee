"""Checkpoint bridges of the port."""
from .convert import from_jax, params_from_jax

__all__ = ["from_jax", "params_from_jax"]
