"""Checkpoints of the port: the JAX weight bridge and torch checkpoint files."""
from .convert import from_jax, params_from_jax
from .torch_io import load_pth_tar

__all__ = ["from_jax", "params_from_jax", "load_pth_tar"]
