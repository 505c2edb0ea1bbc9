"""PyTorch/CUDA port of halo_tpu for NVIDIA Hopper GPUs.

A package of its own beside ``halo_tpu`` (the JAX reference): it imports
torch and never jax, flax, optax or anything of ``halo_tpu``. Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
