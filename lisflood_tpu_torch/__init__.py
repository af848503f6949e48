"""LISFLOOD on PyTorch and CUDA.

A port of the JAX package `lisflood_tpu` to PyTorch, with the channel-routing
sub-step loop as a CUDA kernel written for Hopper (sm_90a). The module layout
and function names follow the JAX package so that each counterpart is easy to
find; the JAX package stays the reference the port is tested against.

Entry points take `device=` and `dtype=`. With `device=None` the device is
CUDA, and a machine without a CUDA device raises `RuntimeError`: the CPU is
used only when the caller asks for it (`device="cpu"`), as the tests do.
There is no global dtype switch; pass the dtype explicitly.
"""
from .device import resolve_device, to_device

__all__ = ["resolve_device", "to_device"]
