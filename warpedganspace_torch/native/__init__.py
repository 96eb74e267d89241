"""Native (C++) host code of the port.

Counterpart of :mod:`warpedganspace_tpu.native`: greedy NMS for the SFD
detector (``sfd_post.cpp``), built with ``g++`` at first use and bound with
ctypes. Without a toolchain :func:`load_native` returns None and the detector
runs its numpy NMS, as the JAX package does.
"""

from warpedganspace_torch.native.build import load_native, native_error

__all__ = ["load_native", "native_error"]
