"""Compute kernels: XLA convolution forms and banded tile-matmul variants.

These are the "native equivalents" of the reference's hand-tuned Java inner
loops: the shared analysis/synthesis butterfly (Wavelet.java:236-303) and the
MODWT circular convolutions (MODWTTransform.java:677-837), reformulated as
batched, statically-shaped XLA convolutions.
"""
from .butterfly import butterfly_forward, butterfly_reverse
from .circular import (
    circular_conv,
    circular_conv_adjoint,
    circular_conv_fft,
    circular_conv_adjoint_fft,
    wrap_filter,
)

__all__ = [
    "butterfly_forward",
    "butterfly_reverse",
    "circular_conv",
    "circular_conv_adjoint",
    "circular_conv_fft",
    "circular_conv_adjoint_fft",
    "wrap_filter",
]
