"""Shared infrastructure for the banded tile-matmul formulations
(``mxu_modwt`` / ``mxu_butterfly`` / ``mxu_wpt`` / ``mxu_pyramid`` /
``mxu_dft``): one dot policy and one lane constant, so a change to the
precision policy lands in exactly one place. No backend routes to these
forms automatically; they are reached through explicit switches
(``ConvolutionMethod.MXU``, ``config.set_mxu_butterfly/set_mxu_dft("on")``).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

LANES = 128


def dot(a, w, precision):
    """Last-axis x first-axis matmul with f32 accumulation for narrow
    dtypes (f64 stays f64 — the CPU correctness gates run the tile paths
    in full double via the config dial)."""
    return lax.dot_general(
        a, w, (((a.ndim - 1,), (0,)), ((), ())),
        precision=precision,
        preferred_element_type=a.dtype if a.dtype == jnp.float64 else jnp.float32,
    )

