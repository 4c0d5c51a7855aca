"""Distributed 1D FFT over a device mesh (four-step / Bailey algorithm).

The reference has no distributed execution at all (SURVEY.md §2.6); its FFT
convolutions (MODWTTransform.java:752-786) are single-JVM. This module is
the layer that lets FFT-convolution transforms run with the *time axis
sharded across devices* — each device holds only N/D samples, so signals
larger than one device's memory become tractable, and every exchange is
an XLA ``all_to_all``.

Algorithm (N = D * L, device axis D, local length L, requiring D | L):

  forward  x (contiguous-sharded) -> X in the "(D, L) spectrum layout"
    1. reshuffle: one all_to_all converts contiguous chunks to the
       stride-D decimated layout  A[d, j2] = x[d + D*j2]
    2. local length-L FFT over j2          B[d, k2]
    3. twiddle  C[d, k2] = B[d, k2] * exp(-2i*pi*d*k2/N)
    4. transpose: one all_to_all so device i holds C[:, i-th k2 block]
    5. local length-D FFT over the d axis  -> X[k2 + L*k1]

  The result is the full spectrum *reshaped row-major to (D, L) and
  column-sharded*: G[k1, k2] = X[k1*L + k2], device i holding k2 block i.
  Because that is a plain reshape of the natural order, frequency-domain
  filters precomputed on the host need only ``.reshape(D, L)`` to align —
  no index permutation anywhere.

  inverse reverses the five steps with conjugate twiddles and 1/N scaling.

Cost per direction: two all_to_alls of N/D complex elements per chip plus
O((N/D) log N) local FLOPs — the textbook lower bound for a transposed
distributed FFT.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..exceptions import JWaveFailure


def _check_geometry(n: int, n_dev: int, who: str):
    if n % n_dev:
        raise JWaveFailure(f"{who} - length {n} must divide over {n_dev} devices")
    l = n // n_dev
    if l % n_dev:
        raise JWaveFailure(
            f"{who} - needs local length divisible by the device count "
            f"(N >= D^2 with D | L); got N={n}, D={n_dev}, L={l}"
        )
    # twiddle/frequency index products reach N; without x64 they are int32
    if not jax.config.jax_enable_x64 and n >= (1 << 31):
        raise JWaveFailure(
            f"{who} - length {n} overflows int32 frequency indices; enable "
            "jax_enable_x64 for signals this large"
        )


def _cfft_axis(z, axis: int, inverse: bool = False):
    """Complex FFT (or inverse) along an arbitrary axis."""
    return (jnp.fft.ifft if inverse else jnp.fft.fft)(z, axis=axis)


# ---------------------------------------------------------------------------
# local (inside-shard_map) pieces — reusable by other sharded transforms
# ---------------------------------------------------------------------------

def pfft_local(x_loc, axis_name: str):
    """Forward four-step FFT body. ``x_loc``: (..., L) local contiguous chunk
    of a length-N=D*L signal (real or complex). Returns the local (..., D,
    L/D) block of the (D, L) spectrum layout (this device's k2 columns)."""
    n_dev = lax.axis_size(axis_name)
    l = x_loc.shape[-1]
    n = n_dev * l
    lead = x_loc.shape[:-1]
    cdtype = jnp.complex128 if x_loc.dtype in (jnp.float64, jnp.complex128) else jnp.complex64
    x_loc = x_loc.astype(cdtype)

    if n_dev == 1:
        # degenerate mesh: the (1, L) layout is the plain spectrum — skip the
        # collectives and the length-1 device-axis FFT
        return _cfft_axis(x_loc, axis=-1)[..., None, :]

    # 1. contiguous -> stride-D decimated: local (L,) -> (L/D, D) -> (D, L/D),
    #    exchange; received rows (ordered by source) concatenate to A[d, :].
    m = jnp.swapaxes(x_loc.reshape(lead + (l // n_dev, n_dev)), -1, -2)
    m = lax.all_to_all(m, axis_name, split_axis=m.ndim - 2, concat_axis=m.ndim - 2, tiled=True)
    a = m.reshape(lead + (l,))  # A[d, j2] for d = this device

    # 2. local length-L FFT
    b = _cfft_axis(a, axis=-1)

    # 3. twiddle exp(-2i pi d k2 / N)
    d = lax.axis_index(axis_name)
    k2 = jnp.arange(l)
    tw = jnp.exp(jnp.asarray(-2j * np.pi / n, dtype=cdtype) * (d * k2).astype(cdtype))
    c = b * tw

    # 4. transpose so this device holds all d for its k2 block
    t = c.reshape(lead + (n_dev, l // n_dev))
    t = lax.all_to_all(t, axis_name, split_axis=t.ndim - 2, concat_axis=t.ndim - 2, tiled=True)

    # 5. local length-D FFT over the source-device axis
    return _cfft_axis(t, axis=-2)  # (..., D, L/D)


def pifft_local(g_loc, axis_name: str):
    """Inverse four-step FFT body. ``g_loc``: (..., D, L/D) local block of
    the (D, L) spectrum layout. Returns the local (..., L) contiguous chunk
    of the length-N time-domain signal (complex; take .real for real
    signals)."""
    n_dev = lax.axis_size(axis_name)
    l = g_loc.shape[-1] * n_dev
    n = n_dev * l
    lead = g_loc.shape[:-2]

    if n_dev == 1:
        return _cfft_axis(g_loc[..., 0, :], axis=-1, inverse=True)

    # 5'. local inverse FFT over k1
    t = _cfft_axis(g_loc, axis=-2, inverse=True)  # C[:, this k2 block]

    # 4'. transpose back: device d reassembles C[d, :]
    t = lax.all_to_all(t, axis_name, split_axis=t.ndim - 2, concat_axis=t.ndim - 2, tiled=True)
    c = t.reshape(lead + (l,))

    # 3'. conjugate twiddle
    d = lax.axis_index(axis_name)
    k2 = jnp.arange(l)
    tw = jnp.exp(jnp.asarray(2j * np.pi / n, dtype=c.dtype) * (d * k2).astype(c.dtype))
    b = c * tw

    # 2'. local inverse length-L FFT
    a = _cfft_axis(b, axis=-1, inverse=True)  # A[d, j2] = x[d + D*j2]

    # 1'. stride-D decimated -> contiguous
    m = a.reshape(lead + (n_dev, l // n_dev))
    m = lax.all_to_all(m, axis_name, split_axis=m.ndim - 2, concat_axis=m.ndim - 2, tiled=True)
    return jnp.swapaxes(m, -1, -2).reshape(lead + (l,))


# ---------------------------------------------------------------------------
# public sharded entry points
# ---------------------------------------------------------------------------

import functools


@functools.lru_cache(maxsize=64)
def _cached_pfft(mesh: Mesh, axis_name: str, ndim: int):
    """One jitted shard_map per (mesh, axis, rank) — a fresh closure per
    call would retrace+recompile every invocation. jit's own cache handles
    varying shapes/dtypes under it."""
    lead = (None,) * (ndim - 1)
    mapped = shard_map(
        lambda v: pfft_local(v, axis_name),
        mesh=mesh, in_specs=P(*lead, axis_name), out_specs=P(*lead, None, axis_name),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _cached_pifft(mesh: Mesh, axis_name: str, ndim: int):
    lead = (None,) * (ndim - 2)
    mapped = shard_map(
        lambda g: pifft_local(g, axis_name),
        mesh=mesh, in_specs=P(*lead, None, axis_name), out_specs=P(*lead, axis_name),
    )
    return jax.jit(mapped)


def pfft(signal, mesh: Mesh, axis_name: str | None = None):
    """Distributed FFT along the last axis of a (..., N) signal batch, the
    time axis sharded over ``mesh`` (leading batch axes replicated — shard
    them separately with :func:`batch_sharded` layouts if desired).

    Returns the full spectrum as a global (..., D, N/D) array — the
    row-major reshape of ``jnp.fft.fft(signal, axis=-1)`` — sharded over its
    *columns* (``PartitionSpec(..., None, axis)``). Use ``.reshape(-1)`` on
    a gathered copy to recover natural order, or feed it straight to
    :func:`pifft`.
    """
    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    signal = jnp.asarray(signal)
    if signal.ndim < 1:
        raise JWaveFailure("pfft - expects at least a 1D signal")
    _check_geometry(signal.shape[-1], n_dev, "pfft")

    return _cached_pfft(mesh, axis_name, signal.ndim)(signal)


def pifft(spectrum, mesh: Mesh, axis_name: str | None = None):
    """Inverse of :func:`pfft`: (..., D, N/D) column-sharded spectrum layout
    back to the (..., N) time-domain signal (contiguous-sharded, complex)."""
    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    spectrum = jnp.asarray(spectrum)
    if spectrum.ndim < 2 or spectrum.shape[-2] != n_dev:
        raise JWaveFailure(f"pifft - expects a (..., {n_dev}, N/{n_dev}) spectrum layout")
    _check_geometry(spectrum.shape[-2] * spectrum.shape[-1], n_dev, "pifft")

    return _cached_pifft(mesh, axis_name, spectrum.ndim)(spectrum)


# ---------------------------------------------------------------------------
# distributed 2D FFT: row shards + all_to_all transpose (natural-order out)
# ---------------------------------------------------------------------------

def pfft2_local(x_loc, axis_name: str, inverse: bool = False):
    """2D FFT body on a row-sharded block: ``x_loc`` (..., M/D, N) ->
    (..., M/D, N) block of the *natural-order* 2D spectrum (row-sharded).

    Local FFT along the resident N axis, one all_to_all to own a column
    chunk, local FFT along the (now resident) M axis, one all_to_all back —
    each element crosses the interconnect exactly twice.
    """
    n_dev = lax.axis_size(axis_name)
    cdtype = jnp.complex128 if x_loc.dtype in (jnp.float64, jnp.complex128) else jnp.complex64
    b = _cfft_axis(x_loc.astype(cdtype), axis=-1, inverse=inverse)
    if n_dev == 1:
        return _cfft_axis(b, axis=-2, inverse=inverse)
    lead = b.shape[:-2]
    nl = len(lead)
    m_loc, n = b.shape[-2:]
    t = b.reshape(lead + (m_loc, n_dev, n // n_dev))
    t = lax.all_to_all(t, axis_name, split_axis=nl + 1, concat_axis=nl)  # (..., D, M/D, n/D)
    t = t.reshape(lead + (n_dev * m_loc, n // n_dev))  # (..., M, n/D)
    t = _cfft_axis(t, axis=-2, inverse=inverse)
    t = t.reshape(lead + (n_dev, m_loc, n // n_dev))
    t = lax.all_to_all(t, axis_name, split_axis=nl, concat_axis=nl + 1)  # (..., M/D, D, n/D)
    return t.reshape(lead + (m_loc, n))


@functools.lru_cache(maxsize=64)
def _cached_pfft2(mesh: Mesh, axis_name: str, ndim: int, inverse: bool):
    lead = (None,) * (ndim - 2)
    spec = P(*lead, axis_name, None)
    mapped = shard_map(
        lambda v: pfft2_local(v, axis_name, inverse),
        mesh=mesh, in_specs=spec, out_specs=spec,
    )
    return jax.jit(mapped)


def _pfft2_common(mat, mesh, axis_name, inverse, who):
    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    mat = jnp.asarray(mat)
    if mat.ndim < 2:
        raise JWaveFailure(f"{who} - expects a (..., M, N) matrix")
    m, n = mat.shape[-2:]
    if m % n_dev or n % n_dev:
        raise JWaveFailure(
            f"{who} - matrix {m}x{n} must divide over {n_dev} devices on both axes"
        )
    if not jax.config.jax_enable_x64 and m * n >= (1 << 31):
        raise JWaveFailure(f"{who} - {m}x{n} overflows int32 indexing; enable jax_enable_x64")
    return _cached_pfft2(mesh, axis_name, mat.ndim, inverse)(mat)


def pfft2(mat, mesh: Mesh, axis_name: str | None = None):
    """Distributed 2D FFT of a (..., M, N) row-sharded matrix.

    Unlike the 1D four-step :func:`pfft`, the output is the full 2D
    spectrum in *natural order*, row-sharded exactly like the input — the
    transpose pair restores the layout, so downstream frequency-domain
    filters index it directly. Unnormalized forward (matches
    ``jnp.fft.fft2``)."""
    return _pfft2_common(mat, mesh, axis_name, False, "pfft2")


def pifft2(mat, mesh: Mesh, axis_name: str | None = None):
    """Inverse distributed 2D FFT (matches ``jnp.fft.ifft2``; complex out)."""
    return _pfft2_common(mat, mesh, axis_name, True, "pifft2")
