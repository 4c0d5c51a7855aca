"""SPMD sharded transforms over a device mesh.

Communication patterns (all expressed as XLA collectives so they lower to
device-to-device transfers, not host round trips):

  * ``all_to_all`` — distributed transpose for separable 2D transforms
    (the scalable analog of the reference's row/column ForkJoinPool
    decorator, ParallelTransform.java:70-126);
  * ``ppermute`` — neighbor halo exchange of filter-support samples for
    time-sharded MODWT (SURVEY.md §5.7: same structure as ring attention
    but with tiny, fixed halos because wavelet filters have compact
    support);
  * none at all — CWT scales and signal batches shard embarrassingly
    (the reference's parallel-stream-over-scales,
    ContinuousWaveletTransform.java:511-565, with zero synchronization).
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

from .. import config as _config
from ..exceptions import JWaveFailure
from ..cwavelets import get_continuous_wavelet
from ..transforms.cwt import CWTResult, PaddingType, _omega_axis, pad_signal
from ..transforms.fwt import fwt, ifwt
from ..transforms.wpt import wpt, iwpt
from ..transforms.modwt import _level_filters, _validate_level
from ..utils.numerics import next_power_of_two


# --------------------------------------------------------------------------
# jit cache: one compiled shard_map program per configuration
# --------------------------------------------------------------------------
# Building a fresh shard_map closure + jax.jit wrapper on every call forces a
# retrace/recompile each invocation.
# Every sharded entry point below therefore builds its jitted program once
# per hashable configuration key and reuses it.

from collections import OrderedDict

_SHARDED_JIT_CACHE: OrderedDict = OrderedDict()
_SHARDED_JIT_MAX = 256  # bounded: each entry pins a compiled XLA executable


def _dial_key():
    """Global numeric dials that are baked into a traced program; they must
    be part of every cache key or a dial change would silently reuse stale
    programs compiled under the old setting."""
    return (_config.conv_precision(), _config.mxu_butterfly())


def _get_or_build(key, builder):
    key = key + _dial_key()
    fn = _SHARDED_JIT_CACHE.get(key)
    if fn is None:
        fn = _SHARDED_JIT_CACHE[key] = builder()
        if len(_SHARDED_JIT_CACHE) > _SHARDED_JIT_MAX:
            _SHARDED_JIT_CACHE.popitem(last=False)
    else:
        _SHARDED_JIT_CACHE.move_to_end(key)
    return fn


_FB_INTERN: dict = {}


def _fb_key(wavelet):
    """Value-key for a filter bank: the coefficient bytes, not the name —
    a custom FilterBank that shares a builtin's name must neither reuse nor
    poison the builtin's compiled program. Interns the resolved bank so
    cached builders can close over the exact coefficients."""
    from ..filters import get_filter

    fb = get_filter(wavelet)
    key = (fb.name, fb.dec_lo.tobytes(), fb.dec_hi.tobytes(),
           fb.rec_lo.tobytes(), fb.rec_hi.tobytes(), float(fb.recon_gain))
    _FB_INTERN.setdefault(key, fb)
    return key


def _wav_key(wav):
    """Hashable value-key for a continuous wavelet instance (name alone is
    not enough: Morlet(fb,fc)/Paul(m)/DOG(n,sigma) carry parameters).
    Arrays hash by content; unknown attribute types fall back to repr()
    (id-based for plain objects), which can only miss cache reuse, never
    alias two distinct wavelets onto one program."""
    def coerce(v):
        if isinstance(v, (bool, int, float, str, bytes)):
            return v
        if isinstance(v, np.ndarray):
            return ("nd", v.dtype.str, v.shape, v.tobytes())
        if isinstance(v, (np.integer, np.floating)):
            return v.item()
        return repr(v)

    try:
        attrs = vars(wav).items()
    except TypeError:  # __slots__ classes
        attrs = ((k, getattr(wav, k)) for k in dir(wav)
                 if not k.startswith("_") and not callable(getattr(wav, k)))
    return (type(wav).__name__,) + tuple(sorted((k, coerce(v)) for k, v in attrs))


# --------------------------------------------------------------------------
# batch sharding (pure data parallelism)
# --------------------------------------------------------------------------

def batch_sharded(fn, mesh: Mesh, axis_name: str | None = None):
    """Wrap ``fn(x)`` so the leading axis of input/output shards across the
    mesh. Zero communication — each chip transforms its own signals."""
    axis_name = axis_name or mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis_name))

    @jax.jit
    def run(x):
        x = lax.with_sharding_constraint(x, sharding)
        return lax.with_sharding_constraint(fn(x), sharding)

    return run


# --------------------------------------------------------------------------
# CWT: scales sharded across chips (embarrassing)
# --------------------------------------------------------------------------

def cwt_scale_sharded(
    signal,
    scales,
    wavelet,
    mesh: Mesh,
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
    axis_name: str | None = None,
) -> CWTResult:
    """FFT-based CWT with the scales axis sharded over the mesh.

    The signal FFT is computed once and replicated; each chip evaluates its
    own block of wavelet spectra and inverse FFTs — the SPMD analog of the
    reference's parallel stream over scales with a shared signal FFT
    (ContinuousWaveletTransform.java:511-565), but with the scale loop as a
    sharded tensor axis instead of a thread pool.
    """
    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    wav = get_continuous_wavelet(wavelet)
    scales = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    if scales.shape[0] % n_dev != 0:
        raise JWaveFailure(
            f"cwt_scale_sharded - number of scales {scales.shape[0]} must divide "
            f"evenly over {n_dev} devices"
        )
    n = signal.shape[-1]
    padded_len = next_power_of_two(n)
    lead = signal.ndim - 1
    fs = float(sampling_rate)

    def _build():
        omega = jnp.asarray(_omega_axis(padded_len, fs))

        def _local(sig_fft, scales_loc):
            a = scales_loc[:, None]
            w_hat = jnp.conj(wav.psi_hat_scaled(omega[None, :], a))
            return jnp.fft.ifft(sig_fft[..., None, :] * w_hat, axis=-1)[..., :n]

        out_spec = P(*([None] * lead), axis_name, None)
        mapped = shard_map(
            _local, mesh=mesh,
            in_specs=(P(), P(axis_name)),
            out_specs=out_spec,
        )

        @jax.jit
        def run(sig, sc):
            sig_fft = jnp.fft.fft(pad_signal(sig, padded_len, padding), axis=-1)
            return mapped(sig_fft, sc)

        return run

    run = _get_or_build(
        ("cwt_scale", mesh, axis_name, _wav_key(wav), n, lead, fs, padding), _build
    )
    coeffs = run(jnp.asarray(signal), jnp.asarray(scales))
    time_axis = jnp.arange(n) / sampling_rate
    return CWTResult(coeffs, jnp.asarray(scales), time_axis, float(sampling_rate), wav.name)


def ssq_scale_sharded(
    signal,
    scales,
    wavelet,
    mesh: Mesh,
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
    frequencies=None,
    gamma: float | None = None,
    out_of_range: str = "clip",
    reassign: str = "auto",
    axis_name: str | None = None,
):
    """Synchrosqueezed CWT with the scales axis sharded over the mesh.

    Each chip evaluates its own block of wavelet spectra + derivative
    spectra, squeezes that block into the FULL (replicated) frequency-bin
    grid, and one ``psum`` merges the per-chip planes — reassignment is a
    per-scale scatter, so the bins simply add across chips. The default
    |W| threshold needs the global coefficient maximum, obtained with a
    ``pmax`` (the only other collective on this path). Matches
    :func:`jwave_tpu.ssq_cwt` exactly (same weights, same grid).
    """
    from ..transforms.ssq import SSQResult, _default_bins, _log_measure, _squeeze_plane

    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    wav = get_continuous_wavelet(wavelet)
    if not wav.is_analytic:
        raise JWaveFailure(
            f"ssq_scale_sharded - synchrosqueezing needs an analytic wavelet "
            f"(Morlet, Paul, Morse); got {wav.name!r}"
        )
    scales_np = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    if scales_np.shape[0] % n_dev != 0:
        raise JWaveFailure(
            f"ssq_scale_sharded - number of scales {scales_np.shape[0]} must "
            f"divide evenly over {n_dev} devices"
        )
    if scales_np.shape[0] < 2:
        raise JWaveFailure("ssq_scale_sharded - need at least 2 scales")
    freqs_np = _default_bins(scales_np, wav.center_frequency, frequencies)
    # the log measure needs neighbor scales, so it is computed on the GLOBAL
    # grid and sharded alongside the scales
    wgt_np = scales_np ** -0.5 * _log_measure(scales_np)
    n = signal.shape[-1]
    padded_len = next_power_of_two(n)
    lead = signal.ndim - 1
    fs = float(sampling_rate)

    def _build():
        omega = jnp.asarray(_omega_axis(padded_len, fs))

        def _local(sig_fft, scales_loc, wgt_loc):
            a = scales_loc[:, None]
            w_hat = jnp.conj(wav.psi_hat_scaled(omega[None, :], a))
            bank = jnp.concatenate([w_hat, w_hat * (1j * omega)[None, :]], axis=0)
            out = jnp.fft.ifft(sig_fft[..., None, :] * bank, axis=-1)[..., :n]
            s_loc = scales_loc.shape[0]
            W, dW = out[..., :s_loc, :], out[..., s_loc:, :]
            if gamma is None:
                mag2 = jnp.real(W) ** 2 + jnp.imag(W) ** 2
                gmax = lax.pmax(jnp.max(mag2, axis=(-2, -1), keepdims=True), axis_name)
                eps = jnp.finfo(W.real.dtype).eps
                gamma_abs = 10.0 * jnp.sqrt(eps) * jnp.sqrt(gmax)
            else:
                gamma_abs = jnp.asarray(gamma, dtype=W.real.dtype)
            tx_loc = _squeeze_plane(W, dW, wgt_loc, freqs_np, gamma_abs, out_of_range, reassign)
            return lax.psum(tx_loc, axis_name)

        mapped = shard_map(
            _local, mesh=mesh,
            in_specs=(P(), P(axis_name), P(axis_name)),
            out_specs=P(),
        )

        @jax.jit
        def run(sig, sc, wg):
            sig_fft = jnp.fft.fft(pad_signal(sig, padded_len, padding), axis=-1)
            return mapped(sig_fft, sc, wg)

        return run

    run = _get_or_build(
        ("ssq_scale", mesh, axis_name, _wav_key(wav), n, lead, fs, padding,
         freqs_np.tobytes(), gamma, out_of_range, reassign), _build
    )
    tx = run(jnp.asarray(signal), jnp.asarray(scales_np), jnp.asarray(wgt_np))
    time_axis = jnp.arange(n) / fs
    return SSQResult(tx, jnp.asarray(freqs_np), jnp.asarray(scales_np), time_axis, fs, wav.name)


# --------------------------------------------------------------------------
# separable 2D transforms: row shards + all_to_all distributed transpose
# --------------------------------------------------------------------------

import functools


@functools.lru_cache(maxsize=256)
def _cached_separable_2d(kind: str, fb_key, level_rows, level_cols,
                         mesh: Mesh, axis_name: str, dials):
    """Build (once per config) the jitted sharded 2D transform — a fresh
    closure per call would force an XLA recompile every invocation. Keyed
    by coefficient value (``_fb_key``) and the global dials, and closes
    over the interned bank so custom FilterBanks get their own programs."""
    fb = _FB_INTERN[fb_key]
    fwd = {"fwt": fwt, "ifwt": ifwt, "wpt": wpt, "iwpt": iwpt}[kind]
    return _sharded_separable_2d(
        lambda b: fwd(b, fb, level_cols),
        lambda b: fwd(b, fb, level_rows),
        mesh, axis_name,
    )


def _sharded_separable_2d(fn_rows, fn_cols, mesh: Mesh, axis_name: str | None = None):
    """rows-local transform -> all_to_all transpose -> columns-local
    transform -> all_to_all back. Both collectives move each element twice
    in total — the bandwidth-optimal pattern used by distributed FFTs."""
    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]

    def _local(block):  # block: (R/D, C)
        y = fn_rows(block)
        r, c_full = y.shape
        c = c_full // n_dev
        y = y.reshape(r, n_dev, c)
        y = lax.all_to_all(y, axis_name, split_axis=1, concat_axis=0)  # (D, r, c)
        y = y.reshape(n_dev * r, c)  # (R, c): this chip now owns a column chunk
        y = jnp.swapaxes(y, 0, 1)  # (c, R)
        y = fn_cols(y)
        y = jnp.swapaxes(y, 0, 1)  # (R, c)
        y = y.reshape(n_dev, r, c)
        y = lax.all_to_all(y, axis_name, split_axis=0, concat_axis=1)  # (r, D, c)
        return y.reshape(r, c_full)

    mapped = shard_map(_local, mesh=mesh, in_specs=P(axis_name, None), out_specs=P(axis_name, None))

    @jax.jit
    def run(mat):
        return mapped(mat)

    def wrapper(mat):
        rows, cols = mat.shape
        if rows % n_dev or cols % n_dev:
            raise JWaveFailure(
                f"sharded 2D transform - matrix {rows}x{cols} must tile evenly "
                f"over {n_dev} devices on both axes"
            )
        return run(mat)

    return wrapper


def fwt2d_sharded(mat, wavelet, mesh: Mesh, level_rows=None, level_cols=None, axis_name=None):
    """2D FWT sharded across the mesh (BASELINE config #4)."""
    from ..filters import get_filter

    f = _cached_separable_2d('fwt', _fb_key(wavelet), level_rows, level_cols,
                             mesh, axis_name or mesh.axis_names[0], _dial_key())
    return f(jnp.asarray(mat))


def ifwt2d_sharded(mat, wavelet, mesh: Mesh, level_rows=None, level_cols=None, axis_name=None):
    from ..filters import get_filter

    f = _cached_separable_2d('ifwt', _fb_key(wavelet), level_rows, level_cols,
                             mesh, axis_name or mesh.axis_names[0], _dial_key())
    return f(jnp.asarray(mat))


def wpt2d_sharded(mat, wavelet, mesh: Mesh, level_rows=None, level_cols=None, axis_name=None):
    from ..filters import get_filter

    f = _cached_separable_2d('wpt', _fb_key(wavelet), level_rows, level_cols,
                             mesh, axis_name or mesh.axis_names[0], _dial_key())
    return f(jnp.asarray(mat))


def iwpt2d_sharded(mat, wavelet, mesh: Mesh, level_rows=None, level_cols=None, axis_name=None):
    from ..filters import get_filter

    f = _cached_separable_2d('iwpt', _fb_key(wavelet), level_rows, level_cols,
                             mesh, axis_name or mesh.axis_names[0], _dial_key())
    return f(jnp.asarray(mat))


# --------------------------------------------------------------------------
# separable 3D transforms: slab shards + all_to_all distributed transpose
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _cached_separable_3d(kind: str, fb_key, level_p, level_q, level_r,
                         mesh: Mesh, axis_name: str, dials):
    """Jitted sharded separable 3D transform, built once per configuration.

    The reference parallelizes 3D as per-slice 2D + per-pillar 1D over a
    ForkJoinPool (ParallelTransform.java:137-160). The SPMD form
    shards the volume's leading axis into slabs: the two local axes
    transform as batched passes, and the sharded axis is brought local by
    one all_to_all transpose pair (same bandwidth-optimal pattern as
    _sharded_separable_2d, extended with the third axis riding along).
    """
    fb = _FB_INTERN[fb_key]
    fwd = {"fwt": fwt, "ifwt": ifwt, "wpt": wpt, "iwpt": iwpt}[kind]
    n_dev = mesh.shape[axis_name]

    def _local(block):  # block: (P/D, Q, R)
        y = fwd(block, fb, level_r)  # along R
        y = jnp.swapaxes(y, -1, -2)  # (P/D, R, Q)
        y = fwd(y, fb, level_q)  # along Q
        y = jnp.swapaxes(y, -1, -2)  # (P/D, Q, R)
        p, q_full, r = y.shape
        q = q_full // n_dev
        y = y.reshape(p, n_dev, q, r)
        y = lax.all_to_all(y, axis_name, split_axis=1, concat_axis=0)  # (D, p, q, R)
        y = y.reshape(n_dev * p, q, r)  # (P, q, R): this chip owns a Q chunk
        y = jnp.moveaxis(y, 0, -1)  # (q, R, P)
        y = fwd(y, fb, level_p)  # along P
        y = jnp.moveaxis(y, -1, 0)  # (P, q, R)
        y = y.reshape(n_dev, p, q, r)
        y = lax.all_to_all(y, axis_name, split_axis=0, concat_axis=1)  # (p, D, q, R)
        return y.reshape(p, q_full, r)

    mapped = shard_map(
        _local, mesh=mesh, in_specs=P(axis_name, None, None), out_specs=P(axis_name, None, None)
    )
    run = jax.jit(mapped)

    def wrapper(vol):
        pp, qq, rr = vol.shape
        if pp % n_dev or qq % n_dev:
            raise JWaveFailure(
                f"sharded 3D transform - volume {pp}x{qq}x{rr} must tile evenly "
                f"over {n_dev} devices on its first two axes"
            )
        return run(vol)

    return wrapper


def _sharded_3d(kind, vol, wavelet, mesh, level_p, level_q, level_r, axis_name):
    f = _cached_separable_3d(kind, _fb_key(wavelet), level_p, level_q, level_r,
                             mesh, axis_name or mesh.axis_names[0], _dial_key())
    return f(jnp.asarray(vol))


def fwt3d_sharded(vol, wavelet, mesh: Mesh, level_p=None, level_q=None, level_r=None, axis_name=None):
    """3D FWT with the volume slab-sharded across the mesh (the scalable
    analog of ParallelTransform.java:137-160; BASELINE config #4's 256^3
    volume workload)."""
    return _sharded_3d("fwt", vol, wavelet, mesh, level_p, level_q, level_r, axis_name)


def ifwt3d_sharded(vol, wavelet, mesh: Mesh, level_p=None, level_q=None, level_r=None, axis_name=None):
    return _sharded_3d("ifwt", vol, wavelet, mesh, level_p, level_q, level_r, axis_name)


def wpt3d_sharded(vol, wavelet, mesh: Mesh, level_p=None, level_q=None, level_r=None, axis_name=None):
    return _sharded_3d("wpt", vol, wavelet, mesh, level_p, level_q, level_r, axis_name)


def iwpt3d_sharded(vol, wavelet, mesh: Mesh, level_p=None, level_q=None, level_r=None, axis_name=None):
    return _sharded_3d("iwpt", vol, wavelet, mesh, level_p, level_q, level_r, axis_name)


# --------------------------------------------------------------------------
# MODWT: time axis sharded with ppermute halo exchange
# --------------------------------------------------------------------------

def _halo_left(v, halo, axis_name, n_dev):
    """Fetch the left neighbor's tail (circular): each chip sends its last
    ``halo`` samples one step to the right."""
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    return lax.ppermute(v[..., -halo:], axis_name, perm)


def _halo_right(v, halo, axis_name, n_dev):
    """Fetch the right neighbor's head (circular)."""
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    return lax.ppermute(v[..., :halo], axis_name, perm)


def _conv_valid_1d(x, kernel):
    out = lax.conv_general_dilated(
        x[None, None, :],
        jnp.asarray(kernel, dtype=x.dtype)[None, None, :],
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=x.dtype,
        precision=_config.conv_precision(),
    )
    return out[0, 0, :]


def modwt_halo_sharded(signal, wavelet, level: int, mesh: Mesh, axis_name: str | None = None):
    """Forward MODWT with the time axis sharded across the mesh.

    Per level each chip convolves its local chunk after a single
    ``ppermute`` halo exchange of the level filter's support (L_j - 1
    samples) from its left neighbor — the compact-support analog of ring
    attention (SURVEY.md §5.7). Requires halo <= local chunk length, i.e.
    level J <~ log2(N / (D * M)); use the FFT path on gathered data beyond
    that.
    """
    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    n = signal.shape[-1]
    if signal.ndim != 1:
        raise JWaveFailure("modwt_halo_sharded - expects a 1D signal (use batch_sharded for batches)")
    if n % n_dev:
        raise JWaveFailure(f"modwt_halo_sharded - length {n} must divide over {n_dev} devices")
    _validate_level(n, level, "modwt_halo_sharded")
    from ..filters import get_filter

    n_loc = n // n_dev
    filters = _level_filters(wavelet, level, n)
    for gj, hj in filters:
        if gj.shape[0] - 1 > n_loc:
            raise JWaveFailure(
                f"modwt_halo_sharded - level filter support {gj.shape[0]} exceeds local "
                f"chunk {n_loc}; lower the level or use fewer devices"
            )

    def _build():
        def _local(v):  # v: (n_loc,)
            vv = v
            rows = []
            for gj, hj in filters:
                lg = gj.shape[0]
                halo = lg - 1
                if halo > 0:
                    ext = jnp.concatenate([_halo_left(vv, halo, axis_name, n_dev), vv])
                else:
                    ext = vv
                w = _conv_valid_1d(ext, np.ascontiguousarray(hj[::-1]))
                vv = _conv_valid_1d(ext, np.ascontiguousarray(gj[::-1]))
                rows.append(w)
            rows.append(vv)
            return jnp.stack(rows)  # (J+1, n_loc)

        mapped = shard_map(_local, mesh=mesh, in_specs=P(axis_name), out_specs=P(None, axis_name))
        return jax.jit(mapped)

    run = _get_or_build(
        ("modwt_halo", mesh, axis_name, _fb_key(wavelet), level, n), _build
    )
    return run(jnp.asarray(signal))


def imodwt_halo_sharded(coeffs, wavelet, mesh: Mesh, axis_name: str | None = None):
    """Inverse MODWT with time-sharded coefficients ((J+1, N) layout).

    The adjoint convolution needs the *right* neighbor's head instead of
    the left neighbor's tail — one ppermute per level in the opposite ring
    direction."""
    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    level = coeffs.shape[-2] - 1
    n = coeffs.shape[-1]
    if n % n_dev:
        raise JWaveFailure(f"imodwt_halo_sharded - length {n} must divide over {n_dev} devices")
    from ..filters import get_filter

    n_loc = n // n_dev
    filters = _level_filters(wavelet, level, n)
    for gj, _ in filters:
        if gj.shape[0] - 1 > n_loc:
            raise JWaveFailure(
                f"imodwt_halo_sharded - level filter support {gj.shape[0]} exceeds local chunk {n_loc}"
            )

    def _build():
        def _local(c):  # c: (J+1, n_loc)
            v = c[level]
            for j in range(level, 0, -1):
                gj, hj = filters[j - 1]
                halo = gj.shape[0] - 1
                w = c[j - 1]
                if halo > 0:
                    ev = jnp.concatenate([v, _halo_right(v, halo, axis_name, n_dev)])
                    ew = jnp.concatenate([w, _halo_right(w, halo, axis_name, n_dev)])
                else:
                    ev, ew = v, w
                v = _conv_valid_1d(ev, gj) + _conv_valid_1d(ew, hj)
            return v

        mapped = shard_map(_local, mesh=mesh, in_specs=P(None, axis_name), out_specs=P(axis_name))
        return jax.jit(mapped)

    run = _get_or_build(
        ("imodwt_halo", mesh, axis_name, _fb_key(wavelet), level, n), _build
    )
    return run(jnp.asarray(coeffs))


# --------------------------------------------------------------------------
# FWT: time axis sharded with ppermute halo exchange (distributed pyramid)
# --------------------------------------------------------------------------

def _butterfly_halo(v, dec_lo, dec_hi, axis_name, n_dev):
    """One analysis butterfly on a time-sharded block (last axis, batched
    over leading axes): each chip computes its contiguous share of
    approx/detail from its local samples plus an M-2 right halo fetched from
    the next chip along ``axis_name`` (circular)."""
    import numpy as np

    lead = v.shape[:-1]
    n_loc = v.shape[-1]
    m = int(dec_lo.shape[0])
    halo = max(m - 2, 0)
    if halo:
        perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        right = lax.ppermute(v[..., :halo], axis_name, perm)
        ext = jnp.concatenate([v, right], axis=-1)
    else:
        ext = v
    rhs = jnp.asarray(np.stack([np.asarray(dec_lo), np.asarray(dec_hi)])[:, None, :], dtype=v.dtype)
    out = lax.conv_general_dilated(
        ext.reshape((-1, 1, ext.shape[-1])), rhs,
        window_strides=(2,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=v.dtype,
        precision=_config.conv_precision(),
    ).reshape(lead + (2, n_loc // 2))
    return out[..., 0, :], out[..., 1, :]  # local approx / detail chunks


def _halo_level_split(n: int, n_dev: int, fb, level: int):
    """How many pyramid levels can run fully sharded (local chunk of the
    shrinking prefix keeps >= filter-length samples) vs. finished redundantly
    on every chip after an all_gather of the tiny remaining prefix."""
    sharded_levels = 0
    h = n
    m = fb.length
    while sharded_levels < level and h >= fb.transform_wavelength and (h // n_dev) >= max(m, 2):
        sharded_levels += 1
        h >>= 1
    tail_levels = 0
    while sharded_levels + tail_levels < level and h >= fb.transform_wavelength:
        tail_levels += 1
        h >>= 1
    return sharded_levels, tail_levels


def _fwt_axis_halo_local(v, fb, sharded_levels: int, tail_levels: int, axis_name: str, n_dev: int):
    """Multi-level FWT along the last axis of a sharded block (batched over
    leading axes) with per-level ppermute halo exchange. Returns the local
    slice of the distributed pyramid layout [D_1^c | D_2^c | ... | tail]."""
    details = []
    for _ in range(sharded_levels):
        v, d = _butterfly_halo(v, fb.dec_lo, fb.dec_hi, axis_name, n_dev)
        details.append(d)
    if tail_levels:
        # gather the tiny remaining prefix and finish on every chip
        full = lax.all_gather(v, axis_name, axis=v.ndim - 1, tiled=True)
        from ..transforms.fwt import fwt as fwt_1d

        full = fwt_1d(full, fb, tail_levels)
        loc = full.shape[-1] // n_dev
        idx = lax.axis_index(axis_name)
        v = lax.dynamic_slice_in_dim(full, idx * loc, loc, axis=full.ndim - 1)
    return jnp.concatenate(details + [v], axis=-1) if details else v


def fwt_halo_sharded(signal, wavelet, mesh: Mesh, level: int | None = None, axis_name=None):
    """Multi-level FWT with the signal's time axis sharded across the mesh,
    using per-level ``ppermute`` halo exchange (BASELINE config #4's halo
    pattern; the transpose-based ``fwt2d_sharded`` is the alternative).

    Each level's butterfly needs only an (M-2)-sample right halo; the approx
    chain stays distributed (chip c always owns the c-th contiguous chunk of
    the current prefix), so no data ever re-shuffles. When the shrinking
    prefix no longer spans all chips with at least a filter-length per chip,
    the remaining tiny prefix is finished redundantly on every chip after an
    all_gather (cheap: the prefix is < D * M samples).

    Returns the coefficients in the *distributed pyramid layout*: chip c's
    local slice is ``[D_1^c | D_2^c | ... | A_L^c]`` (finest detail first).
    Use :func:`gather_pyramid` to convert a gathered copy to the reference's
    global ``[A_L | D_L | ... | D_1]`` layout.
    """
    from ..filters import get_filter
    from ..utils.numerics import exponent_of_two, is_power_of_two

    fb = get_filter(wavelet)
    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    n = signal.shape[-1]
    if signal.ndim != 1:
        raise JWaveFailure("fwt_halo_sharded - expects a 1D signal")
    if not is_power_of_two(n) or n % n_dev:
        raise JWaveFailure(f"fwt_halo_sharded - length {n} must be 2^p and divide over {n_dev} chips")
    steps = exponent_of_two(n)
    if level is None:
        level = steps

    sharded_levels, tail_levels = _halo_level_split(n, n_dev, fb, level)

    def _build():
        def _local(v):  # v: (n_loc,) local chunk
            # local layout: [D_1^c | D_2^c | ... | tail] (finest detail first)
            return _fwt_axis_halo_local(v, fb, sharded_levels, tail_levels, axis_name, n_dev)

        mapped = shard_map(_local, mesh=mesh, in_specs=P(axis_name), out_specs=P(axis_name))
        return jax.jit(mapped)

    run = _get_or_build(("fwt_halo", mesh, axis_name, _fb_key(fb), n, level), _build)
    return run(jnp.asarray(signal))


def _pyramid_permutation(n: int, n_dev: int, fb, level: int) -> np.ndarray:
    """Source-index array mapping a gathered distributed-pyramid axis (local
    layout [D_1^c | D_2^c | ... | tail] per chip, concatenated) to the
    reference's global layout [A_L | D_L | ... | D_1]: out = arr[idx]."""
    sharded_levels, _ = _halo_level_split(n, n_dev, fb, level)
    n_loc = n // n_dev
    idx = np.empty(n, dtype=np.int64)
    offset_local = 0
    for l in range(1, sharded_levels + 1):
        d_len = n // (2**l) // n_dev
        base = n // (2**l)  # detail region for level l: [n/2^l, n/2^(l-1))
        for c in range(n_dev):
            idx[base + c * d_len : base + (c + 1) * d_len] = (
                c * n_loc + offset_local + np.arange(d_len)
            )
        offset_local += d_len
    tail_len = n_loc - offset_local
    for c in range(n_dev):
        idx[c * tail_len : (c + 1) * tail_len] = c * n_loc + offset_local + np.arange(tail_len)
    return idx


def gather_pyramid(dist, wavelet, level: int, n_dev: int):
    """Convert the gathered distributed-pyramid output of
    :func:`fwt_halo_sharded` into the reference's global layout
    ``[A_L | D_L | ... | D_1]`` (host-side reshuffle)."""
    from ..filters import get_filter

    arr = np.asarray(dist)
    return arr[_pyramid_permutation(arr.shape[-1], n_dev, get_filter(wavelet), level)]


# --------------------------------------------------------------------------
# 2D FWT: tile sharding over a 2D mesh with per-level halo exchange
# --------------------------------------------------------------------------

def fwt2d_tile_sharded(
    mat,
    wavelet,
    mesh: Mesh,
    level_rows: int | None = None,
    level_cols: int | None = None,
    row_axis: str | None = None,
    col_axis: str | None = None,
):
    """Multi-level 2D FWT with the matrix *tile-sharded* over a 2D mesh.

    This is the direct SPMD analog of the reference's row/column ForkJoinPool
    decorator (ParallelTransform.java:70-126) in its natural SPMD form
    (SURVEY.md §2.6): each chip owns one (M/Dr, N/Dc) tile; the column pass
    runs the halo-exchange pyramid (:func:`fwt_halo_sharded`'s kernel) along
    the col mesh axis, the row pass along the row mesh axis. Every level
    exchanges only (filter_length - 2) boundary samples per tile edge via
    ``ppermute`` — no element ever moves twice, unlike the all_to_all
    transpose of :func:`fwt2d_sharded` which ships each element once per
    pass. When the shrinking prefix no longer spans a mesh axis, the tiny
    remainder is finished redundantly after a per-axis all_gather.

    Output is in the *distributed pyramid layout* per axis; use
    :func:`gather_pyramid_2d` on a gathered copy to obtain the reference's
    global layout (bit-identical to the single-chip ``fwt2``). Requires both
    matrix axes to be powers of two dividing their mesh axes.
    """
    from ..filters import get_filter
    from ..utils.numerics import exponent_of_two, is_power_of_two

    if len(mesh.axis_names) < 2:
        raise JWaveFailure("fwt2d_tile_sharded - needs a 2D mesh (rows x cols)")
    row_axis = row_axis or mesh.axis_names[0]
    col_axis = col_axis or mesh.axis_names[1]
    n_dev_r = mesh.shape[row_axis]
    n_dev_c = mesh.shape[col_axis]
    fb = get_filter(wavelet)
    mat = jnp.asarray(mat)
    if mat.ndim != 2:
        raise JWaveFailure("fwt2d_tile_sharded - expects a 2D matrix")
    rows, cols = mat.shape
    for n, d, who in ((rows, n_dev_r, "rows"), (cols, n_dev_c, "cols")):
        if not is_power_of_two(n) or n % d:
            raise JWaveFailure(
                f"fwt2d_tile_sharded - {who} length {n} must be 2^p and divide over {d} chips"
            )
    if level_rows is None:
        level_rows = exponent_of_two(rows)
    if level_cols is None:
        level_cols = exponent_of_two(cols)
    sl_r, tl_r = _halo_level_split(rows, n_dev_r, fb, level_rows)
    sl_c, tl_c = _halo_level_split(cols, n_dev_c, fb, level_cols)

    def _build():
        def _local(tile):  # tile: (rows/Dr, cols/Dc)
            y = _fwt_axis_halo_local(tile, fb, sl_c, tl_c, col_axis, n_dev_c)
            y = jnp.swapaxes(y, -1, -2)
            y = _fwt_axis_halo_local(y, fb, sl_r, tl_r, row_axis, n_dev_r)
            return jnp.swapaxes(y, -1, -2)

        mapped = shard_map(
            _local, mesh=mesh, in_specs=P(row_axis, col_axis), out_specs=P(row_axis, col_axis)
        )
        return jax.jit(mapped)

    run = _get_or_build(
        ("fwt2d_tile", mesh, row_axis, col_axis, _fb_key(fb), rows, cols, level_rows, level_cols),
        _build,
    )
    return run(mat)


def gather_pyramid_2d(dist, wavelet, level_rows: int, level_cols: int, n_dev_r: int, n_dev_c: int):
    """Convert a gathered :func:`fwt2d_tile_sharded` output to the
    reference's global 2D layout (host-side index permutation per axis)."""
    from ..filters import get_filter

    fb = get_filter(wavelet)
    arr = np.asarray(dist)
    idx_r = _pyramid_permutation(arr.shape[-2], n_dev_r, fb, level_rows)
    idx_c = _pyramid_permutation(arr.shape[-1], n_dev_c, fb, level_cols)
    return arr[..., idx_r, :][..., :, idx_c]


def cwt_batch_scale_sharded(
    signals,
    scales,
    wavelet,
    mesh: Mesh,
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
    batch_axis: str | None = None,
    scale_axis: str | None = None,
) -> CWTResult:
    """CWT over a 2D mesh: signals data-parallel on one axis, scales on the
    other — the scalable layout for many-signal scalogram pipelines.

    ``signals`` is (B, N); output coefficients are (B, S, N) sharded
    (batch_axis, scale_axis, None). Zero collectives: each chip computes the
    FFTs of its own signal block and applies its own scale block.
    """
    import numpy as np

    if len(mesh.axis_names) < 2:
        raise JWaveFailure("cwt_batch_scale_sharded - needs a 2D mesh (batch, scale axes)")
    batch_axis = batch_axis or mesh.axis_names[0]
    scale_axis = scale_axis or mesh.axis_names[1]
    nb = mesh.shape[batch_axis]
    ns = mesh.shape[scale_axis]
    wav = get_continuous_wavelet(wavelet)
    scales = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    if signals.ndim != 2:
        raise JWaveFailure("cwt_batch_scale_sharded - signals must be (B, N)")
    if signals.shape[0] % nb or scales.shape[0] % ns:
        raise JWaveFailure(
            f"cwt_batch_scale_sharded - batch {signals.shape[0]} and scales "
            f"{scales.shape[0]} must divide over mesh {nb}x{ns}"
        )
    n = signals.shape[-1]
    padded_len = next_power_of_two(n)
    fs = float(sampling_rate)

    def _build():
        omega = jnp.asarray(_omega_axis(padded_len, fs))

        def _local(sig_block, scales_loc):  # (B/nb, N), (S/ns,)
            sig_fft = jnp.fft.fft(pad_signal(sig_block, padded_len, padding), axis=-1)
            a = scales_loc[:, None]
            w_hat = jnp.conj(wav.psi_hat_scaled(omega[None, :], a))
            return jnp.fft.ifft(sig_fft[:, None, :] * w_hat[None, :, :], axis=-1)[..., :n]

        mapped = shard_map(
            _local, mesh=mesh,
            in_specs=(P(batch_axis, None), P(scale_axis)),
            out_specs=P(batch_axis, scale_axis, None),
        )
        return jax.jit(mapped)

    run = _get_or_build(
        ("cwt_batch_scale", mesh, batch_axis, scale_axis, _wav_key(wav), n, fs, padding),
        _build,
    )
    coeffs = run(jnp.asarray(signals), jnp.asarray(scales))
    time_axis = jnp.arange(n) / fs
    return CWTResult(coeffs, jnp.asarray(scales), time_axis, fs, wav.name)


# --------------------------------------------------------------------------
# MODWT: time axis sharded via the distributed four-step FFT (deep levels)
# --------------------------------------------------------------------------

def _check_doubling_bound(n: int, who: str):
    """The on-device cascade evaluation doubles frequency indices mod N;
    without x64 those are int32, so 2*t (t < N) must stay below 2^31."""
    import jax as _jax

    if not _jax.config.jax_enable_x64 and n > (1 << 30):
        raise JWaveFailure(
            f"{who} - length {n} overflows int32 index doubling; enable "
            "jax_enable_x64 for signals this large"
        )


def _local_freq_bins(n: int, n_dev: int, axis_name: str):
    """Global frequency index of each element of this device's (D, L/D)
    block of the pfft (D, L) spectrum layout: k = i*(L/D) + off + L*k1
    (parallel/pfft.py layout contract)."""
    l = n // n_dev
    i = lax.axis_index(axis_name)
    k1 = jnp.arange(n_dev)[:, None]
    k2 = i * (l // n_dev) + jnp.arange(l // n_dev)[None, :]
    return k2 + l * k1  # (D, L/D)


def _filter_dft_at(coeffs: np.ndarray, t, n: int, cdtype):
    """DFT of an M-tap filter at phase indices ``t``: sum_m coeffs[m] *
    exp(-2j*pi*((t*m) mod n)/n). The index is built by cumulative modular
    addition, exact in integer arithmetic (no t*m overflow)."""
    scale = -2.0 * np.pi / n
    acc = jnp.full(t.shape, complex(coeffs[0]), dtype=cdtype)  # m=0: phase 0
    u = jnp.zeros_like(t)
    for m in range(1, coeffs.shape[0]):
        u = u + t
        u = jnp.where(u >= n, u - n, u)
        acc = acc + complex(coeffs[m]) * jnp.exp(
            jnp.asarray(1j * scale, dtype=cdtype) * u.astype(cdtype)
        )
    return acc


def _cascade_responses_local(wavelet, level: int, n: int, k, cdtype):
    """The telescoped cascade responses W_1..W_J, V_J
    (transforms/modwt.py::_cascade_spectra) evaluated *on device* at global
    frequency bins ``k`` — each chip computes only its own N/D bins, so no
    length-N array ever exists on host or chip.

    Identity: the length-N DFT of the level-j upsampled (implicitly
    wrapped, MODWTTransform.java:729-741) filter at bin k equals the M-tap
    base-filter DFT at index (2^(j-1) * k) mod N; the power is built by
    modular doubling (exact in integers — see _check_doubling_bound).
    """
    from ..transforms.modwt import _modwt_base_filters

    g0, h0 = _modwt_base_filters(wavelet)
    t = k
    g_acc = jnp.ones(k.shape, dtype=cdtype)
    rows = []
    for _ in range(level):
        rows.append(_filter_dft_at(h0, t, n, cdtype) * g_acc)
        g_acc = g_acc * _filter_dft_at(g0, t, n, cdtype)
        t2 = t + t
        t = jnp.where(t2 >= n, t2 - n, t2)
    rows.append(g_acc)
    return jnp.stack(rows)  # (J+1, *k.shape)


def modwt_fft_sharded(signal, wavelet, level: int, mesh: Mesh, axis_name: str | None = None):
    """Forward MODWT with the time axis sharded, any decomposition depth.

    :func:`modwt_halo_sharded` requires the level-j filter support to fit in
    one chip's chunk (halo <= N/D), which caps the depth at
    J <~ log2(N/(D*M)). This variant has no such cap: the telescoped
    frequency-domain cascade (transforms/modwt.py::_cascade_spectra) runs on
    top of the distributed four-step FFT (parallel/pfft.py) — one forward
    pFFT of the signal, J+1 purely local spectrum multiplies against cascade
    responses *evaluated on-device at each chip's own frequency bins*
    (nothing of global length N is ever materialized, on host or chip), and
    one batched inverse pFFT. Each chip only ever holds O((J+1) * N/D)
    samples, so signals larger than a single chip's HBM stay sharded end to
    end; all exchanges are ``all_to_all``.

    Returns the reference's (J+1, N) stack [W_1..W_J, V_J]
    (MODWTTransform.java:256-306), time-sharded on the last axis.
    """
    from .pfft import pfft_local, pifft_local, _check_geometry

    from ..ops.butterfly import ensure_float

    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    signal = ensure_float(jnp.asarray(signal))
    if signal.ndim != 1:
        raise JWaveFailure("modwt_fft_sharded - expects a 1D signal (use batch_sharded for batches)")
    n = signal.shape[-1]
    _check_geometry(n, n_dev, "modwt_fft_sharded")
    _check_doubling_bound(n, "modwt_fft_sharded")
    _validate_level(n, level, "modwt_fft_sharded")
    from ..filters import get_filter

    cdtype = jnp.complex128 if signal.dtype == jnp.float64 else jnp.complex64
    rdtype = signal.dtype

    def _build():
        def _local(v):  # v: (L,)
            spec = pfft_local(v, axis_name)  # (D, L/D)
            fil = _cascade_responses_local(wavelet, level, n, _local_freq_bins(n, n_dev, axis_name), cdtype)
            out = pifft_local(fil * spec[None], axis_name)  # (J+1, L)
            return jnp.real(out).astype(rdtype)

        mapped = shard_map(_local, mesh=mesh, in_specs=P(axis_name), out_specs=P(None, axis_name))
        return jax.jit(mapped)

    run = _get_or_build(
        ("modwt_fft", mesh, axis_name, _fb_key(wavelet), level, n, str(rdtype)),
        _build,
    )
    return run(signal)


def imodwt_fft_sharded(coeffs, wavelet, mesh: Mesh, axis_name: str | None = None):
    """Inverse of :func:`modwt_fft_sharded` from a time-sharded (J+1, N)
    stack: batched forward pFFT of the rows, conjugate-weighted sum (the
    telescoped adjoint, MODWTTransform.java:798-837), one inverse pFFT."""
    from .pfft import pfft_local, pifft_local, _check_geometry

    from ..ops.butterfly import ensure_float

    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    coeffs = ensure_float(jnp.asarray(coeffs))
    if coeffs.ndim != 2:
        raise JWaveFailure("imodwt_fft_sharded - expects a (J+1, N) stack")
    level = coeffs.shape[-2] - 1
    n = coeffs.shape[-1]
    if level < 1:
        raise JWaveFailure("imodwt_fft_sharded - need at least level 1 (2 rows)")
    _check_geometry(n, n_dev, "imodwt_fft_sharded")
    _check_doubling_bound(n, "imodwt_fft_sharded")
    from ..filters import get_filter

    cdtype = jnp.complex128 if coeffs.dtype == jnp.float64 else jnp.complex64
    rdtype = coeffs.dtype

    def _build():
        def _local(c):  # c: (J+1, L)
            spec = pfft_local(c, axis_name)  # (J+1, D, L/D)
            fil = _cascade_responses_local(wavelet, level, n, _local_freq_bins(n, n_dev, axis_name), cdtype)
            v_hat = jnp.sum(spec * jnp.conj(fil), axis=0)  # (D, L/D)
            return jnp.real(pifft_local(v_hat, axis_name)).astype(rdtype)

        mapped = shard_map(_local, mesh=mesh, in_specs=P(None, axis_name), out_specs=P(axis_name))
        return jax.jit(mapped)

    run = _get_or_build(
        ("imodwt_fft", mesh, axis_name, _fb_key(wavelet), level, n, str(rdtype)),
        _build,
    )
    return run(coeffs)


def modwt2d_sharded(mat, wavelet, level: int, mesh: Mesh, axis_name: str | None = None, **kw):
    """Separable 2D MODWT with the matrix row-sharded across the mesh.

    Column-direction transforms are fully local (each chip holds complete
    rows); the row-direction pass is brought local by one all_to_all
    transpose pair, exactly like the separable 2D FWT. Matches
    :func:`jwave_tpu.transforms.modwt.modwt_2d`'s (..., J+1, J+1, R, C)
    subband grid, returned row-sharded on R. Feeds scalogram/denoising
    pipelines whose images exceed one chip's HBM.
    """
    from ..transforms.modwt import modwt as _modwt
    from ..filters import get_filter

    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    mat = jnp.asarray(mat)
    if mat.ndim != 2:
        raise JWaveFailure("modwt2d_sharded - expects a 2D matrix (R, C)")
    r, c = mat.shape
    if r % n_dev or c % n_dev:
        raise JWaveFailure(
            f"modwt2d_sharded - matrix {r}x{c} must divide over {n_dev} devices on both axes"
        )
    _validate_level(min(r, c), level, "modwt2d_sharded")

    def _build():
        def _local(block):  # (R/D, C)
            y = _modwt(block, wavelet, level, **kw)  # (R/D, J+1, C)
            y = jnp.moveaxis(y, -2, -3)  # (jc, R/D, C)
            j1, r_loc, c_full = y.shape
            y = y.reshape(j1, r_loc, n_dev, c_full // n_dev)
            y = lax.all_to_all(y, axis_name, split_axis=2, concat_axis=1)  # (jc, D, R/D, C/D)
            y = y.reshape(j1, n_dev * r_loc, c_full // n_dev)  # (jc, R, C/D)
            y = jnp.swapaxes(y, -1, -2)  # (jc, C/D, R)
            y = _modwt(y, wavelet, level, **kw)  # (jc, C/D, jr, R)
            y = jnp.moveaxis(y, -2, -4)  # (jr, jc, C/D, R)
            y = jnp.swapaxes(y, -1, -2)  # (jr, jc, R, C/D)
            y = y.reshape(j1, j1, n_dev, r_loc, c_full // n_dev)
            y = lax.all_to_all(y, axis_name, split_axis=2, concat_axis=3)  # (jr, jc, R/D, D, C/D)
            return y.reshape(j1, j1, r_loc, c_full)

        mapped = shard_map(
            _local, mesh=mesh,
            in_specs=P(axis_name, None),
            out_specs=P(None, None, axis_name, None),
        )
        return jax.jit(mapped)

    run = _get_or_build(
        ("modwt2d", mesh, axis_name, _fb_key(wavelet), level, r, c,
         tuple(sorted(kw.items()))),
        _build,
    )
    return run(mat)


def imodwt2d_sharded(coeffs, wavelet, mesh: Mesh, axis_name: str | None = None, **kw):
    """Inverse of :func:`modwt2d_sharded` from the row-sharded
    (J+1, J+1, R, C) grid back to the (R, C) matrix."""
    from ..transforms.modwt import imodwt as _imodwt
    from ..filters import get_filter

    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    coeffs = jnp.asarray(coeffs)
    if coeffs.ndim != 4:
        raise JWaveFailure("imodwt2d_sharded - expects a (J+1, J+1, R, C) grid")
    j1, j1b, r, c = coeffs.shape
    if j1 != j1b:
        raise JWaveFailure("imodwt2d_sharded - level grid must be square")
    if r % n_dev or c % n_dev:
        raise JWaveFailure(
            f"imodwt2d_sharded - matrix {r}x{c} must divide over {n_dev} devices on both axes"
        )

    def _build():
        def _local(g):  # (jr, jc, R/D, C)
            r_loc = g.shape[-2]
            c_full = g.shape[-1]
            # undo the row-direction transform first: need R resident
            y = g.reshape(j1, j1, r_loc, n_dev, c_full // n_dev)
            y = lax.all_to_all(y, axis_name, split_axis=3, concat_axis=2)  # (jr, jc, D, R/D, C/D)
            y = y.reshape(j1, j1, n_dev * r_loc, c_full // n_dev)  # (jr, jc, R, C/D)
            y = jnp.swapaxes(y, -1, -2)  # (jr, jc, C/D, R)
            y = jnp.moveaxis(y, -4, -2)  # (jc, C/D, jr, R)
            y = _imodwt(y, wavelet, **kw)  # (jc, C/D, R)
            y = jnp.swapaxes(y, -1, -2)  # (jc, R, C/D)
            y = y.reshape(j1, n_dev, r_loc, c_full // n_dev)
            y = lax.all_to_all(y, axis_name, split_axis=1, concat_axis=2)  # (jc, R/D, D, C/D)
            y = y.reshape(j1, r_loc, c_full)  # (jc, R/D, C)
            y = jnp.moveaxis(y, -3, -2)  # (R/D, jc, C)
            return _imodwt(y, wavelet, **kw)  # (R/D, C)

        mapped = shard_map(
            _local, mesh=mesh,
            in_specs=P(None, None, axis_name, None),
            out_specs=P(axis_name, None),
        )
        return jax.jit(mapped)

    run = _get_or_build(
        ("imodwt2d", mesh, axis_name, _fb_key(wavelet), j1, r, c,
         tuple(sorted(kw.items()))),
        _build,
    )
    return run(coeffs)


def cwt_time_sharded(
    signal,
    scales,
    wavelet,
    mesh: Mesh,
    sampling_rate: float = 1.0,
    axis_name: str | None = None,
) -> CWTResult:
    """FFT-based CWT with the *time axis* sharded across the mesh.

    :func:`cwt_scale_sharded` replicates the signal (and its FFT) on every
    chip, so the signal itself must fit in one chip's HBM. This variant keeps
    the signal time-sharded end to end via the distributed four-step FFT
    (parallel/pfft.py): one forward pFFT, a purely local per-scale multiply
    — the analytic conj(psi_hat(a*omega)) is evaluated *on each chip at its
    own frequencies* of the (D, L) spectrum layout, derived from
    ``axis_index`` — and one inverse pFFT batched over scales. Working set
    per chip is O(S * N/D); communication is all_to_all.

    Requires a power-of-two signal length (the fused single-chip path pads
    nothing for such lengths, so results match it exactly; arbitrary-length
    padding would force a resharding — use the single-chip path there).
    Returns a CWTResult whose coefficients (S, N) are sharded on the time
    axis.
    """
    from .pfft import pfft_local, pifft_local, _check_geometry
    from ..ops.butterfly import ensure_float
    from ..utils.numerics import is_power_of_two

    axis_name = axis_name or mesh.axis_names[0]
    n_dev = mesh.shape[axis_name]
    wav = get_continuous_wavelet(wavelet)
    scales = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    signal = ensure_float(jnp.asarray(signal))
    if signal.ndim != 1:
        raise JWaveFailure("cwt_time_sharded - expects a 1D signal (shard batches separately)")
    n = signal.shape[-1]
    if not is_power_of_two(n):
        raise JWaveFailure(
            f"cwt_time_sharded - length {n} must be a power of two (padding "
            "would force a resharding; use cwt/cwt_scale_sharded instead)"
        )
    _check_geometry(n, n_dev, "cwt_time_sharded")
    fs = float(sampling_rate)
    a_host = jnp.asarray(scales)

    def _build():
        def _local(v, a):  # v: (L,), a: (S,)
            spec = pfft_local(v, axis_name)  # (D, L/D) block of the (D, L) layout
            k = _local_freq_bins(n, n_dev, axis_name)
            fdtype = jnp.float64 if v.dtype == jnp.float64 else jnp.float32
            omega = 2.0 * np.pi * fs / n * k.astype(fdtype)
            omega = jnp.where(k > n // 2, omega - 2.0 * np.pi * fs, omega)
            w_hat = jnp.conj(wav.psi_hat_scaled(omega[None], a[:, None, None]))  # (S, D, L/D)
            prod = w_hat.astype(spec.dtype) * spec[None]
            return pifft_local(prod, axis_name)  # (S, L)

        mapped = shard_map(
            _local, mesh=mesh,
            in_specs=(P(axis_name), P(None)),
            out_specs=P(None, axis_name),
        )
        return jax.jit(mapped)

    run = _get_or_build(
        ("cwt_time", mesh, axis_name, _wav_key(wav), n, fs), _build
    )
    coeffs = run(signal, a_host)
    time_axis = jnp.arange(n) / fs
    return CWTResult(coeffs, a_host, time_axis, fs, wav.name)
