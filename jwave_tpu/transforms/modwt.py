"""MODWT — Maximal Overlap Discrete Wavelet Transform (the flagship).

Reference: jwave/transforms/MODWTTransform.java (913 LoC). Shift-invariant,
no-downsampling transform on arbitrary-length signals:

  * base filters = unit-L2-normalized analysis filters scaled by 1/sqrt(2)
    (MODWTTransform.java:469-475)
  * level-j filters = base upsampled with 2^(j-1)-1 zeros between taps
    (:618-630), wrapped modulo N when longer than the signal (:729-741)
  * forward:  W_j = h_j (*) V_{j-1},  V_j = g_j (*) V_{j-1}   (:256-306)
  * inverse:  V_{j-1} = g_j (*)^T V_j + h_j (*)^T W_j          (:337-375)
  * convolution method AUTO selects FFT iff N*M > threshold (4096 default,
    :144, :640-664)

Design: all per-level filters (or their rfft spectra) are computed
host-side at trace time and folded into the program as constants — the
reference's ConcurrentHashMap filter cache and double-checked locking
(:452-593) have no equivalent because there is nothing left to cache. The
two per-level convolutions share one signal FFT and one batched inverse FFT.
Output layout: (..., J+1, N) rows [W_1 .. W_J, V_J].
"""
from __future__ import annotations

from enum import Enum

import numpy as np
import jax.numpy as jnp

from ..exceptions import JWaveFailure
from ..filters import get_filter
from ..ops.butterfly import ensure_float
from ..ops.circular import (
    circular_conv,
    circular_conv_adjoint,
    filter_spectrum,
    wrap_filter,
)
from ..utils.numerics import exponent_of_two, is_power_of_two

#: maximum supported decomposition level (MODWTTransform.java:111)
MAX_DECOMPOSITION_LEVEL = 13

#: AUTO method threshold on N*M (MODWTTransform.java:144)
DEFAULT_FFT_THRESHOLD = 4096


class ConvolutionMethod(Enum):
    """MODWTTransform.ConvolutionMethod (MODWTTransform.java:149-153), plus
    MXU: composite-filter banded tile matmuls (ops.mxu_modwt), reachable
    only explicitly — AUTO never picks it."""

    AUTO = "auto"
    DIRECT = "direct"
    FFT = "fft"
    MXU = "mxu"


def _modwt_base_filters(wavelet):
    """Unit-L2-normalized analysis filters scaled by 1/sqrt(2) (:469-475)."""
    fb = get_filter(wavelet)
    g = np.asarray(fb.dec_lo, dtype=np.float64).copy()
    h = np.asarray(fb.dec_hi, dtype=np.float64).copy()
    for f in (g, h):
        nrm = np.sqrt(np.sum(f * f))
        if nrm > 1e-12:
            f /= nrm
    return g / np.sqrt(2.0), h / np.sqrt(2.0)


def _upsample(f: np.ndarray, level: int) -> np.ndarray:
    """Insert 2^(j-1)-1 zeros between taps (:618-630)."""
    if level <= 1:
        return f
    gap = (1 << (level - 1)) - 1
    out = np.zeros(f.shape[0] + (f.shape[0] - 1) * gap, dtype=np.float64)
    out[:: gap + 1] = f
    return out


def _level_filters(wavelet, level: int, n: int):
    """Per-level wrapped filters [(g_j, h_j)] as host constants."""
    g0, h0 = _modwt_base_filters(wavelet)
    return [
        (wrap_filter(_upsample(g0, j), n), wrap_filter(_upsample(h0, j), n))
        for j in range(1, level + 1)
    ]


def _use_fft(method: ConvolutionMethod, n: int, m: int, threshold: int) -> bool:
    if method is ConvolutionMethod.FFT:
        return True
    if method is ConvolutionMethod.DIRECT:
        return False
    return n * m > threshold


_spec = filter_spectrum  # shared wrap/pad + rfft semantics (ops.circular)


def _cascade_spectra(wavelet, level: int, n: int, start: int = 0) -> np.ndarray:
    """(J-start+1, n//2+1) complex128: frequency response of rows
    W_{start+1} .. W_J, V_J relative to the level-``start`` smooth V_start.

    The per-level recursion V_j = g_j (*) V_{j-1}, W_j = h_j (*) V_{j-1}
    telescopes in the frequency domain to

        W_j_hat = H_j * prod_{start < i < j} G_i,  V_J_hat = prod G_i,

    so the forward MODWT from V_start down is ONE rfft and ONE batched
    irfft against these host-precomputed responses — J x fewer FFTs than
    the reference's level-sequential FFT path (MODWTTransform.java:752-786)
    with identical linear-operator semantics. The inverse telescopes the
    same way with conjugated responses. ``start > 0`` supports the
    reference's per-level AUTO routing (MODWTTransform.java:640-664): the
    shallow levels (small upsampled supports M_j) run as direct
    convolutions, the deep tail as one FFT cascade.
    """
    filters = _level_filters(wavelet, level, n)[start:]
    rows = level - start
    out = np.empty((rows + 1, n // 2 + 1), dtype=np.complex128)
    g_acc = np.ones(n // 2 + 1, dtype=np.complex128)
    for j, (gj, hj) in enumerate(filters):
        out[j] = _spec(hj, n) * g_acc
        g_acc = g_acc * _spec(gj, n)
    out[rows] = g_acc
    return out


def _direct_prefix_levels(wavelet, level: int, n: int,
                          method: ConvolutionMethod, threshold: int) -> int:
    """Per-level AUTO routing (MODWTTransform.java:640-664): the reference
    picks FFT-vs-direct per convolution per level with threshold N*M_j,
    where M_j = (M-1)(2^(j-1)) + ... grows with j — so AUTO is always a
    direct prefix (levels 1..k) followed by an FFT tail (k+1..J). Returns
    k: 0 = pure FFT, ``level`` = pure direct."""
    if method is ConvolutionMethod.FFT:
        return 0
    if method is ConvolutionMethod.DIRECT:
        return level
    k = 0
    while k < level and n * _upsample_len(wavelet, k + 1) <= threshold:
        k += 1
    return k


def _validate_level(n: int, level: int, who: str):
    if level < 1:
        raise JWaveFailure(f"{who} - decomposition level must be at least 1, got {level}")
    if level > MAX_DECOMPOSITION_LEVEL:
        raise JWaveFailure(
            f"{who} - maximum supported decomposition level is {MAX_DECOMPOSITION_LEVEL}, got {level}"
        )
    theoretical = n.bit_length() - 1 if n > 0 else 0
    if level > theoretical:
        raise JWaveFailure(
            f"{who} - level {level} exceeds theoretical limit {theoretical} for signal length {n}"
        )


def modwt(
    x,
    wavelet,
    level: int,
    method: ConvolutionMethod = ConvolutionMethod.AUTO,
    fft_threshold: int = DEFAULT_FFT_THRESHOLD,
    boundary: str = "periodic",
    truncate: bool = True,
):
    """Forward MODWT along the last axis (arbitrary length), batched.

    Returns (..., level+1, N): rows [W_1, ..., W_J, V_J]
    (MODWTTransform.java:256-306).

    ``boundary``: "periodic" (circular, the reference's convention) or
    "reflection" (wmtsa's alternative: the signal is extended to
    ``[x, reverse(x)]``, removing wrap artifacts where the two signal ends
    differ). With reflection, ``truncate=True`` (default) returns the first
    N coefficient columns for analysis; ``truncate=False`` returns all 2N
    columns, which :func:`imodwt` inverts exactly (take the first N samples
    of its output). Truncated reflection coefficients are not invertible.
    """
    if boundary == "reflection":
        x = ensure_float(jnp.asarray(x))
        if x.shape[-1] > 0:
            # validate against the USER's length, not the 2N extension — the
            # theoretical level limit must not loosen because of the mirror
            _validate_level(x.shape[-1], level, "modwt")
        ext = jnp.concatenate([x, jnp.flip(x, axis=-1)], axis=-1)
        c = modwt(ext, wavelet, level, method, fft_threshold)
        return c[..., : x.shape[-1]] if truncate else c
    if boundary != "periodic":
        raise JWaveFailure(
            f"modwt - boundary must be 'periodic' or 'reflection', got {boundary!r}"
        )
    x = ensure_float(jnp.asarray(x))
    n = x.shape[-1]
    if n == 0:
        # reference returns the expected structure with empty rows
        # (MODWTTransform.java:267-274)
        return jnp.zeros(x.shape[:-1] + (level + 1, 0), dtype=x.dtype)
    _validate_level(n, level, "modwt")

    # composite-filter tile matmuls (ops.mxu_modwt), explicit only
    if method is ConvolutionMethod.MXU:
        from ..ops.mxu_modwt import modwt_mxu, mxu_applicable

        if not mxu_applicable(x, level):
            raise JWaveFailure(
                "modwt - ConvolutionMethod.MXU needs a lane-aligned length "
                "(N % 128 == 0); use AUTO for other lengths"
            )
        lead = x.shape[:-1]
        flat = x.reshape((-1, n))
        return modwt_mxu(flat, wavelet, level).reshape(lead + (level + 1, n))

    # per-level AUTO routing (MODWTTransform.java:640-664): the shallow
    # levels whose N*M_j stay under the threshold run as direct circular
    # convolutions; all remaining levels collapse into ONE telescoped FFT
    # cascade on V_k (see _cascade_spectra) — faithful to the reference's
    # per-convolution choice while keeping the one-FFT formulation
    k = _direct_prefix_levels(wavelet, level, n, method, fft_threshold)
    rows = []
    v = x
    if k:
        for gj, hj in _level_filters(wavelet, level, n)[:k]:
            rows.append(circular_conv(v, hj))
            v = circular_conv(v, gj)
    if k == level:
        rows.append(v)
        return jnp.stack(rows, axis=-2)
    cdtype = jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64
    fil = jnp.asarray(_cascade_spectra(wavelet, level, n, start=k), dtype=cdtype)
    spec = jnp.fft.rfft(v, axis=-1)
    tail = jnp.fft.irfft(spec[..., None, :] * fil, n=n, axis=-1).astype(x.dtype)
    if not rows:
        return tail
    return jnp.concatenate([jnp.stack(rows, axis=-2), tail], axis=-2)


def _upsample_len(wavelet, j: int) -> int:
    m = get_filter(wavelet).length
    return m + (m - 1) * ((1 << (j - 1)) - 1)


def imodwt(
    coeffs,
    wavelet,
    method: ConvolutionMethod = ConvolutionMethod.AUTO,
    fft_threshold: int = DEFAULT_FFT_THRESHOLD,
):
    """Inverse MODWT from a (..., J+1, N) stack (MODWTTransform.java:337-375)."""
    coeffs = ensure_float(jnp.asarray(coeffs))
    level = coeffs.shape[-2] - 1
    n = coeffs.shape[-1]
    if n == 0:
        # mirror modwt's empty-input convention (reference returns empty)
        return jnp.zeros(coeffs.shape[:-2] + (0,), dtype=coeffs.dtype)
    if level < 1:
        raise JWaveFailure("imodwt - need at least level 1 (2 rows)")

    if method is ConvolutionMethod.MXU:
        from ..ops.mxu_modwt import imodwt_mxu, mxu_applicable

        if not mxu_applicable(coeffs, level):
            raise JWaveFailure(
                "imodwt - ConvolutionMethod.MXU needs a lane-aligned length "
                "(N % 128 == 0); use AUTO for other lengths"
            )
        lead = coeffs.shape[:-2]
        flat = coeffs.reshape((-1, level + 1, n))
        return imodwt_mxu(flat, wavelet).reshape(lead + (n,))

    # per-level AUTO routing, mirroring the forward: the deep tail
    # (levels k+1..J, large upsampled supports) collapses into one
    # telescoped conjugate cascade producing V_k; the shallow prefix runs
    # as direct adjoint convolutions (MODWTTransform.java:640-664, :798-837)
    k = _direct_prefix_levels(wavelet, level, n, method, fft_threshold)
    if k < level:
        tail = coeffs[..., k:, :]  # rows W_{k+1}..W_J, V_J
        cdtype = jnp.complex128 if coeffs.dtype == jnp.float64 else jnp.complex64
        fil = jnp.asarray(np.conj(_cascade_spectra(wavelet, level, n, start=k)), dtype=cdtype)
        spec = jnp.fft.rfft(tail, axis=-1)  # (..., J-k+1, nf)
        v_hat = jnp.sum(spec * fil, axis=-2)
        v = jnp.fft.irfft(v_hat, n=n, axis=-1).astype(coeffs.dtype)
    else:
        v = coeffs[..., level, :]
    filters = _level_filters(wavelet, level, n)
    for j in range(k, 0, -1):
        gj, hj = filters[j - 1]
        w = coeffs[..., j - 1, :]
        v = circular_conv_adjoint(v, gj) + circular_conv_adjoint(w, hj)
    return v


def modwt_1d(x, wavelet, level: int | None = None, **kw):
    """Flattened 1D facade: (..., N) -> (..., (J+1)*N), power-of-two N
    (MODWTTransform.java:388-417, :853-878)."""
    n = x.shape[-1]
    if not is_power_of_two(n):
        raise JWaveFailure("modwt_1d - given last-axis length is not 2^p")
    max_level = exponent_of_two(n)
    if level is None:
        level = max_level
    if level < 0 or level > max_level:
        raise JWaveFailure("modwt_1d - given level is out of range for given array")
    c = modwt(x, wavelet, level, **kw)
    return c.reshape(c.shape[:-2] + ((level + 1) * n,))


def imodwt_1d(flat, wavelet, level: int | None = None, **kw):
    """Inverse of :func:`modwt_1d`; infers (N, J) like the reference when
    ``level`` is omitted (MODWTTransform.java:880-912)."""
    total = flat.shape[-1]
    if level is None:
        n = 0
        for test_n in range(1, total + 1):
            if total % test_n == 0:
                test_levels = total // test_n - 1
                if test_levels >= 0 and is_power_of_two(test_n) and test_levels <= exponent_of_two(test_n):
                    n, level = test_n, test_levels
                    break
        if n == 0:
            raise JWaveFailure("imodwt_1d - cannot determine original signal dimensions")
    else:
        n = total // (level + 1)
        if not is_power_of_two(n) or total != n * (level + 1):
            raise JWaveFailure("imodwt_1d - invalid coefficient array for given level")
    coeffs = flat.reshape(flat.shape[:-1] + (level + 1, n))
    return imodwt(coeffs, wavelet, **kw)


def modwt_2d(mat, wavelet, level: int, **kw):
    """Separable 2D MODWT: rows then columns of each subband.

    Returns (..., J+1, J+1, R, C): entry (jr, jc) filters rows with the
    level-jc row response and columns with the level-jr response. The
    reference cannot express this (its 1D facade flattens to (J+1)*N, which
    breaks the separable driver's length checks); standard in e.g.
    PyWavelets as ``swt2``. Perfectly invertible via :func:`imodwt_2d`.
    """
    rows = modwt(mat, wavelet, level, **kw)  # (..., R, J+1, C)
    rows = jnp.moveaxis(rows, -2, -3)  # (..., J+1, R, C)
    cols = jnp.swapaxes(rows, -1, -2)  # (..., J+1, C, R)
    cols = modwt(cols, wavelet, level, **kw)  # (..., J+1, C, J+1, R)
    cols = jnp.moveaxis(cols, -2, -4)  # (..., J+1, J+1, C, R)
    return jnp.swapaxes(cols, -1, -2)  # (..., jr, jc, R, C)


def imodwt_2d(coeffs, wavelet, **kw):
    """Inverse of :func:`modwt_2d`."""
    c = jnp.swapaxes(coeffs, -1, -2)  # (..., J+1, J+1, C, R)
    c = jnp.moveaxis(c, -4, -2)  # (..., J+1, C, J+1, R)
    c = imodwt(c, wavelet, **kw)  # (..., J+1, C, R)
    c = jnp.swapaxes(c, -1, -2)  # (..., J+1, R, C)
    c = jnp.moveaxis(c, -3, -2)  # (..., R, J+1, C)
    return imodwt(c, wavelet, **kw)  # (..., R, C)


def modwt_mra_2d(mat, wavelet, level: int, **kw):
    """2D MODWT multiresolution analysis: additive subband-image components.

    Returns (..., J+1, J+1, R, C): component (jr, jc) is the inverse 2D
    MODWT of the isolated (jr, jc) subband, and the (J+1)^2 components sum
    to the input image exactly (the 2D analog of :func:`modwt_mra`; wmtsa's
    image MRA). All (J+1)^2 inverses run as one batched inverse over the
    flattened band axis. ``boundary="reflection"`` analyzes the doubly
    mirrored extension and truncates the components back to (R, C).
    """
    if "truncate" in kw:
        raise JWaveFailure("modwt_mra_2d - 'truncate' is managed internally")
    boundary = kw.pop("boundary", "periodic")
    if boundary == "reflection":
        mat = ensure_float(jnp.asarray(mat))
        r, c = mat.shape[-2:]
        if min(r, c) > 0:
            # validate against the USER's image size, not the 2Rx2C mirror
            _validate_level(min(r, c), level, "modwt_mra_2d")
        ext = jnp.concatenate([mat, jnp.flip(mat, axis=-1)], axis=-1)
        ext = jnp.concatenate([ext, jnp.flip(ext, axis=-2)], axis=-2)
        return modwt_mra_2d(ext, wavelet, level, **kw)[..., :r, :c]
    if boundary != "periodic":
        raise JWaveFailure(
            f"modwt_mra_2d - boundary must be 'periodic' or 'reflection', got {boundary!r}"
        )
    coeffs = modwt_2d(mat, wavelet, level, **kw)  # (..., J+1, J+1, R, C)
    rows = level + 1
    eye = jnp.eye(rows * rows, dtype=coeffs.dtype).reshape(
        (rows * rows, rows, rows)
    )  # band b isolated in the (jr, jc) grid
    isolated = eye[:, :, :, None, None] * coeffs[..., None, :, :, :, :]
    comp = imodwt_2d(isolated, wavelet, **kw)  # (..., J+1*J+1, R, C)
    return comp.reshape(comp.shape[:-3] + (rows, rows) + comp.shape[-2:])


def modwt_mra(x, wavelet, level: int, boundary: str = "periodic", **kw):
    """MODWT multiresolution analysis: additive detail/smooth decomposition.

    Returns (..., J+1, N): rows [D_1 .. D_J, S_J] with ``sum(rows) == x``
    exactly (each row is the inverse MODWT of one isolated subband; the
    inverse is linear, so the rows partition the signal). The classic
    wmtsa/PyWavelets ``mra`` companion the reference lacks — and because the
    band isolation is a diagonal mask, all J+1 inverses run as ONE batched
    inverse on the subband axis. ``boundary="reflection"``
    runs the analysis on the reflected extension and truncates the
    components back to N — still exactly additive, without wrap artifacts.
    """
    if "truncate" in kw:
        raise JWaveFailure(
            "modwt_mra - truncation is managed internally (the full "
            "coefficient stack is needed for exact additivity); do not pass "
            "'truncate'"
        )
    x = ensure_float(jnp.asarray(x))
    n = x.shape[-1]
    coeffs = modwt(x, wavelet, level, boundary=boundary, truncate=False, **kw)
    rows = level + 1
    eye = jnp.eye(rows, dtype=coeffs.dtype)  # (rows, rows)
    # (..., band b, J+1, N): subband j kept only where j == b
    isolated = eye[:, :, None] * coeffs[..., None, :, :]
    return imodwt(isolated, wavelet, **kw)[..., :n]  # (..., J+1, N)


def _detail_moments(cx, cy, wavelet, level: int, unbiased: bool, name: str):
    """Per-level second moments E[W_jx * W_jy] of two coefficient stacks
    (..., J+1, N), dropping the L_j - 1 circular-boundary coefficients when
    ``unbiased`` (L_j = (M-1)(2^j - 1) + 1, the level-j filter support).
    Shared core of the variance/covariance estimators."""
    n = cx.shape[-1]
    m = get_filter(wavelet).length
    dx = cx[..., :level, :]
    dy = cy[..., :level, :]
    if not unbiased:
        return jnp.mean(dx * dy, axis=-1)
    out = []
    for j in range(1, level + 1):
        l_j = (m - 1) * ((1 << j) - 1) + 1
        if n - (l_j - 1) <= 0:
            raise JWaveFailure(
                f"{name} - unbiased estimator needs N > L_j - 1 = {l_j - 1} "
                f"at level {j} (N = {n}); pass unbiased=False"
            )
        out.append(jnp.mean(dx[..., j - 1, l_j - 1:] * dy[..., j - 1, l_j - 1:], axis=-1))
    return jnp.stack(out, axis=-1)


def _reject_truncate(kw, who: str):
    """The scale statistics assume one coefficient column per input sample;
    a 2N reflected stack (truncate=False) would silently double-count the
    mirrored half and misalign the unbiased boundary drop."""
    if "truncate" in kw:
        raise JWaveFailure(
            f"{who} - 'truncate' is not accepted here; the estimators operate "
            f"on the length-N coefficient columns"
        )


def modwt_variance(x, wavelet, level: int, unbiased: bool = True, **kw):
    """Wavelet variance per level: nu_j^2 = E[W_j^2] (Percival & Walden ch. 8).

    ``unbiased=True`` drops the L_j - 1 boundary coefficients of each level
    (L_j = (M-1)(2^j - 1) + 1, the level-j filter support) so only
    coefficients unaffected by circular wrap are averaged — the standard
    estimator. Returns (..., J) detail-level variances (the V_J row is
    excluded, as in wmtsa). Requires N > L_J - 1 for the unbiased form.
    """
    _reject_truncate(kw, "modwt_variance")
    coeffs = modwt(x, wavelet, level, **kw)  # (..., J+1, N)
    return _detail_moments(coeffs, coeffs, wavelet, level, unbiased, "modwt_variance")


def modwt_variance_ci(x, wavelet, level: int, confidence: float = 0.95,
                      unbiased: bool = True, **kw):
    """Wavelet variance with chi-squared confidence intervals.

    Returns ``(var, lo, hi)``, each (..., J). Uses the Percival & Walden
    "EDOF 3" equivalent degrees of freedom eta_j = max(M_j / 2^j, 1) with
    M_j the interior coefficient count (N - L_j + 1 when unbiased, N
    otherwise), and the interval
    ``[eta v / Q_eta((1+c)/2), eta v / Q_eta((1-c)/2)]`` (eq. 313).
    """
    from scipy.stats import chi2

    if not 0.0 < confidence < 1.0:
        raise JWaveFailure(
            f"modwt_variance_ci - confidence must be in (0, 1), got {confidence}"
        )
    x = ensure_float(jnp.asarray(x))
    var = modwt_variance(x, wavelet, level, unbiased=unbiased, **kw)
    n = x.shape[-1]
    m = get_filter(wavelet).length
    eta, q_hi, q_lo = [], [], []
    for j in range(1, level + 1):
        l_j = (m - 1) * ((1 << j) - 1) + 1
        m_j = (n - l_j + 1) if unbiased else n
        e = max(m_j / float(1 << j), 1.0)
        eta.append(e)
        q_hi.append(chi2.ppf((1.0 + confidence) / 2.0, e))
        q_lo.append(chi2.ppf((1.0 - confidence) / 2.0, e))
    eta = jnp.asarray(np.array(eta), var.dtype)
    lo = eta * var / jnp.asarray(np.array(q_hi), var.dtype)
    hi = eta * var / jnp.asarray(np.array(q_lo), var.dtype)
    return var, lo, hi


def modwt_covariance(x, y, wavelet, level: int, unbiased: bool = True, **kw):
    """Wavelet covariance per level: nu_jxy = E[W_jx * W_jy] (Percival &
    Walden ch. 8.6 / Whitcher-Guttorp-Percival 2000) — the scale-by-scale
    decomposition of Cov(x, y). Same boundary handling as
    :func:`modwt_variance`; returns (..., J)."""
    x = ensure_float(jnp.asarray(x))
    y = ensure_float(jnp.asarray(y))
    if x.shape[-1] != y.shape[-1]:
        raise JWaveFailure(
            f"modwt_covariance - signals must share their last-axis length "
            f"(got {x.shape[-1]} and {y.shape[-1]})"
        )
    _reject_truncate(kw, "modwt_covariance")
    cx = modwt(x, wavelet, level, **kw)
    cy = modwt(y, wavelet, level, **kw)
    return _detail_moments(cx, cy, wavelet, level, unbiased, "modwt_covariance")


def modwt_correlation(x, y, wavelet, level: int, unbiased: bool = True, **kw):
    """Wavelet correlation per level: nu_jxy / (nu_jx * nu_jy) in [-1, 1] —
    the scale-by-scale correlation spectrum of two signals. Returns (..., J)."""
    x = ensure_float(jnp.asarray(x))
    y = ensure_float(jnp.asarray(y))
    if x.shape[-1] != y.shape[-1]:
        raise JWaveFailure(
            f"modwt_correlation - signals must share their last-axis length "
            f"(got {x.shape[-1]} and {y.shape[-1]})"
        )
    _reject_truncate(kw, "modwt_correlation")
    cx = modwt(x, wavelet, level, **kw)
    cy = modwt(y, wavelet, level, **kw)
    cov = _detail_moments(cx, cy, wavelet, level, unbiased, "modwt_correlation")
    vx = _detail_moments(cx, cx, wavelet, level, unbiased, "modwt_correlation")
    vy = _detail_moments(cy, cy, wavelet, level, unbiased, "modwt_correlation")
    return jnp.clip(cov / jnp.sqrt(vx * vy), -1.0, 1.0)


def wavelet_log_spectrum(x, wavelet, level: int, unbiased: bool = True, **kw):
    """Logscale diagram: per-level ``log2`` wavelet variance plus the
    weighted-least-squares line fitted through it (Abry & Veitch 1998).

    Long-memory processes have ``nu_j^2 ~ tau_j^alpha`` with ``tau_j =
    2^(j-1)``, so ``log2 nu_j^2`` is affine in the octave j; the fitted
    slope is the scaling exponent alpha. Weights are the Abry-Veitch
    ``1/Var[log2 nu_hat_j^2]`` with ``Var ~ 2 / (n_j ln^2 2)`` for the
    ``n_j`` interior coefficients at level j — deeper (sparser) octaves
    count less. The regression is closed form, batched over leading axes.

    Returns ``(log2_var, slope, intercept)`` with shapes ``(..., J)``,
    ``(...)``, ``(...)``.
    """
    if level < 2:
        raise JWaveFailure("wavelet_log_spectrum - need level >= 2 to fit a slope")
    x = ensure_float(jnp.asarray(x))
    var = modwt_variance(x, wavelet, level, unbiased=unbiased, **kw)
    n = x.shape[-1]
    m = get_filter(wavelet).length
    j = np.arange(1, level + 1, dtype=np.float64)
    if unbiased:
        n_j = np.array([n - (m - 1) * ((1 << int(jj)) - 1) for jj in j], dtype=np.float64)
    else:
        n_j = np.full(level, float(n))
    w = n_j / n_j.sum()  # Var[log2 v_j] ~ 2/(n_j ln^2 2) -> weights ~ n_j
    y = jnp.log2(var)
    jbar = float((w * j).sum())
    denom = float((w * (j - jbar) ** 2).sum())
    jw = jnp.asarray(w * (j - jbar) / denom, dtype=y.dtype)
    slope = jnp.sum(y * jw, axis=-1)
    intercept = jnp.sum(y * jnp.asarray(w, dtype=y.dtype), axis=-1) - slope * jbar
    return y, slope, intercept


def hurst_exponent(x, wavelet="db4", level: int | None = None,
                   kind: str = "fgn", unbiased: bool = True, **kw):
    """Wavelet-domain Hurst exponent (Abry-Veitch logscale regression).

    The MODWT wavelet variance of a long-memory process scales as
    ``nu_j^2 ~ tau_j^(2H-2)`` for stationary fractional Gaussian noise
    (band-integrating its ``f^(1-2H)`` spectrum over the level-j octave)
    and ``tau_j^(2H)`` for nonstationary fractional Brownian motion, so
    the logscale slope alpha of :func:`wavelet_log_spectrum` maps to
    ``H = alpha/2 + 1`` (``kind="fgn"``, e.g. network traffic, volatility
    increments) and ``H = alpha/2`` (``kind="fbm"``, the cumulative
    path). Note this differs by 1 in alpha from the DWT-energy convention
    of Abry-Veitch (their d_{j,k} carry a 2^(j/2) the MODWT folds into its
    rescaled filters). ``level=None`` picks the deepest
    level whose unbiased interior keeps at least 16 coefficients. Returns
    H with the leading batch shape of ``x``; jit/vmap/grad-compatible.

    Validated against synthesized fGn/fBm across H in [0.2, 0.9]
    (tests/test_modwt.py); the reference library has no estimator layer.
    """
    if kind not in ("fgn", "fbm"):
        raise JWaveFailure(f"hurst_exponent - kind must be 'fgn' or 'fbm', got {kind!r}")
    x = ensure_float(jnp.asarray(x))
    n = x.shape[-1]
    m = get_filter(wavelet).length
    if level is None:
        level = 0
        while level < MAX_DECOMPOSITION_LEVEL:
            if unbiased:
                # deepest level whose unbiased interior keeps >= 16 coeffs
                l_next = (m - 1) * ((1 << (level + 1)) - 1) + 1
                if n - (l_next - 1) < 16:
                    break
            elif (1 << (level + 1)) * 4 > n:
                # biased estimator: just keep a few coefficients per
                # effective scale so the deepest octave is estimable
                break
            level += 1
        if level < 2:
            raise JWaveFailure(
                f"hurst_exponent - signal too short for a level-2 "
                f"{'unbiased ' if unbiased else ''}fit with {m}-tap "
                f"'{wavelet}' (N = {n})"
            )
    _, slope, _ = wavelet_log_spectrum(x, wavelet, level, unbiased=unbiased, **kw)
    return slope / 2.0 + 1.0 if kind == "fgn" else slope / 2.0
