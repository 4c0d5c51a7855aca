"""Wavelet scattering transform (Mallat 2012; Andén & Mallat 2014) —
capability superset.

The reference library stops at raw wavelet coefficients; this module adds
the order-2 scattering network — the standard translation-invariant,
deformation-stable signal representation built from the same wavelet
machinery:

- On the spectral hatch (``config.set_mxu_dft('off')``) the whole network
  is THREE batched pow-2 FFT convolution rounds with the envelope spectra
  ``fft(U1)`` shared between the first-order lowpass and the second-order
  bank. On the default matmul route that FFT work is reassociated into
  matmuls and tap convolutions: in 1D, order 1's near-full-rate
  bands are strided circular tap convolutions of the signal itself (a
  Gaussian frequency bump is Gaussian in time, ~100*r taps —
  ops/mxu_bandconv.py), its heavily decimated bands fold psi1's support
  window onto the short rate-r grid before a small inverse FFT, and
  order 2 plus every lowpass are strided tap convolutions too; in 2D
  every band conv restricts to its bump's frequency support box as two
  skinny matmuls whose offset phases die under the modulus
  (ops/mxu_dft2d.py). Exact up to a ~1e-7 Gaussian-tail truncation,
  pinned against the hatch in tests.
- Filter bank, path table and output shapes are all static functions of
  ``(N, J, Q)`` — one XLA program per geometry, jit/vmap/grad compatible,
  and the batch axis shards with :func:`jwave_tpu.parallel.batch_sharded`
  unchanged.

Filters are Gaussian (log-)frequency bumps: ``psi_hat_xi(w) =
exp(-(w - xi)^2 / (2 sigma^2)) - kappa exp(-w^2 / (2 sigma^2))`` with the
Morlet zero-mean correction ``kappa = psi_hat(0-bump)`` so every wavelet
has exactly zero DC response, and ``phi_hat(w) = exp(-w^2 / (2 sigma_J^2))``
with ``sigma_J`` proportional to ``2^-J``. Frequencies are normalized
(cycles/sample); the top center frequency is 0.35 as in the standard
scattering literature. Peak gain is 1 (so ``|x * psi|`` is the half-sided
analytic envelope scale used by the scattering papers).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from .. import config
from ..exceptions import JWaveFailure
from ..ops.mxu_common import dot
from ..utils.numerics import next_power_of_two
from .cwt import PaddingType, pad_signal
from .fft import fft as _fft, ifft as _ifft

XI_MAX = 0.35  # top center frequency, cycles/sample (scattering convention)


def _lowpass_matrix(phi_1d: np.ndarray, out_idx: np.ndarray) -> np.ndarray:
    """Sampled circulant of a real-even spectral filter: row i of
    ``iDFT . diag(phi) . DFT`` at output position ``out_idx[i]``, i.e.
    ``A[i, t] = c[(out_idx[i] - t) mod m]`` with ``c = ifft(phi).real``.

    Composing the lowpass chain fft -> *phi -> ifft -> crop -> stride
    into ONE (frames, m) real matrix turns up to three FFT passes into a
    single skinny matmul per axis, exactly (the same linear operator,
    reassociated)."""
    c = np.fft.ifft(np.asarray(phi_1d, dtype=np.float64)).real
    m = len(c)
    return c[(np.asarray(out_idx)[:, None] - np.arange(m)[None, :]) % m]


#: above this grid length the composed lowpass matrix (frames x m) is
#: skipped in favor of the FFT path — bounds the baked-constant footprint
MAX_LOWPASS_M = 16384


# --------------------------------------------------------------------------
# Filter-bank design (NumPy at trace time — shapes/paths are static)
# --------------------------------------------------------------------------

def _xi_grid(J: int, Q: int) -> np.ndarray:
    """Geometric center-frequency grid: Q wavelets per octave spanning J
    octaves below XI_MAX (J*Q + 1 filters, descending)."""
    j = np.arange(J * Q + 1, dtype=np.float64)
    return XI_MAX * 2.0 ** (-j / Q)


def _sigma_for(xi: np.ndarray, Q: int) -> np.ndarray:
    """Bandwidth of the Gaussian bump at center xi for quality factor Q:
    adjacent filters (ratio r = 2^(1/Q)) cross at half power at the
    arithmetic midpoint of their centers."""
    r = 2.0 ** (1.0 / Q)
    return xi * (1.0 - 1.0 / r) / (2.0 * math.sqrt(math.log(2.0)))


def _gauss_bump(freqs: np.ndarray, xi: float, sigma: float) -> np.ndarray:
    """Zero-mean Gaussian bump on the full FFT frequency axis (analytic:
    support on positive frequencies only; the DC-correction term keeps
    psi_hat(0) == 0 exactly)."""
    g = np.exp(-((freqs - xi) ** 2) / (2.0 * sigma**2))
    kappa = math.exp(-(xi**2) / (2.0 * sigma**2))
    return g - kappa * np.exp(-(freqs**2) / (2.0 * sigma**2))


@dataclass(frozen=True)
class ScatteringBank:
    """Static filter bank + path table for one (padded_len, J, Q1, Q2)."""

    psi1_hat: np.ndarray  # (K1, P) float64
    psi2_hat: np.ndarray  # (K2, P) float64
    phi_hat: np.ndarray  # (P,) float64
    xi1: np.ndarray  # (K1,) cycles/sample
    xi2: np.ndarray  # (K2,)
    paths: np.ndarray  # (P2, 2) int — (k1 index, k2 index), xi2 < xi1


from collections import OrderedDict as _OrderedDict

_BANK_CACHE: _OrderedDict = _OrderedDict()
_BANK_CACHE_MAX = 8  # float64 banks run to tens of MB each


def _bank_cache_put(key, bank):
    _BANK_CACHE[key] = bank
    while len(_BANK_CACHE) > _BANK_CACHE_MAX:
        _BANK_CACHE.popitem(last=False)
    return bank


def _bank_cache_get(key):
    if key in _BANK_CACHE:
        _BANK_CACHE.move_to_end(key)
        return _BANK_CACHE[key]
    return None


def scattering_filter_bank(padded: int, J: int, Q1: int, Q2: int = 1) -> ScatteringBank:
    """Build (and cache) the frequency-domain filter bank on a ``padded``-
    point FFT grid. Positive AND negative frequency bins are evaluated so
    the bumps are genuinely analytic on the discrete grid."""
    key = (padded, J, Q1, Q2)
    hit = _bank_cache_get(key)
    if hit is not None:
        return hit
    i = np.arange(padded, dtype=np.float64)
    freqs = i / padded
    freqs[i > padded // 2] -= 1.0  # [-0.5, 0.5) fold, cycles/sample

    xi1 = _xi_grid(J, Q1)
    s1 = _sigma_for(xi1, Q1)
    xi2 = _xi_grid(J, Q2)
    s2 = _sigma_for(xi2, Q2)
    psi1 = np.stack([_gauss_bump(freqs, x, s) for x, s in zip(xi1, s1)])
    psi2 = np.stack([_gauss_bump(freqs, x, s) for x, s in zip(xi2, s2)])

    # lowpass: half-power point at the bottom of the wavelet ladder so phi
    # covers what the J-octave grid leaves out
    sigma_phi = XI_MAX * 2.0 ** (-float(J)) / math.sqrt(2.0 * math.log(2.0))
    phi = np.exp(-(freqs**2) / (2.0 * sigma_phi**2))

    # second-order paths: xi2 strictly below xi1 (the envelope |x * psi1|
    # has bandwidth ~ sigma1 < xi1; higher-frequency psi2 see ~no energy)
    paths = np.asarray(
        [(k1, k2) for k1 in range(len(xi1)) for k2 in range(len(xi2)) if xi2[k2] < xi1[k1]],
        dtype=np.int64,
    ).reshape(-1, 2)
    bank = ScatteringBank(psi1, psi2, phi, xi1, xi2, paths)
    return _bank_cache_put(key, bank)


# --------------------------------------------------------------------------
# Result container
# --------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclass
class ScatteringResult:
    """Order-0/1/2 scattering coefficients as a jax pytree.

    ``S0``: (..., T) — lowpass average of the signal itself.
    ``S1``: (..., K1, T) — first-order bands, one per psi1 filter.
    ``S2``: (..., P2, T) — second-order bands, one per (j1, j2) path.
    ``T = ceil(N / 2^J)`` time frames (stride ``2^J`` subsampling).
    """

    S0: jnp.ndarray
    S1: jnp.ndarray
    S2: jnp.ndarray
    xi1: np.ndarray  # static metadata (cycles/sample)
    xi2: np.ndarray
    paths: np.ndarray  # (P2, 2) (k1, k2) indices into xi1/xi2
    sampling_rate: float

    def tree_flatten(self):
        return (self.S0, self.S1, self.S2), (
            self.xi1.tobytes(),
            self.xi1.shape,
            self.xi2.tobytes(),
            self.xi2.shape,
            self.paths.tobytes(),
            self.paths.shape,
            self.sampling_rate,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        x1b, x1s, x2b, x2s, pb, ps, fs = aux
        return cls(
            *children,
            np.frombuffer(x1b, dtype=np.float64).reshape(x1s),
            np.frombuffer(x2b, dtype=np.float64).reshape(x2s),
            np.frombuffer(pb, dtype=np.int64).reshape(ps),
            fs,
        )

    @property
    def frequencies1(self) -> np.ndarray:
        """First-order center frequencies in Hz."""
        return self.xi1 * self.sampling_rate

    @property
    def n_paths(self) -> int:
        return int(self.paths.shape[0])

    def features(self):
        """All coefficients stacked on one band axis: (..., 1 + K1 + P2, T).
        The flat feature matrix scattering-based classifiers consume."""
        s0 = self.S0[..., None, :]
        return jnp.concatenate([s0, self.S1, self.S2], axis=-2)


# --------------------------------------------------------------------------
# Transform
# --------------------------------------------------------------------------

def scattering1d(
    signal,
    J: int,
    Q: int = 8,
    sampling_rate: float = 1.0,
    Q2: int = 1,
    padding: PaddingType = PaddingType.SYMMETRIC,
    oversampling: int = 0,
) -> ScatteringResult:
    """Order-2 wavelet scattering of (..., N) real signals.

    Args:
      signal: (..., N); leading axes batch through every stage.
      J: invariance scale — outputs are averaged over ``2^J`` samples and
        subsampled by the same stride (reduce with ``oversampling``).
      Q: first-order wavelets per octave (8-16 for audio, 1 for dyadic).
      sampling_rate: only scales the reported ``frequencies1`` metadata.
      Q2: second-order wavelets per octave (1 is standard).
      padding: boundary handling, same enum as :func:`jwave_tpu.cwt`;
        the signal is extended to ``next_pow2(2 N)`` so wavelets up to
        ``2^J`` wide see no circular wrap from the far end.
      oversampling: subsample by ``2^(J - oversampling)`` instead of
        ``2^J`` (0 = critical rate).

    Returns a :class:`ScatteringResult`. Everything is one jitted XLA
    program per (N, J, Q, Q2) geometry: 3 rounds of batched pow-2 FFTs
    with static filter/path tables baked in as constants.
    """
    x = jnp.asarray(signal)
    if x.ndim == 0:
        raise JWaveFailure("scattering1d - signal must have at least 1 axis")
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise JWaveFailure("scattering1d - expected a real signal")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    n = x.shape[-1]
    if n < 2:
        raise JWaveFailure("scattering1d - need at least 2 samples")
    if J < 1:
        raise JWaveFailure("scattering1d - J must be >= 1")
    if Q < 1 or Q2 < 1:
        raise JWaveFailure("scattering1d - Q and Q2 must be >= 1")
    if 2**J > n:
        raise JWaveFailure(
            f"scattering1d - invariance scale 2^{J} exceeds signal length {n}"
        )
    stride = 2 ** max(0, J - oversampling)

    padded = next_power_of_two(2 * n)
    bank = scattering_filter_bank(padded, J, Q, Q2)
    cdtype = jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64

    # Intermediate decimation (the kymatio design; round-3 reformulation —
    # the full-rate version ran EVERY first-order envelope and second-order
    # path at the padded length, ~4x the needed FFT work at audio shapes):
    #
    #  * order 1: x * psi1_k is band-limited, and |.| of an analytic band
    #    is invariant to where periodization folds the carrier, so u1 can
    #    be computed directly at a decimated rate by EXACT spectral
    #    periodization of X * psi1. The only approximation is the folding
    #    of the envelope's own spectral tail (the modulus has polynomial
    #    tails for noise-like bands — measured: energy 1e-4 beyond
    #    8 sigma1, 2.6e-7 beyond 32 sigma1). The fold boundary is kept at
    #    1/(2 r1) >= max(32 sigma1, xi2 + 8 sigma2 of the filter's
    #    highest-frequency path), bounding S1/S2 deviation from the
    #    full-rate transform at the ~1e-3 level (pinned in tests).
    #  * order 2: each path needs u1's spectrum only inside its psi2 bump,
    #    so V1 is further decimated per path by ideal-lowpass TRUNCATION
    #    (keep the lowest P/(2R) bins) to the rate R with
    #    1/(2 R) >= xi2 + 8 sigma2 — exact up to psi2's e^-32 Gaussian
    #    tail. R >= r1 holds by construction of r1.
    #
    # Filters sharing r1 (and paths sharing R) batch together; original
    # band order is restored at the end. oversampling >= J forces every
    # rate to 1 == the exact full-rate transform.
    sig1 = _sigma_for(bank.xi1, Q)
    sig2 = _sigma_for(bank.xi2, Q2)
    cut2 = bank.xi2 + 8.0 * sig2  # per-k2 Nyquist requirement

    def rate_for(cut: float) -> int:
        r = 1
        while r * 2 <= stride and 1.0 / (2.0 * r * 2) >= cut:
            r *= 2
        return r

    r1_of = np.ones(len(bank.xi1), dtype=np.int64)
    for k in range(len(bank.xi1)):
        pk2 = bank.paths[bank.paths[:, 0] == k, 1]
        need = max(cut2[pk2].max() if pk2.size else 0.0, 32.0 * sig1[k])
        r1_of[k] = rate_for(need)
    r_path = np.asarray(
        [max(rate_for(cut2[k2]), r1_of[k1]) for k1, k2 in bank.paths],
        dtype=np.int64,
    ) if len(bank.paths) else np.zeros(0, dtype=np.int64)

    xp = pad_signal(x, padded, padding)
    _X_cache: list = []

    def full_spec():
        """fft(xp), computed at most once — the matmul route only needs
        the full-length spectrum for the windowed large-r bands."""
        if not _X_cache:
            _X_cache.append(_fft(xp.astype(cdtype)))
        return _X_cache[0]

    def lowpass(spec, r, phi_r):
        """phi-filter an r-grid spectrum, crop the padding, subsample to
        the output frame rate (math: ceil(ceil(n/r)/(stride/r)) ==
        ceil(n/stride), so every group lands on identical frames)."""
        y = _ifft(spec * phi_r).real
        return y[..., : -(-n // r)][..., :: stride // r]

    # Composed lowpass (round-3 DFT-reassociation): the chain
    # fft -> *phi -> ifft -> crop -> stride on a rate-r grid is ONE
    # sampled-circulant real matmul applied to the SPATIAL array — exact,
    # and it deletes the third FFT round (fft(u2)) plus every lowpass
    # ifft for grids small enough to bake the (frames, m) matrix.
    _lp_cache: dict[int, jnp.ndarray] = {}

    def lowpass_direct_ok(r) -> bool:
        return config.mxu_dft() != "off" and padded // r <= MAX_LOWPASS_M

    def lowpass_direct(u, r):
        if r not in _lp_cache:
            phi_np = np.exp(-(grid_freqs(r) ** 2) / (2.0 * sigma_phi**2))
            idx = np.arange(0, -(-n // r), stride // r)
            _lp_cache[r] = jnp.asarray(_lowpass_matrix(phi_np, idx).T, x.dtype)
        return dot(u, _lp_cache[r], config.conv_precision())

    def truncate(V, q):
        """Ideal-lowpass decimation by q in the spectral domain (keep the
        lowest bins of each sign): the DFT of the bandlimited signal's
        q-fold subsample."""
        if q == 1:
            return V
        h = V.shape[-1] // (2 * q)
        return jnp.concatenate([V[..., :h], V[..., V.shape[-1] - h:]], axis=-1) / q

    sigma_phi = XI_MAX * 2.0 ** (-float(J)) / math.sqrt(2.0 * math.log(2.0))

    def grid_freqs(r):
        """Frequency axis of the rate-r grid in ORIGINAL cycles/sample:
        one subsample = r samples, so subgrid bin f' maps to f'/r."""
        m = padded // r
        i = np.arange(m, dtype=np.float64)
        f = i / m
        f[i > m // 2] -= 1.0
        return f / r

    def phi_on(r):
        return jnp.asarray(
            np.exp(-(grid_freqs(r) ** 2) / (2.0 * sigma_phi**2)), dtype=cdtype
        )

    use_mxu = config.mxu_dft() != "off"
    frames = -(-n // stride)

    def phi_lowpass(u_real, r):
        """S-output lowpass of a rate-r spatial magnitude: composed-matrix
        matmul for small grids, block-form time-domain phi conv for large
        ones (ops.mxu_bandconv — phi's impulse response
        is ~1200/r taps, so the third FFT round is a skinny matmul),
        spectral ifft as the hatch."""
        if lowpass_direct_ok(r):
            return lowpass_direct(u_real, r)
        if use_mxu:
            phi_np = np.exp(-(grid_freqs(r) ** 2) / (2.0 * sigma_phi**2))
            out = _bandconv.strided_band_conv(u_real, phi_np, stride // r)
            if out is not None:
                return out[0][..., :frames]
        return lowpass(_fft(u_real.astype(cdtype)), r, phi_on(r))

    if use_mxu:
        from ..ops import mxu_bandconv as _bandconv

        # order 0: phi conv on the padded signal itself — no spectrum needed
        s0 = phi_lowpass(xp, 1)
    else:
        s0 = lowpass(full_spec(), 1, phi_on(1))
        psi1 = jnp.asarray(bank.psi1_hat, dtype=cdtype)

    # Order-1 envelopes on the matmul route: instead of one full-length
    # band iFFT per band, two exact replacements chosen per band by its
    # decimation rate r:
    #  * small r (the expensive near-full-rate top octaves): psi1 is
    #    Gaussian in frequency hence Gaussian in TIME — ~100*r taps —
    #    so u1 = |x (*) psi1| evaluated at stride r is a strided
    #    tile conv (ops.mxu_bandconv lane form; complex taps, two real
    #    banks). Exact envelope subsamples (identical to spectral
    #    periodization) up to the 1e-7 tap truncation, no FFT at all.
    #  * large r (taps would bake multi-MB per-band matmul constants):
    #    X * psi1 vanishes outside psi1's frequency support window, so
    #    slice the window, fold it mod padded/r — arithmetic identical
    #    to the full-length periodization — and inverse-FFT the SHORT
    #    grid. The full-length multiply + r-segment reshape-sum of the
    #    round-3/4 formulation disappear.
    _TAPS_MAX_STRIDE = 8

    def _windowed_band_spec(psi_np, r):
        """(..., padded/r) fold of fft(xp) * psi via psi's support window."""
        from ..ops.mxu_dft2d import circular_box

        mr = padded // r
        a = np.abs(psi_np)
        c0, W = circular_box(a > 1e-7 * a.max())
        Xf = full_spec()
        if c0 + W <= padded:
            win = Xf[..., c0:c0 + W]
        else:
            win = jnp.concatenate(
                [Xf[..., c0:], Xf[..., :c0 + W - padded]], axis=-1)
        win = win * jnp.asarray(np.roll(psi_np, -c0)[:W], cdtype)
        shift = c0 % mr
        total = -(-(shift + W) // mr) * mr
        buf = jnp.pad(win, [(0, 0)] * (win.ndim - 1)
                      + [(shift, total - shift - W)])
        return buf.reshape(buf.shape[:-1] + (-1, mr)).sum(-2) / r

    def _order1_group(idxs, r):
        """Stacked (..., len(idxs), padded/r) order-1 envelopes."""
        tap_rows, win_ks = {}, []
        if r <= _TAPS_MAX_STRIDE:
            for k in idxs.tolist():
                out = _bandconv.strided_band_conv(xp, bank.psi1_hat[k], r)
                if out is not None:
                    tap_rows[k] = jnp.sqrt(out[0] ** 2 + out[1] ** 2)
                else:  # shape outside the tile forms' plan
                    win_ks.append(k)
        else:
            win_ks = idxs.tolist()
        win_rows = {}
        if win_ks:
            specs = jnp.stack(
                [_windowed_band_spec(bank.psi1_hat[k], r) for k in win_ks],
                axis=-2)
            u = jnp.abs(_ifft(specs))
            for i, k in enumerate(win_ks):
                win_rows[k] = u[..., i, :]
        return jnp.stack(
            [tap_rows.get(k, win_rows.get(k)) for k in idxs.tolist()],
            axis=-2)

    s1_parts, s1_order = [], []
    v1_store = {}  # k1 -> (group tensor, local row, r1)   [spectral path]
    u1_store = {}  # k1 -> (group tensor, local row, r1)   [matmul path]
    _v1_group: dict[int, jnp.ndarray] = {}  # lazy fft(u1) per r-group
    for r in sorted(set(r1_of.tolist())):
        idxs = np.nonzero(r1_of == r)[0]
        if use_mxu:
            u1 = _order1_group(idxs, r)  # (..., Kg, P/r)
            s1_parts.append(phi_lowpass(u1, r))
            for i, k1 in enumerate(idxs.tolist()):
                u1_store[k1] = (u1, i, r)
        else:
            # hatch: batched multiply on the full grid, decimation by
            # spectral periodization, inverse FFT at padded/r
            prod = full_spec()[..., None, :] * psi1[idxs]
            if r > 1:
                prod = prod.reshape(prod.shape[:-1] + (r, padded // r)).sum(-2) / r
            u1 = jnp.abs(_ifft(prod))
            V1 = _fft(u1.astype(cdtype))  # reused by BOTH S1 and order 2
            s1_parts.append(lowpass(V1, r, phi_on(r)))
            for i, k1 in enumerate(idxs.tolist()):
                v1_store[k1] = (V1, i, r)
        s1_order.extend(idxs.tolist())

    def v1_row(k1):
        """Lazy fft(u1) for spectral-fallback paths on the matmul route."""
        u1g, i, r1 = u1_store[k1]
        if r1 not in _v1_group:
            _v1_group[r1] = _fft(u1g.astype(cdtype))
        return _v1_group[r1][..., i, :], r1

    s2_parts, s2_order = [], []
    if use_mxu:
        # order 2 without ANY further FFT rounds: each path's psi2 is an
        # octave-wide Gaussian = a short impulse response on the k1
        # band's rate-r1 grid, so u2 = |u1 (*) psi2|[::R/r1] is a strided
        # tile conv (ops.mxu_bandconv), and S2 its phi conv.
        by_r1: dict[int, list[int]] = {}
        for p in range(len(bank.paths)):
            by_r1.setdefault(int(r1_of[int(bank.paths[p, 0])]), []).append(p)
        # Multirate cascade: convolving every path at its SOURCE rate
        # would make order-2 work scale as 4*T*m per path-row regardless
        # of output decimation. The envelope group is therefore
        # anti-alias HALVED between path batches — a ~33-tap Gaussian AA
        # conv whose response is divided out of every later psi2 bank
        # exactly — so each path convolves on the coarsest grid its band
        # allows (stride <= 2 there). Per stage the AA is sized so the
        # fold leaking into any remaining passband is < 2e-9
        # (sigma = F_new/4.5 with descent gated on cut2 <= F_new/2).
        def conv_k2(u_src, Q, sum_inv2, k2, plist):
            """psi2 conv of the (cascaded, rate-Q) group slice for one
            k2; appends the S2 rows. ``sum_inv2`` is the accumulated
            Gaussian-AA response exp(-f^2 * sum_inv2) to divide out."""
            R = int(r_path[plist[0]])
            S = max(R // Q, 1)
            fQ = grid_freqs(Q)
            psi2_np = _gauss_bump(fQ, bank.xi2[k2], sig2[k2])
            if sum_inv2:
                keep = np.abs(psi2_np) > 1e-12 * np.abs(psi2_np).max()
                comp = np.exp(np.where(keep, fQ * fQ * sum_inv2, 0.0))
                psi2_np = np.where(keep, psi2_np * comp, 0.0)
            locs = [u1_store[int(bank.paths[p, 0])][1] for p in plist]
            if locs == list(range(locs[0], locs[0] + len(locs))):
                # a (r1, k2) group is k1-contiguous (xi1 descending, so
                # "xi2 < xi1" selects a prefix): zero-copy slice
                u_stack = u_src[..., locs[0]:locs[0] + len(locs), :]
            else:  # defensive: non-contiguous selection
                u_stack = jnp.stack([u_src[..., i, :] for i in locs], axis=-2)
            out = _bandconv.strided_band_conv(u_stack, psi2_np, S)
            if out is not None:
                u2 = jnp.sqrt(out[0] ** 2 + out[1] ** 2)
            else:  # shape outside the tile forms' plan: spectral fallback
                fR = grid_freqs(R)
                r1_src = u1_store[int(bank.paths[plist[0], 0])][2]
                Vp = jnp.stack(
                    [truncate(v1_row(int(bank.paths[p, 0]))[0], R // r1_src)
                     for p in plist], axis=-2)
                psi2_R = jnp.asarray(
                    _gauss_bump(fR, bank.xi2[k2], sig2[k2]), cdtype)
                u2 = jnp.abs(_ifft(Vp * psi2_R))
            s2_parts.append(phi_lowpass(u2, R))
            s2_order.extend(plist)

        for r1, plist_all in sorted(by_r1.items()):
            by_k2: dict[int, list[int]] = {}
            for p in plist_all:
                by_k2.setdefault(int(bank.paths[p, 1]), []).append(p)
            # pending k2, highest cut2 first — they exit the cascade first
            pending = sorted(by_k2.items(), key=lambda kv: -cut2[kv[0]])
            cur = u1_store[int(bank.paths[plist_all[0], 0])][0]
            Q = r1
            sum_inv2 = 0.0
            while pending:
                f_next = 1.0 / (4.0 * Q)  # Nyquist of the NEXT halving
                # a path must exit at or above its OUTPUT rate R (with
                # oversampling R can sit below the tail-budget rate —
                # its conv then runs at rate Q == R, stride 1)
                due = [kv for kv in pending
                       if cut2[kv[0]] > f_next / 2.0
                       or int(r_path[kv[1][0]]) <= Q]
                pending = [kv for kv in pending if kv not in due]
                for k2, plist in due:
                    conv_k2(cur, Q, sum_inv2, k2, plist)
                if not pending:
                    break
                sigma = f_next / 4.5  # absolute cycles/sample
                aa = np.exp(-(grid_freqs(Q) ** 2) / (2.0 * sigma * sigma))
                dec = _bandconv.strided_band_conv(cur, aa, 2)
                if dec is None:  # tiny grids: finish at the current rate
                    for k2, plist in pending:
                        conv_k2(cur, Q, sum_inv2, k2, plist)
                    break
                cur = dec[0]
                sum_inv2 += 1.0 / (2.0 * sigma * sigma)
                Q *= 2
    else:
        for R in sorted(set(r_path.tolist())):
            pidx = np.nonzero(r_path == R)[0]
            fR = grid_freqs(R)
            # gather this R-group's V1 rows, truncating each from its r1
            # grid (batch the truncation per source r1 to keep op count low)
            rows = {}
            by_r1 = {}
            for p in pidx.tolist():
                k1 = int(bank.paths[p, 0])
                by_r1.setdefault(v1_store[k1][2], []).append(p)
            for r1, plist in by_r1.items():
                V1g = v1_store[int(bank.paths[plist[0], 0])][0]
                locs = jnp.asarray([v1_store[int(bank.paths[p, 0])][1] for p in plist])
                Vsub = truncate(jnp.take(V1g, locs, axis=-2), R // r1)
                for j, p in enumerate(plist):
                    rows[p] = Vsub[..., j, :]
            Vp = jnp.stack([rows[p] for p in pidx.tolist()], axis=-2)
            psi2_R = jnp.asarray(
                np.stack([
                    _gauss_bump(fR, bank.xi2[k2], sig2[k2])
                    for k2 in bank.paths[pidx, 1]
                ]),
                dtype=cdtype,
            )
            u2 = jnp.abs(_ifft(Vp * psi2_R))
            s2_parts.append(lowpass(_fft(u2.astype(cdtype)), R, phi_on(R)))
            s2_order.extend(pidx.tolist())

    inv1 = np.argsort(np.asarray(s1_order))
    s1 = jnp.take(jnp.concatenate(s1_parts, axis=-2), jnp.asarray(inv1), axis=-2)
    if s2_parts:
        inv2 = np.argsort(np.asarray(s2_order))
        s2 = jnp.take(jnp.concatenate(s2_parts, axis=-2), jnp.asarray(inv2), axis=-2)
    else:
        s2 = jnp.zeros(s1.shape[:-2] + (0, s1.shape[-1]), dtype=s1.dtype)

    return ScatteringResult(
        s0, s1, s2, bank.xi1, bank.xi2, bank.paths, float(sampling_rate)
    )


# --------------------------------------------------------------------------
# 2D (image) scattering — Bruna & Mallat 2013
# --------------------------------------------------------------------------

def _gauss_bump_2d(fy, fx, xi: float, theta: float, sigma: float) -> np.ndarray:
    """Oriented zero-mean Gaussian bump centered at xi*(cos, sin) theta.
    ``fy``/``fx`` are meshgrid frequency planes in cycles/pixel."""
    cy, cx = xi * math.sin(theta), xi * math.cos(theta)
    g = np.exp(-((fx - cx) ** 2 + (fy - cy) ** 2) / (2.0 * sigma**2))
    kappa = math.exp(-(xi**2) / (2.0 * sigma**2))
    return g - kappa * np.exp(-(fx**2 + fy**2) / (2.0 * sigma**2))


@dataclass(frozen=True)
class ScatteringBank2D:
    """Static 2D filter bank + path table for one (Py, Px, J, L)."""

    psi_hat: np.ndarray  # (J*L, Py, Px) — scale-major: filter j*L + l
    phi_hat: np.ndarray  # (Py, Px)
    xi: np.ndarray  # (J,) center frequencies, cycles/pixel
    thetas: np.ndarray  # (L,)
    paths: np.ndarray  # (P2, 2) — (k1, k2) flat filter indices, j2 > j1


def scattering_filter_bank_2d(py: int, px: int, J: int, L: int) -> ScatteringBank2D:
    """Oriented Morlet-style bank on a (py, px) FFT grid: J dyadic scales x
    L orientations over the upper half-plane (the modulus makes the lower
    half redundant for real images)."""
    key = ("2d", py, px, J, L)
    hit = _bank_cache_get(key)
    if hit is not None:
        return hit
    iy = np.arange(py, dtype=np.float64)
    ix = np.arange(px, dtype=np.float64)
    gy = iy / py
    gy[iy > py // 2] -= 1.0
    gx = ix / px
    gx[ix > px // 2] -= 1.0
    fy, fx = np.meshgrid(gy, gx, indexing="ij")

    xi = XI_MAX * 2.0 ** (-np.arange(J, dtype=np.float64))
    sig = _sigma_for(xi, 1)
    thetas = np.pi * np.arange(L, dtype=np.float64) / L
    psi = np.stack([
        _gauss_bump_2d(fy, fx, x, t, s)
        for x, s in zip(xi, sig)
        for t in thetas
    ])
    sigma_phi = XI_MAX * 2.0 ** (-float(J)) / math.sqrt(2.0 * math.log(2.0))
    phi = np.exp(-(fx**2 + fy**2) / (2.0 * sigma_phi**2))
    # frequency-decreasing paths: scale j2 strictly coarser than j1,
    # all orientation pairs (Bruna & Mallat 2013 §3.1)
    paths = np.asarray(
        [
            (j1 * L + l1, j2 * L + l2)
            for j1 in range(J)
            for j2 in range(j1 + 1, J)
            for l1 in range(L)
            for l2 in range(L)
        ],
        dtype=np.int64,
    ).reshape(-1, 2)
    bank = ScatteringBank2D(psi, phi, xi, thetas, paths)
    return _bank_cache_put(key, bank)


@jax.tree_util.register_pytree_node_class
@dataclass
class Scattering2DResult:
    """2D scattering coefficients as a jax pytree.

    ``S0``: (..., Ty, Tx); ``S1``: (..., J*L, Ty, Tx) scale-major;
    ``S2``: (..., P2, Ty, Tx) — path p is ``paths[p] = (k1, k2)`` flat
    filter indices (scale ``k // L``, orientation ``k % L``).
    """

    S0: jnp.ndarray
    S1: jnp.ndarray
    S2: jnp.ndarray
    xi: np.ndarray
    thetas: np.ndarray
    paths: np.ndarray

    def tree_flatten(self):
        return (self.S0, self.S1, self.S2), (
            self.xi.tobytes(), self.xi.shape,
            self.thetas.tobytes(), self.thetas.shape,
            self.paths.tobytes(), self.paths.shape,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        xb, xs, tb, ts, pb, ps = aux
        return cls(
            *children,
            np.frombuffer(xb, dtype=np.float64).reshape(xs),
            np.frombuffer(tb, dtype=np.float64).reshape(ts),
            np.frombuffer(pb, dtype=np.int64).reshape(ps),
        )

    @property
    def n_orientations(self) -> int:
        return int(self.thetas.shape[0])

    @property
    def n_paths(self) -> int:
        return int(self.paths.shape[0])

    def features(self):
        """(..., 1 + J*L + P2, Ty, Tx) stacked band axis."""
        return jnp.concatenate([self.S0[..., None, :, :], self.S1, self.S2], axis=-3)


def _fft2(z):
    return _fft(_fft(z, axis=-1), axis=-2)


def _ifft2(z):
    return _ifft(_ifft(z, axis=-1), axis=-2)


def scattering2d(
    image,
    J: int,
    L: int = 8,
    oversampling: int = 0,
) -> Scattering2DResult:
    """Order-2 image scattering (Bruna & Mallat 2013) of (..., H, W) arrays.

    Args:
      image: real (..., H, W); leading axes batch.
      J: invariance scale — outputs average over ``2^J x 2^J`` windows and
        subsample by that stride.
      L: orientations over the half-plane (8 is standard).
      oversampling: subsample by ``2^(J - oversampling)`` instead.

    The network is the 2D analog of :func:`scattering1d`: J*L oriented
    bumps applied as ONE batched pow-2 2D FFT multiply, envelope spectra
    reused for both the lowpass outputs and the second-order bank, path
    table static. Images pad to the next power of two per axis (reflection
    against wrap); texture-classification features come out of
    ``result.features()``.
    """
    x = jnp.asarray(image)
    if x.ndim < 2:
        raise JWaveFailure("scattering2d - image must have at least 2 axes")
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise JWaveFailure("scattering2d - expected a real image")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    h, w = x.shape[-2:]
    if h < 2 or w < 2:
        raise JWaveFailure("scattering2d - need at least 2x2 pixels")
    if J < 1 or L < 1:
        raise JWaveFailure("scattering2d - J and L must be >= 1")
    if 2**J > min(h, w):
        raise JWaveFailure(
            f"scattering2d - invariance scale 2^{J} exceeds image extent {min(h, w)}"
        )
    stride = 2 ** max(0, J - oversampling)

    py, px = next_power_of_two(2 * h), next_power_of_two(2 * w)
    bank = scattering_filter_bank_2d(py, px, J, L)
    cdtype = jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64
    psi = jnp.asarray(bank.psi_hat, dtype=cdtype)

    # mirror-pad both axes (reflection suppresses wrap across the far edge)
    def mirror_extend(a, target, axis):
        a = jnp.swapaxes(a, axis, -1)
        ext = jnp.concatenate([a, jnp.flip(a, axis=-1)], axis=-1)[..., :target]
        ext = pad_signal(ext, target, PaddingType.PERIODIC)
        return jnp.swapaxes(ext, axis, -1)

    xpad = mirror_extend(mirror_extend(x, px, -1), py, -2)
    X = _fft2(xpad.astype(cdtype))

    if config.mxu_dft() != "off":
        # matmul formulation. Two reassociations:
        #
        # 1. phi is an isotropic (= separable) Gaussian, so the lowpass
        #    chain fft2 -> *phi -> ifft2 -> crop -> stride is two sampled
        #    real circulants on the SPATIAL array: Ay @ u @ Ax^T.
        # 2. every band convolution |ifft2(spec * psi)| restricts to psi's
        #    Gaussian support box and collapses to two skinny matmuls —
        #    the box offset phases die under the modulus
        #    (ops.mxu_dft2d.box_ifft2_mag). Scale-0 bumps cover most of the
        #    plane, so those maps stay on the spectral path.
        from ..ops import mxu_dft2d as _mm2d

        sigma_phi = XI_MAX * 2.0 ** (-float(J)) / math.sqrt(2.0 * math.log(2.0))

        def axis_phi(m):
            g = np.arange(m, dtype=np.float64) / m
            g[g > 0.5] -= 1.0
            return np.exp(-(g**2) / (2.0 * sigma_phi**2))

        prec = config.conv_precision()
        ayt = jnp.asarray(
            _lowpass_matrix(axis_phi(py), np.arange(0, h, stride)).T, x.dtype
        )
        axt = jnp.asarray(
            _lowpass_matrix(axis_phi(px), np.arange(0, w, stride)).T, x.dtype
        )

        def lowpass_spatial(u):
            t = jnp.swapaxes(dot(u, axt, prec), -1, -2)  # (..., Tx, Py)
            return jnp.swapaxes(dot(t, ayt, prec), -1, -2)  # (..., Ty, Tx)

        rdt = x.dtype
        psi_np = bank.psi_hat
        bx = [_mm2d.filter_box(psi_np[k]) for k in range(psi_np.shape[0])]

        # ---- order 1: per-scale groups (shared box size), box matmuls ----
        u1_list = [None] * psi_np.shape[0]
        for j in range(J):
            ks = list(range(j * L, (j + 1) * L))
            dy = max(bx[k][1] for k in ks)
            dx = max(bx[k][3] for k in ks)
            if dy > 0.85 * py or dx > 0.85 * px:
                u1g = jnp.abs(_ifft2(X[..., None, :, :] * psi[np.asarray(ks)]))
                for i, k in enumerate(ks):
                    u1_list[k] = u1g[..., i, :, :]
                continue
            Sr, Si = [], []
            for k in ks:
                Z = _mm2d.roll_box(
                    X * jnp.asarray(psi_np[k], cdtype), (bx[k][0], dy, bx[k][2], dx)
                )
                Sr.append(jnp.real(Z).astype(rdt))
                Si.append(jnp.imag(Z).astype(rdt))
            u1g = _mm2d.box_ifft2_mag(
                jnp.stack(Sr, axis=-3), jnp.stack(Si, axis=-3), py, px
            )
            for i, k in enumerate(ks):
                u1_list[k] = u1g[..., i, :, :]
        u1 = jnp.stack(u1_list, axis=-3)  # (..., J*L, Py, Px)

        # ---- V1: real-input FFT2 (the fast direction of the engine) ----
        V1 = _fft2(u1.astype(cdtype))
        V1r = jnp.real(V1).astype(rdt)
        V1i = jnp.imag(V1).astype(rdt)

        # ---- order 2: every path's psi2 box (j2 >= 1, always small) ----
        u2_list = [None] * len(bank.paths)
        for j2 in range(1, J):
            pidx = [p for p in range(len(bank.paths))
                    if int(bank.paths[p, 1]) // L == j2]
            if not pidx:
                continue
            ks2 = sorted({int(bank.paths[p, 1]) for p in pidx})
            dy = max(bx[k][1] for k in ks2)
            dx = max(bx[k][3] for k in ks2)
            Sr, Si = [], []
            for p in pidx:
                k1, k2 = int(bank.paths[p, 0]), int(bank.paths[p, 1])
                box = (bx[k2][0], dy, bx[k2][2], dx)
                pb = jnp.asarray(
                    np.roll(psi_np[k2], (-box[0], -box[2]), axis=(0, 1))[:dy, :dx],
                    rdt,
                )
                Sr.append(_mm2d.roll_box(V1r[..., k1, :, :], box) * pb)
                Si.append(_mm2d.roll_box(V1i[..., k1, :, :], box) * pb)
            u2g = _mm2d.box_ifft2_mag(
                jnp.stack(Sr, axis=-3), jnp.stack(Si, axis=-3), py, px
            )
            for i, p in enumerate(pidx):
                u2_list[p] = u2g[..., i, :, :]
        if u2_list:
            u2 = jnp.stack(u2_list, axis=-3)
            s2 = lowpass_spatial(u2)
        else:
            ty, tx = -(-h // stride), -(-w // stride)
            s2 = jnp.zeros(x.shape[:-2] + (0, ty, tx), dtype=rdt)

        s0 = lowpass_spatial(xpad)
        s1 = lowpass_spatial(u1)
        return Scattering2DResult(s0, s1, s2, bank.xi, bank.thetas, bank.paths)

    # cross-validation hatch (config.set_mxu_dft('off')): the spectral
    # lowpass form — three batched FFT2 rounds end to end
    k1_of_path = jnp.asarray(bank.paths[:, 0])
    psi2_of_path = psi[jnp.asarray(bank.paths[:, 1])]
    phi = jnp.asarray(bank.phi_hat, dtype=cdtype)

    def lowpass(spec):
        y = _ifft2(spec * phi).real
        return y[..., :h, :w][..., ::stride, ::stride]

    s0 = lowpass(X)
    u1 = jnp.abs(_ifft2(X[..., None, :, :] * psi))  # (..., J*L, Py, Px)
    V1 = _fft2(u1.astype(cdtype))
    s1 = lowpass(V1)
    Vp = jnp.take(V1, k1_of_path, axis=-3)
    u2 = jnp.abs(_ifft2(Vp * psi2_of_path))
    s2 = lowpass(_fft2(u2.astype(cdtype)))
    return Scattering2DResult(s0, s1, s2, bank.xi, bank.thetas, bank.paths)
