"""Matching pursuit (Mallat & Zhang 1993) over a multi-scale Gabor
dictionary — capability superset.

Greedy sparse decomposition: repeatedly pick the dictionary atom with the
largest projection energy against the residual and subtract the
projection. The reference library has no sparse/adaptive decomposition.

Formulation:

- The per-iteration search over ALL atoms at ALL shifts is batched FFT
  correlation: ``ifft(fft(r) * conj(G_hat))`` against the stacked (P, N)
  dictionary spectra — a dense (P, N) score map reduced by a flat argmax.
  No tree search, no data-dependent pruning: the dense scan is the FULL
  greedy step (global argmax), as one dense elementwise-and-reduce.
- Each dictionary entry is a cosine/sine QUADRATURE PAIR at one (scale,
  frequency); the pick maximizes the energy of the residual's projection
  onto the 2D span (phase-optimal, via the pair's 2x2 Gram inverse), and
  the subtraction removes the whole projection. One pick therefore
  extracts a full phase-free Gabor component — the phase-scan trick of
  MPTK, done in closed form.
- The K extraction steps are a ``lax.scan`` with static trip count — one
  compiled program. Atom subtraction uses modular index gathers (static
  shapes), so the solver batches over leading axes and differentiates.
- Atoms are periodized on the N-grid (circular shifts), consistent with
  the library's circular-convolution conventions elsewhere.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..exceptions import JWaveFailure
from .fft import fft as _fft, ifft as _ifft


@dataclass(frozen=True, eq=False)
class GaborDictionary:
    """Static periodized quadrature-pair dictionary on an N-grid.

    ``cos_atoms``/``sin_atoms``: (P, N) unit-norm waveforms centered at
    sample 0 (the sine partner of a pure-Gaussian pair is all zero).
    ``cross``: (P,) inner products <g_cos, g_sin> (shift-invariant).
    ``scale``/``freq``: (P,) Gaussian width (samples), frequency
    (cycles/sample). ``eq=False``: identity equality/hash, so the object
    can ride pytree aux_data (array-valued ``__eq__`` would break jit's
    treedef comparison).
    """

    cos_atoms: np.ndarray
    sin_atoms: np.ndarray
    cross: np.ndarray
    scale: np.ndarray
    freq: np.ndarray


_DICT_CACHE: OrderedDict = OrderedDict()
_DICT_CACHE_MAX = 4  # entries are large (hundreds of MB at N ~ 4096)


def gabor_dictionary(n: int, scales=None, freqs_per_scale: int | None = None) -> GaborDictionary:
    """Multi-scale Gabor dictionary: dyadic Gaussian widths from 4 samples
    up to N/2, each carrying quadrature pairs on a Heisenberg-matched
    frequency grid (spacing ``1/(2 s)`` — wide windows resolve finer
    frequencies, so they get proportionally more of them), plus the bare
    Gaussian (freq 0) per scale. ``freqs_per_scale`` overrides with a
    fixed-count linear grid."""
    key = (n, None if scales is None else tuple(scales), freqs_per_scale)
    if key in _DICT_CACHE:
        _DICT_CACHE.move_to_end(key)
        return _DICT_CACHE[key]
    if scales is None:
        scales, s = [], 4
        while s <= n // 2:
            scales.append(s)
            s *= 2
    scales = [int(s) for s in scales]
    if not scales:
        raise JWaveFailure(f"gabor_dictionary - no valid scales for N = {n}")
    t = np.arange(n, dtype=np.float64)
    d = (t + n // 2) % n - n // 2  # signed circular distance from 0
    gc, gs, sc, fr = [], [], [], []
    for s in scales:
        win = np.exp(-(d**2) / (2.0 * (s / 2.0) ** 2))
        g0 = win / np.linalg.norm(win)
        gc.append(g0), gs.append(np.zeros(n)), sc.append(s), fr.append(0.0)
        if freqs_per_scale is None:
            df = 1.0 / (2.0 * s)
            fgrid = np.arange(df, 0.5, df)
        else:
            f_lo = 1.0 / (4.0 * s)
            fgrid = np.linspace(f_lo, 0.5, freqs_per_scale, endpoint=False)
        for f in fgrid:
            c = win * np.cos(2 * np.pi * f * d)
            q = win * np.sin(2 * np.pi * f * d)
            nc, nq = np.linalg.norm(c), np.linalg.norm(q)
            if nc < 1e-12 or nq < 1e-12:
                continue
            gc.append(c / nc), gs.append(q / nq), sc.append(s), fr.append(f)
    gc, gs = np.stack(gc), np.stack(gs)
    cross = np.sum(gc * gs, axis=-1)
    bank = GaborDictionary(gc, gs, cross,
                           np.asarray(sc, dtype=np.float64),
                           np.asarray(fr, dtype=np.float64))
    _DICT_CACHE[key] = bank
    while len(_DICT_CACHE) > _DICT_CACHE_MAX:
        _DICT_CACHE.popitem(last=False)
    return bank


@jax.tree_util.register_pytree_node_class
@dataclass
class MPResult:
    """Matching-pursuit output as a jax pytree.

    Per pick k (in extraction order): ``alphas``/``betas`` (..., K) are the
    cosine/sine projection coefficients, ``atom_idx`` (..., K) the pair
    row, ``positions`` (..., K) the circular shift (samples).
    ``residual``: (..., N); ``energies``: (..., K) residual energy after
    each pick (non-increasing). The static :class:`GaborDictionary` rides
    the pytree's aux_data (NOT a leaf), so jit/vmap never trace or batch
    the (P, N) atom tables.
    """

    alphas: jnp.ndarray
    betas: jnp.ndarray
    atom_idx: jnp.ndarray
    positions: jnp.ndarray
    residual: jnp.ndarray
    energies: jnp.ndarray
    dictionary: GaborDictionary

    def tree_flatten(self):
        return (
            self.alphas, self.betas, self.atom_idx, self.positions,
            self.residual, self.energies,
        ), (self.dictionary,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])

    @property
    def n_atoms(self) -> int:
        return self.alphas.shape[-1]

    @property
    def scale(self) -> np.ndarray:
        return self.dictionary.scale

    @property
    def freq(self) -> np.ndarray:
        return self.dictionary.freq

    @property
    def amplitudes(self):
        """Per-pick Gabor amplitude sqrt(alpha^2 + beta^2)."""
        return jnp.sqrt(self.alphas**2 + self.betas**2)

    def reconstruct(self, k: int | None = None):
        """Sum of the first ``k`` extracted components (all by default)."""
        k = self.n_atoms if k is None else k
        cos_a = jnp.asarray(self.dictionary.cos_atoms, dtype=self.residual.dtype)
        sin_a = jnp.asarray(self.dictionary.sin_atoms, dtype=self.residual.dtype)
        n = cos_a.shape[-1]
        idx = (jnp.arange(n) - self.positions[..., :k, None]) % n
        c = jnp.take_along_axis(
            jnp.take(cos_a, self.atom_idx[..., :k], axis=0), idx, axis=-1)
        s = jnp.take_along_axis(
            jnp.take(sin_a, self.atom_idx[..., :k], axis=0), idx, axis=-1)
        return jnp.sum(self.alphas[..., :k, None] * c
                       + self.betas[..., :k, None] * s, axis=-2)

    def atom_frequencies(self, sampling_rate: float = 1.0):
        """Per-pick carrier frequency (Hz for the given rate)."""
        return jnp.take(jnp.asarray(self.freq), self.atom_idx) * sampling_rate


def matching_pursuit(
    signal,
    n_atoms: int = 32,
    dictionary: GaborDictionary | None = None,
    freqs_per_scale: int | None = None,
) -> MPResult:
    """Greedy phase-optimal Gabor decomposition of (..., N) real signals.

    Args:
      signal: (..., N); leading axes batch through the whole solver.
      n_atoms: static number of extraction steps K (one Gabor component,
        i.e. one quadrature pair, per step).
      dictionary: a :class:`GaborDictionary` (defaults to
        :func:`gabor_dictionary` on the signal length).
      freqs_per_scale: frequency resolution of the default dictionary.

    Returns an :class:`MPResult`; ``result.reconstruct() +
    result.residual`` equals the input to numerical precision and
    ``result.energies`` is non-increasing (each pick removes the maximal
    2D projection energy).
    """
    x = jnp.asarray(signal)
    if x.ndim == 0:
        raise JWaveFailure("matching_pursuit - signal must have at least 1 axis")
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise JWaveFailure("matching_pursuit - expected a real signal")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    n = x.shape[-1]
    if n < 16:
        raise JWaveFailure("matching_pursuit - need at least 16 samples")
    if n_atoms < 1:
        raise JWaveFailure("matching_pursuit - n_atoms must be >= 1")
    bank = dictionary if dictionary is not None else gabor_dictionary(
        n, freqs_per_scale=freqs_per_scale
    )
    if bank.cos_atoms.shape[-1] != n:
        raise JWaveFailure(
            f"matching_pursuit - dictionary grid {bank.cos_atoms.shape[-1]} "
            f"!= signal length {n}"
        )
    rdtype = x.dtype
    cdtype = jnp.complex128 if rdtype == jnp.float64 else jnp.complex64
    cos_a = jnp.asarray(bank.cos_atoms, dtype=rdtype)  # (P, N)
    sin_a = jnp.asarray(bank.sin_atoms, dtype=rdtype)
    c_hat = jnp.conj(_fft(cos_a.astype(cdtype)))
    s_hat = jnp.conj(_fft(sin_a.astype(cdtype)))
    cross = jnp.asarray(bank.cross, dtype=rdtype)[:, None]  # (P, 1)
    det = jnp.maximum(1.0 - cross**2, 1e-12)
    p_count = cos_a.shape[0]

    # both correlations are REAL (real residual x real atoms), so one
    # complex inverse FFT of the packed spectrum yields cc + i*cs — half
    # the per-step FFT work of separate cc/cs transforms
    pair_hat = c_hat + 1j * s_hat

    def step(r, _):
        R = _fft(r.astype(cdtype))[..., None, :]
        z = _ifft(R * pair_hat)  # (..., P, N): cc + i*cs
        cc = z.real  # <r, gc shifted by p>
        cs = z.imag
        # projection energy onto span{gc_p, gs_p}: c^T G^-1 c with
        # G = [[1, cross], [cross, 1]]
        score = (cc**2 - 2.0 * cross * cc * cs + cs**2) / det
        flat = score.reshape(r.shape[:-1] + (p_count * n,))
        pick = jnp.argmax(flat, axis=-1)
        a_star, p_star = pick // n, pick % n
        take = lambda m: jnp.take_along_axis(
            m.reshape(r.shape[:-1] + (p_count * n,)), pick[..., None], axis=-1
        )[..., 0]
        cc_k, cs_k = take(cc), take(cs)
        x_g = jnp.take(jnp.asarray(bank.cross, dtype=rdtype), a_star)
        d_k = jnp.maximum(1.0 - x_g**2, 1e-12)
        alpha = (cc_k - x_g * cs_k) / d_k
        beta = (cs_k - x_g * cc_k) / d_k
        idx = (jnp.arange(n) - p_star[..., None]) % n
        gc = jnp.take_along_axis(jnp.take(cos_a, a_star, axis=0), idx, axis=-1)
        gs = jnp.take_along_axis(jnp.take(sin_a, a_star, axis=0), idx, axis=-1)
        r = r - alpha[..., None] * gc - beta[..., None] * gs
        return r, (alpha.astype(rdtype), beta.astype(rdtype), a_star, p_star,
                   jnp.sum(r * r, axis=-1).astype(rdtype))

    resid, (al, be, aidx, pos, energy) = lax.scan(step, x, None, length=n_atoms)
    mv = lambda a: jnp.moveaxis(a, 0, -1)
    return MPResult(mv(al), mv(be), mv(aidx), mv(pos), resid, mv(energy), bank)
