"""Convergence diagnostics: split R-hat, effective sample size, acceptance.

The port of `victor_tpu/sampling/diagnostics.py`, in numpy on the host: the
recorded chain is already there when these run. The reference's only
convergence machinery is cobaya's Gelman-Rubin stop criterion (R-1 < 0.01,
config/boss_cobaya_config.yaml:46-47); ESS is an FFT autocorrelation over
the recorded chain.
"""

from __future__ import annotations

import numpy as np


def _cross_chain_rhat(x: np.ndarray) -> np.ndarray:
    """Split-R-hat over a (n_chains, n_draws, n_params) array
    (victor_tpu/parallel/mesh.py::cross_chain_rhat)."""
    m, n = x.shape[0], x.shape[1]
    half = n // 2
    if half < 2:
        # fewer than 2 draws per split half: R-hat is undefined — report
        # "not converged" rather than dividing by n = 0
        return np.full(x.shape[2:], np.inf)
    x = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    m, n = 2 * m, half
    chain_mean = np.mean(x, axis=1)                    # (m, P)
    chain_var = np.var(x, axis=1, ddof=1)              # (m, P)
    B = n * np.var(chain_mean, axis=0, ddof=1)
    W = np.mean(chain_var, axis=0)
    var_post = (n - 1) / n * W + B / n
    # W == 0 (every chain constant — a stuck sampler) would give NaN, which
    # fails every `rhat - 1 < stop` test silently; +inf says "not converged"
    bad = W <= 0
    return np.where(bad, np.inf, np.sqrt(var_post / np.where(bad, 1.0, W)))


def split_rhat(chain: np.ndarray) -> np.ndarray:
    """Split R-hat per parameter from a (n_steps, n_walkers, ndim) chain.

    Each walker is treated as a chain (standard practice for ensemble
    samplers; walkers interact through the ensemble, which makes this mildly
    conservative — the safe direction).
    """
    return _cross_chain_rhat(np.asarray(chain).transpose(1, 0, 2))


def autocorr_time(x: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Integrated autocorrelation time per parameter (emcee-style windowing).

    x: (n_steps, n_walkers, ndim). Averages walker autocorrelation functions.
    """
    n_steps = x.shape[0]
    nfft = 1 << (2 * n_steps - 1).bit_length()
    xc = x - x.mean(axis=0, keepdims=True)
    f = np.fft.rfft(xc, n=nfft, axis=0)
    acf = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:n_steps].real
    acf /= np.maximum(acf[0:1], 1e-300)
    rho = acf.mean(axis=1)                               # (n_steps, ndim)
    taus = 2.0 * np.cumsum(rho, axis=0) - 1.0
    out = np.empty(x.shape[2])
    for p in range(x.shape[2]):
        window = np.arange(n_steps) >= c * taus[:, p]
        idx = np.argmax(window) if window.any() else n_steps - 1
        out[p] = taus[idx, p]
    return out


def effective_sample_size(chain: np.ndarray) -> np.ndarray:
    """ESS per parameter for a (n_steps, n_walkers, ndim) chain."""
    tau = autocorr_time(chain)
    n_total = chain.shape[0] * chain.shape[1]
    return n_total / np.maximum(tau, 1.0)


def acceptance_fraction(n_accepted, n_steps) -> float:
    return float(np.mean(np.asarray(n_accepted)) / max(float(n_steps), 1.0))
