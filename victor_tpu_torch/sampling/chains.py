"""Chain storage: checkpoints (npz snapshots) + GetDist-format export.

The port of `victor_tpu/sampling/chains.py`. The reference delegates chain
files and resume to cobaya, which writes GetDist-format text chains under
`output: chains/test` (config/boss_cobaya_config.yaml:1). The same format is
written here — `<root>.1.txt` rows of [weight, -lnpost, params...,
derived...] plus `<root>.paramnames`, `<root>.ranges`, cobaya's `.covmat`
and `.progress` — byte for byte as victor_tpu writes it for the same arrays,
so GetDist and existing post-processing notebooks read it unchanged.

Sampler state (walker coordinates or chain states, acceptance counters and
the generator's state from `Generator.get_state()`) is saved to npz at every
checkpoint; resume restores the generator, so the continuation is exact.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .ensemble import EnsembleState
from .hmc import HMCState
from .priors import ParamSpace


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _generator(state: np.ndarray, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(np.asarray(state, dtype=np.uint8)))
    return gen


def _write_npz(path: str, payload: Dict) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + '.tmp.npz'
    # uncompressed: checkpoints rewrite the full history every segment, so
    # the per-save cost must stay at memcpy speed
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _chain_payload(chain, log_prob, aux) -> Dict:
    if chain is None:
        return {}
    return {'chain': np.asarray(chain), 'chain_log_prob': np.asarray(log_prob),
            'chain_aux': np.asarray(aux)}


def _chain_records(z):
    return tuple(z[k] if k in z else None
                 for k in ('chain', 'chain_log_prob', 'chain_aux'))


def save_checkpoint(path: str, state: EnsembleState,
                    chain: Optional[np.ndarray] = None,
                    log_prob: Optional[np.ndarray] = None,
                    aux: Optional[np.ndarray] = None) -> None:
    """Serialize ensemble state (+ optionally the recorded chain so far)."""
    payload = {
        'coords': _host(state.coords),
        'log_prob': _host(state.log_prob),
        'aux': _host(state.aux),
        'generator': _host(state.generator.get_state()),
        'n_accepted': _host(state.n_accepted),
        'n_steps': np.asarray(state.n_steps),
    }
    _write_npz(path, {**payload, **_chain_payload(chain, log_prob, aux)})


def load_checkpoint(path: str, device='cuda'):
    """Returns (EnsembleState on `device`, chain | None, log_prob | None,
    aux | None)."""
    with np.load(path) as z:
        state = EnsembleState(
            coords=torch.as_tensor(z['coords'], device=device),
            log_prob=torch.as_tensor(z['log_prob'], device=device),
            aux=torch.as_tensor(z['aux'], device=device),
            generator=_generator(z['generator'], device),
            n_accepted=torch.as_tensor(z['n_accepted'], device=device),
            n_steps=int(z['n_steps']))
        return (state,) + _chain_records(z)


def save_hmc_checkpoint(path: str, states: HMCState, chain=None,
                        log_prob=None, aux=None,
                        i0: Optional[int] = None) -> None:
    """Serialize chain states (+ optionally recorded samples). `i0` is the
    global step index reached; resume continues exactly from there."""
    payload = {f'hmc_{k}': _host(v.get_state() if k == 'generator' else v)
               for k, v in states._asdict().items()}
    if i0 is not None:
        payload['i0'] = np.asarray(i0)
    _write_npz(path, {**payload, **_chain_payload(chain, log_prob, aux)})


def load_hmc_checkpoint(path: str, device='cuda'):
    """Returns (HMCState on `device`, chain | None, log_prob | None,
    aux | None, i0 | None)."""
    with np.load(path) as z:
        fields = {k[4:]: z[k] for k in z.files if k.startswith('hmc_')}
        gen = _generator(fields.pop('generator'), device)
        state = HMCState(generator=gen, **{
            k: torch.as_tensor(v, device=device) for k, v in fields.items()})
        i0 = int(z['i0']) if 'i0' in z else None
        return (state,) + _chain_records(z) + (i0,)


def export_getdist(root: str, space: ParamSpace, chain: np.ndarray,
                   log_prob: np.ndarray, aux: Optional[np.ndarray] = None,
                   aux_names: Optional[List[str]] = None,
                   burn_in: int = 0, chain_index: int = 1,
                   n_chain_files: Optional[int] = None,
                   weights: Optional[np.ndarray] = None) -> str:
    """Write GetDist-compatible text chains.

    chain: (n_steps, n_walkers, ndim); log_prob: (n_steps, n_walkers);
    aux: optional (n_steps, n_walkers, n_aux) derived columns (e.g. chi2);
    weights: optional (n_steps, n_walkers) row weights (default 1).

    `n_chain_files`: split the walker axis into that many contiguous groups
    and write one `<root>.<i>.txt` per group — cobaya/MPI's file layout, so
    GetDist's loadMCSamples sees N chains and can compute cross-chain R-hat.
    Default (None): one combined file numbered `chain_index`.
    """
    chain = np.asarray(chain)[burn_in:]
    log_prob = np.asarray(log_prob)[burn_in:]
    n_steps, n_walkers, ndim = chain.shape
    wts = np.ones((n_steps, n_walkers)) if weights is None else \
        np.broadcast_to(np.asarray(weights, dtype=np.float64)[burn_in:],
                        (n_steps, n_walkers))

    def _columns(flat, lnp, aux_flat, w_flat):
        # derived columns: cobaya-style value-lambdas first, then aux outputs
        derived_cols, derived_names, derived_latex = [], [], []
        params = space.full_params(torch.as_tensor(flat)) \
            if space.derived else None
        for d in space.derived:
            derived_cols.append(_host(params[d.name]))
            derived_names.append(d.name)
            derived_latex.append(d.latex or d.name)
        if aux_flat is not None:
            for j, name in enumerate(aux_names or
                                     [f'aux_{j}' for j in range(aux_flat.shape[1])]):
                derived_cols.append(aux_flat[:, j])
                derived_names.append(name)
                derived_latex.append(name.replace('_', r'\_'))
        cols = [w_flat, -lnp] + \
            [flat[:, i] for i in range(ndim)] + derived_cols
        return np.column_stack(cols), derived_names, derived_latex

    aux3 = None if aux is None else \
        np.asarray(aux)[burn_in:].reshape(n_steps, n_walkers, -1)
    os.makedirs(os.path.dirname(os.path.abspath(root)), exist_ok=True)

    if n_chain_files and n_chain_files > 1:
        k = min(n_chain_files, n_walkers)
        groups = np.array_split(np.arange(n_walkers), k)
        chain_file = f'{root}.1.txt'
        for gi, idx in enumerate(groups, start=1):
            flat = chain[:, idx].reshape(-1, ndim)
            lnp = log_prob[:, idx].reshape(-1)
            aux_flat = None if aux3 is None else \
                aux3[:, idx].reshape(flat.shape[0], -1)
            table, derived_names, derived_latex = _columns(
                flat, lnp, aux_flat, wts[:, idx].reshape(-1))
            np.savetxt(f'{root}.{gi}.txt', table, fmt='%.8e')
    else:
        flat = chain.reshape(-1, ndim)
        lnp = log_prob.reshape(-1)
        aux_flat = None if aux3 is None else aux3.reshape(flat.shape[0], -1)
        table, derived_names, derived_latex = _columns(flat, lnp, aux_flat,
                                                       wts.reshape(-1))
        chain_file = f'{root}.{chain_index}.txt'
        np.savetxt(chain_file, table, fmt='%.8e')

    with open(f'{root}.paramnames', 'w') as f:
        for p in space.sampled:
            f.write(f'{p.name}\t{p.latex or p.name}\n')
        for name, latex in zip(derived_names, derived_latex):
            f.write(f'{name}*\t{latex}\n')

    lo, hi = space.bounds()
    with open(f'{root}.ranges', 'w') as f:
        for i, p in enumerate(space.sampled):
            lo_s = f'{lo[i]:.6g}' if np.isfinite(lo[i]) else 'N'
            hi_s = f'{hi[i]:.6g}' if np.isfinite(hi[i]) else 'N'
            f.write(f'{p.name}\t{lo_s}\t{hi_s}\n')

    # cobaya-compatible `<root>.covmat`: weighted posterior covariance of
    # the sampled parameters, read back by `mcmc: {covmat: ...}` / covmat=
    flat_all = chain.reshape(-1, ndim)
    w_all = wts.reshape(-1)
    wsum = float(np.sum(w_all))
    if len(flat_all) >= 2 and wsum > 0:
        mu = np.average(flat_all, axis=0, weights=w_all)
        d = flat_all - mu
        # reliability-weights unbiased denominator (== N-1 at unit weights)
        denom = wsum - float(np.sum(w_all ** 2)) / wsum
        if denom > 0:
            cov = (d * w_all[:, None]).T @ d / denom
            write_covmat(f'{root}.covmat',
                         [p.name for p in space.sampled], cov)
    return chain_file


def append_progress(root: str, n: int, acceptance: float, rminus1: float,
                    reset: bool = False) -> str:
    """Append one row to `<root>.progress` — cobaya's convergence-monitoring
    file (columns `N timestamp acceptance_rate Rminus1 Rminus1_cl`, one row
    per checkpoint). `Rminus1_cl` has no analogue here and is written as
    nan; R-1 itself is nan until enough post-warmup draws exist to define
    split-R-hat. `reset=True` truncates the file (a fresh run); resumed runs
    append."""
    import datetime
    path = root + '.progress'
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fresh = reset or not os.path.isfile(path)
    with open(path, 'w' if fresh else 'a') as f:
        if fresh:
            f.write('# N  timestamp  acceptance_rate  Rminus1  Rminus1_cl\n')
        ts = datetime.datetime.now().strftime('%Y-%m-%d %H:%M:%S')
        f.write(f'{int(n)}  {ts}  {acceptance:.4f}  {rminus1:.6f}  nan\n')
    return path


def read_progress(root: str) -> Dict[str, np.ndarray]:
    """Parse `<root>.progress` (append_progress / cobaya format) into
    arrays: {'n', 'acceptance', 'rminus1'}. Columns are anchored from the
    row's end because the timestamp is two tokens here and one in cobaya."""
    path = root if root.endswith('.progress') else root + '.progress'
    ns, accs, rm1s = [], [], []
    with open(path) as f:
        for ln in f:
            if ln.lstrip().startswith('#') or not ln.strip():
                continue
            parts = ln.split()
            ns.append(int(parts[0]))
            accs.append(float(parts[-3]))
            rm1s.append(float(parts[-2]))
    return {'n': np.asarray(ns), 'acceptance': np.asarray(accs),
            'rminus1': np.asarray(rm1s)}


def write_covmat(path: str, names: List[str], cov: np.ndarray) -> None:
    """Write a cobaya-format covmat file: `# name1 name2 ...` header, then
    the matrix."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, 'w') as f:
        f.write('# ' + ' '.join(names) + '\n')
        np.savetxt(f, np.atleast_2d(np.asarray(cov)), fmt='%.8e')


def read_covmat(path: str, names: List[str],
                fallback_var: Optional[np.ndarray] = None) -> np.ndarray:
    """Load a cobaya-format `.covmat` and reorder/subset it to `names`.

    cobaya's fill rule: parameters present in the file get their covariance
    block; parameters absent fall back to a diagonal entry (`fallback_var`,
    e.g. proposal widths squared) with zero cross-covariance. Raises
    InputError when no requested parameter is present or the matrix is
    malformed."""
    from ..errors import InputError
    with open(path) as f:
        header = f.readline()
    if not header.lstrip().startswith('#'):
        raise InputError(
            f"covmat file {path!r} has no '# name1 name2 ...' header line")
    file_names = header.lstrip('#').split()
    mat = np.atleast_2d(np.loadtxt(path, skiprows=1))
    if mat.shape != (len(file_names), len(file_names)):
        raise InputError(
            f"covmat file {path!r}: matrix shape {mat.shape} does not match "
            f"its {len(file_names)}-name header")
    idx = {n: i for i, n in enumerate(file_names)}
    found = [n for n in names if n in idx]
    if not found:
        raise InputError(
            f"covmat file {path!r} (params {file_names}) shares no "
            f"parameter with the sampled block {list(names)}")
    n = len(names)
    out = np.zeros((n, n))
    if fallback_var is not None:
        out[np.diag_indices(n)] = np.asarray(fallback_var, dtype=float)
    for a, na in enumerate(names):
        for b, nb in enumerate(names):
            if na in idx and nb in idx:
                out[a, b] = mat[idx[na], idx[nb]]
    return out


def read_getdist(root: str):
    """Read GetDist-format chains written by export_getdist (or cobaya).

    Returns (names, weights, minus_lnpost, samples) with every
    `<root>.N.txt` concatenated in chain-index order; `names` lists every
    column after the two leading ones (sampled params first, then
    derived/aux, their GetDist `*` suffix stripped).
    """
    import glob
    import re

    names = []
    with open(f'{root}.paramnames') as f:
        for line in f:
            token = line.split()[0] if line.split() else ''
            if token:
                names.append(token.rstrip('*'))
    # glob.escape: a root containing [, ], ? or * must match literally
    files = [fn for fn in glob.glob(f'{glob.escape(root)}.*.txt')
             if re.fullmatch(r'\d+', fn[len(root) + 1:-4])]
    if not files:
        raise FileNotFoundError(f'no chain files match {root}.<N>.txt')
    files.sort(key=lambda fn: int(fn[len(root) + 1:-4]))
    data = np.vstack([np.loadtxt(fn, ndmin=2) for fn in files])
    if data.shape[1] != 2 + len(names):
        raise ValueError(
            f'{root}: chain files have {data.shape[1]} columns but '
            f'.paramnames lists {len(names)} parameters (expected '
            f'{2 + len(names)} columns: weight, -lnpost, params...)')
    return names, data[:, 0], data[:, 1], data[:, 2:]
