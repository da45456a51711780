"""Build the model's tables from reference-schema config dicts.

The port of `victor_tpu/io/tables.py`. Everything the reference does once in
`CCFModel.__init__`/`CCFFit.__init__` (victor/ccf_model.py:33-297,
victor/ccf_fit.py:15-164) runs here on the host in numpy/scipy, together with
the extraction of the linear operators that let the per-evaluation path run
as interval lookups and small matmuls: PCHIP coefficients over the beta
grids, cubic-spline derivative operators, the enclosed-density and
resampled-gradient operators, the bicubic dispersion surface, the multipole
projection, the quadrature weights, the covariance stacks and the
excursion-set model's k grid and P(k) tables. The finished float64 arrays
are moved to `device` as `dtype` once: the card unless the caller asks for
the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch

from .. import ops
from ..config import (FitOptions, TableSpec, TheoryOptions,
                      fit_options_from_config, theory_options_from_config)
from ..errors import InputError
from ..models.cosmology import BackgroundCosmology
from .loaders import load_key_value_file, select_simulation

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CCFTables:
    """All arrays and operators needed for theory and likelihood: the fields
    of `victor_tpu.io.tables.CCFTables`."""
    # --- scalars ---
    iaH: Tensor
    template_sigma8: Optional[Tensor]
    bias_default: Tensor
    # --- real-space CCF over (beta,) r ---
    r: Tensor                               # (n_r,)
    beta_grid: Optional[Tensor]             # (n_b,) or None if fixed input
    real_mult_fixed: Optional[Tensor]       # (n_ell, n_r)
    real_mult_pchip_c: Optional[Tensor]     # (n_b-1, 4, n_ell, n_r)
    spline_mult: ops.Spline1D               # knots r, clamped
    # --- velocity knot vector r_v = [0.01, r...] ---
    r_v: Tensor                             # (n_r+1,)
    spline_vel: ops.Spline1D                # knots r_v, clamped
    rgrid100: Tensor                        # (100,) fine derivative grid
    dvr_op: Tensor                          # (n_r+1, 100) resampled gradient
    # --- matter model (template) ---
    delta_rv: Optional[Tensor]              # (n_r+1,)
    Delta_rv: Optional[Tensor]              # (n_r+1,)
    delta_r100: Optional[Tensor]            # (100,)
    Delta_r100: Optional[Tensor]            # (100,)
    # --- matter model (linear bias): operators on the real monopole ---
    lb_delta_op: Optional[Tensor]           # (n_r+1, n_r)
    lb_Delta_op: Optional[Tensor]           # (n_r+1, n_r)
    lb_delta100_op: Optional[Tensor]        # (100, n_r)
    lb_Delta100_op: Optional[Tensor]        # (100, n_r)
    # --- velocity mean template ---
    vr_template_rv: Optional[Tensor]        # (n_r+1,)
    vr_template_100: Optional[Tensor]       # (100,)
    template_fsigma8: Optional[Tensor]
    template_hubble_ratio: Optional[Tensor]
    redshift_shift: Optional[Tensor]        # (1+z_sim)/(1+z_eff)
    # --- velocity dispersion surface ---
    sv_surf: ops.Bicubic2D
    # --- integration / projection fixtures ---
    x_nodes: Tensor                         # (n_v,) linspace(-6, 6)
    vel_weights: Tensor                     # (n_v,) simps weights in x units
    mu_ap: Tensor                           # (50,) linspace(1e-10, 1)
    mu_ap_w: Tensor                         # (50,) trapz weights
    proj: Tensor                            # (n_ell_s, n_mu)
    mu_grid: Tensor                         # (n_mu,)
    # --- excursion-set model fixtures (None unless matter excursion_set) ---
    z_eff: Tensor
    esm_k: Optional[Tensor]                 # (200,) log k grid
    esm_kw: Optional[Tensor]                # (200,) trapz weights
    esm_pk0: Optional[Tensor]               # (200,) CAMB P(k, z=0) table
    esm_s80: Optional[Tensor]               # sigma8(0) of the fiducial table
    esm_s8z: Optional[Tensor]               # sigma8(z_eff) of the fiducial table
    esm_x50: Optional[Tensor]               # (50,) density_evolution grid
    # --- data side (None when built without a data block) ---
    s: Optional[Tensor]                     # (n_s,)
    beta_ccf: Optional[Tensor]
    data_mult_fixed: Optional[Tensor]       # (n_ell_s, n_s)
    data_mult_pchip_c: Optional[Tensor]     # (n_b-1, 4, n_ell_s, n_s)
    beta_cov: Optional[Tensor]
    cov: Optional[Tensor]                   # (n_b, D, D) or (D, D)
    icov: Optional[Tensor]
    # beta-covariance pencil factorization: grid logdets and generalized
    # eigenvalues of (C_end, C_b), for the 'factored' beta_covariance mode
    cov_logdet: Optional[Tensor] = None     # (n_b,)
    cov_pencil: Optional[Tensor] = None     # (n_b, D)
    # cosmology-grid CAMB mode (None unless pk_grid_file configured): log
    # P(k) and generator sigma8 tables over a small cosmology grid, the axis
    # names in TableSpec.esm_grid_names
    esm_grid_axes: Optional[tuple] = None   # tuple of (n_a,) axis grids
    esm_pk_grid: Optional[Tensor] = None    # (n_cells, nk) log P(k, 0)
    esm_s80_grid: Optional[Tensor] = None   # (n_cells,)
    esm_s8z_grid: Optional[Tensor] = None   # (n_cells,)

    def to(self, device, dtype) -> 'CCFTables':
        """A copy with every tensor on `device` as `dtype`."""
        def move(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                return tuple(a.to(device, dtype) for a in v)
            return v.to(device, dtype)
        return CCFTables(**{f.name: move(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class CCFModelBundle:
    """Tables together with the static spec and default options."""
    tables: CCFTables
    spec: TableSpec
    theory_opts: TheoryOptions
    fit_opts: Optional[FitOptions] = None

    def to(self, device, dtype) -> 'CCFModelBundle':
        return dataclasses.replace(self, tables=self.tables.to(device, dtype))


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def _multipoles_from_rmu_grid(r, mu, ccf_rmu, ells, npts=200):
    """r-mu grid -> multipoles, matching the reference conversion
    (victor/ccf_model.py:169-181: *linear* interp2d + utils.multipoles_from_fn
    with a 200-point [0,1] trapz)."""
    mu_fine = np.linspace(0.0, 1.0, npts)
    tw = ops.trapz_weights(mu_fine)
    cols = np.empty((len(r), npts))
    for i in range(len(r)):
        cols[i] = np.interp(mu_fine, mu, ccf_rmu[i])
    out = {}
    for ell in ells:
        w = (2 * ell + 1) * tw * ops.legendre_p(ell, mu_fine)
        out[f'{ell}'] = cols @ w
    return out


def _pencil_precompute(stack):
    """Generalized-eigenvalue factorization of a beta-covariance stack
    (n_b, D, D): (logdets (n_b,), lam (n_b, D)) such that
    log det((1-t) C_b + t C_end) = logdets[b] + sum_i log((1-t) + t*lam[b, i]).
    Returns (None, None) if any slice is not positive definite."""
    import scipy.linalg

    n = stack.shape[0]
    logdets = np.empty(n)
    lams = np.empty(stack.shape[:2])
    try:
        for b in range(n):
            sign, ld = np.linalg.slogdet(stack[b])
            if sign != 1:
                raise np.linalg.LinAlgError(f'covariance slice {b} not PD')
            logdets[b] = ld
            lams[b] = scipy.linalg.eigh(stack[-1], stack[b],
                                        eigvals_only=True)
    except (np.linalg.LinAlgError, scipy.linalg.LinAlgError) as e:
        logging.getLogger('victor_tpu_torch.tables').warning(
            'beta-covariance pencil factorization unavailable (%s)', e)
        return None, None
    return logdets, lams


# ---------------------------------------------------------------------------
# main builder
# ---------------------------------------------------------------------------

def _target_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist. There is no
    quiet fallback to the CPU: a caller who wants the CPU asks for it."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'victor_tpu_torch: tables are built for {device}, but no CUDA '
            "device is available; pass device='cpu' to run on the CPU")
    return device


def build_tables(model: dict, data: Optional[dict] = None,
                 n_mu: int = 100, n_v: int = 50, device='cuda',
                 dtype: torch.dtype = torch.float64) -> CCFModelBundle:
    """Build the bundle from reference-schema `model:` (and optional `data:`)
    dicts. The build runs in float64 numpy on the host; the tables then move
    to `device` as `dtype`: the card unless `device='cpu'` is asked for."""
    device = _target_device(device)
    arrays, spec, theory_opts, fit_opts = _build_arrays(model, data, n_mu, n_v)
    return CCFModelBundle(tables=_tables_from_arrays(arrays, device, dtype),
                          spec=spec, theory_opts=theory_opts,
                          fit_opts=fit_opts)


def bundle_from_arrays(arrays: dict, spec: dict, theory_opts: dict,
                       fit_opts: Optional[dict], device='cuda',
                       dtype: torch.dtype = torch.float64) -> CCFModelBundle:
    """A bundle from numpy arrays, e.g. copies of another build's leaves, on
    `device` (the card unless `device='cpu'` is asked for) as `dtype`.

    `arrays` maps every `CCFTables` field to an array, a tuple of arrays
    ('esm_grid_axes') or None, except the nested splines, which are given by
    their leaves: 'spline_mult.x', 'spline_mult.deriv_op', 'spline_vel.x',
    'spline_vel.deriv_op', 'sv_surf.x', 'sv_surf.y', 'sv_surf.cu',
    'sv_surf.cv' and the flag 'sv_surf.y_const'. `spec`, `theory_opts` and
    `fit_opts` are the field dicts of TableSpec, TheoryOptions and
    FitOptions (fit_opts may be None).
    """
    device = _target_device(device)
    flat = dict(arrays)
    nested = {
        'spline_mult': ops.Spline1D(flat.pop('spline_mult.x'),
                                    flat.pop('spline_mult.deriv_op')),
        'spline_vel': ops.Spline1D(flat.pop('spline_vel.x'),
                                   flat.pop('spline_vel.deriv_op')),
        'sv_surf': ops.Bicubic2D(flat.pop('sv_surf.x'), flat.pop('sv_surf.y'),
                                 flat.pop('sv_surf.cu'), flat.pop('sv_surf.cv'),
                                 bool(flat.pop('sv_surf.y_const'))),
    }
    spec = dict(spec)
    for key in ('poles_r', 'poles_s', 'esm_grid_names'):
        if key in spec:
            spec[key] = tuple(spec[key])
    return CCFModelBundle(
        tables=_tables_from_arrays({**flat, **nested}, device, dtype),
        spec=TableSpec(**spec), theory_opts=TheoryOptions(**theory_opts),
        fit_opts=None if fit_opts is None else FitOptions(**fit_opts))


_NESTED = {'spline_mult': ('x', 'deriv_op'), 'spline_vel': ('x', 'deriv_op'),
           'sv_surf': ('x', 'y', 'cu', 'cv', 'y_const')}


def tables_to_arrays(tables) -> dict:
    """The leaves of a tables object as numpy arrays (or None), keyed as
    `bundle_from_arrays` takes them. It reads the port's field names by
    attribute, so it accepts victor_tpu's CCFTables too."""
    out = {}
    for f in dataclasses.fields(CCFTables):
        v = getattr(tables, f.name)
        if f.name in _NESTED:
            for leaf in _NESTED[f.name]:
                a = getattr(v, leaf)
                out[f'{f.name}.{leaf}'] = a if isinstance(a, bool) else _host(a)
        elif isinstance(v, tuple):
            out[f.name] = tuple(_host(a) for a in v)
        elif v is not None:
            out[f.name] = _host(v)
        else:
            out[f.name] = None
    return out


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _tables_from_arrays(arrays: dict, device, dtype) -> CCFTables:
    """CCFTables from float64 leaves (the splines given whole, with numpy
    leaves), moved to `device` as `dtype`."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, (ops.Spline1D, ops.Bicubic2D)):
            return v.to(device, dtype)
        if isinstance(v, tuple):
            return tuple(conv(a) for a in v)
        return torch.tensor(np.asarray(v, dtype=np.float64)).to(device, dtype)
    return CCFTables(**{f.name: conv(arrays.get(f.name))
                        for f in dataclasses.fields(CCFTables)})


def _build_arrays(model: dict, data: Optional[dict], n_mu: int, n_v: int):
    """The host build: (arrays, spec, theory_opts, fit_opts) with every table
    a float64 numpy array and the splines as numpy-leaved dataclasses."""

    # ---------------- cosmology / iaH (ccf_model.py:43-45) ----------------
    z_eff = model['z_eff']
    cosmo = BackgroundCosmology(model.get('cosmology'))
    iaH = (1 + z_eff) / (100 * cosmo.Ez(z_eff))

    base_dir = model.get('dir', '')
    input_fn = os.path.join(base_dir, model['input_model_data_file'])
    input_data = load_key_value_file(input_fn)

    # ---------------- real-space ccf (ccf_model.py:99-181) ----------------
    realspace = model['realspace_ccf']
    fmt = realspace.get('format', 'multipoles')
    fixed_real_input = not realspace.get('reconstruction', False)
    ccf_keys = list(np.atleast_1d(realspace['ccf_keys']))

    beta_grid = None
    if not fixed_real_input:
        beta_key = realspace.get('beta_key', None)
        if beta_key is None:
            raise InputError('Reconstruction specified for realspace ccf but no beta key provided')
        if beta_key not in input_data:
            raise InputError(f'Key {beta_key} not found in input model data file')
        beta_grid = np.asarray(input_data[beta_key], dtype=np.float64)
        if not np.all(np.diff(beta_grid) > 0):
            raise InputError('Realspace beta grid must be strictly monotonically increasing')

    bad_keys = (fmt == 'multipoles' and len(ccf_keys) < 2) or \
               (fmt == 'rmu' and len(ccf_keys) != 3)
    if bad_keys:
        raise InputError(f'Wrong number of ccf keys provided for ccf format {fmt}')
    for key in ccf_keys:
        if key not in input_data:
            raise InputError(f'Key {key} not found in input model data file')

    isim = realspace.get('simulation_number', None)

    if fmt == 'multipoles':
        r = np.asarray(input_data[ccf_keys[0]], dtype=np.float64)
        poles_r = tuple([0, 2, 4][:len(ccf_keys) - 1])
        real_mult = {}
        for i, ell in enumerate(poles_r):
            arr = select_simulation(np.asarray(input_data[ccf_keys[i + 1]]), isim)
            if fixed_real_input:
                if arr.shape != r.shape:
                    raise InputError(
                        f'Shape of real ccf multipole {ell} is {arr.shape}, expected {r.shape}')
            else:
                if arr.shape != (len(beta_grid), len(r)):
                    raise InputError(
                        f'Shape of real ccf multipole {ell} is {arr.shape}, '
                        f'expected ({len(beta_grid)}, {len(r)})')
            real_mult[ell] = np.asarray(arr, dtype=np.float64)
    elif fmt == 'rmu':
        r = np.asarray(input_data[ccf_keys[0]], dtype=np.float64)
        mu_in = np.asarray(input_data[ccf_keys[1]], dtype=np.float64)
        ccf = select_simulation(np.asarray(input_data[ccf_keys[2]]), isim)
        poles_r = (0, 2, 4)
        if fixed_real_input:
            if ccf.shape != (len(r), len(mu_in)):
                raise InputError(
                    f'Shape of real ccf is {ccf.shape}, expected ({len(r)}, {len(mu_in)})')
            m = _multipoles_from_rmu_grid(r, mu_in, ccf, poles_r)
            real_mult = {ell: m[f'{ell}'] for ell in poles_r}
        else:
            if ccf.shape != (len(beta_grid), len(r), len(mu_in)):
                raise InputError(
                    f'Shape of real ccf is {ccf.shape}, expected '
                    f'({len(beta_grid)}, {len(r)}, {len(mu_in)})')
            real_mult = {ell: np.zeros((len(beta_grid), len(r))) for ell in poles_r}
            for b in range(len(beta_grid)):
                m = _multipoles_from_rmu_grid(r, mu_in, ccf[b], poles_r)
                for ell in poles_r:
                    real_mult[ell][b] = m[f'{ell}']
    else:
        raise InputError(f"Unrecognised realspace ccf format '{fmt}'")

    stacked = np.stack([real_mult[ell] for ell in poles_r])   # (n_ell, [n_b,] n_r)
    if fixed_real_input:
        real_mult_fixed = stacked
        real_mult_pchip_c = None
    else:
        real_mult_fixed = None
        real_mult_pchip_c = ops.pchip_coeffs(beta_grid, np.moveaxis(stacked, 1, 0))

    # ---------------- matter ccf (ccf_model.py:183-220,328-383) ----------------
    matter = model['matter_ccf']
    matter_model = matter.get('model', 'linear_bias')
    realspace_from_data = realspace.get('from_data', False)
    template_sigma8 = matter.get('template_sigma8', None)
    if matter_model == 'linear_bias' and not realspace_from_data and not template_sigma8:
        raise InputError(
            'When using linear bias for the matter ccf and the real-space ccf is from a '
            'template, template_sigma8 must be provided')
    if matter_model == 'template' and not template_sigma8:
        raise InputError('When using template model for the matter ccf, template_sigma8 must be provided')

    if r.ndim != 1 or len(r) < 4 or np.any(np.diff(r) <= 0) or r[0] <= 0.01 \
            or r[-1] <= 0.1:
        raise InputError('radial grid in the input model data file must be a '
                         'strictly increasing 1D vector with >= 4 points, all '
                         'above the r=0.01 velocity anchor and extending past '
                         f'r=0.1; got shape {r.shape}')
    r_v = np.concatenate([[0.01], r])
    rgrid100 = np.linspace(0.1, r.max(), 100)
    # velocity_terms re-splines NODAL values over r_v (ext=3) and evaluates
    # that on the fine grid (ref ccf_model.py:421-423,456-459): one more
    # fixed linear operator, shared by the template and linear_bias branches
    respline_100 = ops.spline_eval_matrix(r_v, rgrid100, ext=3)

    delta_rv = Delta_rv = delta_r100 = Delta_r100 = None
    lb_delta_op = lb_Delta_op = lb_delta100_op = lb_Delta100_op = None

    if matter_model == 'template':
        template_keys = list(np.atleast_1d(matter.get('template_keys')))
        integrated = matter.get('integrated', False)
        if len(template_keys) != 2:
            raise InputError('Wrong number of matter ccf template keys provided: '
                             'expected 2 (radial distance and monopole)')
        for key in template_keys:
            if key not in input_data:
                raise InputError(f'Key {key} not found in input model data file')
        r_delta = np.asarray(input_data[template_keys[0]], dtype=np.float64)
        delta_in = np.asarray(input_data[template_keys[1]], dtype=np.float64)
        if len(r_delta) != len(delta_in):
            raise InputError(
                f'Shape of matter ccf template is {len(delta_in)}, expected {len(r_delta)}')
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        from scipy.integrate import quad
        r50 = np.linspace(r_delta.min(), r_delta.max())    # 50-pt grid as reference
        if integrated:
            int_spl = IUS(r_delta, delta_in, k=3, ext=3)
            deriv = np.gradient(int_spl(r50), r50)
            delta_spl = IUS(r50, int_spl(r50) + r50 * deriv / 3.0, k=3, ext=3)
        else:
            delta_spl = IUS(r_delta, delta_in, k=3, ext=3)
            integral = np.array([
                quad(lambda x, ri=ri: 3 * delta_spl(x) * x ** 2 / ri ** 3,
                     0, ri, full_output=1)[0] for ri in r50])
            int_spl = IUS(r50, integral, k=3, ext=3)
        delta_rv, Delta_rv = delta_spl(r_v), int_spl(r_v)
        delta_r100, Delta_r100 = respline_100 @ delta_rv, respline_100 @ Delta_rv
    elif matter_model == 'linear_bias':
        lb_delta_op = ops.spline_eval_matrix(r, r_v, ext=3)
        lb_Delta_op = ops.enclosed_density_operator(r, r_v)
        lb_delta100_op = respline_100 @ lb_delta_op
        lb_Delta100_op = respline_100 @ lb_Delta_op
    elif matter_model != 'excursion_set':
        raise InputError(f'Invalid choice of matter_model {matter_model}')

    # ESM fixtures (victor/excursion_set_profile.py:61; set_ESM_params
    # ccf_model.py:494-536): P(k) is Eisenstein-Hu computed per call, a
    # pregenerated CAMB table (tools/make_camb_table.py), or a grid of such
    # tables over cosmology axes
    esm, esm_use_eh, esm_grid_names = \
        _esm_arrays(matter, base_dir, r) if matter_model == 'excursion_set' \
        else ({}, True, ())

    # ---------------- velocity pdf (ccf_model.py:222-297) ----------------
    velocity = model['velocity_pdf']
    mean_model = velocity['mean'].get('model', 'linear')
    vr_template_rv = vr_template_100 = None
    template_fsigma8 = template_hubble_ratio = redshift_shift = None
    has_velocity_template = False
    if mean_model == 'template':
        template_fsigma8 = velocity['mean'].get('template_fsigma8')
        if not template_fsigma8:
            raise InputError('When using template model for the mean of the velocity pdf, '
                             'a value for template_fsigma8 must be provided')
        # explicit None checks: z_sim = 0 is a legitimate z=0 snapshot
        z_sim = velocity['mean'].get('z_sim')
        z_sim = z_eff if z_sim is None else z_sim
        template_hubble_ratio = velocity['mean'].get('template_hubble_ratio')
        template_hubble_ratio = 1 if template_hubble_ratio is None \
            else template_hubble_ratio
        redshift_shift = (1 + z_sim) / (1 + z_eff)
        template_keys = list(np.atleast_1d(velocity['mean'].get('template_keys')))
        if len(template_keys) != 2:
            raise InputError(f'{len(template_keys)} velocity mean template keys provided, require 2')
        for key in template_keys:
            if key not in input_data:
                raise InputError(f'Key {key} not found in input model data file')
        r_for_v = np.asarray(input_data[template_keys[0]], dtype=np.float64)
        vr_in = np.asarray(input_data[template_keys[1]], dtype=np.float64)
        if len(r_for_v) != len(vr_in):
            raise InputError(f'Shape of mean velocity template is {len(vr_in)}, '
                             f'expected {len(r_for_v)}')
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        v_spl = IUS(r_for_v, vr_in, k=3, ext=3)
        vr_template_rv, vr_template_100 = v_spl(r_v), v_spl(rgrid100)
        has_velocity_template = True
    if mean_model == 'nonlinear' and matter_model != 'excursion_set':
        raise InputError('Cannot have nonlinear mean velocity model unless using '
                         'excursion_set matter model')

    dispersion = velocity.get('dispersion', {})
    disp_model = dispersion.get('model', 'constant')
    if disp_model == 'template':
        template_keys = list(np.atleast_1d(dispersion.get('template_keys')))
        if len(template_keys) < 2 or len(template_keys) > 3:
            raise InputError(f'{len(template_keys)} velocity dispersion template keys '
                             'provided, require 2 or 3')
        for key in template_keys:
            if key not in input_data:
                raise InputError(f'Key {key} not found in input model data file')
        r_sv = np.asarray(input_data[template_keys[0]], dtype=np.float64)
        sv = np.asarray(input_data[template_keys[-1]], dtype=np.float64)
        if r_sv.ndim != 1 or len(r_sv) < 2 or np.any(np.diff(r_sv) <= 0):
            raise InputError('dispersion template radial grid must be a '
                             'strictly increasing 1D vector')
        if len(template_keys) == 2:
            mu_sv = np.linspace(0, 1)
            sv = (np.ones((len(mu_sv), len(r_sv))) * sv).T
        else:
            mu_sv = np.asarray(input_data[template_keys[1]], dtype=np.float64)
            if mu_sv.ndim != 1 or len(mu_sv) < 2 \
                    or np.any(np.diff(mu_sv) <= 0):
                raise InputError('dispersion template mu grid must be a '
                                 'strictly increasing 1D vector')
        if sv.shape != (len(r_sv), len(mu_sv)):
            raise InputError(f'Dispersion template shape {sv.shape} does not match '
                             f'expected ({len(r_sv), len(mu_sv)})')
        if dispersion.get('filter', True):
            from scipy.signal import savgol_filter
            window = dispersion.get('filter_window', 3)
            polyorder = dispersion.get('filter_order', 1)
            sv = np.array([savgol_filter(sv[:, i], window, polyorder)
                           for i in range(sv.shape[1])]).T
    elif disp_model == 'constant':
        # the reference's 'constant' branch (ccf_model.py:284-287) is dead
        # code behind an unbound local; its intent is a unit dispersion shape
        r_sv = r.copy()
        mu_sv = np.linspace(0, 1)
        sv = np.ones((len(r_sv), len(mu_sv)))
    else:
        raise InputError(f"Bad choice '{disp_model}' for dispersion model, "
                         "options are 'constant' or 'template'")

    # normalise by the large-r limit of the monopole (ccf_model.py:294-297)
    mu_fine = np.linspace(0.0, 1.0, 200)
    tw = ops.trapz_weights(mu_fine)
    rows = np.stack([np.interp(mu_fine, mu_sv, sv[i]) for i in range(len(r_sv))])
    sv_monopole = rows @ tw
    sv_norm = sv / sv_monopole[-1]

    # ---------------- integration / projection fixtures ----------------
    x_nodes = np.linspace(-6.0, 6.0, n_v)
    vel_weights = ops.simpson_weights(n_v, dx=x_nodes[1] - x_nodes[0])
    mu_ap = np.linspace(1e-10, 1.0)
    mu_ap_w = ops.trapz_weights(mu_ap)
    mu_grid = np.linspace(0.0, 1.0, n_mu)

    # ---------------- data block (ccf_fit.py:44-164) ----------------
    s = beta_ccf = data_mult_fixed = data_mult_pchip_c = None
    beta_cov = cov = icov = cov_logdet = cov_pencil = None
    poles_s = poles_r
    fixed_data = True
    fixed_covmat = True
    fit_opts = None

    if data is not None:
        data_dir = data.get('dir', '')
        if data.get('redshift_space_ccf', {}).get('data_file') is None:
            raise InputError('data block must provide redshift_space_ccf.data_file')
        data_fn = os.path.join(data_dir, data['redshift_space_ccf']['data_file'])
        has_cov = 'covariance_matrix' in data and data['covariance_matrix']
        if has_cov and data['covariance_matrix'].get('data_file') is None:
            raise InputError('covariance_matrix block must provide data_file')
        cov_fn = os.path.join(data_dir, data['covariance_matrix']['data_file']) \
            if has_cov else None
        for fn in ([data_fn, cov_fn] if has_cov else [data_fn]):
            if not os.path.isfile(fn):
                raise InputError(f'Data file {fn} not found')
        ccf = data['redshift_space_ccf']
        ddict = load_key_value_file(data_fn)
        isim_d = ccf.get('simulation_number', None)
        fixed_data = not ccf.get('reconstruction', False)
        if not fixed_data:
            beta_key = ccf.get('beta_key', None)
            if beta_key and beta_key in ddict:
                beta_ccf = np.asarray(ddict[beta_key], dtype=np.float64)
                if not np.all(np.diff(beta_ccf) > 0):
                    raise InputError('Redshift-space beta grid must be strictly '
                                     'monotonically increasing')
            else:
                if fixed_real_input:
                    raise InputError('Reconstruction beta information required for '
                                     'redshift-space ccf but not found')
                beta_ccf = beta_grid.copy()
        dfmt = ccf.get('format', 'multipoles')
        dkeys = list(np.atleast_1d(ccf['ccf_keys']))
        bad = (dfmt == 'multipoles' and len(dkeys) < 2) or (dfmt == 'rmu' and len(dkeys) != 3)
        if bad:
            raise InputError(f'Wrong number of redshift-space ccf keys provided for format {dfmt}')
        for key in dkeys:
            if key not in ddict:
                raise InputError(f'Key {key} not found in file {data_fn}')
        if dfmt != 'multipoles':
            raise InputError('Currently only multipole format is supported for '
                             'redshift-space ccf data and covmat')
        s = np.asarray(ddict[dkeys[0]], dtype=np.float64)
        poles_s = tuple([0, 2, 4][:len(dkeys) - 1])
        dm = {}
        for i, ell in enumerate(poles_s):
            arr = select_simulation(np.asarray(ddict[dkeys[i + 1]]), isim_d)
            if fixed_data:
                if arr.shape != s.shape:
                    raise InputError(f'Shape of redshift ccf multipole {ell} is '
                                     f'{arr.shape}, expected {s.shape}')
            else:
                if arr.shape != (len(beta_ccf), len(s)):
                    raise InputError(f'Shape of redshift ccf multipole {ell} is '
                                     f'{arr.shape}, expected ({len(beta_ccf)}, {len(s)})')
            dm[ell] = np.asarray(arr, dtype=np.float64)
        dstack = np.stack([dm[ell] for ell in poles_s])
        if fixed_data:
            data_mult_fixed = dstack
        else:
            data_mult_pchip_c = ops.pchip_coeffs(beta_ccf, np.moveaxis(dstack, 1, 0))

        # covariance (ccf_fit.py:116-164)
        if has_cov:
            covariance = data['covariance_matrix']
            cdict = load_key_value_file(cov_fn)
            if not fixed_data:
                fixed_covmat = covariance.get('fixed_beta', True)
                if not fixed_covmat:
                    beta_key = covariance.get('beta_key', None)
                    if beta_key and beta_key in cdict:
                        beta_cov = np.asarray(cdict[beta_key], dtype=np.float64)
                        if not np.all(np.diff(beta_cov) > 0):
                            raise InputError('Covariance beta grid must be strictly '
                                             'monotonically increasing')
                    else:
                        beta_cov = beta_ccf.copy()
            else:
                fixed_covmat = True
            cov_key = covariance['cov_key']
            if cov_key not in cdict:
                raise InputError(f'Key {cov_key} not found in file {cov_fn}')
            cov = np.asarray(cdict[cov_key], dtype=np.float64)
            D = len(s) * len(poles_s)
            if fixed_covmat:
                if cov.shape != (D, D):
                    raise InputError('Unexpected shape of (fixed) covariance matrix')
            else:
                if cov.shape != (len(beta_cov), D, D):
                    raise InputError('Unexpected shape of (beta-varying) covariance matrix')
            icov = np.linalg.inv(cov)
            if not fixed_covmat:
                cov_logdet, cov_pencil = _pencil_precompute(cov)
        fit_opts = fit_options_from_config(data)

    # projection matrix over the theory mu grid for the data-side multipoles
    proj = ops.multipole_projection_matrix(mu_grid, list(poles_s), npts=200, even=True)

    arrays = dict(
        iaH=iaH, template_sigma8=template_sigma8,
        bias_default=matter.get('bias', 1.9),
        r=r, beta_grid=beta_grid,
        real_mult_fixed=real_mult_fixed, real_mult_pchip_c=real_mult_pchip_c,
        spline_mult=ops.Spline1D.build_host(r),
        r_v=r_v, spline_vel=ops.Spline1D.build_host(r_v),
        rgrid100=rgrid100,
        dvr_op=ops.resampled_gradient_operator(rgrid100, r_v),
        delta_rv=delta_rv, Delta_rv=Delta_rv,
        delta_r100=delta_r100, Delta_r100=Delta_r100,
        lb_delta_op=lb_delta_op, lb_Delta_op=lb_Delta_op,
        lb_delta100_op=lb_delta100_op, lb_Delta100_op=lb_Delta100_op,
        vr_template_rv=vr_template_rv, vr_template_100=vr_template_100,
        template_fsigma8=template_fsigma8,
        template_hubble_ratio=template_hubble_ratio,
        redshift_shift=redshift_shift,
        sv_surf=ops.Bicubic2D.build_host(r_sv, mu_sv, sv_norm),
        x_nodes=x_nodes, vel_weights=vel_weights,
        mu_ap=mu_ap, mu_ap_w=mu_ap_w, proj=proj, mu_grid=mu_grid,
        z_eff=z_eff, **esm,
        s=s, beta_ccf=beta_ccf,
        data_mult_fixed=data_mult_fixed, data_mult_pchip_c=data_mult_pchip_c,
        beta_cov=beta_cov, cov=cov, icov=icov,
        cov_logdet=cov_logdet, cov_pencil=cov_pencil,
    )

    spec = TableSpec(
        poles_r=poles_r, poles_s=poles_s,
        fixed_real_input=fixed_real_input, fixed_data=fixed_data,
        fixed_covmat=fixed_covmat,
        has_velocity_template=has_velocity_template,
        has_matter_template=matter_model == 'template',
        esm_use_eh=esm_use_eh, esm_grid_names=esm_grid_names,
        n_s=len(s) if s is not None else len(r),
        n_mu=n_mu, n_v=n_v,
    )
    return arrays, spec, theory_options_from_config(model), fit_opts


def _esm_arrays(matter: dict, base_dir: str, r: np.ndarray) -> dict:
    """The excursion-set fixtures of `victor_tpu/io/tables.py:426-490`: the
    200-point log k grid and its trapezoid weights, the 50-point
    density_evolution grid, and P(k) as Eisenstein-Hu (computed per call), a
    CAMB table (`pk_table_file`) or a grid of CAMB tables over named
    cosmology axes (`pk_grid_file`), each resampled onto the k grid by a
    cubic spline. Without either file a CAMB request falls back to
    Eisenstein-Hu with a warning, as the reference does
    (excursion_set_profile.py:63-70). Returns (arrays, the TableSpec fields
    esm_use_eh and esm_grid_names)."""
    from scipy.interpolate import InterpolatedUnivariateSpline as IUS

    esm_opts = matter.get('excursion_set_options') or {}
    esm_k = np.logspace(-4, np.log10(2), 200)
    out = dict(esm_k=esm_k, esm_kw=ops.trapz_weights(esm_k),
               esm_x50=np.linspace(0.1, r.max(), 50))
    use_eh = esm_opts.get('use_eisenstein_hu', False)
    pk_table = esm_opts.get('pk_table_file')
    pk_grid = esm_opts.get('pk_grid_file')
    if not use_eh and pk_grid:
        g = np.load(os.path.join(base_dir, pk_grid), allow_pickle=False)
        names = tuple(str(s) for s in np.atleast_1d(g['axis_names']))
        axes = [np.asarray(g[f'grid_{n}'], dtype=np.float64) for n in names]
        for n, ax in zip(names, axes):
            if ax.ndim != 1 or (len(ax) > 1 and not np.all(np.diff(ax) > 0)):
                raise InputError(f'pk_grid_file axis {n} must be a strictly '
                                 'increasing 1-D grid')
        shape = tuple(len(ax) for ax in axes)
        logpk = np.asarray(g['logpk0'], dtype=np.float64)
        if logpk.shape[:-1] != shape:
            raise InputError(f'pk_grid_file logpk0 shape {logpk.shape} does '
                             f'not match the axis grids {shape} + (nk,)')
        kg = np.asarray(g['k'], dtype=np.float64)
        for key in ('sigma8_0', 'sigma8_z'):
            if np.asarray(g[key]).shape != shape:
                raise InputError(f'pk_grid_file {key} shape must match the '
                                 f'axis grids {shape}')
        return dict(
            out, esm_grid_axes=tuple(axes),
            esm_pk_grid=np.stack([IUS(kg, row, k=3)(esm_k) for row in
                                  logpk.reshape(-1, logpk.shape[-1])]),
            esm_s80_grid=np.asarray(g['sigma8_0'], dtype=np.float64).reshape(-1),
            esm_s8z_grid=np.asarray(g['sigma8_z'], dtype=np.float64).reshape(-1)
        ), False, names
    if not use_eh and pk_table:
        tbl = np.load(os.path.join(base_dir, pk_table))
        return dict(out, esm_pk0=IUS(tbl['k'], tbl['pk0'], k=3)(esm_k),
                    esm_s80=float(tbl['sigma8_0']),
                    esm_s8z=float(tbl['sigma8_z'])), False, ()
    if not use_eh:
        logging.getLogger('victor_tpu_torch.io').warning(
            'excursion_set requested CAMB but no pk_table_file given; falling '
            'back to the Eisenstein-Hu approximation (mirrors reference '
            'fallback, excursion_set_profile.py:63-70)')
    return out, True, ()
