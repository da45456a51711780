"""Spline primitives: host builders (numpy) and device evaluation.

The port of `victor_tpu/ops/splines.py:47-454`. As there, each spline is split
into a host-side step, done once at table-build time, that probes scipy with
unit basis vectors to extract a linear operator, and a device-side step that
finds the interval and evaluates the local cubic. The host half is a copy of
the JAX package's numpy code; the device half works on tensors with a leading
batch axis.

Piecewise-cubic evaluation (`ppoly_eval`, and `ppoly_eval_multi` for up to
four tables over one query set) and the dispersion model's final stage
(`dispersion_final`) run their hand-written CUDA kernels for CUDA tensors
and their plain PyTorch versions for CPU tensors (`kernels/ppoly.py`,
`kernels/dispersion.py`). Nothing moves a CUDA tensor to the CPU.

The Chebyshev evaluation of the fast streaming mode and of the dispersion
solve (`chebyshev_eval`, and `chebyshev_eval_multi` for two series over one
query set) runs a hand-written CUDA kernel for CUDA tensors
(`kernels/chebyshev.py`), with its gradient composed of the same kernel and
a reduction kernel of the same source: XLA fused the JAX package's
recurrence (`victor_tpu/ops/splines.py:494-502`; there is no Pallas
kernel), which PyTorch would run as ~159 launches per series. The kernel is
bound by f64 operations at the fast streaming mode's (64, 50 x 3000), and
rounds each of them on its own, so it equals the plain recurrence bit for
bit. The fit (`chebyshev_fit`) and the dynamic-knot splines of the
excursion-set model (`cubic_coeffs_dynamic`, `ppoly_eval_dynamic`) are
plain PyTorch, as XLA fused them in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels import chebyshev as _chebyshev
from ..kernels import dispersion as _dispersion
from ..kernels.ppoly import PpolyEval, ppoly_eval_cuda, ppoly_eval_plain
from .special import clip, ipow


# ---------------------------------------------------------------------------
# Host-side preparation (numpy / scipy)
# ---------------------------------------------------------------------------

def cubic_deriv_operator(x: np.ndarray) -> np.ndarray:
    """Linear operator D (n, n) mapping values y to not-a-knot nodal
    derivatives, so that the interpolating cubic spline is recovered in
    Hermite form per interval. Matches
    scipy.interpolate.InterpolatedUnivariateSpline(x, y, k=3) exactly."""
    from scipy.interpolate import CubicSpline
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    D = np.zeros((n, n))
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        D[:, j] = CubicSpline(x, e, bc_type='not-a-knot')(x, 1)
    return D


def hermite_coeffs(x, y, d):
    """Per-interval ascending-power cubic coefficients from values and
    derivatives. Works on numpy arrays or torch tensors; y/d (and x, for
    per-row knots) may have leading batch axes over the trailing knot axis.
    Returns (..., n-1, 4)."""
    stack = torch.stack if isinstance(y, torch.Tensor) else np.stack
    h = x[..., 1:] - x[..., :-1]
    dy = (y[..., 1:] - y[..., :-1]) / h
    c0 = y[..., :-1]
    c1 = d[..., :-1]
    c2 = (3.0 * dy - 2.0 * d[..., :-1] - d[..., 1:]) / h
    c3 = (d[..., :-1] + d[..., 1:] - 2.0 * dy) / (h * h)
    return stack([c0, c1, c2, c3], -1)


def spline_eval_matrix(x: np.ndarray, q: np.ndarray, ext: int = 0) -> np.ndarray:
    """Dense matrix E (len(q), len(x)) with E @ y == IUS(x, y, k=3, ext=ext)(q)."""
    from scipy.interpolate import InterpolatedUnivariateSpline
    x = np.asarray(x, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    n = len(x)
    E = np.zeros((len(q), n))
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        E[:, j] = InterpolatedUnivariateSpline(x, e, k=3, ext=ext)(q)
    return E


def gradient_matrix(x: np.ndarray) -> np.ndarray:
    """Dense matrix G with G @ y == np.gradient(y, x) (numpy's default
    edge_order=1, reproduced by probing rather than re-derived)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    G = np.zeros((n, n))
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        G[:, j] = np.gradient(e, x)
    return G


def pchip_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """PCHIP coefficients of a static table y (n, ...): (n-1, 4, ...) in
    ascending powers, matching scipy.interpolate.PchipInterpolator(x, y,
    axis=0) exactly."""
    from scipy.interpolate import PchipInterpolator
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    p = PchipInterpolator(x, y, axis=0)
    c = np.moveaxis(p.c[::-1], [0, 1], [1, 0])
    return np.ascontiguousarray(c)


def bicubic_cell_coeffs(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Per-cell bicubic polynomial coefficients of RectBivariateSpline(x, y, z)
    (victor_tpu/ops/splines.py:138-166), host numpy.

    Returns A of shape (nx-1, ny-1, 4, 4) in *normalized* cell coordinates:
        f(q, p) = sum_{a,b} A[i, j, a, b] * u**a * v**b,
        u = (q - x[i]) / (x[i+1] - x[i]),  v = (p - y[j]) / (y[j+1] - y[j]),
    by exactly fitting the (bicubic) restriction of the spline on a 4x4
    sample grid per cell; agrees with `RectBivariateSpline.ev` to ~1e-13.
    `Bicubic2D` stores the same surface in tensor-product form instead.
    """
    from scipy.interpolate import RectBivariateSpline
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    rbs = RectBivariateSpline(x, y, z, kx=3, ky=3, s=0)
    nx, ny = len(x) - 1, len(y) - 1
    offs = np.array([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0])
    V = offs[:, None] ** np.arange(4)[None, :]
    Vinv = np.linalg.inv(V)
    dx = np.diff(x)
    dy = np.diff(y)
    xs = (x[:-1, None] + offs[None, :] * dx[:, None]).ravel()
    ys = (y[:-1, None] + offs[None, :] * dy[:, None]).ravel()
    XX, YY = np.meshgrid(xs, ys, indexing='ij')
    F = rbs.ev(XX.ravel(), YY.ravel()).reshape(nx, 4, ny, 4)
    A = np.einsum('pu,iujv,qv->ijpq', Vinv, F, Vinv)
    return np.ascontiguousarray(A)


def _tensor(a, device, dtype):
    """A numpy array or tensor as a tensor on `device` of `dtype`."""
    if isinstance(a, torch.Tensor):
        return a.to(device, dtype)
    return torch.tensor(np.asarray(a, dtype=np.float64)).to(device, dtype)


# ---------------------------------------------------------------------------
# Device-side containers and evaluation
# ---------------------------------------------------------------------------

def ppoly_eval(x: torch.Tensor, coeffs: torch.Tensor, q: torch.Tensor,
               clamp: bool = True) -> torch.Tensor:
    """Evaluate a piecewise cubic at query points q.

    x:      (n,) sorted knots
    coeffs: (n-1, 4) shared by all queries, or (B, n-1, 4) with one table per
            leading row of q
    q:      any shape; with batched coeffs its leading axis is B
    clamp:  clamp q into [x[0], x[-1]] (scipy ext=3); otherwise the end
            polynomials extend (ext=0). NaN queries give NaN either way.

    CUDA tensors go to the CUDA kernel, which raises on what it cannot take;
    CPU tensors go to the plain version. While a gradient is recorded, both
    go through `PpolyEval`, whose backward is the backward kernel or its
    plain version (`_lookup`).
    """
    rows = coeffs.shape[0] if coeffs.ndim == 3 else 1
    c = coeffs.reshape(rows, *coeffs.shape[-2:]).contiguous()
    q2 = q.reshape(rows, -1).contiguous()
    return _lookup(x, c, q2, clamp).reshape(q.shape)


def _lookup(x, c, q2, clamp):
    """The kernel or the plain version by device, through the autograd
    Function only when a gradient to q or the coefficients is recorded: the
    samplers' forward-only steps keep the direct call."""
    if torch.is_grad_enabled() and (q2.requires_grad or c.requires_grad or
                                    x.requires_grad):
        return PpolyEval.apply(x, c, q2, clamp)
    if q2.is_cuda:
        return ppoly_eval_cuda(x, c, q2, clamp)
    return ppoly_eval_plain(x, c, q2, clamp)


def ppoly_eval_multi(x: torch.Tensor, coeffs: torch.Tensor, q: torch.Tensor,
                     clamp: bool = True) -> torch.Tensor:
    """Evaluate K piecewise cubics that share the knots x at one set of
    query points: one interval search per query serves every channel.

    coeffs: (K, n-1, 4) shared by all rows, or (B, K, n-1, 4) per row
    q:      (B, ...) with the batch axis leading
    Returns (B, K, ...). Channel k equals `ppoly_eval(x, coeffs[..., k, :,
    :], q)` bit for bit. CUDA tensors go to the CUDA kernel with K channels,
    CPU tensors to the plain version.
    """
    c = (coeffs if coeffs.ndim == 4 else coeffs[None]).contiguous()
    q2 = q.reshape(q.shape[0], -1).contiguous()
    return _lookup(x, c, q2, clamp).reshape(q.shape[:1] + c.shape[1:2] +
                                            q.shape[1:])


def dispersion_final(x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel):
    """The dispersion model's final stage in one pass: the exact final Picard
    update and the Jacobian's v_r and dv_r lookups (shapes in
    `kernels/dispersion.py`). Returns (r_par, rr, mu_r, jacobian), each
    (B, n_v, q).

    CUDA tensors go to the CUDA kernel, which raises on what it cannot take;
    CPU tensors go to the plain version.
    """
    args = tuple(t.contiguous() for t in (x, c_vr, c_dvr, r_par, A, s_perp,
                                          iaH, resc_vel))
    if r_par.is_cuda:
        return _dispersion.dispersion_final_cuda(*args)
    _dispersion.check_args(*args)
    return _dispersion.dispersion_final_plain(*args)


@functools.lru_cache(maxsize=None)
def _cheb_probe_inverse(degree: int) -> tuple:
    """(INV, nodes): the inverse of the Chebyshev collocation matrix at the
    degree+1 Chebyshev points (coef = INV @ f(nodes)) and the node cosines,
    as float64 numpy arrays."""
    k = np.arange(degree + 1)
    nodes = np.cos((2 * k + 1) * np.pi / (2 * (degree + 1)))
    T = np.cos(np.outer(np.arccos(nodes), np.arange(degree + 1)))
    return np.linalg.inv(T), nodes


def chebyshev_fit(fn, a, b, degree: int = 32):
    """Fit fn on [a[i], b[i]] per batch row by a degree-`degree` Chebyshev
    interpolant (victor_tpu/ops/splines.py:475-491).

    a, b: (B,) domains. fn maps (B, degree+1) nodes to values of the same
    shape. Returns the (B, degree+1) coefficients. Use only where a
    downstream contraction bounds the fit error (models/ccf_theory.py).
    """
    inv, nodes = _cheb_probe_inverse(degree)
    mid = 0.5 * (a + b)
    half = 0.5 * (b - a)
    rn = mid[:, None] + half[:, None] * _tensor(nodes, a.device, a.dtype)
    f = fn(rn)
    return torch.einsum('ij,bj->bi', _tensor(inv, a.device, a.dtype), f)


def chebyshev_eval_multi(series, q):
    """Clenshaw evaluation of up to two per-row Chebyshev series over one
    query set: series ((coef (B, K), a (B,), b (B,)), ...), one K, and q
    (B, ...) -> a tuple of q-shaped tensors, one per series. Series s
    equals `chebyshev_eval(*series[s], q)` bit for bit.

    CUDA tensors go to the CUDA kernel, one launch for all the series (S <=
    2, K <= 128; it raises on what it cannot take): directly where no
    gradient is recorded, through `kernels.chebyshev.ChebyshevEval` (its
    gradient on the card's kernels) where one is. CPU tensors go to the
    plain recurrence, whose autograd is its operations' own (`clip`'s JAX
    derivative)."""
    if not q.is_cuda:
        return tuple(_chebyshev.chebyshev_eval_plain(c, a, b, q)
                     for c, a, b in series)
    flat = [t for s in series for t in s]
    q2 = q.reshape(q.shape[0], -1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat + [q]):
        outs = _chebyshev.ChebyshevEval.apply(q2, *flat)
    else:
        outs = _chebyshev.chebyshev_eval_cuda(
            [tuple(t.contiguous() for t in s) for s in series],
            q2.contiguous())
    return tuple(o.view(q.shape) for o in outs)


def chebyshev_eval(coef, a, b, q):
    """Clenshaw evaluation of per-row Chebyshev series on [a, b]: coef
    (B, K), a and b (B,), q (B, ...) -> q's shape. q is clamped into the
    domain by `clip` (NaN stays NaN; JAX's derivative). The recurrence is
    the JAX package's, step for step: `chebyshev_eval_multi`'s one-series
    case, on the kernel or the plain recurrence by the same rule."""
    return chebyshev_eval_multi(((coef, a, b),), q)[0]


def pchip_eval(x, coeffs, q):
    """Evaluate PCHIP coefficients (n-1, 4, ...) at q of shape (B,) or ()
    with polynomial end-extrapolation (scipy PchipInterpolator semantics).
    Returns q.shape + the table's trailing shape."""
    n = x.shape[0]
    # a column of a parameter matrix (beta under autograd) is strided
    idx = torch.clamp(torch.searchsorted(x, q.contiguous(), right=True) - 1,
                      0, n - 2)
    t = q - x[idx]
    c = coeffs[idx]                               # q.shape + (4, ...)
    t = t.reshape(t.shape + (1,) * (c.ndim - q.ndim - 1))
    c0, c1, c2, c3 = c.unbind(q.ndim)
    return ((c3 * t + c2) * t + c1) * t + c0


def _build_device(device) -> torch.device:
    """The device check of the public `build` methods,
    io/tables.py::_target_device: a CUDA device must exist; no quiet
    fallback to the CPU."""
    from ..io.tables import _target_device
    return _target_device(device)


@dataclasses.dataclass(frozen=True)
class Spline1D:
    """A cubic spline with fixed knots whose values may change at run time.

    `deriv_op` maps values to nodal derivatives (`cubic_deriv_operator`);
    coefficients are recovered in Hermite form. `clamp` reproduces scipy
    ext=3; clamp=False gives ext=0.
    """
    x: torch.Tensor                    # (n,)
    deriv_op: torch.Tensor             # (n, n)
    clamp: bool = True

    @classmethod
    def build(cls, x, clamp: bool = True, device='cuda',
              dtype=torch.float64) -> 'Spline1D':
        """The spline on `device`: the card unless 'cpu' is asked for."""
        return cls.build_host(x, clamp).to(_build_device(device), dtype)

    @classmethod
    def build_host(cls, x, clamp: bool = True) -> 'Spline1D':
        """The spline with float64 numpy leaves (`.to` makes tensors)."""
        x = np.asarray(x, dtype=np.float64)
        return cls(x=x, deriv_op=cubic_deriv_operator(x), clamp=clamp)

    def to(self, device, dtype) -> 'Spline1D':
        return Spline1D(_tensor(self.x, device, dtype),
                        _tensor(self.deriv_op, device, dtype), self.clamp)

    def coeffs(self, y: torch.Tensor) -> torch.Tensor:
        """(..., n) values -> (..., n-1, 4) local polynomial coefficients."""
        d = torch.einsum('ij,...j->...i', self.deriv_op, y)
        return hermite_coeffs(self.x, y, d)

    def eval(self, coeffs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return ppoly_eval(self.x, coeffs, q, clamp=self.clamp)

    def eval_multi(self, coeffs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """K channels (B, K, n-1, 4) at q (B, ...) -> (B, K, ...)."""
        return ppoly_eval_multi(self.x, coeffs, q, clamp=self.clamp)

    def __call__(self, y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return self.eval(self.coeffs(y), q)


@dataclasses.dataclass(frozen=True)
class PchipTable:
    """A static PCHIP-interpolated table f(beta) -> (...) built on the host."""
    x: torch.Tensor          # (n,)
    coeffs: torch.Tensor     # (n-1, 4, ...) ascending powers

    @classmethod
    def build(cls, x, y, device='cuda', dtype=torch.float64) -> 'PchipTable':
        """The table on `device`: the card unless 'cpu' is asked for."""
        device = _build_device(device)
        return cls(x=_tensor(x, device, dtype),
                   coeffs=_tensor(pchip_coeffs(x, y), device, dtype))

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        return pchip_eval(self.x, self.coeffs, q)


@dataclasses.dataclass(frozen=True)
class Bicubic2D:
    """Static bicubic surface with FITPACK `.ev` semantics (clamped
    arguments), stored in exact SVD tensor-product form: the surface is
    sum_m S_x[u_m](q) * S_y[v_m](p) with S_x/S_y 1D not-a-knot cubics. A
    y-independent surface (`y_const`, e.g. the BOSS isotropic dispersion
    template) folds its constant y-factors into `cu`."""
    x: torch.Tensor          # (nx,)
    y: torch.Tensor          # (ny,)
    cu: torch.Tensor         # (R, nx-1, 4)
    cv: torch.Tensor         # (R, ny-1, 4)
    y_const: bool = False

    @classmethod
    def build(cls, x, y, z, device='cuda', dtype=torch.float64) -> 'Bicubic2D':
        """The surface on `device`: the card unless 'cpu' is asked for."""
        return cls.build_host(x, y, z).to(_build_device(device), dtype)

    @classmethod
    def build_host(cls, x, y, z) -> 'Bicubic2D':
        """The surface with float64 numpy leaves (`.to` makes tensors)."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        U, s, Vt = np.linalg.svd(z, full_matrices=False)
        rank = max(1, int(np.sum(s > s[0] * 1e-13))) if s[0] > 0 else 1
        Dx = cubic_deriv_operator(x)
        Dy = cubic_deriv_operator(y)
        cu = np.stack([hermite_coeffs(x, U[:, m] * s[m], Dx @ (U[:, m] * s[m]))
                       for m in range(rank)])
        cv = np.stack([hermite_coeffs(y, Vt[m], Dy @ Vt[m])
                       for m in range(rank)])
        scale = np.max(np.abs(Vt[:rank])) or 1.0
        y_const = bool(np.all(np.ptp(Vt[:rank], axis=1) < 1e-13 * scale))
        if y_const:
            cu = cu * Vt[:rank, 0][:, None, None]
        return cls(x=x, y=y, cu=cu, cv=cv, y_const=y_const)

    def to(self, device, dtype) -> 'Bicubic2D':
        return Bicubic2D(*(_tensor(t, device, dtype)
                           for t in (self.x, self.y, self.cu, self.cv)),
                         y_const=self.y_const)

    def ev(self, q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        qc = clip(q, self.x[0], self.x[-1])
        rank = self.cu.shape[0]
        if self.y_const:
            out = ppoly_eval(self.x, self.cu[0], qc, clamp=False)
            for m in range(1, rank):
                out = out + ppoly_eval(self.x, self.cu[m], qc, clamp=False)
            return out
        pc = clip(p, self.y[0], self.y[-1])
        out = None
        for m in range(rank):
            term = ppoly_eval(self.x, self.cu[m], qc, clamp=False) * \
                ppoly_eval(self.y, self.cv[m], pc, clamp=False)
            out = term if out is None else out + term
        return out


# ---------------------------------------------------------------------------
# Dynamic-knot primitives (knots that change per call, e.g. ESM Eulerian radii)
# ---------------------------------------------------------------------------

def cubic_coeffs_dynamic(x, y):
    """Not-a-knot cubic spline coefficients for knots given at run time
    (victor_tpu/ops/splines.py:379-416).

    x (..., n) knots, per row or shared; y (..., n) values. Solves the
    not-a-knot first-derivative system (scipy's _cubic.py formulation) with
    `torch.linalg.solve`, one (n, n) system per row of x, and returns
    Hermite-form coefficients (..., n-1, 4). Matches
    scipy.interpolate.CubicSpline(x, y, bc_type='not-a-knot') == IUS(k=3),
    which the reference builds on the parameter-dependent Eulerian radius
    grid every call (victor/excursion_set_profile.py:371,486). Plain
    PyTorch: the systems are 50-200 knots, and the JAX package has no kernel
    for them either.
    """
    n = x.shape[-1]
    dx = x[..., 1:] - x[..., :-1]
    slope = (y[..., 1:] - y[..., :-1]) / dx
    A = x.new_zeros(x.shape[:-1] + (n, n))
    b = y.new_zeros(y.shape)
    # interior rows
    i = torch.arange(1, n - 1, device=x.device)
    A[..., i, i - 1] = dx[..., 1:]
    A[..., i, i] = 2.0 * (dx[..., 1:] + dx[..., :-1])
    A[..., i, i + 1] = dx[..., :-1]
    b[..., 1:-1] = 3.0 * (dx[..., 1:] * slope[..., :-1]
                          + dx[..., :-1] * slope[..., 1:])
    # not-a-knot boundaries
    d0 = x[..., 2] - x[..., 0]
    dN = x[..., n - 1] - x[..., n - 3]
    A[..., 0, 0] = dx[..., 1]
    A[..., 0, 1] = d0
    b[..., 0] = ((dx[..., 0] + 2.0 * d0) * dx[..., 1] * slope[..., 0]
                 + ipow(dx[..., 0], 2) * slope[..., 1]) / d0
    A[..., n - 1, n - 1] = dx[..., n - 3]
    A[..., n - 1, n - 2] = dN
    b[..., n - 1] = (ipow(dx[..., n - 2], 2) * slope[..., n - 3]
                     + (2.0 * dN + dx[..., n - 2]) * dx[..., n - 3]
                     * slope[..., n - 2]) / dN
    d = torch.linalg.solve(A, b[..., None])[..., 0]
    return hermite_coeffs(x, y, d)


def ppoly_eval_dynamic(x, coeffs, q, clamp: bool = True):
    """Piecewise-cubic evaluation with per-row knots: x (B, n), coeffs
    (B, n-1, 4), q (B, m) -> (B, m). The interval semantics of `ppoly_eval`
    (interval 0 reaches -inf, interval n-2 +inf) through a per-row
    searchsorted and gathers, and its `+ (qq - qq)` NaN term; the JAX
    package's masksum selects the same polynomial."""
    n = x.shape[-1]
    qq = clip(q, x[..., :1], x[..., -1:]) if clamp else q
    idx = torch.clamp(torch.searchsorted(x.contiguous(), qq.contiguous(),
                                         right=True) - 1, 0, n - 2)
    t = qq - torch.gather(x, -1, idx)
    c0, c1, c2, c3 = (torch.gather(coeffs[..., k], -1, idx) for k in range(4))
    return ((c3 * t + c2) * t + c1) * t + c0 + (qq - qq)


def gradient_nonuniform(y, x):
    """np.gradient(y, x) for tensors: 2nd-order interior, 1st-order one-sided
    edges (numpy's default edge_order=1). x (n,) or per row like y (..., n).
    For the reference's np.gradient calls on parameter-dependent profiles
    (victor/ccf_model.py:379,472; excursion_set_profile.py:411)."""
    hd = x[..., 1:-1] - x[..., :-2]
    hs = x[..., 2:] - x[..., 1:-1]
    interior = (ipow(hd, 2) * y[..., 2:] + (ipow(hs, 2) - ipow(hd, 2))
                * y[..., 1:-1] - ipow(hs, 2) * y[..., :-2]) / \
        (hs * hd * (hd + hs))
    left = (y[..., 1] - y[..., 0]) / (x[..., 1] - x[..., 0])
    right = (y[..., -1] - y[..., -2]) / (x[..., -1] - x[..., -2])
    return torch.cat([left[..., None], interior, right[..., None]], dim=-1)
