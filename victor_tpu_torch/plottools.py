"""2D CCF plotting helpers (reference surface: victor/plottools.py:11,63), a
copy of `victor_tpu/plottools.py`.

Host-side matplotlib, imported inside the functions only, written against
the modern API. Unlike the reference (which draws each quadrant with its own
pcolormesh/contour call), the full plane is assembled ONCE from the symmetry
of the correlation function and drawn with a single mesh + a single contour
set — no seams at the axes, and `clabel` labels every quadrant.
"""

from __future__ import annotations

import numpy as np

ryb_colors = np.array(['#3130ff', '#3366ff', '#9DAFFF', '#A6BDD7', '#F4C800',
                       '#FFB300', '#FF8E00', '#F13A13', '#C10020'])
ryg_colors = np.array(['#007D34', '#93AA00', '#F4C800', '#FFB300', '#FF8E00',
                       '#F13A13', '#C10020', '#7F180D'])


def shifted_color_map(cmap, start=0.0, midpoint=0.5, stop=1.0,
                      name='shiftedcmap'):
    """Colormap with its centre moved to `midpoint` — for data with an
    asymmetric negative/positive range where zero should sit at the colour
    midpoint (reference surface: victor/plottools.py:11-61). Typically
    midpoint = 1 - vmax/(vmax + |vmin|).

    Implementation: resample the source map through a piecewise-linear warp
    that sends output position `midpoint` to the source centre 0.5.
    """
    import matplotlib as mpl

    s = np.linspace(0.0, 1.0, 257)
    lower = s < midpoint
    warped = np.where(
        lower,
        start + np.divide(s, midpoint, out=np.zeros_like(s),
                          where=midpoint > 0) * (0.5 - start),
        0.5 + np.divide(s - midpoint, 1.0 - midpoint,
                        out=np.ones_like(s), where=midpoint < 1) * (stop - 0.5))
    new_cmap = mpl.colors.LinearSegmentedColormap.from_list(
        name, list(zip(s, cmap(warped))))
    try:
        mpl.colormaps.register(new_cmap, name=name, force=True)
    except Exception:
        pass
    return new_cmap


def _mirror_plane(grid, rs, rp, even):
    """Full-plane (x, y, G) from the one-quadrant grid via the CCF symmetries:
    always even in r_perp; even in r_par too unless `even=False`."""
    x = np.concatenate([-rs[::-1], rs])
    G = np.concatenate([grid[:, ::-1], grid], axis=1)
    if even:
        y = np.concatenate([-rp[::-1], rp])
        G = np.concatenate([G[::-1], G], axis=0)
    else:
        y = rp
    return x, y, G


def plot_2D_ccf(xi_sp, rs, rp=None, even=True, cmap=None, vmin=-1, vmax=0.2,
                contours=None, contour_colors='white', clabel=False,
                linewidths=1.2, shift=True, colorbar=True, axis_label='r',
                xlabel=None, ylabel=None, cbar_label=None, ax=None):
    """Filled 2D map of a ccf callable `xi_sp(r_perp, r_par)` over the full
    plane (reference surface: victor/plottools.py:63-109).

    `even=True` mirrors into the lower half-plane (valid for correlation
    functions even in mu). Returns the matplotlib Axes.
    """
    import matplotlib as mpl
    import matplotlib.pyplot as plt

    if cmap is None:
        cmap = mpl.cm.RdYlBu_r
    if shift:
        cmap = shifted_color_map(cmap, midpoint=1 - vmax / (vmax + abs(vmin)))
    if rp is None:
        rp, even = rs, True
    rs, rp = np.asarray(rs), np.asarray(rp)
    x, y, G = _mirror_plane(np.asarray(xi_sp(rs, rp)), rs, rp, even)

    if ax is None:
        _, ax = plt.subplots(figsize=(7.5, 6) if colorbar else (6.2, 6))
    im = ax.pcolormesh(x, y, G, vmin=vmin, vmax=vmax, cmap=cmap,
                       shading='gouraud')
    if colorbar:
        cb = ax.figure.colorbar(im, ax=ax)
        if cbar_label:
            cb.set_label(cbar_label, fontsize=18)
    if contours:
        cs = ax.contour(x, y, G, contours, colors=contour_colors,
                        linestyles='solid', linewidths=linewidths)
        if clabel:
            ax.clabel(cs, inline=True, fontsize=10, fmt='%1.2f')

    # axis_label only fills in labels the caller did NOT supply — explicit
    # xlabel/ylabel always win (the reference quirk of axis_label overriding
    # them is not reproduced)
    if axis_label is not None:
        if xlabel is None:
            xlabel = r'$%s_\perp\;[h^{-1}\mathrm{Mpc}]$' % axis_label
        if ylabel is None:
            ylabel = r'$%s_{||}\;[h^{-1}\mathrm{Mpc}]$' % axis_label
    if xlabel is not None:
        ax.set_xlabel(xlabel, fontsize=18)
    if ylabel is not None:
        ax.set_ylabel(ylabel, fontsize=18)
    ax.tick_params(labelsize=16)
    ax.set_xlim(x[0], x[-1])
    ax.set_ylim(-y[-1] if not even else y[0], y[-1])
    ax.set_yticks(ax.get_xticks()[np.abs(ax.get_xticks()) <= y[-1]])
    return ax


def corner_plot(samples, names, out_path=None, weights=None, params=None,
                bins=40, max_default=6):
    """Corner plot of posterior samples: 1D marginals on the diagonal, 2D
    68/95% sample-mass contours below.

    Beyond the reference surface (its notebooks hand chains to GetDist):
    this is the in-package quick look used by `analyze` and
    tools/plot_chains.py; GetDist remains the recommendation for
    publication plots (the samplers' chain files are exactly its format).

    `samples` is (n, d) in the order of `names`; `weights` defaults to
    equal; `params` selects/orders a subset (default: first `max_default`
    for readability). Saves to `out_path` when given and returns the
    Figure otherwise.
    """
    import matplotlib
    if out_path is not None:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    samples = np.asarray(samples)
    w = np.ones(len(samples)) if weights is None else np.asarray(weights)
    idx = ([names.index(p) for p in params] if params
           else list(range(min(len(names), max_default))))
    labels = [names[i] for i in idx]
    d = len(idx)

    fig, axes = plt.subplots(d, d, figsize=(2.2 * d, 2.2 * d))
    axes = np.atleast_2d(axes)
    for r in range(d):
        for c in range(d):
            ax = axes[r, c]
            if c > r:
                ax.set_visible(False)
                continue
            x = samples[:, idx[c]]
            if r == c:
                ax.hist(x, bins=bins, weights=w, histtype='step',
                        density=True)
                ax.set_yticks([])
            else:
                y = samples[:, idx[r]]
                H, xe, ye = np.histogram2d(x, y, bins=bins, weights=w)
                Hs = H.T
                # contour levels enclosing 68/95% of the sample mass
                flat = np.sort(Hs.ravel())[::-1]
                cum = np.cumsum(flat) / flat.sum()
                levels = sorted({flat[np.searchsorted(cum, q)]
                                 for q in (0.95, 0.68)})
                xc = 0.5 * (xe[:-1] + xe[1:])
                yc = 0.5 * (ye[:-1] + ye[1:])
                ax.contour(xc, yc, Hs, levels=levels)
            if r == d - 1:
                ax.set_xlabel(labels[c])
            else:
                ax.set_xticklabels([])
            if c == 0 and r > 0:
                ax.set_ylabel(labels[r])
            elif c > 0:
                ax.set_yticklabels([])
    fig.tight_layout()
    if out_path is not None:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path
    return fig
