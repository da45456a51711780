"""Each fault that a cell's timed path can have, planted underneath a whole
run of the harness on the CPU at a small size, makes `correct` false; the
same run unbroken is correct. The harness's look for a card is what these
runs skip: they call `run.run_cell` on the CPU."""

import pytest
import torch

import run
from benchlib import manifest
from conftest import tiny_cell

SEED = 2 ** 31 + 77


def _cells(sampler=None, chips=None):
    out = []
    for w in manifest.load_manifest()['workloads']:
        cell = manifest.find_cell(w['name'])
        if (sampler is None or cell.traffic['sampler'] == sampler) and \
                (chips is None or cell.chips == chips):
            out.append(w['name'])
    return out


def _run(name):
    return run.run_cell(tiny_cell(name), SEED, 0.2, trace=False,
                        device='cpu')


@pytest.mark.parametrize('name', _cells())
def test_an_unbroken_run_is_correct(name):
    res = _run(name)
    assert res['correct'], res['checks']
    assert res['failed'] == 0 and res['attempted'] > 0


@pytest.mark.parametrize('name', _cells('smc'))
def test_a_stage_that_returns_its_state_unchanged(name, monkeypatch):
    from victor_tpu_torch.sampling import smc

    def unchanged(lnlike, lnprior, y, lnl, lnpri, aux, w, beta_new, noise):
        return y, lnl, lnpri, aux, torch.zeros((), dtype=y.dtype)
    monkeypatch.setattr(smc, '_stage', unchanged)
    res = _run(name)
    assert not res['correct']
    assert res['checks']['moved_apart']['value'] > \
        res['checks']['moved_apart']['limit']


@pytest.mark.parametrize('name', _cells('hmc'))
def test_a_step_that_returns_its_state_unchanged(name, monkeypatch):
    from victor_tpu_torch.sampling import hmc
    monkeypatch.setattr(hmc, '_hmc_step', lambda vg, state, *a, **k: state)
    res = _run(name)
    assert not res['correct']
    assert res['checks']['moved_apart']['value'] > \
        res['checks']['moved_apart']['limit']


def _broken_likelihood(monkeypatch, fault):
    from victor_tpu_torch.likelihood import core
    original = core.log_likelihood

    def broken(tables, spec, opts, fit, params):
        return fault(original, tables, spec, opts, fit, params)
    monkeypatch.setattr(core, 'log_likelihood', broken)


def _half_left_out(original, tables, spec, opts, fit, params):
    """Half of the batch left out: the second half's values are the mean
    over the first half's."""
    n = next(iter(params.values())).shape[0]
    h = max(n // 2, 1)
    lnl, chi2 = original(tables, spec, opts, fit,
                         {k: v[:h] for k, v in params.items()})
    return (torch.cat([lnl, lnl.mean().expand(n - h)]),
            torch.cat([chi2, chi2.mean().expand(n - h)]))


def _altered(original, tables, spec, opts, fit, params):
    """One answer altered where it is produced: the first row's lnL."""
    lnl, chi2 = original(tables, spec, opts, fit, params)
    return torch.cat([lnl[:1] + 1e-3, lnl[1:]]), chi2


@pytest.mark.parametrize('fault', [_half_left_out, _altered],
                         ids=['half_batch_left_out', 'answer_altered'])
@pytest.mark.parametrize('name', _cells())
def test_a_broken_likelihood(name, fault, monkeypatch):
    _broken_likelihood(monkeypatch, fault)
    res = _run(name)
    assert not res['correct'], res['checks']


@pytest.mark.parametrize('name', _cells(chips=4))
def test_the_exchange_between_cards_left_out(name, monkeypatch):
    """Every card's slice of the result replaced by the first card's: the
    others' results are never gathered."""
    from victor_tpu_torch.parallel import mesh as mesh_mod
    original = mesh_mod.shard_map

    def no_exchange(fn, tables, mesh, axes=None, chunk=None):
        call = original(fn, tables, mesh, axes, chunk)
        if mesh is None:
            return call

        def first_only(x):
            out = call(x)
            k = x.shape[0] // len(mesh_mod.shard_devices(mesh, axes))
            return tuple(o[:k].repeat((x.shape[0] // k,) + (1,) *
                                      (o.ndim - 1)) for o in out)
        return first_only
    monkeypatch.setattr(mesh_mod, 'shard_map', no_exchange)
    res = _run(name)
    assert not res['correct'], res['checks']


def test_a_diverged_chain_hides_no_other():
    """One chain non-finite on both sides and a wrong gradient in another:
    the wrong one is still seen; a chain finite on one side only is inf."""
    from benchlib.drivers import _grad_gap
    g_ref = torch.randn(8, 4, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(1))
    g = g_ref.clone()
    g[2] = g_ref[2] = torch.nan
    assert _grad_gap(g, g_ref) == 0.0
    g[5, 1] += 1e-3 * g_ref[5].abs().max()
    assert _grad_gap(g, g_ref) >= 1e-3 * 0.99
    g[6, 0] = torch.inf
    assert _grad_gap(g, g_ref) == float('inf')
