"""The benchmark's tests: `python -m pytest benchmark/tests` from the
repository's root. Tests marked `cuda` need a card and skip without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips the test without a CUDA device; decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


def tiny(name, **traffic):
    """The cell `name` with its traffic cut to a size the CPU runs in
    seconds; widths and modes as the configuration states them."""
    from benchlib.manifest import find_cell
    cell = find_cell(name)
    cell.traffic.update(traffic)
    return cell


SIZES = {'smc': dict(n_particles=16, n_moves=1, chunk=8),
         'hmc': dict(n_chains=4, n_leapfrog=2)}


def tiny_cell(name):
    from benchlib.manifest import find_cell
    return tiny(name, **SIZES[find_cell(name).traffic['sampler']])
