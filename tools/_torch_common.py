"""What the PyTorch validation tools (`tools/*_torch.py`) share: the repo
root, the configs of `configs/` with the `.npz` copies of the BOSS data
where h5py is absent, the device check of every port entry point, and the
card's name and power limit for the times they print.

Imports neither jax nor victor_tpu: the tools drive `victor_tpu_torch`.
"""

import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_DIR = os.path.join('data', 'BOSS_DR12_CMASS_npz')


def have_h5py() -> bool:
    return importlib.util.find_spec('h5py') is not None


def with_npz_data(cfg: dict) -> dict:
    """`cfg` with its model and data files replaced by their `.npz` copies
    in data/BOSS_DR12_CMASS_npz (tools/hdf5_to_npz.py writes them), in
    place; a path given as None stays None."""
    def npz(path):
        name = os.path.splitext(os.path.basename(path))[0] + '.npz'
        return os.path.join(NPZ_DIR, name)

    model, data = cfg['model'], cfg.get('data') or {}
    if model.get('input_model_data_file'):
        model['input_model_data_file'] = npz(model['input_model_data_file'])
    for block in ('redshift_space_ccf', 'covariance_matrix'):
        if data.get(block, {}).get('data_file'):
            data[block]['data_file'] = npz(data[block]['data_file'])
    return cfg


def load_config(path: str) -> dict:
    """The YAML config at `path` (a bare name: configs/`name`), its model
    and data blocks' `dir` the repo root unless they name one; where h5py is
    absent, the BOSS files are read from their `.npz` copies."""
    import yaml
    if os.path.dirname(path) == '':
        path = os.path.join(REPO, 'configs', path)
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg['model'].setdefault('dir', REPO)
    cfg['data'].setdefault('dir', REPO)
    return cfg if have_h5py() else with_npz_data(cfg)


def require_device(device: str, prog: str) -> None:
    """Exit 2, naming `--device cpu`, when `device` is a CUDA device and no
    card is present: a tool never falls back to the CPU on its own."""
    import torch
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        print(f'{prog}: no CUDA device; pass --device cpu to run on the host',
              file=sys.stderr, flush=True)
        sys.exit(2)


def card_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, or 'cpu'."""
    import torch
    if torch.device(device).type != 'cuda':
        return 'cpu'
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0) + ', power limit not read'
    return out.strip().splitlines()[0]
