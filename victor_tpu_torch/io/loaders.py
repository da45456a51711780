"""File loading utilities (HDF5 / npy / npz key-value stores).

Reproduces the reference's format handling (victor/ccf_model.py:53-68):
a model/data file is a flat mapping from string keys to arrays, stored either
as an .npy pickled dict or an HDF5 file. An .npz archive with the same keys
is read too, for machines without h5py (tools/hdf5_to_npz.py writes one).
"""

from __future__ import annotations

import os

import numpy as np

from ..errors import InputError

HDF5_EXTENSIONS = ('.hdf', '.h4', '.hdf4', '.he2', '.h5', '.hdf5', '.he5', '.h5py')
NPY_EXTENSIONS = ('.npy',)
NPZ_EXTENSIONS = ('.npz',)


def load_key_value_file(path: str) -> dict:
    """Load a model/data input file into a {key: ndarray} dict."""
    if not os.path.isfile(path):
        raise InputError(f'File {path} containing input data not found')
    if any(path.endswith(ext) for ext in NPY_EXTENSIONS):
        return np.load(path, allow_pickle=True).item()
    if any(path.endswith(ext) for ext in NPZ_EXTENSIONS):
        with np.load(path, allow_pickle=False) as z:
            return {key: z[key] for key in z.files}
    if any(path.endswith(ext) for ext in HDF5_EXTENSIONS):
        import h5py
        out = {}
        with h5py.File(path, 'r') as f:
            for key in list(f.keys()):
                out[key] = f[key][:]
        return out
    # fall through like the reference: try hdf5 reader last
    import h5py
    out = {}
    with h5py.File(path, 'r') as f:
        for key in list(f.keys()):
            out[key] = f[key][:]
    return out


def select_simulation(arr: np.ndarray, isim) -> np.ndarray:
    """Optional `simulation_number` selection from stacked mock arrays
    (victor/ccf_model.py:129,139-141)."""
    if isim is None:
        return arr
    if isinstance(isim, (int, np.integer)):
        return arr[int(isim)]
    raise InputError('If provided, simulation_number must be an integer')
