#!/usr/bin/env python
"""Copy HDF5 key-value input files to .npz files with the same keys.

    python tools/hdf5_to_npz.py OUT_DIR FILE.hdf5 [FILE.hdf5 ...]

Writes OUT_DIR/<basename>.npz for each input. victor_tpu_torch's loader
reads both formats; the .npz copies serve machines without h5py, and
chip_smoke.py reads them. tests/test_torch_tables.py holds the shipped
copies in data/BOSS_DR12_CMASS_npz equal to their HDF5 originals.
"""

import os
import sys

import h5py
import numpy as np


def main(out_dir, *paths):
    os.makedirs(out_dir, exist_ok=True)
    for path in paths:
        with h5py.File(path, 'r') as f:
            arrays = {key: f[key][:] for key in f.keys()}
        name = os.path.splitext(os.path.basename(path))[0] + '.npz'
        np.savez_compressed(os.path.join(out_dir, name), **arrays)


if __name__ == '__main__':
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    main(*sys.argv[1:])
