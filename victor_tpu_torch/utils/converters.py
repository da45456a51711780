"""File-format converters with the reference contract (victor/utils.py:97-243),
a copy of `victor_tpu/utils/converters.py` (h5py is imported inside the
functions: the package imports without it).

Host-side data-preparation tools: legacy .npy model/data files -> the HDF5
key schema consumed by the loaders, and Quijote-style JSON simulation suites
-> stacked HDF5 including mock covariance matrices.
"""

from __future__ import annotations

import numpy as np


def _split_multipoles(arr):
    """Split a stacked [monopole | quadrupole] array along its last axis."""
    half = arr.shape[-1] // 2
    return arr[..., :half], arr[..., half:]


def convert_old_model_files_to_hdf5(realspace_ccf_file, output_model_file,
                                    matter_ccf_file=None, velocity_file=None,
                                    beta_file=None):
    """Legacy .npy model inputs -> HDF5 model-input file
    (victor/utils.py:97-130): keys r/monopole/quadrupole (+beta when
    reconstruction), rdelta/delta, rsv/sigmav."""
    import h5py

    with h5py.File(output_model_file, 'w') as f:
        real_ccf = np.load(realspace_ccf_file, allow_pickle=True).item()
        f.create_dataset('r', data=real_ccf['rvals'])
        mono, quad = _split_multipoles(np.asarray(real_ccf['multipoles']))
        if beta_file is not None:
            f.create_dataset('beta', data=np.load(beta_file, allow_pickle=True))
        f.create_dataset('monopole', data=mono)
        f.create_dataset('quadrupole', data=quad)
        if matter_ccf_file is not None:
            matter = np.load(matter_ccf_file, allow_pickle=True).item()
            f.create_dataset('rdelta', data=matter['rvals'])
            f.create_dataset('delta', data=matter['delta'])
        if velocity_file is not None:
            velocity = np.load(velocity_file, allow_pickle=True).item()
            f.create_dataset('rsv', data=velocity['rvals'])
            f.create_dataset('sigmav', data=velocity['sigma_v_los'])


def convert_old_data_files_to_hdf5(redshift_ccf_file, output_data_file,
                                   beta_file=None, covmat_file=None,
                                   output_covmat_file=None, beta_cov_file=None):
    """Legacy .npy data files -> HDF5 data-vector (+ covariance) files
    (victor/utils.py:132-159)."""
    import h5py

    with h5py.File(output_data_file, 'w') as f:
        redshift_ccf = np.load(redshift_ccf_file, allow_pickle=True).item()
        f.create_dataset('s', data=redshift_ccf['rvals'])
        mono, quad = _split_multipoles(np.asarray(redshift_ccf['multipoles']))
        if beta_file is not None:
            f.create_dataset('beta', data=np.load(beta_file, allow_pickle=True))
        f.create_dataset('monopole', data=mono)
        f.create_dataset('quadrupole', data=quad)

    if covmat_file is not None:
        with h5py.File(output_covmat_file, 'w') as f:
            if beta_cov_file is not None:
                f.create_dataset('beta',
                                 data=np.load(beta_cov_file, allow_pickle=True))
            f.create_dataset('covmat',
                             data=np.load(covmat_file, allow_pickle=True))


def convert_hans_quijote_to_hdf5(input_fn, output_fn, reconvoids=True):
    """Quijote-suite JSON -> HDF5 with per-mock stacks, suite averages and
    mock covariance matrices (victor/utils.py:161-243)."""
    import json

    import h5py

    with open(input_fn, 'rb') as json_file:
        data = json.load(json_file)

    txt = 'RECON' if reconvoids else 'REAL'
    grids = {
        'r': data[0][f'CCF_multipole_Halo_{txt}_Void_{txt}_radius'],
        's': data[0][f'CCF_multipole_Halo_RSD_Void_{txt}_radius'],
        'rdelta': data[0][f'profile_DM_REAL_Void_{txt}_radius'],
        'rv': data[0][f'profile_Halo_REAL_Void_{txt}_radius'],
        'rsv': data[0][f'profile_Halo_REAL_Void_{txt}_radius'],
    }
    per_mock_keys = {
        'xi0_r': f'CCF_multipole_Halo_{txt}_Void_{txt}_xi0',
        'xi2_r': f'CCF_multipole_Halo_{txt}_Void_{txt}_xi2',
        'xi4_r': f'CCF_multipole_Halo_{txt}_Void_{txt}_xi4',
        'xi0_s': f'CCF_multipole_Halo_RSD_Void_{txt}_xi0',
        'xi2_s': f'CCF_multipole_Halo_RSD_Void_{txt}_xi2',
        'xi4_s': f'CCF_multipole_Halo_RSD_Void_{txt}_xi4',
        'delta': f'profile_DM_REAL_Void_{txt}_delta',
        'Delta': f'profile_DM_REAL_Void_{txt}_Delta',
        'vr': f'profile_Halo_REAL_Void_{txt}_v',
        'sigmav': f'profile_Halo_REAL_Void_{txt}_sigma',
    }
    stacks = {out: np.array([mock[src] for mock in data])
              for out, src in per_mock_keys.items()}

    with h5py.File(output_fn, 'w') as f:
        for key, grid in grids.items():
            f.create_dataset(key, data=np.asarray(grid))
        for key, stack in stacks.items():
            f.create_dataset(key, data=stack)
            f.create_dataset(f'average_{key}', data=stack.mean(axis=0))
        # mock covariances of the stacked redshift-space data vectors
        f.create_dataset('D_ell024_covmat', data=np.cov(np.hstack(
            [stacks['xi0_s'], stacks['xi2_s'], stacks['xi4_s']]), rowvar=False))
        f.create_dataset('D_ell02_covmat', data=np.cov(np.hstack(
            [stacks['xi0_s'], stacks['xi2_s']]), rowvar=False))
