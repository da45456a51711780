from .logging import get_logger
from .profiling import (timed, trace, throughput, phase_times,
                        reset_phase_times, debug_nans)
from .multipoles import multipoles_from_fn, fn_from_multipoles
from .converters import (convert_old_model_files_to_hdf5,
                         convert_old_data_files_to_hdf5,
                         convert_hans_quijote_to_hdf5)

__all__ = ['get_logger', 'timed', 'trace', 'throughput', 'phase_times',
           'reset_phase_times', 'debug_nans', 'multipoles_from_fn',
           'fn_from_multipoles', 'convert_old_model_files_to_hdf5',
           'convert_old_data_files_to_hdf5', 'convert_hans_quijote_to_hdf5']
