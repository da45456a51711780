from .loaders import load_key_value_file, select_simulation
from .tables import CCFTables, CCFModelBundle, build_tables, bundle_from_arrays

__all__ = ['load_key_value_file', 'select_simulation', 'CCFTables',
           'CCFModelBundle', 'build_tables', 'bundle_from_arrays']
