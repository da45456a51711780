from .cosmology import BackgroundCosmology
from .eisenstein_hu import EisensteinHu, eisenstein_hu_params, power_eh, sigma80

__all__ = ['BackgroundCosmology', 'EisensteinHu', 'eisenstein_hu_params',
           'power_eh', 'sigma80']
