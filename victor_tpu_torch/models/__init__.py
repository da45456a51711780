from .cosmology import BackgroundCosmology

__all__ = ['BackgroundCosmology']
