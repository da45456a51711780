from .CCFLikelihood import CCFLikelihood

__all__ = ['CCFLikelihood']
