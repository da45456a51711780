from .mesh import (make_mesh, replicate, shard_along, cross_chain_rhat,
                   distributed_init)

__all__ = ['make_mesh', 'replicate', 'shard_along', 'cross_chain_rhat',
           'distributed_init']
