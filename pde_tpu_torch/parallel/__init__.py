"""Domain decomposition: a mesh of blocks held by one process, halo exchange
by copies, the fused windows of decomposed 2D and 3D grids, and the plain
sharded stepper's conditions (:class:`ShardedBoundaries`) and blocks."""

from .boundaries import ShardedBoundaries
from .fused import HaloExchange, make_fused_euler_window_sharded, make_fused_multi_window_sharded
from .mesh import GridMesh, _get_optimal_decomposition
