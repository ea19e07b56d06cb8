"""Domain decomposition: a mesh of blocks held by one process, halo exchange
by copies, and the fused windows of decomposed 2D and 3D grids."""

from .fused import HaloExchange, make_fused_euler_window_sharded, make_fused_multi_window_sharded
from .mesh import GridMesh, _get_optimal_decomposition
