"""Boundary conditions: periodic, constant affine, expression and user conditions.

Mini-language as in :mod:`pde_tpu.grids.boundaries`: strings ``periodic``,
``dirichlet``/``value``, ``neumann``/``derivative``/``no-flux``,
``mixed``/``robin``, ``curvature``, their ``normal_*`` forms (acting on the
normal component of a vector or tensor field), ``auto_periodic_neumann`` (aka
``natural``), ``auto_periodic_dirichlet``; dicts such as ``{"value": 2}`` or
``{"type": "mixed", "value": 2, "const": 7}``, ``{"value": "sin(x)"}`` (a
value varying along the side), the expression conditions
``{"value_expression": "sin(3*t)"}``, ``derivative_expression``,
``mixed_expression`` and ``virtual_point`` (expressions of the adjacent
value, ``dx``, the coordinates and ``t``), ``"user"``; per-side dicts keyed by axis
(``"y"``, or an alternative name such as ``"radius"``), side (``"y-"``,
``"y+"``), the grid's boundary names (``"left"``, ``"inner"``, ``"top"``) or
``"*"``; a callable setting every ghost cell (``BoundariesSetter``).
"""

from .axes import BoundariesBase, BoundariesList, BoundariesSetter, set_default_bc
from .axis import BoundaryAxisBase, BoundaryPair, BoundaryPeriodic, get_boundary_axis
from .local import (
    BCBase,
    BCDataError,
    ConstBC1stOrderBase,
    ConstBC2ndOrderBase,
    CurvatureBC,
    DirichletBC,
    ExpressionBC,
    ExpressionDerivativeBC,
    ExpressionMixedBC,
    ExpressionValueBC,
    MixedBC,
    NeumannBC,
    NormalCurvatureBC,
    NormalDirichletBC,
    NormalMixedBC,
    NormalNeumannBC,
    UserBC,
    registered_boundary_condition_classes,
    registered_boundary_condition_names,
)
