"""pde_tpu_torch: the PyTorch/CUDA port of ``pde_tpu``.

The package mirrors ``pde_tpu``'s layout and public names. Fields hold a
``torch.Tensor``; a field made without ``device=`` lands on the config key
``device``, the card by default (``pde.config["device"] = "cpu"`` or
``device="cpu"`` asks for the CPU). On 2D Cartesian grids the fixed-dt Euler
path of ``DiffusionPDE`` runs through a hand-written CUDA kernel
(``csrc/affine_laplace_2d.cu``), and that of expression PDEs (``PDE``, with
one field or a ``FieldCollection`` of scalar fields), ``CahnHilliardPDE`` and
``AllenCahnPDE`` through a kernel generated from the rhs around the
hand-written template ``csrc/multi_stencil_2d.cuh``, on an NVIDIA GPU. On 3D
Cartesian grids the same models take ``csrc/affine_laplace_3d.cuh`` and the
template ``csrc/multi_stencil_3d.cuh``. Equations with additive noise on 2D
grids (``KPZInterfacePDE``, stochastic ``DiffusionPDE`` and ``PDE``) take
Euler-Maruyama windows through the 2D template with a noise policy: staged
increments, or Philox4x32-10 drawn in the kernel (``csrc/philox.cuh``). On
the CPU every kernel runs its plain PyTorch version. This package never
imports JAX.

``VectorField`` and ``Tensor2Field`` hold ``(dim, ...)`` and ``(dim, dim,
...)`` data on Cartesian grids; a vector state enters the expression
windows as its component planes. ``get_backend("cuda").make_operator(grid,
op, bc)`` applies ``laplace`` and the stencil operators (``gradient``,
``gradient_squared``, ``divergence``, ``vector_laplace``,
``vector_gradient``, ``tensor_divergence``) on 2D Cartesian grids through
hand-written kernels (``csrc/stencil_op_2d.cu`` for all but ``laplace``).

Solvers: explicit Euler (``"euler"``), classic RK4 and adaptive
Runge-Kutta-Fehlberg (``"runge-kutta"``) and second-order Adams-Bashforth
(``"adams-bashforth"``). Their fixed-dt windows take the kernels above (RK4
and AB2 through the generated multi-field kernels); adaptive steps (``solve``
without ``dt``) are plain torch on the state's device, their accept test and
dt update included. Implicit Euler (``"implicit"``), Crank-Nicolson
(``"crank-nicolson"``), scipy's ``solve_ivp`` (``"scipy"``) and the
exponential integrator ETDRK4 (``"etdrk4"``) are plain torch on the state's
device too, and so is the Milstein method (``"milstein"``) for multiplicative
noise, whose additive scalar noise takes the Euler-Maruyama kernels, as are the Poisson solvers (``solve_poisson_equation``,
``solve_laplace_equation``, ``helmholtz_decomposition``).

Decomposed runs (``solver="explicit_sharded"`` or ``decomposition=`` on
any solver) split a 2D or 3D Cartesian grid, or a polar, spherical or
cylindrical one into annular blocks, into blocks held by this process
(:class:`GridMesh`), exchange halos by copies and run the halo-extended
kernels (the ext kernels of ``csrc/affine_march_2d.cuh``, with the radial
mode on cylindrical grids, ``csrc/affine_laplace_ext_3d.cuh``,
``csrc/march_2d.cuh`` and ``csrc/multi_stencil_3d.cuh``; Euler, RK4 and
AB2). Every other explicit
configuration, noise and adaptive steps included, runs on the plain sharded
stepper (``ShardedBoundaries``: the plain rhs on each block's halo-extended
view); see :mod:`pde_tpu_torch.parallel`.

    import pde_tpu_torch as pde

    grid = pde.UnitGrid([64, 64], periodic=True)
    state = pde.ScalarField.random_uniform(grid)  # on the card
    result = pde.DiffusionPDE(diffusivity=0.1).solve(state, t_range=10, dt=0.1)

Trackers (``tracker=`` of ``solve``: names, callables, interrupt schedules)
and storages (``MemoryStorage``, HDF5 ``FileStorage``, ``MovieStorage``) run
on the host between the fused windows; a stored frame is one copy to the host
(a movie frame is quantized on the card first). Plots (``field.plot()``,
``grid.plot()``, the plot trackers, ``visualization``) draw host copies with
matplotlib, and movies of figures take the native codec or ``ffmpeg``;
matplotlib, napari and libav are optional and imported where they are used.
"""

__version__ = "0.1.0"

from .backends import NumpyBackend, get_backend, registered_backends
from .fields import (
    DataFieldBase,
    FieldBase,
    FieldCollection,
    ScalarField,
    Tensor2Field,
    VectorField,
)
from .fields.base import RankError
from .grids import (
    CartesianGrid,
    CylindricalSymGrid,
    DimensionError,
    GridBase,
    DomainError,
    PeriodicityError,
    PolarSymGrid,
    SphericalSymGrid,
    UnitGrid,
)
from .grids.base import (
    OperatorInfo,
    discretize_interval,
    registered_grids,
    registered_operators,
)
from .grids.boundaries import (
    BCBase,
    BCDataError,
    BoundariesBase,
    BoundariesList,
    BoundariesSetter,
    BoundaryAxisBase,
    BoundaryPair,
    BoundaryPeriodic,
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
    get_boundary_axis,
    registered_boundary_condition_classes,
    registered_boundary_condition_names,
    set_default_bc,
)
from .interop import field_from_state
from .models import (
    PDE,
    AllenCahnPDE,
    CahnHilliardPDE,
    DiffusionPDE,
    KleinGordonPDE,
    KPZInterfacePDE,
    KuramotoSivashinskyPDE,
    PDEBase,
    ReactionDiffusionPDE,
    SDEBase,
    SwiftHohenbergPDE,
    WavePDE,
    helmholtz_decomposition,
    solve_laplace_equation,
    solve_poisson_equation,
)
from .ops import KernelUnsupportedError
from .parallel import GridMesh
from .solvers import (
    AdamsBashforthSolver,
    AdaptiveSolverBase,
    Controller,
    ConvergenceError,
    CrankNicolsonSolver,
    ETDRK4Solver,
    EulerSolver,
    ExplicitMPISolver,
    ExplicitShardedSolver,
    ExplicitSolver,
    ImplicitSolver,
    MilsteinSolver,
    RungeKuttaSolver,
    ScipySolver,
    SolverBase,
    registered_solvers,
)
from .storage import (
    FileStorage,
    MemoryStorage,
    ModelrunnerStorage,
    MovieStorage,
    StorageBase,
    StorageTracker,
    StorageView,
    get_memory_storage,
)
from .trackers import (
    CallbackTracker,
    ConsistencyTracker,
    ConstantInterrupts,
    DataTracker,
    FinishedSimulation,
    FixedInterrupts,
    GeometricInterrupts,
    InteractivePlotTracker,
    InterruptsBase,
    LivePlotTracker,
    LogarithmicInterrupts,
    MaterialConservationTracker,
    MaxRuntimeTracker,
    PlotTracker,
    PrintTracker,
    ProgressTracker,
    RealtimeInterrupts,
    RuntimeTracker,
    SteadyStateTracker,
    TrackerBase,
    TrackerCollection,
    TransformedTrackerBase,
    WalltimeTracker,
    get_named_trackers,
    parse_interrupt,
    registered_trackers,
)
from .utils.config import Config, Parameter, config, environment
from .utils.expressions import ScalarExpression, TensorExpression
from .utils.expressions_eval import evaluate
from .visualization import (
    Movie,
    ScalarFieldPlot,
    extract_field,
    movie,
    movie_multiple,
    movie_scalar,
    plot_interactive,
    plot_kymograph,
    plot_kymographs,
    plot_magnitudes,
)

# module aliases of pde_tpu's (and py-pde's) layout: `pdes`, `tools` and
# `solvers.explicit_mpi`
from . import models as pdes  # noqa: E402
from . import utils as tools  # noqa: E402
from .solvers import explicit_sharded as explicit_mpi  # noqa: E402
