"""Fixed-dt RK4 and second-order Adams-Bashforth in the port
(``solvers/runge_kutta.py``, ``solvers/adams_bashforth.py``) and their fused
windows through the generated kernels #7 (2D) and #5 (3D).

- The plain steppers against ``pde_tpu``'s XLA steppers, and the fused
  windows (on the CPU: the kernels' plain versions) against ``pde_tpu``'s
  fused windows in interpret mode, as ``tests/ops/test_pallas_kernels.py``
  runs them: Cahn-Hilliard (depth 2), Allen-Cahn (depth 1), a coupled
  two-field system, 3D Allen-Cahn, and AB2's rate planes carried across
  tracker windows; fp64, 1e-12.
- The replays of the kernels' marches against the plain versions at
  rtol = atol = 0 (slots start as NaN, so a race or a short ring shows), for
  the RK4 programs with their stage values stored (the default) and
  recomputed, and for AB2.
- The stage cut, the slots, the ladders and plans, and the gates.
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.solvers.adams_bashforth import AdamsBashforthSolver as JaxAB2
from pde_tpu.solvers.runge_kutta import RungeKuttaSolver as JaxRK
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.ops import cuda_stencil_3d as s3

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-13)
COUPLED = {
    "u": "0.1 * laplace(u) + 1 - 2 * u + u**2 * v",
    "v": "0.05 * laplace(v) + u - u**2 * v",
}
NOFLUX = {"derivative": 0}
MIXED = {"x": "periodic", "y-": {"value": 0.3}, "y+": {"derivative": 0.1}}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _state(pkg, shape, n_fields, seed, periodic=True):
    gen = np.random.default_rng(seed)
    grid = pkg.UnitGrid(shape, periodic=periodic)
    kwargs = {"dtype": torch.float64} if pkg is tpde else {}
    fields = [pkg.ScalarField(grid, gen.uniform(0.0, 1.0, shape), **kwargs)
              for _ in range(n_fields)]
    if n_fields == 1:
        return fields[0]
    fields[0].label, fields[1].label = "u", "v"
    return pkg.FieldCollection(fields)


def _leaves(state):
    fields = list(state) if isinstance(state, (jpde.FieldCollection, tpde.FieldCollection)) \
        else [state]
    return [np.asarray(f.data) for f in fields]


def _windows(solver, state, bounds):
    stepper = solver.make_stepper(state, dt=1e-3)
    for t0, t1 in zip(bounds[:-1], bounds[1:]):
        state, t = stepper(state, t0, t1)
        assert t == pytest.approx(t1)
    return state


# id: (make the PDE in one package, grid shape, fields, periodic)
CASES = {
    "allen-cahn": (lambda p: p.PDE({"c": "0.1 * laplace(c) - c**3 + c"}), [16, 16], 1, True),
    "cahn-hilliard": (lambda p: p.CahnHilliardPDE(interface_width=0.5), [16, 16], 1, True),
    "cahn-hilliard-noflux": (
        lambda p: p.CahnHilliardPDE(0.5, bc_c=NOFLUX, bc_mu=NOFLUX), [16, 12], 1, False),
    "coupled": (lambda p: p.PDE(COUPLED), [16, 16], 2, True),
    "allen-cahn-3d": (lambda p: p.AllenCahnPDE(), [8, 8, 8], 1, True),
}
SOLVERS = {"rk4": (JaxRK, tpde.RungeKuttaSolver), "ab2": (JaxAB2, tpde.AdamsBashforthSolver)}


def _pair(case_id, scheme, fused, monkeypatch, bounds=(0.0, 0.01, 0.02)):
    make_eq, shape, n_fields, periodic = CASES[case_id]
    jax_solver, port_solver = SOLVERS[scheme]
    jstate = _state(jpde, shape, n_fields, 7, periodic)
    tstate = _state(tpde, shape, n_fields, 7, periodic)
    if fused:
        monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
        monkeypatch.delenv("PDE_TPU_DISABLE_FUSED", raising=False)
    else:
        monkeypatch.setenv("PDE_TPU_DISABLE_FUSED", "1")
    kwargs = {"adaptive": False} if scheme == "rk4" else {}
    jsolver = jax_solver(make_eq(jpde), **kwargs)
    jres = _windows(jsolver, jstate, bounds)
    tsolver = port_solver(make_eq(tpde), backend="torch" if fused else "numpy", **kwargs)
    tres = _windows(tsolver, tstate, bounds)
    assert jsolver.info.get("fused_step") is (True if fused else None)
    assert tsolver.info.get("fused_step") is (True if fused else None)
    assert tsolver.info["steps"] == jsolver.info["steps"] == round(bounds[-1] / 1e-3)
    for a, b in zip(_leaves(tres), _leaves(jres), strict=True):
        np.testing.assert_allclose(a, b, **TOL)
    return tsolver


@pytest.mark.parametrize("scheme", ["rk4", "ab2"])
@pytest.mark.parametrize("case_id", ["allen-cahn", "cahn-hilliard-noflux", "coupled"])
def test_plain_steppers_match_pde_tpu(case_id, scheme, monkeypatch):
    """Two tracker windows of the plain loops; AB2 carries its previous
    rates from the first window into the second."""
    _pair(case_id, scheme, False, monkeypatch)


@pytest.mark.parametrize("scheme", ["rk4", "ab2"])
@pytest.mark.parametrize("case_id", sorted(CASES))
def test_fused_windows_match_pde_tpu_interpret(case_id, scheme, monkeypatch):
    """The port's fused windows against pde_tpu's in interpret mode, over two
    tracker windows: AB2's rate planes ride from one window into the next."""
    solver = _pair(case_id, scheme, True, monkeypatch)
    if scheme == "ab2":
        n_planes = CASES[case_id][2]
        assert len(solver._fused_aux) == n_planes


# -- the marches ----------------------------------------------------------------------------
def _window(eq, shape, n_fields, scheme, periodic=True):
    state = _state(tpde, shape, n_fields, 3, periodic)
    hook = eq.make_fused_rk4_window if scheme == "rk4" else eq.make_fused_ab2_window
    return hook(state, 1e-3)


def _recomputed(window):
    """The window's program with its RK4 stage values recomputed in the later
    stages rather than stored (the control the stored cut was timed against)."""
    p = window.program
    return s3.make_chunked_multi_window(
        p.grid, p.make_step, p.depth, p.n_fields, dtype=torch.float64, carry=False)


MARCH_CASES = {
    "allen-cahn-mixed": (lambda: tpde.AllenCahnPDE(bc=MIXED), [21, 19], 1, [True, False]),
    "cahn-hilliard": (lambda: tpde.CahnHilliardPDE(), [20, 18], 1, True),
    "swift-hohenberg-mixed": (lambda: tpde.SwiftHohenbergPDE(bc=MIXED), [20, 17], 1,
                              [True, False]),
    "wave-system": (lambda: tpde.PDE({"u": "v", "v": "0.5 * laplace(u)"}, bc=MIXED), [18, 20],
                    2, [True, False]),
    "allen-cahn-3d": (lambda: tpde.AllenCahnPDE(bc=NOFLUX), [9, 7, 10], 1, False),
}


@pytest.mark.parametrize("carry", [True, False], ids=["stored", "recomputed"])
@pytest.mark.parametrize("case_id", sorted(MARCH_CASES))
def test_rk4_march_replays_plain_version(case_id, carry):
    make_eq, shape, n_fields, periodic = MARCH_CASES[case_id]
    window = _window(make_eq(), shape, n_fields, "rk4", periodic)
    assert window.program.carry
    _assert_replays(window if carry else _recomputed(window), shape)


@pytest.mark.parametrize("case_id", ["allen-cahn-mixed", "cahn-hilliard", "allen-cahn-3d"])
def test_ab2_march_replays_plain_version(case_id):
    make_eq, shape, n_fields, periodic = MARCH_CASES[case_id]
    window = _window(make_eq(), shape, n_fields, "ab2", periodic)
    assert window.program.n_fields == 2 * n_fields and window.n_aux == n_fields
    _assert_replays(window, shape)


def _assert_replays(window, shape):
    program = window.program
    gen = np.random.default_rng(11)
    datas = [torch.as_tensor(gen.uniform(-0.5, 0.5, shape)) for _ in range(program.n_fields)]
    for spec in window.specs:
        plain = cs.multi_stencil_2d_plain(datas, spec)
        if len(shape) == 2:
            marched = cs.multi_stencil_2d_marched(datas, spec, plan=(8, 8))
        else:
            marched = s3.multi_stencil_3d_marched(datas, spec, tile=(5, 4, 8))
        for a, b in zip(marched, plain, strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- stages, slots, ladders and plans --------------------------------------------------------
def test_stages_slots_and_ladders():
    ac = _window(tpde.AllenCahnPDE(), [64, 64], 1, "rk4").program
    ch = _window(tpde.CahnHilliardPDE(), [64, 64], 1, "rk4").program
    # four halo cells a step for a one-deep rhs (k = 2 under TOP_HALO = 8), eight
    # for a two-deep one (k = 1)
    assert (ac.depth, ac.ladder, ch.depth, ch.ladder) == (4, [2, 1], 8, [1])
    # one stage per rhs stage and buffer depth; each buffer stage of Allen-Cahn also
    # stores k1, then k1 + 2 k2, then k1 + 2 k2 + 2 k3 for the stages after it
    layout = ac.march
    assert [st.lag for st in layout.stages] == [1, 2, 3, 4]
    assert [len(st.nodes) for st in layout.stages] == [2, 2, 2, 1]
    # the field's ring reaches back to the output stage's lag of 4; the rings are
    # lengthened to a period of 6 (from 30), whose row loop the march unrolls
    assert layout.slots == (6, 3, 2, 3, 2, 3, 2)
    assert ch.march.slots == (9,) + (3,) * 10
    for program in (ac, ch):
        slots = program.march.slots
        assert np.lcm.reduce(slots) <= max(cs.PERIOD_CAP, 2 * max(slots))
        assert program.tiles[torch.float64][program.ladder[0]] == (256, 288)
    # recomputed, Allen-Cahn keeps fewer rows but evaluates k1-k3 again
    plain_cut = _recomputed(_window(tpde.AllenCahnPDE(), [64, 64], 1, "rk4")).program
    assert [len(st.nodes) for st in plain_cut.march.stages] == [1, 1, 1, 1]
    assert plain_cut.march.slots == (6, 6, 4, 3)
    # AB2 keeps Euler's ladder: its rate planes take no halo
    for eq in (tpde.AllenCahnPDE(), tpde.CahnHilliardPDE()):
        euler = eq.make_fused_euler_window(_state(tpde, [64, 64], 1, 0), 1e-3).program
        ab2 = _window(eq, [64, 64], 1, "ab2").program
        assert ab2.ladder == euler.ladder and ab2.depth == euler.depth


def test_3d_plans():
    """3D RK4 of a one-deep rhs fits at k = 1 with one block per SM in fp64
    (two in fp32); of a two-deep rhs it fits once the step is cut into four
    passes of two planes of halo (rings of three planes at most, two blocks
    an SM), and the engines take the fused window (torch: its plain version
    on the CPU; cuda: the kernel, so a CPU state raises)."""
    ac = _window(tpde.AllenCahnPDE(), [64, 64, 64], 1, "rk4").program
    assert ac.ladder == [1] and ac.march.step_slots == 20
    assert ac.tiles[torch.float64][1] == (32, 8, 64) == ac.tiles[torch.float32][1]
    assert ac.march.step_slots * 16 * 72 * 8 > cs.SMEM_BUDGET
    assert ac.march.step_slots * 16 * 72 * 8 <= s3.SMEM_ONE_BLOCK
    ab2 = _window(tpde.AllenCahnPDE(), [64, 64, 64], 1, "ab2").program
    assert ab2.ladder == [2, 1]
    for eq in (tpde.CahnHilliardPDE(), tpde.SwiftHohenbergPDE()):
        program = _window(eq, [32, 32, 32], 1, "rk4").program
        assert len(program.passes) == 4 and program.ladder == [1]
        assert all(p.depth == 2 and max(p.march.slots) == 3 for p in program.passes)
        assert program.tiles[torch.float32][1][0] == (32, 32, 64)
        assert program.tiles[torch.float64][1][0] == (32, 16, 64)
    state = _state(tpde, [16, 16, 16], 1, 0)
    solver = tpde.RungeKuttaSolver(tpde.CahnHilliardPDE())
    solver.make_stepper(state, dt=1e-3)
    assert solver.info["fused_step"] is True and "fused_unsupported" not in solver.info
    with pytest.raises(RuntimeError, match="CUDA device"):
        tpde.RungeKuttaSolver(tpde.CahnHilliardPDE(), backend="cuda").make_stepper(state, dt=1e-3)


# -- the gates --------------------------------------------------------------------------------
def test_gates():
    state = _state(tpde, [16, 16], 1, 0, periodic=False)
    cube = tpde.ScalarField(tpde.UnitGrid([8, 8, 8]), 0.5, dtype=torch.float64)
    # per-face values are the 3D windows' side inputs too
    array_bc = tpde.PDE({"c": "laplace(c)"}, bc={"value": np.linspace(0, 64, 64).reshape(8, 8)})
    for hook in (array_bc.make_fused_rk4_window, array_bc.make_fused_ab2_window):
        program = hook(cube, 1e-3).program
        assert program.library == "multi_stencil_3d" and program.sides is not None
    # time-dependent values are the windows' side inputs (expression conditions);
    # a value string is an expression of the coordinates only, as in pde_tpu
    timed = tpde.PDE({"c": "laplace(c)"}, bc={"value_expression": "sin(t)"})
    assert timed.make_fused_rk4_window(state, 1e-3).needs_t
    with pytest.raises(RuntimeError, match="unexpected variables"):
        tpde.PDE({"c": "laplace(c)"}, bc={"value": "sin(t)"}).make_fused_rk4_window(state, 1e-3)
    vector = tpde.VectorField.random_uniform(tpde.UnitGrid([16, 16], periodic=True),
                                             dtype=torch.float64, rng=np.random.default_rng(0))
    eq = tpde.PDE({"u": "0.1 * vector_laplace(u)"})
    assert eq.make_fused_rk4_window(vector, 1e-3).program.n_fields == 2
    with pytest.raises(tpde.KernelUnsupportedError, match="vector states"):
        eq.make_fused_ab2_window(vector, 1e-3)
    noisy = tpde.PDE({"c": "laplace(c)"}, noise=0.1)
    periodic = _state(tpde, [16, 16], 1, 0)
    with pytest.raises(tpde.KernelUnsupportedError, match="noise"):
        noisy.make_fused_rk4_window(periodic, 1e-3)
    with pytest.raises(RuntimeError, match="stochastic"):
        tpde.AdamsBashforthSolver(noisy).make_stepper(periodic, dt=1e-3)
    # on a mesh the RK4/AB2 windows are the ext kernels' (tests/test_torch_sharded_rk4_ab2.py);
    # a decomposed run takes them and equals the serial window's
    with tpde.config({"parallel.devices_per_device": 8}):
        from pde_tpu_torch.parallel import GridMesh

        mesh = GridMesh.from_grid(periodic.grid, [2, 2])
        for hook in (tpde.AllenCahnPDE().make_fused_rk4_window,
                     tpde.AllenCahnPDE().make_fused_ab2_window):
            assert hook(periodic, 1e-3, mesh=mesh).sharded
        for solver in ("runge-kutta", "adams-bashforth"):
            got, info = tpde.AllenCahnPDE().solve(periodic, t_range=0.01, dt=1e-3, solver=solver,
                                                  decomposition=[2, 2], tracker=None,
                                                  ret_info=True)
            assert info["solver"]["fused_step"] is True
            serial = tpde.AllenCahnPDE().solve(periodic, t_range=0.01, dt=1e-3, solver=solver,
                                               tracker=None)
            np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())


def test_cuda_engine_runs_the_kernel_or_raises():
    """backend='cuda' takes the kernel window (on the CPU: its plain
    version, then the state-device check) or raises with the reason."""
    state = _state(tpde, [16, 16], 1, 0)
    for solver in (tpde.RungeKuttaSolver, tpde.AdamsBashforthSolver):
        with pytest.raises(RuntimeError, match="CUDA device"):
            solver(tpde.CahnHilliardPDE(), backend="cuda").make_stepper(state, dt=1e-3)
        # per-point values are the 2D and 3D windows' side inputs
        with pytest.raises(RuntimeError, match="CUDA device"):
            solver(tpde.PDE({"c": "laplace(c)"}, bc={"value": np.linspace(0, 1, 16)}),
                   backend="cuda").make_stepper(_state(tpde, [16, 16], 1, 0, False), dt=1e-3)
        with pytest.raises(RuntimeError, match="CUDA device"):
            solver(tpde.PDE({"c": "laplace(c)"},
                            bc={"value": np.linspace(0, 1, 64).reshape(8, 8)}),
                   backend="cuda").make_stepper(
                tpde.ScalarField(tpde.UnitGrid([8, 8, 8]), 0.5, dtype=torch.float64), dt=1e-3)
    with pytest.raises(RuntimeError, match="no expression form"):
        tpde.RungeKuttaSolver(tpde.WavePDE(), backend="cuda").make_stepper(
            tpde.WavePDE().get_initial_condition(state), dt=1e-3)
