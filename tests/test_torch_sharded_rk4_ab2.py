"""Decomposed fixed-dt RK4 and AB2 windows through the ext kernels #8 (2D,
``multi_stencil_ext_2d``) and #6 (3D, ``multi_stencil_ext_3d``), fp64:

- the replays of the ext kernels' marches on the RK4 programs (stage values
  stored, ``carry=True``) and the AB2 programs (``2n`` planes) against their
  plain versions at rtol = atol = 0, at every k of the ladders and under
  every edge-flag pattern;
- decomposed windows against ``pde_tpu``'s sharded fused windows in interpret
  mode (as ``tests/parallel/test_sharded.py:1147-1166`` runs them) at 1e-12,
  and against the port's serial windows bit for bit, over two tracker
  windows (AB2's rate planes carried across, per block);
- the stages, slots and ladders at the blocks' halo, and 3D RK4 of a
  two-deep rhs, whose ext program is cut into two passes of two RK stages
  (the first computing the cells around its blocks that the second reads):
  blocks of 8 cells take its window, bit-equal to the serial window (``tests/test_torch_rk4_3d_deep.py`` holds both against
  ``pde_tpu``).
"""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu.solvers.adams_bashforth import AdamsBashforthSolver as JaxAB2
from pde_tpu.solvers.runge_kutta import RungeKuttaSolver as JaxRK
from pde_tpu_torch.ops import cuda_ext_2d as ce
from pde_tpu_torch.ops import cuda_ext_3d as e3
from pde_tpu_torch.parallel import GridMesh

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
NOFLUX = {"derivative": 0}
MIXED = {"x": "periodic", "y-": {"value": 0.3}, "y+": {"derivative": 0.1}}
COUPLED = {
    "u": "0.1 * laplace(u) + 1 - 2 * u + u**2 * v",
    "v": "0.05 * laplace(v) + u - u**2 * v",
}
HOOKS = {"rk4": "make_fused_rk4_window", "ab2": "make_fused_ab2_window"}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


def _state(pkg, shape, n_fields, seed, periodic=True, low=0.0, high=1.0):
    gen = np.random.default_rng(seed)
    grid = pkg.UnitGrid(shape, periodic=periodic)
    kwargs = {"dtype": torch.float64} if pkg is tpde else {}
    fields = [pkg.ScalarField(grid, gen.uniform(low, high, shape), label=label, **kwargs)
              for label in "uv"[:n_fields]]
    return fields[0] if n_fields == 1 else pkg.FieldCollection(fields)


def _leaves(state):
    fields = list(state) if hasattr(state, "fields") else [state]
    return [np.asarray(f.data) for f in fields]


# -- the marches ----------------------------------------------------------------------------
# id: (PDE, grid shape, fields, periodic, decomposition)
MARCH_CASES = {
    "allen-cahn mixed": (lambda p: p.AllenCahnPDE(bc=MIXED), [16, 18], 1, [True, False],
                         [2, 2]),
    "cahn-hilliard no-flux": (
        lambda p: p.CahnHilliardPDE(bc_c=NOFLUX, bc_mu=NOFLUX), [16, 18], 1, False, [2, 2]),
    "coupled no-flux": (lambda p: p.PDE(COUPLED, bc=NOFLUX), [16, 18], 2, False, [2, 2]),
    "allen-cahn no-flux 3d": (lambda p: p.AllenCahnPDE(bc=NOFLUX), [8, 8, 10], 1, False,
                              [2, 2, 2]),
}
FLAGS_2D = [[0, 0, 0, 0], [1, 0, 0, 1], [0, 1, 1, 0], [1, 1, 1, 1]]
FLAGS_3D = [[0, 0, 0, 0, 0, 0], [1, 0, 0, 1, 1, 0], [0, 1, 1, 0, 0, 1], [1, 1, 1, 1, 1, 1]]


def _mesh_window(case_id, scheme, dt=1e-3):
    make_eq, shape, n_fields, periodic, decomposition = MARCH_CASES[case_id]
    state = _state(tpde, shape, n_fields, 3, periodic)
    mesh = GridMesh.from_grid(state.grid, decomposition)
    return getattr(make_eq(tpde), HOOKS[scheme])(state, dt, mesh=mesh), mesh


@pytest.mark.parametrize("flag_set", range(4))
@pytest.mark.parametrize("scheme", ["rk4", "ab2"])
@pytest.mark.parametrize("case_id", sorted(MARCH_CASES))
def test_ext_march_replays_plain_version(case_id, scheme, flag_set):
    """The ext kernels' marches on the RK4 and AB2 programs, at every k of the
    window's ladder, equal their plain versions exactly (slots start as NaN,
    so a race or a short ring shows); a periodic axis takes no flag."""
    window, mesh = _mesh_window(case_id, scheme)
    program = window.program
    assert window.sharded and program.carry is (scheme == "rk4")
    assert program.n_fields == MARCH_CASES[case_id][2] * (2 if scheme == "ab2" else 1)
    rank = program.geometry.rank
    flags = (FLAGS_2D if rank == 2 else FLAGS_3D)[flag_set]
    flags = [0 if program.geometry.periodic[i // 2] else f for i, f in enumerate(flags)]
    gen = np.random.default_rng(flag_set)
    for spec in window.specs:
        exts = [torch.as_tensor(gen.uniform(-0.5, 0.5, tuple(n + 2 * spec.halo
                                                              for n in spec.shape)))
                for _ in range(program.n_fields)]
        if rank == 2:
            plain = ce.multi_stencil_ext_2d_plain(exts, spec, flags)
            marched = [ce.multi_stencil_ext_2d_marched(exts, spec, flags, plan=plan)
                       for plan in ((8, 5), None)]
        else:
            plain = e3.multi_stencil_ext_3d_plain(exts, spec, flags)
            marched = [e3.multi_stencil_ext_3d_marched(exts, spec, flags, tile=tile)
                       for tile in ((2, 3, 4), None)]
        for replay in marched:
            for a, b in zip(replay, plain, strict=True):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stages_slots_and_ladders_at_the_blocks_halo():
    """The ext programs are the serial RK4 and AB2 programs (their stage
    cut, slots and program struct), their ladders cut to the halo the blocks
    supply: four halo cells a step for a one-deep rhs, eight for a two-deep
    one; AB2's rate planes take none."""
    def struct(text):
        return text[text.index("namespace {"):text.index("}  // namespace")]

    for shape, want in (([64, 64], {"rk4": [2, 1], "ab2": [8, 4, 2, 1]}),
                        ([12, 20], {"rk4": [1], "ab2": [4, 2, 1]}),
                        ([6, 8], {"ab2": [2, 1]})):
        state = _state(tpde, shape, 1, 0)
        mesh = GridMesh.from_grid(state.grid, [2, 2])
        for scheme in want:
            eq = tpde.AllenCahnPDE()
            window = getattr(eq, HOOKS[scheme])(state, 1e-3, mesh=mesh)
            serial = getattr(eq, HOOKS[scheme])(state, 1e-3)
            assert [s.k for s in window.specs] == want[scheme]
            assert window.specs[0].halo == want[scheme][0] * window.program.depth
            assert window.program.depth == (4 if scheme == "rk4" else 1)
            assert window.program.march.slots == serial.program.march.slots
            assert struct(window.program.source) == struct(serial.program.source)
            assert window.n_aux if scheme == "ab2" else not hasattr(window, "n_aux")
    with pytest.raises(tpde.KernelUnsupportedError, match="Shard too small"):
        tpde.AllenCahnPDE().make_fused_rk4_window(state, 1e-3, mesh=mesh)  # blocks of 3x4
    ch = tpde.CahnHilliardPDE().make_fused_rk4_window(
        _state(tpde, [32, 32], 1, 0), 1e-3, mesh=GridMesh.from_grid(
            tpde.UnitGrid([32, 32], periodic=True), [2, 2]))
    assert ch.program.depth == 8 and [s.k for s in ch.specs] == [1]
    with pytest.raises(tpde.KernelUnsupportedError, match="Shard too small"):
        tpde.CahnHilliardPDE().make_fused_rk4_window(
            _state(tpde, [16, 16], 1, 0), 1e-3,
            mesh=GridMesh.from_grid(tpde.UnitGrid([16, 16], periodic=True), [4, 2]))
    ac3 = _mesh_window("allen-cahn no-flux 3d", "rk4")[0]
    assert ac3.program.ladder == [1] and ac3.program.march.step_slots == 20


# -- the windows against pde_tpu and the serial windows -------------------------------------
# id: (PDE, grid shape, fields, periodic, decomposition, scheme)
WINDOW_CASES = {
    "allen-cahn rk4 [2, 2]": (lambda p: p.PDE({"c": "0.1 * laplace(c) - c**3 + c"}),
                              [16, 16], 1, True, [2, 2], "rk4"),
    "allen-cahn ab2 [2, 2]": (lambda p: p.PDE({"c": "0.1 * laplace(c) - c**3 + c"}),
                              [16, 16], 1, True, [2, 2], "ab2"),
    "cahn-hilliard no-flux rk4 [1, 2]": (
        lambda p: p.CahnHilliardPDE(0.5, bc_c=NOFLUX, bc_mu=NOFLUX), [16, 24], 1, False,
        [1, 2], "rk4"),
    "coupled ab2 [2, 1]": (lambda p: p.PDE(COUPLED), [16, 16], 2, True, [2, 1], "ab2"),
    "allen-cahn 3d rk4 [2, 1, 1]": (lambda p: p.AllenCahnPDE(), [8, 8, 8], 1, True,
                                    [2, 1, 1], "rk4"),
    "allen-cahn 3d ab2 [2, 2, 2]": (lambda p: p.AllenCahnPDE(bc=NOFLUX), [8, 8, 8], 1, False,
                                    [2, 2, 2], "ab2"),
}
SOLVERS = {"rk4": (JaxRK, tpde.RungeKuttaSolver), "ab2": (JaxAB2, tpde.AdamsBashforthSolver)}
BOUNDS = (0.0, 0.01, 0.02)


def _run(solver, state, bounds=BOUNDS):
    stepper = solver.make_stepper(state, dt=1e-3)
    for t0, t1 in zip(bounds[:-1], bounds[1:]):
        state, t = stepper(state, t0, t1)
        assert t == pytest.approx(t1)
    return state


@pytest.mark.parametrize("case_id", WINDOW_CASES)
def test_decomposed_windows_match_jax_and_serial(case_id, monkeypatch):
    make_eq, shape, n_fields, periodic, decomposition, scheme = WINDOW_CASES[case_id]
    jax_solver, port_solver = SOLVERS[scheme]
    kwargs = {"adaptive": False} if scheme == "rk4" else {}
    wrapper = ce.multi_stencil_ext_2d if len(shape) == 2 else e3.multi_stencil_ext_3d
    launches = wrapper.launches
    solver = port_solver(make_eq(tpde), decomposition=decomposition, **kwargs)
    got = _run(solver, _state(tpde, shape, n_fields, 7, periodic))
    assert solver.info["fused_step"] is True and solver.info["decomposition"] == decomposition
    assert solver.info["steps"] == 20 and wrapper.launches == launches  # plain versions here
    if scheme == "ab2":  # the rate planes, split into blocks, carried across the windows
        assert len(solver._fused_aux) == n_fields
        assert all(len(blocks) == int(np.prod(decomposition)) for blocks in solver._fused_aux)
    serial_solver = port_solver(make_eq(tpde), **kwargs)
    serial = _run(serial_solver, _state(tpde, shape, n_fields, 7, periodic))
    assert serial_solver.info["fused_step"] is True
    for a, b in zip(_leaves(got), _leaves(serial), strict=True):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PDE_TPU_DISABLE_FUSED", raising=False)
    jsolver = jax_solver(make_eq(jpde), decomposition=decomposition, **kwargs)
    jres = _run(jsolver, _state(jpde, shape, n_fields, 7, periodic))
    assert jsolver.info.get("fused_step") is True
    for a, b in zip(_leaves(got), _leaves(jres), strict=True):
        np.testing.assert_allclose(a, b, **TOL)


def test_3d_rk4_of_a_two_deep_rhs():
    """3D RK4 of Cahn-Hilliard on blocks of 8 cells (its halo a step): the ext
    program is cut into two passes of two RK stages (the serial one into
    four of one), which compute 4 and 0 cells past their blocks; the torch
    engine takes the
    decomposed window, bit-equal to the serial window, and the cuda engine
    takes the kernel (so a CPU state raises)."""
    state = _state(tpde, [16, 8, 8], 1, 0, low=-0.1, high=0.1)
    mesh = GridMesh.from_grid(state.grid, [2, 1, 1])
    window = tpde.CahnHilliardPDE().make_fused_rk4_window(state, 1e-3, mesh=mesh)
    serial_window = tpde.CahnHilliardPDE().make_fused_rk4_window(state, 1e-3)
    assert [p.extent for p in window.program.passes] == [4, 0]
    assert [p.depth for p in window.program.passes] == [4, 4]
    assert [p.depth for p in serial_window.program.passes] == [2, 2, 2, 2]
    assert [s.k for s in window.specs] == [1] and window.specs[0].halo == 8
    got, info = tpde.CahnHilliardPDE().solve(state, t_range=0.005, dt=1e-3, tracker=None,
                                             solver="runge-kutta", decomposition=[2, 1, 1],
                                             ret_info=True)
    assert info["solver"]["fused_step"] is True and "fused_unsupported" not in info["solver"]
    serial = tpde.CahnHilliardPDE().solve(state, t_range=0.005, dt=1e-3, tracker=None,
                                          solver="runge-kutta")
    np.testing.assert_array_equal(got.data.numpy(), serial.data.numpy())
    with pytest.raises(RuntimeError, match="CUDA device"):
        tpde.RungeKuttaSolver(tpde.CahnHilliardPDE(), backend="cuda",
                              decomposition=[2, 1, 1]).make_stepper(state, dt=1e-3)
