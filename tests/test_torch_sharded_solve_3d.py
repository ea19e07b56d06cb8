"""Decomposed fixed-dt Euler runs of the port on 3D Cartesian grids
(``decomposition=[dx, dy, dz]``) against ``pde_tpu``'s decomposed fused runs
on its virtual 8-device CPU mesh (kernels #11, #6 and #4's ``ext_x`` mode in
interpret mode) at ``rtol=1e-12, atol=1e-13``, and against the port's serial
run at 1e-12 (bit-equal in practice), fp64. The cases mirror
``tests/parallel/test_sharded.py:555-806``; the x-cut cases run ``pde_tpu``
under ``PDE_TPU_YCHUNK_SHARDED=1``, its interpret-mode switch to the
y-chunked ``ext_x`` kernel."""

import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu.ops.pallas_cartesian as jax_pallas
import pde_tpu_torch as tpde
from pde_tpu.solvers.controller import Controller as JaxController
from pde_tpu.solvers.euler import EulerSolver as JaxEulerSolver
from pde_tpu_torch.ops import cuda_ext_3d as e3
from pde_tpu_torch.parallel import HaloExchange

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU,
    with eight blocks per device as pde_tpu's tests have eight CPU devices."""
    with tpde.config({"device": "cpu", "parallel.devices_per_device": 8}):
        yield


TOL_JAX = dict(rtol=1e-12, atol=1e-13)
TOL = dict(rtol=1e-12, atol=1e-12)
BRUSSELATOR = {
    "u": "0.1 * laplace(u) + 1 - 2 * u + u**2 * v",
    "v": "0.05 * laplace(v) + u - u**2 * v",
}
EXPR = {"c": "0.1 * laplace(c) + c - c**3"}
EXPR_BC = {"c": "0.1 * laplace(c) - 0.05 * gradient_squared(c)"}
GRAD = {"h": "0.1 * divergence(gradient(h)) + 0.05 * dot(gradient(h), gradient(h))"}


def _periodic(bc):
    return [bc.get(ax) == "periodic" for ax in "xyz"]


# (shape, periodic, equation(pkg), labels, (low, high), t_range, dt, decomposition)
CASES = {}
# tests/parallel/test_sharded.py:640
for dec in ([2, 1, 1], [2, 2, 1], [1, 1, 2], [2, 2, 2]):
    CASES[f"diffusion periodic {dec}"] = (
        (8, 8, 8), True, lambda p: p.DiffusionPDE(diffusivity=0.05), "c", (0, 1), 0.05, 1e-3, dec)
# :676
for name, dec, bc in (
    ("noflux-xcut", [2, 1, 1], {"derivative": 0}),
    ("mixed-xycut", [2, 2, 1], {"x": {"value": 1}, "y": {"derivative": 0.5}, "z": "periodic"}),
    ("mixed-xzcut", [2, 1, 2], {"x": "periodic", "y": {"curvature": 0}, "z": {"value": 0.5}}),
):
    CASES[f"diffusion {name}"] = (
        (8, 8, 8), _periodic(bc) if isinstance(bc, dict) and "x" in bc else False,
        lambda p, bc=bc: p.DiffusionPDE(diffusivity=0.05, bc=bc), "c", (0, 1), 0.05, 1e-3, dec)
# :701
for dec in ([2, 1, 1], [1, 2, 1], [1, 1, 2], [2, 2, 1], [1, 2, 2]):
    CASES[f"expression {dec}"] = (
        (16, 8, 8), True, lambda p: p.PDE(EXPR), "c", (-0.1, 0.1), 0.01, 1e-3, dec)
# :734
for name, dec, bc in (
    ("noflux-xcut", [2, 1, 1], {"derivative": 0}),
    ("dirichlet-ycut", [1, 2, 1], {"x": "periodic", "y": {"value": 0.2}, "z": "periodic"}),
    ("neumann-zcut", [1, 1, 2], {"x": "periodic", "y": "periodic", "z": {"derivative": 0.1}}),
    ("mixed-all", [2, 2, 2], {"x": {"value": 0}, "y": {"derivative": 0}, "z": {"value": 0.5}}),
):
    CASES[f"expression bc {name}"] = (
        (16, 8, 8), _periodic(bc) if "x" in bc else False,
        lambda p, bc=bc: p.PDE(EXPR_BC, bc=bc), "c", (-0.1, 0.1), 0.01, 1e-3, dec)
# :758
for dec in ([2, 2, 1], [1, 2, 2]):
    CASES[f"brusselator {dec}"] = (
        (16, 8, 8), True, lambda p: p.PDE(BRUSSELATOR), "uv", (0, 1), 0.01, 1e-3, dec)
# :784
CASES["gradient composition [1, 2, 2]"] = (
    (16, 8, 8), True, lambda p: p.PDE(GRAD), "h", (-0.1, 0.1), 0.01, 1e-3, [1, 2, 2])

# :555, the x-cut route of pde_tpu's y-chunked ext_x kernel
XCUT = {}
for dec in ([2, 1, 1], [4, 1, 1]):
    XCUT[f"diffusion-noflux {dec}"] = (
        (16, 16, 16), False, lambda p: p.DiffusionPDE(0.05, bc={"derivative": 0}), "c", (0, 1),
        0.01, 1e-3, dec)
    XCUT[f"diffusion-periodic {dec}"] = (
        (16, 16, 16), True, lambda p: p.DiffusionPDE(0.05), "c", (0, 1), 0.01, 1e-3, dec)
    XCUT[f"expression {dec}"] = (
        (16, 16, 16), True, lambda p: p.PDE({"c": "0.1 * laplace(c) - c**3 + c"}), "c", (0, 1),
        0.01, 1e-3, dec)


def _state(pkg, case, seed=11):
    shape, periodic, _, labels, (low, high), _, _, _ = case
    grid = pkg.CartesianGrid([(0, 1)] * 3, shape, periodic=periodic)
    gen = np.random.default_rng(seed)
    extra = {"dtype": torch.float64} if pkg is tpde else {}
    fields = [pkg.ScalarField(grid, gen.uniform(low, high, shape), label=label, **extra)
              for label in labels]
    return fields[0] if len(fields) == 1 else pkg.FieldCollection(fields)


def _leaves(state):
    fields = list(state) if hasattr(state, "fields") else [state]
    return [np.asarray(f.data) for f in fields]


def _jax_decomposed(case, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PDE_TPU_DISABLE_FUSED", raising=False)
    _, _, make_eq, _, _, t_range, dt, decomposition = case
    solver = JaxEulerSolver(make_eq(jpde), decomposition=decomposition)
    result = JaxController(solver, t_range=t_range, tracker=None).run(_state(jpde, case), dt=dt)
    assert solver.info.get("fused_step") is True
    return _leaves(result)


def _port(case, **kwargs):
    _, _, make_eq, _, _, t_range, dt, _ = case
    result, info = make_eq(tpde).solve(
        _state(tpde, case), t_range=t_range, dt=dt, tracker=None, ret_info=True, **kwargs)
    return _leaves(result), info["solver"]


def _check(case, monkeypatch, expected_jax):
    decomposition = case[-1]
    launches = (e3.affine_laplace_ext_3d.launches, e3.multi_stencil_ext_3d.launches)
    copies = HaloExchange.copies
    got, info = _port(case, decomposition=decomposition)
    assert info["fused_step"] is True and info["decomposition"] == decomposition
    # on the CPU the wrappers run the plain versions: no kernel launch
    assert (e3.affine_laplace_ext_3d.launches, e3.multi_stencil_ext_3d.launches) == launches
    assert HaloExchange.copies > copies
    serial, serial_info = _port(case)
    assert serial_info["fused_step"] is True and "decomposition" not in serial_info
    for a, b in zip(got, serial, strict=True):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(got, expected_jax, strict=True):
        np.testing.assert_allclose(a, b, **TOL_JAX)


@pytest.mark.parametrize("case_id", CASES)
def test_decomposed_3d_matches_jax_and_serial(case_id, monkeypatch):
    case = CASES[case_id]
    _check(case, monkeypatch, _jax_decomposed(case, monkeypatch))


@pytest.mark.parametrize("case_id", XCUT)
def test_xcut_matches_jax_ychunk_route_and_serial(case_id, monkeypatch):
    """x-cut meshes: ``pde_tpu`` takes its y-chunked kernel's ``ext_x`` mode
    (#4; the spy sees it), the port its 3D ext kernels."""
    monkeypatch.setenv("PDE_TPU_YCHUNK_SHARDED", "1")
    calls = []
    orig = jax_pallas._make_ychunk_multi_window_3d

    def spy(*args, **kwargs):
        if kwargs.get("ext_x"):
            calls.append(kwargs.get("band"))
        return orig(*args, **kwargs)

    monkeypatch.setattr(jax_pallas, "_make_ychunk_multi_window_3d", spy)
    case = XCUT[case_id]
    expected = _jax_decomposed(case, monkeypatch)
    assert calls, "pde_tpu's halo-extended y-chunked kernel never engaged"
    _check(case, monkeypatch, expected)


def test_windows_take_the_3d_ext_kernels():
    """The drivers' ladders, halos and kernels on 3D meshes."""
    from pde_tpu_torch.parallel import GridMesh

    grid = tpde.UnitGrid([16, 8, 8], periodic=True)
    state = tpde.ScalarField(grid, 0.1, dtype=torch.float64)
    mesh = GridMesh(grid, [2, 2, 2])
    window = tpde.DiffusionPDE(0.1).make_fused_euler_window(state, 1e-3, mesh=mesh)
    assert window.sharded and [s.k for s in window.specs] == [4, 2, 1]
    assert isinstance(window.specs[0], e3.AffineExt3DSpec) and window.specs[0].halo == 4
    assert window.exchange.halo == 4
    window = tpde.PDE(GRAD).make_fused_euler_window(state, 1e-3, mesh=mesh)
    assert isinstance(window.program, e3.ExtStencilProgram3D)
    assert window.program.depth == 2 and [s.k for s in window.specs] == [1]
    # blocks of one cell along x cannot supply a two-cell halo
    thin = tpde.ScalarField(tpde.UnitGrid([8, 8, 8], periodic=True), 0.1, dtype=torch.float64)
    with pytest.raises(tpde.KernelUnsupportedError, match="Shard too small"):
        tpde.PDE(GRAD).make_fused_euler_window(thin, 1e-3, mesh=GridMesh(thin.grid, [8, 1, 1]))
    # a 37-step window of blocks one cell wide runs at k = 1
    window = tpde.DiffusionPDE(0.1).make_fused_euler_window(
        thin, 1e-3, mesh=GridMesh(thin.grid, [8, 1, 1]))
    assert [s.k for s in window.specs] == [1] and window.exchange.halo == 1


def test_ragged_blocks_with_mixed_faces_equal_serial():
    """EulerSolver(decomposition=) on a 12x10x14 grid cut [2, 2, 2] into
    6x5x7 blocks, with Dirichlet, Neumann, Robin and curvature faces; 37 steps
    over the ladder (4, 2, 1)."""
    grid = tpde.CartesianGrid([(0, 3), (0, 2), (0, 1)], (12, 10, 14))
    state = tpde.ScalarField(grid, np.random.default_rng(2).random((12, 10, 14)),
                             dtype=torch.float64)
    bc = {"x": {"curvature": 0.5}, "y-": {"value": -1}, "y+": {"type": "mixed", "value": 3.0},
          "z": {"derivative": 0.2}}
    for eq in (tpde.DiffusionPDE(0.002, bc=bc), tpde.PDE(EXPR_BC, bc=bc)):
        solver = tpde.EulerSolver(eq, decomposition=[2, 2, 2])
        result = tpde.Controller(solver, t_range=0.037, tracker=None).run(state, dt=1e-3)
        assert solver.info["fused_step"] is True and solver.info["steps"] == 37
        serial = eq.solve(state, t_range=0.037, dt=1e-3, tracker=None)
        np.testing.assert_allclose(result.data.numpy(), serial.data.numpy(), **TOL)
