"""The PyTorch port imports neither JAX nor the JAX package.

The machine with the GPU has no JAX, so ``pde_tpu_torch`` and
``chip_smoke.py`` must run with both blocked.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pde_tpu_torch as tpde

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pde_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _blocked(module: str) -> bool:
    return module in ("jax", "pde_tpu") or module.startswith(("jax.", "jaxlib", "pde_tpu."))


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pde_tpu'] = None\n"
        "import importlib, pkgutil\n"
        "import pde_tpu_torch as pde\n"
        "pde.config['device'] = 'cpu'\n"
        "for mod in pkgutil.walk_packages(pde.__path__, 'pde_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "assert 'pde_tpu_torch.ops.cuda_stencil_2d' in sys.modules\n"
        "grid = pde.UnitGrid([8, 8], periodic=True)\n"
        "state = pde.ScalarField.random_uniform(grid, rng=1)\n"
        "pde.DiffusionPDE(0.1).solve(state, t_range=0.3, dt=0.1, tracker=None)\n"
        "pde.CahnHilliardPDE().solve(state, t_range=0.01, dt=1e-3, tracker=None)\n"
        "pair = pde.FieldCollection([state, state.copy()], labels=['u', 'v'])\n"
        "eq = pde.PDE({'u': 'laplace(u) - u * v', 'v': 'gradient_squared(u)'})\n"
        "eq.solve(pair, t_range=0.01, dt=1e-3, tracker=None)\n"
        "assert eq.diagnostics['solver']['fused_step']\n"
        "assert 'pde_tpu_torch.ops.cuda_sde_2d' in sys.modules\n"
        "assert 'pde_tpu_torch.ops.philox' in sys.modules\n"
        "kpz = pde.KPZInterfacePDE(noise=0.1, rng=2)\n"
        "with pde.config({'sde.increment_dist': 'irwin4'}):\n"
        "    kpz.solve(state, t_range=0.01, dt=1e-3, tracker=None)\n"
        "assert kpz.diagnostics['solver']['fused_step']\n"
        "cube = pde.ScalarField.random_uniform(pde.UnitGrid([8, 8, 8], periodic=True), rng=3)\n"
        "for eq3 in (pde.DiffusionPDE(0.1), pde.AllenCahnPDE(0.5)):\n"
        "    eq3.solve(cube, t_range=0.003, dt=1e-3, tracker=None)\n"
        "    assert eq3.diagnostics['solver']['fused_step']\n"
        "assert 'pde_tpu_torch.ops.cuda_cartesian_3d' in sys.modules\n"
        "assert 'pde_tpu_torch.ops.cuda_stencil_3d' in sys.modules\n"
        "vec = pde.VectorField.random_uniform(grid, rng=4)\n"
        "assert isinstance(state.gradient('periodic'), pde.VectorField)\n"
        "assert isinstance(vec.gradient('periodic'), pde.Tensor2Field)\n"
        "op = pde.get_backend('cuda').make_operator(grid, 'vector_gradient', 'periodic')\n"
        "assert op(vec.data).shape == (2, 2, 8, 8)\n"
        "assert 'pde_tpu_torch.ops.cuda_stencil_op_2d' in sys.modules\n"
        "gl = pde.PDE({'u': '0.2 * vector_laplace(u) + u - dot(u, u) * u'})\n"
        "gl.solve(vec, t_range=0.01, dt=1e-3, tracker=None)\n"
        "assert gl.diagnostics['solver']['fused_step']\n"
        "assert sys.modules['jax'] is None and sys.modules['pde_tpu'] is None\n"
        "assert not any(m.startswith(('jax.', 'pde_tpu.')) for m in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr


def test_parallel_and_mpi_import_with_jax_blocked():
    """The mesh, the exchange and the MPI helpers run decomposed 2D and 3D
    solves with JAX and the JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pde_tpu'] = None\n"
        "import pde_tpu_torch.parallel\n"
        "import pde_tpu_torch.utils.mpi as mpi\n"
        "import pde_tpu_torch as pde\n"
        "assert mpi.size == 1 and mpi.is_main\n"
        "pde.config['device'] = 'cpu'\n"
        "pde.config['parallel.devices_per_device'] = 4\n"
        "grid = pde.UnitGrid([8, 8], periodic=True)\n"
        "state = pde.ScalarField.random_uniform(grid, rng=1)\n"
        "eq = pde.DiffusionPDE(0.1)\n"
        "eq.solve(state, t_range=0.3, dt=0.1, tracker=None, solver='explicit_sharded')\n"
        "assert eq.diagnostics['solver']['decomposition'] == [2, 2]\n"
        "pair = pde.FieldCollection([state, state.copy()], labels=['u', 'v'])\n"
        "eq = pde.PDE({'u': 'laplace(u) - u * v', 'v': 'gradient_squared(u)'})\n"
        "eq.solve(pair, t_range=0.01, dt=1e-3, tracker=None, decomposition=[1, 2])\n"
        "assert eq.diagnostics['solver']['fused_step']\n"
        "assert 'pde_tpu_torch.ops.cuda_ext_2d' in sys.modules\n"
        "pde.config['parallel.devices_per_device'] = 8\n"
        "cube = pde.ScalarField.random_uniform(pde.UnitGrid([8, 8, 8], periodic=True), rng=2)\n"
        "for eq3 in (pde.DiffusionPDE(0.1), pde.AllenCahnPDE(0.5)):\n"
        "    eq3.solve(cube, t_range=0.003, dt=1e-3, tracker=None, decomposition=[2, 2, 2])\n"
        "    assert eq3.diagnostics['solver']['fused_step']\n"
        "assert 'pde_tpu_torch.ops.cuda_ext_3d' in sys.modules\n"
        "assert not any(m.startswith(('jax.', 'pde_tpu.')) for m in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_blocked(name) for name in names), (path, names)


def test_chip_smoke_without_cuda_prints_no_result():
    """Without a CUDA device chip_smoke.py fails before printing a result."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
