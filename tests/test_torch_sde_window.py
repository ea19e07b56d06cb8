"""The module holding the two Euler-Maruyama kernels (``ops/cuda_sde_2d``)
and their noise stream (``ops/philox``).

Kernel #10 (staged increments): one k-step pass of the port's window, through
the kernel's plain version and through the emulation of its tiling, is held
against ``pde_tpu``'s ``make_fused_sde_stencil_window_2d`` in interpret mode
on the same numpy increments (fp64, <= 1e-12); the ladder windows of both
packages are compared for step counts that are not multiples of k. Kernel #9
(increments drawn in the kernel): Philox4x32-10's known answers, the three
laws' moments, the tile emulation against the plain version under two tile
sizes and across the periodic seam, and the window's step bookkeeping.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pde_tpu as jpde
import pde_tpu_torch as tpde
from pde_tpu_torch.models.base import make_increment_draw
from pde_tpu_torch.ops import cuda_sde_2d as sde
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.ops import philox

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for the CPU."""
    with tpde.config({"device": "cpu"}):
        yield


TOL = dict(rtol=1e-12, atol=1e-12)
NOFLUX = ("CartesianGrid", ([(0, 2), (0, 3)], [16, 24]), False)
PERIODIC = ("UnitGrid", ([16, 16],), True)
# id: (make the model in one package, grid class, grid args, periodic)
CASES = {
    "diffusion-periodic": (lambda p: p.DiffusionPDE(0.1, noise=0.5), *PERIODIC),
    "diffusion-noflux": (lambda p: p.DiffusionPDE(0.1, noise=0.5), *NOFLUX),
    "kpz-periodic": (lambda p: p.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1), *PERIODIC),
    "kpz-noflux": (lambda p: p.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1), *NOFLUX),
}
DT = 1e-3


def _data(case_id):
    _, cls, args, periodic = CASES[case_id]
    shape = getattr(jpde, cls)(*args, periodic=periodic).shape
    return np.random.default_rng(sorted(CASES).index(case_id)).uniform(-0.5, 0.5, shape)


def _increments(case_id, steps):
    shape = _data(case_id).shape
    return np.random.default_rng(100 + sorted(CASES).index(case_id)).normal(
        0.0, 0.05, (steps, *shape)
    )


def _states(case_id):
    _, cls, args, periodic = CASES[case_id]
    jstate = jpde.ScalarField(getattr(jpde, cls)(*args, periodic=periodic), _data(case_id))
    tstate = tpde.field_from_state(jstate.attributes_serialized, np.asarray(jstate.data))
    return jstate, tstate


def _torch_window(case_id):
    """The port's fused window of the case (staged increments)."""
    _, tstate = _states(case_id)
    window = CASES[case_id][0](tpde).make_fused_euler_window(tstate, DT)
    assert window.needs_key and window.program.noise == "staged"
    return window, tstate.data


@functools.cache
def _jax_parts(case_id):
    """``pde_tpu``'s one-field Euler step lowered through its stencil helpers,
    as its fused SDE window builds it (``models/pde.py`` ``_emit_fused_window``)."""
    jstate, _ = _states(case_id)
    rhs, bc = CASES[case_id][0](jpde)._fused_rhs()
    jeq = jpde.PDE({"c": rhs}, bc=bc)
    _, grid, exprs, var_map, _, bc_inputs, depth, _, make_get_bc = (
        jeq._fused_stencil_lowering(jstate, None)
    )

    def make_step(ops):
        rhs_fn, d = jeq._lower_stencil_expr(exprs[0], var_map, ops, make_get_bc("c"))

        def step(work):
            rate = rhs_fn([work])
            center = ops.trim(work, d)
            return center + DT * jnp.broadcast_to(jnp.asarray(rate), center.shape)

        return step

    return jstate, grid, make_step, depth, bc_inputs


@functools.cache
def _jax_pass(case_id):
    """One pass of ``pde_tpu``'s kernel #10 in interpret mode: (k, result)."""
    from pde_tpu.ops.pallas_cartesian import make_fused_sde_stencil_window_2d

    jstate, grid, make_step, depth, bc_inputs = _jax_parts(case_id)
    window_k, k = make_fused_sde_stencil_window_2d(
        grid, make_step, depth, dtype=np.float64, interpret=True, bc_inputs=bc_inputs
    )
    return k, np.asarray(window_k(jstate.data, _increments(case_id, k)))


@pytest.mark.parametrize("case_id", CASES)
def test_plain_pass_matches_jax_kernel(case_id, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    k, expected = _jax_pass(case_id)
    window, data = _torch_window(case_id)
    spec = next(s for s in window.specs if s.k == k)
    launches = sde.sde_stencil_2d.launches
    got = sde.sde_stencil_2d(data, torch.tensor(_increments(case_id, k)), spec)
    assert sde.sde_stencil_2d.launches == launches  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), expected, **TOL)


@pytest.mark.parametrize("case_id", CASES)
def test_tile_emulation_matches_jax_kernel(case_id, monkeypatch):
    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    k, expected = _jax_pass(case_id)
    window, data = _torch_window(case_id)
    spec = next(s for s in window.specs if s.k == k)
    got = sde.sde_stencil_2d_tiled(data, torch.tensor(_increments(case_id, k)), spec, tile=8)
    np.testing.assert_allclose(got.numpy(), expected, **TOL)


@pytest.mark.parametrize("steps", [5, 37])
@pytest.mark.parametrize("case_id", ["kpz-periodic", "kpz-noflux"])
def test_ladder_window_matches_jax(case_id, steps, monkeypatch):
    """Both packages' chunked windows on the same increments, looked up by
    global step index: the remainder passes and index bookkeeping agree."""
    from pde_tpu.ops.pallas_cartesian import make_chunked_sde_window_2d

    monkeypatch.setenv("PDE_TPU_PALLAS_INTERPRET", "1")
    table = _increments(case_id, steps)
    jstate, grid, make_step, depth, bc_inputs = _jax_parts(case_id)
    jwindow = make_chunked_sde_window_2d(
        grid, make_step, depth, lambda key, idx: jnp.asarray(table)[idx],
        dtype=np.float64, interpret=True, bc_inputs=bc_inputs,
    )
    expected = np.asarray(jwindow(jstate.data, jax.random.key(0), steps))

    fused, data = _torch_window(case_id)
    stencil = fused.program.stencil
    seen = []

    def noise_fn(window_seed, indices, like):
        seen.extend(indices)
        return torch.as_tensor(table[list(indices)])

    window = sde.make_chunked_sde_window_2d(
        stencil.grid, stencil.make_step, stencil.depth, noise_fn, dtype=torch.float64
    )
    got = window(data, 123, steps)
    assert seen == list(range(steps))
    np.testing.assert_allclose(got.numpy(), expected, **TOL)


@pytest.mark.parametrize("tile", [4, 8, 64])
@pytest.mark.parametrize("case_id", ["diffusion-noflux", "kpz-periodic"])
def test_staged_tile_emulation_matches_plain_at_every_k(case_id, tile):
    """Tiles smaller than the halo (their halos wrap the periodic seam more
    than once), ragged edge tiles, and one tile over the whole grid."""
    window, data = _torch_window(case_id)
    for spec in window.specs:
        noise = torch.tensor(_increments(case_id, spec.k))
        expected = sde.sde_stencil_2d_plain(data, noise, spec)
        got = sde.sde_stencil_2d_tiled(data, noise, spec, tile=tile)
        np.testing.assert_allclose(got.numpy(), expected.numpy(), **TOL)


# -- kernel #9: Philox4x32-10 and the laws ------------------------------------------------
@pytest.mark.parametrize(
    "counter,key,expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(counter, key, expected):
    """Random123's ``kat_vectors`` for Philox4x32-10."""
    assert tuple(int(w) for w in philox.philox4x32_10(counter, key)) == expected


def _moments_within(x: torch.Tensor, third: float = 0.0):
    """Mean 0, variance 1 and third moment `third`, each within 6 standard
    errors (estimated from the sample itself)."""
    n = x.numel()
    for power, target in ((1, 0.0), (2, 1.0), (3, third)):
        values = x.double().reshape(-1) ** power
        se = float(values.std()) / math.sqrt(n)
        assert abs(float(values.mean()) - target) <= 6 * se + 1e-12, (power, float(values.mean()))


@pytest.mark.parametrize("law", philox.LAWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_philox_laws_moments(law, dtype):
    cells = torch.arange(256)
    z = philox.cell_increments(law, (12345, 678), 9, cells, cells, dtype, 1.0)
    assert z.shape == (256, 256) and z.dtype == dtype
    _moments_within(z)
    if law == "rademacher":
        assert set(z.unique().tolist()) == {-1.0, 1.0}
    if law == "irwin4":
        assert float(z.abs().max()) <= 2 * math.sqrt(3.0)


@pytest.mark.parametrize("law", philox.LAWS)
def test_staged_draw_laws_moments(law):
    """The laws of the staged stream (torch's generator), as configured."""
    with tpde.config({"sde.increment_dist": law}):
        draw = make_increment_draw()
    z = draw(torch.Generator().manual_seed(5), torch.empty(256, 256, dtype=torch.float64))
    _moments_within(z)
    if law == "rademacher":
        assert set(z.unique().tolist()) == {-1.0, 1.0}


def test_philox_words_depend_on_every_counter_and_key_word():
    base = [int(w) for w in philox.philox4x32_10((3, 4, 5, 0), (6, 7))]
    for changed in [((4, 4, 5, 0), (6, 7)), ((3, 5, 5, 0), (6, 7)), ((3, 4, 6, 0), (6, 7)),
                    ((3, 4, 5, 0), (7, 7)), ((3, 4, 5, 0), (6, 8))]:
        assert [int(w) for w in philox.philox4x32_10(*changed)] != base


def _kernel_noise_window(case_id, law):
    _, tstate = _states(case_id)
    with tpde.config({"sde.increment_dist": law}):
        window = CASES[case_id][0](tpde).make_fused_euler_window(tstate, DT)
    assert window.program.noise == law and window.program.library == "sde_kernel_noise_2d"
    return window, tstate.data


@pytest.mark.parametrize("tile", [4, 16])
@pytest.mark.parametrize("law", ["irwin4", "rademacher"])
@pytest.mark.parametrize("case_id", ["kpz-periodic", "kpz-noflux"])
def test_kernel_noise_tile_emulation_matches_plain(case_id, law, tile):
    """The stream is a function of the global cell: tiles whose halos cross
    the periodic seam add their neighbours' increments."""
    window, data = _kernel_noise_window(case_id, law)
    spec = window.specs[0]
    ctl = (0xDEADBEEF, 17, 4242)
    expected = sde.sde_kernel_noise_2d_plain(data, ctl, spec)
    got = sde.sde_kernel_noise_2d_tiled(data, ctl, spec, tile=tile)
    np.testing.assert_allclose(got.numpy(), expected.numpy(), **TOL)


def test_kernel_noise_box_muller_tile_emulation_matches_plain():
    with tpde.config({"sde.kernel_noise": "on"}):
        window, data = _kernel_noise_window("diffusion-periodic", "normal")
    spec = window.specs[1]
    expected = sde.sde_kernel_noise_2d_plain(data, (1, 2, 3), spec)
    got = sde.sde_kernel_noise_2d_tiled(data, (1, 2, 3), spec, tile=4)
    np.testing.assert_allclose(got.numpy(), expected.numpy(), **TOL)


@pytest.mark.parametrize("steps", [8, 37])
def test_kernel_noise_window_counts_global_steps(steps):
    """The ladder window equals single-step passes keyed by global step
    0, 1, ..., steps - 1 under the window's seed words: the result does not
    depend on how the steps were grouped into passes."""
    window, data = _kernel_noise_window("kpz-periodic", "irwin4")
    one = window.specs[-1]
    assert one.k == 1 and window.specs[0].k == 8
    key = philox.seed_words(99)
    expected = data
    for i in range(steps):
        expected = sde.sde_kernel_noise_2d_plain(expected, (*key, i), one)
    got = window(data, 99, steps)
    np.testing.assert_allclose(got.numpy(), expected.numpy(), **TOL)


def test_seeds_are_distinct_and_mixed():
    seeds = {philox.step_seed(w, i) for w in range(4) for i in range(256)}
    assert len(seeds) == 4 * 256
    assert len({s & philox.MASK32 for s in seeds}) == 4 * 256  # the CPU generator's bits
    assert philox.seed_words(1) != philox.seed_words(2)


# -- the emitter, gates and wrappers ---------------------------------------------------------
def test_emitter_names_policies_and_ladder():
    staged, _ = _torch_window("kpz-noflux")
    kernel_noise, _ = _kernel_noise_window("kpz-noflux", "rademacher")
    assert "StagedNoise<float>" in staged.program.source
    assert "sde_stencil_2d_f64" in staged.program.source
    assert "PhiloxNoise<double, pde_tpu_torch::kRademacher>" in kernel_noise.program.source
    assert "sde_kernel_noise_2d_f32" in kernel_noise.program.source
    assert staged.program.digest != kernel_noise.program.digest
    for k in staged.program.stencil.ladder:
        assert f"launch<Program, float, {k}," in staged.program.source
    # the square window's program struct of the same rhs, which the SDE source
    # includes (the multi-field kernels' own entry points left with the row march)
    assert staged.program.stencil.source in staged.program.source
    assert "level(const pde_tpu_torch::Level<T" in staged.program.stencil.source
    assert "StagedNoise" not in staged.program.stencil.source


def test_build_without_nvcc_raises(monkeypatch):
    """No fallback: a build that cannot find nvcc raises."""
    window, _ = _kernel_noise_window("kpz-periodic", "irwin4")
    monkeypatch.setenv("PDE_TPU_TORCH_NVCC", "/nonexistent/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        cs.build_programs([window.program])


def test_wrappers_check_inputs():
    window, data = _torch_window("kpz-periodic")
    spec = window.specs[0]
    noise = torch.zeros((spec.k, *spec.shape), dtype=torch.float64)
    with pytest.raises(ValueError, match="increments"):
        sde.sde_stencil_2d(data, noise[:1], spec)
    with pytest.raises(ValueError):
        sde.sde_stencil_2d(data.float(), noise, spec)
    with pytest.raises(ValueError, match="in the kernel"):
        sde.sde_stencil_2d(data, noise, _kernel_noise_window("kpz-periodic", "irwin4")[0].specs[0])
    with pytest.raises(RuntimeError, match="No SDE window kernel"):
        sde.sde_stencil_2d(data.to("meta"), noise.to("meta"), spec)
    out = torch.empty_like(data)
    assert sde.sde_stencil_2d(data, noise, spec, out=out) is out
    torch.testing.assert_close(out, sde.sde_stencil_2d_plain(data, noise, spec), rtol=0, atol=0)
    kn_spec = _kernel_noise_window("kpz-periodic", "irwin4")[0].specs[0]
    with pytest.raises(ValueError, match="uint32"):
        sde.sde_kernel_noise_2d(data, (1, 2, -1), kn_spec)
    with pytest.raises(ValueError, match="staged"):
        sde.sde_kernel_noise_2d(data, (1, 2, 3), spec)
    with pytest.raises(ValueError, match="scale"):
        sde.sde_spec(window.program, 8, torch.float64, scale=0.1)
    with pytest.raises(tpde.KernelUnsupportedError, match="ladder"):
        sde.sde_spec(window.program, 3, torch.float64)
