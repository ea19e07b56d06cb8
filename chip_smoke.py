#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pde_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

1. device: the CUDA device's name, and its name and power limit from
   nvidia-smi; the torch, CUDA and sympy versions;
2. build: nvcc builds, all at once, ``pde_tpu_torch/csrc/affine_laplace_2d.cu``
   and one library per rhs of the generated multi-field kernel (template
   ``pde_tpu_torch/csrc/multi_stencil_2d.cuh``), for sm_90a;
3. kernel vs plain (diffusion): the affine Laplacian kernel against its plain
   PyTorch version on the card, on the same inputs, at the main path's shapes
   and at edge cases;
4. main path (diffusion): 4096² periodic fp32 ``DiffusionPDE(0.1)`` through
   ``EulerSolver(backend="cuda").make_stepper`` for 37 steps, and the README
   flow ``eq.solve(...)`` on a 1024² no-flux grid; the kernel's launch count
   over this phase must be positive;
5. throughput (diffusion): cell-updates/s of the main path and of the plain
   version;
6. kernel vs plain (multi-field): the generated kernel against its plain
   version for Cahn-Hilliard (also no-flux on an anisotropic ragged grid),
   Brusselator, gradient/divergence, dot of gradients and mixed per-side
   BCs, fp32 and fp64, down to a 16² grid;
7. main path (Cahn-Hilliard): the expression PDE
   ``laplace(c**3 - c - laplace(c))`` on a 1024² periodic fp32 state through
   ``EulerSolver(backend="cuda").make_stepper`` and ``eq.solve(...)``, and
   ``CahnHilliardPDE().solve(...)``, against the plain step loop on the card;
   the generated kernel's launch count over this phase must be positive;
8. throughput (Cahn-Hilliard): time-to-solution of 1024² to t = 100 at
   dt = 1e-3, cell-updates/s at 4096², and ms per pass by k for kernel and
   plain version;
9. kernel vs plain (SDE): the two Euler-Maruyama kernels against their plain
   versions on the same inputs, for stochastic KPZ (periodic 4096² and 16²,
   no-flux on an anisotropic ragged 1000x1530 grid) and diffusion, fp32 and
   fp64, at every k of the ladder: ``sde_stencil_2d`` on staged increments,
   ``sde_kernel_noise_2d`` under each increment law; and the in-kernel
   stream's independence of the tiling (one k = 8 pass against eight k = 1
   passes, on grids whose tiles touch the periodic seam);
10. main path (SDE): 4096² periodic fp32 ``KPZInterfacePDE(nu=1, lmbda=1,
   noise=0.1)`` through ``EulerSolver(backend="cuda").make_stepper`` (2048
   steps) and ``eq.solve(...)``, once with ``normal`` increments (staged
   kernel) and once with ``irwin4`` (in-kernel noise); each kernel's launch
   count over its run must be positive, the state finite and rough, and the
   staged run equal to the plain step loop on the same stream; then the
   moments of one k = 8 pass of ``DiffusionPDE(0.0, noise=1.0)``'s step from
   zero (mean, variance against k·scale², third moment, within 6 standard
   errors) under each route;
11. throughput (SDE): cell-updates/s of 2048-step windows at 4096² fp32 for
   each increment route, ms per pass of each kernel and of its plain version,
   the staged increments' cost, and the plain loop's rate.

The last lines are a JSON object describing the kernels, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# short runs in fp32: allowed error per step, relative to max|f|
F32_STEP_RTOL = 1e-6
# fp32 over 1000 steps on 256² (the tolerance of pde_tpu's hardware lane)
F32_LONG_TOL = 2e-5
F64_TOL = 1e-12
# Box-Muller increments drawn in the kernel: CUDA's log, cos and sqrt may
# differ from torch's by an ulp or two, so per step relative to max|f|
F32_BOX_MULLER_STEP_RTOL = 2e-6
F64_BOX_MULLER_TOL = 1e-11
# moment checks: allowed distance in standard errors
MOMENT_SIGMAS = 6.0
# increment routes of the SDE window: label, config, kernel
SDE_ROUTES = (
    ("normal", {}, "sde_stencil_2d"),
    ("irwin4", {"sde.increment_dist": "irwin4"}, "sde_kernel_noise_2d"),
    ("rademacher", {"sde.increment_dist": "rademacher"}, "sde_kernel_noise_2d"),
    ("normal (Box-Muller in the kernel)", {"sde.kernel_noise": "on"}, "sde_kernel_noise_2d"),
)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def _cuda_ms(torch, fn, repeats: int) -> float:
    """Mean milliseconds of `fn()` on the card, timed with CUDA events."""
    fn()  # warm up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _ptxas(log: str) -> str:
    """ptxas' registers and spills, one entry per compiled kernel."""
    lines = log.splitlines()
    entries = []
    for i, line in enumerate(lines):
        if "ptxas info    : Used" in line:
            spill = lines[i - 1].strip() if i and "spill" in lines[i - 1] else ""
            entries.append(line.split("ptxas info    : ", 1)[1] + (f" ({spill})" if spill else ""))
    return " | ".join(entries)


def _multi_field_cases(pde, torch, device) -> list[dict]:
    """The rhs set of the multi-field kernel checks: a window per case, on
    seeded inputs on the card."""
    import numpy as np

    gen = np.random.default_rng(10)
    f32, f64 = torch.float32, torch.float64
    ch = pde.PDE({"c": "laplace(c**3 - c - laplace(c))"})
    ch_noflux = pde.CahnHilliardPDE(bc_c={"derivative": 0}, bc_mu={"derivative": 0})
    brusselator = pde.PDE({"u": "laplace(u) + 1 - 4 * u + u**2 * v",
                           "v": "0.1 * laplace(v) + 3 * u - u**2 * v"})
    mixed = {"x-": {"value": 1}, "x+": {"derivative": 0},
             "y-": {"derivative": 0.2}, "y+": {"type": "mixed", "value": 1.0, "const": 0.3}}
    specs = [
        ("cahn-hilliard 1024^2 periodic", ch, pde.UnitGrid([1024, 1024], periodic=True),
         1, f32, 1e-3, (-0.1, 0.1)),
        ("cahn-hilliard no-flux anisotropic 1000x1530", ch_noflux,
         pde.CartesianGrid([(0, 500), (0, 1530)], [1000, 1530]), 1, f32, 1e-4, (-0.1, 0.1)),
        ("cahn-hilliard no-flux anisotropic 1000x1530", ch_noflux,
         pde.CartesianGrid([(0, 500), (0, 1530)], [1000, 1530]), 1, f64, 1e-4, (-0.1, 0.1)),
        ("brusselator no-flux 512^2", brusselator, pde.UnitGrid([512, 512]), 2, f32, 1e-3,
         (0.5, 1.5)),
        ("divergence(gradient(c)) no-flux 256^2",
         pde.PDE({"c": "0.001 * divergence(gradient(c))"}, bc={"derivative": 0.1}),
         pde.UnitGrid([256, 256]), 1, f32, 1e-2, (0.0, 1.0)),
        ("dot(gradient(u), gradient(v)) 256^2",
         pde.PDE({"u": "0.1 * laplace(u) + 0.05 * dot(gradient(u), gradient(v))",
                  "v": "0.1 * laplace(v)"}),
         pde.UnitGrid([256, 256], periodic=True), 2, f32, 1e-2, (0.0, 1.0)),
        ("mixed per-side BCs 256^2", pde.PDE({"c": "0.001 * laplace(c) - 0.1 * c"}, bc=mixed),
         pde.CartesianGrid([(0, 1), (0, 1)], [256, 256]), 1, f32, 1e-3, (0.0, 1.0)),
        ("cahn-hilliard 16^2 periodic (halo wraps)", ch, pde.UnitGrid([16, 16], periodic=True),
         1, f32, 1e-3, (-0.1, 0.1)),
        ("cahn-hilliard 16^2 periodic (halo wraps)", ch, pde.UnitGrid([16, 16], periodic=True),
         1, f64, 1e-3, (-0.1, 0.1)),
    ]
    cases = []
    for label, eq, grid, n_fields, dtype, dt, (lo, hi) in specs:
        datas = [torch.as_tensor(gen.uniform(lo, hi, grid.shape), dtype=dtype, device=device)
                 for _ in range(n_fields)]
        fields = [pde.ScalarField(grid, d) for d in datas]
        state = fields[0] if n_fields == 1 else pde.FieldCollection(fields)
        window = eq.make_fused_euler_window(state, dt)
        cases.append({"label": label, "window": window, "datas": datas, "dtype": dtype})
    return cases


def _sde_cases(pde, torch, device) -> list[dict]:
    """The Euler-Maruyama kernel checks: a window per (rhs, grid, dtype,
    route), on seeded inputs on the card."""
    import numpy as np

    gen = np.random.default_rng(11)
    f32, f64 = torch.float32, torch.float64
    periodic_4k = pde.UnitGrid([4096, 4096], periodic=True)
    periodic_16 = pde.UnitGrid([16, 16], periodic=True)
    ragged = pde.CartesianGrid([(0, 500), (0, 1530)], [1000, 1530])
    specs = [
        ("kpz 4096^2 periodic", "kpz", periodic_4k, f32),
        ("kpz no-flux anisotropic 1000x1530", "kpz", ragged, f32),
        ("kpz no-flux anisotropic 1000x1530", "kpz", ragged, f64),
        ("diffusion 1024^2 periodic", "diffusion", pde.UnitGrid([1024, 1024], periodic=True), f32),
        ("kpz 16^2 periodic (halo wraps the seam)", "kpz", periodic_16, f32),
        ("kpz 16^2 periodic (halo wraps the seam)", "kpz", periodic_16, f64),
    ]
    cases = []
    for label, rhs, grid, dtype in specs:
        data = torch.as_tensor(gen.uniform(-0.5, 0.5, grid.shape), dtype=dtype, device=device)
        state = pde.ScalarField(grid, data)
        for route, cfg, kernel in SDE_ROUTES:
            with pde.config(cfg):
                if rhs == "kpz":
                    eq = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1)
                else:
                    eq = pde.DiffusionPDE(0.1, noise=1.0)
                window = eq.make_fused_euler_window(state, 1e-3)
            cases.append({"label": label, "route": route, "kernel": kernel, "window": window,
                          "data": data, "dtype": dtype})
    return cases


def _zero_rate_windows(pde, sde, torch, grid, dt: float) -> tuple[dict, float]:
    """One window per route for ``DiffusionPDE(0.0, noise=1.0)``: its
    deterministic step is the identity (the expression compiler folds
    ``0.0 * laplace(c)`` away, so the step is built here with the Laplacian
    kept, times zero), its increments those of the model."""
    import math

    def make_step(ops):
        def step(works):
            (work,) = works
            return [ops.trim(work, 1) + 0.0 * ops.lap(work)]

        return step

    noise_fn = pde.PDE({"c": "laplace(c)"}, noise=1.0)._make_staged_noise(
        pde.ScalarField(grid, 0.0), dt)
    scale = math.sqrt(dt * 1.0 / float(grid.cell_volumes[0, 0]))
    windows = {}
    for route, cfg, _ in SDE_ROUTES:
        law = cfg.get("sde.increment_dist", "normal")
        kernel_noise = None if route == "normal" else {"dist": law, "scale": scale}
        windows[route] = sde.make_chunked_sde_window_2d(
            grid, make_step, 1, noise_fn, dtype=torch.float32, kernel_noise=kernel_noise)
    return windows, scale


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")

    import sympy

    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_sde_2d as sde
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    # -- 1. device -------------------------------------------------------------------------
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"sympy {sympy.__version__}; nvidia-smi: {smi}", flush=True)

    # -- 2. build --------------------------------------------------------------------------
    multi = _multi_field_cases(pde, torch, device)
    sde_cases = _sde_cases(pde, torch, device)
    big_sde = pde.UnitGrid([4096, 4096], periodic=True)
    zero_rate, zero_scale = _zero_rate_windows(pde, sde, torch, big_sde, 1e-3)
    sde_programs = [case["window"].program for case in sde_cases] + [
        w.program for w in zero_rate.values()]
    with ThreadPoolExecutor(1) as pool:
        affine_build = pool.submit(cc.build_kernels)
        start = time.perf_counter()
        all_builds = cs.build_programs(
            [case["window"].program for case in multi] + sde_programs)
        multi_seconds = time.perf_counter() - start
        build = affine_build.result()
    multi_builds = all_builds[: len(multi)]
    print(f"[build] affine_laplace_2d nvcc sm_90a: compiled={build['compiled']} in "
          f"{build['seconds']:.2f} s; {_ptxas(build['log'])}", flush=True)
    seen = set()
    for case, built in zip(multi, multi_builds):
        if built["path"] in seen:
            continue
        seen.add(built["path"])
        print(f"[build] multi_stencil_2d ({case['label']}): compiled={built['compiled']} in "
              f"{built['seconds']:.2f} s; {_ptxas(built['log'])}", flush=True)
    for program, built in zip(sde_programs, all_builds[len(multi):]):
        if built["path"] in seen:
            continue
        seen.add(built["path"])
        print(f"[build] {program.library} ({program.noise}, depth {program.stencil.depth}, "
              f"ladder {program.stencil.ladder}): compiled={built['compiled']} in "
              f"{built['seconds']:.2f} s; {_ptxas(built['log'])}", flush=True)
    print(f"[build] {len(seen)} generated libraries built in parallel in {multi_seconds:.2f} s "
          f"(source beside each .so in pde_tpu_torch/_build/)", flush=True)

    # -- 3. kernel vs plain ----------------------------------------------------------------
    gen = np.random.default_rng(0)

    def random_data(shape, dtype):
        return torch.as_tensor(gen.random(shape), dtype=dtype, device=device)

    def check(label, grid, bc, dtype, k, steps=None):
        """Kernel (one pass, or the ladder window for `steps`) vs plain."""
        bcs = None if bc is None else grid.get_boundary_conditions(bc)
        data = random_data(grid.shape, dtype)
        if steps is None:
            spec = cc.affine_laplace_spec(grid, a=1.0, b=0.02, k=k, dtype=dtype, bcs=bcs)
            out = cc.affine_laplace_2d(data, spec)
            ref = cc.affine_laplace_2d_plain(data, spec)
            n_steps = k
        else:
            window = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=0.1, dtype=dtype, bcs=bcs)
            out = window(data, steps)
            spec1 = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=1, dtype=dtype, bcs=bcs)
            ref = data
            for _ in range(steps):
                ref = cc.affine_laplace_2d_plain(ref, spec1)
            n_steps = steps
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        rel = err / scale
        if dtype == torch.float64:
            tol = F64_TOL * scale
        elif steps is not None and steps >= 1000:
            tol = F32_LONG_TOL * (1.0 + scale)
        else:
            tol = F32_STEP_RTOL * n_steps * scale
        ok = bool(torch.isfinite(out).all()) and err <= tol
        print(f"[kernel] {label}: steps={n_steps} max_abs={err:.3e} max_rel={rel:.3e} "
              f"tol={tol:.1e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {label}")
        return err

    f32, f64 = torch.float32, torch.float64
    big = pde.UnitGrid([4096, 4096], periodic=True)
    main_errs = {}
    for k in (1, 2, 4, 8, 16):
        main_errs[k] = check(f"periodic 4096^2 fp32 k={k}", big, None, f32, k)
    grid_1k = pde.UnitGrid([1024, 1024])
    bc_cases = {
        "no-flux": {"derivative": 0},
        "dirichlet 1.5": {"value": 1.5},
        "robin": {"type": "mixed", "value": 2.0, "const": 0.5},
        "curvature": {"curvature": 1.0},
    }
    for label, bc in bc_cases.items():
        check(f"{label} 1024^2 fp32 k=16", grid_1k, bc, f32, 16)
    aniso = pde.CartesianGrid([(0, 1024), (0, 2048)], [1024, 1024], periodic=True)
    check("anisotropic periodic 1024^2 fp32 k=16", aniso, None, f32, 16)
    ragged = pde.CartesianGrid([(0, 1000), (0, 1530)], [1000, 1530], periodic=[False, True])
    ragged_bc = {"x-": {"value": 1.5}, "x+": {"derivative": 0.3}, "y": "periodic"}
    check("ragged 1000x1530 fp32 k=16", ragged, ragged_bc, f32, 16)
    check("ragged 1000x1530 fp32 k=3", ragged, ragged_bc, f32, 3)
    tiny = pde.UnitGrid([32, 32], periodic=True)
    check("periodic 32x32 fp32 k=16 (halo wraps twice)", tiny, None, f32, 16)
    check("no-flux 32x32 fp32 k=16", pde.UnitGrid([32, 32]), {"derivative": 0}, f32, 16)
    check("periodic 1024^2 fp64 k=16", pde.UnitGrid([1024, 1024], periodic=True), None, f64, 16)
    check("no-flux 1024^2 fp64 k=16", grid_1k, {"derivative": 0}, f64, 16)
    check("ragged 1000x1530 fp64 k=16", ragged, ragged_bc, f64, 16)
    check("periodic 256^2 fp32, 1000 steps through the ladder",
          pde.UnitGrid([256, 256], periodic=True), None, f32, None, steps=1000)

    # -- 4. main path ----------------------------------------------------------------------
    eq = pde.DiffusionPDE(diffusivity=0.1)
    state = pde.ScalarField.random_uniform(big, dtype=f32, device=device,
                                           rng=np.random.default_rng(1))
    state_nf = pde.ScalarField.random_uniform(grid_1k, dtype=f32, device=device,
                                              rng=np.random.default_rng(2))
    cc.affine_laplace_2d.launches = 0
    cs.multi_stencil_2d.launches = 0
    solver = pde.EulerSolver(eq, backend="cuda")
    stepper = solver.make_stepper(state, dt=0.1)
    result, t_reached = stepper(state, 0.0, 3.7)
    result_nf = eq.solve(state_nf, t_range=10, dt=0.1, tracker="auto")
    torch.cuda.synchronize()
    launches = cc.affine_laplace_2d.launches
    if not (solver.info.get("fused_step") and eq.diagnostics["solver"].get("fused_step")):
        raise AssertionError("the main path did not take the fused kernel window")
    if launches <= 0:
        raise AssertionError("the main path launched no kernel")

    spec1 = cc.affine_laplace_spec(big, a=1.0, b=0.01, k=1, dtype=f32)
    ref = state.data
    for _ in range(37):
        ref = cc.affine_laplace_2d_plain(ref, spec1)
    bcs_nf = grid_1k.get_boundary_conditions(eq.bc)
    spec_nf = cc.affine_laplace_spec(grid_1k, a=1.0, b=0.01, k=1, dtype=f32, bcs=bcs_nf)
    ref_nf = state_nf.data
    for _ in range(100):
        ref_nf = cc.affine_laplace_2d_plain(ref_nf, spec_nf)
    err_main = float((result.data - ref).abs().max())
    err_nf = float((result_nf.data - ref_nf).abs().max())
    drift = abs(float(result_nf.average) - float(state_nf.average))
    checks = [
        result.data.shape == (4096, 4096) and result.data.dtype == f32,
        bool(torch.isfinite(result.data).all()) and bool(torch.isfinite(result_nf.data).all()),
        abs(t_reached - 3.7) < 1e-9 and solver.info["steps"] == 37,
        err_main <= F32_STEP_RTOL * 37 * float(ref.abs().max()),
        err_nf <= F32_STEP_RTOL * 100 * float(ref_nf.abs().max()),
        drift <= 1e-5,  # no-flux diffusion conserves the mean
    ]
    print(f"[main] 4096^2 periodic fp32, 37 steps (backend='cuda'): max_abs vs plain "
          f"{err_main:.3e}; 1024^2 no-flux solve to t=10: max_abs vs plain {err_nf:.3e}, "
          f"mean drift {drift:.2e}; kernel launches {launches} "
          f"{'ok' if all(checks) else 'FAIL'}", flush=True)
    if not all(checks):
        raise AssertionError(f"main path checks failed: {checks}")

    # -- 5. throughput ---------------------------------------------------------------------
    cells = 4096 * 4096
    window_steps, windows = 2048, 3
    data_w, t_w = stepper(state, 0.0, 0.1 * window_steps)  # warm-up
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(3):
        start = time.perf_counter()
        for _ in range(windows):
            data_w, t_w = stepper(data_w, t_w, t_w + 0.1 * window_steps)
        torch.cuda.synchronize()
        best = max(best, cells * window_steps * windows / (time.perf_counter() - start))
    plain_steps = 64
    plain_best = 0.0
    for _ in range(3):
        f = state.data
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(plain_steps):
            f = cc.affine_laplace_2d_plain(f, spec1)
        torch.cuda.synchronize()
        plain_best = max(plain_best, cells * plain_steps / (time.perf_counter() - start))
    spec16 = cc.affine_laplace_spec(big, a=1.0, b=0.01, k=16, dtype=f32)
    out16 = torch.empty_like(state.data)
    kernel_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d(state.data, spec16, out=out16), 20)
    plain_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d_plain(state.data, spec16), 5)
    print(f"[throughput] 4096^2 periodic fp32 Euler diffusion on {smi}: main path "
          f"{best:.4e} cell-updates/s (best of 3 x {windows} windows of {window_steps} steps); "
          f"plain version {plain_best:.4e} cell-updates/s; one k=16 pass: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)

    # -- 6. kernel vs plain (multi-field) -------------------------------------------------
    def check_multi(label, window, datas, dtype, spec=None, steps=None):
        """Generated kernel (one pass, or the ladder window for `steps`) vs plain."""
        if steps is None:
            out = cs.multi_stencil_2d(datas, spec)
            ref = cs.multi_stencil_2d_plain(datas, spec)
            n_steps = spec.k
        else:
            out = window(datas, steps)
            one = cs.multi_stencil_spec(window.program, 1, dtype)
            ref = datas
            for _ in range(steps):
                ref = cs.multi_stencil_2d_plain(ref, one)
            n_steps = steps
        torch.cuda.synchronize()
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        tol = (F64_TOL if dtype == torch.float64 else F32_STEP_RTOL * n_steps) * scale
        ok = all(bool(torch.isfinite(o).all()) for o in out) and err <= tol
        tile = "" if spec is None else f" tile={spec.tile}"
        print(f"[multi] {label} {str(dtype)[6:]} steps={n_steps}{tile}: max_abs={err:.3e} "
              f"max_rel={err / scale:.3e} tol={tol:.1e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"generated kernel disagrees with its plain version: {label}")
        return err

    multi_errs = {}
    for case in multi:
        window, datas, dtype = case["window"], case["datas"], case["dtype"]
        specs = window.specs if case is multi[0] else window.specs[:1]
        for spec in specs:
            multi_errs[(case["label"], str(dtype), spec.k)] = check_multi(
                case["label"], window, datas, dtype, spec=spec)
    ch_case = multi[0]
    check_multi(ch_case["label"] + " through the ladder", ch_case["window"], ch_case["datas"],
                f32, steps=100)

    # -- 7. main path (Cahn-Hilliard) --------------------------------------------------------
    grid_ch = pde.UnitGrid([1024, 1024], periodic=True)
    state_ch = pde.ScalarField.random_uniform(grid_ch, -0.1, 0.1, dtype=f32, device=device,
                                              rng=np.random.default_rng(0))
    eq_ch = pde.PDE({"c": "laplace(c**3 - c - laplace(c))"})
    model_ch = pde.CahnHilliardPDE()
    cc.affine_laplace_2d.launches = 0
    cs.multi_stencil_2d.launches = 0
    solver_ch = pde.EulerSolver(eq_ch, backend="cuda")
    stepper_ch = solver_ch.make_stepper(state_ch, dt=1e-3)
    result_ch, t_ch = stepper_ch(state_ch, 0.0, 0.3)
    solved_ch = eq_ch.solve(state_ch, t_range=1.0, dt=1e-3, tracker="auto", backend="cuda")
    solved_model = model_ch.solve(state_ch, t_range=1.0, dt=1e-3, tracker="auto",
                                  backend="cuda")
    torch.cuda.synchronize()
    multi_launches = cs.multi_stencil_2d.launches
    fused = (solver_ch.info.get("fused_step") and eq_ch.diagnostics["solver"].get("fused_step")
             and model_ch.diagnostics["solver"].get("fused_step"))
    if not fused:
        raise AssertionError("the Cahn-Hilliard main path did not take the fused kernel window")
    if multi_launches <= 0:
        raise AssertionError("the Cahn-Hilliard main path launched no kernel")

    plain_solver = pde.EulerSolver(eq_ch, backend="numpy")
    plain_ch, _ = plain_solver.make_stepper(state_ch, dt=1e-3)(state_ch, 0.0, 0.3)
    plain_long = eq_ch.solve(state_ch, t_range=1.0, dt=1e-3, tracker=None, backend="numpy")
    torch.cuda.synchronize()
    scale_ch = float(plain_ch.data.abs().max())
    err_stepper = float((result_ch.data - plain_ch.data).abs().max())
    err_solve = float((solved_ch.data - plain_long.data).abs().max())
    err_model = float((solved_model.data - plain_long.data).abs().max())
    drift_ch = max(abs(float(r.average) - float(state_ch.average))
                   for r in (result_ch, solved_ch, solved_model))
    checks_ch = [
        result_ch.data.shape == (1024, 1024) and result_ch.data.dtype == f32,
        all(bool(torch.isfinite(r.data).all()) for r in (result_ch, solved_ch, solved_model)),
        abs(t_ch - 0.3) < 1e-9 and solver_ch.info["steps"] == 300,
        err_stepper <= F32_STEP_RTOL * 300 * scale_ch,
        err_solve <= F32_STEP_RTOL * 1000 * float(plain_long.data.abs().max()),
        err_model <= F32_STEP_RTOL * 1000 * float(plain_long.data.abs().max()),
        drift_ch <= 1e-5,  # periodic Cahn-Hilliard conserves the mean
    ]
    print(f"[main] Cahn-Hilliard 1024^2 periodic fp32 (backend='cuda'): make_stepper 300 "
          f"steps max_abs vs plain loop {err_stepper:.3e}; PDE.solve to t=1 {err_solve:.3e}; "
          f"CahnHilliardPDE.solve to t=1 {err_model:.3e}; mean drift {drift_ch:.2e}; "
          f"kernel launches {multi_launches} {'ok' if all(checks_ch) else 'FAIL'}", flush=True)
    if not all(checks_ch):
        raise AssertionError(f"Cahn-Hilliard main path checks failed: {checks_ch}")

    # -- 8. throughput (Cahn-Hilliard) -------------------------------------------------------
    # BASELINE config 2 as scripts/performance_solvers.py defines it: warm up for
    # 100 steps, then time the stepper to t = 100
    dt_ch, t_end = 1e-3, 100.0
    bench_solver = pde.EulerSolver(eq_ch, backend="cuda")
    bench_stepper = bench_solver.make_stepper(state_ch, dt=dt_ch)
    warm, t_warm = bench_stepper(state_ch, 0.0, 100 * dt_ch)
    torch.cuda.synchronize()
    start = time.perf_counter()
    final, t_final = bench_stepper(warm, t_warm, t_end)
    torch.cuda.synchronize()
    tts = time.perf_counter() - start
    bench_steps = bench_solver.info["steps"] - 100
    final_ok = bool(torch.isfinite(final.data).all()) and abs(t_final - t_end) < 1e-6
    if not final_ok:
        raise AssertionError("the t = 100 Cahn-Hilliard run did not end finite at t = 100")
    print(f"[throughput] Cahn-Hilliard 1024^2 periodic fp32 to t=100 (dt=1e-3, "
          f"{bench_steps} steps after 100 warm-up) on {smi}: {tts:.4f} s, "
          f"{1024 * 1024 * bench_steps / tts:.4e} cell-updates/s", flush=True)

    grid_4k = pde.UnitGrid([4096, 4096], periodic=True)
    state_4k = pde.ScalarField.random_uniform(grid_4k, -0.1, 0.1, dtype=f32, device=device,
                                              rng=np.random.default_rng(3))
    stepper_4k = pde.EulerSolver(eq_ch, backend="cuda").make_stepper(state_4k, dt=dt_ch)
    data_4k, t_4k = stepper_4k(state_4k, 0.0, 0.1)  # warm-up
    torch.cuda.synchronize()
    rate_4k = 0.0
    for _ in range(2):
        start = time.perf_counter()
        data_4k, t_4k = stepper_4k(data_4k, t_4k, t_4k + 2048 * dt_ch)
        torch.cuda.synchronize()
        rate_4k = max(rate_4k, 4096 * 4096 * 2048 / (time.perf_counter() - start))
    print(f"[throughput] Cahn-Hilliard 4096^2 periodic fp32 on {smi}: {rate_4k:.4e} "
          f"cell-updates/s (best of 2 windows of 2048 steps)", flush=True)

    ch_window, ch_data = ch_case["window"], ch_case["datas"]
    per_k = {}
    for spec in ch_window.specs:
        outs = [torch.empty_like(d) for d in ch_data]
        k_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d(ch_data, spec, outs=outs), 50)
        p_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d_plain(ch_data, spec), 5)
        per_k[spec.k] = (k_ms, p_ms)
        print(f"[throughput] Cahn-Hilliard 1024^2 fp32 one k={spec.k} pass (tile {spec.tile}) "
              f"on {smi}: kernel {k_ms:.4f} ms ({1024 * 1024 * spec.k / k_ms * 1e3:.4e} "
              f"cell-updates/s), plain {p_ms:.4f} ms", flush=True)
    top_k = ch_window.specs[0].k

    # -- 9. kernel vs plain (SDE) ------------------------------------------------------------
    noise_gen = torch.Generator(device=device).manual_seed(12)
    ctl = (0x1234ABCD, 0x0BADF00D, 1000)

    def sde_tolerance(dtype, route, steps):
        if route.startswith("normal (Box"):
            return F64_BOX_MULLER_TOL if dtype == f64 else F32_BOX_MULLER_STEP_RTOL * steps
        return F64_TOL if dtype == f64 else F32_STEP_RTOL * steps

    def check_sde(label, route, spec, data):
        """One pass of the route's kernel against its plain version."""
        if spec.program.noise == "staged":
            noise = 0.01 * torch.randn((spec.k, *spec.shape), generator=noise_gen,
                                       dtype=spec.dtype, device=device)
            out = sde.sde_stencil_2d(data, noise, spec)
            ref = sde.sde_stencil_2d_plain(data, noise, spec)
        else:
            out = sde.sde_kernel_noise_2d(data, ctl, spec)
            ref = sde.sde_kernel_noise_2d_plain(data, ctl, spec)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        tol = sde_tolerance(spec.dtype, route, spec.k) * scale
        ok = bool(torch.isfinite(out).all()) and err <= tol
        print(f"[sde] {label} {route} {str(spec.dtype)[6:]} k={spec.k} tile={spec.tile} "
              f"({spec.program.library}): max_abs={err:.3e} max_rel={err / scale:.3e} "
              f"tol={tol:.1e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"SDE kernel disagrees with its plain version: {label} {route}")
        return err

    sde_errs = {}
    for case in sde_cases:
        for spec in case["window"].specs:
            sde_errs[(case["label"], case["route"], str(spec.dtype), spec.k)] = check_sde(
                case["label"], case["route"], spec, case["data"])

    def check_tiling(case):
        """One k = 8 pass of in-kernel noise against eight k = 1 passes keyed
        by the following global steps: the stream is the global cell's."""
        window, data = case["window"], case["data"]
        top, one = window.specs[0], window.specs[-1]
        out = sde.sde_kernel_noise_2d(data, ctl, top)
        ref = data
        for i in range(top.k):
            ref = sde.sde_kernel_noise_2d(ref, (ctl[0], ctl[1], ctl[2] + i), one)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        tol = sde_tolerance(top.dtype, case["route"], top.k) * scale
        ok = err <= tol
        print(f"[sde] tiling {case['label']} {case['route']} {str(top.dtype)[6:]}: one k={top.k} "
              f"pass vs {top.k} k=1 passes max_abs={err:.3e} tol={tol:.1e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"in-kernel noise depends on the tiling: {case['label']}")

    for case in sde_cases:
        if case["kernel"] == "sde_kernel_noise_2d" and case["window"].specs[0].k > 1:
            check_tiling(case)

    # -- 10. main path (SDE) -------------------------------------------------------------------
    dt_sde, sde_steps = 1e-3, 2048
    state_sde = pde.ScalarField(big_sde, 0.0, dtype=f32, device=device)
    counters = (cc.affine_laplace_2d, cs.multi_stencil_2d, sde.sde_stencil_2d,
                sde.sde_kernel_noise_2d)
    sde_launches = {}
    main_sde = {}
    for route, cfg, kernel in SDE_ROUTES[:2]:
        with pde.config(cfg):
            for counter in counters:
                counter.launches = 0
            eq_kpz = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1, rng=np.random.default_rng(1))
            solver_kpz = pde.EulerSolver(eq_kpz, backend="cuda")
            stepper_kpz = solver_kpz.make_stepper(state_sde, dt=dt_sde)
            result_kpz, t_kpz = stepper_kpz(state_sde, 0.0, sde_steps * dt_sde)
            solved_kpz = eq_kpz.solve(state_sde, t_range=0.1, dt=dt_sde, tracker=None,
                                      backend="cuda")
            torch.cuda.synchronize()
            counts = {c.__name__: c.launches for c in counters}
            sde_launches[kernel] = counts[kernel]
            if not (solver_kpz.info.get("fused_step") and
                    eq_kpz.diagnostics["solver"].get("fused_step")):
                raise AssertionError(f"the SDE main path ({route}) did not take the fused window")
            if counts[kernel] <= 0:
                raise AssertionError(f"the SDE main path ({route}) launched no {kernel}")
            checks = [
                result_kpz.data.shape == (4096, 4096) and result_kpz.data.dtype == f32,
                bool(torch.isfinite(result_kpz.data).all()),
                bool(torch.isfinite(solved_kpz.data).all()),
                abs(t_kpz - sde_steps * dt_sde) < 1e-9 and solver_kpz.info["steps"] == sde_steps,
                float(result_kpz.fluctuations) > 0 and float(solved_kpz.fluctuations) > 0,
                solver_kpz.info["stochastic"] is True,
            ]
            note = ""
            if kernel == "sde_stencil_2d":
                # the staged stream is the plain loop's: same seed, same increments
                plain_kpz = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1,
                                                rng=np.random.default_rng(1))
                plain_stepper = pde.EulerSolver(plain_kpz, backend="numpy").make_stepper(
                    state_sde, dt=dt_sde)
                pl_solver = pde.EulerSolver(
                    pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1,
                                        rng=np.random.default_rng(1)), backend="cuda")
                fused_short, _ = pl_solver.make_stepper(state_sde, dt=dt_sde)(
                    state_sde, 0.0, 100 * dt_sde)
                plain_short, _ = plain_stepper(state_sde, 0.0, 100 * dt_sde)
                torch.cuda.synchronize()
                err_plain = float((fused_short.data - plain_short.data).abs().max())
                bound = F32_STEP_RTOL * 100 * float(plain_short.data.abs().max())
                checks.append(err_plain <= bound)
                note = f"; 100 steps vs the plain loop on the same stream max_abs {err_plain:.3e}"
            main_sde[route] = (float(result_kpz.fluctuations), float(solved_kpz.fluctuations))
            print(f"[main] KPZ 4096^2 periodic fp32 {route} (backend='cuda'): make_stepper "
                  f"{sde_steps} steps fluctuations {main_sde[route][0]:.4e}; solve to t=0.1 "
                  f"fluctuations {main_sde[route][1]:.4e}{note}; launches {counts} "
                  f"{'ok' if all(checks) else 'FAIL'}", flush=True)
            if not all(checks):
                raise AssertionError(f"SDE main path checks failed ({route}): {checks}")

    def check_moments(route, window):
        """One k = 8 pass from zero: every cell holds the sum of 8 increments."""
        zeros = torch.zeros(big_sde.shape, dtype=f32, device=device)
        steps = window.specs[0].k
        x = window(zeros, 77, steps).double().reshape(-1)
        n = x.numel()
        target_var = steps * zero_scale**2
        results = []
        for power, target in ((1, 0.0), (2, target_var), (3, 0.0)):
            values = x**power
            se = float(values.std()) / n**0.5
            got = float(values.mean())
            results.append((power, got, target, se, abs(got - target) <= MOMENT_SIGMAS * se))
        ok = all(r[-1] for r in results)
        text = ", ".join(f"E[x^{p}]={g:.4e} (target {t:.4e}, se {e:.1e})" for p, g, t, e, _ in results)
        print(f"[main] increment moments, one k={steps} pass of DiffusionPDE(0.0, noise=1.0) "
              f"from zero, 4096^2 fp32, {route}: {text} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"increment moments off ({route})")

    for route, window in zero_rate.items():
        check_moments(route, window)

    # -- 11. throughput (SDE) ------------------------------------------------------------------
    cells_sde = 4096 * 4096
    sde_rates = {}
    for route, cfg, kernel in SDE_ROUTES:
        with pde.config(cfg):
            eq_t = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1, rng=np.random.default_rng(1))
            stepper_t = pde.EulerSolver(eq_t, backend="cuda").make_stepper(state_sde, dt=dt_sde)
        data_t, t_t = stepper_t(state_sde, 0.0, sde_steps * dt_sde)  # warm-up
        torch.cuda.synchronize()
        best_t = 0.0
        for _ in range(3):
            start = time.perf_counter()
            data_t, t_t = stepper_t(data_t, t_t, t_t + sde_steps * dt_sde)
            torch.cuda.synchronize()
            best_t = max(best_t, cells_sde * sde_steps / (time.perf_counter() - start))
        sde_rates[route] = best_t
        print(f"[throughput] KPZ 4096^2 periodic fp32 {route} ({kernel}) on {smi}: "
              f"{best_t:.4e} cell-updates/s (best of 3 windows of {sde_steps} steps)", flush=True)
    plain_eq = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1, rng=np.random.default_rng(1))
    plain_stepper_t = pde.EulerSolver(plain_eq, backend="numpy").make_stepper(state_sde, dt=dt_sde)
    plain_rate = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        plain_stepper_t(state_sde, 0.0, 32 * dt_sde)
        torch.cuda.synchronize()
        plain_rate = max(plain_rate, cells_sde * 32 / (time.perf_counter() - start))
    print(f"[throughput] KPZ 4096^2 periodic fp32 normal, plain step loop on {smi}: "
          f"{plain_rate:.4e} cell-updates/s (best of 3 x 32 steps)", flush=True)

    kpz_main = {case["route"]: case for case in sde_cases
                if case["label"] == "kpz 4096^2 periodic"}
    staged_case, kn_case = kpz_main["normal"], kpz_main["irwin4"]
    staged_spec, kn_spec = staged_case["window"].specs[0], kn_case["window"].specs[0]
    data_main = staged_case["data"]
    out_main = torch.empty_like(data_main)
    noise_main = 0.01 * torch.randn((staged_spec.k, *staged_spec.shape), generator=noise_gen,
                                    dtype=f32, device=device)
    staged_ms = _cuda_ms(torch, lambda: sde.sde_stencil_2d(data_main, noise_main, staged_spec,
                                                           out=out_main), 20)
    staged_plain_ms = _cuda_ms(torch, lambda: sde.sde_stencil_2d_plain(data_main, noise_main,
                                                                       staged_spec), 3)
    kn_ms = _cuda_ms(torch, lambda: sde.sde_kernel_noise_2d(data_main, ctl, kn_spec,
                                                            out=out_main), 20)
    kn_plain_ms = _cuda_ms(torch, lambda: sde.sde_kernel_noise_2d_plain(data_main, ctl, kn_spec), 3)
    noise_fn = pde.PDE({"c": "laplace(c)"}, noise=0.1)._make_staged_noise(
        pde.ScalarField(big_sde, 0.0), dt_sde)
    stage_ms = _cuda_ms(torch, lambda: noise_fn(5, range(staged_spec.k), data_main), 5)
    print(f"[throughput] KPZ 4096^2 fp32 one k={staged_spec.k} pass on {smi}: sde_stencil_2d "
          f"{staged_ms:.4f} ms ({cells_sde * staged_spec.k / staged_ms * 1e3:.4e} "
          f"cell-updates/s), plain {staged_plain_ms:.4f} ms; staging its {staged_spec.k} "
          f"normal increment planes {stage_ms:.4f} ms; sde_kernel_noise_2d irwin4 "
          f"{kn_ms:.4f} ms ({cells_sde * kn_spec.k / kn_ms * 1e3:.4e} cell-updates/s), "
          f"plain {kn_plain_ms:.4f} ms", flush=True)

    print(json.dumps({"kernels": [{
        "name": "affine_laplace_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_laplace_2d.cu",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:793",
        "launches": launches,
        "max_abs_err": main_errs[16],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "multi_stencil_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/multi_stencil_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:3755",
        "launches": multi_launches,
        "max_abs_err": multi_errs[(ch_case["label"], str(f32), top_k)],
        "ms": per_k[top_k][0],
        "plain_ms": per_k[top_k][1],
    }, {
        "name": "sde_stencil_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/multi_stencil_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:4831",
        "launches": sde_launches["sde_stencil_2d"],
        "max_abs_err": sde_errs[("kpz 4096^2 periodic", "normal", str(f32), staged_spec.k)],
        "ms": staged_ms,
        "plain_ms": staged_plain_ms,
    }, {
        "name": "sde_kernel_noise_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/philox.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:4660",
        "launches": sde_launches["sde_kernel_noise_2d"],
        "max_abs_err": sde_errs[("kpz 4096^2 periodic", "irwin4", str(f32), kn_spec.k)],
        "ms": kn_ms,
        "plain_ms": kn_plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
