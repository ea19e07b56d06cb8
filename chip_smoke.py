#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pde_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

1. device: the CUDA device's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds ``pde_tpu_torch/csrc/affine_laplace_2d.cu`` for sm_90a;
3. kernel vs plain: the CUDA kernel against its plain PyTorch version on the
   card, on the same inputs, at the main path's shapes and at edge cases;
4. main path: 4096² periodic fp32 ``DiffusionPDE(0.1)`` through
   ``EulerSolver(backend="cuda").make_stepper`` for 37 steps, and the README
   flow ``eq.solve(...)`` on a 1024² no-flux grid; the kernel's launch count
   over this phase must be positive;
5. throughput: cell-updates/s of the main path and of the plain version.

The last lines are a JSON object describing the kernel, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# short runs in fp32: allowed error per step, relative to max|f|
F32_STEP_RTOL = 1e-6
# fp32 over 1000 steps on 256² (the tolerance of pde_tpu's hardware lane)
F32_LONG_TOL = 2e-5
F64_TOL = 1e-12


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


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")

    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc

    # -- 1. device -------------------------------------------------------------------------
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {smi}", flush=True)

    # -- 2. build --------------------------------------------------------------------------
    build = cc.build_kernels()
    ptxas = " | ".join(
        line.split("ptxas info    : ", 1)[1]
        for line in build["log"].splitlines()
        if "ptxas info    : Used" in line
    )
    print(f"[build] nvcc sm_90a: compiled={build['compiled']} in {build['seconds']:.2f} s; "
          f"{ptxas}", flush=True)

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

    print(json.dumps({"kernels": [{
        "name": "affine_laplace_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_laplace_2d.cu",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:793",
        "launches": launches,
        "max_abs_err": main_errs[16],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
