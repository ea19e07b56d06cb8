"""Design sweep of kernel #1's radial mode (the cylindrical Laplacian) on one NVIDIA GPU.

Times the radial mode of the row march (``AffineRowMarch`` of
``pde_tpu_torch/csrc/affine_march_2d.cuh``, the mode ``kRadial``) on config
4's pass, ``DiffusionPDE(0.1)`` at dt = 0.1 on
``CylindricalSymGrid(4096, (0, 4096), (4096, 4096))`` (``uniform(0, 1)``, seed
17), fp32, beside the Cartesian march on a 4096² ``UnitGrid`` with the same
sides, so that what the radial mode costs shows apart from what bounded sides
cost:

- the production wrappers at every k they take: the Cartesian march (k =
  1-16) with no-flux rows and columns and with no-flux rows and periodic
  columns, the radial mode (k = 1-8, its ladder's top) with z bounded
  (no-flux) and periodic; fp64 at k = 4, 8 and (Cartesian) 12;
- variants of the radial mode's kernel at k = 6, 8, 10, 12 and 16, with the
  launch bounds' blocks per SM of the plan (4) and 3: ``table``, the
  template as it is (the production kernel, also past its ladder's top; fp64
  at k = 8 and 12 with the plan's bounds); and copies of the template
  rewritten by this script: ``fac``, one factor a row (``fac = (b / (2 dr))
  / r``, a 4-byte table) in the update ``b sx (up + down) + fac (down - up)
  + b sy (left + right) + c centre``; ``div``, the same update with the
  factor computed from the row index in the kernel (no table);
- kernel #7 (``csrc/march_2d.cuh``) on the Cahn-Hilliard rhs
  ``laplace(c**3 - c - laplace(c))`` at dt = 1e-3 and every k of its ladder,
  on the same four grids and sides: what its radial helpers cost beside
  bounded sides.

Each is held against its plain version (1e-6 x k relative to max|f|; the
variants against the production plain version, whose order of operations
differs) and timed with CUDA events over 50 passes, all in turns, twice;
ptxas' registers and spills beside each.

With ``--sides`` it sweeps the radial mode with side inputs instead (the
kernel ``affine_laplace_radial_sides_2d_kernel``, whose top k
``RADIAL_SIDES_TOP_STEPS`` it sets): at every k up to the top of either mode
alone, ``min(RADIAL_TOP_STEPS, SIDES_TOP_STEPS)`` (its library built to that
k in this process), fp32 and fp64, on config 4's 4096² cylinders with side
inputs, beside the scalar
radial mode at the same k on the same grid with scalar sides of the same
kinds: (a) z periodic, a hole at r = 512 (``CylindricalSymGrid((512,
4608), (0, 4096), (4096, 4096))``), ``0.1*sin(3*t)`` on r- and a per-point
Dirichlet array along z on r+ (scalar: value 0 on both); (b) z bounded,
``CylindricalSymGrid(4096, (0, 4096), (4096, 4096))``, no-flux r, a
per-point Dirichlet array along r on z- and ``cos(t)`` as z+'s derivative
(scalar: value 0 and no-flux); the cases are
``scripts/torch_radial_sides_phases.py``'s. Each pass is held against its
plain version (fp32 1.5e-7 relative to max|f|, the scalar radial mode 1e-6
a step; fp64 1e-14), the t-tables from t = 0.35 at dt = 0.1.

Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_radial_sweep.py [--sides]

One line per wrapper and variant (both rounds' ms, ms per step, share of the
byte bound, error, registers and spills), then the card's name and power
limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import ctypes
import hashlib
import sys
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402  (the repository root's helpers)

REPEATS = 50
N = 4096
NOFLUX = {"derivative": 0}
SIDES_T0 = 0.35
SIDES_DT = 0.1
F32_RTOL = 1.5e-7  # the side-input sweep's tolerances, relative to max|f|
F64_RTOL = 1e-14
VARIANT_KS = (6, 8, 10, 12, 16)
VARIANT_F64_KS = (8, 12)


def _variant_header(template: str, kind: str) -> str:
    """The template rewritten for the variant `kind` (``table``: as it is;
    ``fac`` or ``div``)."""
    if kind == "table":
        return template
    subs = [
        ("struct alignas(2 * sizeof(T)) RadialRow {\n  T cu, cd;\n};",
         "struct alignas(sizeof(T)) RadialRow {\n  T fac;\n};"),
        ("return f.cu * up + f.cd * down + rad.bsy * (left + right) + rad.cc * center;",
         "return rad.bsx * (up + down) + f.fac * (down - up) + rad.bsy * (left + right) + "
         "rad.cc * center;"),
        ("RadialRow<T> factors{T(0), T(0)};", "RadialRow<T> factors{T(0)};"),
        ("  T cc, bsy;\n  const RadialRow<T>* rows;",
         "  T cc, bsy, bsx, bfac, dr, rlo;\n  const RadialRow<T>* rows;"),
        ("const AffineRadial<T> rad{T(doubles[16]), T(doubles[17]),",
         "const AffineRadial<T> rad{T(doubles[16]), T(doubles[17]), T(doubles[1] * doubles[2]), "
         "T(doubles[18]), T(doubles[19]), T(doubles[20]),"),
    ]
    if kind == "div":
        subs.append((
            "if constexpr (MODE == kRadial) factors = rad.rows[rad_base + t - L - 1];",
            "if constexpr (MODE == kRadial) factors.fac = rad.bfac / ((T(rad_base + t - L - 1 - "
            "kRadialPad) + T(0.5)) * rad.dr + rad.rlo);"))
    for old, new in subs:
        if old not in template:
            raise RuntimeError(f"the template changed: {old!r} not found")
        template = template.replace(old, new)
    return template


class _Variant:
    """A build unit of one variant: the (rewritten) template and its entry
    points, fp32 at :data:`VARIANT_KS` and (``table`` at the plan's bounds)
    fp64 at :data:`VARIANT_F64_KS`."""

    library = "affine_laplace_radial_2d"

    def __init__(self, cc, kind: str, min_blocks: int, periodic_cols: bool):
        self.kind, self.min_blocks, self.periodic_cols = kind, min_blocks, periodic_cols
        template = (Path(cc.__file__).resolve().parent.parent / "csrc" / "affine_march_2d.cuh")
        lines = [_variant_header(template.read_text(), kind)]
        self.f64 = kind == "table" and min_blocks == cc.ROW_MIN_BLOCKS[4]
        for ctype, suffix, itemsize, ks in (("float", "f32", 4, VARIANT_KS),
                                            ("double", "f64", 8, VARIANT_F64_KS)):
            if itemsize == 8 and not self.f64:
                continue
            lines += [f'extern "C" int affine_laplace_radial_2d_{suffix}(const void* in, '
                      "void* out, const void* rows, const int* ints, const double* doubles, "
                      "void* stream) {", "  switch (ints[3]) {"]
            for k in ks:
                tx, threads, prefetch, plan_blocks = cc.affine_row_plan(k, itemsize)
                blocks = min_blocks if itemsize == 4 else plan_blocks
                lines.append(f"    case {k}: return pde_tpu_torch::launch_affine_radial_2d<"
                             f"{ctype}, {k}, {tx}, {threads}, {prefetch}, {blocks}, "
                             f"{str(periodic_cols).lower()}>(in, out, rows, ints, doubles, "
                             "stream);")
            lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
        self.source = "\n".join(lines)
        text = self.source + " ".join(cc._NVCC_FLAGS)
        self.digest = hashlib.sha256(text.encode()).hexdigest()[:16]

    @property
    def label(self) -> str:
        z = "periodic z" if self.periodic_cols else "bounded z"
        return f"variant {self.kind}, {self.min_blocks} blocks/SM, {z}"


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_radial_sweep: no CUDA device")
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    device = torch.device("cuda", 0)
    smi = smoke._nvidia_smi()
    cells = N * N
    f32, f64 = torch.float32, torch.float64
    cases = {  # label -> (grid, conditions)
        "cartesian no-flux": (pde.UnitGrid([N, N]), NOFLUX),
        "cartesian periodic columns": (pde.UnitGrid([N, N], periodic=[False, True]),
                                       {"x": NOFLUX, "y": "periodic"}),
        "radial bounded z": (pde.CylindricalSymGrid(N, (0, N), (N, N)), NOFLUX),
        "radial periodic z": (pde.CylindricalSymGrid(N, (0, N), (N, N), periodic_z=True),
                              {"r": NOFLUX, "z": "periodic"}),
    }
    variants = [_Variant(cc, kind, blocks, periodic) for kind in ("table", "fac", "div")
                for blocks in (4, 3) for periodic in (False, True)]
    ch_windows = {}
    for label, (grid, bc) in cases.items():
        state = pde.ScalarField(grid, 0.0, dtype=f32, device=device)
        ch_windows[label] = pde.PDE({"c": "laplace(c**3 - c - laplace(c))"},
                                    bc_ops={"c:laplace": bc}).make_fused_euler_window(state, 1e-3)
    units = [cc.kernel_source(p, library) for p, library in (
        ((False, False), "affine_laplace_2d"), ((False, True), "affine_laplace_2d"),
        ((False, False), cc.RADIAL_LIBRARY), ((False, True), cc.RADIAL_LIBRARY))] + variants + [
        w.program for w in ch_windows.values()]
    builds = cs.build_programs(units)
    logs = {unit.digest: built["log"] for unit, built in zip(units, builds, strict=True)}
    print(f"[radial sweep] {len(units)} libraries built", flush=True)

    gen = np.random.default_rng(17)
    runs = []  # (label, k, dtype, fn, reference, registers)
    for label, (grid, bc) in cases.items():
        bcs = grid.get_boundary_conditions(bc)
        radial = label.startswith("radial")
        top = cc.RADIAL_TOP_STEPS if radial else cc.MAX_STEPS
        for dtype, ks in ((f32, range(1, top + 1)), (f64, (4, 8) if radial else (4, 8, 12))):
            data = torch.as_tensor(gen.uniform(0, 1, grid.shape), dtype=dtype, device=device)
            out = torch.empty_like(data)
            for k in ks:
                spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k, dtype=dtype, bcs=bcs)
                unit = cc.kernel_source(spec.periodic, cc.library_of(spec))
                tx, threads, _, _ = spec.tile
                tag = "I{}Li{}ELi{}ELi{}E".format("f" if dtype == f32 else "d", k, tx, threads)
                regs = smoke._ptxas_of(logs[unit.digest], f"{unit.library}_kernel", tag)
                runs.append((f"{label} {str(dtype)[6:]}", k, dtype,
                             lambda d=data, s=spec, o=out: cc.affine_laplace_2d(d, s, out=o),
                             cc.affine_laplace_2d_plain(data, spec), regs))
    for variant in variants:
        lib = ctypes.CDLL(builds[units.index(variant)]["path"])
        grid, bc = cases["radial periodic z" if variant.periodic_cols else "radial bounded z"]
        bcs = grid.get_boundary_conditions(bc)
        for dtype, ks in ((f32, VARIANT_KS), (f64, VARIANT_F64_KS if variant.f64 else ())):
            if not ks:
                continue
            fn = getattr(lib, f"affine_laplace_radial_2d_{'f32' if dtype == f32 else 'f64'}")
            fn.argtypes = [ctypes.c_void_p] * 6
            fn.restype = ctypes.c_int
            data = torch.as_tensor(gen.uniform(0, 1, grid.shape), dtype=dtype, device=device)
            out = torch.empty_like(data)
            top = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=cc.RADIAL_TOP_STEPS, dtype=dtype,
                                         bcs=bcs)
            for k in ks:  # the production spec's numbers at any k (the gate stops at the top)
                spec = replace(top, k=k, tile=cc.affine_row_plan(k, 4 if dtype == f32 else 8))
                r_lo, dr = spec.radial
                if variant.kind == "table":
                    table = cc.radial_rows(spec, device)
                else:  # one factor a row
                    rows = torch.arange(-cc.RADIAL_PAD, N + cc.RADIAL_PAD, dtype=dtype)
                    table = ((spec.b / (2.0 * dr)) / ((rows + 0.5) * dr + r_lo)).to(device)
                tx, threads, prefetch, _ = spec.tile
                ints = (ctypes.c_int * 9)(N, N, cc.block_plan(spec)[1], k, tx, threads, prefetch,
                                          0, int(variant.periodic_cols))
                doubles = (ctypes.c_double * 21)(*cc.step_doubles(spec), spec.b / (2.0 * dr), dr,
                                                 r_lo)

                def launch(d=data, o=out, t=table, i=ints, dd=doubles, f=fn):
                    err = f(d.data_ptr(), o.data_ptr(), t.data_ptr(), ctypes.addressof(i),
                            ctypes.addressof(dd), torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant launch failed with CUDA error {err}")
                    return o

                tag = "I{}Li{}ELi{}ELi{}E".format("f" if dtype == f32 else "d", k, tx, threads)
                runs.append((f"{variant.label} {str(dtype)[6:]}", k, dtype, launch,
                             cc.affine_laplace_2d_plain(data, spec),
                             smoke._ptxas_of(logs[variant.digest],
                                             "affine_laplace_radial_2d_kernel", tag)))

    for label, window in ch_windows.items():
        program = window.program
        data = [torch.as_tensor(gen.uniform(0, 1, program.geometry.shape), dtype=f32,
                                device=device)]
        outs = [torch.empty_like(data[0])]
        for spec in window.specs:
            runs.append((f"multi_stencil_2d cahn-hilliard {label}", spec.k, f32,
                         lambda d=data, s=spec, o=outs: cs.multi_stencil_2d(d, s, outs=o)[0],
                         cs.multi_stencil_2d_plain(data, spec)[0],
                         [smoke._ptxas(logs[program.digest])]))

    times = {}
    for round_ in range(2):  # every run in turns, twice
        for i, (label, k, dtype, fn, ref, regs) in enumerate(runs):
            times.setdefault(i, []).append(smoke._cuda_ms(torch, fn, REPEATS))
    for i, (label, k, dtype, fn, ref, regs) in enumerate(runs):
        got = fn()
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        tol = (smoke.F64_TOL if dtype == f64 else smoke.F32_STEP_RTOL * k) * scale
        itemsize = 8 if dtype == f64 else 4
        bound = smoke._bound(2 * cells * itemsize, 8 * k * cells)[0]
        ms = times[i]
        print(f"[radial sweep] {label} k={k}: {ms[0]:.4f} / {ms[1]:.4f} ms "
              f"({min(ms) / k:.5f} a step, {bound / min(ms):.1%} of the byte bound); "
              f"max_rel {err / scale:.2e} {'ok' if err <= tol else 'FAIL'}; "
              f"{' | '.join(regs)}", flush=True)
    print(smi)


def sides_main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_radial_sweep: no CUDA device")
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    # past the production top, up to either mode's own top, in this process only
    cc.RADIAL_SIDES_TOP_STEPS = SIDES_SWEEP_TOP = min(cc.RADIAL_TOP_STEPS, cc.SIDES_TOP_STEPS)
    device = torch.device("cuda", 0)
    smi = smoke._nvidia_smi()
    f32, f64 = torch.float32, torch.float64
    from scripts.torch_radial_sides_phases import side_cases

    cases = side_cases(pde, np, N)
    units = [cc.kernel_source(p, library) for p in ((False, False), (False, True))
             for library in (cc.RADIAL_SIDES_LIBRARY, cc.RADIAL_LIBRARY)]
    builds = cs.build_programs(units)
    logs = {unit.digest: built["log"] for unit, built in zip(units, builds, strict=True)}
    print(f"[radial sides sweep] {len(units)} libraries built: " + ", ".join(
        f"{u.library} {u.periodic} {b['cpu_seconds']:.1f} CPU-s" for u, b in zip(units, builds)),
        flush=True)
    gen = np.random.default_rng(17)
    runs = []  # (label, k, dtype, fn, reference, registers)
    for label, (grid, bc, scalar_bc) in cases.items():
        for dtype in (f32, f64):
            data = torch.as_tensor(gen.uniform(0, 1, grid.shape), dtype=dtype, device=device)
            out = torch.empty_like(data)
            for k in range(1, SIDES_SWEEP_TOP + 1):
                for kind, conditions in (("side inputs", bc), ("scalar sides", scalar_bc)):
                    bcs = grid.get_boundary_conditions(conditions)
                    spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k, dtype=dtype, bcs=bcs)
                    sides = None
                    if spec.has_sides:
                        sides = cc.AffineSideInputs(grid, bcs).for_pass(
                            dtype, device, [SIDES_T0 + s * SIDES_DT for s in range(k)])
                    unit = cc.kernel_source(spec.periodic, cc.library_of(spec))
                    tx, threads, _, _ = spec.tile
                    tag = "I{}Li{}ELi{}ELi{}E".format("f" if dtype == f32 else "d", k, tx, threads)
                    regs = smoke._ptxas_of(logs[unit.digest], f"{unit.library}_kernel", tag)
                    runs.append((f"{label} {kind} {str(dtype)[6:]}", k, dtype,
                                 lambda d=data, s=spec, o=out, sd=sides:
                                 cc.affine_laplace_2d(d, s, out=o, sides=sd),
                                 cc.affine_laplace_2d_plain(data, spec, sides), regs))
    times = {}
    for _ in range(2):  # every run in turns, twice
        for i, (label, k, dtype, fn, ref, regs) in enumerate(runs):
            times.setdefault(i, []).append(smoke._cuda_ms(torch, fn, REPEATS))
    failed = []
    for i, (label, k, dtype, fn, ref, regs) in enumerate(runs):
        got = fn()
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        # the scalar radial mode contracts its update into FMAs: its plain
        # version's tolerance is 1e-6 a step, as main()'s
        tol = F64_RTOL if dtype == f64 else F32_RTOL if "side inputs" in label else \
            smoke.F32_STEP_RTOL * k
        ok = bool(torch.isfinite(got).all()) and err <= tol * scale
        if not ok:
            failed.append(f"{label} k={k}")
        itemsize = 8 if dtype == f64 else 4
        bound = smoke._bound(2 * N * N * itemsize, 8 * k * N * N)[0]
        ms = times[i]
        print(f"[radial sides sweep] {label} k={k}: {ms[0]:.4f} / {ms[1]:.4f} ms "
              f"({min(ms) / k:.5f} a step, {bound / min(ms):.1%} of the byte bound); "
              f"max_rel {err / scale:.2e} {'ok' if ok else 'FAIL'}; {' | '.join(regs)}",
              flush=True)
    print(smi)
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: {failed}")


if __name__ == "__main__":
    sides_main() if sys.argv[1:] == ["--sides"] else main()
