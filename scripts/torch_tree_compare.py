"""Times the 2D row-march passes of the main paths, and config 4's radial passes, from several copies of pde_tpu_torch in turns on one NVIDIA GPU.

Each argument is a directory holding a copy of the package
(``DIR/pde_tpu_torch``: for example another commit's, unpacked by ``git
archive`` into a git-ignored folder; ``.`` is the repository's own). Each copy
builds the libraries below first, one process a library, all at once, and
reports each build's CPU time (``nvcc`` and the compilers it ran). Then each
copy runs in a process of its own (the copies share the package's name), in
turns A B ... B A, on 4096² fp32 states (``uniform(0, 1)``, seed 5):

- kernel #1 (``affine_laplace_2d``) at the main path's top k, 12, on the
  periodic ``UnitGrid`` and with no-flux sides; and the main path's rate,
  cell-updates/s of ``EulerSolver(DiffusionPDE(0.1), backend="cuda")``
  windows of 2048 steps at dt = 0.1 (best of 3 x 3 windows);
- kernel #7 (``multi_stencil_2d``) on Cahn-Hilliard, ``laplace(c**3 - c -
  laplace(c))`` at dt = 1e-3: the Euler window's k = 4 pass, periodic and
  no-flux, and the RK4 window's k = 1 pass, periodic;
- where the copy has them (BASELINE config 4), #1's radial mode at k = 8 and
  #7's radial Cahn-Hilliard (Euler k = 4, RK4 k = 1) on
  ``CylindricalSymGrid(4096, (0, 4096), (4096, 4096))`` with no-flux sides;
- the ext kernels of decomposed runs, over the four 2048² blocks of a [2, 2]
  mesh of those grids (buffers ``uniform(0, 1)``, halo k, each block's edge
  flags): #12 (``affine_laplace_ext_2d``) at k = 12, periodic and no-flux,
  #8 (``multi_stencil_ext_2d``) on Cahn-Hilliard's Euler k = 4 pass,
  periodic, and where the copy has it, #12's radial mode at k = 8;
- where the copy has it, the 9-point corner-weight mode (w = 1/3) of #1 at
  k = 8 on the periodic grid, and of #12 at k = 8 over the two blocks of a
  [2, 1] cut;
- where the copy has them, the side-input modes of #1 and #12 at k = 6 on
  the 4096² ``UnitGrid`` with the hardware configuration's sides (a
  per-point Dirichlet array on x-, ``sin(3*t)`` on y-, no-flux elsewhere;
  t-tables from t = 0 at dt = 0.1), and their radial modes on the
  cylinder above with a per-point Dirichlet array along z on r+,
  ``0.1*sin(3*t)`` on z-, no-flux elsewhere.

Each pass is held against its plain version (1e-6 a step relative to
max|f|) and timed with CUDA events over 200 passes. Beside each: ptxas'
registers, and a hash of the kernel's SASS (``cuobjdump -sass``, found beside
``nvcc``), so that copies whose kernels compile to the same instructions show
it, whatever the kernels' mangled names; with ``--sass-dir DIR`` each copy's
SASS of those kernels goes to ``DIR/<copy>/<case>.sass`` (the names of the
library's functions first), to
be compared line by line.

Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_tree_compare.py _archive/parent . [--sass-dir chiprun_out/sass]

One line per build, one per measurement (each copy's two turns), then the
card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 4096
REPEATS = 200
CAHN_HILLIARD = "laplace(c**3 - c - laplace(c))"
NOFLUX = {"derivative": 0}
# the conditions' slot of a case under the 9-point corner weight (a periodic grid)
CORNER = "corner weight 1/3"
CORNER_KEY = "operators.cartesian.laplacian_2d_corner_weight"
# a line of cuobjdump's SASS that holds an instruction: its address, then the opcode
_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _package(copy: str):
    """Import the copy's package (first on the path) and the repository's
    ``chip_smoke`` helpers."""
    here = Path(copy).resolve()
    sys.path[:0] = [str(here), str(ROOT)]
    import pde_tpu_torch as pde

    if Path(pde.__file__).resolve().parents[1] != here:
        raise RuntimeError(f"imported {pde.__file__}, not the copy in {here}")
    import chip_smoke

    return pde, chip_smoke


def _side_bcs(n: int, radial: bool) -> dict:
    """The side-input cases' conditions on n² cells (see the docstring)."""
    import numpy as np

    array = {"value": np.sin(np.linspace(0.0, 2.0 * np.pi, n))}
    if radial:
        return {"r-": NOFLUX, "r+": array, "z-": {"value_expression": "0.1*sin(3*t)"},
                "z+": NOFLUX}
    return {"x-": array, "x+": NOFLUX, "y-": {"value_expression": "sin(3*t)"}, "y+": NOFLUX}


def _cases(pde, torch):
    """label -> (kind, k, grid, conditions) of the copy."""
    cases = {
        "#1 periodic k=12": ("affine", 12, pde.UnitGrid([N, N], periodic=True), None),
        "#1 no-flux k=12": ("affine", 12, pde.UnitGrid([N, N]), NOFLUX),
        "#7 CH periodic k=4": ("ch", 4, pde.UnitGrid([N, N], periodic=True), None),
        "#7 CH no-flux k=4": ("ch", 4, pde.UnitGrid([N, N]), NOFLUX),
        "#7 RK4 CH periodic k=1": ("rk4", 1, pde.UnitGrid([N, N], periodic=True), None),
    }
    if hasattr(pde, "CylindricalSymGrid"):
        cylinder = pde.CylindricalSymGrid(N, (0, N), (N, N))
        cases["#1 radial no-flux k=8"] = ("affine", 8, cylinder, NOFLUX)
        cases["#7 CH radial no-flux k=4"] = ("ch", 4, cylinder, NOFLUX)
        cases["#7 RK4 CH radial no-flux k=1"] = ("rk4", 1, cylinder, NOFLUX)
    cases["#12 periodic k=12 [2, 2]"] = ("ext", 12, pde.UnitGrid([N, N], periodic=True), None)
    cases["#12 no-flux k=12 [2, 2]"] = ("ext", 12, pde.UnitGrid([N, N]), NOFLUX)
    cases["#8 CH periodic k=4 [2, 2]"] = ("ext ch", 4, pde.UnitGrid([N, N], periodic=True), None)
    from pde_tpu_torch.ops import cuda_cartesian as cc

    if hasattr(cc, "RADIAL_EXT_LIBRARY"):  # the ext kernel's radial mode
        cases["#12 radial no-flux k=8 [2, 2]"] = (
            "ext", 8, pde.CylindricalSymGrid(N, (0, N), (N, N)), NOFLUX)
    if hasattr(cc, "CORNER_LIBRARY"):  # the 9-point corner-weight mode of #1 and #12
        cases["#1 9-point w=1/3 periodic k=8"] = (
            "affine", 8, pde.UnitGrid([N, N], periodic=True), CORNER)
        cases["#12 9-point w=1/3 periodic k=8 [2, 1]"] = (
            "ext", 8, pde.UnitGrid([N, N], periodic=True), CORNER)
    if hasattr(cc, "SIDES_EXT_LIBRARY"):  # the side inputs of #1 and #12
        cases["#1 side inputs k=6"] = ("affine", 6, pde.UnitGrid([N, N]), _side_bcs(N, False))
        cases["#12 side inputs k=6 [2, 2]"] = ("ext", 6, pde.UnitGrid([N, N]),
                                               _side_bcs(N, False))
    if hasattr(cc, "RADIAL_SIDES_LIBRARY"):  # ... and of their radial modes
        cylinder = pde.CylindricalSymGrid(N, (0, N), (N, N))
        k = cc.RADIAL_SIDES_TOP_STEPS
        cases[f"#1 radial side inputs k={k}"] = ("affine", k, cylinder, _side_bcs(N, True))
        cases[f"#12 radial side inputs k={k} [2, 2]"] = ("ext", k, cylinder, _side_bcs(N, True))
    return cases


def _side_views(cc, torch, grid, bcs, spec, device, row_pad: int = 0):
    """The pass's side inputs, their t-table from t = 0 at dt = 0.1 (None
    where the spec has none)."""
    if not getattr(spec, "has_sides", False):
        return None
    return cc.AffineSideInputs(grid, bcs).for_pass(
        torch.float32, device, [0.1 * s for s in range(spec.k)], row_pad=row_pad)


def _affine_unit(cc, spec):
    """The build unit of kernel #1 that takes `spec`."""
    if getattr(spec, "corner", 0) or getattr(spec, "has_sides", False):
        return cc.kernel_source(spec.periodic, cc.library_of(spec))
    if getattr(spec, "radial", None) is None:
        return cc.kernel_source(spec.periodic)
    if hasattr(cc, "library_of"):
        return cc.kernel_source(spec.periodic, cc.library_of(spec))
    return cc.kernel_source(spec.periodic, radial=True)  # the radial mode in #1's library


def _pass(pde, torch, kind, k, grid, bc, device):
    """(unit, kernel name parts, run, plain reference) of one case's pass."""
    import numpy as np
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    f32 = torch.float32
    if bc == CORNER:  # the specs are made under the key; the passes keep it
        with pde.config({CORNER_KEY: 1 / 3}):
            return _pass(pde, torch, kind, k, grid, None, device)
    if kind.startswith("ext"):
        return _ext_pass(pde, torch, kind, k, grid, bc, device)
    data = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, grid.shape), dtype=f32,
                           device=device)
    out = torch.empty_like(data)
    if kind == "affine":
        bcs = None if bc is None else grid.get_boundary_conditions(bc)
        spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k, dtype=f32, bcs=bcs)
        unit = _affine_unit(cc, spec)
        tx, threads, _, _ = spec.tile
        sides = _side_views(cc, torch, grid, bcs, spec, device)
        extra = {} if sides is None else {"sides": sides}
        return (unit, ("_2d_kernel", f"IfLi{k}ELi{tx}ELi{threads}E"),
                lambda: cc.affine_laplace_2d(data, spec, out=out, **extra),
                lambda: cc.affine_laplace_2d_plain(data, spec, *extra.values()))
    eq = pde.PDE({"c": CAHN_HILLIARD}, **({} if bc is None else {"bc_ops": {"c:laplace": bc}}))
    make = eq.make_fused_euler_window if kind == "ch" else eq.make_fused_rk4_window
    window = make(pde.ScalarField(grid, 0.0, dtype=f32, device=device), 1e-3)
    spec = next(s for s in window.specs if s.k == k)
    return (window.program, ("multi_stencil_2d_kernel", f"EfLi{k}E"),
            lambda: cs.multi_stencil_2d([data], spec, outs=[out])[0],
            lambda: cs.multi_stencil_2d_plain([data], spec)[0])


def _ext_pass(pde, torch, kind, k, grid, bc, device):
    """:func:`_pass` of an ext kernel over the four blocks of a [2, 2] mesh;
    run and reference give the blocks' interiors, a list (run's are views
    into the output buffers, so that a timed call is the launch alone)."""
    import numpy as np
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh

    f32 = torch.float32
    cut = [2, 1] if cc._corner_weight() else [2, 2]  # the 9-point mode takes row cuts
    mesh = GridMesh(grid, cut, devices=[device] * (cut[0] * cut[1]))
    bcs = None if bc is None else grid.get_boundary_conditions(bc)
    flags = [mesh.edge_flags(b) for b in range(len(mesh))]
    if kind == "ext":
        spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=0.01, k=k, halo=k,
                                          dtype=f32, bcs=bcs)
        sides = _side_views(cc, torch, grid, bcs, spec, device, getattr(cc, "SIDE_PAD", 0))
        if sides is not None:
            flags = [f + list(mesh.block_origin(b)) for b, f in enumerate(flags)]
            unit = ce.affine_ext_source(spec.periodic, radial=spec.radial is not None,
                                        sides=True)
        elif spec.radial is not None:
            flags = [f + [mesh.block_origin(b)[0]] for b, f in enumerate(flags)]
            unit = ce.affine_ext_source(spec.periodic, radial=True)
        elif getattr(spec, "corner", 0):
            unit = ce.affine_ext_source(spec.periodic, corner=True)
        else:
            unit = ce.affine_ext_source(spec.periodic)
        tx, threads, _, _ = spec.tile
        needles = ("ext_2d_kernel", f"IfLi{k}ELi{tx}ELi{threads}E")
        extra = {} if sides is None else {"sides": sides}

        def launch(ins, outs, flags, spec):
            ce.affine_laplace_ext_2d(ins, outs, flags, spec, **extra)

        def plain(ext, spec, flags):
            return ce.affine_laplace_ext_2d_plain(ext, spec, flags, *extra.values())
    else:
        eq = pde.PDE({"c": CAHN_HILLIARD}, **({} if bc is None else {"bc": bc}))
        window = eq.make_fused_euler_window(pde.ScalarField(grid, 0.0, dtype=f32, device=device),
                                            1e-3, mesh=mesh)
        spec = next(s for s in window.specs if s.k == k)
        unit, needles = window.program, ("multi_stencil_ext_2d_kernel", f"EfLi{k}E")

        def launch(ins, outs, flags, spec):
            ce.multi_stencil_ext_2d([[x] for x in ins], [[o] for o in outs], flags, spec)

        def plain(ext, spec, flags):
            return ce.multi_stencil_ext_2d_plain([ext], spec, flags)[0]

    h, (n, m) = spec.halo, spec.shape
    gen = np.random.default_rng(5)
    ins = [torch.as_tensor(gen.uniform(0, 1, (n + 2 * h, m + 2 * h)), dtype=f32, device=device)
           for _ in range(len(mesh))]
    outs = [torch.empty_like(x) for x in ins]

    def run():
        launch(ins, outs, flags, spec)
        return [o[h:h + n, h:h + m] for o in outs]

    return (unit, needles, run, lambda: [plain(x, spec, f) for x, f in zip(ins, flags)])


def _sass(nvcc: str, path: str, needles, out: Path | None) -> dict:
    """{function: hash of its SASS, its count of instructions and a hash of
    their opcodes, sorted (the same instructions, ordered or allocated
    otherwise, give the same)} of the library's functions whose names hold
    every needle ({} without cuobjdump); their SASS into `out`, where given,
    after the names of every function of the library."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    if not cuobjdump.exists():
        return {}
    dump = subprocess.run([str(cuobjdump), "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    functions, names, texts, name, body = {}, [], [], None, []
    for line in dump.splitlines() + [None]:  # None: the end, after the last function
        if line is None or line.strip().startswith("Function : "):
            if name is not None and all(n in name for n in needles):
                opcodes = sorted(m.group(1) for m in map(_INSTRUCTION.match, body) if m)
                functions[name] = (f"{hashlib.sha256(chr(10).join(body).encode()).hexdigest()[:12]}"
                                   f" ({len(opcodes)} instructions, their opcodes "
                                   f"{hashlib.sha256(' '.join(opcodes).encode()).hexdigest()[:8]})")
                texts += [f"Function : {name}", *body]
            if line is not None:
                name, body = line.split("Function : ", 1)[1].strip(), []
                names.append(name)
        elif name is not None:
            body.append(line)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(names + texts) + "\n")
    return functions


def build(copy: str, label: str) -> None:
    """Build the library of one case of the copy; print its CPU seconds."""
    import resource

    import torch

    pde, _ = _package(copy)
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    kind, k, grid, bc = _cases(pde, torch)[label]
    unit = _pass(pde, torch, kind, k, grid, bc, "cpu")[0]
    start = time.perf_counter()
    built = cs.build_programs([unit])[0]
    usage = resource.getrusage(resource.RUSAGE_CHILDREN)
    print(json.dumps({"library": unit.library, "compiled": built["compiled"],
                      "seconds": time.perf_counter() - start,
                      "cpu_seconds": usage.ru_utime + usage.ru_stime}))


def measure(copy: str, turn: int, sass_dir: str | None) -> None:
    """Time every case of the copy; print one JSON line."""
    import numpy as np
    import torch

    pde, smoke = _package(copy)
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    device = torch.device("cuda", 0)
    result = {"ms": {}, "max_rel": {}, "registers": {}, "sass": {}}
    for label, (kind, k, grid, bc) in _cases(pde, torch).items():
        unit, needles, run, plain = _pass(pde, torch, kind, k, grid, bc, device)
        got, ref = run(), plain()
        if isinstance(got, list):  # an ext kernel's blocks
            got, ref = torch.stack(got), torch.stack(ref)
        torch.cuda.synchronize()
        rel = float((got - ref).abs().max()) / float(ref.abs().max())
        if not (bool(torch.isfinite(got).all()) and rel <= smoke.F32_STEP_RTOL * k):
            raise AssertionError(f"{copy} {label}: the kernel disagrees with its plain version")
        result["ms"][label] = smoke._cuda_ms(torch, run, REPEATS)
        result["max_rel"][label] = rel
        if turn == 0:
            built = cs.build_programs([unit])[0]
            result["registers"][label] = smoke._ptxas_of(built["log"], *needles)
            out = None
            if sass_dir is not None:
                slug = "".join(c if c.isalnum() else "_" for c in label)
                out = Path(sass_dir) / Path(copy).resolve().name / f"{slug}.sass"
            result["sass"][label] = _sass(cc._nvcc(), built["path"], needles, out)
    state = pde.ScalarField.random_uniform(pde.UnitGrid([N, N], periodic=True),
                                           dtype=torch.float32, rng=np.random.default_rng(33))
    stepper = pde.EulerSolver(pde.DiffusionPDE(0.1), backend="cuda").make_stepper(state, dt=0.1)
    result["rate"] = smoke._window_rate(torch, stepper, state, 0.1)
    print(json.dumps(result))


def _last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def main(copies: list[str], sass_dir: str | None) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_tree_compare: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    script = str(Path(__file__).resolve())
    jobs = []
    for copy in copies:
        labels = subprocess.run([sys.executable, script, "--labels", copy], capture_output=True,
                                text=True, check=True).stdout.split("\n")
        jobs += [(copy, label, subprocess.Popen([sys.executable, script, "--build", copy, label],
                                                stdout=subprocess.PIPE, text=True))
                 for label in labels if label]
    for copy, label, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the build of {copy} {label} failed")
        built = _last_json(out)
        print(f"[compare build] {copy} {label}: {built['library']} compiled={built['compiled']} "
              f"{built['cpu_seconds']:.1f} CPU-s ({built['seconds']:.1f} s)", flush=True)
    turns = {copy: [] for copy in copies}
    for turn, copy in enumerate(copies + copies[::-1]):
        out = subprocess.run([sys.executable, script, "--measure", copy, str(turn // len(copies)),
                              *([sass_dir] if sass_dir else [])],
                             capture_output=True, text=True, check=True).stdout
        turns[copy].append(_last_json(out))
    first = turns[copies[0]][0]
    for label in {label: None for copy in copies for label in turns[copy][0]["ms"]}:
        parts = []
        for copy in copies:
            a, b = turns[copy]
            if label not in a["ms"]:
                continue
            sass = ",".join(sorted(a["sass"][label].values())) or "not read"
            # the functions' SASS, whatever their mangled names (a template
            # argument added with a default renames an instantiation)
            if copy != copies[0] and a["sass"][label] and sorted(
                    a["sass"][label].values()) == sorted(first["sass"].get(label, {}).values()):
                sass += f" (the same as {copies[0]}'s)"
            parts.append(f"{copy}: {a['ms'][label]:.4f} / {b['ms'][label]:.4f} ms, max_rel "
                         f"{a['max_rel'][label]:.2e}, {' | '.join(a['registers'][label])}, "
                         f"SASS {sass}")
        print(f"[compare] {label}: " + "; ".join(parts), flush=True)
    print("[compare] main path 4096^2 cell-updates/s: " + "; ".join(
        f"{copy}: {turns[copy][0]['rate']:.4e} / {turns[copy][1]['rate']:.4e}"
        for copy in copies), flush=True)
    print(smoke._nvidia_smi())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--labels"]:
        import torch

        print("\n".join(_cases(_package(sys.argv[2])[0], torch)))
    elif sys.argv[1:2] == ["--build"]:
        build(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2], int(sys.argv[3]), (sys.argv[4:] or [None])[0])
    else:
        args = sys.argv[1:]
        sass_dir = None
        if "--sass-dir" in args:
            at = args.index("--sass-dir")
            sass_dir, args[at:at + 2] = args[at + 1], []
        main(args or ["."], sass_dir)
