"""Runs phases 54-57 of ``chip_smoke.py`` alone, on one NVIDIA GPU: the side
inputs of the Euler-Maruyama kernels #9 and #10 (``[sde sides]``), the SDE
main path with them through the Milstein solver (``[sde sides main]``),
multiplicative noise and Milstein (``[milstein]``) and correlated noise
(``[correlated noise]``).

It first builds, all at once, the libraries those phases launch, and the
periodic KPZ main path's scalar-side libraries (phases 9-11's) whose
registers and SASS phase 55 prints. With ``--parent DIR`` (a directory
holding another copy of ``pde_tpu_torch``, for example the parent commit's
unpacked by ``git archive`` into a git-ignored folder) it then prints, for
each noise route, dtype and k of those scalar-side kernels, ptxas'
registers and spills and the SASS summary (instructions and hashes) of
DIR's copy beside this tree's, each copy built in a process of its own. Run
from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_sde_sides_phases.py [--parent _archive/parent]

The phases' lines, the build and phase times, and the comparison.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# builds, in a process whose package is DIR's, the periodic KPZ 4096² windows'
# libraries of both routes, and prints {route: {path, log, ladder, tiles}} as JSON
_BUILD_SCALAR = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import pde_tpu_torch as pde
from pde_tpu_torch.ops import cuda_stencil_2d as cs
grid = pde.UnitGrid([4096, 4096], periodic=True)
state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device="cpu")
out = {}
for route, cfg in (("normal", {}), ("irwin4", {"sde.increment_dist": "irwin4"})):
    with pde.config(cfg):
        program = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1).make_fused_euler_window(
            state, 1e-3).program
    built = cs.build_programs([program])[0]
    out[route] = {"path": built["path"], "log": built["log"],
                  "ladder": program.stencil.ladder,
                  "tiles": {str(d)[6:]: t for d, t in program.stencil.tiles.items()}}
print(json.dumps(out))
"""


def _scalar_kernels(copies) -> dict:
    """Each copy's periodic KPZ libraries, built at once, one process a copy."""
    procs = {copy: subprocess.Popen([sys.executable, "-c", _BUILD_SCALAR, str(copy)],
                                    stdout=subprocess.PIPE, text=True) for copy in copies}
    out = {}
    for copy, proc in procs.items():
        stdout, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the build in {copy} failed ({proc.returncode})")
        out[copy] = json.loads(stdout.strip().splitlines()[-1])
    return out


def _compare(smoke, parent: str) -> None:
    """ptxas' report and the SASS summary of the scalar-side SDE kernels of
    `parent`'s copy beside this tree's, for each route, dtype and k."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from scripts.torch_tree_compare import _sass

    builds = _scalar_kernels([parent, str(ROOT)])
    nvcc = cc._nvcc()
    for route in ("normal", "irwin4"):
        mine = builds[str(ROOT)][route]
        for dtype, tag in (("float32", "Ef"), ("float64", "Ed")):
            for k in mine["ladder"]:
                tile = mine["tiles"][dtype][str(k)]
                needles = ("sde_window_2d_kernel", f"{tag}Li{k}ELi{tile}E")
                cells = []
                for copy in (parent, str(ROOT)):
                    built = builds[copy][route]
                    ptx = " | ".join(smoke._ptxas_of(built["log"], *needles))
                    sass = ", ".join(sorted(_sass(nvcc, built["path"], needles, None).values()))
                    cells.append(f"{copy}: {ptx}; SASS {sass or 'not read'}")
                print(f"[sde scalar kernels] {route} {dtype} k={k}: " + " || ".join(cells),
                      flush=True)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False; no result")

    import chip_smoke as smoke
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    units = smoke._sde_side_units(pde, torch, device)
    state = pde.ScalarField(pde.UnitGrid([4096, 4096], periodic=True), 0.0,
                            dtype=torch.float32, device=device)
    scalar = {}
    for route, cfg, _ in smoke.SDE_SIDE_ROUTES:
        with pde.config(cfg):
            scalar[route] = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1) \
                .make_fused_euler_window(state, smoke.SDE_DT).program
    programs = units["units"] + list(scalar.values())
    start = time.perf_counter()
    builds = cs.build_programs(programs)
    cpu = ", ".join(f"{p.library} {b['cpu_seconds']:.1f}" for p, b in zip(programs, builds))
    print(f"built {len(programs)} libraries in {time.perf_counter() - start:.1f} s "
          f"(CPU s {cpu})", flush=True)
    by_digest = {p.digest: b for p, b in zip(programs, builds)}
    start = time.perf_counter()
    errs = smoke._sde_sides_phase(pde, torch, np, device, smi, units)
    print(f"phase 54 in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    rows = smoke._sde_sides_main(pde, torch, np, device, smi, units, by_digest, errs,
                                 {route: by_digest[p.digest] for route, p in scalar.items()})
    print(f"phase 55 in {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    start = time.perf_counter()
    smoke._milstein_phase(pde, torch, np, device, smi)
    print(f"phase 56 in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    smoke._correlated_noise_phase(pde, torch, np, device, smi)
    print(f"phase 57 in {time.perf_counter() - start:.1f} s", flush=True)
    if "--parent" in sys.argv:
        _compare(smoke, sys.argv[sys.argv.index("--parent") + 1])


if __name__ == "__main__":
    main()
