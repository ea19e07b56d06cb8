"""Runs phases 61-63 of ``chip_smoke.py`` alone, on one NVIDIA GPU: the side
inputs of the 3D windows, kernel A (#5's side-input mode, which serves #4)
and kernel B (#6's), against their plain versions (``[sides3d]``), the main
paths through them serially and on [2, 2, 2], bit-equal (``[sides3d
main]``), and the scalar-side #5 and #6 kernels' registers and SASS
(``[sides3d sass]``).

It first builds, all at once, the libraries those phases launch and the
scalar-side Allen-Cahn 256³ periodic programs (chip_smoke's phases 12 and
22) whose SASS phase 63 prints. With ``--parent DIR`` (a directory holding
another copy of ``pde_tpu_torch``, for example the parent commit's unpacked
by ``git archive`` into a git-ignored folder) it then prints, for each
dtype and k of those scalar-side kernels, ptxas' registers and spills and
the SASS summary (instructions and hashes) of DIR's copy beside this
tree's, each copy built in a process of its own, and whether the SASS is
the same. Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_sides_3d_phases.py [--parent _archive/parent]

The phases' lines, the build and phase times, the kernels line of the two
side-input modes, and the comparison.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# builds, in a process whose package is DIR's, the scalar-side Allen-Cahn
# 256³ periodic programs of #5 and #6 (serial, and on a [2, 2, 2] mesh), and
# prints {kernel: {path, log, ladder, tiles}} as JSON
_BUILD_SCALAR = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import pde_tpu_torch as pde
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.parallel import GridMesh
grid = pde.UnitGrid([256] * 3, periodic=True)
state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device="cpu")
with pde.config({"parallel.devices_per_device": 8}):
    mesh = GridMesh(grid, [2, 2, 2], devices=["cpu"] * 8)
    programs = {
        "multi_stencil_3d_kernel": pde.PDE({"u": "laplace(u) + u - u**3"})
        .make_fused_euler_window(state, 0.05).program,
        "multi_stencil_ext_3d_kernel": pde.AllenCahnPDE()
        .make_fused_euler_window(state, 0.05, mesh=mesh).program}
builds = cs.build_programs(list(programs.values()))
print(json.dumps({kernel: {"path": b["path"], "log": b["log"], "ladder": p.ladder,
                           "tiles": {str(d)[6:]: t for d, t in p.tiles.items()}}
                  for (kernel, p), b in zip(programs.items(), builds)}))
"""


def _scalar_kernels(copies) -> dict:
    """Each copy's scalar-side Allen-Cahn libraries, built at once, one process a copy."""
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
    """ptxas' report and the SASS summary of the scalar-side #5 and #6
    kernels of `parent`'s copy beside this tree's, for each dtype and k."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from scripts.torch_tree_compare import _sass

    builds = _scalar_kernels([parent, str(ROOT)])
    nvcc = cc._nvcc()
    same = True
    for kernel in ("multi_stencil_3d_kernel", "multi_stencil_ext_3d_kernel"):
        mine = builds[str(ROOT)][kernel]
        for dtype, tag in (("float32", "Ef"), ("float64", "Ed")):
            for k in mine["ladder"]:
                tile = mine["tiles"][dtype][str(k)]
                needles = (kernel, "{}Li{}ELi{}ELi{}ELi{}E".format(tag, k, *tile))
                cells, hashes = [], []
                for copy in (parent, str(ROOT)):
                    built = builds[copy][kernel]
                    ptx = " | ".join(smoke._ptxas_of(built["log"], *needles))
                    sass = ", ".join(sorted(_sass(nvcc, built["path"], needles, None).values()))
                    hashes.append(sass)
                    cells.append(f"{copy}: {ptx}; SASS {sass or 'not read'}")
                same = same and hashes[0] == hashes[1] and bool(hashes[0])
                print(f"[sides3d sass] {kernel} {dtype} k={k}: " + " || ".join(cells)
                      + f" -> {'same SASS' if hashes[0] == hashes[1] else 'SASS DIFFERS'}",
                      flush=True)
    print(f"[sides3d sass] the scalar-side #5 and #6 kernels "
          f"{'keep' if same else 'do NOT keep'} {parent}'s SASS", flush=True)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False; no result")

    import chip_smoke as smoke
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.parallel import GridMesh

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    units = smoke._sides3d_units(pde, torch, np, device)
    grid = pde.UnitGrid([256] * 3, periodic=True)
    state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=device)
    mesh = GridMesh(grid, [2, 2, 2], devices=[device] * 8)
    ac_serial = pde.PDE(smoke.ALLEN_CAHN_3D).make_fused_euler_window(state, 0.05).program
    ac_ext = pde.AllenCahnPDE().make_fused_euler_window(state, 0.05, mesh=mesh).program
    programs = units["units"] + [ac_serial, ac_ext]
    start = time.perf_counter()
    builds = cs.build_programs(programs)
    cpu = ", ".join(f"{p.library} {b['cpu_seconds']:.1f}" for p, b in zip(programs, builds))
    print(f"built {len(programs)} libraries in {time.perf_counter() - start:.1f} s "
          f"(CPU s {cpu})", flush=True)
    by_digest = {p.digest: b for p, b in zip(programs, builds)}
    start = time.perf_counter()
    errs = smoke._sides3d_phase(pde, torch, np, device, smi, units)
    print(f"phase 61 in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    rows = smoke._sides3d_main(pde, torch, np, device, smi, units, by_digest, errs)
    print(f"phase 62 in {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    f32 = torch.float32
    smoke._sides3d_sass(smi, [
        ("allen-cahn 256^3 periodic", "multi_stencil_3d_kernel", ac_serial.ladder,
         ac_serial.tiles[f32], by_digest[ac_serial.digest]),
        ("allen-cahn periodic [2, 2, 2]", "multi_stencil_ext_3d_kernel", ac_ext.ladder,
         ac_ext.tiles[f32], by_digest[ac_ext.digest])])
    if "--parent" in sys.argv:
        _compare(smoke, sys.argv[sys.argv.index("--parent") + 1])


if __name__ == "__main__":
    main()
