"""Runs phases 58-60 of ``chip_smoke.py`` alone, on one NVIDIA GPU: the side
inputs of the ext kernels #12 and #8 against their plain versions
(``[sharded sides]``), the decomposed main paths through them, bit-equal to
the serial side-input windows (``[sharded sides main]``, with the scalar-side
ext kernels' registers and SASS in ``[2d plan]``), and the plain pieces:
global reductions in a decomposed rhs, anti-periodic cut axes and
``split_mpi`` (``[a9 plain]``).

It first builds, all at once, the libraries those phases launch: the
side-input libraries and programs, kernel #1's side-input library (the
serial windows of phase 59), the scalar #12 libraries (periodic and
bounded), the no-flux Cahn-Hilliard ext program and the main path's #1
library. Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_sharded_sides_phases.py

The phases' lines, the build and phase times, and the kernels line of the
two side-input modes.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False; no result")

    import chip_smoke as smoke
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    units = smoke._sharded_side_units(pde, torch, np, device)
    ch_scalar = smoke._ext_windows(pde, torch, device)["cahn-hilliard no-flux"]
    scalar_units = [ce.affine_ext_source(p) for p in ((True, True), (False, False))]
    programs = units["units"] + scalar_units + [
        ch_scalar.program, cc.kernel_source((False, False), cc.SIDES_LIBRARY),
        cc.kernel_source((True, True))]
    start = time.perf_counter()
    builds = cs.build_programs(programs)
    cpu = ", ".join(f"{p.library} {b['cpu_seconds']:.1f}" for p, b in zip(programs, builds))
    print(f"built {len(programs)} libraries in {time.perf_counter() - start:.1f} s "
          f"(CPU s {cpu})", flush=True)
    by_digest = {p.digest: b for p, b in zip(programs, builds)}
    start = time.perf_counter()
    errs = smoke._sharded_sides_phase(pde, torch, np, device, smi, units)
    print(f"phase 58 in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    rows = smoke._sharded_sides_main(pde, torch, np, device, smi, units, by_digest, errs,
                                     scalar_units, ch_scalar)
    print(f"phase 59 in {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    start = time.perf_counter()
    smoke._a9_plain_phase(pde, torch, np, device, smi)
    print(f"phase 60 in {time.perf_counter() - start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
