"""Runs phases 51-53 of ``chip_smoke.py`` alone, on one NVIDIA GPU: the movie
on the main path (``[movie]``, ``[movie rates]``), the plots (``[plots]``)
and a user ghost-cell setter against kernel #1 (``[bc setter]``).

It first builds, all at once, the libraries those phases launch: kernel #1
for periodic and for bounded axes, and kernel #12 for periodic axes. Run from
the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_movie_phases.py

The phases' lines, and the build and phase times.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


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
    units = [cc.kernel_source((True, True)), cc.kernel_source((False, False)),
             ce.affine_ext_source((True, True))]
    start = time.perf_counter()
    builds = cs.build_programs(units)
    cpu = ", ".join(f"{unit.library} {built['cpu_seconds']:.1f}"
                    for unit, built in zip(units, builds))
    print(f"built {len(units)} libraries in {time.perf_counter() - start:.1f} s (CPU s {cpu})",
          flush=True)
    start = time.perf_counter()
    result = smoke._movie_phase(pde, torch, np, device, smi)
    print(f"phase 51 in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    smoke._plots_phase(pde, torch, np, device, smi, result)
    print(f"phase 52 in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    smoke._bc_setter_phase(pde, torch, np, device, smi)
    print(f"phase 53 in {time.perf_counter() - start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
