"""Runs phases 49-50 of ``chip_smoke.py`` alone, on one NVIDIA GPU: the 9-point
corner-weight mode of kernels #1 and #12 (``[corner]``) and the operator
options and axis operators on the card (``[ops options]``).

It first builds, all at once, the libraries those phases launch: the 9-point
mode's libraries of #1 and #12, and the periodic 5-point libraries of #1 and
#12, whose registers and SASS phase 49 prints. Run from the repository root
on a machine with a GPU and nvcc::

    python3 scripts/torch_corner_phases.py

The phases' lines, the build and phase times, and the two kernels' JSON rows.
"""

from __future__ import annotations

import json
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
    corner_units = smoke._corner_units(pde, torch)
    five_point_units = {"affine_laplace_2d": cc.kernel_source((True, True)),
                        "affine_laplace_ext_2d": ce.affine_ext_source((True, True))}
    units = corner_units + list(five_point_units.values())
    start = time.perf_counter()
    builds = cs.build_programs(units)
    cpu = ", ".join(f"{unit.library} {built['cpu_seconds']:.1f}"
                    for unit, built in zip(units, builds))
    print(f"built {len(units)} libraries in {time.perf_counter() - start:.1f} s (CPU s {cpu})",
          flush=True)
    start = time.perf_counter()
    rows = smoke._corner_phase(pde, torch, np, device, smi, dict(zip(corner_units, builds)),
                               {name: builds[len(corner_units) + i]
                                for i, name in enumerate(five_point_units)})
    smoke._ops_options_phase(pde, torch, np, device, smi)
    print(f"phases 49-50 in {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))


if __name__ == "__main__":
    main()
