"""Runs phases 46-48 of ``chip_smoke.py`` alone, on one NVIDIA GPU: the field
API on the card (``[api]``), Kuramoto-Sivashinsky through kernels #7, #10 and
#9 (``[ks]``) and the plain-torch models and 1D grids (``[rd kg 1d]``).

It first builds, all at once, the libraries those phases launch: the KS
programs of kernel #7 (periodic and no-flux), of #10 and #9, kernel #1
periodic and the six stencil operators (``evaluate``'s kernels). Run from
the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_api_ks_phases.py

The phases' lines, the build and phase times, and the KS kernels' JSON rows.
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
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_op_2d as so

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    windows = smoke._ks_windows(pde, torch, device)
    ks_units = list({w.program.digest: w.program for w in windows.values()}.values())
    units = ks_units + [cc.kernel_source((True, True)), so.kernel_source()]
    start = time.perf_counter()
    builds = cs.build_programs(units)
    cpu = ", ".join(f"{built['cpu_seconds']:.1f}" for built in builds)
    print(f"built {len(units)} libraries in {time.perf_counter() - start:.1f} s (CPU s {cpu})",
          flush=True)
    logs = {unit.digest: built["log"] for unit, built in zip(units, builds)}
    start = time.perf_counter()
    smoke._api_phase(pde, torch, np, device, smi)
    rows = smoke._ks_phase(pde, torch, np, device, smi, windows, logs)
    smoke._rd_kg_1d_phase(pde, torch, np, device, smi)
    print(f"phases 46-48 in {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))


if __name__ == "__main__":
    main()
