"""Runs phases 44-45 of ``chip_smoke.py`` alone, on one NVIDIA GPU: trackers
and storage around kernels #1, #12 and #7 (frames against the plain loop's,
the [2, 2] run bit-equal to serial, a steady-state stop, the 2048-step
solve's rate per tracker setup, host ms an interrupt, one frame's copy to the
host and a traced solve).

It first builds, all at once, the libraries those phases launch: kernel #1
periodic and bounded (fp32 and fp64), kernel #12 periodic and the
Cahn-Hilliard program of kernel #7. Run from the repository root on a
machine with a GPU and nvcc::

    python3 scripts/torch_trackers_phases.py

The phases' lines, then the build and phase times.
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
    smi = smoke._nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    state = pde.ScalarField(pde.UnitGrid([64, 64], periodic=True), 0.0, dtype=torch.float32,
                            device=device)
    units = [cc.kernel_source((True, True)), cc.kernel_source((False, False)),
             ce.affine_ext_source((True, True)),
             pde.CahnHilliardPDE().make_fused_euler_window(state, 1e-3).program]
    start = time.perf_counter()
    cs.build_programs(units)
    print(f"built {len(units)} libraries in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    smoke._trackers_phase(pde, torch, np, device, smi)
    smoke._trackers_cahn_hilliard(pde, torch, np, device, smi)
    print(f"phases 44-45 in {time.perf_counter() - start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
