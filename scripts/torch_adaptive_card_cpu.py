"""Where the README example's adaptive run on an NVIDIA GPU parts from the
same run on the CPU, in fp64 (``pde_tpu_torch``, Euler step doubling).

``DiffusionPDE(0.1).solve(state, t_range=10)`` on 64², no dt, ``tracker=None``,
``uniform`` data from seed 0, runs three times:

- on the CPU and on the card, every trial's ``adjust_dt(dt_step, error_rel)``
  recorded: the first trial where the two runs' dt, error or proposal differ,
  and whether the proposal differs for equal inputs;
- on the card again, with the one power in ``adjust_dt``
  (``error_rel ** -0.2``) taken on the CPU: if this run equals the CPU run bit
  for bit, the power is the only operation whose bits differ;
- and every error of the card run through ``x ** -0.2`` on both devices: how
  many results differ, and by how many units in the last place.

Run from the repository root on a machine with a GPU::

    python3 scripts/torch_adaptive_card_cpu.py

Prints one line per finding, then the card's name and power limit as
``nvidia-smi`` gives them.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402  (the repository root's helpers)


def _readme_run(pde, np, torch, device, record):
    """The README run on `device`, its adjust_dt replaced by ``record(recording)``
    (``recording`` keeps every trial's inputs and proposal)."""
    from pde_tpu_torch.solvers import base as solver_base

    adjust = solver_base.adjust_dt
    trials = []

    def recording(dt_step, error_rel):
        out = adjust(dt_step, error_rel)
        trials.append(torch.stack([dt_step, error_rel, out]))
        return out

    solver_base.adjust_dt = record(recording)
    try:
        data = np.random.default_rng(0).uniform(size=(64, 64))
        state = pde.ScalarField(pde.UnitGrid([64, 64]), data, dtype=torch.float64,
                                device=device)
        result, info = pde.DiffusionPDE(0.1).solve(state, t_range=10, tracker=None,
                                                   ret_info=True)
    finally:
        solver_base.adjust_dt = adjust
    log = torch.stack(trials).cpu().numpy() if trials else np.empty((0, 3))
    return result.data.cpu().numpy(), info["solver"], log


def _ulps(np, a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a.view(np.int64) - b.view(np.int64))


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_adaptive_card_cpu: no CUDA device")
    import pde_tpu_torch as pde

    device = torch.device("cuda", 0)
    runs = {
        "cpu": _readme_run(pde, np, torch, "cpu", lambda f: f),
        "card": _readme_run(pde, np, torch, device, lambda f: f),
        "card, power on the CPU": _readme_run(
            pde, np, torch, device, lambda f: smoke._host_power_adjust_dt(torch)),
    }
    cpu_state, cpu_info, cpu_log = runs["cpu"]
    for name, (state, info, log) in runs.items():
        if name == "cpu":
            continue
        line = (f"[card/cpu] {name}: {info['steps']} steps, final dt {info['dt']!r} "
                f"(CPU {cpu_info['steps']}, {cpu_info['dt']!r}; "
                f"rel diff {abs(info['dt'] - cpu_info['dt']) / cpu_info['dt']:.3e}), "
                f"state max_abs diff {np.abs(state - cpu_state).max():.3e}")
        if name == "card":
            n = min(len(log), len(cpu_log))
            differs = [np.flatnonzero(log[:n, j] != cpu_log[:n, j]) for j in range(3)]
            first = [int(d[0]) if d.size else None for d in differs]
            line += (f"; {len(log)} trials (CPU {len(cpu_log)}); first trial differing in "
                     f"dt {first[0]}, error {first[1]}, proposal {first[2]}")
            same_in = (log[:n, 0] == cpu_log[:n, 0]) & (log[:n, 1] == cpu_log[:n, 1])
            odd = np.flatnonzero(same_in & (log[:n, 2] != cpu_log[:n, 2]))
            line += f"; proposals differing for equal inputs: {odd.size} (first {odd[:1].tolist()})"
            errors = torch.as_tensor(log[:, 1]).abs()
            on_card = (errors.to(device) ** -0.2).cpu().numpy()
            on_cpu = (errors ** -0.2).numpy()
            ulps = _ulps(np, on_card, on_cpu)
            line += (f"; x ** -0.2 over its {len(errors)} errors: {int((ulps > 0).sum())} "
                     f"differ, at most {int(ulps.max())} ulp")
        print(line, flush=True)
    print(smoke._nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
