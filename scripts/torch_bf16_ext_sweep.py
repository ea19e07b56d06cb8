"""Times the bf16 mode of the ext kernel #8 (the multi-field window on the
extended blocks of a decomposed 2D grid, bf16 planes; the kernel of
``csrc/march_bf16_ext_2d.cuh``, whose blocks march edge-free where their
windows meet no flagged side) on one NVIDIA GPU, against the bf16 kernel of
another copy of the package, in turns.

The cases: Cahn-Hilliard over the four 2048² blocks of a [2, 2] mesh of
4096², each program at the top k of its ladder (Euler k = 4, RK4 k = 1):
periodic (``CahnHilliardPDE()``), with side inputs (``laplace(c**3 - c -
laplace(c))`` under ``chip_smoke.py``'s phase 58 conditions, tables from t0
= 0.35) and with no flux on every side (scalar sides). Each pass is held
against #8's plain version on the same exchanged buffers (one bf16 ulp of
max|f|), and at two chunks of rows (the launch's, ``launch_chunk``, and 64,
which move blocks between the interior and the edge march) bit-identical;
beside it the share of blocks marching interior at each chunk, ptxas'
registers and spills, the blocks an SM its registers and shared memory
allow, and, from ``cuobjdump -sass`` of its kernel, the instructions, the
bf16 conversions (``F2F``, ``F2FP``), the 2-byte global loads and stores and
the shared loads. Then every pass is timed with CUDA events over 200 calls,
twice, beside its bound (4 bytes a cell of each field and the side tables
over 3.35 TB/s, or the step's operations over 67 TFLOP/s).

With ``--parent DIR`` (another copy of the package, for example the parent
commit unpacked by ``git archive`` into a git-ignored folder), the same
passes of DIR's bf16 kernel are timed in a process whose package is DIR's,
before and after this copy's (parent, change, change, parent), and the
float32 and float64 kernels of #8 and #7 on the same programs are built in
both copies and their source digests and SASS compared function by function
(the names with nvcc's anonymous namespace, which is named after the source
file's path, left out). ``--diagnose`` then times each bounded case's pass
with every block's flags zeroed (every block interior: what the edge blocks
cost) and at chunks of 128, 64, 32 and 16 rows. ``--check`` stops after the
checks (a first call of a new kernel); ``--sass-dir DIR`` writes the SASS of
the periodic Euler case's library there. Run from the repository root on a
machine with a GPU and nvcc::

    python3 scripts/torch_bf16_ext_sweep.py [--check] [--diagnose] [--parent _archive/parent]
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
MESH = [2, 2]
DT = 1e-3
T0 = 0.35
REPEATS = 200
SECOND_CHUNK = 64
CASES = (("periodic", "euler"), ("periodic", "rk4"), ("side inputs", "euler"),
         ("side inputs", "rk4"), ("no-flux", "euler"), ("no-flux", "rk4"))
SM_SMEM = 228 * 1024  # shared memory an SM holds (1 KiB of it reserved a block)
SM_REGS = 65536
# a line of cuobjdump's SASS that holds an instruction: its address, then the opcode
_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
# nvcc's name of a source file's anonymous namespace in a mangled name: its
# length, then _GLOBAL__N__ and a hash of the file's path
_ANONYMOUS = re.compile(r"(\d+)_GLOBAL__N_")


def _equation(pde, np, case: str):
    """(grid, equation) of a case on the 4096² grid."""
    from scripts import torch_bf16_phases as bfp

    if case == "side inputs":
        return bfp.ch_case(pde, np, N, True)
    if case == "no-flux":
        noflux = {"derivative": 0}
        return pde.UnitGrid([N, N]), pde.CahnHilliardPDE(bc_c=noflux, bc_mu=noflux)
    return pde.UnitGrid([N, N], periodic=True), pde.CahnHilliardPDE()


def passes(device) -> dict:
    """{(case, scheme): {"program", "mesh", "spec", "ins", "outs", "flags",
    "views"}}: the bf16 #8 pass of each case at the top k of its ladder, on
    buffers of seeded values, in the package first on ``sys.path`` (this
    copy's or another's: only names both have are used)."""
    import numpy as np
    import torch

    import chip_smoke as smoke
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.parallel import GridMesh

    pde.config["parallel.devices_per_device"] = 4
    out = {}
    for case, scheme in CASES:
        grid, eq = _equation(pde, np, case)
        state = pde.ScalarField(grid, 0.0, dtype=torch.bfloat16, device=device)
        mesh = GridMesh(grid, MESH, devices=[device] * 4)
        hook = eq.make_fused_euler_window if scheme == "euler" else eq.make_fused_rk4_window
        out[(case, scheme)] = {"program": hook(state, DT, mesh=mesh).program, "mesh": mesh}
    start = time.perf_counter()
    builds = cs.build_programs([p["program"] for p in out.values()])
    print(f"built {len(builds)} libraries in {time.perf_counter() - start:.1f} s", flush=True)
    for i, ((case, scheme), p) in enumerate(out.items()):
        program, mesh = p["program"], p["mesh"]
        local = mesh.local_shape
        ladder, halo = smoke._ext_ladder(program, local)
        k = ladder[0]
        gen = torch.Generator(device=device).manual_seed(31 + i)
        ins, outs, flags = smoke._ext_side_blocks(torch, mesh, halo, torch.bfloat16, gen,
                                                  program.n_fields)
        sides = program.sides is not None
        flags = [f[:6] if sides else f[:4] for f in flags]
        flags = [[0 if program.geometry.periodic[j // 2] else v for j, v in enumerate(f[:4])]
                 + f[4:] for f in flags]
        p.update(build=builds[i], halo=halo, k=k, ins=ins, outs=outs, flags=flags,
                 spec=ce.multi_stencil_ext_spec(program, k, torch.bfloat16, local, halo),
                 views=program.sides.passes(T0, k, DT, torch.bfloat16, device)(0, k)
                 if sides else None)
    pde.config["parallel.devices_per_device"] = 1
    return out


def time_passes(runs: dict) -> dict:
    """{(case, scheme): ms a pass} over REPEATS calls of each pass."""
    import torch

    import chip_smoke as smoke
    from pde_tpu_torch.ops import cuda_ext_2d as ce

    return {key: smoke._cuda_ms(torch, lambda p=p: ce.multi_stencil_ext_2d(
        p["ins"], p["outs"], p["flags"], p["spec"], sides=p["views"]), REPEATS)
        for key, p in runs.items()}


def _times_of(copy: str) -> dict:
    """{"case scheme": ms} of the bf16 passes of the package in `copy`, timed
    in a process of its own."""
    proc = subprocess.run([sys.executable, __file__, "--times-of", copy], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the run in {copy} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sass_functions(nvcc: str, path: str, *needles: str) -> dict:
    """{function: {"instructions", "F2F", "F2FP", "LDG.U16", "STG.U16", "LDS",
    "hash"}} of the library's functions whose names hold every needle ({}
    without cuobjdump beside nvcc); the names with the anonymous namespace's
    name replaced by ``<anonymous>``."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    if not cuobjdump.exists():
        return {}
    dump = subprocess.run([str(cuobjdump), "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    found, name, body = {}, None, []
    for line in dump.splitlines() + [None]:
        if line is None or line.strip().startswith("Function : "):
            if name is not None and all(n in name for n in needles):
                ops = [m.group(1) for m in map(_INSTRUCTION.match, body) if m]
                found[_plain_name(name)] = {
                    "instructions": len(ops),
                    "F2F": sum(op.startswith("F2F.") for op in ops),
                    "F2FP": sum(op.startswith("F2FP") for op in ops),
                    "LDG.U16": sum(op.startswith("LDG") and ".U16" in op for op in ops),
                    "STG.U16": sum(op.startswith("STG") and ".U16" in op for op in ops),
                    "LDS": sum(op.startswith("LDS") for op in ops),
                    "hash": hashlib.sha256("\n".join(body).encode()).hexdigest()[:12],
                }
            if line is not None:
                name, body = line.split("Function : ", 1)[1].strip(), []
        elif name is not None:
            body.append(line)
    return found


def _plain_name(name: str) -> str:
    """A mangled name with each anonymous namespace's name (its length says
    how far it runs) replaced by ``<anonymous>``."""
    while (m := _ANONYMOUS.search(name)) is not None:
        name = name[:m.start()] + "<anonymous>" + name[m.end(1) + int(m.group(1)):]
    return name


def _registers(log: str, *needles: str) -> tuple[int | None, int | None]:
    """(registers, spill store bytes) of the first kernel whose mangled name
    holds every needle, in ptxas' report."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and all(n in line for n in needles):
            regs = spills = None
            for later in lines[i + 1:i + 6]:
                if "Used" in later and "registers" in later:
                    regs = int(later.split("Used")[1].split("registers")[0])
                if "spill stores" in later:
                    spills = int(later.split("bytes spill stores")[0].split(",")[-1])
            return regs, spills
    return None, None


def _blocks(smem: int, regs: int | None, threads: int) -> int:
    """Blocks an SM holds with `smem` bytes of shared memory and `regs`
    registers a thread (allocated 8 at a time) at `threads` a block."""
    by_smem = SM_SMEM // (smem + 1024)
    by_regs = SM_REGS // (-(-regs // 8) * 8 * threads) if regs else 32
    return max(0, min(by_smem, by_regs, 2048 // threads))


# builds the float32 and float64 #8 and #7 programs of the cases in the
# package of the copy argv[1]; prints {label: {"digest", "sass": {function:
# hash}}} as JSON
_FP_PROGRAMS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import pde_tpu_torch as pde
from pde_tpu_torch.ops import cuda_stencil_2d as cs
from pde_tpu_torch.parallel import GridMesh
sys.path.insert(0, sys.argv[2])
import torch_bf16_ext_sweep as sweep
dev = torch.device("cuda", 0)
pde.config["parallel.devices_per_device"] = 4
programs = {}
for case in ("periodic", "no-flux", "side inputs"):
    grid, eq = sweep._equation(pde, np, case)
    state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=dev)
    mesh = GridMesh(grid, [2, 2], devices=[dev] * 4)
    for scheme in ("euler", "rk4"):
        hook = eq.make_fused_euler_window if scheme == "euler" else eq.make_fused_rk4_window
        programs[f"#8 {case} {scheme}"] = hook(state, 1e-3, mesh=mesh).program
        programs[f"#7 {case} {scheme}"] = hook(state, 1e-3).program
builds = cs.build_programs(list(programs.values()))
out = {}
for (label, program), built in zip(programs.items(), builds):
    sass = sweep.sass_functions(cs._nvcc(), built["path"])
    out[label] = {"digest": program.digest, "sass": {n: f["hash"] for n, f in sass.items()}}
print(json.dumps(out))
"""


def fp_sass(copy: str) -> dict:
    """The float32 and float64 #8 and #7 programs of the cases, built in the
    package of `copy`: {label: {"digest", "sass"}}."""
    proc = subprocess.run([sys.executable, "-c", _FP_PROGRAMS, copy, str(ROOT / "scripts")],
                          capture_output=True, text=True, cwd=copy)
    if proc.returncode != 0:
        raise RuntimeError(f"the build in {copy} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _times_only(copy: str) -> None:
    """``--times-of DIR``: time the bf16 passes of DIR's package, print JSON."""
    import torch

    sys.path.insert(0, copy)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    times = time_passes(passes(device))
    print(json.dumps({" ".join(key): ms for key, ms in times.items()}), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False; no result")
    if "--times-of" in sys.argv:
        _times_only(sys.argv[sys.argv.index("--times-of") + 1])
        return
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from scripts.torch_bf16_phases import _ulps

    check_only = "--check" in sys.argv
    diagnose = "--diagnose" in sys.argv
    sass_dir = Path(sys.argv[sys.argv.index("--sass-dir") + 1]) if "--sass-dir" in sys.argv \
        else None
    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    runs = passes(device)
    if sass_dir is not None:
        cuobjdump = Path(cs._nvcc()).parent / "cuobjdump"
        sass_dir.mkdir(parents=True, exist_ok=True)
        dump = subprocess.run([str(cuobjdump), "-sass", runs[("periodic", "euler")]["build"][
            "path"]], capture_output=True, text=True, check=True).stdout
        (sass_dir / "bf16_ext.sass").write_text(dump)
    cells = N * N
    for (case, scheme), p in runs.items():
        program, spec, local, halo = p["program"], p["spec"], p["mesh"].local_shape, p["halo"]
        ins, outs, flags, views, k = p["ins"], p["outs"], p["flags"], p["views"], p["k"]
        inner = (slice(halo, -halo),) * 2
        tx, threads = spec.tile
        got, shares = [], []
        for chunk in (None, SECOND_CHUNK):
            ce.multi_stencil_ext_2d(ins, outs, flags, spec, sides=views, chunk=chunk)
            got.append(torch.stack([torch.stack([q[inner] for q in planes]) for planes in outs]))
            rows = chunk or ce.launch_chunk(program, local[0], -(-local[1] // tx), flags)
            blocks = [ce.ext_window_interior(local, halo, f[:4], (r0, c0), tx,
                                             k * program.depth, rows, program.geometry.periodic)
                      for f in flags for r0 in range(0, local[0], rows)
                      for c0 in range(0, local[1], tx)]
            shares.append((rows, sum(blocks) / len(blocks)))
        ref = torch.stack([torch.stack(ce.multi_stencil_ext_2d_plain(q, spec, f, views))
                           for q, f in zip(ins, flags, strict=True)])
        err, ulps, differ = _ulps(torch, got[0], ref)
        identical = torch.equal(got[0], got[1])
        smoke._require(ulps <= 1.0 and identical,
                       f"{case} {scheme}: {ulps:.2f} ulps from the plain version, "
                       f"the two chunks {'bit-identical' if identical else 'differ'}")
        kernel = f"multi_stencil_bf16{'_sides' if views is not None else ''}_ext_2d_kernel"
        needles = (kernel, f"Li{k}ELi{tx}ELi{threads}E")
        regs, spills = _registers(p["build"]["log"], *needles)
        s = next(iter(sass_functions(cs._nvcc(), p["build"]["path"], *needles).values()), {})
        smem = program.march.step_slots * k * (tx + 2 * k * program.depth) * 4
        ext_cells = 4 * (local[0] + 2 * halo) * (local[1] + 2 * halo)
        tables = 0 if views is None else sum(v.numel() * 4 for v in views)
        p["bound"] = smoke._bound((ext_cells + cells) * 2 * program.n_fields + tables,
                                  smoke._program_flops(program) * k * cells)
        print(f"[bf16 ext check] {case} {scheme} k={k} on {smi}: {ulps:.2f} ulps of max|f| "
              f"from the plain version ({differ:.4%} of cells), chunks "
              + " and ".join(f"{rows} rows ({share:.1%} of blocks interior)"
                             for rows, share in shares)
              + f" bit-identical; {regs} registers, {spills} B spilled, "
              f"{_blocks(smem, regs, threads)} blocks an SM; SASS {s.get('instructions')} "
              f"instructions, {s.get('F2F')} F2F, {s.get('F2FP')} F2FP, {s.get('LDG.U16')} "
              f"LDG.U16, {s.get('STG.U16')} STG.U16, {s.get('LDS')} LDS", flush=True)
    if parent is not None:
        here, there = fp_sass(str(ROOT)), fp_sass(parent)
        for label in here:
            same_source = here[label]["digest"] == there[label]["digest"]
            same_sass = here[label]["sass"] == there[label]["sass"]
            print(f"[bf16 ext fp kernels] {label}: source digest {here[label]['digest']} "
                  f"({'the parent' if same_source else 'differs from the parent'}'s), SASS of "
                  f"{len(here[label]['sass'])} functions, by name "
                  f"({'the parent' if same_sass else 'differs from the parent'}'s)", flush=True)
            smoke._require(same_source and same_sass and here[label]["sass"],
                           f"{label}: not the parent's kernel")
    if check_only:
        return
    before = _times_of(parent) if parent else {}
    turns = [time_passes(runs), time_passes(runs)]
    after = _times_of(parent) if parent else {}
    table = {}
    for (case, scheme), p in runs.items():
        tag = f"{case} {scheme}"
        table[tag] = {"this": [t[(case, scheme)] for t in turns],
                      "parent": [before[tag], after[tag]] if parent else None}
        bound = p["bound"]
        best = min(table[tag]["this"])
        print(f"[bf16 ext sweep] CH {tag} k={p['k']} over {MESH} of {N}^2 on {smi}, bound "
              f"{bound[0]:.4f} ms ({bound[1]}): "
              + (f"parent {before[tag]:.4f}, " if parent else "")
              + "this {:.4f}/{:.4f}".format(*table[tag]["this"])
              + (f", parent {after[tag]:.4f}" if parent else "")
              + f" ms a pass ({bound[0] / best:.1%} of the bound)", flush=True)
    if diagnose:
        for (case, scheme), p in runs.items():
            def timed(run_flags, chunk=None, p=p):
                return "/".join(f"{t:.4f}" for t in (smoke._cuda_ms(torch, lambda: (
                    ce.multi_stencil_ext_2d(p["ins"], p["outs"], run_flags, p["spec"],
                                            sides=p["views"], chunk=chunk)), REPEATS)
                    for _ in range(2)))

            parts = []
            if case != "periodic":
                parts.append("flags zeroed " + timed([[0, 0, 0, 0] + f[4:] for f in p["flags"]]))
            for chunk in (128, 64, 32, 16):
                parts.append(f"chunk {chunk} " + timed(p["flags"], chunk))
            print(f"[bf16 ext diagnose] CH {case} {scheme} on {smi}: ms a pass, "
                  + "; ".join(parts), flush=True)
    print(json.dumps({"device": smi, "ms": table}), flush=True)


if __name__ == "__main__":
    main()
