"""Times the layouts of the 3D RK4 step of a two-deep rhs through kernels #5
and #6 on one NVIDIA GPU, in turns, to choose the layout the port keeps.

The layouts:

- ``parent``: the layout of another copy of the package (``--parent DIR``,
  for example the commit before the cut, unpacked by ``git archive`` into a
  git-ignored folder: one march of the whole step, eight planes of halo,
  the fields read from the pass's input, compact planes, one block an SM),
  timed in a process of its own, before and after this tree's;
- ``S``: the step cut into four passes of one RK stage each (two planes of
  halo, ``pass_stages = (1,)``), each asking for two blocks an SM;
- ``S1``: the same passes asking for one block an SM (``PASS_MIN_BLOCKS = 1``:
  no register cap);
- ``T``: two passes of two stages each (four planes of halo, ``pass_stages
  = (2,)``).

For Cahn-Hilliard, Swift-Hohenberg and Kuramoto-Sivashinsky on a periodic
256³ grid and ``laplace(c**3 - c - laplace(c))`` with a face in time on a
bounded one (the side-input kernels A and B), fp32 and fp64, serially (one step of ``multi_stencil_3d``) and
over the eight 128³ blocks of a [2, 2, 2] mesh (one step of
``multi_stencil_ext_3d`` on exchanged buffers, halo 8): each step held
against its plain version, then timed with CUDA events over 20 steps, this
tree's layouts in turns S S1 T T S1 S. Beside each: the bytes a cell-step
its passes move (each input read once and each output written once, on the
cells each pass reads and writes), the window cells a block loads a cell it
writes (y and z, the mean over the passes), the blocks an SM its shared
memory and registers allow, ptxas' registers and spills. Then, once, why
the parent's #6 over eight 128³ blocks beats its serial 256³ step: the
parent's serial step on one 128³ grid (64 blocks of its plan, under half
the SMs), eight times, and on a 1024×128×128 grid, which has the cells and
the blocks of 256³ and the planes (rows of 128 cells) of a 128³ block,
beside both. Run from the repository root on a machine with a
GPU and nvcc::

    python3 scripts/torch_rk4_3d_sweep.py --parent _archive/parent
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 256
DT = 1e-3
MESH = [2, 2, 2]
MODELS = ("cahn-hilliard", "swift-hohenberg", "kuramoto-sivashinsky", "sides")
CH_EXPR = "laplace(c**3 - c - laplace(c))"
T0 = 0.35
REPEATS = 20
SM_SMEM = 228 * 1024  # shared memory an SM holds (1 KiB of it reserved a block)
SM_REGS = 65536


def _model(pde, name):
    """The model `name`; "sides": ``laplace(c**3 - c - laplace(c))`` with a
    face in time (y- ``0.1*sin(3*t)``, y+ 0, the rest no-flux), on a bounded
    grid, through the side-input kernels A and B."""
    if name == "sides":
        return pde.PDE({"c": CH_EXPR}, bc={
            "x": {"derivative": 0}, "y-": {"value_expression": "0.1*sin(3*t)"},
            "y+": {"value": 0}, "z": {"derivative": 0}})
    return {"cahn-hilliard": pde.CahnHilliardPDE, "swift-hohenberg": pde.SwiftHohenbergPDE,
            "kuramoto-sivashinsky": pde.KuramotoSivashinskyPDE}[name]()


def _views(program, dtype, device):
    """A pass's views of the program's side inputs (None without), from t0 = T0."""
    if program.sides is None:
        return None
    return program.sides.passes(T0, 1, DT, dtype, device)(0, 1)


def _flags(program, mesh):
    """Every block's flags: its face flags, and its origin where the program
    has side inputs."""
    return [mesh.edge_flags(b) + (list(mesh.block_origin(b)) if program.sides else [])
            for b in range(len(mesh))]


def _ms(torch, fn, repeats: int = REPEATS) -> float:
    """Milliseconds a call of `fn`, CUDA events over `repeats` calls after one."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _registers(log: str, *needles: str) -> list[tuple[int, int]]:
    """(registers, spill store bytes) of each kernel whose mangled name holds
    every needle, in ptxas' report."""
    found, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and all(n in line for n in needles):
            regs = spills = None
            for later in lines[i + 1:i + 6]:
                if "Used" in later and "registers" in later:
                    regs = int(later.split("Used")[1].split("registers")[0])
                if "spill stores" in later:
                    spills = int(later.split("bytes spill stores")[0].split(",")[-1])
            found.append((regs, spills))
    return found


def _blocks(smem: int, regs: int | None) -> int:
    """Blocks of 512 threads an SM holds with `smem` bytes and `regs`
    registers a thread."""
    by_smem = SM_SMEM // (smem + 1024)
    by_regs = SM_REGS // (512 * regs) if regs else 4
    return max(0, min(by_smem, by_regs, 4))


# times the parent's layout, in a process whose package is DIR's, and prints
# {key: {...}} as JSON; argv: DIR, the models
_PARENT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import pde_tpu_torch as pde
from pde_tpu_torch.ops import cuda_ext_3d as e3, cuda_stencil_2d as cs, cuda_stencil_3d as s3
from pde_tpu_torch.parallel import GridMesh, HaloExchange
N, DT, REPEATS = 256, 1e-3, 20
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
pde.config["parallel.devices_per_device"] = 8
def ms(fn):
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPEATS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPEATS
def model(name):
    if name == "sides":
        return pde.PDE({"c": "laplace(c**3 - c - laplace(c))"}, bc={
            "x": {"derivative": 0}, "y-": {"value_expression": "0.1*sin(3*t)"},
            "y+": {"value": 0}, "z": {"derivative": 0}})
    return {"cahn-hilliard": pde.CahnHilliardPDE, "swift-hohenberg": pde.SwiftHohenbergPDE,
            "kuramoto-sivashinsky": pde.KuramotoSivashinskyPDE}[name]()
small = pde.UnitGrid([N // 2] * 3, periodic=True)
long = pde.UnitGrid([4 * N, N // 2, N // 2], periodic=True)
programs, meshes = {}, {}
for name in sys.argv[2:]:
    grid = pde.UnitGrid([N] * 3, periodic=name != "sides")
    meshes[name] = GridMesh(grid, [2, 2, 2], devices=[dev] * 8)
    state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=dev)
    programs[(name, "serial")] = model(name).make_fused_rk4_window(state, DT).program
    programs[(name, "ext")] = model(name).make_fused_rk4_window(
        state, DT, mesh=meshes[name]).program
programs[("cahn-hilliard", "serial 128")] = model("cahn-hilliard").make_fused_rk4_window(
    pde.ScalarField(small, 0.0, dtype=torch.float32, device=dev), DT).program
programs[("cahn-hilliard", "serial long")] = model("cahn-hilliard").make_fused_rk4_window(
    pde.ScalarField(long, 0.0, dtype=torch.float32, device=dev), DT).program
builds = cs.build_programs(list(programs.values()))
gen = torch.Generator(device=dev).manual_seed(30)
out = {}
for ((name, where), program), built in zip(programs.items(), builds):
    for dtype in (torch.float32, torch.float64):
        if program.tiles[dtype][1] is None:
            continue
        views = None
        if program.sides is not None:
            views = program.sides.passes(0.35, 1, DT, dtype, dev)(0, 1)
        if where.startswith("serial"):
            spec = cs.multi_stencil_spec(program, 1, dtype)
            data = torch.rand(spec.shape, generator=gen, dtype=dtype, device=dev) - 0.5
            outs = [torch.empty_like(data)]
            t = ms(lambda: s3.multi_stencil_3d([data], spec, outs=outs, sides=views))
        else:
            mesh = meshes[name]
            spec = e3.multi_stencil_ext_3d_spec(program, 1, dtype, mesh.local_shape, 8)
            exchange = HaloExchange(mesh, 8)
            ins, outs = exchange.allocate(1, dtype), exchange.allocate(1, dtype)
            data = torch.rand(mesh.basegrid.shape, generator=gen, dtype=dtype, device=dev) - 0.5
            exchange.load(ins, [[b] for b in mesh.split_field_data(data)])
            exchange.copy(exchange.strips(ins))
            flags = [mesh.edge_flags(b) + (list(mesh.block_origin(b)) if views else [])
                     for b in range(len(mesh))]
            t = ms(lambda: e3.multi_stencil_ext_3d(ins, outs, flags, spec, sides=views))
        tile = program.tiles[dtype][1]
        out[f"{name}|{where}|{str(dtype)[6:]}"] = {
            "ms": t, "tile": tile, "smem": program.smem_bytes(1, tile, dtype.itemsize),
            "log": built["log"], "halo": program.depth}
print(json.dumps(out))
"""


def _parent_times(parent: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _PARENT, parent, *MODELS], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the parent's run failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _programs(pde, torch, s3, e3, device):
    """{(layout, model, where): program} of this tree's layouts."""
    from pde_tpu_torch.parallel import GridMesh

    meshes, programs = {}, {}
    for layout in ("S", "S1", "T"):
        stages = 2 if layout == "T" else 1
        serial = type(f"Serial{layout}", (s3.StencilProgram3D,), {"pass_stages": (stages,)})
        ext = type(f"Ext{layout}", (e3.ExtStencilProgram3D,), {"pass_stages": (stages,)})
        s3.PASS_MIN_BLOCKS = 1 if layout == "S1" else 2
        for name in MODELS:
            grid = pde.UnitGrid([N] * 3, periodic=name != "sides")
            meshes[name] = GridMesh(grid, MESH, devices=[device] * 8)
            state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=device)
            base = _model(pde, name).make_fused_rk4_window(state, DT).program
            args = (grid, base.make_step, base.depth, base.n_fields)
            try:
                programs[(layout, name, "serial")] = serial(*args, carry=True, sides=base.sides)
                programs[(layout, name, "ext")] = ext(*args, carry=True, sides=base.sides)
            except s3.KernelUnsupportedError as err:  # no fp32 plan
                print(f"[rk4 3d sweep] {layout} {name}: {err}", flush=True)
        s3.PASS_MIN_BLOCKS = 2
    return programs, meshes


def _facts(program, dtype, where, log: str, kernel: str) -> dict:
    """Bytes a cell-step, window cells loaded a cell written, blocks an SM,
    registers and spills of a cut step's passes at their plans."""
    size = dtype.itemsize
    letter = "f" if size == 4 else "d"
    n = N // 2 if where == "ext" else N
    moved = loads = 0.0
    regs, spills, blocks = [], [], []
    for p, tile in zip(program.cut(dtype), program.tiles[dtype][1], strict=True):
        grow = ((n + 2 * p.extent) / n) ** 3
        moved += size * grow * (p.n_fields + len(p.outputs))
        loads += (tile[1] + 2 * p.depth) * (tile[2] + 2 * p.depth) / (tile[1] * tile[2])
        found = _registers(log, kernel, f"N5pass{p.index}",
                           "ProgramE{}Li1ELi{}ELi{}ELi{}E".format(letter, *tile)) or [(None, None)]
        regs.append(found[0][0])
        spills.append(found[0][1])
        blocks.append(_blocks(p.smem_bytes(1, tile, size), found[0][0]))
    return {"bytes": moved, "loads": loads / len(program.cut(dtype)), "regs": regs,
            "spills": spills, "blocks": blocks, "tiles": program.tiles[dtype][1]}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False; no result")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3
    from pde_tpu_torch.parallel import HaloExchange

    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)
    before = _parent_times(parent) if parent else {}
    pde.config["parallel.devices_per_device"] = 8
    programs, meshes = _programs(pde, torch, s3, e3, device)
    start = time.perf_counter()
    builds = cs.build_programs(list(programs.values()))
    print(f"built {len(programs)} libraries in {time.perf_counter() - start:.1f} s", flush=True)
    logs = {key: b["log"] for key, b in zip(programs, builds)}
    gen = torch.Generator(device=device).manual_seed(30)
    runs, facts = {}, {}
    for (layout, name, where), program in programs.items():
        for dtype in (torch.float32, torch.float64):
            if program.tiles[dtype][1] is None:
                continue
            key = (layout, name, where, dtype)
            data = torch.rand((N,) * 3, generator=gen, dtype=dtype, device=device) - 0.5
            views = _views(program, dtype, device)
            sides = "_sides" if views else ""
            if where == "serial":
                spec = cs.multi_stencil_spec(program, 1, dtype)
                (got,) = s3.multi_stencil_3d([data], spec, sides=views)
                (ref,) = s3.multi_stencil_3d_plain([data], spec, views)
                outs = [torch.empty_like(data)]
                runs[key] = (lambda spec=spec, data=data, outs=outs, views=views:
                             s3.multi_stencil_3d([data], spec, outs=outs, sides=views))
                kernel = f"multi_stencil{sides}_3d_kernel"
            else:
                mesh = meshes[name]
                spec = e3.multi_stencil_ext_3d_spec(program, 1, dtype, mesh.local_shape, 8)
                exchange = HaloExchange(mesh, 8)
                ins, outs = exchange.allocate(1, dtype), exchange.allocate(1, dtype)
                exchange.load(ins, [[b] for b in mesh.split_field_data(data)])
                exchange.copy(exchange.strips(ins))
                flags = _flags(program, mesh)
                e3.multi_stencil_ext_3d(ins, outs, flags, spec, sides=views)
                got = mesh.combine_field_data(b[0] for b in exchange.interiors(outs))
                ref = s3.multi_stencil_3d_plain([data], cs.multi_stencil_spec(
                    programs[(layout, name, "serial")], 1, dtype), views)[0]
                runs[key] = (lambda spec=spec, ins=ins, outs=outs, flags=flags, views=views:
                             e3.multi_stencil_ext_3d(ins, outs, flags, spec, sides=views))
                kernel = f"multi_stencil{sides}_ext_3d_kernel"
            err = smoke._check_rel(torch, f"{key}", got, ref, dtype, 1)
            facts[key] = {**_facts(program, dtype, where, logs[(layout, name, where)], kernel),
                          "err": err}
    times = {key: [] for key in runs}
    order = ["S", "S1", "T"]
    for turn in (*order, *reversed(order)):
        for key in runs:
            if key[0] == turn:
                times[key].append(_ms(torch, runs[key]))
    pde.config["parallel.devices_per_device"] = 1
    after = _parent_times(parent) if parent else {}
    for name in MODELS:
        for where in ("serial", "ext"):
            for dtype in (torch.float32, torch.float64):
                tag = f"{name}|{where}|{str(dtype)[6:]}"
                parts = []
                if tag in before:
                    old = before[tag]
                    kernel = (f"multi_stencil{'_sides' if name == 'sides' else ''}"
                              f"{'_ext' if where == 'ext' else ''}_3d_kernel")
                    letter = "f" if dtype == torch.float32 else "d"
                    found = _registers(old["log"], kernel,
                                       "E{}Li1ELi{}ELi{}ELi{}E".format(letter, *old["tile"]))
                    regs, spills = found[0] if found else (None, None)
                    loads = ((old["tile"][1] + 2 * old["halo"]) * (old["tile"][2] + 2 * old["halo"])
                             / (old["tile"][1] * old["tile"][2]))
                    parts.append(
                        f"parent {before[tag]['ms']:.4f}/{after[tag]['ms']:.4f} ms at "
                        f"{tuple(old['tile'])}, {old['smem']} B, {2 * dtype.itemsize} B a "
                        f"cell-step, {loads:.2f} cells loaded a cell, "
                        f"{_blocks(old['smem'], regs)} blocks an SM, {regs} registers, "
                        f"{spills} B spilled")
                for layout in order:
                    key = (layout, name, where, dtype)
                    if key not in times:
                        parts.append(f"{layout} no plan")
                        continue
                    f = facts[key]
                    parts.append(
                        f"{layout} {'/'.join(f'{t:.4f}' for t in times[key])} ms at {f['tiles']}, "
                        f"{f['bytes']:.1f} B a cell-step, {f['loads']:.2f} cells loaded a "
                        f"cell, {f['blocks']} blocks an SM, {f['regs']} registers, "
                        f"{f['spills']} B spilled, max_abs {f['err']:.1e}")
                what = f"{N}^3" if where == "serial" else f"eight {N // 2}^3 blocks"
                print(f"[rk4 3d sweep] {name} {what} {str(dtype)[6:]} a step on {smi}: "
                      + "; ".join(parts), flush=True)
    if before:
        for dtype in ("float32", "float64"):
            serial = [d[f"cahn-hilliard|serial|{dtype}"]["ms"] for d in (before, after)]
            ext = [d[f"cahn-hilliard|ext|{dtype}"]["ms"] for d in (before, after)]
            small = [d[f"cahn-hilliard|serial 128|{dtype}"]["ms"] for d in (before, after)]
            long = [d[f"cahn-hilliard|serial long|{dtype}"]["ms"] for d in (before, after)]
            print(f"[rk4 3d sweep] why the parent's #6 beats its #5 ({dtype}, CH): serial "
                  f"256^3 {'/'.join(f'{t:.4f}' for t in serial)} ms, eight 128^3 blocks "
                  f"{'/'.join(f'{t:.4f}' for t in ext)} ms, the serial step on one 128^3 grid "
                  f"x 8 {'/'.join(f'{8 * t:.4f}' for t in small)} ms, on a 1024x128x128 grid "
                  f"(the cells and CTAs of 256^3, the planes and rows of a 128^3 block) "
                  f"{'/'.join(f'{t:.4f}' for t in long)} ms", flush=True)


if __name__ == "__main__":
    main()
