"""Design sweep of pde_tpu_torch's generated 2D multi-field kernels on one NVIDIA GPU.

Times variants of the row-marching template (``march_program_2d`` of
``pde_tpu_torch/csrc/march_2d.cuh``) on the main-path passes of kernels #7
and #8, fp32, periodic: the expression Cahn-Hilliard
``laplace(c**3 - c - laplace(c))`` on 4096² and 1024² (dt = 1e-3, depth 2,
one operand buffer), vector Ginzburg-Landau ``0.2 * vector_laplace(u) + u -
dot(u, u) * u`` on 4096² (two component planes, depth 1) and the ext pass of
decomposed Cahn-Hilliard over the four 2048² blocks of a 2x2 mesh
(``uniform(-0.1, 0.1)`` or ``(-0.5, 0.5)``, seeds 13-16). The variants:

- the control: the parent's square-window kernel (a ``(TILE + 2k·depth)²``
  window per plane, 256 threads, TILE 64, k = 4 for Cahn-Hilliard and 8 for
  Ginzburg-Landau), built from a copy of it held in this script, on the
  program struct the SDE kernels' square window still takes;
- the march at each k (the ladder and one past its top), at strips ``tx`` of
  256, 128 and 64 columns, chunks of 8-512 rows (0: ``chunk_rows`` of the
  shape, as the wrappers pass it), one window column a thread or two, and
  level 0 loaded through registers (the template's route) or by cp.async
  straight into its shared-memory slot (a copy of the march held in this
  script, with one ring row more for the fields of step 0).

Each variant is held against its plain version (chip_smoke's fp32
tolerance, 1e-6 x k relative to max|f|) and timed with CUDA events over 50
passes, all variants in turns, twice;
ptxas' registers and spills beside each, and the SASS opcode counts of the
production kernel at the main pass. Then the production wrappers
(``multi_stencil_2d``, ``multi_stencil_ext_2d``) at every k of their ladders.

Run from the repository root on a machine with a GPU and nvcc::

    python3 scripts/torch_multi2d_sweep.py [--production]

``--production`` skips the variants and times only what any checkout of the
port since its 2D ext kernel has (the wrappers above): copied into an older
checkout, it times that checkout's kernels, so that old and new can be read
in turns in one call.

One line per variant and wrapper (both rounds' ms, ms per step, error,
ptxas' registers and spills), then the card's name and power limit as
``nvidia-smi`` gives them.
"""

from __future__ import annotations

import ctypes
import hashlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as smoke  # noqa: E402  (the repository root's helpers)

REPEATS = 50

# the parent's square-window multi-field kernel (before the row march), the
# control variant; it runs the `level` program struct of emit_program
CONTROL = r"""
template <typename T, int NF>
struct ControlPtrs {
  const T* in[NF];
  T* out[NF];
};

template <class P, typename T, int K, int TILE>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    control_kernel(ControlPtrs<T, P::kFields> io, int n_rows, int n_cols) {
  constexpr int NF = P::kFields;
  constexpr int NB = P::kBuffers;
  constexpr int D = P::kDepth;
  constexpr int H0 = K * D;
  constexpr int W = TILE + 2 * H0;
  constexpr int WW = W * W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  Level<T, NF, NB> lv;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    lv.cur[f] = smem + f * WW;
    lv.nxt[f] = smem + (NF + f) * WW;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) lv.buf[b] = smem + (2 * NF + b) * WW;
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  lv.w = W;
  lv.h0 = H0;
  lv.tile = TILE;
  lv.gr0 = row0 - H0;
  lv.gc0 = col0 - H0;
  lv.n_rows = n_rows;
  lv.n_cols = n_cols;

  for (int i = threadIdx.y; i < W; i += kBlockY) {
    const int gr = lv.gr0 + i;
    const bool row_in = P::kRowsPeriodic || (gr >= 0 && gr < n_rows);
    const int r = P::kRowsPeriodic ? wrap_index(gr, n_rows) : gr;
    for (int j = threadIdx.x; j < W; j += kBlockX) {
      const int gc = lv.gc0 + j;
      const bool col_in = P::kColsPeriodic || (gc >= 0 && gc < n_cols);
      const int c = P::kColsPeriodic ? wrap_index(gc, n_cols) : gc;
      const size_t src = static_cast<size_t>(r) * n_cols + c;
#pragma unroll
      for (int f = 0; f < NF; ++f) lv.cur[f][i * W + j] = (row_in && col_in) ? io.in[f][src] : T(0);
    }
  }
  __syncthreads();

  for (int s = 0; s < K; ++s) {
    P::template level<T>(lv, (K - s) * D);
    __syncthreads();
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      T* tmp = lv.cur[f];
      lv.cur[f] = lv.nxt[f];
      lv.nxt[f] = tmp;
    }
  }

  for (int i = threadIdx.y; i < TILE; i += kBlockY) {
    const int gr = row0 + i;
    if (gr >= n_rows) break;
    for (int j = threadIdx.x; j < TILE; j += kBlockX) {
      const int gc = col0 + j;
      if (gc >= n_cols) break;
      const size_t dst = static_cast<size_t>(gr) * n_cols + gc;
#pragma unroll
      for (int f = 0; f < NF; ++f) io.out[f][dst] = lv.cur[f][(i + H0) * W + j + H0];
    }
  }
}

template <class P, typename T, int K, int TILE>
int control_launch(const void* const* ins, void* const* outs, int n_rows, int n_cols,
                   void* stream) {
  constexpr int NF = P::kFields;
  constexpr int W = TILE + 2 * K * P::kDepth;
  ControlPtrs<T, NF> io;
  for (int f = 0; f < NF; ++f) {
    io.in[f] = static_cast<const T*>(ins[f]);
    io.out[f] = static_cast<T*>(outs[f]);
  }
  const size_t smem = static_cast<size_t>(2 * NF + P::kBuffers) * W * W * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(control_kernel<P, T, K, TILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_cols + TILE - 1) / TILE, (n_rows + TILE - 1) / TILE);
  control_kernel<P, T, K, TILE>
      <<<grid, dim3(kBlockX, kBlockY), smem, static_cast<cudaStream_t>(stream)>>>(io, n_rows,
                                                                                  n_cols);
  return cudaGetLastError();
}
"""


# the march of csrc/march_2d.cuh with level 0 loaded by cp.async straight into
# its slot, which the fields of step 0 pay with one ring row more each (the
# next row lands during the iteration); the load route that lost
ASYNC_MARCH = r"""
template <class P, typename T, int K, int TX, int NT>
struct AsyncShape {
  static constexpr int kHalo = K * P::kDepth;
  static constexpr int kWX = TX + 2 * kHalo;
  static constexpr int kCols = (kWX + NT - 1) / NT;
  static constexpr int kRows = K * P::kStepSlots + P::kFields;
  static constexpr size_t kSmem = size_t(kRows) * kWX * sizeof(T);

  __host__ __device__ static constexpr int ring(int s, int v) {
    return P::volume_slots(v) + (s == 0 && v < P::kFields ? 1 : 0);
  }
  __host__ __device__ static constexpr int base(int s, int v) {
    return s * P::kStepSlots + P::volume_base(v) +
           (s == 0 ? (v < P::kFields ? v : P::kFields) : P::kFields);
  }
  __host__ __device__ static constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }
  __host__ __device__ static constexpr int period() {
    int p = 1;
    for (int s = 0; s < (K > 1 ? 2 : 1); ++s) {
      for (int v = 0; v < P::kVolumes; ++v) p = p / gcd(p, ring(s, v)) * ring(s, v);
    }
    return p;
  }
};

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8 bytes a cell");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  }
}

template <class P, typename T, int K, int TX, int NT, class Geo>
struct AsyncMarch {
  using S = AsyncShape<P, T, K, TX, NT>;
  static constexpr int NF = P::kFields, NV = P::kVolumes, D = P::kDepth, H = K * D;
  static constexpr int M = S::kCols, WX = S::kWX;

  Geo& geo;
  const T* const (&in)[NF];
  T* const (&out)[NF];
  T* const smem;
  const int tid;
  int off[M];
  unsigned flags[M];

  __device__ __forceinline__ AsyncMarch(Geo& geo_, const T* const (&in_)[NF],
                                        T* const (&out_)[NF], T* smem_)
      : geo(geo_), in(in_), out(out_), smem(smem_), tid(threadIdx.x) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int q = tid + m * NT;
      off[m] = 0;
      flags[m] = 0u;
      if (q < WX) {
        const int depth = min(q, WX - 1 - q);
        const RowColumn c = geo.column(q, depth >= H);
        off[m] = c.off;
        flags[m] = c.flags | (unsigned(depth + 1) << kDepthShift);
      }
    }
  }

  __device__ __forceinline__ T* slot(int s, int v, int r) const {
    const int n = S::ring(s, v);
    return smem + (S::base(s, v) + (r % n + n) % n) * WX;
  }

  template <int R>
  __device__ __forceinline__ void load_row() {
    const MarchRow pl = geo.load_next();
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      T* dst = slot(0, f, R);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (!(flags[m] >> kDepthShift)) continue;
        T* cell = dst + tid + m * NT;
        if ((pl.flags & kLoad) && (flags[m] & kLoad)) {
          cp_async(cell, in[f] + pl.off + off[m]);
        } else {
          *cell = T(0);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  template <int R, int SX, int J>
  __device__ __forceinline__ void stage(int t) {
    constexpr int lag = SX * D + P::stage_lag(J);
    constexpr bool output = J + 1 == P::kStages;
    constexpr int first = P::stage_out(J), width = P::stage_width(J);
    constexpr int wr = R - lag;
    if (t < 2 * lag) return;
    const int w = t - lag;
    const MarchRow pl = geo.row(w);
    RowOperands<T, NV> ops;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      ops.lo[v] = slot(SX, v, wr - 1);
      ops.c[v] = slot(SX, v, wr);
      ops.hi[v] = slot(SX, v, wr + 1);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const unsigned f = flags[m];
      const int q = tid + m * NT;
      if ((f >> kDepthShift) <= unsigned(lag)) continue;
      T val[width];
      bool inside = true;
      if constexpr (Geo::kBounded) inside = (f & kDomain) && (pl.flags & kDomain);
      if (inside) {
        P::template stage<J>(ops, q, f, pl.flags, val);
      } else {
#pragma unroll
        for (int i = 0; i < width; ++i) val[i] = T(0);
      }
      if constexpr (output && SX + 1 == K) {
        if (f & kOut) {
#pragma unroll
          for (int i = 0; i < width; ++i) out[i][pl.off + off[m]] = val[i];
        }
      } else {
        constexpr int step = output ? SX + 1 : SX;
#pragma unroll
        for (int i = 0; i < width; ++i) slot(step, first + i, wr)[q] = val[i];
      }
    }
  }

  template <int R, int I>
  __device__ __forceinline__ void stages(int t) {
    if constexpr (I < K * P::kStages) {
      stage<R, I / P::kStages, I % P::kStages>(t);
      stages<R, I + 1>(t);
    }
  }

  template <int U>
  __device__ __forceinline__ void iterate(int t0, int rows) {
    if constexpr (U < S::period()) {
      const int t = t0 + U;
      if (t >= rows) return;
      if (t + 1 < rows) load_row<U + 1>();
      stages<U, 0>(t);
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // the next row has landed
      __syncthreads();
      iterate<U + 1>(t0, rows);
    }
  }

  __device__ __forceinline__ void run(int rows) {
    load_row<0>();
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int t0 = 0; t0 < rows; t0 += S::period()) iterate<0>(t0, rows);
  }
};

template <class P, typename T, int K, int TX, int NT>
__global__ void __launch_bounds__(NT)
    async_march_kernel(RowFieldPtrs<T, P::kFields> io, int n_rows, int n_cols, int chunk) {
  constexpr int H = K * P::kDepth;
  const int r0 = blockIdx.y * chunk;
  const int c0 = blockIdx.x * TX;
  GridRows<P::kRowsPeriodic, P::kColsPeriodic> geo(n_rows, n_cols, r0 - H, c0 - H);
  const T* in[P::kFields];
  T* out[P::kFields];
#pragma unroll
  for (int f = 0; f < P::kFields; ++f) {
    in[f] = io.in[f];
    out[f] = io.out[f];
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AsyncMarch<P, T, K, TX, NT, decltype(geo)> march(geo, in, out,
                                                   reinterpret_cast<T*>(smem_raw));
  march.run(min(chunk, n_rows - r0) + 2 * H);
}

template <class P, typename T, int K, int TX, int NT>
int async_launch(const void* const* ins, void* const* outs, int n_rows, int n_cols, int chunk,
                 void* stream) {
  const int strips = (n_cols + TX - 1) / TX;
  const int chunks = (n_rows + chunk - 1) / chunk;
  RowFieldPtrs<T, P::kFields> io;
  for (int f = 0; f < P::kFields; ++f) {
    io.in[f] = static_cast<const T*>(ins[f]);
    io.out[f] = static_cast<T*>(outs[f]);
  }
  constexpr size_t smem = AsyncShape<P, T, K, TX, NT>::kSmem;
  auto kernel = async_march_kernel<P, T, K, TX, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(strips, chunks), NT, smem, static_cast<cudaStream_t>(stream)>>>(io, n_rows, n_cols,
                                                                                chunk);
  return cudaGetLastError();
}
"""


def _variant(case: str, k: int, tx: int = 256, chunk: int = 0, load: str = "registers",
             threads: int = 0, control: bool = False) -> dict:
    return {"case": case, "k": k, "tx": tx, "chunk": chunk, "load": load, "threads": threads,
            "control": control}


# one build unit per case (and one for its control), all built in parallel
VARIANTS = (
    _variant("ch4096", 4, control=True),
    _variant("gl4096", 8, control=True),
    _variant("ch1024", 4, control=True),
    # Cahn-Hilliard 4096²: every k, then strips, chunks, threads and the load route
    *(_variant("ch4096", k) for k in (1, 2, 4, 8, 16)),
    _variant("ch4096", 4, tx=128),
    *(_variant("ch4096", 4, chunk=c) for c in (64, 128, 256, 512)),
    _variant("ch4096", 4, threads=160),
    _variant("ch4096", 4, load="cp.async"),
    _variant("ch4096", 8, load="cp.async"),
    _variant("ch4096", 16, tx=128),
    # Ginzburg-Landau 4096² (two planes, depth 1)
    *(_variant("gl4096", k) for k in (2, 4, 8, 16)),
    _variant("gl4096", 8, tx=128),
    *(_variant("gl4096", 8, chunk=c) for c in (64, 256)),
    _variant("gl4096", 8, threads=160),
    _variant("gl4096", 8, load="cp.async"),
    # Cahn-Hilliard 1024²: the host-bound size, where the blocks are few
    *(_variant("ch1024", k) for k in (2, 4, 8)),
    *(_variant("ch1024", 4, tx=tx) for tx in (128, 64)),
    *(_variant("ch1024", 4, chunk=c) for c in (8, 32, 64)),
    _variant("ch1024", 4, tx=64, chunk=8),
)


def _threads(v, halo: int) -> int:
    """The variant's threads: as given, else the production rule (one a window
    column, in whole warps)."""
    from pde_tpu_torch.ops.cuda_stencil_2d import row_threads

    return v["threads"] or row_threads(v["tx"] + 2 * halo)


def _needle(v, depth: int) -> tuple[str, str]:
    """The kernel and a piece of the mangled name of variant `v` (float)."""
    if v["control"]:
        return "control_kernel", "EfLi{}ELi64E".format(v["k"])
    kernel = "async_march_kernel" if v["load"] == "cp.async" else "multi_stencil_2d_kernel"
    return kernel, "EfLi{}ELi{}ELi{}E".format(v["k"], v["tx"], _threads(v, v["k"] * depth))


def _label(v) -> str:
    if v["control"]:
        return f"{v['case']} k={v['k']} parent square window (tile 64, 256 threads)"
    chunk = "auto" if v["chunk"] == 0 else v["chunk"]
    threads = f" threads={v['threads']}" if v["threads"] else ""
    return f"{v['case']} k={v['k']} march tx={v['tx']} chunk={chunk} load={v['load']}{threads}"


class _Unit:
    """A source for ``build_programs``: the variants of one case."""

    library = "multi2d_sweep"

    def __init__(self, source: str, flags: str):
        self.source = source
        self.digest = hashlib.sha256((source + flags).encode()).hexdigest()[:16]


def _march_source(program, variants, emit_march_program) -> str:
    lines = ['#include "march_2d.cuh"', "", "namespace pde_tpu_torch {", ASYNC_MARCH,
             "}  // namespace pde_tpu_torch", "", *emit_march_program(program)]
    for v in variants:
        launch = "async_launch" if v["load"] == "cp.async" else "launch_2d"
        lines += [
            f'extern "C" int variant_{v["index"]}(const void* const* ins, void* const* outs, '
            "int n_rows, int n_cols, int chunk, void* stream) {",
            f"  return pde_tpu_torch::{launch}<Program, float, {v['k']}, {v['tx']}, "
            f"{_threads(v, v['k'] * program.depth)}>(ins, outs, n_rows, n_cols, chunk, stream);",
            "}",
        ]
    return "\n".join(lines) + "\n"


def _control_source(program, variants, emit_program) -> str:
    lines = ['#include "multi_stencil_2d.cuh"', "", "namespace pde_tpu_torch {", CONTROL,
             "}  // namespace pde_tpu_torch", "", *emit_program(program)]
    for v in variants:
        lines += [
            f'extern "C" int variant_{v["index"]}(const void* const* ins, void* const* outs, '
            "int n_rows, int n_cols, int chunk, void* stream) {",
            "  (void)chunk;",
            f"  return pde_tpu_torch::control_launch<Program, float, {v['k']}, 64>"
            "(ins, outs, n_rows, n_cols, stream);",
            "}",
        ]
    return "\n".join(lines) + "\n"


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_multi2d_sweep: torch.cuda.is_available() is False; no result")
    production_only = sys.argv[1:] == ["--production"]

    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smoke._nvidia_smi()
    f32 = torch.float32

    def scalar(n, seed):
        return pde.ScalarField.random_uniform(pde.UnitGrid([n, n], periodic=True), -0.1, 0.1,
                                              dtype=f32, device=device,
                                              rng=np.random.default_rng(seed))

    gl_state = pde.VectorField.random_uniform(pde.UnitGrid([4096, 4096], periodic=True), -0.5,
                                              0.5, dtype=f32, device=device,
                                              rng=np.random.default_rng(14))
    states = {"ch4096": scalar(4096, 13), "ch1024": scalar(1024, 15), "gl4096": gl_state}
    eqs = {"ch4096": pde.PDE(smoke.CAHN_HILLIARD), "ch1024": pde.PDE(smoke.CAHN_HILLIARD),
           "gl4096": pde.PDE(smoke.GINZBURG_LANDAU)}
    windows = {case: eqs[case].make_fused_euler_window(states[case], 1e-3) for case in states}
    planes = {"ch4096": [states["ch4096"].data], "ch1024": [states["ch1024"].data],
              "gl4096": [gl_state.data[0], gl_state.data[1]]}
    ext_window = smoke._ext_windows(pde, torch, device)["cahn-hilliard periodic"]

    variants = [dict(v, index=i) for i, v in enumerate(VARIANTS)]
    units, groups = [], []
    if not production_only:
        flags = " ".join(cc._NVCC_FLAGS)
        march_text = (cs._CSRC / "march_2d.cuh").read_text()
        window_text = (cs._CSRC / "multi_stencil_2d.cuh").read_text()
        for case, window in windows.items():
            program = window.program
            for control in (False, True):
                group = [v for v in variants if v["case"] == case and v["control"] == control]
                if not group:
                    continue
                groups.append(group)
                if control:
                    square = cs.WindowProgram(program.grid, program.make_step, program.depth,
                                              program.n_fields)
                    units.append(_Unit(_control_source(square, group, cs.emit_program),
                                       flags + window_text))
                else:
                    units.append(_Unit(_march_source(program, group, cs.emit_march_program),
                                       flags + march_text))
    production = [w.program for w in windows.values()] + [ext_window.program]
    built = cs.build_programs(units + production)
    print(f"[sweep] built {len(built)} libraries on {smi}", flush=True)

    def check(label, got, ref, k):
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        if not (all(bool(torch.isfinite(g).all()) for g in got)
                and err <= smoke.F32_STEP_RTOL * k * scale):
            raise AssertionError(f"{label} disagrees with its plain version: {err}")
        return err

    refs = {}  # (case, k): k plain steps

    def reference(case, k):
        if (case, k) not in refs:
            one = cs.multi_stencil_spec(windows[case].program, 1, f32)
            ref = planes[case]
            for _ in range(k):
                ref = cs.multi_stencil_2d_plain(ref, one)
            refs[(case, k)] = ref
        return refs[(case, k)]

    runs = []  # (label, fn, error, ptxas, k)
    failures = []
    for group, b in zip(groups, built):
        lib = ctypes.CDLL(b["path"])
        for v in group:
            case, k = v["case"], v["k"]
            n = planes[case][0].shape[0]
            fn = getattr(lib, f"variant_{v['index']}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            outs = [torch.empty_like(p) for p in planes[case]]
            ins = (ctypes.c_void_p * len(outs))(*[p.data_ptr() for p in planes[case]])
            out_ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])

            chunk = v["chunk"] or cs.chunk_rows(n, -(-n // v["tx"]))

            def launch(fn=fn, ins=ins, out_ptrs=out_ptrs, n=n, chunk=chunk, label=_label(v)):
                err = fn(ctypes.addressof(ins), ctypes.addressof(out_ptrs), n, n, chunk,
                         torch.cuda.current_stream(device).cuda_stream)
                if err:
                    raise RuntimeError(f"{label}: launch failed with CUDA error {err}")

            try:
                launch()
            except RuntimeError as exc:  # reported, and the sweep fails at its end
                failures.append(str(exc))
                print(f"[sweep] {exc}", flush=True)
                continue
            torch.cuda.synchronize()
            err = check(_label(v), outs, reference(case, k), k)
            ptx = " | ".join(smoke._ptxas_of(b["log"], *_needle(v, windows[case].program.depth)))
            runs.append((_label(v), launch, err, ptx, k))

    # the production wrappers at every k of their ladders, and the ext pass
    for case, window in windows.items():
        outs_p = [torch.empty_like(p) for p in planes[case]]
        for spec in window.specs:
            def serial_pass(spec=spec, outs_p=outs_p, case=case):
                cs.multi_stencil_2d(planes[case], spec, outs=outs_p)

            serial_pass()
            torch.cuda.synchronize()
            err = check(f"{case} k={spec.k}", outs_p,
                        cs.multi_stencil_2d_plain(planes[case], spec), spec.k)
            runs.append((f"production multi_stencil_2d {case} k={spec.k} tile {spec.tile}",
                         serial_pass, err, "", spec.k))
    gen = np.random.default_rng(16)
    for spec in ext_window.specs:
        shape = (2048 + 2 * spec.halo,) * 2
        ext_ins = [[torch.as_tensor(gen.uniform(-0.1, 0.1, shape), dtype=f32, device=device)]
                   for _ in range(4)]
        ext_outs = [[torch.empty_like(x[0])] for x in ext_ins]

        def ext_pass(spec=spec, ext_ins=ext_ins, ext_outs=ext_outs):
            ce.multi_stencil_ext_2d(ext_ins, ext_outs, [[0] * 4] * 4, spec)

        ext_pass()
        torch.cuda.synchronize()
        interior = (slice(spec.halo, spec.halo + 2048),) * 2
        err = max(check("ext", [o[0][interior]], ce.multi_stencil_ext_2d_plain(x, spec, [0] * 4),
                        spec.k) for x, o in zip(ext_ins, ext_outs))
        runs.append((f"production multi_stencil_ext_2d cahn-hilliard 4x2048^2 halo {spec.halo} "
                     f"k={spec.k} tile {spec.tile}", ext_pass, err, "", spec.k))

    if not production_only:  # SASS of the production kernel at the main pass: opcodes by count
        from torch_sde_sweep import _sass_histogram

        spec = windows["ch4096"].specs[0]
        tx, threads = spec.tile
        print(f"[sweep] SASS of the production multi_stencil_2d kernel (Cahn-Hilliard, float, "
              f"k = {spec.k}, tx {tx}, {threads} threads): " + _sass_histogram(
                  Path(cc._nvcc()).parent / "cuobjdump", built[len(units)]["path"],
                  "multi_stencil_2d_kernel", "EfLi{}ELi{}ELi{}E".format(spec.k, tx, threads)),
              flush=True)

    times = [[smoke._cuda_ms(torch, fn, REPEATS) for _, fn, _, _, _ in runs] for _ in range(2)]
    for j, (label, _, err, ptx, k) in enumerate(runs):
        print(f"[sweep] {label}: {times[0][j]:.4f} / {times[1][j]:.4f} ms (two rounds in turns, "
              f"{times[0][j] / k:.4f} ms per step), max_abs {err:.3e}; {ptx}", flush=True)
    print(smi)
    if failures:
        raise SystemExit(f"{len(failures)} variants failed to launch")


if __name__ == "__main__":
    sys.exit(main())
