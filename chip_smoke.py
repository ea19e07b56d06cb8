#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pde_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

1. device: the CUDA device's name, and its name and power limit from
   nvidia-smi; the torch, CUDA and sympy versions;
2. build: nvcc builds, all at once, the 2D affine libraries (template
   ``pde_tpu_torch/csrc/affine_march_2d.cuh``: kernel #1 for each periodicity
   of the two axes, #12 periodic and bounded), ``pde_tpu_torch/csrc/stencil_op_2d.cu``,
   the 3D affine libraries and one library per rhs of the generated
   multi-field kernels (templates ``pde_tpu_torch/csrc/march_2d.cuh``,
   ``pde_tpu_torch/csrc/multi_stencil_3d.cuh`` and, for the SDE windows,
   ``pde_tpu_torch/csrc/multi_stencil_2d.cuh``), for sm_90a;
3. kernel vs plain (diffusion): the affine Laplacian kernel against its plain
   PyTorch version on the card, on the same inputs, at every k of the
   window's ladder in fp32 and fp64: 4096² periodic, each BC form at 1024²,
   an anisotropic grid, both mixed periodicities on a ragged 1000x1530
   grid, grids smaller than the halo (2x5 bounded, 3x4 periodic) and 32²;
4. main path (diffusion): 4096² periodic fp32 ``DiffusionPDE(0.1)`` through
   ``EulerSolver(backend="cuda").make_stepper`` for 37 steps, and the README
   flow ``eq.solve(...)`` on a 1024² no-flux grid; the kernel's launch count
   over this phase must be positive;
5. throughput (diffusion): cell-updates/s of the main path and of the plain
   version; ms of one top-k pass of the kernel, of its plain version and of
   one circular ``nn.Conv2d`` with the composed (2k+1)² stencil (a periodic
   k-step pass is one such convolution; checked against the kernel); ms per
   pass and per step at every k (``[throughput] affine_laplace_2d``), and
   both 2D affine kernels' plan, registers and spills per k and dtype
   (``[2d affine plan]``);
6. kernel vs plain (multi-field): the generated row-marching kernel
   (``csrc/march_2d.cuh``) against its plain version at every k of each
   ladder for Cahn-Hilliard (also no-flux on an anisotropic ragged grid),
   Brusselator, gradient/divergence, dot of gradients and mixed per-side
   BCs, fp32 and fp64, down to a 16² grid;
7. main path (Cahn-Hilliard): the expression PDE
   ``laplace(c**3 - c - laplace(c))`` on a 1024² periodic fp32 state through
   ``EulerSolver(backend="cuda").make_stepper`` and ``eq.solve(...)``, and
   ``CahnHilliardPDE().solve(...)``, against the plain step loop on the card;
   the generated kernel's launch count over this phase must be positive;
8. throughput (Cahn-Hilliard): time-to-solution of 1024² to t = 100 at
   dt = 1e-3, cell-updates/s at 4096², ms per pass by k for kernel and
   plain version at 1024² and for the kernel at 4096² (with its bound and
   launches per 2048-step window), and the row march's plan, stages, slots,
   registers and spills of both generated 2D kernels at their main passes
   (``[2d plan]``);
9. kernel vs plain (SDE): the two Euler-Maruyama kernels against their plain
   versions on the same inputs, for stochastic KPZ (periodic 4096² and 16²,
   no-flux on an anisotropic ragged 1000x1530 grid) and diffusion, fp32 and
   fp64, at every k of the ladder: ``sde_stencil_2d`` on staged increments,
   ``sde_kernel_noise_2d`` under each increment law; and the in-kernel
   stream's independence of the tiling (one k = 8 pass against eight k = 1
   passes, on grids whose tiles touch the periodic seam);
10. main path (SDE): 4096² periodic fp32 ``KPZInterfacePDE(nu=1, lmbda=1,
   noise=0.1)`` through ``EulerSolver(backend="cuda").make_stepper`` (2048
   steps) and ``eq.solve(...)``, once with ``normal`` increments (staged
   kernel) and once with ``irwin4`` (in-kernel noise); each kernel's launch
   count over its run must be positive, the state finite and rough, and the
   staged run equal to the plain step loop on the same stream; then the
   moments of one k = 8 pass of ``DiffusionPDE(0.0, noise=1.0)``'s step from
   zero (mean, variance against k·scale², third moment, within 6 standard
   errors) under each route;
11. throughput (SDE): cell-updates/s of 2048-step windows at 4096² fp32 for
   each increment route, ms per k = 8 pass of each kernel and of its plain
   version, the staged increments' cost, the noise path alone (one k = 8
   pass of each route's zero-rate window), both kernels' registers and
   spills at that pass (``[sde ptxas]``), and the plain loop's rate;
12. kernel vs plain (3D): ``affine_laplace_3d`` at every k it takes (1-4) and
   the generated ``multi_stencil_3d`` at every k of each ladder against their
   plain versions, fp32 and fp64: periodic, no-flux and mixed faces at 256³,
   the 8³ triple seam, and a ragged anisotropic 30x34x38 grid; Allen-Cahn,
   Cahn-Hilliard, the Brusselator and dot-grad no-flux;
13. main path (3D): ``DiffusionPDE(1.0)`` and Allen-Cahn
   ``PDE({"u": "laplace(u) + u - u**3"})`` on a 256³ periodic fp32 state
   (``uniform(-0.1, 0.1)``, seed 0), dt = 0.05, through
   ``EulerSolver(backend="cuda").make_stepper`` (37 steps, against the plain
   loop) and ``eq.solve(...)`` with and without the default trackers; each
   kernel's launch count over its run must be positive;
14. throughput (3D): cell-updates/s of 2048-step windows (best of 3 after a
   warm-up) of both runs and of the diffusion rhs through
   ``multi_stencil_3d``, ms per pass of ``affine_laplace_3d`` at every k
   (and per step; the top k is the least) and of ``multi_stencil_3d`` per
   ladder k (and per step, with the launches per 2048-step window and
   ptxas' registers and spills), each beside its plain version and its
   bound, both kernels' plans, stages and slots (``[3d plan]``) and both
   affine kernels' registers and spills at the main pass (``[3d ptxas]``),
   the plain loop's rate, one
   circular ``nn.Conv3d``
   with the composed stencil of the top-k affine pass, and the device's idle
   share over one ``torch.profiler``-traced 2048-step window of each run;
15. kernel vs plain (stencil operators): ``stencil_op_2d`` for each of its six
   operators and the registry's ``laplace`` (kernel #1 at k = 1), fp32 and
   fp64, against their plain versions on a 4096² periodic grid, anisotropic
   1000x1530 grids with no-flux and with mixed Dirichlet/Neumann/Robin sides,
   one with a periodic axis, and a 16² grid whose tiles touch the seam; and
   the ``cuda`` registry's raises (an unregistered operator, a 1D grid, an
   array BC value);
16. main path (operators and vector states): ``get_backend("cuda")
   .make_operator`` for the seven registered operators on 4096² periodic
   fp32 fields made without ``device=``, against the fields' own methods
   (the plain operators); vector Ginzburg-Landau ``0.2 * vector_laplace(u) +
   u - dot(u, u) * u`` on a 4096² periodic fp32 ``VectorField``
   (``uniform(-0.5, 0.5)``, seed 0, dt = 1e-3), a ``FieldCollection`` mixing
   ranks at 1024² and a 3D vector state at 128³, each through
   ``EulerSolver(backend="cuda").make_stepper`` (37 steps, against the plain
   loop) and ``eq.solve(...)`` with the default trackers; the launch counts of
   ``stencil_op_2d``, ``multi_stencil_2d`` and ``multi_stencil_3d`` over their
   runs must be positive; the vector window's passes against their plain
   versions at every k, fp32 at 4096² and fp64 at 512²;
17. throughput (operators and vector states): ms per call of each registry
   operator at 4096² fp32 (kernel, plain version, bound, and one circular
   ``nn.Conv2d`` with the operator's 3x3 weights and channel layout, TF32
   off, checked against the kernel); cell-updates/s of vector
   Ginzburg-Landau in 2048-step windows (best of 3 after a warm-up) and of
   its plain loop, and the idle share of one traced window.
18. kernel vs plain (decomposed): the two halo-extended kernels,
   ``affine_laplace_ext_2d`` and the generated ``multi_stencil_ext_2d``
   (Cahn-Hilliard, no-flux and periodic), against their plain versions on the
   same extended buffers, fp32 and fp64, at every k of each ladder, with edge
   flags on every side, on four 2048² blocks and four ragged 70x50 blocks
   (the affine one also periodic, with every BC form and with periodic
   rows);
   ms per top-k pass over four 2048² blocks beside the plain versions, the
   bound and (affine) one ``F.conv2d`` with the composed stencil over the
   extended blocks;
19. main path (decomposed): 4096² periodic fp32 ``DiffusionPDE(0.1)``,
   dt = 0.1, through ``eq.solve(..., backend="cuda", decomposition=[2, 2])``
   on four blocks of one card (``parallel.devices_per_device = 4``): 37 steps
   bit-equal to the serial kernel window; cell-updates/s of 2048-step windows of
   the decomposed and the serial stepper in turns (best of 3), launches and
   halo copies per window, and one ``torch.profiler``-traced window (the ext
   kernel's and the exchange copies' device time, the idle share);
20. decomposed BCs: 1024² diffusion with Dirichlet, Neumann and Robin sides on
   [2, 2] and [1, 4] against the serial window;
21. decomposed Cahn-Hilliard: the expression PDE on [2, 2], 1024² bit-equal
   to the serial kernel #7 window, and the rate at 4096² beside serial's;
   each ext kernel's launch count over its runs must be positive;
22. kernel vs plain (decomposed 3D): the two 3D halo-extended kernels,
   ``affine_laplace_ext_3d`` and the generated ``multi_stencil_ext_3d``
   (``AllenCahnPDE()`` periodic, ``0.1 * laplace(c) - 0.05 *
   gradient_squared(c)`` no-flux), against their plain versions on the same
   extended buffers, fp32 and fp64, at k = 1 and the top k, with face flags on
   every side, on eight 128³ blocks and eight ragged 40x36x50 blocks (the
   generated one at every k of its ladder); ms per ``affine_laplace_ext_3d``
   pass (and per step) at every k with halo k, and per
   ``multi_stencil_ext_3d`` pass at every k of its ladder (with ptxas), over
   eight 128³ blocks; ms per top-k pass over them beside the plain versions,
   the bound and
   (affine) one ``F.conv3d`` with the composed (2k+1)³ stencil of the top k
   over the extended blocks;
23. main path (decomposed 3D): 256³ periodic fp32 ``DiffusionPDE(1.0)``,
   dt = 0.05, ``uniform(-0.1, 0.1)``, through ``eq.solve(..., backend="cuda",
   decomposition=[2, 2, 2])`` on eight blocks of one card
   (``parallel.devices_per_device = 8``): 37 steps bit-equal to the serial
   ``affine_laplace_3d`` window; cell-updates/s of 2048-step windows of the
   decomposed and the serial stepper in turns (best of 3), launches and halo
   copies per window and pass, and one ``torch.profiler``-traced window;
24. decomposed 3D BCs, Allen-Cahn and the x-cut: 128³ diffusion with
   Dirichlet, Neumann, Robin and curvature faces on [2, 2, 1], [1, 2, 2] and
   [2, 1, 2] against the serial window; ``AllenCahnPDE()`` 256³ on [2, 2, 2]
   and on the x-cut [2, 1, 1] (``pde_tpu``'s ``ext_x`` route) bit-equal to
   the serial ``multi_stencil_3d`` window (the BC runs bit-equal too), and
   the [2, 2, 2] rate beside serial's;
   each 3D ext kernel's launch count over its runs must be positive;
25. kernel vs plain (RK4 and AB2): the RK4 and AB2 programs of the generated
   kernels #7 (``CahnHilliardPDE()`` and ``AllenCahnPDE()`` 4096² periodic)
   and #5 (``AllenCahnPDE()`` 256³ periodic) against their plain versions at
   every k of their ladders, fp32 and fp64 (AB2's rate planes seeded too);
   ms per top-k fp32 pass beside the plain version and the bound, the
   ladders, plans, stages and slots, and ptxas' registers and spills
   (``[family]``, ``[family throughput]``, ``[family plan]``);
26. main paths (RK4 and AB2): Cahn-Hilliard 4096² and Allen-Cahn 256³ fp32
   through ``solve(..., solver="runge-kutta" / "adams-bashforth", dt=...,
   backend="cuda")``, 20 steps in two tracker windows (AB2's rate planes
   carry over) against the plain loop on the card; each kernel's launch count
   over its run must be positive; cell-updates/s of 2048-step Cahn-Hilliard
   windows (best of 3) and launches a window (``[family main]``);
27. adaptive: the README example as written (64² ``DiffusionPDE(0.1).solve(
   state, t_range=10)``, no dt) on the card; its fp64 run with
   ``tracker=None`` on the card against the same run on the CPU (the same
   accepted steps, the state within 1e-12 and the final dt within 1e-11
   relative); adaptive Euler on 4096² ``DiffusionPDE(0.1)`` to t = 1000 and
   adaptive RKF45 on 1024² ``SwiftHohenbergPDE(rate=0.1)`` with config 3's
   sides (tolerance 1e-6) to t = 20: accepted and rejected trials, host
   reads a window, accepted steps/s, cell-updates/s and the idle share of
   one traced window (``[adaptive]``);
28. kernel vs plain (decomposed RK4 and AB2): the RK4 and AB2 programs of
   the ext kernels #8 (``CahnHilliardPDE()`` and ``AllenCahnPDE()`` on four
   2048² blocks of a periodic 4096² grid, Cahn-Hilliard also no-flux) and #6
   (``AllenCahnPDE()`` on eight 128³ blocks of 256³, periodic and no-flux)
   against their plain versions at every k of their ladders, fp32 and fp64,
   with edge flags on every side on the bounded meshes; ms per top-k fp32
   pass a call and with its launches queued, beside the plain version, the
   bound and ptxas' registers and spills (``[sharded family]``,
   ``[sharded family throughput]``);
29. main paths (decomposed RK4 and AB2): Cahn-Hilliard 4096² on [2, 2] and
   Allen-Cahn 256³ on [2, 2, 2], fp32, through ``solve(..., solver=
   "runge-kutta" / "adams-bashforth", backend="cuda", decomposition=...)``,
   20 steps in two tracker windows (AB2's rate planes carry over, per block)
   bit-equal to the serial windows; each ext kernel's launch count over its
   run must be positive; cell-updates/s of 2048-step windows beside the
   serial window's, launches and halo copies a window and one traced window
   (``[sharded family main]``, ``[sharded trace]``);
30. the plain sharded stepper and adaptive steps over blocks: BASELINE config
   5, ``KPZInterfacePDE(noise=0.1)`` on 4096² periodic fp32, dt = 1e-3,
   ``solver="explicit_sharded"`` on [2, 2]: finite, blocks decorrelated, the
   squared interface width growing and within 6 standard errors of the
   serial kernel #10 run's (another seed) at t = 0.128 and 0.512; its rate
   beside serial's, copy calls a step, device kernels a step and the idle
   share of a traced window; fp64 KPZ, a vector Ginzburg-Landau and a
   ``laplace(c) + x * c`` run at 1024² on [2, 2] bit-equal to the serial
   plain loop; adaptive Euler on 4096² ``DiffusionPDE(0.1)`` and RKF45 on
   1024² Swift-Hohenberg with config 3's sides on [2, 2]: serial's accepted
   steps and state, bit for bit (``[sharded plain]``, ``[sharded adaptive]``);
31. kernel vs plain (curvilinear, BASELINE config 4): kernel #1's radial mode
   on ``CylindricalSymGrid(4096, (0, 4096), (4096, 4096))`` (the main path's
   cells) against its plain version at every k of the ladder, fp32 and fp64,
   with z periodic or bounded and derivative, value and mixed sides on r, and
   the ``cuda`` registry's cylindrical ``laplace`` (k = 1) against it and
   against ``ops/cylindrical.py``; ms a pass at every k of the ladder with
   the bound and ptxas' registers (``[curvilinear throughput]``,
   ``[curvilinear ptxas]``);
32. kernel #7's radial helpers on the same grid: the Cahn-Hilliard and
   ``divergence(gradient(c))`` Euler programs and Cahn-Hilliard's RK4
   program against their plain versions at every ladder k, fp32 and fp64,
   and their passes timed;
33. config 4 end to end: cylindrical diffusion (no-flux, 37 steps through
   ``EulerSolver(backend="cuda").make_stepper`` and ``eq.solve``, against the
   plain version, launches counted), its 2048-step windows (launches a window
   asserted) in turns with the Cartesian main path, with z periodic and on
   ``pde_tpu``'s 2048² grid; the cylindrical Cahn-Hilliard window against the
   plain loop and its rate; spherical and polar diffusion (4096 cells, both
   stencils) on the plain torch path, fp64 against the CPU, and their
   steps/s; every operator of the three grids on vector and tensor fields on
   the card against the CPU in fp64 (``[config 4]``);
34. kernel vs plain (decomposed curvilinear): kernel #12's radial mode (the
   ext kernel of ``csrc/affine_march_2d.cuh`` on the blocks of a decomposed
   ``CylindricalSymGrid(4096, (0, 4096), (4096, 4096))``, each block's flags
   carrying its first row) against its plain version at every k of the
   radial ladder, fp32 and fp64, on [2, 2] with z periodic and bounded, on
   [4, 1] and on a small ragged [2, 2] whose blocks are barely deeper than
   the halo; one top-k pass over four 2048² blocks timed beside the serial
   radial pass, with the bound and ptxas' registers (``[radial ext kernels]``);
35. config 4 on a mesh: cylindrical 4096² no-flux fp32 diffusion through
   ``EulerSolver(backend="cuda", decomposition=[2, 2])`` on four blocks of
   one card, 37 steps against the serial radial window (bit for bit, or
   within 1e-6 a step), the radial ext kernel's launch count over the run
   positive; 2048-step windows in turns with the serial window, launches and
   halo copies a window, one traced window (``[sharded cylindrical main]``,
   ``[sharded trace]``);
36. the plain sharded stepper on curvilinear grids under ``torch``: polar and
   spherical diffusion (4096 cells) on [4] and cylindrical Cahn-Hilliard
   (4096²) on [2, 2], each against its serial plain run on the card, and
   their steps/s (``[sharded curvilinear plain]``);
37. the Poisson solvers (plain torch, as in ``pde_tpu``): the FFT solve of a
   4096² periodic rhs in fp32 and fp64 against the CPU's fp64 solve, its
   residual through the plain ``laplace`` and the registry's (kernel #1 at
   k = 1); BiCGStab on a 512² Dirichlet grid and a 256² cylinder (its
   residual through #1's radial mode) against the CPU's, with iterations,
   host reads and ms; ``helmholtz_decomposition`` of a 4096² fp32 vector
   field, the divergence of its solenoidal part (``[poisson]``);
38. implicit Euler and Crank-Nicolson on 1024² periodic fp64 diffusion (20
   steps at dt = 1) against the CPU and on [2, 2] bit-equal to serial, their
   steps/s; ``ConvergenceError`` raised on the card; the scipy solver on 128²
   against the CPU (``[implicit]``);
39. ETDRK4 on ``pde_tpu``'s stiff configurations (``docs/BENCHMARKS.md:425-445``)
   beside the Euler window (kernel #7) in turns: Cahn-Hilliard 1024² to t =
   100 (time-to-solution, set-up and coefficients apart) and its accuracy
   against the Euler window at dt = 1e-5 (fp64, fp32); 2D Kuramoto-Sivashinsky
   1024² at dx = 0.1 to t = 10 (``KuramotoSivashinskyPDE``'s split) against
   the Euler window extrapolated from t = 0.01; one no-flux KS step (DCT axes)
   against the CPU's; Gray-Scott 512²
   against the CPU (``[etdrk4]``);
40. ETDRK4 on a mesh: Cahn-Hilliard 1024² on [2, 2] bit-equal to serial,
   both steps/s (``[etdrk4 sharded]``);
41. kernel #1's side inputs (B1(c)): 4096² with a per-point Dirichlet array
   on x-, ``value_expression "sin(3*t)"`` on y- and no-flux elsewhere
   (``pde_tpu``'s hardware configuration) against the plain version at every
   k of the ladder, fp32 and fp64, each pass's t-table from t0 = 0.35; a
   2048-step window from t0 through ``solve(backend="cuda")`` against the
   plain loop's solve on the card; the top-k pass beside the same kernel
   with scalar sides and the main path's periodic pass, the windows' rates,
   launches and ptxas (``[sides #1]``);
42. kernel #7's side inputs (B2(b)): Cahn-Hilliard 4096² Euler with
   time-dependent sides, with a side varying in space and time
   (``sin(x - 2*t)``), with a Robin side whose gamma varies along it, and
   RK4 with per-stage times, against their plain versions at every k, fp32
   and fp64; the t-sides window through ``solve(backend="cuda")`` against
   the plain loop; passes beside the scalar-side pass, rates, launches and
   ptxas (``[sides #7]``);
43. BASELINE config 3 with a time-dependent side: Swift-Hohenberg 1024²
   (``value_expression`` on y-) through fixed-dt RK4 on #7 against the
   plain loop, and adaptive RKF45 (plain torch) (``[config 3 sides]``);
44. trackers and storage on the main path (kernel #1): 4096² periodic fp32
   ``DiffusionPDE(0.1)``, dt = 0.1, 2048 steps through
   ``solve(backend="cuda")`` with a ``MemoryStorage`` every 128 steps, the
   consistency and conservation trackers and a ``DataTracker``, every frame
   against the plain loop's on the card (fp32 1e-6 a step; fp64 at 512²,
   1e-12), the times equal; the same solve on [2, 2] through #12 bit-equal
   to the serial frames; a ``SteadyStateTracker`` stop through #1 at the
   plain loop's time and reason; the 2048-step solve's rate with storage
   every 2048, 256 and 32 steps, ``tracker="auto"`` and ``tracker=None`` in
   turns (best of 3), #1's launches and the host ms an interrupt of each,
   one frame's copy to the host (as the storages take it, and into reused
   pageable and pinned memory) and the idle share of a traced solve
   (``[trackers #1]``, ``[trackers #12]``, ``[trackers rates]``,
   ``[trackers trace]``);
45. Cahn-Hilliard 4096² fp32 through #7 (dt = 1e-3, 512 steps) with storage
   every 64 steps, the conservation tracker and a ``DataTracker`` of the
   integral, against the plain loop's frames; the average conserved
   (``[trackers #7]``). Phases 44-45 reset and read the launch counts of
   their kernels around each run.
46. the field API on the card: fields from ``from_expression``,
   ``random_normal``, ``random_harmonic`` and ``random_colored`` on a 4096²
   fp32 grid land on the card, ``random_normal(rng=46)`` equals the same call
   on the CPU bit for bit; ``evaluate("laplace(a*b) + gradient_squared(a)")``
   through the ``cuda`` registry's kernels (#1 at k = 1, ``stencil_op_2d``)
   against the composed field operators (fp32 1e-5, fp64 1e-12, launches
   counted); ``interpolate`` at 10⁶ points against the plain gather in fp64;
   ``smooth(sigma=2)`` and ``insert``; ms a call (``[api]``);
47. ``KuramotoSivashinskyPDE(nu=1)`` 4096², dt = 0.01: its #7 window against
   the plain loop over 64 steps, periodic and no-flux, fp32 and fp64; the
   main path through ``EulerSolver(backend="cuda")`` and ``solve`` (#7's
   launches positive), the top-k pass against its bound and the rate of
   2048-step windows; noisy KS (noise 0.1) through #10 against the plain loop
   on the same stream and through #9 (``irwin4``) by the moments of one k = 1
   pass's increments, each kernel's pass against its plain version and bound;
   ETDRK4 through ``make_etdrk_parts`` bit-equal to the expression PDE's
   (``[ks]``);
48. plain torch on the card: the Brusselator ``ReactionDiffusionPDE`` of
   ``examples/pde_brusselator_rd_pde.py`` at 1024², ``KleinGordonPDE`` at
   4096², 1D KS and 1D diffusion at 4096 cells: 20 fp64 steps of each at a
   small size against the CPU (1e-12), steps/s and the idle share of one
   traced 50-step window (``[rd kg 1d]``);
49. the 9-point corner-weight mode of #1 and #12 (config key
   ``operators.cartesian.laplacian_2d_corner_weight``, w = 1/3 and 1/2):
   registers and spills per k and dtype (``[corner plan]``), and the 5-point
   kernels' registers and SASS beside them; #1 against its plain version at
   every k of its ladder [8, 4, 2, 1] and over a 64-step window at 4096²,
   fp32 and fp64, and on 3x4 and a ragged anisotropic grid; the main path
   ``EulerSolver(backend="cuda")`` at 4096² fp32 under the key (launches of
   the 9-point kernel counted from 0, against the plain loop's 9-point
   stencil), its rate of 2048-step windows beside the 5-point one; [2, 1]
   through #12 bit-equal to serial, and [1, 2] refused under cuda; one k = 8
   pass of each kernel timed against its plain version, its bound and one
   convolution with the composed 17×17 stencil (``[corner]``, ``[corner
   throughput]``);
50. the operator options and axis operators (plain torch) on the card
   against the CPU at 256² fp64, an expression PDE with axis operators, ms a
   call at 4096² fp32, and the cuda registry's refusals (``[ops options]``);
51. the README flow with a movie on the main path: 4096² periodic fp32
   ``DiffusionPDE(0.1)``, dt = 0.1, 2048 steps through ``solve(backend=
   "cuda")`` (#1) with a ``MovieStorage`` (the encode backend it took is
   printed: native, ffmpeg or raw) and a ``MemoryStorage`` every 256 steps:
   every movie frame read back within one quantization step of the memory
   frame, its bytes equal to a host numpy quantization of it; the same solve
   on [2, 2] through #12 writes a byte-equal movie; #1's and #12's launches
   counted from 0; ms a frame split into on-card quantization, copy and
   encode, and the solve's rate against ``tracker=None`` (``[movie]``,
   ``[movie rates]``);
52. plots: with matplotlib (Agg), ``result.plot(filename=...)`` of phase
   51's state and a ``PlotTracker(output_file=...)`` solve on 1024² draw the
   card state's host copy; without it, both raise matplotlib's
   ``ModuleNotFoundError`` as ``pde_tpu``'s do (the line names the branch;
   ``[plots]``);
53. a ``BoundariesSetter`` (a callable ``bc=`` setting Dirichlet-0 ghosts)
   on 1024², 64 steps in the plain loop on the card, against
   ``bc={"value": 0}`` through #1, fp32 and fp64; ``backend="cuda"`` refuses
   the setter (``[bc setter]``);
54. the side inputs of the Euler-Maruyama kernels #9 and #10 (B2(b)):
   ``sde_stencil_2d`` and ``sde_kernel_noise_2d`` with side inputs against
   their plain versions at every k of the ladder, fp32 and fp64, on the main
   path's 4096² grid (x sides ``0.1*sin(3*t)``, y periodic) and on bounded
   4096², 1000x1530 and 16² grids with a per-point array side, a
   time-dependent side and a side varying in space and time, tables from t0
   = 0.35; #9 with side inputs against #10 fed the Philox increments of
   (seed, global step, global cell) (``[sde sides]``);
55. the SDE main path with side inputs: ``KPZInterfacePDE(nu=1, lmbda=1,
   noise=0.1)`` 4096² fp32 with Dirichlet x sides ``0.1*sin(3*t)``, y
   periodic, through ``solve(solver="milstein", backend="cuda")`` for 2048
   steps at dt = 1e-3: ``normal`` increments (#10, against the Milstein plain
   loop on the same stream) and ``irwin4`` (#9), each kernel's side-input
   launches counted from 0; one top-k pass with side inputs beside the
   scalar-side pass, the plain version and the bound; 2048-step windows'
   rates; registers, spills and SASS of the side-input kernels, the
   scalar-side ones and the periodic main path's (``[sde sides main]``);
56. multiplicative noise and Milstein (plain torch) on the card:
   ``pde_tpu``'s ``MultiplicativeDiffusion`` at 1024² fp32 through
   Euler-Maruyama and Milstein in the three interpretations, Itô <
   Stratonovich < anti-Itô in the mean (the variance is a card tensor, fault
   C15); one fp64 Milstein step against the formula on the same draws; 256²
   on [2, 2] bit-equal to serial (``[milstein]``);
57. correlated noise: ``examples/custom_noise.py``'s model against the port
   (``make_correlated_noise_torch``) at 1024² fp32 for 1000 steps; 64
   realizations' spectrum in rings of |k| against the target's, and their
   variance (``[correlated noise]``).
58. the side inputs of the ext kernels #12 and #8 (A9.3's 2D half): each
   against its plain version on the same exchanged buffers, at every k of
   its ladder, fp32 and fp64, on [2, 1], [1, 2] and [2, 2] meshes of 4096²
   and of a ragged 64x70 grid (blocks down to 32x35); #12 with a per-point
   and a time-dependent side, #8 with a time-dependent, a per-point and a
   space-and-time side (Euler and RK4) and with per-point and
   time-dependent ghost factors, tables from t0 = 0.35 (``[sharded sides]``);
59. the decomposed main paths through them on [2, 2]: ``DiffusionPDE(0.1)``
   4096² fp32 (x- ``0.1*sin(3*t)``, x+ no-flux, y- a per-point array, y+ 0)
   through #12 for 2048 steps at dt = 0.1, and Cahn-Hilliard 4096² fp32 (a
   time-dependent, a per-point and a ``cos(x)*sin(t)`` side) through #8's
   Euler and RK4 windows for 2048 steps at dt = 1e-3, each through
   ``solve(backend="cuda")`` and bit-equal to the serial side-input window
   in the same call, their side-input launches counted from 0; one top-k
   pass of each mode beside the scalar-side ext pass, its plain version and
   bound, registers and spills (``[sharded sides main]``); the scalar-side
   ext kernels' registers and SASS (``[2d plan]``);
60. the plain pieces of A9 (plain torch): ``laplace(u) - integral(u)`` on a
   4096-cell polar grid on [4] and on a 1024² Cartesian grid on [2, 2]
   against the serial runs, ms a step and the traced idle share; diffusion
   with an anti-periodic x on [2, 1], bit-equal to serial;
   ``split_mpi(4)`` of a 4096² field and the main path on its mesh through
   #12, bit-equal to serial (``[a9 plain]``);
61. the side inputs of the 3D windows (ROADMAP B2(b)'s and A9.3's 3D halves):
   kernel A (``multi_stencil_sides_3d_kernel``, #5's side-input mode, which
   serves #4 too) and kernel B (``multi_stencil_sides_ext_3d_kernel``, #6's)
   against their plain versions at every k of each ladder, fp32 and fp64,
   tables from t0 = 0.35: a per-point x face, a face in time and a z face in
   space and time (path (a)), a per-point Robin gamma (path (b), Euler and
   RK4), an x face in space and time, per-point y and z faces and a y Robin
   gamma, on 256³ and on a ragged 30x34x38 grid; kernel B over the blocks of
   [2, 1, 1] and [2, 2, 2] meshes of both (``[sides3d]``);
62. the main paths through them, 256³ fp32 from ``uniform(-0.1, 0.1)``, dt =
   0.05, through ``solve(backend="cuda")``: (a) ``DiffusionPDE(1.0)`` (x- a
   per-point array, y- ``sin(3*t)``, y+ 0, z- ``cos(x + t)``, the rest
   no-flux; the reroute to the expression window) for 2048 Euler steps, (b)
   Allen-Cahn (x- Robin with a per-point gamma, y- ``sin(3*t)``) for 2048
   Euler and 512 RK4 steps, each serially through kernel A and on [2, 2, 2]
   through kernel B, bit-equal to serial, the side-input launches counted
   from 0, beside the scalar-side run on the same faces; one top-k pass of
   each kernel beside its scalar-side pass, the plain version and the bound;
   launches per 2048-step window, registers and spills (``[sides3d main]``);
63. the scalar-side #5 and #6 kernels of Allen-Cahn 256³ periodic, their
   registers and SASS, which the side-input modes leave as they were
   (``[sides3d sass]``; ``scripts/torch_sides_3d_phases.py --parent DIR``
   sets another tree's beside them);
64. the side inputs of the radial modes of kernels #1 and #12 (ROADMAP B1(c)
   on cylinders; the kernels ``affine_laplace_radial_sides_2d_kernel`` and
   ``affine_laplace_radial_sides_ext_2d_kernel``) against their plain
   versions at every k of their ladder, fp32 and fp64, on config 4's 4096²
   cylinders: (a) z periodic with a hole, ``0.1*sin(3*t)`` on r-, a per-point
   array on r+; (b) z bounded, a per-point array on z-, ``cos(t)`` as z+'s
   derivative; #12 over [2, 2] and [2, 1] blocks (``[radial sides]``);
65. ``DiffusionPDE(0.1)`` on (a) for 2048 steps from t0 = 0.35 through
   ``solve(backend="cuda")``, serially and on [2, 2] and [2, 1], fused,
   bit-equal, the side-input launches counted from 0, and the rates beside
   the scalar-side radial window's (``[radial sides main]``);
66. one top-k pass of each kernel beside the scalar radial pass, the plain
   version and the bound, registers and spills (``[radial sides passes]``);
67. the two kernels' rows of the kernels line. Phases 64-67 live in
   ``scripts/torch_radial_sides_phases.py``, which also runs them alone;
68. fixed-dt RK4 of a two-deep rhs on 3D grids (ROADMAP §B.1 item 6), the
   step cut at its RK stages into four passes (``cut_step`` of
   ``ops/cuda_stencil_3d.py``: one-step marches of two planes of halo, two
   blocks an SM): every pass of each of the four kernels that run them
   (#5's ``multi_stencil_3d_kernel`` and kernel A, #6's
   ``multi_stencil_ext_3d_kernel``, whose two passes take two stages each
   and compute 4 and 0 cells past their blocks, and kernel B, whose four
   compute 6, 4, 2 and 0) against its plain version on the inputs
   the plain passes before it give, and the whole step, Cahn-Hilliard,
   Swift-Hohenberg and Kuramoto-Sivashinsky on a periodic 256³ grid (the ext
   kernels over [2, 2, 2]) and ``laplace(c**3 - c - laplace(c))`` with a
   face in time on a bounded one (A and B), fp32 and fp64 (``[rk4 3d
   kernels]``);
69. the slice's main path, ``CahnHilliardPDE()`` on a periodic 256³ fp32
   grid for 2048 steps at dt = 1e-3 through ``solve(backend="cuda",
   solver="runge-kutta", adaptive=False, tracker=None)``: fused, 8192
   launches serially (each pass 2048) and 4096 on [2, 2, 2], against the
   plain loop on the card, [2, 2, 2] bit-equal to serial, cell-updates/s
   beside the plain loop's, the idle share of a traced window of each and
   the host's microseconds a launch; the face-in-time program for 256
   steps through A and B, bit-equal (``[rk4 3d main]``);
70. each pass kernel beside its plain version and its bound, the step
   beside the step's, registers and spills (``[rk4 3d passes]``), and the
   four kernels' rows of the kernels line (each its step against the step's
   bound, its pass kernels listed under ``passes``). Phases 68-70 live in
   ``scripts/torch_rk4_3d_phases.py``,
   which also runs them alone;
71. bf16 storage (ROADMAP B1(f)) in kernels #1, #12 and #8: every bf16
   entry point against its plain version at every k, within one bf16 ulp of
   max|f|, with the share of cells that differ, ms a pass, registers and
   spills; 4096² periodic, bounded rows (scalar sides and side inputs), config
   4's cylinder with z periodic (with and without side inputs), #12 over the
   four 2048² blocks of [2, 2] of each, #8 on Cahn-Hilliard's Euler and RK4
   programs over [2, 2], periodic and with side inputs (``[bf16 kernels]``;
   #8's bf16 kernel, ``csrc/march_bf16_ext_2d.cuh``, also at a second chunk
   of rows, which moves blocks between its interior and edge marches,
   bit-identical); the float32 kernels of #8 and #7 on those programs, their
   source digests and SASS (``[bf16 fp kernels]``);
72. the main path on a bf16 state, ``DiffusionPDE(0.1)`` 4096² periodic for
   2048 steps through ``solve(backend="cuda")``: fused, its launches counted
   from 0, [2, 2] bit-equal to serial, the difference from the float32 run,
   cell-updates/s beside float32's in turns; the other cases likewise;
   Cahn-Hilliard 1024² on [2, 2], Euler and RK4, periodic and with side
   inputs, fused, against #8's plain version (``[bf16 main]``); one top-k
   pass of each kernel beside its plain version, its bound and a bf16
   convolution (``[bf16 passes]``), and the kernels line's rows; the seconds
   of both phases and of their libraries' builds (``[bf16 time]``). Phases
   71-72 live in ``scripts/torch_bf16_phases.py``, which also runs them
   alone;
73. every depth that kernels #1 and #12 take in ``pde_tpu`` (ROADMAP §B.1
   item 4, B1(g)): each entry point of the deep march
   (``csrc/affine_deep_2d.cuh``, k at run time, the levels' rows in shared
   memory) against its plain version at k = top + 1, 12, 16 and 32 past
   each mode's register top (#12 up to 16), fp32, fp64 and bf16 where
   ``pde_tpu`` takes it, on 4096² periodic, bounded and side-input grids and
   config 4's cylinders (z periodic and bounded, scalar sides and side
   inputs), #12 over the four 2048² blocks of [2, 2]; ms a pass, its bound,
   registers and spills (``[deep kernels]``); a deep pass against register
   passes of the same depth (``[deep ladder]``);
74. the windows at ``pde_tpu``'s depth: ``make_fused_euler_window_cyl``
   (k = 16) on the cylinder for 2048 steps, its deep launches counted from
   0, against the k = 8 ladder, serially and on [2, 2] (bit-equal), the
   side-input grid and the cylinder with side inputs at k = 16 and the
   periodic grid at k = 32 likewise, cell-updates/s beside the default
   ladders' in turns (``[deep windows]``); the sweep of k = 8..16 a step,
   radial and radial side inputs, fp32 and fp64 (``[deep sweep]``); the
   kernels line's rows, and the seconds of both phases and of their
   libraries' builds (``[deep time]``). Phases 73-74 live in
   ``scripts/torch_deep_phases.py``, which also runs them alone. The line
   before the kernels line gives the seconds of the whole run (``[time]``).

The device phase also checks that a field made without ``device=`` lands on
the card. The last lines are a JSON object describing the kernels (with each
kernel's bound: the larger of the bytes it must move over 3.35 TB/s and its
floating-point operations over 67 TFLOP/s; ``ms`` is the time of one call,
and ``queued_ms``, where measured, that of the kernels with their launches
queued behind a spin of the stream), the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# short runs in fp32: allowed error per step, relative to max|f|
F32_STEP_RTOL = 1e-6
# fp32 over 1000 steps on 256² (the tolerance of pde_tpu's hardware lane)
F32_LONG_TOL = 2e-5
F64_TOL = 1e-12
# Box-Muller increments drawn in the kernel: CUDA's log, cos and sqrt may
# differ from torch's by an ulp or two, so per step relative to max|f|
F32_BOX_MULLER_STEP_RTOL = 2e-6
F64_BOX_MULLER_TOL = 1e-11
# moment checks: allowed distance in standard errors
MOMENT_SIGMAS = 6.0
# one library convolution with the composed stencil against the kernel, relative
# to max|f|: it sums (2k+1)^rank products in another order (and cuDNN may take
# an FFT), so it is held only to showing that it computes the same function
LIBRARY_RTOL = 1e-4
# the card's data-sheet rates (H100 SXM at 700 W): HBM bytes/s, fp32 flop/s
# outside the tensor cores; a bound is the larger of bytes and operations over them
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# integer operations per Philox4x32-10 call (10 rounds of two 32-bit
# multiply-high/low pairs and four xors, nine key bumps of two adds), and of
# the irwin4 law's conversion; the data sheet gives no integer rate, so they
# are counted at the fp32 rate
PHILOX_OPS = 98
IRWIN4_OPS = 17
# periodicities (rows, columns) of the 2D affine kernel checks (phases 3-5, 15; the
# ext kernel's of phases 18-20 are periodic, bounded and (True, False))
AFFINE_2D_PERIODIC = ((True, True), (False, False), (False, True), (True, False))
# increment routes of the SDE window: label, config, kernel
SDE_ROUTES = (
    ("normal", {}, "sde_stencil_2d"),
    ("irwin4", {"sde.increment_dist": "irwin4"}, "sde_kernel_noise_2d"),
    ("rademacher", {"sde.increment_dist": "rademacher"}, "sde_kernel_noise_2d"),
    ("normal (Box-Muller in the kernel)", {"sde.kernel_noise": "on"}, "sde_kernel_noise_2d"),
)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def _cuda_ms(torch, fn, repeats: int) -> float:
    """Mean milliseconds of `fn()` on the card, timed with CUDA events."""
    fn()  # warm up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _queued_ms(torch, fn, repeats: int):
    """Mean milliseconds of `fn()` on the card with its launches queued back to
    back: the stream first spins for about 50 ms while the host enqueues the
    calls, so a wrapper's host work per call (as long as a kernel for the
    3D ext wrapper's eight blocks) does not show; None if the host took
    longer than the spin."""
    fn()  # warm up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # GPU clock cycles
    start.record()
    enqueue = time.perf_counter()
    for _ in range(repeats):
        fn()
    enqueue = time.perf_counter() - enqueue
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats if enqueue < 0.025 else None


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(bound in ms, what sets it): the larger of the bytes over the HBM rate
    and the operations over the fp32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _composed_stencil(torch, a: float, b: float, scales, k: int):
    """The (2k+1)^rank weights of k steps of ``f <- a*f + b*lap(f)`` on a
    periodic grid: the k-step pass is linear and shift-invariant, so it is one
    circular correlation with these weights (fp64; symmetric, so also a
    convolution)."""
    rank = len(scales)
    w = torch.zeros((2 * k + 1,) * rank, dtype=torch.float64)
    w[(k,) * rank] = 1.0
    for _ in range(k):  # the support grows by one per step and never wraps
        w = a * w + sum(b * s * (w.roll(1, ax) + w.roll(-1, ax) - 2.0 * w)
                        for ax, s in enumerate(scales))
    return w


def _library_conv(torch, data, weight, repeats: int):
    """(ms, output) of one circular-padded ``nn.Conv2d``/``nn.Conv3d`` call
    with `weight` on `data`, in the data's precision (TF32 off). Timed for the
    kernels line only; the port never calls it."""
    radius = weight.shape[0] // 2
    conv_cls = torch.nn.Conv2d if weight.dim() == 2 else torch.nn.Conv3d
    conv = conv_cls(1, 1, weight.shape[0], padding=radius, padding_mode="circular",
                    bias=False).to(device=data.device, dtype=data.dtype)
    x = data[None, None]
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            conv.weight.copy_(weight[None, None])
            out = conv(x)[0, 0]
            ms = _cuda_ms(torch, lambda: conv(x), repeats)
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    return ms, out


def _program_flops(program) -> int:
    """Floating-point operations per cell and step of a traced step's graph
    (the ghost substitutions at faces and the domain masks not counted)."""
    geo = program.geometry
    rank = geo.rank
    total = 0
    for node in program.nodes:
        if node.op in ("const", "field"):
            continue
        if node.op == "lap" and geo.radial is not None:
            total += 10  # the radial Laplacian (its row's factor comes from a table)
        elif node.op == "lap":
            total += 2 * rank + 2 if len(set(geo.scales)) == 1 else 5 * rank - 1
        elif node.op == "radial":
            continue  # a row's 1/r, read from a table
        elif node.op == "gsq":
            total += 4 * rank - 1
        elif node.op in ("drow", "dcol", "ddep"):
            total += 2
        else:
            total += 1
    return total


def _affine_flops(scales) -> int:
    """Operations an update of ``a*f + b*lap(f)`` (5- or 7-point) needs, in
    the form ``(a - 2b*sum(s))*f + sum(b*s_i * (f[i-] + f[i+]))``: with equal
    scales the 2*rank neighbours' sum, its product, the centre's product and
    the last sum (2*rank + 2); else a sum and a product per axis, rank - 1
    sums of those, the centre's product and sum (3*rank + 1)."""
    rank = len(scales)
    return 2 * rank + 2 if len(set(scales)) == 1 else 3 * rank + 1


def _ladder_passes(ladder, steps: int) -> int:
    """Kernel passes of a ladder window over `steps` steps."""
    passes = 0
    for k in ladder:
        chunks, steps = divmod(steps, k)
        passes += chunks
    return passes


def _ptxas(log: str) -> str:
    """ptxas' registers and spills, one entry per compiled kernel."""
    lines = log.splitlines()
    entries = []
    for i, line in enumerate(lines):
        if "ptxas info    : Used" in line:
            spill = lines[i - 1].strip() if i and "spill" in lines[i - 1] else ""
            entries.append(line.split("ptxas info    : ", 1)[1] + (f" ({spill})" if spill else ""))
    return " | ".join(entries)


def _ptxas_of(log: str, *needles: str) -> list[str]:
    """ptxas' registers and spills of each kernel whose mangled name holds every
    needle (a template's instantiations: ``"EfLi8ELi64E"`` is float, K = 8, TILE = 64)."""
    lines = log.splitlines()
    name, entries = "", []
    for i, line in enumerate(lines):
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
        elif "ptxas info    : Used" in line and all(n in name for n in needles):
            spill = lines[i - 1].strip() if i and "spill" in lines[i - 1] else ""
            entries.append(line.split("ptxas info    : ", 1)[1] + (f" ({spill})" if spill else ""))
    return entries


def _multi_field_cases(pde, torch, device) -> list[dict]:
    """The rhs set of the multi-field kernel checks: a window per case, on
    seeded inputs on the card."""
    import numpy as np

    gen = np.random.default_rng(10)
    f32, f64 = torch.float32, torch.float64
    ch = pde.PDE({"c": "laplace(c**3 - c - laplace(c))"})
    ch_noflux = pde.CahnHilliardPDE(bc_c={"derivative": 0}, bc_mu={"derivative": 0})
    brusselator = pde.PDE({"u": "laplace(u) + 1 - 4 * u + u**2 * v",
                           "v": "0.1 * laplace(v) + 3 * u - u**2 * v"})
    mixed = {"x-": {"value": 1}, "x+": {"derivative": 0},
             "y-": {"derivative": 0.2}, "y+": {"type": "mixed", "value": 1.0, "const": 0.3}}
    specs = [
        ("cahn-hilliard 1024^2 periodic", ch, pde.UnitGrid([1024, 1024], periodic=True),
         1, f32, 1e-3, (-0.1, 0.1)),
        ("cahn-hilliard no-flux anisotropic 1000x1530", ch_noflux,
         pde.CartesianGrid([(0, 500), (0, 1530)], [1000, 1530]), 1, f32, 1e-4, (-0.1, 0.1)),
        ("cahn-hilliard no-flux anisotropic 1000x1530", ch_noflux,
         pde.CartesianGrid([(0, 500), (0, 1530)], [1000, 1530]), 1, f64, 1e-4, (-0.1, 0.1)),
        ("brusselator no-flux 512^2", brusselator, pde.UnitGrid([512, 512]), 2, f32, 1e-3,
         (0.5, 1.5)),
        ("divergence(gradient(c)) no-flux 256^2",
         pde.PDE({"c": "0.001 * divergence(gradient(c))"}, bc={"derivative": 0.1}),
         pde.UnitGrid([256, 256]), 1, f32, 1e-2, (0.0, 1.0)),
        ("dot(gradient(u), gradient(v)) 256^2",
         pde.PDE({"u": "0.1 * laplace(u) + 0.05 * dot(gradient(u), gradient(v))",
                  "v": "0.1 * laplace(v)"}),
         pde.UnitGrid([256, 256], periodic=True), 2, f32, 1e-2, (0.0, 1.0)),
        ("mixed per-side BCs 256^2", pde.PDE({"c": "0.001 * laplace(c) - 0.1 * c"}, bc=mixed),
         pde.CartesianGrid([(0, 1), (0, 1)], [256, 256]), 1, f32, 1e-3, (0.0, 1.0)),
        ("cahn-hilliard 16^2 periodic (halo wraps)", ch, pde.UnitGrid([16, 16], periodic=True),
         1, f32, 1e-3, (-0.1, 0.1)),
        ("cahn-hilliard 16^2 periodic (halo wraps)", ch, pde.UnitGrid([16, 16], periodic=True),
         1, f64, 1e-3, (-0.1, 0.1)),
    ]
    cases = []
    for label, eq, grid, n_fields, dtype, dt, (lo, hi) in specs:
        datas = [torch.as_tensor(gen.uniform(lo, hi, grid.shape), dtype=dtype, device=device)
                 for _ in range(n_fields)]
        fields = [pde.ScalarField(grid, d) for d in datas]
        state = fields[0] if n_fields == 1 else pde.FieldCollection(fields)
        window = eq.make_fused_euler_window(state, dt)
        cases.append({"label": label, "window": window, "datas": datas, "dtype": dtype})
    return cases


def _sde_cases(pde, torch, device) -> list[dict]:
    """The Euler-Maruyama kernel checks: a window per (rhs, grid, dtype,
    route), on seeded inputs on the card."""
    import numpy as np

    gen = np.random.default_rng(11)
    f32, f64 = torch.float32, torch.float64
    periodic_4k = pde.UnitGrid([4096, 4096], periodic=True)
    periodic_16 = pde.UnitGrid([16, 16], periodic=True)
    ragged = pde.CartesianGrid([(0, 500), (0, 1530)], [1000, 1530])
    specs = [
        ("kpz 4096^2 periodic", "kpz", periodic_4k, f32),
        ("kpz no-flux anisotropic 1000x1530", "kpz", ragged, f32),
        ("kpz no-flux anisotropic 1000x1530", "kpz", ragged, f64),
        ("diffusion 1024^2 periodic", "diffusion", pde.UnitGrid([1024, 1024], periodic=True), f32),
        ("kpz 16^2 periodic (halo wraps the seam)", "kpz", periodic_16, f32),
        ("kpz 16^2 periodic (halo wraps the seam)", "kpz", periodic_16, f64),
    ]
    cases = []
    for label, rhs, grid, dtype in specs:
        data = torch.as_tensor(gen.uniform(-0.5, 0.5, grid.shape), dtype=dtype, device=device)
        state = pde.ScalarField(grid, data)
        for route, cfg, kernel in SDE_ROUTES:
            with pde.config(cfg):
                if rhs == "kpz":
                    eq = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1)
                else:
                    eq = pde.DiffusionPDE(0.1, noise=1.0)
                window = eq.make_fused_euler_window(state, 1e-3)
            cases.append({"label": label, "route": route, "kernel": kernel, "window": window,
                          "data": data, "dtype": dtype})
    return cases


def _zero_rate_windows(pde, sde, torch, grid, dt: float) -> tuple[dict, float]:
    """One window per route for ``DiffusionPDE(0.0, noise=1.0)``: its
    deterministic step is the identity (the expression compiler folds
    ``0.0 * laplace(c)`` away, so the step is built here with the Laplacian
    kept, times zero), its increments those of the model."""
    import math

    def make_step(ops):
        def step(works):
            (work,) = works
            return [ops.trim(work, 1) + 0.0 * ops.lap(work)]

        return step

    noise_fn = pde.PDE({"c": "laplace(c)"}, noise=1.0)._make_staged_noise(
        pde.ScalarField(grid, 0.0), dt)
    scale = math.sqrt(dt * 1.0 / float(grid.cell_volumes[0, 0]))
    windows = {}
    for route, cfg, _ in SDE_ROUTES:
        law = cfg.get("sde.increment_dist", "normal")
        kernel_noise = None if route == "normal" else {"dist": law, "scale": scale}
        windows[route] = sde.make_chunked_sde_window_2d(
            grid, make_step, 1, noise_fn, dtype=torch.float32, kernel_noise=kernel_noise)
    return windows, scale


ALLEN_CAHN_3D = {"u": "laplace(u) + u - u**3"}
# vector Ginzburg-Landau (pde_tpu's on-silicon vector case, tests/tpu/test_on_device.py)
GINZBURG_LANDAU = {"u": "0.2 * vector_laplace(u) + u - dot(u, u) * u"}
# a collection mixing ranks (pde_tpu's tests/ops/test_pallas_vector.py)
COUPLED_RANKS = {"u": "0.1 * laplace(u) - divergence(v)",
                 "v": "0.05 * vector_laplace(v) + gradient(u) - dot(v, v) * v"}
VECTOR_3D = {"u": "0.05 * vector_laplace(u) - dot(u, u) * u"}
# the registry's operators: the input field's rank, the field method computing the
# same operator through the plain path, and flops per cell of the kernel
REGISTRY_OPS = {
    "laplace": (0, "laplace", 6),
    "gradient_squared": (0, "gradient_squared", 7),
    "gradient": (0, "gradient", 4),
    "divergence": (1, "divergence", 5),
    "vector_laplace": (1, "laplace", 12),
    "vector_gradient": (1, "gradient", 8),
    "tensor_divergence": (2, "divergence", 10),
}
RAGGED_3D = ([(0, 1), (0, 2), (0, 3)], [30, 34, 38])


def _affine_3d_cases(pde) -> list[tuple]:
    """(label, grid, bc) of the 3D affine kernel checks."""
    mixed = {"x": {"value": 1}, "y": {"derivative": 0.5}, "z": "periodic"}
    ragged_mixed = {"x-": {"value": 1}, "x+": {"curvature": 0.5}, "y": "periodic",
                    "z": {"type": "mixed", "value": 2.0, "const": 0.5}}
    return [
        ("periodic 256^3", pde.UnitGrid([256] * 3, periodic=True), None),
        ("no-flux 256^3", pde.UnitGrid([256] * 3), {"derivative": 0}),
        ("mixed faces 256^3", pde.UnitGrid([256] * 3, periodic=[False, False, True]), mixed),
        ("no-flux ragged anisotropic 30x34x38", pde.CartesianGrid(*RAGGED_3D), {"derivative": 0}),
        ("mixed ragged anisotropic 30x34x38",
         pde.CartesianGrid(*RAGGED_3D, periodic=[False, True, False]), ragged_mixed),
        ("periodic 8^3 (halos wrap every seam)", pde.UnitGrid([8] * 3, periodic=True), None),
        ("no-flux 8^3", pde.UnitGrid([8] * 3), {"derivative": 0}),
    ]


def _operator_grids(pde) -> list[tuple]:
    """(label, grid, bc) of the stencil-operator kernel checks."""
    aniso = [(0, 500), (0, 1530)]
    mixed = {"x-": {"value": 1.5}, "x+": {"derivative": 0.3},
             "y-": {"type": "mixed", "value": 2.0, "const": 0.5}, "y+": {"value": -0.5}}
    return [
        ("periodic 4096^2", pde.UnitGrid([4096, 4096], periodic=True), "periodic"),
        ("no-flux anisotropic 1000x1530", pde.CartesianGrid(aniso, [1000, 1530]),
         {"derivative": 0}),
        ("dirichlet/neumann/robin anisotropic 1000x1530", pde.CartesianGrid(aniso, [1000, 1530]),
         mixed),
        ("dirichlet x, periodic y 1000x1530",
         pde.CartesianGrid([(0, 1000), (0, 1530)], [1000, 1530], periodic=[False, True]),
         {"x-": {"value": 1.5}, "x+": {"curvature": 0.3}, "y": "periodic"}),
        ("periodic 16^2 (tiles touch the seam)", pde.UnitGrid([16, 16], periodic=True),
         "periodic"),
    ]


def _operator_conv(torch, op: str, spec, data):
    """(module, input) of one circular-padded ``nn.Conv2d`` computing the
    periodic operator `op` on the stacked planes `data` with 3x3 central-
    difference or 5-point weights in the operator's channel and group layout
    (``torch.nn.Conv2d`` correlates: weight[a, b] multiplies x[i + a - 1,
    j + b - 1]); None for ``gradient_squared``, which is no convolution."""
    gx, gy = spec.halves
    sx, sy = spec.scales
    d_row = torch.zeros(3, 3, dtype=torch.float64)
    d_row[2, 1], d_row[0, 1] = gx, -gx
    d_col = torch.zeros(3, 3, dtype=torch.float64)
    d_col[1, 2], d_col[1, 0] = gy, -gy
    lap = torch.zeros(3, 3, dtype=torch.float64)
    lap[0, 1] = lap[2, 1] = sx
    lap[1, 0] = lap[1, 2] = sy
    lap[1, 1] = -2 * (sx + sy)
    layouts = {  # weight (out channels, in channels per group, 3, 3), groups
        "laplace": ([[lap]], 1),
        "gradient": ([[d_row], [d_col]], 1),
        "divergence": ([[d_row, d_col]], 1),
        "vector_laplace": ([[lap], [lap]], 2),
        "vector_gradient": ([[d_row], [d_col], [d_row], [d_col]], 2),
        "tensor_divergence": ([[d_row, d_col], [d_row, d_col]], 2),
    }
    if op not in layouts:
        return None
    rows, groups = layouts[op]
    weight = torch.stack([torch.stack(row) for row in rows])
    conv = torch.nn.Conv2d(weight.shape[1] * groups, weight.shape[0], 3, padding=1,
                           padding_mode="circular", groups=groups, bias=False)
    conv = conv.to(device=data.device, dtype=data.dtype)
    with torch.no_grad():
        conv.weight.copy_(weight)
    return conv, data.reshape((1, -1) + tuple(data.shape[-2:]))


def _multi_field_cases_3d(pde, torch, device) -> list[dict]:
    """The 3D multi-field kernel checks: a window per case, on seeded inputs on
    the card."""
    import numpy as np

    gen = np.random.default_rng(13)
    f32, f64 = torch.float32, torch.float64
    periodic = pde.UnitGrid([256] * 3, periodic=True)
    allen_cahn = pde.PDE(ALLEN_CAHN_3D)
    ch_noflux = pde.CahnHilliardPDE(bc_c={"derivative": 0}, bc_mu={"derivative": 0})
    brusselator = pde.PDE({"u": "0.1 * laplace(u) + 1 - 2 * u + u**2 * v",
                           "v": "0.05 * laplace(v) + u - u**2 * v"})
    dot_grad = pde.PDE({"c": "0.1 * laplace(c) + 0.05 * dot(gradient(c), gradient(c))"},
                       bc={"derivative": 0})
    specs = [
        ("allen-cahn 256^3 periodic", allen_cahn, periodic, 1, (f32, f64), 0.05),
        ("allen-cahn 8^3 periodic (halos wrap every seam)", allen_cahn,
         pde.UnitGrid([8] * 3, periodic=True), 1, (f32, f64), 0.05),
        ("cahn-hilliard 256^3 periodic", pde.CahnHilliardPDE(), periodic, 1, (f32, f64), 1e-3),
        ("cahn-hilliard no-flux ragged anisotropic 30x34x38", ch_noflux,
         pde.CartesianGrid(*RAGGED_3D), 1, (f32, f64), 1e-7),
        ("brusselator 256^3 periodic", brusselator, periodic, 2, (f32, f64), 1e-2),
        ("dot-grad no-flux 256^3", dot_grad, pde.UnitGrid([256] * 3), 1, (f32, f64), 1e-2),
        ("dot-grad no-flux ragged anisotropic 30x34x38", dot_grad,
         pde.CartesianGrid(*RAGGED_3D), 1, (f32,), 1e-3),
        ("diffusion 256^3 periodic through multi_stencil_3d", pde.PDE({"c": "laplace(c)"}),
         periodic, 1, (f32,), 0.05),
    ]
    cases = []
    for label, eq, grid, n_fields, dtypes, dt in specs:
        for dtype in dtypes:
            datas = [torch.as_tensor(gen.uniform(-0.1, 0.1, grid.shape) + (1.0 if i else 0.0),
                                     dtype=dtype, device=device) for i in range(n_fields)]
            fields = [pde.ScalarField(grid, d) for d in datas]
            state = fields[0] if n_fields == 1 else pde.FieldCollection(fields)
            cases.append({"label": label, "window": eq.make_fused_euler_window(state, dt),
                          "datas": datas, "dtype": dtype})
    return cases


# the expression Cahn-Hilliard of phase 7, on decomposed grids (phases 18-21)
CAHN_HILLIARD = {"c": "laplace(c**3 - c - laplace(c))"}
# Dirichlet, Neumann and Robin sides: the BC set of pde_tpu's
# tests/parallel/test_sharded.py:307 ("mixed")
SHARDED_BCS = {"x-": {"value": 1}, "x+": {"derivative": 0},
               "y": {"type": "mixed", "value": 1.0, "const": 0.5}}
# edge flags of the four blocks of an ext-kernel check: every side flagged somewhere
EXT_FLAGS = [[1, 0, 1, 0], [0, 1, 0, 1], [1, 1, 1, 1], [0, 0, 0, 0]]


def _ext_windows(pde, torch, device) -> dict:
    """Decomposed Cahn-Hilliard windows on a 2x2 mesh of one card, periodic
    and no-flux (whose ghosts the ext kernel gates by the edge flags), at
    4096²; their generated programs go to the build."""
    from pde_tpu_torch.parallel import GridMesh

    windows = {}
    for label, periodic, bc in (("cahn-hilliard periodic", True, "periodic"),
                                ("cahn-hilliard no-flux", False, {"derivative": 0})):
        grid = pde.UnitGrid([4096, 4096], periodic=periodic)
        state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=device)
        mesh = GridMesh(grid, [2, 2], devices=[device] * 4)
        windows[label] = pde.PDE(CAHN_HILLIARD, bc=bc).make_fused_euler_window(
            state, 1e-3, mesh=mesh)
    return windows


def _device_times(prof) -> dict:
    """Device microseconds by event name of a ``torch.profiler`` trace."""
    times = {}
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", None)
        if device_us is None:
            device_us = event.self_cuda_time_total
        if device_us > 0:
            times[event.key] = times.get(event.key, 0.0) + device_us
    return times


def _trace_window(torch, smi, label, stepper, state, t_end, kernel) -> dict:
    """One profiled window of a decomposed stepper: the ext kernel's device
    time, every other device time (exchange, split and combine copies), the
    idle share. Prints one line and returns the numbers."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        stepper(state, 0.0, t_end)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    times = _device_times(prof)
    kernel_us = sum(us for name, us in times.items() if kernel in name)
    other_us = sum(times.values()) - kernel_us
    busy_us = kernel_us + other_us
    idle = "not measured (the trace holds no device time)" if busy_us == 0 else (
        f"{1.0 - busy_us / wall_us:.4%}")
    share = "not measured" if busy_us == 0 else f"{other_us / busy_us:.4%}"
    top = sorted(times.items(), key=lambda kv: -kv[1])[:4]
    print(f"[sharded trace] {label}, one 2048-step window (torch.profiler) on {smi}: wall "
          f"{wall_us:.1f} us, {kernel} {kernel_us:.1f} us, copies (exchange, split, "
          f"combine) {other_us:.1f} us = {share} of device time, idle share {idle}; top: "
          + "; ".join(f"{name[:60]} {us:.1f} us" for name, us in top), flush=True)
    return {"wall_us": wall_us, "kernel_us": kernel_us, "other_us": other_us}


def _decomposed(pde, torch, np, device, smi, ext_windows, serial_best) -> dict:
    """Phases 18-21: the ext kernels against their plain versions, the
    decomposed main paths against the serial ones, their rates and one traced
    window. Returns the two ext kernels' entries of the kernels line."""
    import torch.nn.functional as F

    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import HaloExchange

    f32, f64 = torch.float32, torch.float64
    gen = np.random.default_rng(6)

    def buffers(spec, n_planes, low=-0.5, padded=False):
        """Random extended buffers of four blocks, contiguous as the exchange
        allocates them; `padded`: rows padded to a multiple of 128 bytes."""
        n, m = spec.shape
        h = spec.halo
        per_line = 128 // torch.empty((), dtype=spec.dtype).element_size()
        ld = -(-(m + 2 * h) // per_line) * per_line if padded else m + 2 * h
        return [[torch.empty((n + 2 * h, ld), dtype=spec.dtype, device=device)[:, : m + 2 * h]
                 .copy_(torch.as_tensor(gen.uniform(low, 0.5, (n + 2 * h, m + 2 * h))))
                 for _ in range(n_planes)] for _ in EXT_FLAGS]

    def run_affine(ins, outs, flags, spec):
        ce.affine_laplace_ext_2d([p[0] for p in ins], [p[0] for p in outs], flags, spec)

    def plain_affine(planes, spec, flags):
        return [ce.affine_laplace_ext_2d_plain(planes[0], spec, flags)]

    def check(label, run, plain, spec, n_planes, periodic):
        """One launch over four blocks (flags EXT_FLAGS on the non-periodic
        axes) against the plain version of each block, on the same buffers."""
        flag_sets = [[int(f and not periodic[i // 2]) for i, f in enumerate(flags)]
                     for flags in EXT_FLAGS]
        ins = buffers(spec, n_planes)
        outs = buffers(spec, n_planes)
        run(ins, outs, flag_sets, spec)
        torch.cuda.synchronize()
        h, (n, m) = spec.halo, spec.shape
        err = scale = 0.0
        finite = True
        for planes, out, flags in zip(ins, outs, flag_sets):
            for o, r in zip(out, plain(planes, spec, flags)):
                err = max(err, float((o[h:h + n, h:h + m] - r).abs().max()))
                scale = max(scale, float(r.abs().max()))
                finite = finite and bool(torch.isfinite(o).all())
        tol = (F64_TOL if spec.dtype == f64 else F32_STEP_RTOL * spec.k) * scale
        ok = finite and err <= tol
        print(f"[ext kernels] {label} {str(spec.dtype)[6:]} blocks {n}x{m} halo {h} k={spec.k} "
              f"flags {flag_sets}: max_abs={err:.3e} max_rel={err / scale:.3e} tol={tol:.1e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"ext kernel disagrees with its plain version: {label}")
        return err

    # -- 18. kernel vs plain (decomposed) ------------------------------------------------------
    top = cc.TOP_STEPS
    ladder = [top >> i for i in range(top.bit_length())]
    ragged = pde.CartesianGrid([(0, 140), (0, 200)], [140, 100])
    affine_grids = {  # (grid, blocks, BCs): every BC form, both periodicities and one mixed
        "affine mixed bcs": (pde.CartesianGrid([(0, 4096), (0, 8192)], [4096, 4096]), (2048, 2048),
                             SHARDED_BCS),
        "affine mixed bcs ragged": (ragged, (70, 50), SHARDED_BCS),
        "affine curvature/dirichlet ragged": (ragged, (70, 50),
                                              {"x": {"curvature": 1.0}, "y": {"value": -0.5}}),
        "affine periodic rows ragged": (
            pde.CartesianGrid([(0, 140), (0, 200)], [140, 100], periodic=[True, False]), (70, 50),
            {"x": "periodic", "y": {"derivative": 0.3}}),
        "affine periodic": (pde.UnitGrid([4096, 4096], periodic=True), (2048, 2048), "periodic"),
    }
    ext_errs = {}
    for label, (grid, local, bc) in affine_grids.items():
        bcs = None if all(grid.periodic) else grid.get_boundary_conditions(bc)
        for dtype in (f32, f64):
            for k in ladder:
                spec = ce.affine_laplace_ext_spec(grid, local, a=1.0, b=0.1, k=k, halo=top,
                                                  dtype=dtype, bcs=bcs)
                ext_errs[(label, str(dtype), k)] = check(
                    label, run_affine, plain_affine, spec, 1, spec.periodic)
    for label, window in ext_windows.items():
        program = window.program
        halo = window.specs[0].halo
        for local in ((2048, 2048), (70, 50)):
            for dtype in (f32, f64):
                for k in [spec.k for spec in window.specs]:
                    spec = ce.multi_stencil_ext_spec(program, k, dtype, local, halo)
                    ext_errs[(label, local, str(dtype), k)] = check(
                        label, ce.multi_stencil_ext_2d, ce.multi_stencil_ext_2d_plain, spec, 1,
                        program.geometry.periodic)

    # one top-k pass over four 2048² blocks of a periodic grid (flags 0), timed
    cells = 4096 * 4096
    periodic = pde.UnitGrid([4096, 4096], periodic=True)
    spec_top = ce.affine_laplace_ext_spec(periodic, (2048, 2048), a=1.0, b=0.01, k=top,
                                          halo=top, dtype=f32)
    flags0 = [[0, 0, 0, 0]] * 4
    ins = [p[0] for p in buffers(spec_top, 1, low=0.0)]
    outs = [p[0] for p in buffers(spec_top, 1)]
    affine_ms = _cuda_ms(torch, lambda: ce.affine_laplace_ext_2d(ins, outs, flags0, spec_top), 20)
    affine_plain_ms = _cuda_ms(
        torch,
        lambda: [ce.affine_laplace_ext_2d_plain(x, spec_top, f) for x, f in zip(ins, flags0)], 3)
    side = 2048 + 2 * top
    ext_cells = 4 * side * side
    affine_bound = _bound((ext_cells + cells) * 4, _affine_flops((1.0, 1.0)) * top * cells)
    weight = _composed_stencil(torch, 1.0, 0.01, (1.0, 1.0), top).to(device=device, dtype=f32)
    stacked = torch.stack(ins)[:, None]
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        library_ms = _cuda_ms(torch, lambda: F.conv2d(stacked, weight[None, None]), 5)
        library_out = F.conv2d(stacked, weight[None, None])[:, 0]
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    ce.affine_laplace_ext_2d(ins, outs, flags0, spec_top)
    interiors = torch.stack([o[top:top + 2048, top:top + 2048] for o in outs])
    library_err = float((library_out - interiors).abs().max())
    library_ok = library_err <= LIBRARY_RTOL * float(interiors.abs().max())
    ch_window = ext_windows["cahn-hilliard periodic"]
    ch_top = ch_window.specs[0]
    ch_ins = buffers(ch_top, 1)
    ch_outs = buffers(ch_top, 1)
    multi_ms = _cuda_ms(
        torch, lambda: ce.multi_stencil_ext_2d(ch_ins, ch_outs, flags0, ch_top), 20)
    multi_plain_ms = _cuda_ms(
        torch, lambda: [ce.multi_stencil_ext_2d_plain(p, ch_top, f)
                        for p, f in zip(ch_ins, flags0)], 3)
    padded_ins = buffers(ch_top, 1, padded=True)
    padded_outs = buffers(ch_top, 1, padded=True)
    padded_ms = _cuda_ms(
        torch, lambda: ce.multi_stencil_ext_2d(padded_ins, padded_outs, flags0, ch_top), 20)
    ch_ext_cells = 4 * (2048 + 2 * ch_top.halo) ** 2
    multi_bound = _bound((ch_ext_cells + cells) * 4,
                         _program_flops(ch_window.program) * ch_top.k * cells)
    print(f"[ext kernels] one top-k pass over four 2048^2 blocks of a periodic fp32 grid on "
          f"{smi}: affine_laplace_ext_2d k={top} {affine_ms:.4f} ms ({affine_ms / top:.5f} a step; "
          f"plain {affine_plain_ms:.4f} ms, bound {affine_bound[0]:.4f} ms ({affine_bound[1]}), "
          f"one F.conv2d with the composed {2 * top + 1}x{2 * top + 1} stencil over the "
          f"extended blocks {library_ms:.4f} ms, max_abs vs kernel "
          f"{library_err:.3e} {'ok' if library_ok else 'FAIL'}); multi_stencil_ext_2d "
          f"Cahn-Hilliard k={ch_top.k} (tile {ch_top.tile}, halo {ch_top.halo}) {multi_ms:.4f} ms "
          f"with contiguous rows of {2048 + 2 * ch_top.halo} as the exchange allocates them, "
          f"{padded_ms:.4f} ms with rows padded to 128 B (plain {multi_plain_ms:.4f} ms, bound "
          f"{multi_bound[0]:.4f} ms ({multi_bound[1]}))",
          flush=True)
    if not library_ok:
        raise AssertionError(f"the composed-stencil conv2d does not compute the ext k={top} pass")

    # -- 19. main path (decomposed) -------------------------------------------------------------
    pde.config["parallel.devices_per_device"] = 4  # a 2x2 mesh of blocks on one card
    state = pde.ScalarField.random_uniform(periodic, dtype=f32, device=device,
                                           rng=np.random.default_rng(1))
    eq = pde.DiffusionPDE(diffusivity=0.1)
    ce.affine_laplace_ext_2d.launches = 0
    ce.multi_stencil_ext_2d.launches = 0
    result = eq.solve(state, t_range=3.7, dt=0.1, tracker=None, backend="cuda",
                      decomposition=[2, 2])
    torch.cuda.synchronize()
    main_launches = ce.affine_laplace_ext_2d.launches
    info = eq.diagnostics["solver"]
    serial_stepper = pde.EulerSolver(eq, backend="cuda").make_stepper(state, dt=0.1)
    serial, _ = serial_stepper(state, 0.0, 3.7)
    torch.cuda.synchronize()
    err_main = float((result.data - serial.data).abs().max())
    checks = [
        info.get("fused_step") is True, info.get("decomposition") == [2, 2],
        main_launches > 0, info["steps"] == 37,
        result.data.shape == (4096, 4096) and bool(torch.isfinite(result.data).all()),
        err_main == 0.0,  # the ext kernel runs the serial kernel's march, the same passes
    ]
    print(f"[sharded main] 4096^2 periodic fp32 DiffusionPDE(0.1), dt=0.1, eq.solve(..., "
          f"backend='cuda', decomposition=[2, 2]) on four blocks of one card, 37 steps: max_abs "
          f"vs the serial kernel window {err_main:.3e} (bit-equal required); "
          f"affine_laplace_ext_2d launches {main_launches} {'ok' if all(checks) else 'FAIL'}",
          flush=True)
    if not all(checks):
        raise AssertionError(f"decomposed main path checks failed: {checks}")

    steppers = {
        "serial": serial_stepper,
        "decomposed": pde.EulerSolver(eq, backend="cuda", decomposition=[2, 2]).make_stepper(
            state, dt=0.1),
    }
    rates = dict.fromkeys(steppers, 0.0)
    for stepper in steppers.values():
        stepper(state, 0.0, 204.8)  # warm-up windows of 2048 steps
    for round_ in range(3):
        order = list(steppers) if round_ % 2 == 0 else list(reversed(steppers))
        for label in order:
            torch.cuda.synchronize()
            start = time.perf_counter()
            out, _ = steppers[label](state, 0.0, 204.8)
            torch.cuda.synchronize()
            rates[label] = max(rates[label], cells * 2048 / (time.perf_counter() - start))
    launches0, copies0 = ce.affine_laplace_ext_2d.launches, HaloExchange.copies
    steppers["decomposed"](state, 0.0, 204.8)
    torch.cuda.synchronize()
    window_launches = ce.affine_laplace_ext_2d.launches - launches0
    window_copies = HaloExchange.copies - copies0
    print(f"[sharded main] 4096^2 periodic fp32 on {smi}: decomposed [2, 2] "
          f"{rates['decomposed']:.4e} cell-updates/s, serial {rates['serial']:.4e} (2048-step "
          f"windows in turns, best of 3; phase 5's serial main path {serial_best:.4e}); per "
          f"window {window_launches} affine_laplace_ext_2d launches and {window_copies} halo "
          f"copies (split and combine once per window)", flush=True)
    _trace_window(torch, smi, "diffusion 4096^2 [2, 2]", steppers["decomposed"], state, 204.8,
                  "affine_laplace_ext_2d_kernel")

    # -- 20. decomposed BCs -----------------------------------------------------------------------
    grid_bc = pde.CartesianGrid([(0, 1024), (0, 2048)], [1024, 1024])
    state_bc = pde.ScalarField.random_uniform(grid_bc, dtype=f32, device=device,
                                              rng=np.random.default_rng(2))
    eq_bc = pde.DiffusionPDE(0.05, bc=SHARDED_BCS)
    serial_bc, _ = pde.EulerSolver(eq_bc, backend="cuda").make_stepper(state_bc, dt=1.0)(
        state_bc, 0.0, 37.0)
    for decomposition in ([2, 2], [1, 4]):
        launches0 = ce.affine_laplace_ext_2d.launches
        got = eq_bc.solve(state_bc, t_range=37.0, dt=1.0, tracker=None, backend="cuda",
                          decomposition=decomposition)
        torch.cuda.synchronize()
        err = float((got.data - serial_bc.data).abs().max())
        launched = ce.affine_laplace_ext_2d.launches - launches0
        ok = (err <= F32_STEP_RTOL * 37 * float(serial_bc.data.abs().max()) and launched > 0
              and eq_bc.diagnostics["solver"].get("decomposition") == decomposition)
        print(f"[sharded bc] 1024^2 fp32 diffusion, Dirichlet/Neumann/Robin sides, "
              f"{decomposition}, 37 steps: max_abs vs serial {err:.3e}, {launched} launches "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"decomposed BC run disagrees with serial: {decomposition}")

    # -- 21. decomposed Cahn-Hilliard ----------------------------------------------------------
    eq_ch = pde.PDE(CAHN_HILLIARD)
    grid_1k = pde.UnitGrid([1024, 1024], periodic=True)
    state_ch = pde.ScalarField.random_uniform(grid_1k, -0.1, 0.1, dtype=f32, device=device,
                                              rng=np.random.default_rng(0))
    serial_ch, _ = pde.EulerSolver(eq_ch, backend="cuda").make_stepper(state_ch, dt=1e-3)(
        state_ch, 0.0, 0.037)
    ce.multi_stencil_ext_2d.launches = 0
    got_ch = eq_ch.solve(state_ch, t_range=0.037, dt=1e-3, tracker=None, backend="cuda",
                         decomposition=[2, 2])
    torch.cuda.synchronize()
    multi_launches = ce.multi_stencil_ext_2d.launches
    err_ch = float((got_ch.data - serial_ch.data).abs().max())
    ok = (err_ch == 0 and multi_launches > 0
          and eq_ch.diagnostics["solver"].get("fused_step") is True)
    print(f"[sharded multi] Cahn-Hilliard 1024^2 periodic fp32 on [2, 2], 37 steps: max_abs vs "
          f"the serial kernel #7 window {err_ch:.3e} (bit-equal required); multi_stencil_ext_2d "
          f"launches {multi_launches} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("decomposed Cahn-Hilliard disagrees with serial")
    state_4k = pde.ScalarField.random_uniform(periodic, -0.1, 0.1, dtype=f32, device=device,
                                              rng=np.random.default_rng(3))
    steppers_ch = {
        "serial": pde.EulerSolver(eq_ch, backend="cuda").make_stepper(state_4k, dt=1e-3),
        "decomposed": pde.EulerSolver(eq_ch, backend="cuda", decomposition=[2, 2]).make_stepper(
            state_4k, dt=1e-3),
    }
    rates_ch = dict.fromkeys(steppers_ch, 0.0)
    for stepper in steppers_ch.values():
        stepper(state_4k, 0.0, 0.1)  # warm-up
    for round_ in range(2):
        order = list(steppers_ch) if round_ % 2 == 0 else list(reversed(steppers_ch))
        for label in order:
            torch.cuda.synchronize()
            start = time.perf_counter()
            steppers_ch[label](state_4k, 0.0, 2.048)
            torch.cuda.synchronize()
            rates_ch[label] = max(rates_ch[label], cells * 2048 / (time.perf_counter() - start))
    launches0, copies0 = ce.multi_stencil_ext_2d.launches, HaloExchange.copies
    steppers_ch["decomposed"](state_4k, 0.0, 2.048)
    torch.cuda.synchronize()
    print(f"[sharded multi] Cahn-Hilliard 4096^2 periodic fp32 on {smi}: decomposed [2, 2] "
          f"{rates_ch['decomposed']:.4e} cell-updates/s, serial {rates_ch['serial']:.4e} "
          f"(2048-step windows in turns, best of 2); per window "
          f"{ce.multi_stencil_ext_2d.launches - launches0} multi_stencil_ext_2d launches and "
          f"{HaloExchange.copies - copies0} halo copies", flush=True)
    _trace_window(torch, smi, "Cahn-Hilliard 4096^2 [2, 2]", steppers_ch["decomposed"], state_4k,
                  2.048, "multi_stencil_ext_2d_kernel")
    _trace_window(torch, smi, "Cahn-Hilliard 4096^2 serial", steppers_ch["serial"], state_4k,
                  2.048, "multi_stencil_2d_kernel")
    pde.config["parallel.devices_per_device"] = 1

    return {
        "affine_laplace_ext_2d": {
            "launches": main_launches,
            "max_abs_err": ext_errs[("affine periodic", str(f32), top)],
            "ms": affine_ms, "plain_ms": affine_plain_ms,
            "bound_ms": affine_bound[0], "bound_by": affine_bound[1],
            "library_ms": library_ms,
        },
        "multi_stencil_ext_2d": {
            "launches": multi_launches,
            "max_abs_err": ext_errs[("cahn-hilliard periodic", (2048, 2048), str(f32), ch_top.k)],
            "ms": multi_ms, "plain_ms": multi_plain_ms,
            "bound_ms": multi_bound[0], "bound_by": multi_bound[1],
            "library_ms": None,
        },
    }


# the decomposed 3D paths (phases 22-24): Allen-Cahn periodic and a no-flux
# expression rhs for the generated ext kernel, on 2x2x2 meshes of one card
NOFLUX_3D = {"c": "0.1 * laplace(c) - 0.05 * gradient_squared(c)"}
# Dirichlet, Neumann, Robin and curvature faces
SHARDED_BCS_3D = {"x-": {"value": 1}, "x+": {"derivative": 0},
                  "y": {"type": "mixed", "value": 1.0, "const": 0.5}, "z": {"curvature": 0.3}}
# edge flags of the eight blocks of an ext-kernel check: every face flagged somewhere,
# blocks with two, three and six flagged faces
EXT_FLAGS_3D = [[1, 0, 1, 0, 1, 0], [0, 1, 0, 1, 0, 1], [1, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0],
                [1, 0, 0, 1, 1, 1], [0, 1, 1, 0, 0, 0], [1, 1, 0, 0, 1, 0], [0, 0, 1, 1, 0, 1]]


def _ext_windows_3d(pde, torch, device) -> dict:
    """Decomposed 3D windows of the generated ext kernel on a 2x2x2 mesh of
    one card, at 256³: Allen-Cahn periodic and a no-flux expression rhs
    (whose ghosts the kernel gates by the face flags); their programs go to
    the build."""
    from pde_tpu_torch.parallel import GridMesh

    windows = {}
    for label, eq, periodic in (
            ("allen-cahn periodic", pde.AllenCahnPDE(), True),
            ("laplace-gsq no-flux", pde.PDE(NOFLUX_3D, bc={"derivative": 0}), False)):
        grid = pde.UnitGrid([256] * 3, periodic=periodic)
        state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=device)
        mesh = GridMesh(grid, [2, 2, 2], devices=[device] * 8)
        windows[label] = eq.make_fused_euler_window(state, 0.05, mesh=mesh)
    return windows


def _decomposed_3d(pde, torch, np, device, smi, ext_windows, ext_logs) -> dict:
    """Phases 22-24: the 3D ext kernels against their plain versions, the
    decomposed 3D main path against the serial window, its rate and one traced
    window, the BC, Allen-Cahn and x-cut runs; `ext_logs` holds ptxas' report
    of each ext window's build. Returns the two 3D ext kernels' entries of the
    kernels line."""
    import torch.nn.functional as F

    from pde_tpu_torch.ops import cuda_cartesian_3d as c3
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.ops import cuda_stencil_3d as s3
    from pde_tpu_torch.parallel import HaloExchange

    f32, f64 = torch.float32, torch.float64
    gen = np.random.default_rng(7)

    def buffers(spec, n_planes, low=-0.5):
        """Random contiguous extended buffers of eight blocks."""
        shape = tuple(n + 2 * spec.halo for n in spec.shape)
        return [[torch.as_tensor(gen.uniform(low, 0.5, shape), dtype=spec.dtype, device=device)
                 for _ in range(n_planes)] for _ in EXT_FLAGS_3D]

    def run_affine(ins, outs, flags, spec):
        e3.affine_laplace_ext_3d([p[0] for p in ins], [p[0] for p in outs], flags, spec)

    def plain_affine(planes, spec, flags):
        return [e3.affine_laplace_ext_3d_plain(planes[0], spec, flags)]

    def check(label, run, plain, spec, n_planes, periodic):
        """One launch over eight blocks (flags EXT_FLAGS_3D on the non-periodic
        axes) against the plain version of each block, on the same buffers."""
        flag_sets = [[int(f and not periodic[i // 2]) for i, f in enumerate(flags)]
                     for flags in EXT_FLAGS_3D]
        ins = buffers(spec, n_planes)
        outs = buffers(spec, n_planes)
        run(ins, outs, flag_sets, spec)
        torch.cuda.synchronize()
        interior = tuple(slice(spec.halo, spec.halo + n) for n in spec.shape)
        err = scale = 0.0
        finite = True
        for planes, out, flags in zip(ins, outs, flag_sets):
            for o, r in zip(out, plain(planes, spec, flags)):
                err = max(err, float((o[interior] - r).abs().max()))
                scale = max(scale, float(r.abs().max()))
                finite = finite and bool(torch.isfinite(o).all())
        tol = (F64_TOL if spec.dtype == f64 else F32_STEP_RTOL * spec.k) * scale
        ok = finite and err <= tol
        shape = "x".join(map(str, spec.shape))
        print(f"[ext3d kernels] {label} {str(spec.dtype)[6:]} eight {shape} blocks halo "
              f"{spec.halo} k={spec.k} tile {spec.tile}: max_abs={err:.3e} "
              f"max_rel={err / scale:.3e} tol={tol:.1e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"3D ext kernel disagrees with its plain version: {label}")
        return err

    # -- 22. kernel vs plain (decomposed 3D) ---------------------------------------------------
    affine_grids = {
        "affine mixed faces": (pde.CartesianGrid([(0, 256), (0, 512), (0, 256)], [256] * 3),
                               (128, 128, 128)),
        "affine mixed faces ragged": (
            pde.CartesianGrid([(0, 80), (0, 144), (0, 100)], [80, 72, 100]), (40, 36, 50)),
    }
    ext_errs = {}
    top = c3.TOP_STEPS
    for label, (grid, local) in affine_grids.items():
        bcs = grid.get_boundary_conditions(SHARDED_BCS_3D)
        for dtype in (f32, f64):
            for k in (1, top):
                spec = e3.affine_laplace_ext_3d_spec(grid, local, a=1.0, b=0.05, k=k, halo=top,
                                                     dtype=dtype, bcs=bcs)
                ext_errs[(label, str(dtype), k)] = check(
                    label, run_affine, plain_affine, spec, 1, spec.periodic)
    for label, window in ext_windows.items():
        program = window.program
        halo = window.specs[0].halo
        for local in ((128, 128, 128), (40, 36, 50)):
            for dtype in (f32, f64):
                for k in program.ladder:
                    spec = e3.multi_stencil_ext_3d_spec(program, k, dtype, local, halo)
                    ext_errs[(label, local, str(dtype), k)] = check(
                        label, e3.multi_stencil_ext_3d, e3.multi_stencil_ext_3d_plain, spec, 1,
                        program.geometry.periodic)

    # one pass over eight 128³ blocks of a periodic grid (flags 0) at each k
    # (halo k, as its decomposed window), then at the top k, timed
    cells = 256**3
    periodic = pde.UnitGrid([256] * 3, periodic=True)
    dt = 0.05
    for k in range(1, c3.MAX_STEPS + 1):
        spec_k = e3.affine_laplace_ext_3d_spec(periodic, (128,) * 3, a=1.0, b=dt, k=k, halo=k,
                                               dtype=f32)
        ins = [p[0] for p in buffers(spec_k, 1, low=0.0)]
        outs = [p[0] for p in buffers(spec_k, 1)]

        def ext_pass(ins=ins, outs=outs, spec_k=spec_k):
            e3.affine_laplace_ext_3d(ins, outs, [[0] * 6] * 8, spec_k)

        k_ms = _cuda_ms(torch, ext_pass, 20)
        q_ms = _queued_ms(torch, ext_pass, 20)
        queued = "not measured" if q_ms is None else f"{q_ms:.4f} ms, {q_ms / k:.4f} ms per step"
        print(f"[ext3d kernels] affine_laplace_ext_3d one k={k} pass over eight 128^3 blocks "
              f"(halo {k}, plan (cx, ty, tz) {spec_k.tile}) on {smi}: {k_ms:.4f} ms a call, "
              f"{k_ms / k:.4f} ms per step; launches queued {queued}", flush=True)
        del ins, outs
    spec_top = e3.affine_laplace_ext_3d_spec(periodic, (128,) * 3, a=1.0, b=dt, k=top, halo=top,
                                             dtype=f32)
    flags0 = [[0] * 6] * 8
    ins = [p[0] for p in buffers(spec_top, 1, low=0.0)]
    outs = [p[0] for p in buffers(spec_top, 1)]
    affine_ms = _cuda_ms(torch, lambda: e3.affine_laplace_ext_3d(ins, outs, flags0, spec_top), 20)
    # the kernels' own time beside it: the wrapper's host work per call (eight
    # blocks' checks and pointer tables) can take as long as a top-k pass
    queued_ms = _queued_ms(torch, lambda: e3.affine_laplace_ext_3d(ins, outs, flags0, spec_top),
                           20)
    affine_plain_ms = _cuda_ms(
        torch, lambda: [e3.affine_laplace_ext_3d_plain(x, spec_top, f)
                        for x, f in zip(ins, flags0)], 3)
    ext_cells = 8 * (128 + 2 * top) ** 3
    affine_bound = _bound((ext_cells + cells) * 4, _affine_flops(spec_top.scales) * top * cells)
    weight = _composed_stencil(torch, 1.0, dt, spec_top.scales, top).to(device=device, dtype=f32)
    stacked = torch.stack(ins)[:, None]
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        library_ms = _cuda_ms(torch, lambda: F.conv3d(stacked, weight[None, None]), 5)
        library_out = F.conv3d(stacked, weight[None, None])[:, 0]
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    e3.affine_laplace_ext_3d(ins, outs, flags0, spec_top)
    interiors = torch.stack([o[top:top + 128, top:top + 128, top:top + 128] for o in outs])
    library_err = float((library_out - interiors).abs().max())
    library_ok = library_err <= LIBRARY_RTOL * float(interiors.abs().max())
    del stacked, library_out, interiors
    ac_window = ext_windows["allen-cahn periodic"]
    ac_top = ac_window.specs[0]
    for spec_k in ac_window.specs:  # the generated ext kernel at every k of its ladder
        k_ins, k_outs = buffers(spec_k, 1), buffers(spec_k, 1)

        def multi_pass(k_ins=k_ins, k_outs=k_outs, spec_k=spec_k):
            e3.multi_stencil_ext_3d(k_ins, k_outs, flags0, spec_k)

        k_ms = _cuda_ms(torch, multi_pass, 20)
        q_ms = _queued_ms(torch, multi_pass, 20)
        queued = ("not measured" if q_ms is None
                  else f"{q_ms:.4f} ms, {q_ms / spec_k.k:.4f} ms per step")
        ptx = " | ".join(_ptxas_of(ext_logs["allen-cahn periodic"], "multi_stencil_ext_3d_kernel",
                                   "EfLi{}ELi{}ELi{}ELi{}E".format(spec_k.k, *spec_k.tile)))
        print(f"[ext3d kernels] multi_stencil_ext_3d Allen-Cahn one k={spec_k.k} pass over eight "
              f"128^3 blocks (halo {spec_k.halo}, plan (cx, ty, tz) {spec_k.tile}) on {smi}: "
              f"{k_ms:.4f} ms a call, {k_ms / spec_k.k:.4f} ms per step; launches queued "
              f"{queued}; ptxas: {ptx}", flush=True)
        del k_ins, k_outs
    ac_ins = buffers(ac_top, 1)
    ac_outs = buffers(ac_top, 1)
    multi_ms = _cuda_ms(
        torch, lambda: e3.multi_stencil_ext_3d(ac_ins, ac_outs, flags0, ac_top), 20)
    multi_queued_ms = _queued_ms(
        torch, lambda: e3.multi_stencil_ext_3d(ac_ins, ac_outs, flags0, ac_top), 20)
    multi_plain_ms = _cuda_ms(
        torch, lambda: [e3.multi_stencil_ext_3d_plain(p, ac_top, f)
                        for p, f in zip(ac_ins, flags0)], 3)
    ac_ext_cells = 8 * (128 + 2 * ac_top.halo) ** 3
    multi_bound = _bound((ac_ext_cells + cells) * 4,
                         _program_flops(ac_window.program) * ac_top.k * cells)
    print(f"[ext3d kernels] one top-k pass over eight 128^3 blocks of a periodic fp32 grid on "
          f"{smi}: affine_laplace_ext_3d k={top} (tile {spec_top.tile}) {affine_ms:.4f} ms "
          f"a call (launches queued: "
          f"{'not measured' if queued_ms is None else f'{queued_ms:.4f} ms'}; plain "
          f"{affine_plain_ms:.4f} ms, bound "
          f"{affine_bound[0]:.4f} ms ({affine_bound[1]}), "
          f"one F.conv3d with the composed {2 * top + 1}^3 stencil over the extended blocks "
          f"{library_ms:.4f} ms, max_abs vs kernel {library_err:.3e} "
          f"{'ok' if library_ok else 'FAIL'}); multi_stencil_ext_3d Allen-Cahn k={ac_top.k} "
          f"(tile {ac_top.tile}, halo {ac_top.halo}) {multi_ms:.4f} ms (plain "
          f"{multi_plain_ms:.4f} ms, bound {multi_bound[0]:.4f} ms ({multi_bound[1]}))",
          flush=True)
    if not library_ok:
        raise AssertionError("the composed-stencil conv3d does not compute the ext pass")
    del ins, outs, ac_ins, ac_outs

    # -- 23. main path (decomposed 3D) --------------------------------------------------------
    pde.config["parallel.devices_per_device"] = 8  # a 2x2x2 mesh of blocks on one card
    state = pde.ScalarField.random_uniform(periodic, -0.1, 0.1, dtype=f32, device=device,
                                           rng=np.random.default_rng(0))
    eq = pde.DiffusionPDE(1.0)
    e3.affine_laplace_ext_3d.launches = 0
    e3.multi_stencil_ext_3d.launches = 0
    result = eq.solve(state, t_range=37 * dt, dt=dt, tracker=None, backend="cuda",
                      decomposition=[2, 2, 2])
    torch.cuda.synchronize()
    main_launches = e3.affine_laplace_ext_3d.launches
    info = eq.diagnostics["solver"]
    serial_stepper = pde.EulerSolver(eq, backend="cuda").make_stepper(state, dt=dt)
    serial, _ = serial_stepper(state, 0.0, 37 * dt)
    torch.cuda.synchronize()
    err_main = float((result.data - serial.data).abs().max())
    checks = [
        info.get("fused_step") is True, info.get("decomposition") == [2, 2, 2],
        main_launches > 0, info["steps"] == 37,
        result.data.shape == (256, 256, 256) and bool(torch.isfinite(result.data).all()),
        err_main == 0.0,
    ]
    print(f"[sharded3d main] 256^3 periodic fp32 DiffusionPDE(1.0), dt={dt}, eq.solve(..., "
          f"backend='cuda', decomposition=[2, 2, 2]) on eight blocks of one card, 37 steps: "
          f"max_abs vs the serial affine_laplace_3d window {err_main:.3e} "
          f"({'bit-equal' if err_main == 0 else 'not bit-equal'}); affine_laplace_ext_3d "
          f"launches {main_launches} {'ok' if all(checks) else 'FAIL'}", flush=True)
    if not all(checks):
        raise AssertionError(f"decomposed 3D main path checks failed: {checks}")

    def rates_in_turns(steppers, state, t_window, rounds):
        rates = dict.fromkeys(steppers, 0.0)
        for stepper in steppers.values():
            stepper(state, 0.0, t_window)  # warm-up windows of 2048 steps
        for round_ in range(rounds):
            order = list(steppers) if round_ % 2 == 0 else list(reversed(steppers))
            for label in order:
                torch.cuda.synchronize()
                start = time.perf_counter()
                steppers[label](state, 0.0, t_window)
                torch.cuda.synchronize()
                rates[label] = max(rates[label], cells * 2048 / (time.perf_counter() - start))
        return rates

    t_window = 2048 * dt
    steppers = {
        "serial": serial_stepper,
        "decomposed": pde.EulerSolver(eq, backend="cuda", decomposition=[2, 2, 2]).make_stepper(
            state, dt=dt),
    }
    rates = rates_in_turns(steppers, state, t_window, 3)
    launches0, copies0 = e3.affine_laplace_ext_3d.launches, HaloExchange.copies
    steppers["decomposed"](state, 0.0, t_window)
    torch.cuda.synchronize()
    window_launches = e3.affine_laplace_ext_3d.launches - launches0
    window_copies = HaloExchange.copies - copies0
    print(f"[sharded3d main] 256^3 periodic fp32 on {smi}: decomposed [2, 2, 2] "
          f"{rates['decomposed']:.4e} cell-updates/s, serial {rates['serial']:.4e} (2048-step "
          f"windows in turns, best of 3); per window {window_launches} affine_laplace_ext_3d "
          f"launches and {window_copies} halo copies ({window_copies // window_launches} per "
          f"pass; split and combine once per window)", flush=True)
    traced = _trace_window(torch, smi, "diffusion 256^3 [2, 2, 2]", steppers["decomposed"],
                           state, t_window, "affine_laplace_ext_3d_kernel")
    print(f"[sharded3d trace] per pass: {traced['kernel_us'] / window_launches:.2f} us of ext "
          f"kernel, {traced['other_us'] / window_launches:.2f} us of copies "
          f"({traced['other_us'] / window_copies:.3f} us per copy, split and combine included), "
          f"{traced['wall_us'] / window_launches:.2f} us of wall", flush=True)
    del steppers

    # -- 24. decomposed 3D BCs, Allen-Cahn and the x-cut --------------------------------------
    grid_bc = pde.CartesianGrid([(0, 128), (0, 256), (0, 128)], [128] * 3)
    state_bc = pde.ScalarField.random_uniform(grid_bc, dtype=f32, device=device,
                                              rng=np.random.default_rng(2))
    eq_bc = pde.DiffusionPDE(0.05, bc=SHARDED_BCS_3D)
    serial_bc, _ = pde.EulerSolver(eq_bc, backend="cuda").make_stepper(state_bc, dt=1.0)(
        state_bc, 0.0, 37.0)
    bc_launches = 0
    for decomposition in ([2, 2, 1], [1, 2, 2], [2, 1, 2]):
        launches0 = e3.affine_laplace_ext_3d.launches
        got = eq_bc.solve(state_bc, t_range=37.0, dt=1.0, tracker=None, backend="cuda",
                          decomposition=decomposition)
        torch.cuda.synchronize()
        err = float((got.data - serial_bc.data).abs().max())
        launched = e3.affine_laplace_ext_3d.launches - launches0
        bc_launches += launched
        ok = (err == 0.0 and launched > 0  # bit-equal: one per-cell update for both kernels
              and eq_bc.diagnostics["solver"].get("decomposition") == decomposition)
        print(f"[sharded3d bc] 128^3 fp32 diffusion, Dirichlet/Neumann/Robin/curvature faces, "
              f"{decomposition}, 37 steps: max_abs vs serial {err:.3e} "
              f"({'bit-equal' if err == 0 else 'not bit-equal'}), {launched} launches "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"decomposed 3D BC run disagrees with serial: {decomposition}")

    eq_ac = pde.AllenCahnPDE()
    serial_ac_stepper = pde.EulerSolver(eq_ac, backend="cuda").make_stepper(state, dt=dt)
    serial_ac, _ = serial_ac_stepper(state, 0.0, 37 * dt)
    torch.cuda.synchronize()
    multi_launches = {}
    for decomposition in ([2, 2, 2], [2, 1, 1]):
        e3.multi_stencil_ext_3d.launches = 0
        got_ac = eq_ac.solve(state, t_range=37 * dt, dt=dt, tracker=None, backend="cuda",
                             decomposition=decomposition)
        torch.cuda.synchronize()
        multi_launches[str(decomposition)] = e3.multi_stencil_ext_3d.launches
        err_ac = float((got_ac.data - serial_ac.data).abs().max())
        ok = (err_ac == 0.0  # bit-equal: one set of stage functions for both kernels
              and multi_launches[str(decomposition)] > 0
              and eq_ac.diagnostics["solver"].get("fused_step") is True)
        route = "row 4's ext_x route" if decomposition == [2, 1, 1] else "row 6"
        print(f"[sharded3d multi] AllenCahnPDE() 256^3 periodic fp32 on {decomposition} "
              f"({route}), 37 steps: max_abs vs the serial multi_stencil_3d window {err_ac:.3e} "
              f"({'bit-equal' if err_ac == 0 else 'not bit-equal'}); multi_stencil_ext_3d "
              f"launches {multi_launches[str(decomposition)]} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"decomposed 3D Allen-Cahn disagrees with serial: {decomposition}")
    steppers_ac = {
        "serial": serial_ac_stepper,
        "decomposed": pde.EulerSolver(eq_ac, backend="cuda", decomposition=[2, 2, 2])
        .make_stepper(state, dt=dt),
    }
    rates_ac = rates_in_turns(steppers_ac, state, t_window, 2)
    launches0, copies0 = e3.multi_stencil_ext_3d.launches, HaloExchange.copies
    steppers_ac["decomposed"](state, 0.0, t_window)
    torch.cuda.synchronize()
    print(f"[sharded3d multi] AllenCahnPDE() 256^3 periodic fp32 on {smi}: decomposed "
          f"[2, 2, 2] {rates_ac['decomposed']:.4e} cell-updates/s, serial "
          f"{rates_ac['serial']:.4e} (2048-step windows in turns, best of 2); per window "
          f"{e3.multi_stencil_ext_3d.launches - launches0} multi_stencil_ext_3d launches and "
          f"{HaloExchange.copies - copies0} halo copies", flush=True)
    pde.config["parallel.devices_per_device"] = 1
    if bc_launches <= 0:
        raise AssertionError("the decomposed 3D BC runs launched no affine_laplace_ext_3d")

    return {
        "affine_laplace_ext_3d": {
            "launches": main_launches,
            "max_abs_err": ext_errs[("affine mixed faces", str(f32), top)],
            "ms": affine_ms, "plain_ms": affine_plain_ms,
            "bound_ms": affine_bound[0], "bound_by": affine_bound[1],
            "library_ms": library_ms, "queued_ms": queued_ms,
        },
        "multi_stencil_ext_3d": {
            "launches": multi_launches["[2, 2, 2]"],
            "max_abs_err": ext_errs[("allen-cahn periodic", (128, 128, 128), str(f32),
                                     ac_top.k)],
            "ms": multi_ms, "plain_ms": multi_plain_ms,
            "bound_ms": multi_bound[0], "bound_by": multi_bound[1],
            "library_ms": None, "queued_ms": multi_queued_ms,
        },
    }


# the explicit solver family (phases 25-27): RK4 and AB2 windows of the generated
# kernels #7 (2D) and #5 (3D), label -> (model, grid shape, initial range, dt)
FAMILY_CASES = {
    "cahn-hilliard 4096^2 periodic": ("CahnHilliardPDE", (4096, 4096), (-0.1, 0.1), 1e-3),
    "allen-cahn 4096^2 periodic": ("AllenCahnPDE", (4096, 4096), (-0.5, 0.5), 1e-2),
    "allen-cahn 256^3 periodic": ("AllenCahnPDE", (256, 256, 256), (-0.1, 0.1), 0.05),
}
FAMILY_SCHEMES = {"rk4": "make_fused_rk4_window", "ab2": "make_fused_ab2_window"}
# the README example's last proposed dt, card against CPU in fp64: CUDA's double
# pow (adjust_dt's error_rel ** -0.2) is 1 ulp from the host's on 14 of the run's
# 120 errors, and the controller, whose error estimate is a difference of nearly
# equal states, carries that to 1.1e-12 over 115 steps (NVIDIA H100,
# scripts/torch_adaptive_card_cpu.py); the step count and the state are held to
# equality and 1e-12, and the card run with that power taken on the host to the
# CPU run's bits
README_DT_RTOL = 1e-11


def _host_power_adjust_dt(torch):
    """The port's ``adjust_dt`` with its one power, ``error_rel ** -0.2``, taken
    on the CPU (a host read a trial): every other operation of an adaptive run
    then gives the card the CPU's bits."""

    def adjust_dt(dt_step, error_rel):
        power = (error_rel.abs().cpu() ** -0.2).to(error_rel.device)
        finite = torch.isfinite(error_rel)
        return torch.where(
            error_rel < (0.9 / 4.0) ** 5,
            dt_step * 4.0,
            torch.where(~finite, dt_step * 0.25, dt_step * torch.clamp(0.9 * power, min=0.1)),
        )

    return adjust_dt
# config 3's mixed sides (tests/test_integration.py:117-149)
CONFIG3_BC = {"x": "periodic", "y-": {"value": 0}, "y+": {"derivative": 0}}


def _family_windows(pde, torch, device) -> dict:
    """Phase 25's windows, (label, scheme, dtype) -> {"window", "datas"}: the
    RK4 and AB2 windows of each case of :data:`FAMILY_CASES` in fp32 and fp64,
    with seeded inputs on the card (AB2's rate planes too)."""
    gen = torch.Generator(device=device).manual_seed(25)
    windows = {}
    for label, (model, shape, (lo, hi), dt) in FAMILY_CASES.items():
        grid = pde.UnitGrid(list(shape), periodic=True)
        for dtype in (torch.float32, torch.float64):
            state = pde.ScalarField(grid, torch.zeros(shape, dtype=dtype, device=device))
            for scheme, hook in FAMILY_SCHEMES.items():
                window = getattr(getattr(pde, model)(), hook)(state, dt)
                datas = [lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype,
                                                     device=device)
                         for _ in range(window.program.n_fields)]
                windows[(label, scheme, dtype)] = {"window": window, "datas": datas}
    return windows


def _traced_window(torch, stepper, state, t0, t1) -> tuple[float, float]:
    """(wall µs, device-busy µs) of one ``torch.profiler``-traced stepper call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        stepper(state, t0, t1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    return wall_us, sum(_device_times(prof).values())


def _solver_family(pde, torch, np, device, smi, family, logs) -> list[dict]:
    """Phases 25-27: the RK4 and AB2 programs of kernels #7 and #5 against
    their plain versions at every k of their ladders (fp32 and fp64) and
    their passes timed; the Cahn-Hilliard 4096² and Allen-Cahn 256³ main
    paths through ``solve(..., solver="runge-kutta"/"adams-bashforth",
    backend="cuda")`` against the plain loop on the card and their rates; the
    adaptive runs (the README example, fp64 against the CPU; Euler on 4096²
    diffusion; RKF45 on 1024² Swift-Hohenberg with config 3's sides). `logs`
    holds ptxas' report of each window's build, by (label, scheme). Returns
    the four rows of the kernels line."""
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3
    from pde_tpu_torch.trackers.interrupts import ConstantInterrupts

    f32, f64 = torch.float32, torch.float64
    wrappers = {2: (cs.multi_stencil_2d, cs.multi_stencil_2d_plain, "multi_stencil_2d_kernel"),
                3: (s3.multi_stencil_3d, s3.multi_stencil_3d_plain, "multi_stencil_3d_kernel")}

    # -- 25. kernel vs plain, RK4 and AB2 ------------------------------------------------------
    errs, times = {}, {}
    for (label, scheme, dtype), case in family.items():
        window, datas = case["window"], case["datas"]
        program = window.program
        rank = program.geometry.rank
        wrapper, plain, kernel = wrappers[rank]
        for spec in window.specs:
            out = wrapper(datas, spec)
            ref = plain(datas, spec)
            torch.cuda.synchronize()
            scale = max(float(r.abs().max()) for r in ref)
            err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
            tol = (F64_TOL if dtype == f64 else F32_STEP_RTOL * spec.k) * scale
            ok = all(bool(torch.isfinite(o).all()) for o in out) and err <= tol
            print(f"[family] {label} {scheme} {str(dtype)[6:]} k={spec.k} tile={spec.tile} "
                  f"({program.library}, {program.n_fields} planes): max_abs={err:.3e} "
                  f"max_rel={err / scale:.3e} tol={tol:.1e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError(f"{scheme} kernel disagrees with its plain version: {label}")
            errs[(label, scheme, str(dtype), spec.k)] = err
            del out, ref
        spec = window.specs[0]
        if dtype == f32:
            cells = int(np.prod(spec.shape))
            outs = [torch.empty_like(d) for d in datas]
            k_ms = _cuda_ms(torch, lambda: wrapper(datas, spec, outs=outs), 20)
            p_ms = _cuda_ms(torch, lambda: plain(datas, spec), 2)
            b_ms, b_by = _bound(2 * program.n_fields * cells * 4,
                                _program_flops(program) * spec.k * cells)
            times[(label, scheme)] = (k_ms, p_ms, b_ms, b_by, spec.k)
            print(f"[family throughput] {label} {scheme} fp32 one top k={spec.k} pass on {smi}: "
                  f"kernel {k_ms:.4f} ms ({k_ms / spec.k:.4f} ms a step, "
                  f"{cells * spec.k / k_ms * 1e3:.4e} cell-updates/s), plain {p_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}: {program.n_fields} planes each way, "
                  f"{_program_flops(program)} flops a cell-step; {b_ms / k_ms:.1%} of it); "
                  f"ladder {program.ladder} ({_ladder_passes(program.ladder, 2048)} passes a "
                  f"2048-step window)", flush=True)
        layout = program.march
        for k, tile in program.tiles[dtype].items():
            tag = "E{}Li{}E".format("f" if dtype == f32 else "d", k) + "".join(
                f"Li{t}E" for t in tile)
            print(f"[family plan] {label} {scheme} {str(dtype)[6:]} k={k}: plan {tile}, stages "
                  f"(lag, first volume, width) "
                  f"{[(st.lag, st.first, len(st.nodes)) for st in layout.stages]}, slots "
                  f"{layout.slots} a step ({layout.step_slots}); ptxas: "
                  + " | ".join(_ptxas_of(logs[(label, scheme)], kernel, tag)), flush=True)

    # -- 26. main paths --------------------------------------------------------------------------
    def two_windows(dt):
        return [pde.ConsistencyTracker(interrupts=ConstantInterrupts(10 * dt))]

    launches = {}
    main_runs = (
        ("cahn-hilliard 4096^2 periodic", pde.CahnHilliardPDE, cs.multi_stencil_2d, 2),
        ("allen-cahn 256^3 periodic", pde.AllenCahnPDE, s3.multi_stencil_3d, 3),
    )
    for label, model, wrapper, rank in main_runs:
        _, shape, (lo, hi), dt = FAMILY_CASES[label]
        state = pde.ScalarField.random_uniform(pde.UnitGrid(list(shape), periodic=True), lo, hi,
                                               dtype=f32, device=device,
                                               rng=np.random.default_rng(26))
        for scheme, solver in (("rk4", "runge-kutta"), ("ab2", "adams-bashforth")):
            wrapper.launches = 0
            result, info = model().solve(state, t_range=20 * dt, dt=dt, solver=solver,
                                         backend="cuda", tracker=two_windows(dt), ret_info=True)
            torch.cuda.synchronize()
            launches[(label, scheme)] = wrapper.launches
            ref = model().solve(state, t_range=20 * dt, dt=dt, solver=solver, backend="numpy",
                                tracker=two_windows(dt))
            torch.cuda.synchronize()
            scale = float(ref.data.abs().max())
            err = float((result.data - ref.data).abs().max())
            checks = [info["solver"].get("fused_step") is True, launches[(label, scheme)] > 0,
                      info["solver"]["steps"] == 20, bool(torch.isfinite(result.data).all()),
                      err <= F32_STEP_RTOL * 20 * scale]
            print(f"[family main] {label} fp32 {solver} (backend='cuda'), 20 steps in two "
                  f"tracker windows: max_abs vs the plain loop on the card {err:.3e} "
                  f"(tol {F32_STEP_RTOL * 20 * scale:.1e}); {wrapper.__name__} launches "
                  f"{launches[(label, scheme)]} {'ok' if all(checks) else 'FAIL'}", flush=True)
            if not all(checks):
                raise AssertionError(f"the {solver} main path failed its checks: {checks}")
            if rank == 2:  # rates of 2048-step windows
                solver_obj = {"rk4": pde.RungeKuttaSolver, "ab2": pde.AdamsBashforthSolver}[
                    scheme](model(), backend="cuda")
                stepper = solver_obj.make_stepper(state, dt=dt)
                data, t = stepper(state, 0.0, 2048 * dt)  # warm-up
                torch.cuda.synchronize()
                rate, per_window = 0.0, 0
                for _ in range(3):
                    before = wrapper.launches
                    start = time.perf_counter()
                    data, t = stepper(data, t, t + 2048 * dt)
                    torch.cuda.synchronize()
                    rate = max(rate, int(np.prod(shape)) * 2048 / (time.perf_counter() - start))
                    per_window = wrapper.launches - before
                if not bool(torch.isfinite(data.data).all()) or per_window <= 0:
                    raise AssertionError(f"the {solver} throughput windows failed")
                print(f"[family throughput] {label} fp32 {solver} on {smi}: {rate:.4e} "
                      f"cell-updates/s (best of 3 windows of 2048 steps); {per_window} "
                      f"launches a window", flush=True)

    # -- 27. adaptive ------------------------------------------------------------------------------
    readme = pde.ScalarField.random_uniform(pde.UnitGrid([64, 64]), rng=np.random.default_rng(0))
    result, info = pde.DiffusionPDE(0.1).solve(readme, t_range=10, ret_info=True)
    torch.cuda.synchronize()
    if result.device != device or not bool(torch.isfinite(result.data).all()):
        raise AssertionError("the README example did not run on the card")
    print(f"[adaptive] README example as written (64^2 {str(result.dtype)[6:]}, "
          f"DiffusionPDE(0.1).solve(state, t_range=10), default trackers) on the card: "
          f"{info['solver']['steps']} accepted steps, final dt {info['solver']['dt']:.6g}, "
          f"{info['solver']['adaptive_trials']} trials, {info['solver']['host_syncs']} host "
          f"reads", flush=True)
    from pde_tpu_torch.solvers import base as solver_base

    data64 = np.random.default_rng(0).uniform(size=(64, 64))
    runs = {}
    for where in ("card", "cpu", "host power"):
        state = pde.ScalarField(pde.UnitGrid([64, 64]), data64, dtype=f64,
                                device="cpu" if where == "cpu" else device)
        adjust_dt = solver_base.adjust_dt
        if where == "host power":
            solver_base.adjust_dt = _host_power_adjust_dt(torch)
        try:
            runs[where] = pde.DiffusionPDE(0.1).solve(state, t_range=10, tracker=None,
                                                      ret_info=True)
        finally:
            solver_base.adjust_dt = adjust_dt
    (card, card_info), (cpu, cpu_info) = runs["card"], runs["cpu"]
    hp, hp_info = runs["host power"]
    cs_, cc_ = card_info["solver"], cpu_info["solver"]
    dt_rel = abs(cs_["dt"] - cc_["dt"]) / cc_["dt"]
    state_rel = float((card.data.cpu() - cpu.data).abs().max() / cpu.data.abs().max())
    bits = (hp_info["solver"]["steps"] == cc_["steps"] and hp_info["solver"]["dt"] == cc_["dt"]
            and torch.equal(hp.data.cpu(), cpu.data))
    checks = [cs_["steps"] == cc_["steps"], dt_rel <= README_DT_RTOL, state_rel <= F64_TOL,
              card.device == device, bits]
    print(f"[adaptive] README example fp64, tracker=None: card {cs_['steps']} accepted steps, "
          f"final dt {cs_['dt']!r}; CPU {cc_['steps']}, {cc_['dt']!r}; dt rel diff {dt_rel:.2e}, "
          f"state rel diff {state_rel:.2e}; with adjust_dt's power on the host the card run "
          f"{'equals' if bits else 'differs from'} the CPU run bit for bit "
          f"{'ok' if all(checks) else 'FAIL'}", flush=True)
    if not all(checks):
        raise AssertionError(f"the README example's card run differs from the CPU run: {checks}")

    adaptive_runs = (
        ("adaptive Euler, DiffusionPDE(0.1) 4096^2 periodic fp32", pde.EulerSolver,
         pde.DiffusionPDE(0.1), pde.UnitGrid([4096, 4096], periodic=True), (0.0, 1.0), 1e-4,
         1000.0),
        ("adaptive RKF45, SwiftHohenbergPDE(rate=0.1) 1024^2 config-3 sides fp32",
         pde.RungeKuttaSolver, pde.SwiftHohenbergPDE(rate=0.1, bc=CONFIG3_BC),
         pde.UnitGrid([1024, 1024], periodic=[True, False]), (-0.1, 0.1), 1e-6, 20.0),
    )
    for label, solver_cls, eq, grid, (lo, hi), tolerance, t_end in adaptive_runs:
        state = pde.ScalarField.random_uniform(grid, lo, hi, dtype=f32, device=device,
                                               rng=np.random.default_rng(27))
        solver = solver_cls(eq, adaptive=True, tolerance=tolerance)
        stepper = solver.make_stepper(state)
        stepper(state, 0.0, 0.05 * t_end)  # warm-up (one window)
        solver.info.update(dt=solver.dt_default, steps=0, adaptive_trials=0, host_syncs=0)
        torch.cuda.synchronize()
        start = time.perf_counter()
        final, t = stepper(state, 0.0, t_end)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        steps, trials, syncs, dt_end = (solver.info[key] for key in (
            "steps", "adaptive_trials", "host_syncs", "dt"))
        if not bool(torch.isfinite(final.data).all()) or abs(t - t_end) > 1e-6 * t_end:
            raise AssertionError(f"{label} did not end finite at t = {t_end}")
        wall_us, busy_us = _traced_window(torch, stepper, final, t_end, 1.05 * t_end)
        idle = "not measured (the trace holds no device time)" if busy_us == 0 else (
            f"{1.0 - busy_us / wall_us:.4%}")
        print(f"[adaptive] {label}, tolerance {tolerance:g}, to t={t_end:g} in one window on "
              f"{smi}: {steps} accepted and {trials - steps} rejected trials, "
              f"{syncs} host reads a window, {seconds:.4f} s, "
              f"{steps / seconds:.4e} accepted steps/s, "
              f"{int(np.prod(grid.shape)) * steps / seconds:.4e} cell-updates/s, final dt "
              f"{dt_end:.4g}; one traced window to t={1.05 * t_end:g}: wall "
              f"{wall_us:.1f} us, device busy {busy_us:.1f} us, idle share {idle}", flush=True)

    rows = []
    for label, scheme, name, source, replaces in (
            ("cahn-hilliard 4096^2 periodic", "rk4", "multi_stencil_2d (RK4)",
             "pde_tpu_torch/csrc/march_2d.cuh", "pde_tpu/ops/pallas_cartesian.py:3755"),
            ("cahn-hilliard 4096^2 periodic", "ab2", "multi_stencil_2d (AB2)",
             "pde_tpu_torch/csrc/march_2d.cuh", "pde_tpu/ops/pallas_cartesian.py:3755"),
            ("allen-cahn 256^3 periodic", "rk4", "multi_stencil_3d (RK4)",
             "pde_tpu_torch/csrc/multi_stencil_3d.cuh", "pde_tpu/ops/pallas_cartesian.py:2935"),
            ("allen-cahn 256^3 periodic", "ab2", "multi_stencil_3d (AB2)",
             "pde_tpu_torch/csrc/multi_stencil_3d.cuh", "pde_tpu/ops/pallas_cartesian.py:2935")):
        k_ms, p_ms, b_ms, b_by, top = times[(label, scheme)]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[(label, scheme)],
            "max_abs_err": errs[(label, scheme, str(f32), top)],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    return rows


# the decomposed explicit family (phases 28-30): RK4 and AB2 of the ext kernels #8
# (4096² on [2, 2], blocks of 2048²) and #6 (256³ on [2, 2, 2], blocks of 128³), a
# periodic and a bounded mesh each (every edge flag), label -> (model, grid shape,
# periodic, decomposition, dt)
NOFLUX = {"derivative": 0}
SHARDED_FAMILY = {
    "cahn-hilliard 4096^2 periodic": (lambda pde: pde.CahnHilliardPDE(), (4096, 4096), True,
                                      [2, 2], 1e-3),
    "cahn-hilliard 4096^2 no-flux": (
        lambda pde: pde.CahnHilliardPDE(bc_c=NOFLUX, bc_mu=NOFLUX), (4096, 4096), False, [2, 2],
        1e-3),
    "allen-cahn 4096^2 periodic": (lambda pde: pde.AllenCahnPDE(), (4096, 4096), True, [2, 2],
                                   1e-2),
    "allen-cahn 256^3 periodic": (lambda pde: pde.AllenCahnPDE(), (256, 256, 256), True,
                                  [2, 2, 2], 0.05),
    "allen-cahn 256^3 no-flux": (lambda pde: pde.AllenCahnPDE(bc=NOFLUX), (256, 256, 256), False,
                                 [2, 2, 2], 0.05),
}


def _sharded_family_windows(pde, torch, device) -> dict:
    """Phase 28's decomposed windows, (label, scheme) -> window: the RK4 and
    AB2 windows of each case of :data:`SHARDED_FAMILY` on a mesh of blocks of
    one card; their ext programs go to the build."""
    from pde_tpu_torch.parallel import GridMesh

    windows = {}
    for label, (make_eq, shape, periodic, decomposition, dt) in SHARDED_FAMILY.items():
        grid = pde.UnitGrid(list(shape), periodic=periodic)
        state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=device)
        mesh = GridMesh(grid, decomposition, devices=[device] * math.prod(decomposition))
        for scheme, hook in FAMILY_SCHEMES.items():
            windows[(label, scheme)] = getattr(make_eq(pde), hook)(state, dt, mesh=mesh)
    return windows


def _kpz_width(torch, data, tiles: int = 8) -> tuple[float, float]:
    """(mean, standard error) of the squared interface width over tiles x
    tiles square tiles of a KPZ height field (each tile's variance about its
    own mean, in fp64)."""
    n, m = data.shape
    blocks = data.double().reshape(tiles, n // tiles, tiles, m // tiles).transpose(1, 2)
    w2 = blocks.reshape(tiles * tiles, -1).var(dim=1, unbiased=False)
    return float(w2.mean()), float(w2.std() / tiles)


def _profiled(torch, fn) -> tuple[float, dict, int]:
    """(wall µs, device µs by event, device events) of one ``torch.profiler``-traced call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    events = 0
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", None)
        if (event.self_cuda_time_total if device_us is None else device_us) > 0:
            events += event.count
    return wall_us, _device_times(prof), events


def _idle(busy_us: float, wall_us: float) -> str:
    if busy_us == 0:
        return "not measured (the trace holds no device time)"
    return f"{1.0 - busy_us / wall_us:.4%}"


def _sharded_family(pde, torch, np, device, smi, windows, logs) -> list[dict]:
    """Phases 28-30: the ext kernels #8 and #6 on the RK4 and AB2 programs
    against their plain versions at every k (fp32 and fp64, every edge flag)
    and their top-k passes timed; the decomposed RK4/AB2 main paths against
    the serial windows, bit for bit, and their rates; the plain sharded
    stepper (config 5's KPZ at 4096², fp64 KPZ, a vector and a coordinate
    rhs against the serial plain loop) and adaptive Euler and RKF45 over
    blocks. `logs` holds ptxas' report of each window's build, by (label,
    scheme). Returns the four rows of the kernels line."""
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.parallel import HaloExchange
    from pde_tpu_torch.trackers.interrupts import ConstantInterrupts

    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=device).manual_seed(28)
    kernels = {
        2: (ce.multi_stencil_ext_2d, ce.multi_stencil_ext_2d_plain, ce.multi_stencil_ext_spec,
            EXT_FLAGS, "multi_stencil_ext_2d_kernel"),
        3: (e3.multi_stencil_ext_3d, e3.multi_stencil_ext_3d_plain, e3.multi_stencil_ext_3d_spec,
            EXT_FLAGS_3D, "multi_stencil_ext_3d_kernel"),
    }

    # -- 28. kernel vs plain, ext RK4 and AB2 ----------------------------------------------------
    errs, times = {}, {}
    for (label, scheme), window in windows.items():
        program = window.program
        rank = program.geometry.rank
        wrapper, plain, make_spec, flag_table, kernel = kernels[rank]
        periodic = program.geometry.periodic
        flags = [[int(f and not periodic[i // 2]) for i, f in enumerate(row)] for row in flag_table]
        local, halo = window.specs[0].shape, window.specs[0].halo
        ladder = [spec.k for spec in window.specs]
        ext_shape = tuple(n + 2 * halo for n in local)
        for dtype in (f32, f64):
            ins = [[torch.rand(ext_shape, generator=gen, dtype=dtype, device=device) - 0.5
                    for _ in range(program.n_fields)] for _ in flags]
            outs = [[torch.zeros_like(p) for p in planes] for planes in ins]
            interior = tuple(slice(halo, halo + n) for n in local)
            for k in ladder:
                spec = make_spec(program, k, dtype, local, halo)
                wrapper(ins, outs, flags, spec)
                torch.cuda.synchronize()
                err = scale = 0.0
                finite = True
                for planes, out, block_flags in zip(ins, outs, flags):
                    for o, r in zip(out, plain(planes, spec, block_flags)):
                        err = max(err, float((o[interior] - r).abs().max()))
                        scale = max(scale, float(r.abs().max()))
                        finite = finite and bool(torch.isfinite(o[interior]).all())
                tol = (F64_TOL if dtype == f64 else F32_STEP_RTOL * k) * scale
                ok = finite and err <= tol
                print(f"[sharded family] {label} {scheme} {str(dtype)[6:]} k={k} halo {halo} "
                      f"tile {spec.tile} ({program.library}, {len(flags)} blocks of "
                      f"{'x'.join(map(str, local))}, {program.n_fields} planes, flags {flags}): "
                      f"max_abs={err:.3e} max_rel={err / scale:.3e} tol={tol:.1e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(
                        f"ext {scheme} kernel disagrees with its plain version: {label}")
                errs[(label, scheme, str(dtype), k)] = err
            if dtype == f32 and periodic[0]:  # one top-k pass, timed
                spec = make_spec(program, ladder[0], dtype, local, halo)
                cells = int(np.prod(local)) * len(flags)

                def ext_pass(spec=spec, ins=ins, outs=outs, flags=flags):
                    wrapper(ins, outs, flags, spec)

                k_ms = _cuda_ms(torch, ext_pass, 20)
                q_ms = _queued_ms(torch, ext_pass, 20)
                p_ms = _cuda_ms(torch, lambda: [plain(p, spec, f) for p, f in zip(ins, flags)], 2)
                b_ms, b_by = _bound(
                    program.n_fields * (len(flags) * int(np.prod(ext_shape)) + cells) * 4,
                    _program_flops(program) * spec.k * cells)
                times[(label, scheme)] = (k_ms, q_ms, p_ms, b_ms, b_by, spec.k)
                queued = "not measured" if q_ms is None else f"{q_ms:.4f} ms"
                tag = "EfLi{}E".format(spec.k) + "".join(f"Li{t}E" for t in spec.tile)
                print(f"[sharded family throughput] {label} {scheme} fp32 one top k={spec.k} "
                      f"pass over {len(flags)} blocks of {'x'.join(map(str, local))} on {smi}: "
                      f"{k_ms:.4f} ms a call ({k_ms / spec.k:.4f} ms a step; launches queued "
                      f"{queued}), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                      f"{program.n_fields} planes each way, {_program_flops(program)} flops a "
                      f"cell-step; {b_ms / k_ms:.1%} of it); ladder {ladder} "
                      f"({_ladder_passes(ladder, 2048)} passes a 2048-step window); ptxas: "
                      + " | ".join(_ptxas_of(logs[(label, scheme)], kernel, tag)), flush=True)
            del ins, outs

    # -- 29. decomposed RK4 and AB2 windows ------------------------------------------------------
    def two_windows(dt):
        return [pde.ConsistencyTracker(interrupts=ConstantInterrupts(10 * dt))]

    def rates_in_turns(steppers, state, dt, steps, cells, rounds=3):
        """Best cell-updates/s of each stepper's windows of `steps` steps, in turns."""
        rates = dict.fromkeys(steppers, 0.0)
        for stepper in steppers.values():
            stepper(state, 0.0, steps * dt)  # warm-up
        for round_ in range(rounds):
            for label in (list(steppers) if round_ % 2 == 0 else list(reversed(steppers))):
                torch.cuda.synchronize()
                start = time.perf_counter()
                steppers[label](state, 0.0, steps * dt)
                torch.cuda.synchronize()
                rates[label] = max(rates[label], cells * steps / (time.perf_counter() - start))
        return rates

    launches = {}
    for label, wrapper, per_device in (
            ("cahn-hilliard 4096^2 periodic", ce.multi_stencil_ext_2d, 4),
            ("allen-cahn 256^3 periodic", e3.multi_stencil_ext_3d, 8)):
        make_eq, shape, _, decomposition, dt = SHARDED_FAMILY[label]
        pde.config["parallel.devices_per_device"] = per_device
        cells = int(np.prod(shape))
        state = pde.ScalarField.random_uniform(pde.UnitGrid(list(shape), periodic=True), -0.1, 0.1,
                                               dtype=f32, device=device,
                                               rng=np.random.default_rng(29))
        for scheme, solver_cls in (("rk4", pde.RungeKuttaSolver),
                                   ("ab2", pde.AdamsBashforthSolver)):
            solver = solver_cls.name
            wrapper.launches = 0
            got, info = make_eq(pde).solve(state, t_range=20 * dt, dt=dt, solver=solver,
                                           backend="cuda", decomposition=decomposition,
                                           tracker=two_windows(dt), ret_info=True)
            torch.cuda.synchronize()
            launches[(label, scheme)] = wrapper.launches
            serial = make_eq(pde).solve(state, t_range=20 * dt, dt=dt, solver=solver,
                                        backend="cuda", tracker=two_windows(dt))
            torch.cuda.synchronize()
            err = float((got.data - serial.data).abs().max())
            checks = [info["solver"].get("fused_step") is True, launches[(label, scheme)] > 0,
                      info["solver"].get("decomposition") == decomposition,
                      info["solver"]["steps"] == 20, bool(torch.isfinite(got.data).all()),
                      err == 0.0]
            print(f"[sharded family main] {label} fp32 {solver} (backend='cuda', decomposition="
                  f"{decomposition}), 20 steps in two tracker windows: max_abs vs the serial "
                  f"window {err:.3e} (bit-equal required); {wrapper.__name__} launches "
                  f"{launches[(label, scheme)]} {'ok' if all(checks) else 'FAIL'}", flush=True)
            if not all(checks):
                raise AssertionError(f"the decomposed {solver} main path failed: {checks}")
            kwargs = {"adaptive": False} if scheme == "rk4" else {}
            steppers = {
                "serial": solver_cls(make_eq(pde), backend="cuda", **kwargs).make_stepper(
                    state, dt=dt),
                "decomposed": solver_cls(make_eq(pde), backend="cuda", decomposition=decomposition,
                                         **kwargs).make_stepper(state, dt=dt),
            }
            rates = rates_in_turns(steppers, state, dt, 2048, cells)
            launches0, copies0 = wrapper.launches, HaloExchange.copies
            steppers["decomposed"](state, 0.0, 2048 * dt)
            torch.cuda.synchronize()
            per_window = wrapper.launches - launches0
            copies = HaloExchange.copies - copies0
            if per_window <= 0:
                raise AssertionError(f"the decomposed {solver} windows launched no kernel")
            print(f"[sharded family main] {label} fp32 {solver} on {smi}: decomposed "
                  f"{decomposition} {rates['decomposed']:.4e} cell-updates/s, serial "
                  f"{rates['serial']:.4e} (2048-step windows in turns, best of 3); per window "
                  f"{per_window} {wrapper.__name__} launches and {copies} halo copies",
                  flush=True)
            _trace_window(torch, smi, f"{label} {solver} {decomposition}", steppers["decomposed"],
                          state, 2048 * dt, wrapper.__name__ + "_kernel")
    pde.config["parallel.devices_per_device"] = 4

    # -- 30. the plain sharded stepper and adaptive steps over blocks ----------------------------
    kpz_grid = pde.UnitGrid([4096, 4096], periodic=True)
    flat = pde.ScalarField(kpz_grid, 0.0, dtype=f32, device=device)
    dt = 1e-3
    sharded = pde.ExplicitShardedSolver(pde.KPZInterfacePDE(noise=0.1,
                                                            rng=np.random.default_rng(30)),
                                        decomposition=[2, 2])
    stepper = sharded.make_stepper(flat, dt=dt)
    serial_solver = pde.EulerSolver(pde.KPZInterfacePDE(noise=0.1, rng=np.random.default_rng(31)))
    serial_stepper = serial_solver.make_stepper(flat, dt=dt)
    if "fused_step" in sharded.info or not serial_solver.info.get("fused_step"):
        raise AssertionError("config 5 did not take the plain sharded stepper beside kernel #10")
    widths, state_d, state_s, t = [], flat, flat, 0.0
    for t_next in (0.128, 0.512):
        state_d, _ = stepper(state_d, t, t_next)
        state_s, t = serial_stepper(state_s, t, t_next)
        torch.cuda.synchronize()
        widths.append((_kpz_width(torch, state_d.data), _kpz_width(torch, state_s.data)))
    data = state_d.data
    half = data.shape[0] // 2
    (early_d, _), (late_d, late_s) = widths
    checks = [bool(torch.isfinite(data).all()), data.shape == tuple(kpz_grid.shape),
              not torch.allclose(data[:half, :half], data[half:, :half]),
              late_d[0] > early_d[0] + MOMENT_SIGMAS * math.hypot(late_d[1], early_d[1])]
    checks += [abs(d[0] - s[0]) <= MOMENT_SIGMAS * math.hypot(d[1], s[1]) for d, s in widths]
    print(f"[sharded plain] config 5: KPZInterfacePDE(noise=0.1) 4096^2 periodic fp32, dt=1e-3, "
          f"solver='explicit_sharded', decomposition=[2, 2] (the plain sharded stepper, halo "
          f"{sharded.info['sharded_halo']}), beside the serial kernel #10 path (another seed): "
          f"squared width (mean of 64 tiles' variance ± standard error) at t=0.128 "
          f"{widths[0][0][0]:.4e} ± {widths[0][0][1]:.1e} vs {widths[0][1][0]:.4e} ± "
          f"{widths[0][1][1]:.1e}, at t=0.512 {late_d[0]:.4e} ± {late_d[1]:.1e} vs "
          f"{late_s[0]:.4e} ± {late_s[1]:.1e} (within {MOMENT_SIGMAS:g} standard errors "
          f"required; growing); blocks decorrelated, finite {'ok' if all(checks) else 'FAIL'}",
          flush=True)
    if not all(checks):
        raise AssertionError(f"config 5 on a mesh failed its checks: {checks}")
    cells = int(np.prod(kpz_grid.shape))
    rates = {"plain sharded": 0.0, "serial #10": 0.0}
    for label, run in (("plain sharded", stepper), ("serial #10", serial_stepper)):
        for round_ in range(2):
            torch.cuda.synchronize()
            start = time.perf_counter()
            run(flat, 0.0, 0.256)
            torch.cuda.synchronize()
            rates[label] = max(rates[label], cells * 256 / (time.perf_counter() - start))
    copies0 = HaloExchange.copies
    wall_us, device_us, events = _profiled(torch, lambda: stepper(flat, 0.0, 0.256))
    copies = (HaloExchange.copies - copies0) / 256
    busy = sum(device_us.values())
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:4]
    print(f"[sharded plain] config 5 on {smi}: plain sharded [2, 2] {rates['plain sharded']:.4e} "
          f"cell-updates/s, serial kernel #10 window {rates['serial #10']:.4e} (256-step "
          f"windows, best of 2); {copies:g} copy calls a step; one traced 256-step window: wall "
          f"{wall_us:.1f} us, device busy {busy:.1f} us, {events / 256:.1f} device kernels a "
          f"step, idle share {_idle(busy, wall_us)}; top: "
          + "; ".join(f"{name[:50]} {us:.1f} us" for name, us in top), flush=True)

    def plain_vs_serial(label, make_eq, state, dt, steps):
        """A decomposed plain run against the serial plain loop (backend='numpy'),
        bit for bit."""
        got, info = make_eq().solve(state, t_range=steps * dt, dt=dt, tracker=None,
                                    decomposition=[2, 2], ret_info=True)
        serial = make_eq().solve(state, t_range=steps * dt, dt=dt, tracker=None,
                                 backend="numpy")
        torch.cuda.synchronize()
        err = float((got.data - serial.data).abs().max())
        ok = (err == 0 and "fused_step" not in info["solver"]
              and bool(torch.isfinite(got.data).all()) and got.device == device)
        solver = info["solver"]
        print(f"[sharded plain] {label} on [2, 2], {steps} steps (the plain sharded stepper, "
              f"halo {solver.get('sharded_halo')}; {solver.get('fused_unsupported')}): "
              f"max_abs vs the serial plain loop {err:.3e} (bit-equal required) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"the plain sharded stepper disagrees with serial: {label}")

    grid_1k = pde.UnitGrid([1024, 1024], periodic=True)
    plain_vs_serial("KPZInterfacePDE(noise=0.1) 1024^2 fp64, dt=1e-3, seed 32",
                    lambda: pde.KPZInterfacePDE(noise=0.1, rng=np.random.default_rng(32)),
                    pde.ScalarField(grid_1k, 0.0, dtype=f64, device=device), 1e-3, 100)
    plain_vs_serial("vector 0.2 * vector_laplace(u) + u - dot(u, u) * u 1024^2 fp32",
                    lambda: pde.PDE(GINZBURG_LANDAU),
                    pde.VectorField.random_uniform(grid_1k, -0.5, 0.5, dtype=f32, device=device,
                                                   rng=np.random.default_rng(33)), 1e-3, 20)
    plain_vs_serial("laplace(c) + x * c 1024^2 fp32", lambda: pde.PDE({"c": "laplace(c) + x * c"}),
                    pde.ScalarField.random_uniform(grid_1k, dtype=f32, device=device,
                                                   rng=np.random.default_rng(34)), 1e-4, 20)

    adaptive_runs = (
        ("adaptive Euler, DiffusionPDE(0.1) 4096^2 periodic fp32", pde.EulerSolver,
         lambda: pde.DiffusionPDE(0.1), kpz_grid, (0.0, 1.0), 1e-4, 1000.0),
        ("adaptive RKF45, SwiftHohenbergPDE(rate=0.1) 1024^2 config-3 sides fp32",
         pde.RungeKuttaSolver, lambda: pde.SwiftHohenbergPDE(rate=0.1, bc=CONFIG3_BC),
         pde.UnitGrid([1024, 1024], periodic=[True, False]), (-0.1, 0.1), 1e-6, 5.0),
    )
    for label, solver_cls, make_eq, grid, (lo, hi), tolerance, t_end in adaptive_runs:
        state = pde.ScalarField.random_uniform(grid, lo, hi, dtype=f32, device=device,
                                               rng=np.random.default_rng(30))
        runs = {}
        for where, kwargs in (("decomposed", {"decomposition": [2, 2]}), ("serial", {})):
            solver = solver_cls(make_eq(), adaptive=True, tolerance=tolerance, **kwargs)
            stepper = solver.make_stepper(state)
            torch.cuda.synchronize()
            copies0, start = HaloExchange.copies, time.perf_counter()
            final, t = stepper(state, 0.0, t_end)
            torch.cuda.synchronize()
            info = dict(solver.info, copies=HaloExchange.copies - copies0)
            runs[where] = (final, info, time.perf_counter() - start, stepper)
        (final, info, seconds, stepper), (serial, serial_info, serial_seconds, _) = (
            runs["decomposed"], runs["serial"])
        steps = info["steps"]
        err = float((final.data - serial.data).abs().max())
        checks = [steps == serial_info["steps"] > 0, err == 0.0, info["dt"] == serial_info["dt"],
                  bool(torch.isfinite(final.data).all()), "sharded_halo" in info]
        wall_us, device_us, events = _profiled(
            torch, lambda: stepper(final, t_end, 1.05 * t_end))
        busy = sum(device_us.values())
        print(f"[sharded adaptive] {label} on [2, 2], tolerance {tolerance:g}, to t={t_end:g} "
              f"in one window on {smi}: {steps} accepted and {info['adaptive_trials'] - steps} "
              f"rejected trials (serial {serial_info['steps']} and "
              f"{serial_info['adaptive_trials'] - serial_info['steps']}), {info['host_syncs']} "
              f"host reads, {info['copies'] / info['adaptive_trials']:g} copy calls a trial, "
              f"state max_abs vs serial {err:.3e} (bit-equal required); "
              f"{seconds:.4f} s, {int(np.prod(grid.shape)) * steps / seconds:.4e} cell-updates/s "
              f"(serial {serial_seconds:.4f} s, "
              f"{int(np.prod(grid.shape)) * steps / serial_seconds:.4e}); one traced window to "
              f"t={1.05 * t_end:g}: wall {wall_us:.1f} us, device busy {busy:.1f} us, "
              f"{events} device kernels, idle share {_idle(busy, wall_us)} "
              f"{'ok' if all(checks) else 'FAIL'}", flush=True)
        if not all(checks):
            raise AssertionError(f"{label} over blocks differs from serial: {checks}")
    pde.config["parallel.devices_per_device"] = 1

    rows = []
    for label, scheme, name, source, replaces in (
            ("cahn-hilliard 4096^2 periodic", "rk4", "multi_stencil_ext_2d (RK4)",
             "pde_tpu_torch/csrc/march_2d.cuh", "pde_tpu/ops/pallas_cartesian.py:4081"),
            ("cahn-hilliard 4096^2 periodic", "ab2", "multi_stencil_ext_2d (AB2)",
             "pde_tpu_torch/csrc/march_2d.cuh", "pde_tpu/ops/pallas_cartesian.py:4081"),
            ("allen-cahn 256^3 periodic", "rk4", "multi_stencil_ext_3d (RK4)",
             "pde_tpu_torch/csrc/multi_stencil_3d.cuh", "pde_tpu/ops/pallas_cartesian.py:3443"),
            ("allen-cahn 256^3 periodic", "ab2", "multi_stencil_ext_3d (AB2)",
             "pde_tpu_torch/csrc/multi_stencil_3d.cuh", "pde_tpu/ops/pallas_cartesian.py:3443")):
        k_ms, q_ms, p_ms, b_ms, b_by, top = times[(label, scheme)]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[(label, scheme)],
            "max_abs_err": errs[(label, scheme, str(f32), top)],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "queued_ms": q_ms,
        })
    return rows


# BASELINE config 4 (phases 31-33): curvilinear grids. The cylindrical grid has
# the main path's cells, bytes and dt (r and z from 0 to CYL_N, cells of 1), the
# spherical and polar grids CYL_N cells of 1; conditions per case: (periodic z,
# conditions)
CYL_N = 4096
CYL_CASES = {
    "no-flux": (False, {"r": {"derivative": 0}, "z": {"derivative": 0}}),
    "periodic z": (True, {"r": {"derivative": 0}, "z": "periodic"}),
    "value r": (False, {"r-": {"derivative": 0}, "r+": {"value": 1.5},
                        "z": {"derivative": 0}}),
    "mixed r": (False, {"r-": {"derivative": 0},
                        "r+": {"type": "mixed", "value": 2.0, "const": 0.5},
                        "z": {"value": 0.5}}),
}
CYL_NOFLUX = CYL_CASES["no-flux"][1]
# kernel #7's cylindrical programs (phase 32): label -> (rhs, PDE keywords, dt)
CYL_PROGRAMS = {
    "cahn-hilliard": ("laplace(c**3 - c - laplace(c))", {"bc_ops": {"c:laplace": CYL_NOFLUX}},
                      1e-3),
    "divergence of gradient": ("divergence(gradient(c))", {"bc": CYL_NOFLUX}, 1e-2),
}
# conditions of the operator checks on the card (phase 33), by grid class
CYL_OPERATOR_BC = {"r": {"derivative": 0}, "z": {"value": 0.5}}
RADIAL_OPERATOR_BC = {"inner": {"derivative": 0}, "outer": {"value": 1.0}}
CURVILINEAR_OPERATORS = {  # grid class -> operator -> input rank
    "PolarSymGrid": {"laplace": 0, "gradient": 0, "gradient_squared": 0, "divergence": 1,
                     "vector_gradient": 1, "tensor_divergence": 2},
    "SphericalSymGrid": {"laplace": 0, "gradient": 0, "gradient_squared": 0, "divergence": 1,
                         "vector_gradient": 1, "tensor_divergence": 2,
                         "tensor_double_divergence": 2},
    "CylindricalSymGrid": {"laplace": 0, "gradient": 0, "gradient_squared": 0, "divergence": 1,
                           "vector_gradient": 1, "vector_laplace": 1, "tensor_divergence": 2},
}


def _cylinder(pde, periodic_z: bool = False):
    return pde.CylindricalSymGrid(CYL_N, (0, CYL_N), (CYL_N, CYL_N), periodic_z=periodic_z)


def _curvilinear_units(pde, torch, device) -> dict:
    """Phases 31-35's builds: kernel #1's radial libraries (z bounded and
    periodic), kernel #7's cylindrical programs (Euler windows of
    :data:`CYL_PROGRAMS`, Cahn-Hilliard's RK4 window) with a window per
    dtype, on 4096² states on the card, and kernel #12's radial libraries."""
    from pde_tpu_torch.ops import cuda_cartesian as cc

    windows = {}
    for label, (rhs, kwargs, dt) in CYL_PROGRAMS.items():
        for dtype in (torch.float32, torch.float64):
            state = pde.ScalarField(_cylinder(pde), 0.0, dtype=dtype, device=device)
            eq = pde.PDE({"c": rhs}, **kwargs)
            windows[(label, "euler", dtype)] = eq.make_fused_euler_window(state, dt)
            if label == "cahn-hilliard":
                windows[(label, "rk4", dtype)] = eq.make_fused_rk4_window(state, dt)
    affine = [cc.kernel_source(periodic, cc.RADIAL_LIBRARY)
              for periodic in ((False, False), (False, True))]
    # phases 34-35: kernel #12's radial mode, z bounded and periodic
    from pde_tpu_torch.ops import cuda_ext_2d as ce

    radial_ext = [ce.affine_ext_source(periodic, radial=True)
                  for periodic in ((False, False), (False, True))]
    programs = list({w.program.digest: w.program for w in windows.values()}.values())
    return {"windows": windows, "affine": affine, "programs": programs,
            "radial_ext": radial_ext, "units": affine + programs + radial_ext}


def _check_close(torch, label, out, ref, dtype, steps) -> float:
    """Max |out - ref|, raising beyond fp32's 1e-6 a step or fp64's 1e-12,
    relative to max |ref|; one line printed."""
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    tol = (F64_TOL if dtype == torch.float64 else F32_STEP_RTOL * steps) * scale
    ok = bool(torch.isfinite(out).all()) and err <= tol
    print(f"[curvilinear kernel] {label} {str(dtype)[6:]}: steps={steps} max_abs={err:.3e} "
          f"max_rel={err / scale:.3e} tol={tol:.1e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {label}")
    return err


def _window_rate(torch, stepper, state, dt, steps=2048, windows=3):
    """Best of 3 cell-updates/s of `windows` stepper windows of `steps` steps,
    after a warm-up window."""
    cells = math.prod(state.grid.shape)
    data, t = stepper(state, 0.0, dt * steps)
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(3):
        start = time.perf_counter()
        for _ in range(windows):
            data, t = stepper(data, t, t + dt * steps)
        torch.cuda.synchronize()
        best = max(best, cells * steps * windows / (time.perf_counter() - start))
    if not bool(torch.isfinite(data.data).all()):
        raise AssertionError("a throughput window ended non-finite")
    return best


def _curvilinear(pde, torch, np, device, smi, units, logs) -> list[dict]:
    """Phases 31-33: BASELINE config 4. Kernel #1's radial mode and kernel
    #7's radial helpers against their plain versions at 4096² at every k of
    their ladders (fp32 and fp64) and timed; the cylindrical diffusion and
    Cahn-Hilliard windows through ``EulerSolver(backend="cuda")`` against the
    plain versions, their launches a window and their rates beside the
    Cartesian main path's in turns; spherical and polar diffusion on the
    plain torch path; and every operator of the three grids on the card
    against the CPU in fp64. `logs` holds ptxas' report of each unit's
    build, by its digest. Returns the two rows of the kernels line."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    f32, f64 = torch.float32, torch.float64
    cells = CYL_N * CYL_N
    size = f"{CYL_N}^2"
    gen = np.random.default_rng(31)

    def on_card(shape, dtype, lo=0.0, hi=1.0):
        return torch.as_tensor(gen.uniform(lo, hi, shape), dtype=dtype, device=device)

    # -- 31. kernel #1's radial mode against its plain version -------------------------------
    ladder = [spec.k for spec in cc.make_fused_euler_window_2d(
        _cylinder(pde), diffusivity=0.1, dt=0.1, dtype=f32,
        bcs=_cylinder(pde).get_boundary_conditions(CYL_NOFLUX)).specs]
    errs = {}
    for dtype in (f32, f64):
        for label, (periodic_z, bc) in CYL_CASES.items():
            grid = _cylinder(pde, periodic_z)
            bcs = grid.get_boundary_conditions(bc)
            data = on_card(grid.shape, dtype)
            for k in ladder:
                spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k, dtype=dtype, bcs=bcs)
                errs[(label, str(dtype), k)] = _check_close(
                    torch, f"affine_laplace_2d radial {label} {size} k={k}",
                    cc.affine_laplace_2d(data, spec), cc.affine_laplace_2d_plain(data, spec),
                    dtype, k)
            # the cuda registry's laplace: kernel #1 at a = 0, b = 1, k = 1
            op = pde.get_backend("cuda").make_operator(grid, "laplace", bc)
            spec1 = cc.affine_laplace_spec(grid, a=0.0, b=1.0, k=1, dtype=dtype, bcs=bcs)
            _check_close(torch, f"registry laplace (radial k=1) {label} {size}", op(data),
                         cc.affine_laplace_2d_plain(data, spec1), dtype, 1)
            _check_close(torch, f"registry laplace against ops/cylindrical.py {label} {size}",
                         op(data), grid.make_operator("laplace", bc)(data), dtype, 1)
    grid = _cylinder(pde)
    bcs = grid.get_boundary_conditions(CYL_NOFLUX)
    data = on_card(grid.shape, f32)
    out = torch.empty_like(data)
    radial_log = logs[units["affine"][0].digest]
    per_k, radial_ms = [], {}
    for k in sorted(ladder):
        spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=k, dtype=f32, bcs=bcs)
        k_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d(data, spec, out=out), 20)
        b_ms, b_by = _bound(2 * cells * 4, 8 * k * cells)
        tx, threads, _, _ = spec.tile
        regs = _ptxas_of(radial_log, "affine_laplace_radial_2d_kernel",
                         f"IfLi{k}ELi{tx}ELi{threads}E")
        per_k.append(f"k={k} {k_ms:.4f} ms ({k_ms / k:.5f} a step, {b_ms / k_ms:.1%} of the "
                     f"bound; {' | '.join(regs)})")
        radial_ms[k] = (k_ms, b_ms, b_by)
    top = ladder[0]
    spec_top = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=top, dtype=f32, bcs=bcs)
    radial_plain_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d_plain(data, spec_top), 5)
    op = pde.get_backend("cuda").make_operator(grid, "laplace", CYL_NOFLUX)
    registry_ms = _cuda_ms(torch, lambda: op(data), 20)
    print(f"[curvilinear throughput] affine_laplace_2d radial mode, {size} no-flux fp32, one "
          f"pass per k on {smi} (bound {radial_ms[top][1]:.4f} ms, {radial_ms[top][2]}): "
          + "; ".join(per_k) + f"; plain version at k={top} {radial_plain_ms:.4f} ms; the "
          f"registry's laplace {registry_ms:.4f} ms a call", flush=True)
    for digest, unit in ((u.digest, u) for u in units["affine"]):
        print(f"[curvilinear ptxas] affine_laplace_2d radial, periodic axes {unit.periodic}: "
              f"{_ptxas(logs[digest])}", flush=True)

    # -- 32. kernel #7's radial helpers against their plain versions -------------------------
    multi_errs, multi_ms = {}, {}
    for (label, scheme, dtype), window in units["windows"].items():
        program = window.program
        datas = [on_card(program.geometry.shape, dtype) for _ in range(program.n_fields)]
        for spec in window.specs:
            outs = cs.multi_stencil_2d(datas, spec)
            refs = cs.multi_stencil_2d_plain(datas, spec)
            multi_errs[(label, scheme, str(dtype), spec.k)] = max(
                _check_close(torch, f"multi_stencil_2d radial {label} {scheme} {size} "
                             f"k={spec.k}", o, r, dtype, spec.k)
                for o, r in zip(outs, refs, strict=True))
            if dtype == f32:
                outs = [torch.empty_like(d) for d in datas]
                k_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d(datas, spec, outs=outs), 20)
                b_ms, b_by = _bound(2 * program.n_fields * cells * 4,
                                    _program_flops(program) * spec.k * cells)
                p_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d_plain(datas, spec), 3) if (
                    spec is window.specs[0]) else None
                multi_ms[(label, scheme, spec.k)] = (k_ms, p_ms, b_ms, b_by)
        if dtype == f32:
            times = "; ".join(
                f"k={k} {v[0]:.4f} ms ({v[0] / k:.5f} a step, {v[2] / v[0]:.1%} of the bound "
                f"{v[2]:.4f} ms, {v[3]})" + ("" if v[1] is None else f", plain {v[1]:.4f} ms")
                for (lb, sc, k), v in multi_ms.items() if (lb, sc) == (label, scheme))
            print(f"[curvilinear throughput] multi_stencil_2d radial {label} {scheme} {size} "
                  f"fp32 on {smi}: ladder {program.ladder}, "
                  f"{_ladder_passes(program.ladder, 2048)} passes a 2048-step window; {times}; "
                  f"{_ptxas(logs[program.digest])}", flush=True)

    # -- 33. config 4 end to end ---------------------------------------------------------------
    cart = pde.UnitGrid([CYL_N, CYL_N], periodic=True)
    cart_state = pde.ScalarField.random_uniform(cart, dtype=f32, rng=np.random.default_rng(33))
    cart_stepper = pde.EulerSolver(pde.DiffusionPDE(0.1), backend="cuda").make_stepper(
        cart_state, dt=0.1)
    eq = pde.DiffusionPDE(0.1, bc=CYL_NOFLUX)
    state = pde.ScalarField.random_uniform(grid, dtype=f32, rng=np.random.default_rng(34))
    if state.data.device != device:
        raise AssertionError(f"config 4's state lies on {state.data.device}, not the card")
    cc.affine_laplace_2d.launches = 0
    cs.multi_stencil_2d.launches = 0
    solver = pde.EulerSolver(eq, backend="cuda")
    stepper = solver.make_stepper(state, dt=0.1)
    result, t_reached = stepper(state, 0.0, 3.7)
    solved = eq.solve(state, t_range=3.7, dt=0.1, backend="cuda", tracker=None)
    torch.cuda.synchronize()
    diffusion_launches = cc.affine_laplace_2d.launches
    spec1 = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=1, dtype=f32, bcs=bcs)
    ref = state.data
    for _ in range(37):
        ref = cc.affine_laplace_2d_plain(ref, spec1)
    err = float((result.data - ref).abs().max())
    checks = [
        solver.info.get("fused_step") is True, eq.diagnostics["solver"].get("fused_step"),
        diffusion_launches == 2 * _ladder_passes(ladder, 37), abs(t_reached - 3.7) < 1e-9,
        err <= F32_STEP_RTOL * 37 * float(ref.abs().max()),
        bool(torch.equal(solved.data, result.data)),
    ]
    print(f"[config 4] cylindrical {size} no-flux fp32 DiffusionPDE(0.1), 37 steps "
          f"(backend='cuda', make_stepper and solve): max_abs vs plain {err:.3e}; kernel "
          f"launches {diffusion_launches} {'ok' if all(checks) else 'FAIL'}", flush=True)
    if not all(checks):
        raise AssertionError(f"config 4's diffusion checks failed: {checks}")
    rates = []
    for label, cyl, bc, dt in (
            (f"{size} no-flux", grid, CYL_NOFLUX, 0.1),
            (f"{size} periodic z", _cylinder(pde, True), CYL_CASES["periodic z"][1], 0.1),
            (f"{CYL_N // 2}^2 (pde_tpu's grid, in L2)",
             pde.CylindricalSymGrid(1.0, (0, 2), (CYL_N // 2, CYL_N // 2)), CYL_NOFLUX, 1e-8)):
        cyl_state = pde.ScalarField.random_uniform(cyl, dtype=f32, rng=np.random.default_rng(35))
        cyl_stepper = pde.EulerSolver(pde.DiffusionPDE(0.1, bc=bc), backend="cuda").make_stepper(
            cyl_state, dt=dt)
        before = cc.affine_laplace_2d.launches
        cyl_stepper(cyl_state, 0.0, dt * 2048)
        torch.cuda.synchronize()
        per_window = cc.affine_laplace_2d.launches - before
        if per_window != _ladder_passes(ladder, 2048):
            raise AssertionError(f"{label}: {per_window} launches a 2048-step window, not "
                                 f"{_ladder_passes(ladder, 2048)}")
        if cyl is grid:  # in turns with the Cartesian main path: plain, kernel, kernel, plain
            measured = [_window_rate(torch, stepper_, state_, dt_) for stepper_, state_, dt_ in (
                (cart_stepper, cart_state, 0.1), (cyl_stepper, cyl_state, dt),
                (cyl_stepper, cyl_state, dt), (cart_stepper, cart_state, 0.1))]
            cart_rates, cyl_rates = measured[::3], measured[1:3]
        else:
            cyl_rates = [_window_rate(torch, cyl_stepper, cyl_state, dt)]
        rates.append(f"{label} " + " / ".join(f"{r:.4e}" for r in cyl_rates)
                     + f" ({per_window} launches a window)")
    print(f"[config 4] cylindrical diffusion fp32 on {smi}, cell-updates/s of 2048-step windows "
          f"(best of 3 x 3 after a warm-up; ladder {ladder}): " + "; ".join(rates)
          + f"; the Cartesian main path ({size} periodic UnitGrid), before and after: "
          + " / ".join(f"{r:.4e}" for r in cart_rates), flush=True)

    # the cylindrical Cahn-Hilliard window
    rhs, kwargs, dt_ch = CYL_PROGRAMS["cahn-hilliard"]
    eq_ch = pde.PDE({"c": rhs}, **kwargs)
    ch_state = pde.ScalarField.random_uniform(grid, dtype=f32, rng=np.random.default_rng(36))
    cs.multi_stencil_2d.launches = 0
    ch_solver = pde.EulerSolver(eq_ch, backend="cuda")
    ch_stepper = ch_solver.make_stepper(ch_state, dt=dt_ch)
    ch_result, _ = ch_stepper(ch_state, 0.0, 37 * dt_ch)
    torch.cuda.synchronize()
    ch_launches = cs.multi_stencil_2d.launches
    ch_plain, _ = pde.EulerSolver(eq_ch, backend="numpy").make_stepper(ch_state, dt=dt_ch)(
        ch_state, 0.0, 37 * dt_ch)
    ch_err = float((ch_result.data - ch_plain.data).abs().max())
    ch_program_ladder = units["windows"][("cahn-hilliard", "euler", f32)].program.ladder
    ch_checks = [ch_solver.info.get("fused_step") is True,
                 ch_launches == _ladder_passes(ch_program_ladder, 37),
                 ch_err <= F32_STEP_RTOL * 37 * float(ch_plain.data.abs().max())]
    before = cs.multi_stencil_2d.launches
    ch_stepper(ch_state, 0.0, 2048 * dt_ch)
    torch.cuda.synchronize()
    ch_window_launches = cs.multi_stencil_2d.launches - before
    ch_checks.append(ch_window_launches == _ladder_passes(ch_program_ladder, 2048))
    ch_rate = _window_rate(torch, ch_stepper, ch_state, dt_ch)
    print(f"[config 4] cylindrical Cahn-Hilliard {size} no-flux fp32, dt={dt_ch:g} "
          f"(backend='cuda') on {smi}: 37 steps max_abs vs the plain loop {ch_err:.3e}, "
          f"{ch_launches} launches; {ch_window_launches} launches a 2048-step window (ladder "
          f"{ch_program_ladder}); {ch_rate:.4e} cell-updates/s (best of 3 x 3 windows) "
          f"{'ok' if all(ch_checks) else 'FAIL'}", flush=True)
    if not all(ch_checks):
        raise AssertionError(f"config 4's Cahn-Hilliard checks failed: {ch_checks}")

    # spherical and polar diffusion: the plain torch path, as in pde_tpu
    for name in ("SphericalSymGrid", "PolarSymGrid"):
        radial_grid = getattr(pde, name)(CYL_N, CYL_N)
        for conservative in (True, False):
            key = {"operators.conservative_stencil": conservative}
            with pde.config(key):
                eq_r = pde.DiffusionPDE(0.1)
                data64 = gen.uniform(0, 1, radial_grid.shape)
                card = pde.ScalarField(radial_grid, data64, dtype=f64)
                cpu = pde.ScalarField(radial_grid, data64, dtype=f64, device="cpu")
                r_solver = pde.EulerSolver(eq_r, backend="torch")
                r_stepper = r_solver.make_stepper(card, dt=0.1)
                r_card, _ = r_stepper(card, 0.0, 20.0)
                r_cpu, _ = pde.EulerSolver(eq_r, backend="torch").make_stepper(cpu, dt=0.1)(
                    cpu, 0.0, 20.0)
                r_err = float((r_card.data.cpu() - r_cpu.data).abs().max())
                state32 = pde.ScalarField(radial_grid, data64, dtype=f32)
                stepper32 = pde.EulerSolver(eq_r, backend="torch").make_stepper(state32, dt=0.1)
                stepper32(state32, 0.0, 10.0)
                torch.cuda.synchronize()
                start = time.perf_counter()
                stepper32(state32, 0.0, 200.0)
                torch.cuda.synchronize()
                steps_per_s = 2000 / (time.perf_counter() - start)
            ok = ("fused_step" not in r_solver.info and r_err <= F64_TOL * float(
                r_cpu.data.abs().max()))
            print(f"[config 4] {name}({CYL_N}, {CYL_N}) DiffusionPDE(0.1) dt=0.1, conservative "
                  f"stencil {conservative}, plain torch on {smi}: fp64 200 steps on the card vs "
                  f"the CPU max_abs {r_err:.3e}; fp32 {steps_per_s:.1f} steps/s "
                  f"({steps_per_s * CYL_N:.4e} cell-updates/s; no kernel: "
                  f"{r_solver.info.get('fused_unsupported', '')}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} diffusion on the card disagrees with the CPU")

    # every operator of the three grids on the card against the CPU, fp64
    op_grids = {"PolarSymGrid": pde.PolarSymGrid(CYL_N, CYL_N),
                "SphericalSymGrid": pde.SphericalSymGrid(CYL_N, CYL_N),
                "CylindricalSymGrid": _cylinder(pde)}
    results = []
    for name, op_grid in op_grids.items():
        bc = CYL_OPERATOR_BC if name == "CylindricalSymGrid" else RADIAL_OPERATOR_BC
        for op_name, rank in CURVILINEAR_OPERATORS[name].items():
            # the config key selects the spherical grid's flux forms only
            variants = (True, False) if name == "SphericalSymGrid" and op_name in (
                "laplace", "divergence", "tensor_divergence", "tensor_double_divergence") else (
                True,)
            for conservative in variants:
                data64 = gen.uniform(-1, 1, (op_grid.dim,) * rank + op_grid.shape)
                with pde.config({"operators.conservative_stencil": conservative}):
                    operator = op_grid.make_operator(op_name, bc)
                    card = torch.as_tensor(data64, device=device)
                    got = operator(card)
                    op_ms = _cuda_ms(torch, lambda: operator(card), 3)
                    expected = operator(torch.as_tensor(data64))
                del card
                op_err = float((got.cpu() - expected).abs().max())
                scale = max(1.0, float(expected.abs().max()))
                ok = op_err <= F64_TOL * scale and tuple(got.shape) == tuple(expected.shape)
                results.append(f"{name} {op_name}{'' if conservative else ' (naive)'} "
                               f"{op_err:.2e} {op_ms:.3f} ms{'' if ok else ' FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {op_name} on the card disagrees with the CPU")
                del got, expected
    print(f"[config 4] operators on the card against the CPU, fp64, full width (polar and "
          f"spherical {CYL_N} cells, cylindrical {size}) on {smi}: max_abs, ms a call on the "
          "card: " + "; ".join(results), flush=True)

    radial_top = radial_ms[top]
    ch_top = ch_program_ladder[0]
    ch_times = multi_ms[("cahn-hilliard", "euler", ch_top)]
    return [{
        "name": "affine_laplace_2d (radial mode)",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:793 (radial mode: :197, :1052)",
        "launches": diffusion_launches,
        "max_abs_err": errs[("no-flux", str(f32), top)],
        "ms": radial_top[0],
        "plain_ms": radial_plain_ms,
        "bound_ms": radial_top[1],
        "bound_by": radial_top[2],
        "library_ms": None,  # a row-varying stencil is not a convolution
    }, {
        "name": "multi_stencil_2d (radial helpers)",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:3755 (radial helpers: :1770)",
        "launches": ch_launches,
        "max_abs_err": multi_errs[("cahn-hilliard", "euler", str(f32), ch_top)],
        "ms": ch_times[0],
        "plain_ms": ch_times[1],
        "bound_ms": ch_times[2],
        "bound_by": ch_times[3],
        "library_ms": None,  # the rhs is nonlinear
    }]


# the decomposed curvilinear phases (34-36): the meshes of the radial ext
# kernel's check, label -> (grid, decomposition, conditions)
def _radial_ext_meshes(pde) -> dict:
    return {
        "[2, 2] periodic z": (_cylinder(pde, True), [2, 2], CYL_CASES["periodic z"][1]),
        "[2, 2] no-flux": (_cylinder(pde), [2, 2], CYL_NOFLUX),
        "[4, 1] mixed r, value z": (_cylinder(pde), [4, 1], CYL_CASES["mixed r"][1]),
        # blocks of 10x18 cells under a halo of 8, a hole at r = 2
        "[2, 2] ragged": (pde.CylindricalSymGrid((2, 22), (0, 36), (20, 36)), [2, 2],
                          CYL_CASES["mixed r"][1]),
    }


def _decomposed_curvilinear(pde, torch, np, device, smi, units, logs) -> dict:
    """Phases 34-36: kernel #12's radial mode against its plain version on
    the blocks of decomposed cylindrical grids and timed; config 4's
    diffusion on [2, 2] through the decomposed window against the serial
    window, its rate, launches, copies and idle share; the plain sharded
    stepper on polar, spherical and cylindrical grids against the serial
    plain runs. `logs` holds ptxas' report of each unit, by its digest.
    Returns the radial ext kernel's row of the kernels line."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh, HaloExchange

    f32, f64 = torch.float32, torch.float64
    gen = np.random.default_rng(34)
    top = cc.RADIAL_TOP_STEPS
    ladder = [top >> i for i in range(top.bit_length())]
    cells = CYL_N * CYL_N

    def buffers(spec, n_blocks):
        n, m = spec.shape
        h = spec.halo
        return [torch.as_tensor(gen.uniform(0.0, 1.0, (n + 2 * h, m + 2 * h)), dtype=spec.dtype,
                                device=device) for _ in range(n_blocks)]

    # -- 34. kernel #12's radial mode against its plain version ------------------------------
    errs = {}
    for label, (grid, decomposition, bc) in _radial_ext_meshes(pde).items():
        mesh = GridMesh(grid, decomposition, devices=[device] * math.prod(decomposition))
        flags = [mesh.edge_flags(b) + [mesh.block_origin(b)[0]] for b in range(len(mesh))]
        bcs = grid.get_boundary_conditions(bc)
        for dtype in (f32, f64):
            for k in ladder:
                spec = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=0.01, k=k,
                                                  halo=top, dtype=dtype, bcs=bcs)
                ins, outs = buffers(spec, len(mesh)), buffers(spec, len(mesh))
                ce.affine_laplace_ext_2d(ins, outs, flags, spec)
                h, (n, m) = spec.halo, spec.shape
                got = torch.stack([o[h:h + n, h:h + m] for o in outs])
                ref = torch.stack([ce.affine_laplace_ext_2d_plain(x, spec, f)
                                   for x, f in zip(ins, flags)])
                errs[(label, str(dtype), k)] = _check_close(
                    torch, f"affine_laplace_ext_2d radial {label} blocks {n}x{m} halo {h} k={k} "
                    f"flags {flags}", got, ref, dtype, k)
    grid = _cylinder(pde)
    bcs = grid.get_boundary_conditions(CYL_NOFLUX)
    mesh = GridMesh(grid, [2, 2], devices=[device] * 4)
    flags = [mesh.edge_flags(b) + [mesh.block_origin(b)[0]] for b in range(4)]
    spec_top = ce.affine_laplace_ext_spec(grid, mesh.local_shape, a=1.0, b=0.01, k=top,
                                          halo=top, dtype=f32, bcs=bcs)
    ins, outs = buffers(spec_top, 4), buffers(spec_top, 4)
    ext_ms = _cuda_ms(torch, lambda: ce.affine_laplace_ext_2d(ins, outs, flags, spec_top), 20)
    ext_plain_ms = _cuda_ms(torch, lambda: [ce.affine_laplace_ext_2d_plain(x, spec_top, f)
                                            for x, f in zip(ins, flags)], 3)
    ext_cells = 4 * (CYL_N // 2 + 2 * top) ** 2
    ext_bound = _bound((ext_cells + cells) * 4, 8 * top * cells)
    data = torch.as_tensor(gen.uniform(0.0, 1.0, grid.shape), dtype=f32, device=device)
    serial_spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=top, dtype=f32, bcs=bcs)
    serial_out = torch.empty_like(data)
    serial_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d(data, serial_spec, out=serial_out),
                         20)
    tx, threads, _, _ = spec_top.tile
    regs = {}
    for periodic, unit in zip((False, True), units["radial_ext"]):
        regs[periodic] = "; ".join(
            f"k={k}: " + " | ".join(_ptxas_of(
                logs[unit.digest], "affine_laplace_radial_ext_2d_kernel",
                f"IfLi{k}ELi{tx}ELi{threads}E"))
            for k in ladder)
    print(f"[radial ext kernels] one k={top} pass over four {CYL_N // 2}^2 blocks of the no-flux "
          f"fp32 cylinder on {smi}: affine_laplace_ext_2d radial {ext_ms:.4f} ms "
          f"({ext_ms / top:.5f} a step, {ext_bound[0] / ext_ms:.1%} of the bound "
          f"{ext_bound[0]:.4f} ms, {ext_bound[1]}; plain {ext_plain_ms:.4f} ms); the serial "
          f"radial pass over the {CYL_N}^2 grid "
          f"{serial_ms:.4f} ms; ptxas, z bounded: {regs[False]}; z periodic: {regs[True]}",
          flush=True)

    # -- 35. config 4 on a mesh ---------------------------------------------------------------
    pde.config["parallel.devices_per_device"] = 4  # a 2x2 mesh of blocks on one card
    eq = pde.DiffusionPDE(0.1, bc=CYL_NOFLUX)
    state = pde.ScalarField.random_uniform(grid, dtype=f32, rng=np.random.default_rng(35))
    if state.data.device != device:
        raise AssertionError(f"config 4's state lies on {state.data.device}, not the card")
    ce.affine_laplace_ext_2d.launches = 0
    solver = pde.EulerSolver(eq, backend="cuda", decomposition=[2, 2])
    stepper = solver.make_stepper(state, dt=0.1)
    result, t_reached = stepper(state, 0.0, 3.7)
    torch.cuda.synchronize()
    main_launches = ce.affine_laplace_ext_2d.launches
    serial_stepper = pde.EulerSolver(eq, backend="cuda").make_stepper(state, dt=0.1)
    serial, _ = serial_stepper(state, 0.0, 3.7)
    torch.cuda.synchronize()
    err_main = float((result.data - serial.data).abs().max())
    bound_main = F32_STEP_RTOL * 37 * float(serial.data.abs().max())
    checks = [
        solver.info.get("fused_step") is True, solver.info.get("decomposition") == [2, 2],
        main_launches == _ladder_passes(ladder, 37), abs(t_reached - 3.7) < 1e-9,
        bool(torch.isfinite(result.data).all()), err_main <= bound_main,
    ]
    print(f"[sharded cylindrical main] {CYL_N}^2 no-flux fp32 DiffusionPDE(0.1), dt=0.1, "
          f"EulerSolver(backend='cuda', decomposition=[2, 2]) on four blocks of one card, 37 "
          f"steps: max_abs vs the serial radial window {err_main:.3e} (bit-equal: "
          f"{'yes' if err_main == 0 else 'no'}; bound {bound_main:.1e}); radial ext kernel "
          f"launches {main_launches} {'ok' if all(checks) else 'FAIL'}", flush=True)
    if not all(checks):
        raise AssertionError(f"decomposed config 4 checks failed: {checks}")
    steppers = {"serial": serial_stepper, "decomposed": stepper}
    measured = [(label, _window_rate(torch, steppers[label], state, 0.1))
                for label in ("serial", "decomposed", "decomposed", "serial")]
    launches0, copies0 = ce.affine_laplace_ext_2d.launches, HaloExchange.copies
    stepper(state, 0.0, 204.8)
    torch.cuda.synchronize()
    window_launches = ce.affine_laplace_ext_2d.launches - launches0
    window_copies = HaloExchange.copies - copies0
    print(f"[sharded cylindrical main] {CYL_N}^2 no-flux fp32 on {smi}, cell-updates/s of "
          f"2048-step windows (best of 3 x 3 after a warm-up; ladder {ladder}), in turns: "
          + ", ".join(f"{label} {rate:.4e}" for label, rate in measured)
          + f"; per decomposed window {window_launches} affine_laplace_ext_2d launches and "
          f"{window_copies} halo copies (split and combine once per window)", flush=True)
    if window_launches != _ladder_passes(ladder, 2048):
        raise AssertionError(f"{window_launches} launches a 2048-step window")
    _trace_window(torch, smi, f"cylindrical diffusion {CYL_N}^2 [2, 2]", stepper, state, 204.8,
                  "affine_laplace_radial_ext_2d_kernel")

    # -- 36. the plain sharded stepper on curvilinear grids -------------------------------------
    lines = []
    plain_runs = (
        ("PolarSymGrid", pde.DiffusionPDE(0.1), [4], 0.1, 200),
        ("SphericalSymGrid", pde.DiffusionPDE(0.1), [4], 0.1, 200),
        ("CylindricalSymGrid", pde.PDE({"c": CYL_PROGRAMS["cahn-hilliard"][0]},
                                       **CYL_PROGRAMS["cahn-hilliard"][1]), [2, 2], 1e-3, 10),
    )
    for name, eq_p, decomposition, dt, steps in plain_runs:
        p_grid = _cylinder(pde) if name == "CylindricalSymGrid" else getattr(pde, name)(
            CYL_N, CYL_N)
        low = -0.1 if name == "CylindricalSymGrid" else 0.0
        values = gen.uniform(low, -low if low else 1.0, p_grid.shape)
        for dtype in (f64, f32):
            p_state = pde.ScalarField(p_grid, values, dtype=dtype)
            p_solver = pde.EulerSolver(eq_p, backend="torch", decomposition=decomposition)
            p_stepper = p_solver.make_stepper(p_state, dt=dt)
            got, _ = p_stepper(p_state, 0.0, dt * steps)
            want, _ = pde.EulerSolver(eq_p, backend="numpy").make_stepper(p_state, dt=dt)(
                p_state, 0.0, dt * steps)
            torch.cuda.synchronize()
            p_err = float((got.data - want.data).abs().max())
            ok = ("fused_step" not in p_solver.info and p_solver.info.get("sharded_halo")
                  and p_err == 0 and bool(torch.isfinite(got.data).all()))
            if not ok:
                raise AssertionError(f"{name} on {decomposition} disagrees with the serial "
                                     f"plain run ({str(dtype)[6:]}): {p_err}")
        rates = []  # the serial plain loop (`numpy`: eager, no window) beside the blocks'
        for label, run in (("decomposed", p_stepper), ("serial plain", pde.EulerSolver(
                eq_p, backend="numpy").make_stepper(p_state, dt=dt))):
            run(p_state, 0.0, dt * 2)
            torch.cuda.synchronize()
            start = time.perf_counter()
            run(p_state, 0.0, dt * steps)
            torch.cuda.synchronize()
            rates.append(f"{label} {steps / (time.perf_counter() - start):.1f}")
        lines.append(f"{name} {p_grid.shape} {decomposition} ({eq_p.__class__.__name__}, halo "
                     f"{p_solver.info['sharded_halo']}): fp64 and fp32 bit-equal to the serial "
                     f"plain run; steps/s fp32 " + ", ".join(rates)
                     + f" (no kernel: {p_solver.info.get('fused_unsupported', '')})")
    print(f"[sharded curvilinear plain] the plain sharded stepper (backend='torch') on {smi}: "
          + "; ".join(lines), flush=True)
    pde.config["parallel.devices_per_device"] = 1

    return {
        "name": "affine_laplace_ext_2d (radial mode)",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:5792 (radial)",
        "launches": main_launches,
        "max_abs_err": errs[("[2, 2] no-flux", str(f32), top)],
        "ms": ext_ms,
        "plain_ms": ext_plain_ms,
        "bound_ms": ext_bound[0],
        "bound_by": ext_bound[1],
        "library_ms": None,  # the factors vary by row: no convolution computes it
    }


# the other solvers (phases 37-40): the Poisson solves, implicit steps, scipy and
# ETDRK4, plain torch on the card as in pde_tpu (plain XLA there); kernel #1 checks
# the Poisson residuals as the registry's `laplace`, kernel #7 is ETDRK4's yardstick
# grid sizes of phases 37-40, and the end times of phase 39's runs (a CPU
# rehearsal of the phases shrinks them)
SOLVER_N = {"fft": 4096, "bicgstab": 512, "cylinder": 256, "implicit": 1024, "scipy": 128,
            "etdrk": 1024, "gray-scott": 512}
SOLVER_T_END = {"ch": 100.0, "ch accuracy": 1.0, "ks": 10.0, "ks euler": 0.01}
# BiCGStab's tolerance where a card solve is held against the CPU's: the stop test
# bounds the residual, not the error, so two solves stopped at the default 1e-10
# may differ by about condition number x 1e-10 (2.3e-8 of max|u| at 256², measured
# on the CPU between two reduction orders); at 1e-12 both are within 1e-8 of the
# solution
BICGSTAB_CHECK_TOL = 1e-12
BICGSTAB_RTOL = 1e-8  # card solve against the CPU solve, of max|u|
# fp32 FFT Poisson solve and Helmholtz projection against fp64, of max|u|
F32_SOLVE_RTOL = 1e-5
HELMHOLTZ_DIV_RTOL = 1e-5  # max|div(solenoidal)| of max|div f|, fp32
# ETDRK4 at dt = 1e-2 against the Euler window at dt = 1e-5, CH to t = 1
# (tests/solvers/test_etdrk.py:72-82's fp64 tolerance and the hardware lane's fp32 one)
ETDRK_EULER_ATOL = {"float64": 2e-6, "float32": 1e-4}
# 2D Kuramoto-Sivashinsky at dx = 0.1 (docs/BENCHMARKS.md:431-440): 1024² cells
# on a 102.4² domain; explicit Euler is stable below dt = 2 / max|λ(−∇² − ∇⁴)| =
# 2 / ((8 / dx²)² − 8 / dx²) = 3.13e-6 (the docs' 5e-6 lies in the 1D limit's range)
KS_DX, KS_EULER_DT = 0.1, 3e-6
KURAMOTO_SIVASHINSKY = {"u": "-laplace(u) - laplace(laplace(u)) - gradient_squared(u) / 2"}
GRAY_SCOTT = {"u": "0.2 * laplace(u) - u * v**2 + 0.04 * (1 - u)",
              "v": "0.1 * laplace(v) + u * v**2 - 0.1 * v"}
# the Euler windows (kernel #7) phase 39 runs: label -> (rhs, grid, dt)
SOLVER_WINDOWS = {
    "cahn-hilliard dt=1e-3": (CAHN_HILLIARD, "ch", 1e-3),
    "cahn-hilliard dt=1e-5": (CAHN_HILLIARD, "ch", 1e-5),
    "kuramoto-sivashinsky": (KURAMOTO_SIVASHINSKY, "ks", KS_EULER_DT),
}


def _solver_grids(pde) -> dict:
    n = SOLVER_N["etdrk"]
    return {"ch": pde.UnitGrid([n, n], periodic=True),
            "ks": pde.CartesianGrid([(0, n * KS_DX)] * 2, [n, n], periodic=True)}


def _solver_units(pde, torch) -> list:
    """The programs of phase 39's Euler windows, for the parallel build."""
    grids = _solver_grids(pde)
    return [pde.PDE(rhs).make_fused_euler_window(
        pde.ScalarField(grids[grid], 0.0, dtype=torch.float32), dt).program
        for rhs, grid, dt in SOLVER_WINDOWS.values()]


def _synced_seconds(torch, fn):
    """(result, seconds) of `fn()`, the card synchronized before and after."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def _rel_err(torch, out, ref) -> float:
    """max |out - ref| over max |ref|, both moved to the CPU in fp64."""
    out, ref = out.detach().to("cpu", torch.float64), ref.detach().to("cpu", torch.float64)
    return float((out - ref).abs().max() / ref.abs().max())


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def _trace_line(torch, fn, per: int, unit: str) -> str:
    """One ``torch.profiler``-traced call of `fn` (`per` units of work): wall
    and device time a unit, device kernels a unit, idle share, top kernels."""
    wall_us, times, events = _profiled(torch, fn)
    busy_us = sum(times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:3]
    return (f"wall {wall_us / per:.1f} us a {unit}, device {busy_us / per:.1f} us in "
            f"{events / per:.1f} kernels, idle share {_idle(busy_us, wall_us)}; top: "
            + "; ".join(f"{name[:40]} {us / per:.1f} us" for name, us in top))


def _poisson_phase(pde, torch, np, device, smi) -> None:
    """Phase 37: the FFT solve of a 4096² periodic rhs (fp32, fp64) against the
    CPU's fp64 solve, its residual through the plain `laplace` and through the
    registry's (kernel #1, k = 1); BiCGStab on a 512² Dirichlet grid and a 256²
    cylinder (its residual through #1's radial mode) against the CPU's; the
    Helmholtz projection of a 4096² fp32 vector field."""
    from pde_tpu_torch.ops import cuda_cartesian as cc

    f32, f64 = torch.float32, torch.float64
    gen = np.random.default_rng(37)
    cuda = pde.get_backend("cuda")
    grid = pde.UnitGrid([SOLVER_N["fft"]] * 2, periodic=True)
    f_host = gen.uniform(-1, 1, grid.shape)
    f_host -= f_host.mean()
    cpu_solve = grid.make_operator("poisson_solver", bc="periodic")
    ref = cpu_solve(torch.as_tensor(f_host))  # fp64 on the CPU
    plain_lap = grid.make_operator("laplace", bc="periodic")
    kernel_lap = cuda.make_operator(grid, "laplace", "periodic")
    scale_lap = 4 * sum(float(d) ** -2 for d in grid.discretization)
    for dtype in (f32, f64):
        rhs = torch.as_tensor(f_host, dtype=dtype, device=device)
        solve = grid.make_operator("poisson_solver", bc="periodic")
        u = solve(rhs)
        err = _rel_err(torch, u, ref)
        launches = cc.affine_laplace_2d.launches
        res_plain = float((plain_lap(u) - rhs).abs().max())
        res_kernel = float((kernel_lap(u) - rhs).abs().max())
        _require(cc.affine_laplace_2d.launches > launches, "the registry's laplace did not launch")
        ms = _cuda_ms(torch, lambda: solve(rhs), 5)
        # the residual of an exact discrete solve is rounding: eps x the stencil's
        # weight x max|u|, 64 eps of slack
        res_tol = 64 * torch.finfo(dtype).eps * scale_lap * float(u.abs().max())
        tol = F64_TOL if dtype == f64 else F32_SOLVE_RTOL
        ok = err <= tol and max(res_plain, res_kernel) <= res_tol
        print(f"[poisson] FFT {grid.shape[0]}^2 periodic {str(dtype)[6:]} on {smi}: {ms:.4f} ms a "
              f"solve; against the CPU's fp64 solve {err:.3e} of max|u| (tol {tol:.0e}); "
              f"residual |lap(u) - f| plain {res_plain:.3e}, kernel #1 k=1 {res_kernel:.3e} "
              f"(tol {res_tol:.2e}, max|u| {float(u.abs().max()):.4e}) {'ok' if ok else 'FAIL'}",
              flush=True)
        _require(ok, f"the FFT Poisson solve failed its checks ({dtype})")

    n_b, n_c = SOLVER_N["bicgstab"], SOLVER_N["cylinder"]
    cases = (
        (f"BiCGStab {n_b}^2 Dirichlet 0.5", pde.UnitGrid([n_b, n_b]), {"value": 0.5}),
        (f"BiCGStab cylinder {n_c}^2 (Dirichlet outer side, no-flux z)",
         pde.CylindricalSymGrid(n_c, (0, n_c), (n_c, n_c)),
         {"r-": {"derivative": 0}, "r+": {"value": 1.0}, "z": {"derivative": 0}}),
    )
    for label, b_grid, bc in cases:
        f_b = gen.uniform(-1, 1, b_grid.shape)
        rhs = torch.as_tensor(f_b, device=device)
        solve = b_grid.make_operator("poisson_solver", bc=bc)  # the default tol, 1e-10
        u, seconds = _synced_seconds(torch, lambda: solve(rhs))
        info = dict(solve.info)
        launches = cc.affine_laplace_2d.launches
        residual = float((cuda.make_operator(b_grid, "laplace", bc)(u) - rhs).abs().max())
        _require(cc.affine_laplace_2d.launches > launches, "the registry's laplace did not launch")
        check = b_grid.make_operator("poisson_solver", bc=bc, tol=BICGSTAB_CHECK_TOL)
        u_check, check_seconds = _synced_seconds(torch, lambda: check(rhs))
        check_info = dict(check.info)
        cpu_u = check(torch.as_tensor(f_b))
        err = _rel_err(torch, u_check, cpu_u)
        ok = (err <= BICGSTAB_RTOL and residual <= 1e-5 * float(rhs.abs().max())
              and info["code"] == info["iterations"] and check.info["code"] > 0)
        print(f"[poisson] {label} fp64 on {smi}: tol 1e-10 {info['iterations']} iterations, "
              f"{info['host_reads']} host reads, {seconds * 1e3:.1f} ms, residual through the "
              f"registry's laplace (kernel #1) {residual / float(rhs.abs().max()):.3e} of max|f|; "
              f"tol {BICGSTAB_CHECK_TOL:.0e} {check_info['iterations']} iterations "
              f"({check_seconds * 1e3:.1f} ms) against the CPU's ({check.info['iterations']}) "
              f"{err:.3e} of max|u| (tol {BICGSTAB_RTOL:.0e}) {'ok' if ok else 'FAIL'}",
              flush=True)
        _require(ok, f"{label} failed its checks")
    traced = b_grid.make_operator("poisson_solver", bc=bc, maxiter=64)
    print(f"[poisson trace] BiCGStab {label[9:]}, 64 iterations (torch.profiler) on {smi}: "
          + _trace_line(torch, lambda: traced(rhs), 64, "iteration"), flush=True)

    field = pde.VectorField(grid, gen.normal(size=(2, *grid.shape)), dtype=f32)
    (potential, solenoidal), seconds = _synced_seconds(
        torch, lambda: pde.helmholtz_decomposition(field, "periodic"))
    div_f = float(field.divergence("periodic").data.abs().max())
    div_s = float(solenoidal.divergence("periodic").data.abs().max())
    div_kernel = float(cuda.make_operator(grid, "divergence", "periodic")(
        solenoidal.data).abs().max())
    recon = float((potential.gradient("periodic").data + solenoidal.data - field.data).abs().max())
    ok = (max(div_s, div_kernel) <= HELMHOLTZ_DIV_RTOL * div_f and solenoidal.data.dtype == f32
          and recon <= F32_SOLVE_RTOL * float(field.data.abs().max()))
    print(f"[poisson] helmholtz_decomposition {grid.shape[0]}^2 periodic fp32 on {smi}: "
          f"{seconds * 1e3:.1f} ms; max|div solenoidal| plain {div_s:.3e}, kernel #2 "
          f"{div_kernel:.3e} of max|div f| {div_f:.3e} (tol {HELMHOLTZ_DIV_RTOL:.0e}); "
          f"|grad phi + solenoidal - f| {recon:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    _require(ok, "the Helmholtz decomposition failed its checks")


def _implicit_phase(pde, torch, np, device, smi) -> None:
    """Phase 38: implicit Euler and Crank-Nicolson on 1024² periodic fp64
    diffusion (20 steps at dt = 1) against the CPU, on [2, 2] bit-equal to
    serial, their steps/s; ConvergenceError on the card; scipy on 128²."""
    f64 = torch.float64
    gen = np.random.default_rng(38)
    grid = pde.UnitGrid([SOLVER_N["implicit"]] * 2, periodic=True)
    data = gen.random(grid.shape)
    eq = pde.DiffusionPDE(0.1)
    for name in ("implicit", "crank-nicolson"):
        state = pde.ScalarField(grid, data, dtype=f64, device=device)
        solver = pde.solvers.SolverBase.from_name(name, eq)
        stepper = solver.make_stepper(state, dt=1.0)
        stepper(state, 0.0, 2.0)  # warm up
        iterations = solver.info["fixed_point_iterations"]
        (got, _), seconds = _synced_seconds(torch, lambda: stepper(state, 0.0, 20.0))
        iterations = solver.info["fixed_point_iterations"] - iterations
        cpu_state = pde.ScalarField(grid, data, dtype=f64, device="cpu")
        want = eq.solve(cpu_state, t_range=20.0, dt=1.0, solver=name, tracker=None)
        err = _rel_err(torch, got.data, want.data)
        pde.config["parallel.devices_per_device"] = 4  # a 2x2 mesh of blocks on one card
        try:
            blocked = pde.solvers.SolverBase.from_name(name, eq, decomposition=[2, 2])
            b_stepper = blocked.make_stepper(state, dt=1.0)
            (b_got, _), b_seconds = _synced_seconds(torch, lambda: b_stepper(state, 0.0, 20.0))
        finally:
            pde.config["parallel.devices_per_device"] = 1
        equal = bool(torch.equal(b_got.data, got.data))
        ok = err <= F64_TOL and equal and got.data.device.type == "cuda"
        print(f"[implicit] {name} DiffusionPDE(0.1) {grid.shape[0]}^2 periodic fp64, 20 steps at dt = 1 on "
              f"{smi}: {20 / seconds:.1f} steps/s, {iterations / 20:.1f} fixed-point iterations "
              f"a step; against the CPU {err:.3e} of max|u| (tol {F64_TOL:.0e}); [2, 2] (halo "
              f"{blocked.info['sharded_halo']}) bit-equal to serial: {equal}, "
              f"{20 / b_seconds:.1f} steps/s {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"{name} failed its checks")

    class StiffPDE(pde.PDEBase):
        """test_solver_matrix.py:95-107's diverging cubic, on a 2D grid."""

        def evolution_rate(self, state, t=0):
            return -1e6 * state**3

    stiff = pde.ScalarField(pde.UnitGrid([64, 64]), 2.0, dtype=f64, device=device)
    try:
        StiffPDE().solve(stiff, t_range=1.0, dt=1.0, solver="implicit", tracker=None)
    except pde.ConvergenceError as err:
        print(f"[implicit] the stiff cubic on the card raised ConvergenceError: {err}", flush=True)
    else:
        raise AssertionError("the stiff cubic did not raise ConvergenceError on the card")

    s_grid = pde.UnitGrid([SOLVER_N["scipy"]] * 2, periodic=True)
    s_data = gen.random(s_grid.shape)
    runs = []
    for where in (device, "cpu"):
        state = pde.ScalarField(s_grid, s_data, dtype=f64, device=where)
        for _ in range(2):  # the first run imports scipy.integrate
            (result, info), seconds = _synced_seconds(torch, lambda: pde.DiffusionPDE(0.1).solve(
                state, t_range=1.0, solver="scipy", tracker=None, ret_info=True))
        runs.append((result, info["solver"]["steps"], seconds))
    (card, nfev, seconds), (cpu, cpu_nfev, _) = runs
    diff = (card.data.cpu() - cpu.data).abs()
    ok = bool((diff <= 1e-6 + 1e-3 * cpu.data.abs()).all()) and card.data.device.type == "cuda"
    print(f"[implicit] scipy (solve_ivp RK45 on the host, the rhs on the card) DiffusionPDE(0.1) "
          f"{s_grid.shape[0]}^2 to t = 1 on {smi}: {nfev} rhs calls ({cpu_nfev} on the CPU), "
          f"{seconds * 1e3:.1f} ms; against the CPU max {float(diff.max()):.3e} (solve_ivp's "
          f"rtol 1e-3, atol 1e-6) {'ok' if ok else 'FAIL'}", flush=True)
    _require(ok, "the scipy solver failed its checks")


def _time_to_solution(torch, solver, state, dt, t_end):
    """(result, set-up seconds, run seconds) of `solver` from `state` to
    `t_end`: `make_stepper`, then one window, each synchronized."""
    stepper, setup = _synced_seconds(torch, lambda: solver.make_stepper(state, dt=dt))
    (result, _), run = _synced_seconds(torch, lambda: stepper(state, 0.0, t_end))
    if not bool(torch.isfinite(result.data).all()):
        raise AssertionError(f"{solver.name} ended non-finite")
    return result, setup, run


def _etdrk_phase(pde, torch, np, device, smi) -> None:
    """Phases 39-40: ETDRK4 on pde_tpu's stiff configurations
    (docs/BENCHMARKS.md:425-445) beside the Euler window (kernel #7): CH 1024²
    to t = 100 and its accuracy gate, 2D KS 1024² at dx = 0.1; no-flux KS
    (DCT axes) one step against the CPU; Gray-Scott 512² against the CPU; CH
    1024² on [2, 2] bit-equal to serial."""
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    f32, f64 = torch.float32, torch.float64
    _require(not torch.backends.cuda.matmul.allow_tf32,
             "TF32 is on: an fp32 DCT axis would lose about three digits")
    gen = np.random.default_rng(39)
    grids = _solver_grids(pde)
    n = SOLVER_N["etdrk"]
    ch_data = gen.uniform(-0.1, 0.1, grids["ch"].shape)
    eq = pde.PDE(CAHN_HILLIARD)

    def ch_state(dtype):
        return pde.ScalarField(grids["ch"], ch_data, dtype=dtype, device=device)

    t_end = SOLVER_T_END["ch"]
    launches = cs.multi_stencil_2d.launches
    times = {"etdrk4": [], "euler": []}
    for _ in range(2):  # in turns
        for name, dt in (("etdrk4", 0.05), ("euler", 1e-3)):
            solver = (pde.ETDRK4Solver(eq) if name == "etdrk4"
                      else pde.EulerSolver(eq, backend="cuda"))
            _, setup, run = _time_to_solution(torch, solver, ch_state(f32), dt, t_end)
            times[name].append((setup, run, dict(solver.info)))
    _require(cs.multi_stencil_2d.launches > launches, "the Euler window did not launch")
    e_run = min(run for _, run, _ in times["etdrk4"])
    x_run = min(run for _, run, _ in times["euler"])
    e_steps, x_steps = round(t_end / 0.05), round(t_end / 1e-3)
    # a first set-up also compiles torch's complex kernels (NVRTC), hence both
    print(f"[etdrk4] Cahn-Hilliard {n}^2 periodic fp32 to t = {t_end:g} on {smi}: ETDRK4 "
          f"dt = 0.05 ({e_steps} steps) {e_run:.3f} s ({e_run / e_steps * 1e3:.4f} ms a step; "
          "runs " + ", ".join(f"{r:.3f}" for _, r, _ in times["etdrk4"])
          + " s), set-ups " + ", ".join(
              f"{setup:.3f} s (split {info['etdrk_split_seconds']:.3f}, coefficients "
              f"{info['etdrk_coefficient_seconds']:.4f})" for setup, _, info in times["etdrk4"])
          + f"; Euler window (#7) dt = 1e-3 ({x_steps} steps) {x_run:.3f} s (runs "
          + ", ".join(f"{r:.3f}" for _, r, _ in times["euler"])
          + "), set-ups " + ", ".join(f"{setup:.3f}" for setup, _, _ in times["euler"])
          + f" s; ETDRK4 / Euler {e_run / x_run:.2f}", flush=True)
    state = ch_state(f32)
    stepper = pde.ETDRK4Solver(eq).make_stepper(state, dt=0.05)
    stepper(state, 0.0, 1.0)
    print(f"[etdrk4 trace] Cahn-Hilliard {n}^2 fp32, 20 ETDRK4 steps (torch.profiler) on "
          f"{smi}: " + _trace_line(torch, lambda: stepper(state, 0.0, 1.0), 20, "step"),
          flush=True)

    t_gate = SOLVER_T_END["ch accuracy"]
    for dtype in (f64, f32):
        got, _, run = _time_to_solution(torch, pde.ETDRK4Solver(eq), ch_state(dtype), 1e-2,
                                        t_gate)
        ref, _, ref_run = _time_to_solution(torch, pde.EulerSolver(eq, backend="cuda"),
                                            ch_state(dtype), 1e-5, t_gate)
        err = float((got.data - ref.data).abs().max())
        tol = ETDRK_EULER_ATOL[str(dtype)[6:]]
        print(f"[etdrk4] accuracy, Cahn-Hilliard {n}^2 {str(dtype)[6:]} to t = {t_gate:g} on "
              f"{smi}: ETDRK4 dt = 1e-2 ({run:.3f} s) against the Euler window dt = 1e-5 "
              f"({ref_run:.3f} s) max abs {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if err <= tol else 'FAIL'}", flush=True)
        _require(err <= tol, f"ETDRK4 strays from the fine Euler window ({dtype})")

    # four periods of the domain a side (wave number 0.245 at 1024², in KS's growing band)
    x, y = np.meshgrid(*grids["ks"].axes_coords, indexing="ij")
    q = 2 * np.pi * 4 / (n * KS_DX)
    ks_data = np.cos(q * x) * (1 + np.sin(q * y))
    ks = pde.PDE(KURAMOTO_SIVASHINSKY)  # the Euler window's
    ks_model = pde.KuramotoSivashinskyPDE()  # ETDRK4 through its make_etdrk_parts
    ks_state = pde.ScalarField(grids["ks"], ks_data, dtype=f32, device=device)
    t_ks, t_euler = SOLVER_T_END["ks"], SOLVER_T_END["ks euler"]
    _, setup, run = _time_to_solution(torch, pde.ETDRK4Solver(ks_model), ks_state, 0.05, t_ks)
    short, _, _ = _time_to_solution(torch, pde.ETDRK4Solver(ks_model), ks_state, t_euler / 10,
                                    t_euler)
    euler, x_setup, x_run = _time_to_solution(torch, pde.EulerSolver(ks, backend="cuda"),
                                              ks_state, KS_EULER_DT, t_euler)
    extrapolated = x_run * t_ks / t_euler
    print(f"[etdrk4] Kuramoto-Sivashinsky {n}^2 at dx = {KS_DX} periodic fp32 to t = {t_ks:g} "
          f"on {smi}: ETDRK4 dt = 0.05 ({round(t_ks / 0.05)} steps) {run:.3f} s + set-up "
          f"{setup:.3f} s; Euler window (#7) dt = {KS_EULER_DT:g} over t = {t_euler:g} "
          f"({round(t_euler / KS_EULER_DT)} steps) {x_run:.3f} s + set-up {x_setup:.3f} s, "
          f"extrapolated to t = {t_ks:g}: {extrapolated:.1f} s; ETDRK4 "
          f"{extrapolated / (run + setup):.1f}x faster; at t = {t_euler:g} ETDRK4 (10 steps) "
          f"and Euler differ by {float((short.data - euler.data).abs().max()):.3e} "
          f"(max|u| {float(euler.data.abs().max()):.3f})", flush=True)

    nf_grid = pde.CartesianGrid([(0, n * KS_DX)] * 2, [n, n])
    nf = pde.KuramotoSivashinskyPDE(bc={"derivative": 0})
    step_ms = {}
    for dtype in (f32, f64):
        state = pde.ScalarField(nf_grid, ks_data, dtype=dtype, device=device)
        solver = pde.ETDRK4Solver(nf)
        stepper = solver.make_stepper(state, dt=0.05)
        step_ms[dtype] = _cuda_ms(torch, lambda: stepper(state, 0.0, 0.05), 5)
    got, _ = stepper(state, 0.0, 0.05)
    cpu_state = pde.ScalarField(nf_grid, ks_data, dtype=f64, device="cpu")
    want, _ = pde.ETDRK4Solver(nf).make_stepper(cpu_state, dt=0.05)(cpu_state, 0.0, 0.05)
    err = _rel_err(torch, got.data, want.data)
    print(f"[etdrk4] no-flux Kuramoto-Sivashinsky {n}^2 (DCT-II axes, torch.matmul, TF32 off) "
          f"on {smi}: one step {step_ms[f32]:.3f} ms fp32, {step_ms[f64]:.3f} ms fp64; "
          f"axes {solver.info['etdrk_axis_kinds']}; fp64 against the CPU's step {err:.3e} of "
          f"max|u| (tol {F64_TOL:.0e}) {'ok' if err <= F64_TOL else 'FAIL'}", flush=True)
    _require(err <= F64_TOL, "the no-flux ETDRK4 step disagrees with the CPU's")

    n_gs = SOLVER_N["gray-scott"]
    gs_grid = pde.UnitGrid([n_gs, n_gs], periodic=True)
    v0 = np.zeros(gs_grid.shape)
    v0[3 * n_gs // 8:5 * n_gs // 8, 3 * n_gs // 8:5 * n_gs // 8] = 0.5
    v0 += 0.01 * gen.random(gs_grid.shape)
    runs = []
    for where in (device, "cpu"):
        state = pde.FieldCollection([
            pde.ScalarField(gs_grid, 1.0, dtype=f64, device=where, label="u"),
            pde.ScalarField(gs_grid, v0, dtype=f64, device=where, label="v")])
        runs.append(_time_to_solution(torch, pde.ETDRK4Solver(pde.PDE(GRAY_SCOTT)), state, 1.0,
                                      20.0))
    (card, setup, run), (cpu, _, _) = runs
    err = max(_rel_err(torch, a.data, b.data) for a, b in zip(card, cpu, strict=True))
    print(f"[etdrk4] Gray-Scott (two fields, per-mode 2x2 matrices) {n_gs}^2 periodic fp64, "
          f"dt = 1 to t = 20 on {smi}: {20 / run:.1f} steps/s, set-up {setup:.3f} s; against "
          f"the CPU {err:.3e} of max|u| (tol {F64_TOL:.0e}) {'ok' if err <= F64_TOL else 'FAIL'}",
          flush=True)
    _require(err <= F64_TOL, "the coupled ETDRK4 run disagrees with the CPU's")

    # phase 40: CH on a 2x2 mesh of blocks on one card, beside serial in turns
    pde.config["parallel.devices_per_device"] = 4
    try:
        state = ch_state(f32)
        steppers, results, rates = {}, {}, {"serial": [], "[2, 2]": []}
        for label, decomposition in (("serial", None), ("[2, 2]", [2, 2])):
            solver = pde.ETDRK4Solver(eq, decomposition=decomposition)
            steppers[label] = solver.make_stepper(state, dt=0.05)
        halo = solver.info["sharded_halo"]
        for _ in range(2):
            for label, stepper in steppers.items():
                (result, _), seconds = _synced_seconds(torch, lambda: stepper(state, 0.0, 10.0))
                results.setdefault(label, result)
                rates[label].append(200 / seconds)
    finally:
        pde.config["parallel.devices_per_device"] = 1
    equal = bool(torch.equal(results["serial"].data, results["[2, 2]"].data))
    print(f"[etdrk4 sharded] Cahn-Hilliard {n}^2 periodic fp32, 200 steps at dt = 0.05, on "
          f"{smi}: [2, 2] (the remainder over four blocks, halo {halo}; the transforms on the "
          f"global leaves) bit-equal to serial: {equal}; steps/s in turns "
          + ", ".join(f"{k} " + " / ".join(f"{v:.1f}" for v in vs) for k, vs in rates.items())
          + f" {'ok' if equal else 'FAIL'}", flush=True)
    _require(equal, "the decomposed ETDRK4 run is not bit-equal to serial")
# -- phases 41-43: the side inputs of kernels #1 (B1(c)) and #7 (B2(b)) ------------------------
# grid sizes of phases 41-43 (a CPU rehearsal shrinks them), the start of their
# windows (t != 0) and their window's steps
SIDES_N = 4096
CONFIG3_N = 1024
SIDES_T0 = 0.35
SIDES_WINDOW = 2048
SIDES_RHS = "laplace(c**3 - c - laplace(c))"  # Cahn-Hilliard, as phase 7's
T_SIDES_BC = {"x": {"derivative": 0}, "y-": {"value_expression": "sin(3*t)"},
              "y+": {"derivative_expression": "0.5*cos(t)"}}
CONFIG3_T_BC = {"x": "periodic", "y-": {"value_expression": "0.1*sin(2*t)"},
                "y+": {"derivative": 0}}


def _affine_sides_bc(np, n: int) -> dict:
    """Kernel #1's side inputs at n² (``pde_tpu``'s hardware configuration,
    ``docs/BENCHMARKS.md:78-80``): a per-point Dirichlet array on x-, a
    time-dependent value on y-, no-flux elsewhere."""
    return {"x-": {"value": np.sin(np.linspace(0.0, 2.0 * np.pi, n))}, "x+": {"derivative": 0},
            "y-": {"value_expression": "sin(3*t)"}, "y+": {"derivative": 0}}


def _multi_sides_cases(np) -> dict:
    """Kernel #7's side-input cases: label -> (conditions, scheme), on the
    Cahn-Hilliard rhs (``tests/ops/test_pallas_kernels.py:392, :871,
    :1231-1232``)."""
    return {
        "t sides": (T_SIDES_BC, "euler"),
        "xt side": ({"x": {"derivative": 0}, "y-": {"value_expression": "sin(x - 2*t)"},
                     "y+": {"value": 0}}, "euler"),
        "robin gamma along the side": ({"x-": {"mixed": "1 + 0.5*sin(y)", "const": 0.2},
                                        "x+": {"derivative": 0}, "y": {"derivative": 0}},
                                       "euler"),
        "t sides rk4": (T_SIDES_BC, "rk4"),
    }


def _side_input_units(pde, torch, device) -> dict:
    """The windows and build units of phases 41-43: kernel #1's side-input
    library (both axes bounded) and #7's programs with side inputs."""
    import numpy as np

    from pde_tpu_torch.ops import cuda_cartesian as cc

    n = SIDES_N
    grid = pde.UnitGrid([n, n])
    state = pde.ScalarField.random_uniform(grid, 0.4, 0.6, dtype=torch.float32, device=device,
                                           rng=np.random.default_rng(41))
    windows = {}
    for label, (bc, scheme) in _multi_sides_cases(np).items():
        eq = pde.PDE({"c": SIDES_RHS}, bc=bc)
        hook = "make_fused_euler_window" if scheme == "euler" else "make_fused_rk4_window"
        windows[label] = getattr(eq, hook)(state, 1e-3)
    grid3 = pde.UnitGrid([CONFIG3_N, CONFIG3_N], periodic=[True, False])
    state3 = pde.ScalarField.random_uniform(grid3, -0.1, 0.1, dtype=torch.float32, device=device,
                                            rng=np.random.default_rng(43))
    windows["config 3 rk4"] = pde.SwiftHohenbergPDE(rate=0.1, bc=CONFIG3_T_BC) \
        .make_fused_rk4_window(state3, 1e-2)
    units = [cc.kernel_source((False, False), cc.SIDES_LIBRARY)]
    units += list({id(w.program): w.program for w in windows.values()}.values())
    return {"windows": windows, "units": units, "state": state, "state3": state3}


def _check_rel(torch, label, out, ref, dtype, steps) -> float:
    """max_abs of `out` against `ref` (raises past the tolerance: fp64 1e-12
    of max|ref|, fp32 1e-6 a step, or 2e-5 past 1000 steps)."""
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    if dtype == torch.float64:
        tol = F64_TOL * scale
    elif steps >= 1000:
        tol = F32_LONG_TOL * (1.0 + scale)
    else:
        tol = F32_STEP_RTOL * steps * scale
    if not (bool(torch.isfinite(out).all()) and err <= tol):
        raise AssertionError(f"{label}: max_abs {err:.3e} past {tol:.1e}")
    return err


def _rate_from(torch, stepper, state, dt, t0, cells, steps=SIDES_WINDOW, repeats=3):
    """Best cell-updates/s of `repeats` windows of `steps` steps from t0."""
    out, t = stepper(state, t0, t0 + steps * dt)  # warm-up
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(repeats):
        start = time.perf_counter()
        out, t = stepper(out, t, t + steps * dt)
        torch.cuda.synchronize()
        best = max(best, cells * steps / (time.perf_counter() - start))
    return best


def _side_inputs(pde, torch, np, device, smi, units, logs, main_k_ms) -> list[dict]:
    """Phases 41-43 (see the module docstring) on the windows and states of
    :func:`_side_input_units` (`units`; `logs`: ptxas' report of each build
    unit, by digest); returns the kernels line's rows of #1's and #7's
    side-input modes."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    f32, f64 = torch.float32, torch.float64
    n = SIDES_N
    cells = n * n
    grid = pde.UnitGrid([n, n])
    bc1 = _affine_sides_bc(np, n)
    bcs1 = grid.get_boundary_conditions(bc1)
    inputs = cc.AffineSideInputs(grid, bcs1)
    dt1 = 0.1
    ladder = [spec.k for spec in cc.make_fused_euler_window_2d(
        grid, diffusivity=0.1, dt=dt1, dtype=f32, bcs=bcs1).specs]
    gen = np.random.default_rng(41)

    # -- 41. kernel #1 ------------------------------------------------------------------------
    errs1, lines = {}, []
    for dtype in (f32, f64):
        data = torch.as_tensor(gen.random((n, n)), dtype=dtype, device=device)
        for k in ladder:
            spec = cc.affine_laplace_spec(grid, a=1.0, b=dt1 * 0.1, k=k, dtype=dtype, bcs=bcs1)
            times = [SIDES_T0 + s * dt1 for s in range(k)]
            sides = inputs.for_pass(dtype, device, times)
            out = cc.affine_laplace_2d(data, spec, sides=sides)
            ref = cc.affine_laplace_2d_plain(data, spec, sides)
            errs1[(dtype, k)] = _check_rel(torch, f"#1 sides k={k} {dtype}", out, ref, dtype, k)
            lines.append(f"{str(dtype)[6:]} k={k} {errs1[(dtype, k)]:.2e}")
    print(f"[sides #1] affine_laplace_2d {n}^2, per-point Dirichlet array on x-, "
          f"sin(3*t) on y-, no-flux elsewhere, t-table from t0={SIDES_T0}, one pass against "
          "its plain version, max_abs: " + "; ".join(lines) + " ok", flush=True)
    top = ladder[0]
    data = torch.as_tensor(gen.random((n, n)), dtype=f32, device=device)
    out = torch.empty_like(data)
    spec_top = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=top, dtype=f32, bcs=bcs1)
    sides_top = inputs.for_pass(f32, device, [SIDES_T0 + s * dt1 for s in range(top)])
    sides_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d(data, spec_top, out=out,
                                                            sides=sides_top), 20)
    scalar_spec = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=top, dtype=f32,
                                         bcs=grid.get_boundary_conditions({"derivative": 0}))
    scalar_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d(data, scalar_spec, out=out), 20)
    plain1_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d_plain(data, spec_top, sides_top), 3)
    bound1 = _bound(2 * cells * 4 + 2 * n * 4, _affine_flops((1.0, 1.0)) * top * cells)
    # the window from t0 through solve on the card against the plain loop's
    eq1 = pde.DiffusionPDE(0.1, bc=bc1)
    state1 = pde.ScalarField.random_uniform(grid, dtype=f32, device=device,
                                            rng=np.random.default_rng(42))
    cc.affine_laplace_2d.launches = 0
    t_range = [SIDES_T0, SIDES_T0 + SIDES_WINDOW * dt1]
    res1, info1 = eq1.solve(state1, t_range=t_range, dt=dt1, tracker=None, backend="cuda",
                            ret_info=True)
    torch.cuda.synchronize()
    launches1 = cc.affine_laplace_2d.launches
    if launches1 <= 0 or not info1["solver"].get("fused_step"):
        raise AssertionError("kernel #1's side-input window launched no kernel")
    start = time.perf_counter()
    ref1 = eq1.solve(state1, t_range=t_range, dt=dt1, tracker=None, backend="numpy")
    torch.cuda.synchronize()
    plain_loop_s = time.perf_counter() - start
    win_err1 = _check_rel(torch, "#1 sides 2048-step window", res1.data, ref1.data, f32,
                          SIDES_WINDOW)
    stepper = pde.EulerSolver(eq1, backend="cuda").make_stepper(state1, dt=dt1)
    rate1 = _rate_from(torch, stepper, state1, dt1, SIDES_T0, cells)
    scalar_eq = pde.DiffusionPDE(0.1, bc={"derivative": 0})
    rate1_scalar = _rate_from(torch, pde.EulerSolver(scalar_eq, backend="cuda").make_stepper(
        state1, dt=dt1), state1, dt1, 0.0, cells)
    ptx1 = []
    for dtype, tag in ((f32, "If"), (f64, "Id")):
        for k in ladder:
            itemsize = cc._DTYPES[dtype][2]
            tx, threads = cc.affine_row_plan(k, itemsize)[:2]
            ptx1 += [f"{str(dtype)[6:]} k={k}: " + " | ".join(_ptxas_of(
                logs[units["units"][0].digest], "affine_laplace_sides_2d_kernel",
                f"{tag}Li{k}ELi{tx}ELi{threads}E"))]
    print(f"[sides #1] on {smi}: one k={top} pass {sides_ms:.4f} ms with the side inputs, "
          f"{scalar_ms:.4f} ms with scalar no-flux sides, plain {plain1_ms:.4f} ms, bound "
          f"{bound1[0]:.4f} ms ({bound1[1]}); the main path's periodic k={cc.TOP_STEPS} pass "
          f"{main_k_ms:.4f} ms (phase 5); a {SIDES_WINDOW}-step window from t={SIDES_T0} "
          f"through solve(backend='cuda'): {launches1} launches (ladder {ladder}), max_abs "
          f"{win_err1:.3e} against the plain loop's solve ({plain_loop_s:.2f} s) ok; windows "
          f"{rate1:.4e} cell-updates/s against {rate1_scalar:.4e} with scalar no-flux sides; "
          "ptxas: " + "; ".join(ptx1), flush=True)

    # -- 42. kernel #7 ------------------------------------------------------------------------
    cases = _multi_sides_cases(np)
    wins = units["windows"]
    errs7, ms7, lines = {}, {}, []
    for label, (bc, scheme) in cases.items():
        window = wins[label]
        program = window.program
        for dtype in (f32, f64):
            datas = [torch.as_tensor(gen.uniform(0.4, 0.6, (n, n)), dtype=dtype, device=device)]
            for kk in program.ladder:
                spec = cs.multi_stencil_spec(program, kk, dtype)
                block = program.sides.block(SIDES_T0, 0, kk, 1e-3, dtype, device)
                views = program.sides.for_pass(dtype, device, kk, block, 0)
                out = cs.multi_stencil_2d(datas, spec, sides=views)
                ref = cs.multi_stencil_2d_plain(datas, spec, views)
                err = _check_rel(torch, f"#7 {label} k={kk} {dtype}", out[0], ref[0], dtype, kk)
                errs7[(label, dtype, kk)] = err
                lines.append(f"{label} {str(dtype)[6:]} k={kk} {err:.2e}")
        spec = cs.multi_stencil_spec(program, program.ladder[0], f32)
        datas = [torch.as_tensor(gen.uniform(0.4, 0.6, (n, n)), dtype=f32, device=device)]
        block = program.sides.block(SIDES_T0, 0, spec.k, 1e-3, f32, device)
        views = program.sides.for_pass(f32, device, spec.k, block, 0)
        outs = [torch.empty_like(datas[0])]
        k_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d(datas, spec, outs=outs, sides=views),
                        20)
        p_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d_plain(datas, spec, views), 3)
        ms7[label] = (k_ms, p_ms, spec.k, _bound(2 * cells * 4, _program_flops(program)
                                                 * spec.k * cells))
    print(f"[sides #7] multi_stencil_2d Cahn-Hilliard {n}^2 with side inputs, tables from "
          f"t0={SIDES_T0}, one pass against its plain version, max_abs: " + "; ".join(lines)
          + " ok", flush=True)
    scalar_ch = pde.PDE({"c": SIDES_RHS}, bc={"derivative": 0})
    state7 = units["state"]
    scalar_window = scalar_ch.make_fused_euler_window(state7, 1e-3)
    scalar_spec = scalar_window.specs[0]
    sdatas = [state7.data]
    souts = [torch.empty_like(state7.data)]
    scalar7_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d(sdatas, scalar_spec, outs=souts), 20)
    eq7 = pde.PDE({"c": SIDES_RHS}, bc=T_SIDES_BC)
    t_range = [SIDES_T0, SIDES_T0 + 64 * 1e-3]
    cs.multi_stencil_2d.launches = 0
    res7, info7 = eq7.solve(state7, t_range=t_range, dt=1e-3, tracker=None, backend="cuda",
                            ret_info=True)
    torch.cuda.synchronize()
    launches7 = cs.multi_stencil_2d.launches
    if launches7 <= 0 or not info7["solver"].get("fused_step"):
        raise AssertionError("kernel #7's side-input window launched no kernel")
    ref7 = eq7.solve(state7, t_range=t_range, dt=1e-3, tracker=None, backend="numpy")
    win_err7 = _check_rel(torch, "#7 t sides 64 steps", res7.data, ref7.data, f32, 64)
    rk4 = pde.PDE({"c": SIDES_RHS}, bc=T_SIDES_BC)
    res_rk, info_rk = rk4.solve(state7, t_range=[SIDES_T0, SIDES_T0 + 8e-3], dt=1e-3,
                                tracker=None, backend="cuda", solver="runge-kutta", ret_info=True)
    ref_rk = rk4.solve(state7, t_range=[SIDES_T0, SIDES_T0 + 8e-3], dt=1e-3, tracker=None,
                       backend="numpy", solver="runge-kutta")
    rk_err = _check_rel(torch, "#7 RK4 t sides 8 steps", res_rk.data, ref_rk.data, f32, 32)
    stepper7 = pde.EulerSolver(eq7, backend="cuda").make_stepper(state7, dt=1e-3)
    rate7 = _rate_from(torch, stepper7, state7, 1e-3, SIDES_T0, cells)
    rate7_scalar = _rate_from(torch, pde.EulerSolver(scalar_ch, backend="cuda").make_stepper(
        state7, dt=1e-3), state7, 1e-3, 0.0, cells)
    passes7 = _ladder_passes(wins["t sides"].program.ladder, SIDES_WINDOW)
    ptx7 = []
    for label in cases:
        program = wins[label].program
        log = logs[program.digest]
        ptx7.append(f"{label}: " + " | ".join(_ptxas_of(log, "multi_stencil_sides_2d_kernel")))
    print(f"[sides #7] on {smi}: one top-k pass, kernel / plain / bound ms: " + "; ".join(
        f"{label} k={kk} {k_ms:.4f} / {p_ms:.4f} / {b[0]:.4f} ({b[1]})"
        for label, (k_ms, p_ms, kk, b) in ms7.items())
        + f"; the scalar no-flux Cahn-Hilliard pass k={scalar_spec.k} {scalar7_ms:.4f} ms; "
        f"64 Euler steps from t={SIDES_T0} through solve(backend='cuda'): {launches7} launches, "
        f"max_abs {win_err7:.3e} against the plain loop ok; RK4 8 steps max_abs {rk_err:.3e} "
        f"ok ({info_rk['solver'].get('fused_step')}); {SIDES_WINDOW}-step windows "
        f"{rate7:.4e} cell-updates/s ({passes7} passes a window) against {rate7_scalar:.4e} "
        "with scalar no-flux sides; ptxas: " + "; ".join(ptx7), flush=True)

    # -- 43. config 3 with a time-dependent side ----------------------------------------------
    state3 = units["state3"]
    eq3 = pde.SwiftHohenbergPDE(rate=0.1, bc=CONFIG3_T_BC)
    cells3 = CONFIG3_N * CONFIG3_N
    t3 = [SIDES_T0, SIDES_T0 + 0.5]
    cs.multi_stencil_2d.launches = 0
    start = time.perf_counter()
    fused3, info3 = eq3.solve(state3, t_range=t3, dt=1e-2, tracker=None, solver="runge-kutta",
                              backend="cuda", ret_info=True)
    torch.cuda.synchronize()
    fused3_s = time.perf_counter() - start
    launches3 = cs.multi_stencil_2d.launches
    start = time.perf_counter()
    plain3 = eq3.solve(state3, t_range=t3, dt=1e-2, tracker=None, solver="runge-kutta",
                       backend="numpy")
    torch.cuda.synchronize()
    plain3_s = time.perf_counter() - start
    err3 = _check_rel(torch, "config 3 RK4 50 steps", fused3.data, plain3.data, f32, 200)
    start = time.perf_counter()
    adaptive3, info_a = eq3.solve(state3, t_range=t3, solver="runge-kutta", adaptive=True,
                                  tolerance=1e-6, tracker=None, backend="torch", ret_info=True)
    torch.cuda.synchronize()
    adaptive3_s = time.perf_counter() - start
    gap = float((adaptive3.data - fused3.data).abs().max())
    if launches3 <= 0 or not bool(torch.isfinite(adaptive3.data).all()) or gap > 1e-3:
        raise AssertionError(f"config 3 with a time-dependent side: launches {launches3}, "
                             f"adaptive against fixed-dt {gap:.3e}")
    steps3 = round(0.5 / 1e-2)
    print(f"[config 3 sides] SwiftHohenbergPDE(rate=0.1) {CONFIG3_N}^2 fp32, y- "
          f"0.1*sin(2*t), from t={SIDES_T0} to {t3[1]} on {smi}: fixed-dt RK4 (dt 0.01) "
          f"through #7 {fused3_s:.3f} s ({launches3} launches, "
          f"{cells3 * steps3 / fused3_s:.4e} cell-updates/s), the plain loop {plain3_s:.3f} s, "
          f"max_abs {err3:.3e} ok; adaptive RKF45 (plain torch, tolerance 1e-6) "
          f"{adaptive3_s:.3f} s, {info_a['solver'].get('steps')} steps, max_abs against the "
          f"fixed-dt run {gap:.3e} ok", flush=True)

    k1 = ms7["t sides"]
    return [{
        "name": "affine_laplace_2d (side inputs)",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:793 (side inputs: :807-817)",
        "launches": launches1,
        "max_abs_err": errs1[(f32, top)],
        "ms": sides_ms,
        "plain_ms": plain1_ms,
        "bound_ms": bound1[0],
        "bound_by": bound1[1],
        "library_ms": None,  # per-point and time-dependent ghosts are no convolution's
    }, {
        "name": "multi_stencil_2d (side inputs)",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:3755 (side inputs: :616, :3755-4077)",
        "launches": launches7,
        "max_abs_err": errs7[("t sides", f32, k1[2])],
        "ms": k1[0],
        "plain_ms": k1[1],
        "bound_ms": k1[3][0],
        "bound_by": k1[3][1],
        "library_ms": None,  # the rhs is nonlinear
    }]



TRACKERS_N = 4096
TRACKERS_DT = 0.1
TRACKERS_T_END = 204.8  # 2048 steps
TRACKERS_F64_N = 512
STEADY_N = 32  # phase 44's steady-state stop: no-flux diffusion, D = 1, dt = 0.2
STEADY_T_END = 4000.0  # 20000 steps
# storage every 32 steps runs 512 steps: 17 frames of 64 MiB stay under 2 GB
RATE_SETUPS = {  # label -> (trackers(pde), end time)
    "storage every 2048 steps": (lambda pde: [pde.MemoryStorage().tracker(204.8)], 204.8),
    "storage every 256 steps": (lambda pde: [pde.MemoryStorage().tracker(25.6)], 204.8),
    "storage every 32 steps (512 steps)": (lambda pde: [pde.MemoryStorage().tracker(3.2)],
                                           51.2),
    "tracker='auto'": (lambda pde: "auto", 204.8),
    "tracker=None": (lambda pde: None, 204.8),
}
CH_TRACKERS_N = 4096
CH_TRACKERS_DT = 1e-3
CH_TRACKERS_T_END = 0.512  # 512 steps


def _frames_close(torch, np, label, got, ref, dt, dtype) -> float:
    """Max |got - ref| over the frames of two storages with equal times: fp64
    within 1e-12 of max|ref|, fp32 within 1e-6 a step of max|ref|; raises."""
    if list(got.times) != list(ref.times):
        raise AssertionError(f"{label}: times {list(got.times)} against {list(ref.times)}")
    worst = 0.0
    for t, a, b in zip(got.times, got.data, ref.data, strict=True):
        scale = float(np.abs(b).max())
        steps = max(1, round(t / dt))
        tol = (F64_TOL if dtype == torch.float64 else F32_STEP_RTOL * steps) * scale
        err = float(np.abs(a.astype(np.float64) - b).max())
        if not (np.isfinite(a).all() and err <= tol):
            raise AssertionError(f"{label}: frame at t={t} max_abs {err:.3e} past {tol:.1e}")
        worst = max(worst, err)
    return worst


def _tracked_solve(pde, torch, state, trackers, t_end, dt, **kw):
    """One ``solve`` with trackers, synchronised; (seconds, controller info)."""
    eq = kw.pop("eq", None) or pde.DiffusionPDE(0.1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    eq.solve(state, t_range=t_end, dt=dt, tracker=trackers, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - start, eq.diagnostics["controller"]


def _trackers_phase(pde, torch, np, device, smi) -> None:
    """Phase 44: the main path (kernel #1) with storage and trackers between
    its windows, against the plain loop on the card; #12 on [2, 2]; a
    steady-state stop; rates per tracker setup, host ms per interrupt, a
    frame's copy and the idle share of a traced solve."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.storage.base import field_to_host

    f32, f64 = torch.float32, torch.float64
    dt, t_end = TRACKERS_DT, TRACKERS_T_END

    def main_trackers():
        storage = pde.MemoryStorage()
        values = pde.DataTracker(lambda f: float(f.average), interrupts=12.8)
        return storage, values, [storage.tracker(12.8), "consistency",
                                 pde.MaterialConservationTracker(interrupts=25.6), values]

    runs = {}
    for n, dtype in ((TRACKERS_N, f32), (TRACKERS_F64_N, f64)):
        grid = pde.UnitGrid([n, n], periodic=True)
        state = pde.ScalarField.random_uniform(grid, dtype=dtype, device=device,
                                               rng=np.random.default_rng(44))
        cc.affine_laplace_2d.launches = 0
        storage, values, trackers = main_trackers()
        seconds, info = _tracked_solve(pde, torch, state, trackers, t_end, dt, backend="cuda")
        launches = cc.affine_laplace_2d.launches
        ref, ref_values, ref_trackers = main_trackers()
        plain_seconds, plain_info = _tracked_solve(pde, torch, state, ref_trackers, t_end, dt,
                                                   backend="numpy")
        err = _frames_close(torch, np, f"[trackers #1] {n}^2", storage, ref, dt, dtype)
        checks = [launches > 0, info["successful"], info.get("stop_reason") is None,
                  list(storage.times) == values.times == ref_values.times,
                  len(storage) == 17, storage.times[-1] == t_end,
                  np.allclose(values.data, ref_values.data, rtol=1e-5)]
        print(f"[trackers #1] DiffusionPDE(0.1) {n}^2 periodic {str(dtype)[6:]}, {round(t_end / dt)}"
              f" steps through solve(backend='cuda') with storage every 128 steps, the "
              f"consistency and conservation trackers and a DataTracker: {len(storage)} frames "
              f"at times equal to the DataTracker's and the plain loop's, max_abs against the "
              f"plain loop's frames {err:.3e}; #1 launches {launches}; {seconds:.3f} s against "
              f"the plain loop's {plain_seconds:.3f} s {'ok' if all(checks) else 'FAIL'}",
              flush=True)
        _require(all(checks), f"trackers on the main path: {checks}")
        runs[n] = (state, storage, values)

    # the same solve over a [2, 2] mesh through #12: the blocks are combined on every
    # call, so the stored frames equal the serial run's bit for bit
    state, serial, serial_values = runs[TRACKERS_N]
    pde.config["parallel.devices_per_device"] = 4
    try:
        ce.affine_laplace_ext_2d.launches = 0
        storage, values, trackers = main_trackers()
        seconds, info = _tracked_solve(pde, torch, state, trackers, t_end, dt, backend="cuda",
                                       decomposition=[2, 2])
        ext_launches = ce.affine_laplace_ext_2d.launches
    finally:
        pde.config["parallel.devices_per_device"] = 1
    equal = list(storage.times) == list(serial.times) and all(
        np.array_equal(a, b) for a, b in zip(storage.data, serial.data, strict=True))
    ok = equal and ext_launches > 0 and values.data == serial_values.data
    print(f"[trackers #12] the same solve on [2, 2]: {len(storage)} frames bit-equal to the "
          f"serial run's: {equal}; #12 launches {ext_launches}; {seconds:.3f} s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    _require(ok, "the decomposed run's frames differ from the serial run's")

    # a steady-state stop through #1, against the plain loop's
    grid = pde.UnitGrid([STEADY_N, STEADY_N])
    steady_state = pde.ScalarField.random_uniform(grid, dtype=f64, device=device,
                                                  rng=np.random.default_rng(45))
    stops = {}
    cc.affine_laplace_2d.launches = 0
    for backend in ("cuda", "numpy"):
        seconds, info = _tracked_solve(
            pde, torch, steady_state, [pde.SteadyStateTracker(10.0, atol=1e-6, rtol=1e-6)],
            STEADY_T_END, 0.2, eq=pde.DiffusionPDE(1.0, bc={"derivative": 0}), backend=backend)
        stops[backend] = (info["t_final"], info.get("stop_reason"), seconds)
        if backend == "cuda":
            steady_launches = cc.affine_laplace_2d.launches
    (t_stop, reason, seconds), (t_plain, reason_plain, plain_seconds) = stops.values()
    ok = (t_stop == t_plain < STEADY_T_END and reason == reason_plain
          and "steady state" in str(reason) and steady_launches > 0)
    print(f"[trackers #1] steady state: DiffusionPDE(1.0) {STEADY_N}^2 no-flux fp64, dt 0.2, "
          f"SteadyStateTracker(10, atol=rtol=1e-6): stopped at t={t_stop} "
          f"({round(t_stop / 0.2)} of {round(STEADY_T_END / 0.2)} steps), {reason!r}, #1 "
          f"launches {steady_launches}, {seconds:.3f} s; the plain loop at t={t_plain}, "
          f"{reason_plain!r}, {plain_seconds:.3f} s {'ok' if ok else 'FAIL'}", flush=True)
    _require(ok, f"the steady-state stops differ: {stops}")

    # rates by tracker setup, in turns, best of 3; the host's share per interrupt
    cells = TRACKERS_N * TRACKERS_N
    rates = {label: 0.0 for label in RATE_SETUPS}
    per_solve = {}
    _tracked_solve(pde, torch, state, None, t_end, dt, backend="cuda")  # warm-up
    for turn in range(3):
        for label, (make, end) in RATE_SETUPS.items():
            cc.affine_laplace_2d.launches = 0
            seconds, info = _tracked_solve(pde, torch, state, make(pde), end, dt,
                                           backend="cuda")
            rates[label] = max(rates[label], cells * round(end / dt) / seconds)
            if turn == 0:
                profiler = info["profiler"]
                per_solve[label] = (cc.affine_laplace_2d.launches, profiler["tracker"],
                                    profiler["solver"])
    interrupts = {}  # tracker calls a solve: one before each window and one at its end
    for label, (make, end) in RATE_SETUPS.items():
        trackers = make(pde)
        interval = (end if trackers is None else 1.0 if trackers == "auto"
                    else trackers[0].interrupts.dt)  # "auto": the consistency tracker's
        interrupts[label] = math.ceil(round(end / interval, 9)) + 1
    auto = [type(tracker).__name__ for tracker in pde.TrackerCollection.from_data("auto")]
    print(f"[trackers rates] DiffusionPDE(0.1) {TRACKERS_N}^2 fp32, 2048 steps through "
          f"solve(backend='cuda') on {smi} ('auto' makes {auto}), best of 3 in turns, "
          f"cell-updates/s: "
          + "; ".join(
              f"{label} {rates[label]:.4e} ({rates[label] / rates['tracker=None']:.1%} of "
              f"tracker=None; #1 launches {per_solve[label][0]}; {interrupts[label]} interrupts, "
              f"host ms an interrupt: trackers "
              f"{1e3 * per_solve[label][1] / interrupts[label]:.3f}, windows "
              f"{1e3 * per_solve[label][2] / interrupts[label]:.3f})"
              for label in RATE_SETUPS), flush=True)
    # one frame's copy to the host as the storages take it (a new pageable array),
    # beside the same copy into a reused pageable array and into pinned memory
    reused = torch.empty(state.data.shape, dtype=state.dtype)
    pinned = torch.empty(state.data.shape, dtype=state.dtype, pin_memory=True)
    copy_ms = {}
    for label, copy in (("a new array (the storages')", lambda: field_to_host(state)),
                        ("a new tensor (Tensor.cpu())", lambda: state.data.cpu()),
                        ("a reused pageable array", lambda: reused.copy_(state.data)),
                        ("pinned memory", lambda: pinned.copy_(state.data))):
        times_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            start = time.perf_counter()
            copy()
            torch.cuda.synchronize()
            times_ms.append(1e3 * (time.perf_counter() - start))
        copy_ms[label] = sorted(times_ms)
    wall_us, times, events = _profiled(torch, lambda: pde.DiffusionPDE(0.1).solve(
        state, t_range=t_end, dt=dt, tracker=[pde.MemoryStorage().tracker(25.6)],
        backend="cuda"))
    busy_us = sum(times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:3]
    frame_mib = state.data.numel() * state.data.element_size() / 2**20
    print(f"[trackers trace] one {frame_mib:g} MiB frame's copy to the host, best / median of 5 "
          f"ms: " + "; ".join(f"into {label} {ms[0]:.3f} / {ms[2]:.3f}"
                             for label, ms in copy_ms.items())
          + "; one traced "
          f"solve with storage every 256 steps (torch.profiler): wall {wall_us:.1f} us, device "
          f"{busy_us:.1f} us in {events} events, idle share {_idle(busy_us, wall_us)}; top: "
          + "; ".join(f"{name[:50]} {us:.1f} us" for name, us in top), flush=True)


def _trackers_cahn_hilliard(pde, torch, np, device, smi) -> None:
    """Phase 45: Cahn-Hilliard through kernel #7 with storage, the conservation
    tracker and a DataTracker, against the plain loop on the card."""
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    grid = pde.UnitGrid([CH_TRACKERS_N, CH_TRACKERS_N], periodic=True)
    state = pde.ScalarField.random_uniform(grid, -0.5, 0.5, dtype=torch.float32,
                                           device=device, rng=np.random.default_rng(46))
    dt, t_end = CH_TRACKERS_DT, CH_TRACKERS_T_END
    runs = {}
    for backend in ("cuda", "numpy"):
        storage = pde.MemoryStorage()
        values = pde.DataTracker(lambda f: float(f.integral), interrupts=0.064)
        trackers = [storage.tracker(0.064), pde.MaterialConservationTracker(interrupts=0.128),
                    values]
        cs.multi_stencil_2d.launches = 0
        seconds, info = _tracked_solve(pde, torch, state, trackers, t_end, dt,
                                       eq=pde.CahnHilliardPDE(), backend=backend)
        runs[backend] = (storage, values, info, seconds, cs.multi_stencil_2d.launches)
    (storage, values, info, seconds, launches), (ref, ref_values, ref_info, plain_seconds, _) = \
        runs.values()
    err = _frames_close(torch, np, "[trackers #7]", storage, ref, dt, torch.float32)
    # the average's drift: Cahn-Hilliard conserves material, fp32 sums round
    drift = max(abs(v - values.data[0]) for v in values.data) / grid.volume
    checks = [launches > 0, info["successful"], ref_info["successful"],
              info.get("stop_reason") is None, list(storage.times) == values.times,
              len(storage) == 9, drift <= 1e-5]
    print(f"[trackers #7] CahnHilliardPDE() {CH_TRACKERS_N}^2 periodic fp32, dt {dt}, "
          f"{round(t_end / dt)} steps through solve(backend='cuda') on {smi}, storage every 64 "
          f"steps, the conservation tracker and DataTracker(integral): {len(storage)} frames, "
          f"max_abs against the plain loop's {err:.3e}; the average drifts by at most "
          f"{drift:.3e}; #7 launches {launches}; {seconds:.3f} s against the plain loop's "
          f"{plain_seconds:.3f} s {'ok' if all(checks) else 'FAIL'}", flush=True)
    _require(all(checks), f"trackers on Cahn-Hilliard: {checks}")


API_N = 4096  # phase 46's grid
API_POINTS = 1_000_000  # interpolation points
API_F32_RTOL = 1e-5  # evaluate's kernels against the composed field operators, fp32, of max|ref|
KS_N = 4096  # phase 47's grid: UnitGrid, dx = 1
KS_DT = 0.01  # below 2 / max|λ(−∇² − ∇⁴)| = 2 / 56 at dx = 1
KS_CHECK_STEPS = 64
KS_NOISE = 0.1
RD_N, KG_N, LINE_N = 1024, 4096, 4096  # phase 48's grids
RD_SMALL_N, LINE_SMALL_N = 64, 256  # its card-against-CPU checks, fp64


def _ks_windows(pde, torch, device) -> dict:
    """Phase 47's windows: KS Euler through #7 (periodic and no-flux, fp32 and
    fp64), noisy KS through #10 (staged) and #9 (irwin4 in the kernel)."""
    periodic = pde.UnitGrid([KS_N, KS_N], periodic=True)
    bounded = pde.UnitGrid([KS_N, KS_N])
    windows = {}
    for label, grid, bc in (("periodic", periodic, "auto_periodic_neumann"),
                            ("no-flux", bounded, {"derivative": 0})):
        for dtype in (torch.float32, torch.float64):
            state = pde.ScalarField(grid, 0.0, dtype=dtype, device=device)
            windows[(label, dtype)] = pde.KuramotoSivashinskyPDE(bc=bc).make_fused_euler_window(
                state, KS_DT)
    state = pde.ScalarField(periodic, 0.0, dtype=torch.float32, device=device)
    for route, cfg, _ in SDE_ROUTES[:2]:
        with pde.config(cfg):
            windows[route] = pde.KuramotoSivashinskyPDE(noise=KS_NOISE).make_fused_euler_window(
                state, KS_DT)
    return windows


def _api_phase(pde, torch, np, device, smi) -> None:
    """Phase 46: the field API on the card (plain torch but evaluate's kernels)."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_stencil_op_2d as so

    f32, f64 = torch.float32, torch.float64
    grid = pde.UnitGrid([API_N, API_N], periodic=True)
    made = {
        "from_expression": lambda: pde.ScalarField.from_expression(
            grid, "sin(x / 64) * cos(y / 32) + 0.5", dtype=f32),
        "random_normal": lambda: pde.ScalarField.random_normal(grid, dtype=f32, rng=46),
        "random_harmonic": lambda: pde.ScalarField.random_harmonic(grid, dtype=f32, rng=47),
        "random_colored": lambda: pde.ScalarField.random_colored(grid, -2, dtype=f32, rng=48),
    }
    fields, ms = {}, {}
    for name, make in made.items():  # one call each, synchronized (host work and a copy)
        fields[name], seconds = _synced_seconds(torch, make)
        ms[name] = 1e3 * seconds
    on_card = all(f.device.type == "cuda" and f.dtype == f32 and bool(torch.isfinite(f.data).all())
                  for f in fields.values())
    cpu = pde.ScalarField.random_normal(grid, dtype=f32, device="cpu", rng=46)
    same = bool(torch.equal(fields["random_normal"].data.cpu(), cpu.data))
    print(f"[api] {API_N}^2 fp32 on {smi}: from_expression, random_normal, random_harmonic and "
          f"random_colored land on {fields['random_normal'].device} ({on_card}); random_normal"
          f"(rng=46) equals the CPU's bit for bit: {same}; ms a call (host numpy, then one "
          "copy): " + ", ".join(f"{name} {t:.2f}" for name, t in ms.items()), flush=True)
    _require(on_card and same, "fields from the API did not land on the card as drawn")

    a, b = fields["random_normal"], fields["random_harmonic"]
    expr = "laplace(a*b) + gradient_squared(a)"
    errs = {}
    for dtype in (f32, f64):
        fa, fb = a.copy(dtype=dtype), b.copy(dtype=dtype)
        cc.affine_laplace_2d.launches = so.stencil_op_2d.launches = 0
        got = pde.evaluate(expr, {"a": fa, "b": fb})
        launches = (cc.affine_laplace_2d.launches, so.stencil_op_2d.launches)
        ref = (fa * fb).laplace("periodic") + fa.gradient_squared("periodic")
        errs[dtype] = _rel_err(torch, got.data, ref.data)
        tol = API_F32_RTOL if dtype == f32 else F64_TOL
        ok = errs[dtype] <= tol and min(launches) > 0 and got.dtype == dtype
        print(f"[api] evaluate('{expr}') {str(dtype)[6:]}: against the composed field operators "
              f"{errs[dtype]:.3e} of max|ref| (tol {tol:.0e}); launches #1 {launches[0]}, "
              f"stencil_op_2d {launches[1]} {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"evaluate on the card ({dtype})")
    eval_ms = _cuda_ms(torch, lambda: pde.evaluate(expr, {"a": a, "b": b}), 5)
    composed_ms = _cuda_ms(torch, lambda: (a * b).laplace("periodic")
                           + a.gradient_squared("periodic"), 5)

    points = np.random.default_rng(49).uniform(0, API_N, (API_POINTS, 2))
    values = a.interpolate(points)
    ref = a.make_interpolator()(a.data.cpu().double(), points)
    err = _rel_err(torch, values, ref)
    interp_ms = _cuda_ms(torch, lambda: a.interpolate(points), 3)
    _require(err <= F32_STEP_RTOL and values.device.type == "cuda",
             "interpolation on the card disagrees with the plain gather")
    smooth = a.smooth(2)
    smooth_drift = abs(float(smooth.average) - float(a.average)) / float(a.data.abs().max())
    smooth_ms = _cuda_ms(torch, lambda: a.smooth(2), 3)
    deposit = pde.ScalarField(grid, 0.0, dtype=f64)
    deposit.insert(points[:1000], 1.0)
    inserted = float(deposit.integral)
    insert_ms = _cuda_ms(torch, lambda: deposit.insert(points, 1.0), 3)
    checks = [bool(torch.isfinite(smooth.data).all()), smooth_drift <= API_F32_RTOL,
              abs(inserted - 1000.0) <= 1e-9, float(smooth.data.std()) < float(a.data.std())]
    print(f"[api] on {smi}: evaluate {eval_ms:.3f} ms a call (the composed field operators "
          f"{composed_ms:.3f}); interpolate at {API_POINTS} points {interp_ms:.3f} ms, "
          f"against the plain gather in fp64 {err:.3e} of max|ref|; smooth(sigma=2) "
          f"{smooth_ms:.3f} ms, its average moved {smooth_drift:.2e} of max|f|; insert at "
          f"{API_POINTS} points (fp64) {insert_ms:.3f} ms, 1000 unit deposits integrate to "
          f"{inserted:.12f} {'ok' if all(checks) else 'FAIL'}", flush=True)
    _require(all(checks), f"smooth or insert on the card: {checks}")


def _ks_phase(pde, torch, np, device, smi, windows, logs) -> list[dict]:
    """Phase 47: Kuramoto-Sivashinsky through #7, #10 and #9."""
    from pde_tpu_torch.ops import cuda_sde_2d as sde
    from pde_tpu_torch.ops import cuda_stencil_2d as cs

    f32, f64 = torch.float32, torch.float64
    cells = KS_N * KS_N
    errs = {}
    for (label, dtype), window in ((key, w) for key, w in windows.items() if len(key) == 2):
        grid = pde.UnitGrid([KS_N, KS_N], periodic=label == "periodic")
        bc = "auto_periodic_neumann" if label == "periodic" else {"derivative": 0}
        state = pde.ScalarField.random_normal(grid, std=0.1, dtype=dtype, rng=47)
        eq = pde.KuramotoSivashinskyPDE(bc=bc)
        cs.multi_stencil_2d.launches = 0
        (got,) = window([state.data], KS_CHECK_STEPS)
        launches = cs.multi_stencil_2d.launches
        ref, _ = pde.EulerSolver(eq, backend="numpy").make_stepper(state, dt=KS_DT)(
            state, 0.0, KS_CHECK_STEPS * KS_DT)
        text = (f"[ks] KS {KS_N}^2 {label} {str(dtype)[6:]} window (#7, ladder "
                f"{window.program.ladder}, {launches} launches) against its plain loop")
        errs[(label, dtype)] = _check_rel(torch, text, got, ref.data, dtype, KS_CHECK_STEPS)
        print(f"{text}: {KS_CHECK_STEPS} steps max_abs {errs[(label, dtype)]:.3e}, max|f| "
              f"{float(ref.data.abs().max()):.4f} ok", flush=True)
        _require(launches > 0, f"the KS window launched no #7 ({label})")

    # the main path: make_stepper and solve through backend='cuda'
    grid = pde.UnitGrid([KS_N, KS_N], periodic=True)
    state = pde.ScalarField.random_normal(grid, std=0.1, dtype=f32, rng=47)
    eq = pde.KuramotoSivashinskyPDE(nu=1.0)
    cs.multi_stencil_2d.launches = 0
    solver = pde.EulerSolver(eq, backend="cuda")
    stepper = solver.make_stepper(state, dt=KS_DT)
    out, _ = stepper(state, 0.0, 2048 * KS_DT)
    solved = eq.solve(state, t_range=0.64, dt=KS_DT, tracker=None, backend="cuda")
    torch.cuda.synchronize()
    ks_launches = cs.multi_stencil_2d.launches
    ok = (ks_launches > 0 and solver.info.get("fused_step") and
          eq.diagnostics["solver"].get("fused_step") and bool(torch.isfinite(out.data).all())
          and bool(torch.isfinite(solved.data).all()))
    _require(ok, "the KS main path did not run through #7")
    window = windows[("periodic", f32)]
    top = window.specs[0]
    data = state.data
    outs = [torch.empty_like(data)]
    k_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d([data], top, outs=outs), 20)
    plain_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d_plain([data], top), 3)
    ks_bound = _bound(2 * cells * 4, _program_flops(window.program) * top.k * cells)
    rate = _window_rate(torch, stepper, state, KS_DT)
    per_window = _ladder_passes(window.program.ladder, 2048)
    print(f"[ks] KuramotoSivashinskyPDE(nu=1) {KS_N}^2 periodic fp32, dt {KS_DT}, on {smi}: "
          f"#7 launches over the main path {ks_launches} (make_stepper 2048 steps, solve 64); "
          f"one k={top.k} pass {k_ms:.4f} ms (plain {plain_ms:.4f}), bound {ks_bound[0]:.4f} "
          f"ms ({ks_bound[1]}), {ks_bound[0] / k_ms:.1%} of it; {per_window} passes a 2048-step "
          f"window (ladder {window.program.ladder}); {rate:.4e} cell-updates/s (best of 3 "
          f"windows of 2048 steps); ptxas {' | '.join(_ptxas_of(logs[window.program.digest]))}", flush=True)

    # noisy KS: #10 (staged, the plain loop's stream) and #9 (irwin4 in the kernel)
    rows = []
    noisy = {}
    for route, cfg, kernel in SDE_ROUTES[:2]:
        with pde.config(cfg):
            counter = getattr(sde, kernel)
            counter.launches = 0
            eq = pde.KuramotoSivashinskyPDE(noise=KS_NOISE, rng=np.random.default_rng(5))
            solver = pde.EulerSolver(eq, backend="cuda")
            fused, _ = solver.make_stepper(state, dt=KS_DT)(state, 0.0, KS_CHECK_STEPS * KS_DT)
            torch.cuda.synchronize()
            launches = counter.launches
            checks = [launches > 0, bool(solver.info.get("fused_step")),
                      bool(torch.isfinite(fused.data).all())]
            if route == "normal":
                plain_eq = pde.KuramotoSivashinskyPDE(noise=KS_NOISE, rng=np.random.default_rng(5))
                plain, _ = pde.EulerSolver(plain_eq, backend="numpy").make_stepper(
                    state, dt=KS_DT)(state, 0.0, KS_CHECK_STEPS * KS_DT)
                err = float((fused.data - plain.data).abs().max())
                tol = F32_STEP_RTOL * KS_CHECK_STEPS * float(plain.data.abs().max())
                checks.append(err <= tol)
                note = (f"against the plain loop on the same stream max_abs {err:.3e} "
                        f"(tol {tol:.1e})")
            else:
                # one k = 1 pass less the deterministic step: the increments alone
                w = windows[route]
                x = (w(data, 77, 1) - w.program.stencil.plain_step([data])[0]).double().reshape(-1)
                scale = w.specs[0].scale
                parts = []
                for power, target in ((1, 0.0), (2, scale**2), (3, 0.0)):
                    values = x**power
                    se = float(values.std()) / x.numel() ** 0.5
                    got = float(values.mean())
                    checks.append(abs(got - target) <= MOMENT_SIGMAS * se)
                    parts.append(f"E[x^{power}] {got:.4e} (target {target:.4e}, se {se:.1e})")
                note = "one k=1 pass less the deterministic step: " + ", ".join(parts)
            window = windows[route]
            spec = window.specs[0]
            out = torch.empty_like(data)
            if route == "normal":
                noise = torch.randn((spec.k, *spec.shape), dtype=f32, device=device) * 0.03
                run = lambda: sde.sde_stencil_2d(data, noise, spec, out=out)  # noqa: E731
                plain_run = lambda: sde.sde_stencil_2d_plain(data, noise, spec)  # noqa: E731
                n_bytes = (2 + spec.k) * cells * 4
                flops = _program_flops(spec.program.stencil) + 1
            else:
                ctl = (4, 7, 0)
                run = lambda: sde.sde_kernel_noise_2d(data, ctl, spec, out=out)  # noqa: E731
                plain_run = lambda: sde.sde_kernel_noise_2d_plain(data, ctl, spec)  # noqa: E731
                n_bytes = 2 * cells * 4
                flops = _program_flops(spec.program.stencil) + 1 + PHILOX_OPS + IRWIN4_OPS
            kernel_err = float((run() - plain_run()).abs().max())
            ks_ms = _cuda_ms(torch, run, 20)
            ks_plain_ms = _cuda_ms(torch, plain_run, 3)
            bound = _bound(n_bytes, flops * spec.k * cells)
            checks.append(kernel_err <= F32_STEP_RTOL * spec.k * float(data.abs().max()))
            noisy[route] = launches
            print(f"[ks] noisy KS (noise {KS_NOISE}) {KS_N}^2 periodic fp32 {route} through "
                  f"{kernel}: {launches} launches over {KS_CHECK_STEPS} steps, {note}; one "
                  f"k={spec.k} pass {ks_ms:.4f} ms (plain {ks_plain_ms:.4f}, kernel against it "
                  f"{kernel_err:.3e}), bound {bound[0]:.4f} ms ({bound[1]}); "
                  f"{_ladder_passes(window.program.stencil.ladder, 2048)} passes a 2048-step "
                  f"window {'ok' if all(checks) else 'FAIL'}", flush=True)
            _require(all(checks), f"noisy KS through {kernel}: {checks}")
            rows.append({
                "name": f"{kernel} (Kuramoto-Sivashinsky)",
                "route": "cuda",
                "source": ("pde_tpu_torch/csrc/multi_stencil_2d.cuh" if route == "normal"
                           else "pde_tpu_torch/csrc/philox.cuh"),
                "replaces": ("pde_tpu/ops/pallas_cartesian.py:4831" if route == "normal"
                             else "pde_tpu/ops/pallas_cartesian.py:4660"),
                "launches": launches, "max_abs_err": kernel_err, "ms": ks_ms,
                "plain_ms": ks_plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None,  # the rhs is nonlinear
            })

    # ETDRK4 through make_etdrk_parts against the expression PDE's ETDRK4 run
    small = pde.UnitGrid([1024, 1024], periodic=True)
    etd_state = pde.ScalarField.random_normal(small, std=0.1, dtype=f32, rng=48)
    rhs = "-1.0 * laplace(laplace(c)) - laplace(c) - 0.5 * gradient_squared(c)"
    runs = [model.solve(etd_state, t_range=0.5, dt=0.05, solver="etdrk4", tracker=None)
            for model in (pde.KuramotoSivashinskyPDE(), pde.PDE({"c": rhs}))]
    equal = bool(torch.equal(runs[0].data, runs[1].data))
    print(f"[ks] ETDRK4 of KuramotoSivashinskyPDE() 1024^2 periodic fp32 (make_etdrk_parts) "
          f"against the expression PDE's, 10 steps of dt 0.05, on {smi}: bit-equal {equal} "
          f"{'ok' if equal else 'FAIL'}", flush=True)
    _require(equal, "KS's ETDRK4 split differs from the expression PDE's")
    return [{
        "name": "multi_stencil_2d (Kuramoto-Sivashinsky)",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:3755",
        "launches": ks_launches,
        "max_abs_err": errs[("periodic", f32)],
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": ks_bound[0],
        "bound_by": ks_bound[1],
        "library_ms": None,  # the rhs is nonlinear
    }] + rows


def _rd_kg_1d_phase(pde, torch, np, device, smi) -> None:
    """Phase 48: the plain-torch models and 1D grids on the card."""
    f32, f64 = torch.float32, torch.float64

    def brusselator():
        return pde.ReactionDiffusionPDE(["u", "v"], [1, 0.1],
                                        ["1 - (3 + 1) * u + u**2 * v", "3 * u - u**2 * v"])

    def rd_state(n, dtype, where):
        grid = pde.UnitGrid([n, n])
        u = pde.ScalarField(grid, 1.0, dtype=dtype, device=where, label="u")
        v = 3 + 0.1 * pde.ScalarField.random_normal(grid, dtype=dtype, device=where, rng=48)
        return pde.FieldCollection([u, v])

    def kg_state(n, dtype, where):
        u = pde.ScalarField.random_harmonic(pde.UnitGrid([n, n], periodic=True), dtype=dtype,
                                            device=where, rng=49)
        return pde.KleinGordonPDE().get_initial_condition(u)

    def line_state(n, dtype, where):
        return pde.ScalarField.random_normal(pde.UnitGrid([n], periodic=True), std=0.1,
                                             dtype=dtype, device=where, rng=50)

    cases = {  # label -> (model, state(n, dtype, device), n, small n, dt, steps)
        "Brusselator ReactionDiffusionPDE": (brusselator, rd_state, RD_N, RD_SMALL_N, 1e-3, 500),
        "KleinGordonPDE": (pde.KleinGordonPDE, kg_state, KG_N, RD_SMALL_N, 1e-2, 200),
        "1D KuramotoSivashinskyPDE": (pde.KuramotoSivashinskyPDE, line_state, LINE_N,
                                      LINE_SMALL_N, 1e-2, 2000),
        "1D DiffusionPDE": (lambda: pde.DiffusionPDE(1.0), line_state, LINE_N, LINE_SMALL_N,
                            0.1, 2000),
    }
    for label, (model, make_state, n, n_small, dt, steps) in cases.items():
        small = [model().solve(make_state(n_small, f64, where), t_range=20 * dt, dt=dt,
                               tracker=None) for where in (device, "cpu")]
        card, cpu = (s.data if isinstance(s, pde.FieldCollection) else s.data for s in small)
        err = _rel_err(torch, card, cpu)
        state = make_state(n, f32, device)
        eq = model()
        solver = pde.EulerSolver(eq)
        stepper = solver.make_stepper(state, dt=dt)
        result, _ = stepper(state, 0.0, steps * dt)
        torch.cuda.synchronize()
        start = time.perf_counter()
        result, _ = stepper(result, 0.0, steps * dt)
        torch.cuda.synchronize()
        rate = steps / (time.perf_counter() - start)
        trace = _trace_line(torch, lambda: stepper(state, 0.0, 50 * dt), 50, "step")
        checks = [err <= F64_TOL, bool(torch.isfinite(result.data).all()),
                  result.data.device.type == "cuda", "fused_step" not in solver.info]
        square = not label.startswith("1D")
        print(f"[rd kg 1d] {label} {n}{'^2' if square else ' cells'} fp32 on {smi}: "
              f"{rate:.1f} steps/s over {steps} steps, dt {dt:g} (plain torch on the card, "
              f"{solver.info.get('fused_unsupported', 'no fused window')}); one traced 50-step "
              f"window: {trace}; 20 fp64 steps at {n_small}{'^2' if square else ' cells'} "
              f"on the card against the CPU {err:.3e} of max|f| {'ok' if all(checks) else 'FAIL'}",
              flush=True)
        _require(all(checks), f"{label} on the card: {checks}")


CORNER_KEY = "operators.cartesian.laplacian_2d_corner_weight"
CORNER_N = 4096  # phase 49's grid: the main path's
CORNER_WEIGHTS = {"w=1/3": 1 / 3, "w=1/2": 0.5}  # Patra-Karttunen, Oono-Puri
CORNER_DT = 0.1
CORNER_CHECK_STEPS = 64
CORNER_MAIN_STEPS = 37
# operations per cell and step of the 9-point update (corner_update_2d: five
# adds of neighbour pairs and sums, four products and three adds of lap9, then
# a*c + b*lap9)
CORNER_FLOPS = 15
# the 5-point kernels whose registers and instructions phase 49 prints beside
# the parent's (scripts/torch_tree_compare.py holds them against another copy)
FIVE_POINT_NEEDLES = {
    "affine_laplace_2d": ("affine_laplace_2d_kernel", "IfLi12ELi256ELi288E"),
    "affine_laplace_ext_2d": ("affine_laplace_ext_2d_kernel", "IfLi12ELi256ELi288E"),
}


def _corner_units(pde, torch) -> list:
    """Phase 49's build units: the 9-point mode's libraries of #1 and #12."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce

    return [cc.kernel_source((True, True), cc.CORNER_LIBRARY),
            ce.affine_ext_source((True, True), corner=True)]


def _composed_corner_stencil(torch, spec):
    """The (2k+1)² weights of one k-step pass of the 9-point mode on a
    periodic grid (as :func:`_composed_stencil`; fp64, symmetric)."""
    from pde_tpu_torch.ops.cuda_cartesian import corner_factors

    k = spec.k
    cud, clr, cdg, cc = corner_factors(spec)
    w = torch.zeros((2 * k + 1, 2 * k + 1), dtype=torch.float64)
    w[k, k] = 1.0
    for _ in range(k):
        h = w.roll(1, 1) + w.roll(-1, 1)
        lap9 = (cud * (w.roll(1, 0) + w.roll(-1, 0)) + clr * h
                + cdg * (h.roll(1, 0) + h.roll(-1, 0)) + cc * w)
        w = spec.a * w + spec.b * lap9
    return w


def _sass_summary(path: str, needles) -> str:
    """Instructions and a hash of the SASS of each function of a library whose
    name holds every needle (``scripts/torch_tree_compare.py``'s reading)."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from scripts.torch_tree_compare import _sass

    functions = _sass(cc._nvcc(), path, needles, None)
    return ", ".join(sorted(functions.values())) or "SASS not read (no cuobjdump)"


def _corner_phase(pde, torch, np, device, smi, builds, five_point) -> list[dict]:
    """Phase 49: the 9-point corner-weight mode of kernels #1 and #12 (B1(e)).

    `builds` maps the build units of :func:`_corner_units` to their builds;
    `five_point` the 5-point libraries of #1 and #12 (periodic) to theirs.
    Returns the two kernels' entries of the kernels line."""
    import torch.nn.functional as F

    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce

    f32, f64 = torch.float32, torch.float64
    gen = np.random.default_rng(49)
    grid = pde.UnitGrid([CORNER_N, CORNER_N], periodic=True)
    cells = CORNER_N * CORNER_N
    small = {"periodic 3x4 (the halo wraps many times)": pde.UnitGrid([3, 4], periodic=True),
             "anisotropic ragged 100x130": pde.CartesianGrid([(0, 100), (0, 260)], [100, 130],
                                                              periodic=True)}
    for unit, built in builds.items():
        for dtype, name, itemsize in ((f32, "f", 4), (f64, "d", 8)):
            regs = [f"k={k}: " + " ".join(_ptxas_of(built["log"], "corner", f"I{name}Li{k}E"))
                    for k in range(1, cc.CORNER_TOP_STEPS + 1)]
            print(f"[corner plan] {unit.library} {str(dtype)[6:]}: plan "
                  f"{cc.corner_row_plan(cc.CORNER_TOP_STEPS, itemsize)} at k=8; "
                  + "; ".join(regs), flush=True)
    for library, built in five_point.items():
        needles = FIVE_POINT_NEEDLES[library]
        print(f"[corner] the 5-point {library} k=12 fp32 periodic, as built beside the 9-point "
              f"mode: {' | '.join(_ptxas_of(built['log'], *needles))}; SASS "
              f"{_sass_summary(built['path'], needles)}", flush=True)
    errs, per_weight = {}, {}
    for label, w in CORNER_WEIGHTS.items():
        with pde.config({CORNER_KEY: w}):
            for dtype in (f32, f64):  # every pass of the ladder, and the window over 64 steps
                data = torch.as_tensor(gen.random(grid.shape), dtype=dtype, device=device)
                window = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=CORNER_DT,
                                                       dtype=dtype)
                parts = []
                for spec in window.specs:
                    errs[(label, str(dtype), spec.k)] = err = _check_rel(
                        torch, f"9-point {label} k={spec.k}", cc.affine_laplace_2d(data, spec),
                        cc.affine_laplace_2d_plain(data, spec), dtype, spec.k)
                    parts.append(f"k={spec.k} {err:.3e}")
                ref = data
                for _ in range(CORNER_CHECK_STEPS):
                    ref = cc.affine_laplace_2d_plain(ref, window.specs[-1])
                err = _check_rel(torch, f"9-point {label} window", window(data, CORNER_CHECK_STEPS),
                                 ref, dtype, CORNER_CHECK_STEPS)
                for name, g in small.items():
                    d = torch.as_tensor(gen.random(g.shape), dtype=dtype, device=device)
                    for spec in cc.make_fused_euler_window_2d(g, diffusivity=0.1, dt=0.1,
                                                              dtype=dtype).specs:
                        _check_rel(torch, f"9-point {label} {name} k={spec.k}",
                                   cc.affine_laplace_2d(d, spec),
                                   cc.affine_laplace_2d_plain(d, spec), dtype, spec.k)
                print(f"[corner] #1 9-point {label} {CORNER_N}^2 periodic {str(dtype)[6:]}: one "
                      f"pass against its plain version, max_abs {', '.join(parts)}; the ladder "
                      f"{[s.k for s in window.specs]} window over {CORNER_CHECK_STEPS} steps "
                      f"{err:.3e} (max|f| {float(ref.abs().max()):.3g}); {', '.join(small)} at "
                      "every k ok", flush=True)
            # the main path under the key: counts reset just before, read just after
            eq = pde.DiffusionPDE(diffusivity=0.1)
            state = pde.ScalarField.random_uniform(grid, dtype=f32, rng=np.random.default_rng(3))
            solver = pde.EulerSolver(eq, backend="cuda")
            stepper = solver.make_stepper(state, dt=CORNER_DT)
            cc.affine_laplace_2d.launches = cc.affine_laplace_2d.corner_launches = 0
            result, t_end = stepper(state, 0.0, CORNER_MAIN_STEPS * CORNER_DT)
            solved = eq.solve(state, t_range=CORNER_MAIN_STEPS * CORNER_DT, dt=CORNER_DT,
                              tracker=None, backend="cuda")
            torch.cuda.synchronize()
            launches, corner = cc.affine_laplace_2d.launches, cc.affine_laplace_2d.corner_launches
            plain, _ = pde.EulerSolver(pde.DiffusionPDE(diffusivity=0.1), backend="numpy") \
                .make_stepper(state, dt=CORNER_DT)(state, 0.0, CORNER_MAIN_STEPS * CORNER_DT)
            err_main = _check_rel(torch, f"9-point main path {label}", result.data, plain.data,
                                  f32, CORNER_MAIN_STEPS)
            checks = [solver.info.get("fused_step") is True,
                      eq.diagnostics["solver"].get("fused_step") is True,
                      corner > 0 and corner == launches, torch.equal(solved.data, result.data),
                      result.data.device.type == "cuda", abs(t_end - 3.7) < 1e-9]
            _require(all(checks), f"the 9-point main path ({label}): {checks}")
            rate = _window_rate(torch, stepper, state, CORNER_DT)
            # #12 on a row cut [2, 1] of one card against the serial run, bit for bit
            pde.config["parallel.devices_per_device"] = 2
            try:
                solver_d = pde.EulerSolver(eq, backend="cuda", decomposition=[2, 1])
                stepper_d = solver_d.make_stepper(state, dt=CORNER_DT)
                ce.affine_laplace_ext_2d.launches = ce.affine_laplace_ext_2d.corner_launches = 0
                result_d, _ = stepper_d(state, 0.0, CORNER_MAIN_STEPS * CORNER_DT)
                torch.cuda.synchronize()
                ext_launches = ce.affine_laplace_ext_2d.corner_launches
                equal = torch.equal(result_d.data, result.data)
                rate_d = _window_rate(torch, stepper_d, state, CORNER_DT)
                try:
                    pde.EulerSolver(eq, backend="cuda", decomposition=[1, 2]).make_stepper(
                        state, dt=CORNER_DT)
                    refused = "no refusal"
                except RuntimeError as err:
                    refused = str(err)
            finally:
                pde.config["parallel.devices_per_device"] = 1
            checks = [solver_d.info.get("fused_step") is True, equal, ext_launches > 0,
                      "row-cut" in refused]
            _require(all(checks), f"#12's 9-point mode on [2, 1] ({label}): {checks}; {refused}")
            print(f"[corner] main path {label} ({CORNER_N}^2 periodic fp32 DiffusionPDE(0.1), "
                  f"EulerSolver(backend='cuda'), {CORNER_MAIN_STEPS} steps): against the plain "
                  f"loop's 9-point stencil max_abs {err_main:.3e}; launches {launches} (9-point "
                  f"{corner}); solve() equal; {rate:.4e} cell-updates/s (best of 3 x 3 windows "
                  f"of 2048 steps) on {smi}; [2, 1] through #12: bit-equal to serial {equal}, "
                  f"{ext_launches} launches, {rate_d:.4e} cell-updates/s; [1, 2] refused under "
                  f"cuda: {refused[:90]!r} ok", flush=True)
            per_weight[label] = {"launches": corner, "ext_launches": ext_launches, "rate": rate}
    # the 5-point main path's rate in the same call
    with pde.config({CORNER_KEY: 0.0}):
        state = pde.ScalarField.random_uniform(grid, dtype=f32, rng=np.random.default_rng(3))
        stepper = pde.EulerSolver(pde.DiffusionPDE(0.1), backend="cuda").make_stepper(
            state, dt=CORNER_DT)
        rate5 = _window_rate(torch, stepper, state, CORNER_DT)
    print(f"[corner] the 5-point main path in the same call: {rate5:.4e} cell-updates/s on {smi}",
          flush=True)
    # one top pass of each kernel: time, plain version, bound, the library call
    label = "w=1/3"
    rows = []
    with pde.config({CORNER_KEY: CORNER_WEIGHTS[label]}):
        data = torch.as_tensor(gen.random(grid.shape), dtype=f32, device=device)
        top = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=cc.CORNER_TOP_STEPS, dtype=f32)
        out = torch.empty_like(data)
        k_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d(data, top, out=out), 50)
        p_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d_plain(data, top), 3)
        weight = _composed_corner_stencil(torch, top).to(device=device, dtype=f32)
        lib_ms, lib_out = _library_conv(torch, data, weight, 5)
        lib_err = float((lib_out - out).abs().max())
        _require(lib_err <= LIBRARY_RTOL * float(out.abs().max()),
                 f"the 17x17 Conv2d does not compute the 9-point pass: {lib_err:.3e}")
        b_ms, b_by = _bound(2 * cells * 4, CORNER_FLOPS * top.k * cells)
        ladder = [s.k for s in cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=0.1).specs]
        print(f"[corner throughput] #1 9-point {label} {CORNER_N}^2 periodic fp32 k={top.k} on "
              f"{smi}: {k_ms:.4f} ms a pass ({k_ms / top.k:.4f} a step), plain {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), circular Conv2d with the composed "
              f"{weight.shape[0]}x{weight.shape[1]} stencil {lib_ms:.4f} ms (max_abs vs kernel "
              f"{lib_err:.3e}); {_ladder_passes(ladder, 2048)} launches per 2048-step window",
              flush=True)
        rows.append({
            "name": "affine_laplace_corner_2d", "route": "cuda",
            "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
            "replaces": "pde_tpu/ops/pallas_cartesian.py:793 (its 9-point mode, :1078-1108)",
            "launches": per_weight[label]["launches"],
            "max_abs_err": errs[(label, str(f32), top.k)], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
        # #12: one k = 8 pass over the two blocks of a [2, 1] cut, halo 8
        local = (CORNER_N // 2, CORNER_N)
        spec = ce.affine_laplace_ext_spec(grid, local, a=1.0, b=0.01, k=cc.CORNER_TOP_STEPS,
                                          halo=cc.CORNER_TOP_STEPS, dtype=f32)
        h, (n, m) = spec.halo, spec.shape
        ins = [torch.as_tensor(gen.random((n + 2 * h, m + 2 * h)), dtype=f32, device=device)
               for _ in range(2)]
        outs = [torch.empty_like(x) for x in ins]
        flags = [[0, 0, 0, 0]] * 2
        ce.affine_laplace_ext_2d(ins, outs, flags, spec)
        err = max(float((o[h:h + n, h:h + m] - ce.affine_laplace_ext_2d_plain(x, spec, f)).abs()
                        .max()) for x, o, f in zip(ins, outs, flags))
        scale = max(float(ce.affine_laplace_ext_2d_plain(x, spec, f).abs().max())
                    for x, f in zip(ins, flags))
        _require(err <= F32_STEP_RTOL * spec.k * scale,
                 f"#12's 9-point mode disagrees with its plain version: {err:.3e}")
        e_ms = _cuda_ms(torch, lambda: ce.affine_laplace_ext_2d(ins, outs, flags, spec), 50)
        ep_ms = _cuda_ms(torch, lambda: [ce.affine_laplace_ext_2d_plain(x, spec, f)
                                         for x, f in zip(ins, flags)], 3)
        x = torch.stack(ins)[:, None]
        allow_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                conv_out = F.conv2d(x, weight[None, None])
                el_ms = _cuda_ms(torch, lambda: F.conv2d(x, weight[None, None]), 5)
        finally:
            torch.backends.cudnn.allow_tf32 = allow_tf32
        conv_err = max(float((conv_out[b, 0] - outs[b][h:h + n, h:h + m]).abs().max())
                       for b in range(2))
        _require(conv_err <= LIBRARY_RTOL * scale,
                 f"the valid conv2d does not compute #12's 9-point pass: {conv_err:.3e}")
        eb_ms, eb_by = _bound(2 * ((n + 2 * h) * (m + 2 * h) + n * m) * 4,
                              CORNER_FLOPS * spec.k * 2 * (n + 2 * h) * (m + 2 * h))
        print(f"[corner throughput] #12 9-point {label} two {n}x{m} blocks ([2, 1]) fp32 halo {h} "
              f"k={spec.k} on {smi}: {e_ms:.4f} ms a call, plain {ep_ms:.4f} ms, bound {eb_ms:.4f} "
              f"ms ({eb_by}), valid conv2d over the extended blocks {el_ms:.4f} ms (max_abs vs "
              f"kernel {conv_err:.3e}); against its plain version {err:.3e}", flush=True)
        rows.append({
            "name": "affine_laplace_corner_ext_2d", "route": "cuda",
            "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
            "replaces": "pde_tpu/ops/pallas_cartesian.py:5792 (its 9-point mode, :6037-6114)",
            "launches": per_weight[label]["ext_launches"], "max_abs_err": err, "ms": e_ms,
            "plain_ms": ep_ms, "bound_ms": eb_ms, "bound_by": eb_by, "library_ms": el_ms,
        })
    return rows


OPS_OPTIONS_CHECK_N = 256  # phase 50's grid against the CPU, fp64
OPS_OPTIONS_N = 4096  # ... and timed, fp32
# operator, options, input rank
OPS_OPTIONS = (
    ("laplace", {"spectral": True}, 0),
    ("gradient", {"method": "forward"}, 0),
    ("gradient", {"method": "backward"}, 0),
    ("gradient_squared", {"central": False}, 0),
    ("divergence", {"method": "forward"}, 1),
    ("vector_gradient", {"method": "backward"}, 1),
    ("tensor_divergence", {"method": "forward"}, 2),
    ("d_dx", {}, 0),
    ("d_dy_forward", {}, 0),
    ("d2_dy2", {}, 0),
)
OPS_OPTIONS_PDE = {"c": "d_dx(c) + 0.1 * d2_dy2(c) - 0.5 * d_dy_backward(c) * c"}


def _ops_options_phase(pde, torch, np, device, smi) -> None:
    """Phase 50: the operator options and axis operators (plain torch, no
    kernel: ``pde_tpu`` lowers them to XLA) on the card against the CPU at
    256² fp64, an expression PDE with axis operators solved on both, and ms a
    call at 4096² fp32; the cuda registry refuses them."""
    from pde_tpu_torch.backends import get_backend

    f32, f64 = torch.float32, torch.float64
    bounded_bc = {"x": "periodic", "y": {"derivative": 0.3}}

    def grids(n):  # (periodic grid, grid with a bounded axis)
        return (pde.CartesianGrid([(0, 1), (0, 2)], [n, n], periodic=True),
                pde.CartesianGrid([(0, 1), (0, 2)], [n, n], periodic=[True, False]))

    def setup(op, options, rank, n, dtype, where, seed):
        periodic, bounded = grids(n)
        grid, bc = (periodic, "periodic") if options.get("spectral") else (bounded, bounded_bc)
        data = np.random.default_rng(seed).random((2,) * rank + (n, n))
        return grid, bc, torch.as_tensor(data, dtype=dtype, device=where)

    parts = []
    for i, (op, options, rank) in enumerate(OPS_OPTIONS):
        results = []
        for where in (device, "cpu"):
            grid, bc, data = setup(op, options, rank, OPS_OPTIONS_CHECK_N, f64, where, 50 + i)
            results.append(grid.make_operator(op, bc, **options)(data))
        err = _rel_err(torch, *results)
        _require(err <= F64_TOL and results[0].device.type == "cuda",
                 f"{op}{options} on the card against the CPU: {err:.3e}")
        grid, bc, data = setup(op, options, rank, OPS_OPTIONS_N, f32, device, 60 + i)
        apply = grid.make_operator(op, bc, **options)
        ms = _cuda_ms(torch, lambda: apply(data), 20)
        try:
            get_backend("cuda").make_operator(grid, op, bc, **options)
            refused = False
        except NotImplementedError:
            refused = True
        _require(refused, f"the cuda registry took {op}{options}")
        parts.append(f"{op}({', '.join(f'{k}={v!r}' for k, v in options.items())}) "
                     f"{err:.1e}, {ms:.4f} ms")
    # an expression PDE with axis operators: the plain loop, on the card and on the CPU
    results = []
    for where in (device, "cpu"):
        grid = grids(OPS_OPTIONS_CHECK_N)[1]
        state = pde.ScalarField(grid, np.random.default_rng(59).random(grid.shape), dtype=f64,
                                device=where)
        eq = pde.PDE(OPS_OPTIONS_PDE, bc=bounded_bc)
        results.append(eq.solve(state, t_range=20 * 1e-4, dt=1e-4, tracker=None).data)
        _require("fused_step" not in eq.diagnostics["solver"], "axis operators took a window")
    err = _rel_err(torch, *results)
    _require(err <= F64_TOL, f"the axis-operator PDE on the card against the CPU: {err:.3e}")
    print(f"[ops options] plain torch on the card ({OPS_OPTIONS_CHECK_N}^2 fp64 against the "
          f"CPU, max_rel; ms a call at {OPS_OPTIONS_N}^2 fp32 on {smi}; the cuda registry "
          f"refuses each): {'; '.join(parts)}; PDE {OPS_OPTIONS_PDE['c']!r} 20 steps on the "
          f"card against the CPU {err:.1e} (plain loop: "
          f"{eq.diagnostics['solver'].get('fused_unsupported')}) ok", flush=True)


MOVIE_N = 4096  # phase 51's grid: the main path's
MOVIE_DT = 0.1
MOVIE_T_END = 204.8  # 2048 steps
MOVIE_INTERVAL = 25.6  # a frame every 256 steps: 9 frames
PLOTS_N = 1024  # phase 52's PlotTracker run
PLOTS_T_END = 6.4  # 64 steps, a plot every 16
SETTER_N = 1024  # phase 53's grid, both axes bounded
SETTER_STEPS = 64
SETTER_DT = 0.1


def _dirichlet_zero_setter(full, args=None):
    """A user ghost-cell setter (``BoundariesSetter``): Dirichlet 0 on every side
    of a 2D field, each ghost minus its neighbour, written into the padded
    tensor it gets on the card."""
    full[0] = -full[1]
    full[-1] = -full[-2]
    full[:, 0] = -full[:, 1]
    full[:, -1] = -full[:, -2]
    return full


def _host_ms(torch, fn, repeats: int = 5) -> list[float]:
    """Sorted milliseconds of `repeats` calls of `fn()`, the card synchronized
    around each."""
    times = []
    for _ in range(repeats):
        times.append(1e3 * _synced_seconds(torch, fn)[1])
    return sorted(times)


def _movie_phase(pde, torch, np, device, smi):
    """Phase 51: the README flow with a movie on the main path: 4096² periodic
    fp32 ``DiffusionPDE(0.1)``, 2048 steps through ``solve(backend="cuda")``
    (kernel #1) with a ``MovieStorage`` and a ``MemoryStorage`` every 256 steps;
    the movie read back against the memory frames, its bytes against a host
    numpy quantization of them; the same solve on [2, 2] through #12 writes
    the same file; ms a frame split into on-card quantization, copy and
    encode; the solve's rate against ``tracker=None``. Returns the serial
    run's final state."""
    import filecmp
    import os
    import tempfile

    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.storage.base import field_to_host

    grid = pde.UnitGrid([MOVIE_N, MOVIE_N], periodic=True)
    state = pde.ScalarField.random_uniform(grid, dtype=torch.float32, device=device,
                                           rng=np.random.default_rng(51))
    cells, steps = MOVIE_N * MOVIE_N, round(MOVIE_T_END / MOVIE_DT)

    def solve(trackers, **kw):
        eq = pde.DiffusionPDE(0.1)
        result, seconds = _synced_seconds(torch, lambda: eq.solve(
            state, t_range=MOVIE_T_END, dt=MOVIE_DT, tracker=trackers, backend="cuda", **kw))
        return result, seconds, eq.diagnostics["controller"]

    with tempfile.TemporaryDirectory() as folder:
        movie = pde.MovieStorage(os.path.join(folder, "serial.mov"))
        memory = pde.MemoryStorage()
        cc.affine_laplace_2d.launches = 0
        result, seconds, info = solve([movie.tracker(MOVIE_INTERVAL),
                                       memory.tracker(MOVIE_INTERVAL)])
        launches = cc.affine_laplace_2d.launches
        # the movie alone against tracker=None, in turns, best of 2
        alone_seconds, none_seconds = math.inf, math.inf
        for _ in range(2):
            alone = pde.MovieStorage(os.path.join(folder, "alone.mov"))  # overwritten
            alone_seconds = min(alone_seconds, solve([alone.tracker(MOVIE_INTERVAL)])[1])
            none_seconds = min(none_seconds, solve(None)[1])
        reader = pde.MovieStorage(movie.filename)
        frames, decode_seconds = _synced_seconds(torch, reader._read_frames)
        step = (movie.vmax - movie.vmin) / movie._format.max_value
        worst, bytes_equal = 0.0, len(frames) == len(memory.data)
        for frame, host in zip(frames, memory.data):
            worst = max(worst, float(np.abs(movie._dequantize(frame) - host).max()))
            bytes_equal &= frame.tobytes() == movie._quantize(host).tobytes()
        checks = [launches > 0, info["successful"], len(movie) == len(memory) == 9,
                  movie.times == list(memory.times) == reader.times, worst <= step,
                  bytes_equal, result.data.device.type == "cuda"]
        print(f"[movie] DiffusionPDE(0.1) {MOVIE_N}^2 periodic fp32, {steps} steps through "
              f"solve(backend='cuda') with MovieStorage (backend {movie._backend!r}, "
              f"{movie.bits_per_channel} bits, {movie._format.pix_fmt_file}) and MemoryStorage "
              f"every 256 steps: {len(movie)} frames; read back (decoded in "
              f"{decode_seconds:.3f} s), max |dequantized - memory frame| {worst:.3e} against "
              f"one quantization step {step:.3e}; frame bytes equal to a host numpy "
              f"quantization of the memory frames: {bytes_equal}; #1 launches {launches}; "
              f"{os.path.getsize(movie.filename) / 2**20:.1f} MiB "
              f"{'ok' if all(checks) else 'FAIL'}", flush=True)
        _require(all(checks), f"the movie on the main path: {checks}")

        pde.config["parallel.devices_per_device"] = 4
        try:
            sharded = pde.MovieStorage(os.path.join(folder, "sharded.mov"))
            ce.affine_laplace_ext_2d.launches = 0
            _, sharded_seconds, _ = solve([sharded.tracker(MOVIE_INTERVAL)],
                                          decomposition=[2, 2])
            ext_launches = ce.affine_laplace_ext_2d.launches
        finally:
            pde.config["parallel.devices_per_device"] = 1
        # the times go to a sidecar: `.times` for an encoded movie, `.json` for raw frames
        sidecars = [path for path in (movie._times_path, movie._meta_path)
                    if os.path.exists(path)]
        same = (filecmp.cmp(movie.filename, sharded.filename, shallow=False) and all(
            filecmp.cmp(path, path.replace("serial", "sharded"), shallow=False)
            for path in sidecars))
        ok = same and ext_launches > 0 and len(sidecars) == 1
        print(f"[movie] the same solve on [2, 2] (#12 launches {ext_launches}) with the movie "
              f"alone: movie and {os.path.splitext(sidecars[0])[1]} files byte-equal to the "
              f"serial run's: {same}; "
              f"{sharded_seconds:.3f} s {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, "the decomposed run's movie differs from the serial run's")

        # one frame's costs, on the last stored state: quantization on the card,
        # the copy of the quantized frame, the encode; beside the fp32 frame's copy
        last = pde.ScalarField(grid, torch.as_tensor(memory.data[-1], device=device))
        timing = pde.MovieStorage(os.path.join(folder, "timing.mov"))
        timing.start_writing(last)
        quantize_ms = _cuda_ms(torch, lambda: timing._frame_on_device(last.data), 20)
        frame = timing._frame_on_device(last.data)
        copy_ms = _host_ms(torch, lambda: timing._frame_to_host(frame))
        field_copy_ms = _host_ms(torch, lambda: field_to_host(last))
        payload = timing._frame_to_host(frame).tobytes()
        encode_ms = _host_ms(torch, lambda: timing._write_payload(payload), 3)
        timing.end_writing()
    tracker_ms = 1e3 * info["profiler"]["tracker"] / len(movie)
    frame_mib = frame.element_size() * cells / 2**20
    print(f"[movie rates] on {smi}: a {MOVIE_N}^2 frame: on-card quantization "
          f"{quantize_ms:.4f} ms (CUDA events), copy of the {frame_mib:g} MiB quantized "
          f"frame best/median of 5 {copy_ms[0]:.3f}/{copy_ms[2]:.3f} ms (the "
          f"fp32 frame a MemoryStorage copies {field_copy_ms[0]:.3f}/{field_copy_ms[2]:.3f}), "
          f"encode ({movie._backend}) best/median of 3 {encode_ms[0]:.3f}/{encode_ms[1]:.3f} ms; "
          f"trackers' host ms an interrupt in the serial solve {tracker_ms:.1f}; "
          f"cell-updates/s: the movie alone {cells * steps / alone_seconds:.4e} against "
          f"tracker=None {cells * steps / none_seconds:.4e} (best of 2 in turns), with the "
          f"movie and memory storages {cells * steps / seconds:.4e}, [2, 2] with the movie "
          f"{cells * steps / sharded_seconds:.4e}", flush=True)
    return result


def _plots_phase(pde, torch, np, device, smi, result) -> None:
    """Phase 52: with matplotlib, ``result.plot(filename=...)`` of the movie
    phase's 4096² state and a ``PlotTracker(output_file=...)`` run on a 1024²
    state draw the card state's host copies (Agg); without it, both raise
    the error ``pde_tpu`` raises (matplotlib's ModuleNotFoundError), and the
    package and phase 51 ran without it."""
    import importlib.util
    import os
    import tempfile

    from pde_tpu_torch.ops import cuda_cartesian as cc

    grid = pde.UnitGrid([PLOTS_N, PLOTS_N], periodic=True)
    state = pde.ScalarField.random_uniform(grid, dtype=torch.float32, device=device,
                                           rng=np.random.default_rng(52))
    with tempfile.TemporaryDirectory() as folder:
        filename = os.path.join(folder, "result.png")
        tracker = None
        eq = pde.DiffusionPDE(0.1)

        def run_tracker():
            nonlocal tracker
            tracker = pde.PlotTracker(PLOTS_T_END / 4, output_file=os.path.join(folder, "t.png"))
            return eq.solve(state, t_range=PLOTS_T_END, dt=MOVIE_DT, tracker=[tracker],
                            backend="cuda")

        if importlib.util.find_spec("matplotlib") is None:
            errors = []
            for call in (lambda: result.plot(filename=filename), run_tracker):
                try:
                    call()
                    errors.append(None)
                except ModuleNotFoundError as err:
                    errors.append(err.name)
            ok = errors == ["matplotlib", "matplotlib"] and "matplotlib" not in sys.modules
            print(f"[plots] branch: matplotlib absent on this machine; result.plot(filename=...) "
                  f"and a PlotTracker solve each raise ModuleNotFoundError for {errors}, as "
                  f"pde_tpu's do; import pde_tpu_torch and [movie] ran without it "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            _require(ok, f"the plots without matplotlib: {errors}")
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ref, plot_seconds = _synced_seconds(torch, lambda: result.plot(filename=filename))
        drawn = np.ma.getdata(ref.element.get_array())
        plot_ok = np.array_equal(drawn, result.to_numpy().T) and os.path.getsize(filename) > 0
        cc.affine_laplace_2d.launches = 0
        final, tracker_seconds = _synced_seconds(torch, run_tracker)
        launches = cc.affine_laplace_2d.launches
        tracked = np.ma.getdata(tracker._plot_ref.element.get_array())
        tracker_ok = (np.array_equal(tracked, final.to_numpy().T)
                      and os.path.getsize(os.path.join(folder, "t.png")) > 0)
        plt.close("all")
    ok = plot_ok and tracker_ok and launches > 0
    print(f"[plots] branch: matplotlib {matplotlib.__version__} (Agg) on {smi}: "
          f"result.plot(filename=...) of the {MOVIE_N}^2 state draws its host copy: {plot_ok} "
          f"({plot_seconds:.3f} s); PlotTracker(output_file=...) on {PLOTS_N}^2, "
          f"{round(PLOTS_T_END / MOVIE_DT)} steps (#1 launches {launches}), its last plot "
          f"the final state's host copy: {tracker_ok} ({tracker_seconds:.3f} s) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    _require(ok, "the plots do not draw the card state")


def _bc_setter_phase(pde, torch, np, device, smi) -> None:
    """Phase 53: a user ghost-cell setter (``BoundariesSetter``, Dirichlet 0)
    on a 1024² state in the plain loop on the card, against ``bc={"value": 0}``
    through kernel #1 (fp32 within 1e-6 a step of max|f|, fp64 1e-12); the
    ``cuda`` engine refuses the setter."""
    from pde_tpu_torch.ops import cuda_cartesian as cc

    grid = pde.UnitGrid([SETTER_N, SETTER_N])
    t_end = SETTER_STEPS * SETTER_DT
    parts = []
    for dtype in (torch.float32, torch.float64):
        state = pde.ScalarField.random_uniform(grid, dtype=dtype, device=device,
                                               rng=np.random.default_rng(53))
        eq = pde.DiffusionPDE(0.1, bc=_dirichlet_zero_setter)
        ref_eq = pde.DiffusionPDE(0.1, bc={"value": 0})
        for warm_eq, backend in ((eq, "torch"), (ref_eq, "cuda")):  # load, plan
            warm_eq.solve(state, t_range=SETTER_DT, dt=SETTER_DT, tracker=None, backend=backend)
        plain, plain_seconds = _synced_seconds(torch, lambda: eq.solve(
            state, t_range=t_end, dt=SETTER_DT, tracker=None, backend="torch"))
        unsupported = eq.diagnostics["solver"].get("fused_unsupported")
        cc.affine_laplace_2d.launches = 0
        kernel, kernel_seconds = _synced_seconds(torch, lambda: ref_eq.solve(
            state, t_range=t_end, dt=SETTER_DT, tracker=None, backend="cuda"))
        launches = cc.affine_laplace_2d.launches
        err = _rel_err(torch, plain.data, kernel.data)
        tol = F32_STEP_RTOL * SETTER_STEPS if dtype == torch.float32 else F64_TOL
        try:
            eq.solve(state, t_range=t_end, dt=SETTER_DT, tracker=None, backend="cuda")
            refused = None
        except RuntimeError as err_cuda:
            refused = str(err_cuda)
        checks = [err <= tol, launches > 0, unsupported is not None, refused is not None,
                  plain.data.device.type == "cuda"]
        _require(all(checks), f"the BoundariesSetter run ({dtype}): {checks}, {err:.3e}")
        parts.append(f"{str(dtype)[6:]} max_rel {err:.3e} (tol {tol:.1e}), plain loop "
                     f"{SETTER_STEPS / plain_seconds:.1f} steps/s against #1's "
                     f"{SETTER_STEPS / kernel_seconds:.1f} ({launches} launches)")
    print(f"[bc setter] DiffusionPDE(0.1, bc=<Dirichlet-0 ghost setter>) {SETTER_N}^2, "
          f"{SETTER_STEPS} steps in the plain loop on the card ({unsupported!r}) against "
          f"bc={{'value': 0}} through #1 on {smi}: " + "; ".join(parts)
          + f"; backend='cuda' refuses the setter: {refused!r} ok", flush=True)


# -- phases 54-57: the side inputs of #9/#10 (B2(b)), Milstein and the rest of the noise (A7) ---
# grid sizes (a CPU rehearsal shrinks them), the tables' start in phase 54, and the SDE
# main path's dt (phase 10's) and window
SDE_SIDES_N = 4096
SDE_SIDES_SMALL = ((1000, 1530), (16, 16))  # phase 54's ragged bounded grids
SDE_SIDES_T0 = 0.35
SDE_DT = 1e-3
SDE_WINDOW = 2048
# the main path's time-dependent Dirichlet x sides (y periodic), and their scalar twin
SDE_MAIN_BC = {"x": {"value_expression": "0.1*sin(3*t)"}, "y": "periodic"}
SDE_SCALAR_BC = {"x": {"value": 0.0}, "y": "periodic"}
# phase 54's bounded grids: a per-point array, a time-dependent and a space-and-time side
SDE_MIXED_BC = {"x-": {"value": "0.1*sin(y)"}, "x+": {"value_expression": "0.1*sin(3*t)"},
                "y-": {"value_expression": "0.1*sin(x - 2*t)"}, "y+": {"derivative": 0}}
SDE_SIDE_ROUTES = SDE_ROUTES[:2]  # normal increments staged (#10), irwin4 in the kernel (#9)
MULT_N = 1024  # phase 56's grid
MULT_CHECK_N = 256  # ... its fp64 step against the formula, and its [2, 2] mesh
MULT_DT = 0.01
MULT_STEPS = 64
CORR_N = 1024  # phase 57's grid
CORR_STEPS = 1000
CORR_DRAWS = 64


def _multiplicative_diffusion(pde):
    """``pde_tpu``'s test model (``tests/ops/test_pallas_kernels.py:1754-1769``)
    against the port: diffusion with variance ``noise (1 + c²)``, derivative
    ``2 noise c``, computed with torch on the leaves' device."""

    class MultiplicativeDiffusion(pde.DiffusionPDE):
        def make_noise_variance(self, state, *, ret_diff=False):
            base = super().make_noise_variance(state, ret_diff=False)

            def var_fn(leaves, t):
                return [v * (1 + y**2) for v, y in zip(base(leaves, t), leaves, strict=True)]

            if not ret_diff:
                return var_fn

            def var_diff_fn(leaves, t):
                return var_fn(leaves, t), [v * 2 * y for v, y in
                                           zip(base(leaves, t), leaves, strict=True)]

            return var_diff_fn

    return MultiplicativeDiffusion


def _sde_side_units(pde, torch, device) -> dict:
    """The Euler-Maruyama windows of phases 54-55, both routes, on fp32
    states on the card: the main path's (x sides varying in time), its twin
    with scalar sides, and the bounded grids' with every kind of side input
    (4096² and the ragged grids share one source); and their build units."""
    n = SDE_SIDES_N
    periodic_y = pde.UnitGrid([n, n], periodic=[False, True])
    grids = {"main": (periodic_y, SDE_MAIN_BC), "scalar": (periodic_y, SDE_SCALAR_BC)}
    for rows, cols in ((n, n), *SDE_SIDES_SMALL):
        grids[f"mixed {rows}x{cols}"] = (pde.UnitGrid([rows, cols]), SDE_MIXED_BC)
    windows = {}
    for label, (grid, bc) in grids.items():
        state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=device)
        for route, cfg, _ in SDE_SIDE_ROUTES:
            with pde.config(cfg):
                eq = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1, bc=bc)
                windows[(label, route)] = eq.make_fused_euler_window(state, SDE_DT)
    units = list({w.program.digest: w.program for w in windows.values()}.values())
    return {"windows": windows, "units": units}


def _side_views(window, dtype, device, k, t0=SDE_SIDES_T0):
    """One pass's views of a window's side inputs: k steps from t0."""
    return window.program.stencil.sides.passes(t0, k, SDE_DT, dtype, device)(0, k)


def _sde_sides_phase(pde, torch, np, device, smi, units) -> dict:
    """Phase 54: both Euler-Maruyama kernels with side inputs against their
    plain versions, at every k of the ladder, fp32 and fp64; kernel #9's
    stream with side inputs against #10 fed the same Philox increments."""
    from pde_tpu_torch.ops import cuda_sde_2d as sde
    from pde_tpu_torch.ops import philox

    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=device).manual_seed(54)
    ctl = (0x1234ABCD, 0x0BADF00D, 1000)
    errs, lines = {}, []
    for (label, route), window in units["windows"].items():
        if label == "scalar":
            continue
        program = window.program
        for dtype in (f32, f64):
            data = torch.rand(program.stencil.geometry.shape, generator=gen, dtype=dtype,
                              device=device) - 0.5
            for k in program.stencil.ladder:
                spec = sde.sde_spec(program, k, dtype, window.specs[0].scale)
                views = _side_views(window, dtype, device, k)
                if program.noise == "staged":
                    noise = 0.01 * torch.randn((k, *spec.shape), generator=gen, dtype=dtype,
                                               device=device)
                    out = sde.sde_stencil_2d(data, noise, spec, sides=views)
                    ref = sde.sde_stencil_2d_plain(data, noise, spec, views)
                else:
                    out = sde.sde_kernel_noise_2d(data, ctl, spec, sides=views)
                    ref = sde.sde_kernel_noise_2d_plain(data, ctl, spec, views)
                err = _check_rel(torch, f"SDE sides {label} {route} k={k} {dtype}", out, ref,
                                 dtype, k)
                errs[(label, route, dtype, k)] = err
            lines.append(f"{label} {route} {str(dtype)[6:]} k={program.stencil.ladder}: max_abs "
                         + "/".join(f"{errs[(label, route, dtype, k)]:.1e}"
                                    for k in program.stencil.ladder))
    print(f"[sde sides] KPZ(nu=1, lmbda=1, noise=0.1) with side inputs, tables from "
          f"t0={SDE_SIDES_T0}, one pass of each kernel against its plain version on {smi}: "
          + "; ".join(lines) + " ok", flush=True)
    # kernel #9's stream with side inputs: the Philox increments of (seed, global step,
    # global cell), as kernel #10 adds them when they are staged
    stream = []
    for label in [f"mixed {SDE_SIDES_N}x{SDE_SIDES_N}"] + [
            f"mixed {r}x{c}" for r, c in SDE_SIDES_SMALL]:
        kn_window = units["windows"][(label, "irwin4")]
        st_window = units["windows"][(label, "normal")]
        kn_spec, st_spec = kn_window.specs[0], st_window.specs[0]
        data = torch.rand(kn_spec.shape, generator=gen, dtype=f32, device=device) - 0.5
        rows, cols = (torch.arange(m, device=device) for m in kn_spec.shape)
        staged = torch.stack([philox.cell_increments("irwin4", ctl[:2], ctl[2] + s, rows, cols,
                                                     f32, kn_spec.scale)
                              for s in range(kn_spec.k)])
        out = sde.sde_kernel_noise_2d(data, ctl, kn_spec,
                                      sides=_side_views(kn_window, f32, device, kn_spec.k))
        ref = sde.sde_stencil_2d(data, staged, st_spec,
                                 sides=_side_views(st_window, f32, device, st_spec.k))
        err = _check_rel(torch, f"#9's stream with side inputs, {label}", out, ref, f32,
                         kn_spec.k)
        stream.append(f"{label} k={kn_spec.k} {err:.2e}")
    print("[sde sides] #9 with side inputs against #10 fed the Philox increments of (seed, "
          "global step, global cell), fp32 max_abs: " + "; ".join(stream) + " ok", flush=True)
    return errs


def _sde_sides_main(pde, torch, np, device, smi, units, builds, errs,
                    scalar_builds) -> list[dict]:
    """Phase 55: the main path, KPZ 4096² fp32 with time-dependent Dirichlet x
    sides through ``solve(solver="milstein", backend="cuda")`` for 2048 steps,
    normal (#10 with side inputs, against the Milstein plain loop on the same
    stream) and irwin4 (#9 with side inputs); each kernel's side-input
    launches counted from 0; the top-k pass with side inputs beside the
    scalar-side one, plain version and bound; windows' rates; registers,
    spills and SASS of the side-input and the scalar kernels (`builds`:
    each build unit's by digest, `scalar_builds`: phases 9-11's periodic
    main-path libraries by route). Returns the kernels line's rows."""
    from pde_tpu_torch.ops import cuda_sde_2d as sde

    f32 = torch.float32
    n = SDE_SIDES_N
    cells = n * n
    grid = pde.UnitGrid([n, n], periodic=[False, True])
    state = pde.ScalarField(grid, 0.0, dtype=f32, device=device)
    t_end = SDE_WINDOW * SDE_DT
    gen = torch.Generator(device=device).manual_seed(55)
    ctl = (0x1234ABCD, 0x0BADF00D, 1000)
    launches, parts, rows = {}, [], []
    for route, cfg, kernel in SDE_SIDE_ROUTES:
        counter = getattr(sde, kernel)
        with pde.config(cfg):
            eq = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1, bc=SDE_MAIN_BC,
                                     rng=np.random.default_rng(55))
            counter.launches = counter.sides_launches = 0
            (result, info), seconds = _synced_seconds(torch, lambda: eq.solve(
                state, t_range=t_end, dt=SDE_DT, tracker=None, solver="milstein",
                backend="cuda", ret_info=True))
            launches[route] = counter.sides_launches
            checks = [launches[route] > 0, counter.launches == launches[route],
                      info["solver"].get("fused_step") is True,
                      info["solver"]["steps"] == SDE_WINDOW,
                      result.data.shape == (n, n) and result.data.dtype == f32,
                      bool(torch.isfinite(result.data).all()), float(result.fluctuations) > 0]
            note = ""
            if route == "normal":  # the staged stream is the Milstein plain loop's
                plain_eq = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1, bc=SDE_MAIN_BC,
                                               rng=np.random.default_rng(55))
                ref, plain_seconds = _synced_seconds(torch, lambda: plain_eq.solve(
                    state, t_range=t_end, dt=SDE_DT, tracker=None, solver="milstein",
                    backend="numpy"))
                err = _check_rel(torch, "the SDE main path with side inputs against the "
                                 "Milstein plain loop", result.data, ref.data, f32, SDE_WINDOW)
                note = (f", max_abs {err:.3e} against the Milstein plain loop on the same stream "
                        f"({plain_seconds:.2f} s)")
            _require(all(checks), f"the SDE main path with side inputs ({route}): {checks}")
            stepper = pde.MilsteinSolver(eq, backend="cuda").make_stepper(state, dt=SDE_DT)
            rate = _rate_from(torch, stepper, state, SDE_DT, 0.0, cells, steps=SDE_WINDOW)
            scalar_eq = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1, bc=SDE_SCALAR_BC,
                                            rng=np.random.default_rng(55))
            scalar_rate = _rate_from(torch, pde.MilsteinSolver(scalar_eq, backend="cuda")
                                     .make_stepper(state, dt=SDE_DT), state, SDE_DT, 0.0, cells,
                                     steps=SDE_WINDOW)
        window = units["windows"][("main", route)]
        spec = window.specs[0]
        scalar_spec = units["windows"][("scalar", route)].specs[0]
        data = torch.rand((n, n), generator=gen, dtype=f32, device=device) - 0.5
        out = torch.empty_like(data)
        views = _side_views(window, f32, device, spec.k, 0.0)
        if route == "normal":
            noise = 0.01 * torch.randn((spec.k, n, n), generator=gen, dtype=f32, device=device)
            ms = _cuda_ms(torch, lambda: sde.sde_stencil_2d(data, noise, spec, out=out,
                                                            sides=views), 20)
            scalar_ms = _cuda_ms(torch, lambda: sde.sde_stencil_2d(data, noise, scalar_spec,
                                                                   out=out), 20)
            plain_ms = _cuda_ms(torch, lambda: sde.sde_stencil_2d_plain(data, noise, spec,
                                                                        views), 3)
        else:
            ms = _cuda_ms(torch, lambda: sde.sde_kernel_noise_2d(data, ctl, spec, out=out,
                                                                 sides=views), 20)
            scalar_ms = _cuda_ms(torch, lambda: sde.sde_kernel_noise_2d(data, ctl, scalar_spec,
                                                                        out=out), 20)
            plain_ms = _cuda_ms(torch, lambda: sde.sde_kernel_noise_2d_plain(data, ctl, spec,
                                                                             views), 3)
        flops = _program_flops(spec.program.stencil) + 1
        if route == "normal":
            bound = _bound((2 + spec.k) * cells * 4, flops * spec.k * cells)
        else:
            bound = _bound(2 * cells * 4, (flops + PHILOX_OPS + IRWIN4_OPS + 1) * spec.k * cells)
        tag = f"EfLi{spec.k}ELi{spec.tile}E"
        side_build = builds[spec.program.digest]
        scalar_build = builds[scalar_spec.program.digest]
        ptx = " | ".join(_ptxas_of(side_build["log"], "sde_window_sides_2d_kernel", tag))
        scalar_ptx = " | ".join(_ptxas_of(scalar_build["log"], "sde_window_2d_kernel", tag))
        main_ptx = " | ".join(_ptxas_of(scalar_builds[route]["log"], "sde_window_2d_kernel", tag))
        sass = _sass_summary(side_build["path"], ("sde_window_sides_2d_kernel", tag))
        main_sass = _sass_summary(scalar_builds[route]["path"], ("sde_window_2d_kernel", tag))
        passes = _ladder_passes([s.k for s in window.specs], SDE_WINDOW)
        parts.append(
            f"{route} ({kernel}): {SDE_WINDOW} steps through solve(solver='milstein', "
            "backend='cuda') "
            f"{seconds:.2f} s, {launches[route]} side-input launches ({passes} passes a "
            f"{SDE_WINDOW}-step window, ladder {[s.k for s in window.specs]}){note}; one k="
            f"{spec.k} pass {ms:.4f} ms with the side inputs, {scalar_ms:.4f} ms with scalar "
            f"Dirichlet sides, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); "
            f"windows {rate:.4e} cell-updates/s against {scalar_rate:.4e} with scalar sides; "
            f"ptxas float k={spec.k} tile={spec.tile}: sides {ptx}; scalar sides {scalar_ptx}; "
            f"the periodic main path's (phase 11) {main_ptx}; SASS: sides {sass}; the periodic "
            f"main path's {main_sass}")
        rows.append({
            "name": f"{kernel} (side inputs)",
            "route": "cuda",
            "source": "pde_tpu_torch/csrc/multi_stencil_2d.cuh",
            "replaces": ("pde_tpu/ops/pallas_cartesian.py:4831" if route == "normal" else
                         "pde_tpu/ops/pallas_cartesian.py:4660")
            + " (side inputs: :4463, :5011-5040)",
            "launches": launches[route],
            "max_abs_err": errs[("main", route, f32, spec.k)],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": None,  # time-dependent ghosts and noise are no library call's
        })
    print(f"[sde sides main] KPZInterfacePDE(nu=1, lmbda=1, noise=0.1) {n}^2 fp32, x sides "
          f"0.1*sin(3*t) (Dirichlet), y periodic, dt {SDE_DT}, on {smi}: " + "; ".join(parts)
          + " ok", flush=True)
    return rows


def _milstein_phase(pde, torch, np, device, smi) -> None:
    """Phase 56: multiplicative noise and Milstein on the card (plain torch):
    ``pde_tpu``'s ``MultiplicativeDiffusion`` at 1024² fp32 through
    Euler-Maruyama and Milstein in the three interpretations (the variance
    and its derivative are card tensors: fault C15); one fp64 Milstein step
    at 256² against the formula on the same draws; [2, 2] bit-equal to
    serial."""
    f32, f64 = torch.float32, torch.float64
    mult = _multiplicative_diffusion(pde)
    grid = pde.UnitGrid([MULT_N, MULT_N], periodic=True)
    state = pde.ScalarField.random_uniform(grid, 0.5, 1.5, dtype=f32, device=device,
                                           rng=np.random.default_rng(56))
    t_end = MULT_STEPS * MULT_DT
    means, parts = {}, []
    for solver in ("euler", "milstein"):
        for interpretation in ("ito", "stratonovich", "anti-ito"):
            eq = mult(0.1, noise=0.1, rng=np.random.default_rng(56))
            eq.noise_interpretation = interpretation
            (result, info), seconds = _synced_seconds(torch, lambda: eq.solve(
                state, t_range=t_end, dt=MULT_DT, tracker=None, solver=solver,
                backend="torch", ret_info=True))
            _require(bool(torch.isfinite(result.data).all()) and result.data.is_cuda
                     and "fused_step" not in info["solver"],
                     f"multiplicative noise on the card ({solver}, {interpretation})")
            means[(solver, interpretation)] = float(result.average)
            parts.append(f"{solver} {interpretation} mean {means[(solver, interpretation)]:.6f} "
                         f"({MULT_STEPS / seconds:.1f} steps/s)")
        _require(means[(solver, "ito")] < means[(solver, "stratonovich")]
                 < means[(solver, "anti-ito")], f"the interpretations' order ({solver})")
    # one fp64 Milstein step against the formula on the same draws
    small = pde.UnitGrid([MULT_CHECK_N, MULT_CHECK_N], periodic=True)
    state64 = pde.ScalarField.random_uniform(small, 0.5, 1.5, dtype=f64, device=device,
                                             rng=np.random.default_rng(57))
    eq = mult(0.1, noise=0.1)
    eq.noise_interpretation = "stratonovich"
    step = pde.MilsteinSolver(eq)._make_single_step_fixed_dt(state64, MULT_DT)
    (out,) = step([state64.data], 0.0, torch.Generator(device=device).manual_seed(5))
    z = torch.empty_like(state64.data).normal_(generator=torch.Generator(device=device)
                                               .manual_seed(5))
    y = state64.data
    rate = eq.evolution_rate(state64).data
    var, diff = 0.1 * (1 + y**2), 0.2 * y
    dw = MULT_DT**0.5 * z
    expected = (y + MULT_DT * rate + 0.5 * MULT_DT * 0.5 * diff + var.sqrt() * dw
                + 0.25 * diff * (dw**2 - MULT_DT))
    step_err = _check_rel(torch, "a Milstein step on the card against the formula", out,
                          expected, f64, 1)
    # [2, 2] through the plain sharded stepper, bit-equal to serial
    state32 = pde.ScalarField.random_uniform(small, 0.5, 1.5, dtype=f32, device=device,
                                             rng=np.random.default_rng(58))
    runs = []
    pde.config["parallel.devices_per_device"] = 4
    try:
        for decomposition in (None, [2, 2]):
            eq = mult(0.1, noise=0.1, rng=np.random.default_rng(59))
            eq.noise_interpretation = "stratonovich"
            runs.append(eq.solve(state32, t_range=t_end, dt=MULT_DT, tracker=None,
                                 solver="milstein", backend="torch",
                                 decomposition=decomposition).data)
    finally:
        pde.config["parallel.devices_per_device"] = 1
    equal = bool(torch.equal(runs[0], runs[1]))
    _require(equal, "Milstein on [2, 2] is not bit-equal to serial")
    print(f"[milstein] MultiplicativeDiffusion(0.1, noise=0.1) (variance 0.1(1 + c^2) from "
          f"card tensors) {MULT_N}^2 fp32, {MULT_STEPS} steps at dt {MULT_DT} on {smi}: "
          + "; ".join(parts) + "; Ito < Stratonovich < anti-Ito for both ok; one fp64 "
          f"Stratonovich step at {MULT_CHECK_N}^2 against the formula max_abs {step_err:.3e}; "
          f"{MULT_CHECK_N}^2 fp32 on [2, 2] bit-equal to serial: {equal} ok", flush=True)


def _correlated_noise_phase(pde, torch, np, device, smi) -> None:
    """Phase 57: ``examples/custom_noise.py``'s model against the port at
    1024² fp32 on the card (a correlated realization from
    ``make_correlated_noise_torch`` each step); the realization's spectrum,
    in rings of |k| over 64 draws, against the target's (6 standard
    errors), and its unit variance."""
    from pde_tpu_torch.utils.spectral import make_correlated_noise_torch

    f32 = torch.float32
    n = CORR_N

    class CorrelatedNoiseDiffusion(pde.DiffusionPDE):
        use_noise_variance = False
        use_noise_realization = True

        def make_noise_realization(self, state, backend="torch"):
            noise_fn = make_correlated_noise_torch(
                tuple(state.data.shape), correlation="gaussian",
                discretization=state.grid.discretization, length_scale=2.0,
                dtype=state.data.dtype)
            amplitude = float(np.sqrt(self.noise))

            def realization(leaves, t, generator):
                return [amplitude * noise_fn(generator) for _ in leaves]

            return realization

    grid = pde.UnitGrid([n, n], periodic=True)
    state = pde.ScalarField(grid, 0.0, dtype=f32, device=device)
    eq = CorrelatedNoiseDiffusion(0.1, noise=0.1, rng=np.random.default_rng(0))
    (result, info), seconds = _synced_seconds(torch, lambda: eq.solve(
        state, t_range=CORR_STEPS * 1e-3, dt=1e-3, tracker=None, ret_info=True))
    fluctuations = float(result.fluctuations)
    _require(bool(torch.isfinite(result.data).all()) and result.data.is_cuda
             and info["solver"]["stochastic"] and fluctuations > 0,
             "the correlated-noise model on the card")
    noise_fn = make_correlated_noise_torch((n, n), "gaussian", length_scale=2.0, dtype=f32)
    generator = torch.Generator(device=device).manual_seed(57)
    draw_ms = _cuda_ms(torch, lambda: noise_fn(generator), 20)
    power = torch.zeros((n, n), dtype=torch.float64, device=device)
    variance = 0.0
    for _ in range(CORR_DRAWS):
        field = noise_fn(generator).double()
        variance += float(field.var()) / CORR_DRAWS
        power += torch.fft.fftn(field).abs() ** 2 / CORR_DRAWS
    k = torch.fft.fftfreq(n, dtype=torch.float64, device=device)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    target = torch.exp(-0.5 * 2.0**2 * k2)  # the Gaussian's power spectrum, length scale 2
    target[0, 0] = 0
    target *= n**4 / target.sum()  # unit variance: sum of the power = cells²
    ring = torch.round(k2.sqrt() * n).long().reshape(-1)
    rings = int(ring.max()) + 1
    counts = torch.bincount(ring, minlength=rings).double()
    got = torch.bincount(ring, power.reshape(-1), minlength=rings) / counts
    want = torch.bincount(ring, target.reshape(-1), minlength=rings) / counts
    # a mode's power over the draws: an exponential law (the field is real, so
    # k and -k are one mode): relative standard error sqrt(2 / (draws * modes))
    se = torch.sqrt(2.0 / (CORR_DRAWS * counts))
    strong = want > 1e-3 * float(want.max())
    dev = ((got - want).abs() / want / se)[strong]
    worst = float(dev.max())
    _require(worst <= MOMENT_SIGMAS and abs(variance - 1.0) < 0.05,
             f"the correlated realization's spectrum: {worst:.2f} se, variance {variance:.4f}")
    print(f"[correlated noise] CorrelatedNoiseDiffusion(0.1, noise=0.1) (examples/"
          f"custom_noise.py against the port) {n}^2 fp32, {CORR_STEPS} steps on {smi}: "
          f"{CORR_STEPS / seconds:.1f} steps/s, fluctuations {fluctuations:.4e}; one "
          f"realization {draw_ms:.4f} ms; {CORR_DRAWS} draws: variance {variance:.4f} (target "
          f"1), mean power in {int(strong.sum())} rings of |k| within {worst:.2f} standard "
          f"errors of the target's (limit {MOMENT_SIGMAS:g}) ok", flush=True)


# -- phases 58-60: the decomposed side inputs of #12 and #8 (A9.3), reductions, split_mpi ------
# grid sizes (a CPU rehearsal shrinks them), the meshes of phase 58, the tables' start there,
# the main paths' steps (§3(a): the main path's dt; §3(b): phase 42's)
SHARDED_SIDES_N = 4096
SHARDED_SIDES_RAGGED = (64, 70)  # phase 58's ragged bounded grid: blocks down to 32x35
SHARDED_SIDES_MESHES = ([2, 1], [1, 2], [2, 2])
SHARDED_SIDES_T0 = 0.35
SHARDED_DIFFUSION_DT = 0.1
SHARDED_CH_DT = 1e-3
SHARDED_WINDOW = 2048
A9_PLAIN_N = 1024  # phase 60's Cartesian grids
A9_POLAR_N = 4096  # ... its polar grid's cells
A9_PLAIN_STEPS = 64
A9_SPLIT_N = 4096


def _sharded_diffusion_bc(np, rows: int) -> dict:
    """§3(a)'s conditions: x- ``0.1*sin(3*t)``, x+ no-flux, y- a per-point
    Dirichlet array (along the rows), y+ value 0."""
    return {"x-": {"value_expression": "0.1*sin(3*t)"}, "x+": {"derivative": 0},
            "y-": {"value": 0.1 * np.sin(np.linspace(0.0, 2.0 * np.pi, rows))},
            "y+": {"value": 0}}


def _sharded_ch_bc(np, cols: int) -> dict:
    """§3(b)'s conditions: a time-dependent Dirichlet side, a per-point array
    side (along the columns) and a side varying in space and time."""
    return {"x-": {"value_expression": "0.1*sin(3*t)"},
            "x+": {"value": 0.1 * np.cos(np.linspace(0.0, 2.0 * np.pi, cols))},
            "y-": {"value_expression": "cos(x)*sin(t)"}, "y+": {"derivative": 0}}


def _sharded_factor_bc(np, cols: int) -> dict:
    """Phase 58's ghost factors: a Robin side whose gamma varies along it, and
    one whose gamma varies in time."""
    return {"x-": {"type": "mixed", "value": 1.0 + 0.5 * np.sin(np.linspace(0.0, 6.0, cols)),
                   "const": 0.1},
            "x+": {"derivative": 0}, "y-": {"mixed_expression": "1 + t", "const": 0.2},
            "y+": {"value": 0}}


def _sharded_side_units(pde, torch, np, device) -> dict:
    """The build units of phases 58-59: #12's side-input ext library (both
    axes bounded) and #8's side-input programs (Cahn-Hilliard Euler and RK4
    with §3(b)'s sides, Euler with ghost factors) on 4096² and the ragged
    grid."""
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh

    grids = {f"{SHARDED_SIDES_N}^2": pde.UnitGrid([SHARDED_SIDES_N] * 2),
             "ragged {}x{}".format(*SHARDED_SIDES_RAGGED): pde.UnitGrid(
                 list(SHARDED_SIDES_RAGGED))}
    programs = {}
    for label, grid in grids.items():
        state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=device)
        mesh = GridMesh(grid, [2, 2], devices=[device] * 4)
        ch = pde.PDE({"c": SIDES_RHS}, bc=_sharded_ch_bc(np, grid.shape[1]))
        factor = pde.PDE({"c": SIDES_RHS}, bc=_sharded_factor_bc(np, grid.shape[1]))
        programs[(label, "euler")] = ch.make_fused_euler_window(
            state, SHARDED_CH_DT, mesh=mesh).program
        programs[(label, "rk4")] = ch.make_fused_rk4_window(state, SHARDED_CH_DT,
                                                            mesh=mesh).program
        programs[(label, "factors")] = factor.make_fused_euler_window(
            state, SHARDED_CH_DT, mesh=mesh).program
    # the serial side-input windows (#7) that phase 59 holds the main paths against
    state = pde.ScalarField(grids[f"{SHARDED_SIDES_N}^2"], 0.0, dtype=torch.float32,
                            device=device)
    ch = pde.PDE({"c": SIDES_RHS}, bc=_sharded_ch_bc(np, SHARDED_SIDES_N))
    serial = [ch.make_fused_euler_window(state, SHARDED_CH_DT).program,
              ch.make_fused_rk4_window(state, SHARDED_CH_DT).program]
    units = [ce.affine_ext_source((False, False), sides=True)]
    units += list({p.digest: p for p in [*programs.values(), *serial]}.values())
    return {"grids": grids, "programs": programs, "units": units}


def _ext_side_blocks(torch, mesh, halo: int, dtype, gen, n_planes: int = 1):
    """Random planes of `mesh`'s grid in the windows' extended buffers,
    exchanged, output buffers, and every block's flags with its origin."""
    from pde_tpu_torch.parallel import HaloExchange

    exchange = HaloExchange(mesh, halo)
    device = mesh.devices[0]
    datas = [torch.rand(mesh.basegrid.shape, generator=gen, dtype=dtype, device=device) - 0.5
             for _ in range(n_planes)]
    ins, outs = exchange.allocate(n_planes, dtype), exchange.allocate(n_planes, dtype)
    exchange.load(ins, [list(p) for p in zip(*(mesh.split_field_data(d) for d in datas))])
    exchange.copy(exchange.strips(ins))
    flags = [mesh.edge_flags(b) + list(mesh.block_origin(b)) for b in range(len(mesh))]
    return ins, outs, flags


def _ext_ladder(program, local) -> tuple[list[int], int]:
    """The decomposed window's ladder and halo of `program` on blocks of `local`."""
    ladder = [k for k in program.ladder if k * program.depth <= min(local)]
    return ladder, ladder[0] * program.depth


def _sharded_sides_phase(pde, torch, np, device, smi, units) -> dict:
    """Phase 58: #12's and #8's side-input modes against their plain versions
    on the card, on the same exchanged buffers, at every k of their ladders,
    fp32 and fp64, on [2, 1], [1, 2] and [2, 2] meshes of 4096² and of the
    ragged grid; #12 with a per-point and time-dependent sides, #8 with a
    time-dependent, a per-point and a space-and-time side (Euler and RK4) and
    with per-point and time-dependent ghost factors."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh

    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=device).manual_seed(58)
    t0 = SHARDED_SIDES_T0
    errs, lines = {}, []
    for label, grid in units["grids"].items():
        bcs = grid.get_boundary_conditions(_sharded_diffusion_bc(np, grid.shape[0]))
        inputs = cc.AffineSideInputs(grid, bcs)
        for cut in SHARDED_SIDES_MESHES:
            mesh = GridMesh(grid, cut, devices=[device] * int(np.prod(cut)))
            local = mesh.local_shape
            for dtype in (f32, f64):
                ins, outs, flags = _ext_side_blocks(torch, mesh, cc.SIDES_TOP_STEPS, dtype, gen)
                row = []
                for k in (6, 3, 1):
                    spec = ce.affine_laplace_ext_spec(
                        grid, local, a=1.0, b=0.1 * SHARDED_DIFFUSION_DT, k=k,
                        halo=cc.SIDES_TOP_STEPS, dtype=dtype, bcs=bcs)
                    times = [t0 + s * SHARDED_DIFFUSION_DT for s in range(k)]
                    sides = inputs.for_pass(dtype, device, times, row_pad=cc.SIDE_PAD)
                    ce.affine_laplace_ext_2d([p[0] for p in ins], [p[0] for p in outs], flags,
                                             spec, sides=sides)
                    h = spec.halo
                    out = torch.stack([p[0][h:-h, h:-h] for p in outs])
                    ref = torch.stack([ce.affine_laplace_ext_2d_plain(p[0], spec, f, sides)
                                       for p, f in zip(ins, flags, strict=True)])
                    err = _check_rel(torch, f"#12 side inputs {label} {cut} k={k} {dtype}",
                                     out, ref, dtype, k)
                    errs[("#12", label, str(cut), dtype, k)] = err
                    row.append(f"{err:.1e}")
                lines.append(f"#12 {label} {cut} {str(dtype)[6:]} k=6/3/1 " + "/".join(row))
                for kind in ("euler", "rk4", "factors"):
                    program = units["programs"][(label, kind)]
                    ladder, halo = _ext_ladder(program, local)
                    ins, outs, flags = _ext_side_blocks(torch, mesh, halo, dtype, gen)
                    row = []
                    for k in ladder:
                        spec = ce.multi_stencil_ext_spec(program, k, dtype, local, halo)
                        views = program.sides.passes(t0, k, SHARDED_CH_DT, dtype, device)(0, k)
                        ce.multi_stencil_ext_2d(ins, outs, flags, spec, sides=views)
                        out = torch.stack([p[0][halo:-halo, halo:-halo] for p in outs])
                        ref = torch.stack([ce.multi_stencil_ext_2d_plain(p, spec, f, views)[0]
                                           for p, f in zip(ins, flags, strict=True)])
                        err = _check_rel(torch, f"#8 side inputs {kind} {label} {cut} k={k} "
                                         f"{dtype}", out, ref, dtype, k)
                        errs[("#8", kind, label, str(cut), dtype, k)] = err
                        row.append(f"{err:.1e}")
                    lines.append(f"#8 {kind} {label} {cut} {str(dtype)[6:]} k={ladder} "
                                 + "/".join(row))
    print(f"[sharded sides] the ext kernels' side-input modes against their plain versions, "
          f"tables from t0={t0}, on {smi}: " + "; ".join(lines) + " ok", flush=True)
    return errs


def _sharded_sides_main(pde, torch, np, device, smi, units, builds, errs, scalar_units,
                        ch_scalar) -> list[dict]:
    """Phase 59: §3(a) diffusion 4096² fp32 on [2, 2] through #12's side
    inputs and §3(b) Cahn-Hilliard 4096² fp32 on [2, 2] through #8's (Euler
    and RK4), 2048 steps each through ``solve(backend="cuda")``, each
    bit-equal to the serial side-input window (#1, #7) in the same call,
    their side-input launches counted from 0; one top-k pass of each mode
    beside the scalar-side ext pass, the plain version and the bound;
    registers and spills; and the scalar ext kernels' registers and SASS
    (`builds`: each build unit's by digest; `scalar_units`: the periodic and
    bounded scalar #12 libraries; `ch_scalar`: the no-flux Cahn-Hilliard ext
    window, phase 18's). Returns the kernels line's rows."""
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.parallel import GridMesh

    f32 = torch.float32
    n = SHARDED_SIDES_N
    cells = n * n
    grid = pde.UnitGrid([n, n])
    mesh = GridMesh(grid, [2, 2], devices=[device] * 4)
    local = mesh.local_shape
    pde.config["parallel.devices_per_device"] = 4
    gen = torch.Generator(device=device).manual_seed(59)
    rng = np.random.default_rng(59)
    state = pde.ScalarField(grid, rng.uniform(0.4, 0.6, (n, n)), dtype=f32, device=device)
    rows, parts = [], []

    # (a) diffusion through #12
    eq = pde.DiffusionPDE(0.1, bc=_sharded_diffusion_bc(np, n))
    t_end = SHARDED_WINDOW * SHARDED_DIFFUSION_DT
    ce.affine_laplace_ext_2d.launches = ce.affine_laplace_ext_2d.sides_launches = 0
    (result, info), seconds = _synced_seconds(torch, lambda: eq.solve(
        state, t_range=t_end, dt=SHARDED_DIFFUSION_DT, tracker=None, backend="cuda",
        decomposition=[2, 2], ret_info=True))
    launches_12 = ce.affine_laplace_ext_2d.sides_launches
    checks = [launches_12 > 0, ce.affine_laplace_ext_2d.launches == launches_12,
              info["solver"].get("fused_step") is True,
              info["solver"]["steps"] == SHARDED_WINDOW]
    serial, serial_seconds = _synced_seconds(torch, lambda: eq.solve(
        state, t_range=t_end, dt=SHARDED_DIFFUSION_DT, tracker=None, backend="cuda"))
    checks += [bool(torch.isfinite(result.data).all()), torch.equal(result.data, serial.data)]
    _require(all(checks), f"the decomposed diffusion main path with side inputs: {checks}")
    ins, outs, flags = _ext_side_blocks(torch, mesh, cc.SIDES_TOP_STEPS, f32, gen)
    bcs = grid.get_boundary_conditions(_sharded_diffusion_bc(np, n))
    scalar_bcs = grid.get_boundary_conditions({"x": {"derivative": 0}, "y": {"value": 0}})
    b = 0.1 * SHARDED_DIFFUSION_DT
    spec = ce.affine_laplace_ext_spec(grid, local, a=1.0, b=b, k=cc.SIDES_TOP_STEPS,
                                      halo=cc.SIDES_TOP_STEPS, dtype=f32, bcs=bcs)
    sides = cc.AffineSideInputs(grid, bcs).for_pass(
        f32, device, [s * SHARDED_DIFFUSION_DT for s in range(spec.k)], row_pad=cc.SIDE_PAD)
    scalar_spec = ce.affine_laplace_ext_spec(grid, local, a=1.0, b=b, k=cc.SIDES_TOP_STEPS,
                                             halo=cc.SIDES_TOP_STEPS, dtype=f32, bcs=scalar_bcs)
    top_spec = ce.affine_laplace_ext_spec(grid, local, a=1.0, b=b, k=cc.TOP_STEPS,
                                          halo=cc.TOP_STEPS, dtype=f32, bcs=scalar_bcs)
    top_ins, top_outs, _ = _ext_side_blocks(torch, mesh, cc.TOP_STEPS, f32, gen)
    edges = [f[:4] for f in flags]
    in0, out0 = [p[0] for p in ins], [p[0] for p in outs]
    ms = _cuda_ms(torch, lambda: ce.affine_laplace_ext_2d(in0, out0, flags, spec, sides=sides),
                  20)
    scalar_ms = _cuda_ms(torch, lambda: ce.affine_laplace_ext_2d(in0, out0, edges, scalar_spec),
                         20)
    top_ms = _cuda_ms(torch, lambda: ce.affine_laplace_ext_2d(
        [p[0] for p in top_ins], [p[0] for p in top_outs], edges, top_spec), 20)
    plain_ms = _cuda_ms(torch, lambda: [ce.affine_laplace_ext_2d_plain(x, spec, f, sides)
                                        for x, f in zip(in0, flags, strict=True)], 3)
    ext_cells = 4 * (local[0] + 2 * spec.halo) * (local[1] + 2 * spec.halo)
    bound = _bound((ext_cells + cells) * 4, _affine_flops((1.0, 1.0)) * spec.k * cells)
    sides_unit = ce.affine_ext_source((False, False), sides=True)
    tag = f"IfLi{spec.k}E"
    ptx = " | ".join(_ptxas_of(builds[sides_unit.digest]["log"],
                               "affine_laplace_sides_ext_2d_kernel", tag))
    ladder = [s.k for s in eq.make_fused_euler_window(state, SHARDED_DIFFUSION_DT,
                                                      mesh=mesh).specs]
    passes = _ladder_passes(ladder, SHARDED_WINDOW)
    parts.append(
        f"(a) DiffusionPDE(0.1) {n}^2 fp32 on [2, 2], x- 0.1*sin(3*t), x+ no-flux, y- a "
        f"per-point array, y+ 0, dt {SHARDED_DIFFUSION_DT}: {SHARDED_WINDOW} steps through "
        f"solve(backend='cuda') {seconds:.3f} s ({cells * SHARDED_WINDOW / seconds:.4e} "
        f"cell-updates/s), serial (#1's side inputs) {serial_seconds:.3f} s, bit-equal; "
        f"{launches_12} side-input launches ({passes} passes a {SHARDED_WINDOW}-step window, "
        f"ladder {ladder}); one k={spec.k} pass over the four {local[0]}x{local[1]} blocks "
        f"{ms:.4f} ms with "
        f"the side inputs, {scalar_ms:.4f} ms with scalar sides (k={cc.TOP_STEPS}: "
        f"{top_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
        f"{bound[0] / ms:.1%} of it); ptxas float k={spec.k}: {ptx}")
    rows.append({
        "name": "affine_laplace_ext_2d (side inputs)",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:5792 (bc_specs: "
                    "pde_tpu/parallel/fused.py:197-260)",
        "launches": launches_12,
        "max_abs_err": errs[("#12", f"{n}^2", "[2, 2]", f32, spec.k)],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": None,  # per-point and time-dependent ghosts are no convolution's
    })

    # (b) Cahn-Hilliard through #8, Euler and RK4
    launches_8 = 0
    label = f"{n}^2"
    ch = pde.PDE({"c": SIDES_RHS}, bc=_sharded_ch_bc(np, n))
    t_end = SHARDED_WINDOW * SHARDED_CH_DT
    for scheme, solver, kind in (("Euler", "euler", "euler"), ("RK4", "runge-kutta", "rk4")):
        ce.multi_stencil_ext_2d.launches = ce.multi_stencil_ext_2d.sides_launches = 0
        (result, info), seconds = _synced_seconds(torch, lambda: ch.solve(
            state, t_range=t_end, dt=SHARDED_CH_DT, tracker=None, backend="cuda",
            solver=solver, decomposition=[2, 2], ret_info=True))
        launches = ce.multi_stencil_ext_2d.sides_launches
        checks = [launches > 0, ce.multi_stencil_ext_2d.launches == launches,
                  info["solver"].get("fused_step") is True,
                  info["solver"]["steps"] == SHARDED_WINDOW]
        serial, serial_seconds = _synced_seconds(torch, lambda: ch.solve(
            state, t_range=t_end, dt=SHARDED_CH_DT, tracker=None, backend="cuda",
            solver=solver))
        checks += [bool(torch.isfinite(result.data).all()),
                   torch.equal(result.data, serial.data)]
        _require(all(checks), f"the decomposed Cahn-Hilliard {scheme} main path with side "
                              f"inputs: {checks}")
        launches_8 += launches
        program = units["programs"][(label, kind)]
        ladder, halo = _ext_ladder(program, local)
        spec = ce.multi_stencil_ext_spec(program, ladder[0], f32, local, halo)
        ins, outs, flags = _ext_side_blocks(torch, mesh, halo, f32, gen)
        views = program.sides.passes(0.0, spec.k, SHARDED_CH_DT, f32, device)(0, spec.k)
        ms = _cuda_ms(torch, lambda: ce.multi_stencil_ext_2d(ins, outs, flags, spec,
                                                             sides=views), 20)
        plain_ms = _cuda_ms(torch, lambda: [ce.multi_stencil_ext_2d_plain(p, spec, f, views)
                                            for p, f in zip(ins, flags, strict=True)], 3)
        ext_cells = 4 * (local[0] + 2 * halo) * (local[1] + 2 * halo)
        bound = _bound((ext_cells + cells) * 4, _program_flops(program) * spec.k * cells)
        tx, threads = program.tiles[f32][spec.k]
        tag = f"EfLi{spec.k}ELi{tx}ELi{threads}E"
        ptx = " | ".join(_ptxas_of(builds[program.digest]["log"],
                                   "multi_stencil_sides_ext_2d_kernel", tag))
        scalar_note = ""
        if kind == "euler":
            scalar_spec = ch_scalar.specs[0]
            s_ins, s_outs, _ = _ext_side_blocks(torch, mesh, scalar_spec.halo, f32, gen)
            scalar_ms = _cuda_ms(torch, lambda: ce.multi_stencil_ext_2d(
                s_ins, s_outs, [f[:4] for f in flags], scalar_spec), 20)
            scalar_note = f", {scalar_ms:.4f} ms with scalar no-flux sides (k={scalar_spec.k})"
            euler = (ms, plain_ms, bound, spec.k)
        parts.append(
            f"(b) Cahn-Hilliard {scheme} {n}^2 fp32 on [2, 2], x- 0.1*sin(3*t), x+ a per-point "
            f"array, y- cos(x)*sin(t), y+ no-flux, dt {SHARDED_CH_DT}: {SHARDED_WINDOW} steps "
            f"through solve(backend='cuda') {seconds:.3f} s "
            f"({cells * SHARDED_WINDOW / seconds:.4e} cell-updates/s), serial (#7's side "
            f"inputs) {serial_seconds:.3f} s, bit-equal; {launches} side-input launches "
            f"({_ladder_passes(ladder, SHARDED_WINDOW)} passes a {SHARDED_WINDOW}-step window, "
            f"ladder {ladder}); one k={spec.k} pass {ms:.4f} ms with the side inputs"
            f"{scalar_note}, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
            f"{bound[0] / ms:.1%} of it); ptxas float k={spec.k}: {ptx}")
    ms, plain_ms, bound, k = euler
    rows.append({
        "name": "multi_stencil_ext_2d (side inputs)",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:4081 (bc_inputs: "
                    "pde_tpu/parallel/fused.py:476-516)",
        "launches": launches_8,
        "max_abs_err": errs[("#8", "euler", label, "[2, 2]", f32, k)],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": None,  # the rhs is nonlinear
    })
    print(f"[sharded sides main] on {smi}: " + "; ".join(parts) + " ok", flush=True)

    # the scalar-side ext kernels, which the side inputs leave as they were
    sass = []
    for unit in scalar_units:
        needles = ("affine_laplace_ext_2d_kernel", f"IfLi{cc.TOP_STEPS}E")
        sass.append(f"affine_laplace_ext_2d periodic {unit.periodic} k={cc.TOP_STEPS} float: "
                    + " | ".join(_ptxas_of(builds[unit.digest]["log"], *needles))
                    + "; SASS " + _sass_summary(builds[unit.digest]["path"], needles))
    program = ch_scalar.program
    spec = ch_scalar.specs[0]
    tx, threads = program.tiles[f32][spec.k]
    needles = ("multi_stencil_ext_2d_kernel", f"EfLi{spec.k}ELi{tx}ELi{threads}E")
    sass.append(f"multi_stencil_ext_2d Cahn-Hilliard no-flux k={spec.k} float: "
                + " | ".join(_ptxas_of(builds[program.digest]["log"], *needles))
                + "; SASS " + _sass_summary(builds[program.digest]["path"], needles))
    print("[2d plan] the scalar-side ext kernels beside the side-input modes: "
          + "; ".join(sass), flush=True)
    pde.config["parallel.devices_per_device"] = 1
    return rows


def _a9_plain_phase(pde, torch, np, device, smi) -> None:
    """Phase 60: the plain pieces of A9 on the card (plain torch, as in
    ``pde_tpu``): ``laplace(u) - integral(u)`` on a polar grid on [4] and on a
    1024² Cartesian grid on [2, 2] against the serial runs; diffusion with an
    anti-periodic x on [2, 1], bit-equal to serial; ``split_mpi(4)`` of a
    4096² field and the main path on its mesh through #12."""
    from pde_tpu_torch.ops import cuda_ext_2d as ce

    f32 = torch.float32
    pde.config["parallel.devices_per_device"] = 4
    rng = np.random.default_rng(60)
    parts = []
    rhs = {"u": "laplace(u) - integral(u)"}
    n = A9_PLAIN_N
    for label, grid, dt, cut in (
            (f"polar {A9_POLAR_N} cells on [4]", pde.PolarSymGrid(1.0, A9_POLAR_N),
             0.1 / A9_POLAR_N**2, [4]),
            (f"Cartesian {n}^2 of the unit square on [2, 2]",
             pde.CartesianGrid([(0, 1), (0, 1)], [n, n], periodic=True), 0.1 / n**2, [2, 2])):
        state = pde.ScalarField(grid, rng.uniform(0.0, 1.0, grid.shape), dtype=f32,
                                device=device)
        eq = pde.PDE(rhs)
        t_end = A9_PLAIN_STEPS * dt

        def solve(**kw):
            return eq.solve(state, t_range=t_end, dt=dt, tracker=None, ret_info=True, **kw)

        solve(decomposition=cut)  # warm-up
        (got, info), seconds = _synced_seconds(torch, lambda: solve(decomposition=cut))
        (serial, _), serial_seconds = _synced_seconds(torch, solve)
        diff = float((got.data - serial.data).abs().max())
        scale = float(serial.data.abs().max())
        checks = [info["solver"]["decomposition"] == cut, info["solver"]["sharded_halo"] == 1,
                  bool(torch.isfinite(got.data).all()), diff <= F32_STEP_RTOL * scale]
        _require(all(checks), f"a global reduction in a decomposed rhs, {label}: {checks}")
        trace = _trace_line(torch, lambda: solve(decomposition=cut), A9_PLAIN_STEPS, "step")
        parts.append(f"integral, {label}: {seconds / A9_PLAIN_STEPS * 1e3:.4f} ms a step "
                     f"(serial {serial_seconds / A9_PLAIN_STEPS * 1e3:.4f}), max_abs against "
                     f"the serial run {diff:.3e} (max|u| {scale:.3f}; the blocks' partial "
                     f"integrals summed in block order); traced: {trace}")
    grid = pde.UnitGrid([n, n], periodic=True)
    state = pde.ScalarField(grid, rng.uniform(0.0, 1.0, (n, n)), dtype=f32, device=device)
    eq = pde.DiffusionPDE(0.1, bc={"x": "anti-periodic", "y": "periodic"})
    t_end = A9_PLAIN_STEPS * 0.1

    def anti(**kw):
        return eq.solve(state, t_range=t_end, dt=0.1, tracker=None, ret_info=True, **kw)

    anti(decomposition=[2, 1])  # warm-up
    (got, info), seconds = _synced_seconds(torch, lambda: anti(decomposition=[2, 1]))
    (serial, _), serial_seconds = _synced_seconds(torch, anti)
    checks = ["fused_step" not in info["solver"], torch.equal(got.data, serial.data)]
    _require(all(checks), f"anti-periodic diffusion on [2, 1]: {checks}")
    trace = _trace_line(torch, lambda: anti(decomposition=[2, 1]), A9_PLAIN_STEPS, "step")
    parts.append(f"DiffusionPDE(0.1) {n}^2 with an anti-periodic x on [2, 1]: "
                 f"{seconds / A9_PLAIN_STEPS * 1e3:.4f} ms a step (serial plain "
                 f"{serial_seconds / A9_PLAIN_STEPS * 1e3:.4f}), bit-equal to serial; "
                 f"traced: {trace}")
    m = A9_SPLIT_N
    field = pde.ScalarField(pde.UnitGrid([m, m], periodic=True),
                            rng.uniform(0.0, 1.0, (m, m)), dtype=f32, device=device)
    split, seconds = _synced_seconds(torch, lambda: field.split_mpi(4))
    ce.affine_laplace_ext_2d.launches = 0
    main = pde.DiffusionPDE(0.1)
    got, info = main.solve(split, t_range=3.7, dt=0.1, tracker=None, backend="cuda",
                           decomposition="auto", ret_info=True)
    launches = ce.affine_laplace_ext_2d.launches
    serial = main.solve(field, t_range=3.7, dt=0.1, tracker=None, backend="cuda")
    checks = [split.mesh.decomposition == [2, 2], torch.equal(split.data, field.data),
              split.device == field.device, info["solver"]["decomposition"] == [2, 2],
              launches > 0, torch.equal(got.data, serial.data)]
    _require(all(checks), f"split_mpi: {checks}")
    parts.append(f"split_mpi(4) of a {m}^2 fp32 field: {seconds * 1e3:.3f} ms, decomposition "
                 f"{split.mesh.decomposition}, data equal, on {split.device}; the main path "
                 f"on its mesh (decomposition='auto', 37 steps) through {launches} launches of "
                 f"#12, bit-equal to serial")
    print(f"[a9 plain] on {smi}: " + "; ".join(parts) + " ok", flush=True)
    pde.config["parallel.devices_per_device"] = 1


# -- phases 61-63: the side inputs of the 3D windows (#5/#4 serially, #6 on a mesh) -----------------
SIDES3D_N = 256  # the 3D configurations of scripts/perf_3d.py
SIDES3D_RAGGED = (30, 34, 38)  # phase 61's ragged grid: blocks down to 15x17x19
SIDES3D_MESHES = ([2, 1, 1], [2, 2, 2])
SIDES3D_T0 = 0.35
SIDES3D_DT = 0.05
SIDES3D_WINDOW = 2048
SIDES3D_RK4_STEPS = 512
SIDES3D_AC = "laplace(u) + u - u**3"  # path (b), Allen-Cahn
SIDES3D_FACES_RHS = "0.5 * laplace(u) - 0.1 * u**3"  # phase 61's check of every face kind


def _sides3d_diffusion_bc(np, face, scalar: bool = False) -> dict:
    """Path (a)'s faces: x- a per-point value array (seed 1; `face`: the x
    face's shape, (ny, nz)), x+ no-flux, y-
    ``sin(3*t)``, y+ value 0, z- ``cos(x + t)`` (space and time), z+ no-flux;
    `scalar`: the same faces with constant values."""
    if scalar:
        return {"x-": {"value": 0.05}, "x+": {"derivative": 0}, "y-": {"value": 0.5},
                "y+": {"value": 0}, "z-": {"value": 0.5}, "z+": {"derivative": 0}}
    return {"x-": {"value": np.random.default_rng(1).uniform(-0.1, 0.1, face)},
            "x+": {"derivative": 0}, "y-": {"value_expression": "sin(3*t)"},
            "y+": {"value": 0}, "z-": {"value_expression": "cos(x + t)"},
            "z+": {"derivative": 0}}


def _sides3d_allen_cahn_bc(np, face, scalar: bool = False) -> dict:
    """Path (b)'s faces: x- Robin with a per-point gamma (uniform(0.5, 2), seed
    2; `face`: the x face's shape) and const 0.3, y- ``sin(3*t)``, the rest
    no-flux; `scalar`: the same faces with constant values."""
    gamma = 1.25 if scalar else np.random.default_rng(2).uniform(0.5, 2.0, face)
    return {"x-": {"type": "mixed", "value": gamma, "const": 0.3}, "x+": {"derivative": 0},
            "y-": {"value": 0.5} if scalar else {"value_expression": "sin(3*t)"},
            "y+": {"derivative": 0}, "z": {"derivative": 0}}


def _sides3d_faces_bc(np, shape) -> dict:
    """Phase 61's other face kinds: x- ``sin(y + z - t)``, x+ ``0.5*cos(t)``,
    y- a per-point array, y+ Robin with a per-point gamma, z- a per-point
    array, z+ no-flux."""
    nx, ny, nz = shape
    rng = np.random.default_rng(3)
    return {"x-": {"value_expression": "sin(y + z - t)"},
            "x+": {"value_expression": "0.5*cos(t)"},
            "y-": {"value": rng.uniform(-0.5, 0.5, (nx, nz))},
            "y+": {"type": "mixed", "value": rng.uniform(0.5, 2.0, (nx, nz)), "const": 0.1},
            "z-": {"value": rng.uniform(-0.5, 0.5, (nx, ny))}, "z+": {"derivative": 0}}


def _sides3d_units(pde, torch, np, device) -> dict:
    """The build units of phases 61-62: the serial (#5) and decomposed (#6)
    programs with side inputs of path (a) (the diffusion window's reroute:
    ``DiffusionPDE._fused_rhs``), path (b) (Allen-Cahn Euler and RK4) and the
    other face kinds, on 256³ and the ragged grid (one library a kind: the
    sources do not depend on the grid's shape), and the scalar-side programs
    of paths (a) and (b) that phase 62 sets beside them."""
    from pde_tpu_torch.parallel import GridMesh

    grids = {f"{SIDES3D_N}^3": pde.UnitGrid([SIDES3D_N] * 3),
             "ragged {}x{}x{}".format(*SIDES3D_RAGGED): pde.UnitGrid(list(SIDES3D_RAGGED))}
    programs = {}
    for label, grid in grids.items():
        state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=device)
        mesh = GridMesh(grid, [2, 2, 2], devices=[device] * 8)
        face = grid.shape[1:]
        diffusion = pde.DiffusionPDE(1.0, bc=_sides3d_diffusion_bc(np, face))
        allen_cahn = pde.PDE({"u": SIDES3D_AC}, bc=_sides3d_allen_cahn_bc(np, face))
        faces = pde.PDE({"u": SIDES3D_FACES_RHS}, bc=_sides3d_faces_bc(np, grid.shape))
        makers = {"diffusion": diffusion.make_fused_euler_window,
                  "euler": allen_cahn.make_fused_euler_window,
                  "faces": faces.make_fused_euler_window}
        if label == f"{SIDES3D_N}^3":
            makers["rk4"] = allen_cahn.make_fused_rk4_window
        for kind, make in makers.items():
            programs[(label, kind, "serial")] = make(state, SIDES3D_DT).program
            programs[(label, kind, "ext")] = make(state, SIDES3D_DT, mesh=mesh).program
    grid = grids[f"{SIDES3D_N}^3"]
    state = pde.ScalarField(grid, 0.0, dtype=torch.float32, device=device)
    mesh = GridMesh(grid, [2, 2, 2], devices=[device] * 8)
    face = grid.shape[1:]
    scalar = {"diffusion": pde.PDE({"u": "1.0 * laplace(u)"},
                                   bc=_sides3d_diffusion_bc(np, face, scalar=True)),
              "euler": pde.PDE({"u": SIDES3D_AC},
                               bc=_sides3d_allen_cahn_bc(np, face, scalar=True))}
    for kind, eq in scalar.items():
        programs[("scalar", kind, "serial")] = eq.make_fused_euler_window(state, SIDES3D_DT).program
        programs[("scalar", kind, "ext")] = eq.make_fused_euler_window(
            state, SIDES3D_DT, mesh=mesh).program
    programs[("scalar", "rk4", "serial")] = scalar["euler"].make_fused_rk4_window(
        state, SIDES3D_DT).program
    programs[("scalar", "rk4", "ext")] = scalar["euler"].make_fused_rk4_window(
        state, SIDES3D_DT, mesh=mesh).program
    units = list({p.digest: p for p in programs.values()}.values())
    return {"grids": grids, "programs": programs, "units": units}


def _sides3d_phase(pde, torch, np, device, smi, units) -> dict:
    """Phase 61: kernel A (#5's side-input mode) and kernel B (#6's) against
    their plain versions on the card, on the same inputs, at every k of each
    ladder, fp32 and fp64, tables from t0 = 0.35: paths (a) and (b) (Euler,
    and RK4 on 256³) and the other face kinds, on 256³ and on the ragged
    30x34x38 grid; kernel B over the blocks of [2, 1, 1] and [2, 2, 2]
    meshes of both, exchanged as the windows exchange them."""
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3
    from pde_tpu_torch.parallel import GridMesh

    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=device).manual_seed(61)
    t0 = SIDES3D_T0
    errs, lines = {}, []
    for (label, kind, where), program in units["programs"].items():
        if label == "scalar":
            continue
        grid = units["grids"][label]
        for dtype in (f32, f64):
            if where == "serial":
                data = torch.rand(grid.shape, generator=gen, dtype=dtype, device=device) - 0.5
                row = []
                for k in program.ladder:
                    spec = cs.multi_stencil_spec(program, k, dtype)
                    views = program.sides.passes(t0, k, SIDES3D_DT, dtype, device)(0, k)
                    (out,) = s3.multi_stencil_3d([data], spec, sides=views)
                    (ref,) = s3.multi_stencil_3d_plain([data], spec, views)
                    err = _check_rel(torch, f"kernel A {kind} {label} k={k} {dtype}", out, ref,
                                     dtype, k)
                    errs[("A", kind, label, dtype, k)] = err
                    row.append(f"{err:.1e}")
                lines.append(f"A {kind} {label} {str(dtype)[6:]} k={program.ladder} "
                             + "/".join(row))
                continue
            for cut in SIDES3D_MESHES:
                mesh = GridMesh(grid, cut, devices=[device] * int(np.prod(cut)))
                local = mesh.local_shape
                ladder, halo = _ext_ladder(program, local)
                ins, outs, flags = _ext_side_blocks(torch, mesh, halo, dtype, gen)
                row = []
                for k in ladder:
                    spec = e3.multi_stencil_ext_3d_spec(program, k, dtype, local, halo)
                    views = program.sides.passes(t0, k, SIDES3D_DT, dtype, device)(0, k)
                    e3.multi_stencil_ext_3d(ins, outs, flags, spec, sides=views)
                    inner = (slice(halo, -halo),) * 3
                    out = torch.stack([p[0][inner] for p in outs])
                    ref = torch.stack([e3.multi_stencil_ext_3d_plain(p, spec, f, views)[0]
                                       for p, f in zip(ins, flags, strict=True)])
                    err = _check_rel(torch, f"kernel B {kind} {label} {cut} k={k} {dtype}",
                                     out, ref, dtype, k)
                    errs[("B", kind, label, str(cut), dtype, k)] = err
                    row.append(f"{err:.1e}")
                lines.append(f"B {kind} {label} {cut} {str(dtype)[6:]} k={ladder} "
                             + "/".join(row))
    print(f"[sides3d] kernels A and B (the side-input modes of #5/#4 and #6) against their "
          f"plain versions, max_abs at each k, tables from t0={t0}, on {smi}: "
          + "; ".join(lines) + " ok", flush=True)
    return errs


def _sides3d_table_bytes(program, k: int, itemsize: int) -> int:
    """Bytes of a pass's side inputs over the grid's faces: each input's face
    (a value, where it is one) once, a time-dependent one once a step."""
    sides = program.sides
    total = 0
    for i, (_, _, kind, stage) in enumerate(sides.entries):
        cells = 1 if kind == "t" else math.prod(sides.shape[a] for a in sides.face_axes(kind))
        total += cells * itemsize * (1 if stage is None else k)
    return total


def _sides3d_main(pde, torch, np, device, smi, units, builds, errs) -> list[dict]:
    """Phase 62: paths (a) and (b) on 256³ fp32 (``uniform(-0.1, 0.1)``, seed
    0, dt = 0.05) through ``solve(backend="cuda")``: (a) DiffusionPDE(1.0)
    Euler for 2048 steps (the reroute to the expression window), (b)
    Allen-Cahn Euler for 2048 steps and fixed-dt RK4 for 512, each serially
    through kernel A and on [2, 2, 2] (eight 128³ blocks on the card) through
    kernel B, bit-equal to the serial run, the side-input launches counted
    from 0; beside each its scalar-side run on the same faces; one top-k
    pass of each kernel beside its scalar-side pass, the plain version and
    the bound; registers and spills. Returns the kernels line's rows."""
    from pde_tpu_torch.ops import cuda_cartesian_3d as c3
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3
    from pde_tpu_torch.parallel import GridMesh

    f32 = torch.float32
    n = SIDES3D_N
    cells = n**3
    label = f"{n}^3"
    grid = units["grids"][label]
    mesh = GridMesh(grid, [2, 2, 2], devices=[device] * 8)
    local = mesh.local_shape
    pde.config["parallel.devices_per_device"] = 8
    gen = torch.Generator(device=device).manual_seed(62)
    rng = np.random.default_rng(0)
    state = pde.ScalarField(grid, rng.uniform(-0.1, 0.1, (n, n, n)), dtype=f32, device=device)
    counters = (s3.multi_stencil_3d, e3.multi_stencil_ext_3d, c3.affine_laplace_3d,
                e3.affine_laplace_ext_3d)
    paths = {
        "(a)": (pde.DiffusionPDE(1.0, bc=_sides3d_diffusion_bc(np, (n, n))),
                pde.PDE({"u": "1.0 * laplace(u)"}, bc=_sides3d_diffusion_bc(np, (n, n), True)),
                "diffusion", (("Euler", "euler", SIDES3D_WINDOW),)),
        "(b)": (pde.PDE({"u": SIDES3D_AC}, bc=_sides3d_allen_cahn_bc(np, (n, n))),
                pde.PDE({"u": SIDES3D_AC}, bc=_sides3d_allen_cahn_bc(np, (n, n), True)),
                "euler", (("Euler", "euler", SIDES3D_WINDOW),
                          ("RK4", "runge-kutta", SIDES3D_RK4_STEPS))),
    }
    launches = {"A": 0, "B": 0}
    parts, timed = [], {}
    for name, (eq, scalar_eq, kind, schemes) in paths.items():
        for scheme, solver, steps in schemes:
            t_end = steps * SIDES3D_DT
            run = {}
            for where, kwargs in (("serial", {}), ("[2, 2, 2]", {"decomposition": [2, 2, 2]})):
                for model in (eq, scalar_eq):  # warm-up: the libraries loaded, the tables made
                    model.solve(state, t_range=4 * SIDES3D_DT, dt=SIDES3D_DT, tracker=None,
                                backend="cuda", solver=solver, **kwargs)
                for counter in counters:
                    counter.launches = 0
                s3.multi_stencil_3d.sides_launches = e3.multi_stencil_ext_3d.sides_launches = 0
                (result, info), seconds = _synced_seconds(torch, lambda: eq.solve(
                    state, t_range=t_end, dt=SIDES3D_DT, tracker=None, backend="cuda",
                    solver=solver, ret_info=True, **kwargs))
                kernel = s3.multi_stencil_3d if where == "serial" else e3.multi_stencil_ext_3d
                count = kernel.sides_launches
                others = sum(c.launches for c in counters) - kernel.launches
                checks = [count > 0, kernel.launches == count, others == 0,
                          info["solver"].get("fused_step") is True,
                          info["solver"]["steps"] == steps,
                          bool(torch.isfinite(result.data).all())]
                _require(all(checks), f"path {name} {scheme} {where} with side inputs: {checks}")
                launches["A" if where == "serial" else "B"] += count
                _, scalar_seconds = _synced_seconds(torch, lambda: scalar_eq.solve(
                    state, t_range=t_end, dt=SIDES3D_DT, tracker=None, backend="cuda",
                    solver=solver, **kwargs))
                run[where] = (result, seconds, scalar_seconds, count)
            _require(torch.equal(run["serial"][0].data, run["[2, 2, 2]"][0].data),
                     f"path {name} {scheme}: [2, 2, 2] is not bit-equal to serial")
            parts.append(
                f"{name} {scheme} {steps} steps: " + ", ".join(
                    f"{where} {seconds:.3f} s ({cells * steps / seconds:.4e} cell-updates/s; "
                    f"scalar-side {cells * steps / scalar:.4e}), {count} side-input launches"
                    for where, (_, seconds, scalar, count) in run.items())
                + ", [2, 2, 2] bit-equal to serial")
        # one top-k pass of each kernel, with side inputs and with scalar sides
        for where in ("serial", "ext"):
            program = units["programs"][(label, kind, where)]
            scalar_program = units["programs"][("scalar", kind, where)]
            if where == "serial":
                k = program.ladder[0]
                spec = cs.multi_stencil_spec(program, k, f32)
                scalar_spec = cs.multi_stencil_spec(scalar_program, k, f32)
                data = torch.rand(grid.shape, generator=gen, dtype=f32, device=device) - 0.5
                out = [torch.empty_like(data)]
                views = program.sides.passes(0.0, k, SIDES3D_DT, f32, device)(0, k)
                ms = _cuda_ms(torch, lambda: s3.multi_stencil_3d([data], spec, outs=out,
                                                                 sides=views), 20)
                scalar_ms = _cuda_ms(torch, lambda: s3.multi_stencil_3d([data], scalar_spec,
                                                                        outs=out), 20)
                plain_ms = _cuda_ms(torch, lambda: s3.multi_stencil_3d_plain([data], spec,
                                                                             views), 3)
                moved = 2 * cells * 4
                kernel_name, what = "multi_stencil_sides_3d_kernel", "one 256^3 pass"
            else:
                ladder, halo = _ext_ladder(program, local)
                k = ladder[0]
                spec = e3.multi_stencil_ext_3d_spec(program, k, f32, local, halo)
                scalar_spec = e3.multi_stencil_ext_3d_spec(scalar_program, k, f32, local, halo)
                ins, outs, flags = _ext_side_blocks(torch, mesh, halo, f32, gen)
                edges = [f[:6] for f in flags]
                views = program.sides.passes(0.0, k, SIDES3D_DT, f32, device)(0, k)
                ms = _cuda_ms(torch, lambda: e3.multi_stencil_ext_3d(ins, outs, flags, spec,
                                                                     sides=views), 20)
                scalar_ms = _cuda_ms(torch, lambda: e3.multi_stencil_ext_3d(
                    ins, outs, edges, scalar_spec), 20)
                plain_ms = _cuda_ms(torch, lambda: [e3.multi_stencil_ext_3d_plain(
                    p, spec, f, views) for p, f in zip(ins, flags, strict=True)], 3)
                moved = (8 * math.prod(m + 2 * halo for m in local) + cells) * 4
                kernel_name, what = ("multi_stencil_sides_ext_3d_kernel",
                                     "one pass over the eight 128^3 blocks")
            bound = _bound(moved + _sides3d_table_bytes(program, k, 4),
                           _program_flops(program) * k * cells)
            tag = "EfLi{}ELi{}ELi{}ELi{}E".format(k, *spec.tile)
            ptx = " | ".join(_ptxas_of(builds[program.digest]["log"], kernel_name, tag))
            ladder = program.ladder if where == "serial" else _ext_ladder(program, local)[0]
            parts.append(
                f"{name} kernel {'A' if where == 'serial' else 'B'} {what} at k={k} (plan "
                f"{spec.tile}): {ms:.4f} ms with side inputs, {scalar_ms:.4f} ms with scalar "
                f"sides ({ms / scalar_ms - 1.0:+.1%}), plain {plain_ms:.4f} ms, bound "
                f"{bound[0]:.4f} ms ({bound[1]}, {bound[0] / ms:.1%} of it); "
                f"{_ladder_passes(ladder, SIDES3D_WINDOW)} launches a {SIDES3D_WINDOW}-step "
                f"window (ladder {ladder}); ptxas float k={k}: {ptx}")
            timed[(name, where)] = (ms, plain_ms, bound, k)
    print(f"[sides3d main] 256^3 fp32 through solve(backend='cuda') on {smi}: "
          + "; ".join(parts) + " ok", flush=True)
    pde.config["parallel.devices_per_device"] = 1
    rows = []
    for where, letter, row_name, source_line in (
            ("serial", "A", "multi_stencil_3d (side inputs)",
             "pde_tpu/ops/pallas_cartesian.py:2935, pde_tpu/ops/pallas_cartesian.py:2562 "
             "(bc_inputs: :2950-2957, :2608-2610)"),
            ("ext", "B", "multi_stencil_ext_3d (side inputs)",
             "pde_tpu/ops/pallas_cartesian.py:3443 (bc_inputs: :3507-3530; "
             "pde_tpu/parallel/fused.py:597-700)")):
        ms, plain_ms, bound, k = timed[("(b)", where)]
        err = (errs[("A", "euler", label, f32, k)] if where == "serial"
               else errs[("B", "euler", label, "[2, 2, 2]", f32, k)])
        rows.append({
            "name": row_name, "route": "cuda", "source": "pde_tpu_torch/csrc/multi_stencil_3d.cuh",
            "replaces": source_line, "launches": launches[letter], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None,  # a nonlinear rhs with per-face ghosts: no library call
        })
    return rows


def _sides3d_sass(smi, scalar_builds) -> None:
    """Phase 63: ptxas' registers and the SASS summary (instructions and
    hashes, ``scripts/torch_tree_compare.py``'s reading) of the scalar-side
    #5 and #6 kernels of Allen-Cahn 256³ periodic (phases 12 and 22's), which
    the side-input modes leave as they were: ``scripts/torch_sides_3d_phases.py
    --parent DIR`` sets another tree's beside them (`scalar_builds`: (label,
    kernel, ladder, tiles, build) of each)."""
    lines = []
    for label, kernel, ladder, tiles, built in scalar_builds:
        for k in ladder:
            needles = (kernel, "EfLi{}ELi{}ELi{}ELi{}E".format(k, *tiles[k]))
            lines.append(f"{label} {kernel} float k={k}: "
                         + " | ".join(_ptxas_of(built["log"], *needles))
                         + "; SASS " + _sass_summary(built["path"], needles))
    print(f"[sides3d sass] the scalar-side 3D kernels beside the side-input modes, on {smi}: "
          + "; ".join(lines), flush=True)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")
    started = time.perf_counter()

    import sympy

    import pde_tpu_torch as pde
    from pde_tpu_torch.ops import cuda_cartesian as cc
    from pde_tpu_torch.ops import cuda_cartesian_3d as c3
    from pde_tpu_torch.ops import cuda_ext_2d as ce
    from pde_tpu_torch.ops import cuda_ext_3d as e3
    from pde_tpu_torch.ops import cuda_sde_2d as sde
    from pde_tpu_torch.ops import cuda_stencil_2d as cs
    from pde_tpu_torch.ops import cuda_stencil_3d as s3
    from pde_tpu_torch.ops import cuda_stencil_op_2d as so
    from scripts import torch_bf16_phases as bfp
    from scripts import torch_deep_phases as dpp
    from scripts import torch_radial_sides_phases as rsp
    from scripts import torch_rk4_3d_phases as r3p

    # -- 1. device -------------------------------------------------------------------------
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"sympy {sympy.__version__}; nvidia-smi: {smi}", flush=True)
    default_field = pde.ScalarField(pde.UnitGrid([8, 8, 8], periodic=True), 0.0)
    if default_field.device.type != "cuda":
        raise AssertionError(f"a field made without device= lies on {default_field.device}")
    print(f"[device] a field made without device= lies on {default_field.device}", flush=True)
    # -- 2. build --------------------------------------------------------------------------
    multi = _multi_field_cases(pde, torch, device)
    multi3 = _multi_field_cases_3d(pde, torch, device)
    sde_cases = _sde_cases(pde, torch, device)
    big_sde = pde.UnitGrid([4096, 4096], periodic=True)
    zero_rate, zero_scale = _zero_rate_windows(pde, sde, torch, big_sde, 1e-3)
    sde_programs = [case["window"].program for case in sde_cases] + [
        w.program for w in zero_rate.values()]
    # the vector main paths' states (no device=: they land on the card) and windows
    vector_runs = {
        "ginzburg-landau 4096^2": (
            pde.PDE(GINZBURG_LANDAU), 1e-3,
            pde.VectorField.random_uniform(pde.UnitGrid([4096, 4096], periodic=True), -0.5, 0.5,
                                           dtype=torch.float32, rng=np.random.default_rng(0))),
        "coupled ranks 1024^2": (
            pde.PDE(COUPLED_RANKS), 5e-3,
            pde.FieldCollection([
                pde.ScalarField.random_uniform(pde.UnitGrid([1024, 1024], periodic=True),
                                               dtype=torch.float32, rng=np.random.default_rng(1)),
                pde.VectorField.random_uniform(pde.UnitGrid([1024, 1024], periodic=True),
                                               dtype=torch.float32, rng=np.random.default_rng(2)),
            ], labels=["u", "v"])),
        "vector 3d 128^3": (
            pde.PDE(VECTOR_3D), 1e-3,
            pde.VectorField.random_uniform(pde.UnitGrid([128] * 3, periodic=True), -0.5, 0.5,
                                           dtype=torch.float32, rng=np.random.default_rng(3))),
    }
    vector_windows = {run: eq.make_fused_euler_window(state, dt)
                      for run, (eq, dt, state) in vector_runs.items()}
    ext_windows = _ext_windows(pde, torch, device)
    ext_windows_3d = _ext_windows_3d(pde, torch, device)
    affine_ext_3d_units = [e3.affine_ext_source(p) for p in ((True,) * 3, (False,) * 3)]
    # the 2D affine libraries (#1 and #12), one per periodicity the checks below take
    affine_2d_units = [cc.kernel_source(p) for p in AFFINE_2D_PERIODIC] + [
        ce.affine_ext_source(p) for p in ((True, True), (False, False), (True, False))]
    late_units = [w.program for w in vector_windows.values()] + [so.kernel_source()] + [
        w.program for w in ext_windows.values()] + (
        affine_ext_3d_units + [w.program for w in ext_windows_3d.values()]) + affine_2d_units
    late_labels = [f"vector {run}" for run in vector_windows] + [
        "the six stencil operators"] + [f"ext {label}" for label in ext_windows] + [
        f"3D affine ext kernel, periodic axes {unit.periodic}" for unit in affine_ext_3d_units] + [
        f"3D ext {label}" for label in ext_windows_3d] + [
        f"periodic axes {unit.periodic}" for unit in affine_2d_units]
    family = _family_windows(pde, torch, device)
    family_units = list({(label, scheme): case["window"].program
                         for (label, scheme, _), case in family.items()}.items())
    late_units += [program for _, program in family_units]
    late_labels += [f"{scheme} {label}" for (label, scheme), _ in family_units]
    sharded_family = _sharded_family_windows(pde, torch, device)
    late_units += [window.program for window in sharded_family.values()]
    late_labels += [f"ext {scheme} {label}" for label, scheme in sharded_family]
    curvilinear = _curvilinear_units(pde, torch, device)
    late_units += curvilinear["units"]
    solver_units = _solver_units(pde, torch)
    late_labels += [f"radial mode, periodic axes {unit.periodic}" if getattr(unit, "radial", 0)
                    else "cylindrical program" for unit in curvilinear["units"]]
    late_units += solver_units
    late_labels += [f"Euler window, {label}" for label in SOLVER_WINDOWS]
    side_units = _side_input_units(pde, torch, device)
    late_units += side_units["units"]
    late_labels += ["side inputs of #1, both axes bounded"] + [
        "side inputs of #7" for _ in side_units["units"][1:]]
    ks_windows = _ks_windows(pde, torch, device)
    ks_units = list({w.program.digest: w.program for w in ks_windows.values()}.values())
    late_units += ks_units
    late_labels += [f"Kuramoto-Sivashinsky, {unit.library}" for unit in ks_units]
    corner_units = _corner_units(pde, torch)
    late_units += corner_units
    late_labels += ["the 9-point corner-weight mode of #1", "the 9-point corner-weight mode of #12"]
    sde_side_units = _sde_side_units(pde, torch, device)
    late_units += sde_side_units["units"]
    late_labels += [f"Euler-Maruyama, {'side inputs' if unit.stencil.sides else 'scalar sides'}, "
                    f"{unit.noise}" for unit in sde_side_units["units"]]
    sharded_side_units = _sharded_side_units(pde, torch, np, device)
    late_units += sharded_side_units["units"]
    late_labels += ["side inputs of #12, both axes bounded"] + [
        f"side inputs of {'#8' if unit.library == 'multi_stencil_ext_2d' else '#7'}"
        for unit in sharded_side_units["units"][1:]]
    sides3d_units = _sides3d_units(pde, torch, np, device)
    late_units += sides3d_units["units"]
    late_labels += [f"{'scalar sides' if unit.sides is None else 'side inputs'} of "
                    f"{'#6' if unit.library == 'multi_stencil_ext_3d' else '#5'}"
                    for unit in sides3d_units["units"]]
    radial_sides_units = rsp.units()
    late_units += radial_sides_units
    late_labels += [f"radial side inputs of {'#12' if unit.library.endswith('ext_2d') else '#1'}"
                    f", periodic axes {unit.periodic}" for unit in radial_sides_units]
    rk4_3d_units = r3p.units(pde, torch, device)
    late_units += rk4_3d_units["units"]
    late_labels += [f"RK4 of {name} cut into passes, {where}"
                    for name, where in rk4_3d_units["programs"]]
    bf16_units = bfp.units(pde, torch, np, device)
    late_units += bf16_units["units"]
    late_labels += [f"bf16 storage of {kernel}, {label}" for kernel, label in bf16_units["affine"]]
    late_labels += [f"bf16 storage of #8, Cahn-Hilliard {bfp.ch_label(*case)}"
                    for case in bf16_units["programs"]]
    late_labels += [f"float32 {kernel} beside bf16 #8, Cahn-Hilliard {bfp.ch_label(*case)}"
                    for kernel, *case in bf16_units["fp"]]
    deep_units = dpp.units(pde, torch, np, device)
    late_units += deep_units["units"] + deep_units["register"]
    late_labels += [f"the deep march, periodic axes {unit.periodic}" for unit in deep_units["units"]]
    late_labels += [f"the register march, periodic axes {unit.periodic}"
                    for unit in deep_units["register"]]
    start = time.perf_counter()
    affine_units = [c3.kernel_source(p) for p in sorted(
        {tuple(grid.periodic) for _, grid, _ in _affine_3d_cases(pde)})]
    programs_3d = affine_units + [case["window"].program for case in multi3]
    all_builds = cs.build_programs(
        [case["window"].program for case in multi] + sde_programs + programs_3d + late_units)
    multi_seconds = time.perf_counter() - start
    multi_builds = all_builds[: len(multi)]
    first_3d = len(multi) + len(sde_programs)
    multi3_logs = {case["label"]: built["log"] for case, built in zip(  # ptxas' reports
        multi3, all_builds[first_3d + len(affine_units):first_3d + len(programs_3d)])}
    ext3_logs = {label: all_builds[len(all_builds) - len(late_units) + late_units.index(
        window.program)]["log"] for label, window in ext_windows_3d.items()}
    affine_3d_logs = {  # ptxas' reports of both 3D affine kernels, by periodicity
        "affine_laplace_3d": {unit.periodic: built["log"] for unit, built in zip(
            affine_units, all_builds[first_3d:first_3d + len(affine_units)])},
        "affine_laplace_ext_3d": {unit.periodic: all_builds[
            len(all_builds) - len(late_units) + late_units.index(unit)]["log"]
            for unit in affine_ext_3d_units},
    }
    affine_2d_logs = {  # ptxas' reports of both 2D affine kernels, by library and periodicity
        (unit.library, unit.periodic): all_builds[
            len(all_builds) - len(late_units) + late_units.index(unit)]["log"]
        for unit in affine_2d_units}
    seen = set()
    for case, built in zip(multi, multi_builds):
        if built["path"] in seen:
            continue
        seen.add(built["path"])
        print(f"[build] multi_stencil_2d ({case['label']}): compiled={built['compiled']} in "
              f"{built['seconds']:.2f} s ({built['cpu_seconds']:.1f} CPU-s); "
              f"{_ptxas(built['log'])}", flush=True)
    for program, built in zip(sde_programs, all_builds[len(multi):]):
        if built["path"] in seen:
            continue
        seen.add(built["path"])
        print(f"[build] {program.library} ({program.noise}, depth {program.stencil.depth}, "
              f"ladder {program.stencil.ladder}): compiled={built['compiled']} in "
              f"{built['seconds']:.2f} s ({built['cpu_seconds']:.1f} CPU-s); "
              f"{_ptxas(built['log'])}", flush=True)
    labels_3d = [f"periodic axes {unit.periodic}" for unit in affine_units] + [
        case["label"] for case in multi3]
    for program, label, built in zip(programs_3d, labels_3d,
                                     all_builds[len(multi) + len(sde_programs):]):
        if built["path"] in seen:
            continue
        seen.add(built["path"])
        print(f"[build] {program.library} ({label}): compiled={built['compiled']} in "
              f"{built['seconds']:.2f} s ({built['cpu_seconds']:.1f} CPU-s); "
              f"{_ptxas(built['log'])}", flush=True)
    for unit, label, built in zip(late_units, late_labels, all_builds[-len(late_units):]):
        if built["path"] in seen:
            continue
        seen.add(built["path"])
        print(f"[build] {unit.library} ({label}): compiled={built['compiled']} in "
              f"{built['seconds']:.2f} s ({built['cpu_seconds']:.1f} CPU-s); "
              f"{_ptxas(built['log'])}", flush=True)
    cpu = {built["path"]: built["cpu_seconds"] for built in all_builds}
    curvilinear_cpu = {all_builds[len(all_builds) - len(late_units) + late_units.index(unit)][
        "path"]: unit for unit in curvilinear["units"]}
    print(f"[build] {len(seen)} libraries built in parallel in {multi_seconds:.2f} s, "
          f"{sum(cpu.values()):.1f} CPU-s in all, phases 31-35's {len(curvilinear_cpu)}: "
          + ", ".join(f"{unit.library} {cpu[path]:.1f}" for path, unit in curvilinear_cpu.items())
          + " (source beside each .so in pde_tpu_torch/_build/)", flush=True)

    # -- 3. kernel vs plain ----------------------------------------------------------------
    gen = np.random.default_rng(0)

    def random_data(shape, dtype):
        return torch.as_tensor(gen.random(shape), dtype=dtype, device=device)

    def check(label, grid, bc, dtype, k, steps=None):
        """Kernel (one pass, or the ladder window for `steps`) vs plain."""
        bcs = None if bc is None else grid.get_boundary_conditions(bc)
        data = random_data(grid.shape, dtype)
        if steps is None:
            spec = cc.affine_laplace_spec(grid, a=1.0, b=0.02, k=k, dtype=dtype, bcs=bcs)
            out = cc.affine_laplace_2d(data, spec)
            ref = cc.affine_laplace_2d_plain(data, spec)
            n_steps = k
        else:
            window = cc.make_fused_euler_window_2d(grid, diffusivity=0.1, dt=0.1, dtype=dtype, bcs=bcs)
            out = window(data, steps)
            spec1 = cc.affine_laplace_spec(grid, a=1.0, b=0.01, k=1, dtype=dtype, bcs=bcs)
            ref = data
            for _ in range(steps):
                ref = cc.affine_laplace_2d_plain(ref, spec1)
            n_steps = steps
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        rel = err / scale
        if dtype == torch.float64:
            tol = F64_TOL * scale
        elif steps is not None and steps >= 1000:
            tol = F32_LONG_TOL * (1.0 + scale)
        else:
            tol = F32_STEP_RTOL * n_steps * scale
        ok = bool(torch.isfinite(out).all()) and err <= tol
        print(f"[kernel] {label} {str(dtype)[6:]}: steps={n_steps} max_abs={err:.3e} max_rel={rel:.3e} "
              f"tol={tol:.1e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {label}")
        return err

    f32, f64 = torch.float32, torch.float64
    big = pde.UnitGrid([4096, 4096], periodic=True)
    affine_top = cc.TOP_STEPS
    ladder = [spec.k for spec in cc.make_fused_euler_window_2d(
        big, diffusivity=0.1, dt=0.1, dtype=f32).specs]
    grid_1k = pde.UnitGrid([1024, 1024])
    bc_cases = {
        "no-flux": {"derivative": 0},
        "dirichlet 1.5": {"value": 1.5},
        "robin": {"type": "mixed", "value": 2.0, "const": 0.5},
        "curvature": {"curvature": 1.0},
    }
    aniso = pde.CartesianGrid([(0, 1024), (0, 2048)], [1024, 1024], periodic=True)
    ragged = pde.CartesianGrid([(0, 1000), (0, 1530)], [1000, 1530], periodic=[False, True])
    ragged_bc = {"x-": {"value": 1.5}, "x+": {"derivative": 0.3}, "y": "periodic"}
    ragged_cols = pde.CartesianGrid([(0, 1000), (0, 1530)], [1000, 1530], periodic=[True, False])
    ragged_cols_bc = {"x": "periodic", "y-": {"curvature": 1.0}, "y+": {"value": -0.5}}
    main_errs = {}
    for dtype in (f32, f64):  # every k of the ladder, both dtypes, every BC form
        for k in ladder:
            main_errs[(str(dtype), k)] = check("periodic 4096^2", big, None, dtype, k)
            for label, bc in bc_cases.items():
                check(f"{label} 1024^2", grid_1k, bc, dtype, k)
            check("anisotropic periodic 1024^2", aniso, None, dtype, k)
            check("ragged 1000x1530 periodic columns", ragged, ragged_bc, dtype, k)
            check("ragged 1000x1530 periodic rows", ragged_cols, ragged_cols_bc, dtype, k)
            check("curvature 2x5 (smaller than the halo)", pde.UnitGrid([2, 5]),
                  {"curvature": 1.0}, dtype, k)
            check("periodic 3x4 (the halo wraps many times)", pde.UnitGrid([3, 4], periodic=True),
                  None, dtype, k)
            check("no-flux 32x32", pde.UnitGrid([32, 32]), {"derivative": 0}, dtype, k)
    check("ragged 1000x1530 fp32 k=3", ragged, ragged_bc, f32, 3)
    check("periodic 256^2 fp32, 1000 steps through the ladder",
          pde.UnitGrid([256, 256], periodic=True), None, f32, None, steps=1000)

    # -- 4. main path ----------------------------------------------------------------------
    eq = pde.DiffusionPDE(diffusivity=0.1)
    state = pde.ScalarField.random_uniform(big, dtype=f32, device=device,
                                           rng=np.random.default_rng(1))
    state_nf = pde.ScalarField.random_uniform(grid_1k, dtype=f32, device=device,
                                              rng=np.random.default_rng(2))
    cc.affine_laplace_2d.launches = 0
    cs.multi_stencil_2d.launches = 0
    solver = pde.EulerSolver(eq, backend="cuda")
    stepper = solver.make_stepper(state, dt=0.1)
    result, t_reached = stepper(state, 0.0, 3.7)
    result_nf = eq.solve(state_nf, t_range=10, dt=0.1, tracker="auto")
    torch.cuda.synchronize()
    launches = cc.affine_laplace_2d.launches
    if not (solver.info.get("fused_step") and eq.diagnostics["solver"].get("fused_step")):
        raise AssertionError("the main path did not take the fused kernel window")
    if launches <= 0:
        raise AssertionError("the main path launched no kernel")

    spec1 = cc.affine_laplace_spec(big, a=1.0, b=0.01, k=1, dtype=f32)
    ref = state.data
    for _ in range(37):
        ref = cc.affine_laplace_2d_plain(ref, spec1)
    bcs_nf = grid_1k.get_boundary_conditions(eq.bc)
    spec_nf = cc.affine_laplace_spec(grid_1k, a=1.0, b=0.01, k=1, dtype=f32, bcs=bcs_nf)
    ref_nf = state_nf.data
    for _ in range(100):
        ref_nf = cc.affine_laplace_2d_plain(ref_nf, spec_nf)
    err_main = float((result.data - ref).abs().max())
    err_nf = float((result_nf.data - ref_nf).abs().max())
    drift = abs(float(result_nf.average) - float(state_nf.average))
    checks = [
        result.data.shape == (4096, 4096) and result.data.dtype == f32,
        bool(torch.isfinite(result.data).all()) and bool(torch.isfinite(result_nf.data).all()),
        abs(t_reached - 3.7) < 1e-9 and solver.info["steps"] == 37,
        err_main <= F32_STEP_RTOL * 37 * float(ref.abs().max()),
        err_nf <= F32_STEP_RTOL * 100 * float(ref_nf.abs().max()),
        drift <= 1e-5,  # no-flux diffusion conserves the mean
    ]
    print(f"[main] 4096^2 periodic fp32, 37 steps (backend='cuda'): max_abs vs plain "
          f"{err_main:.3e}; 1024^2 no-flux solve to t=10: max_abs vs plain {err_nf:.3e}, "
          f"mean drift {drift:.2e}; kernel launches {launches} "
          f"{'ok' if all(checks) else 'FAIL'}", flush=True)
    if not all(checks):
        raise AssertionError(f"main path checks failed: {checks}")

    # -- 5. throughput ---------------------------------------------------------------------
    cells = 4096 * 4096
    window_steps, windows = 2048, 3
    data_w, t_w = stepper(state, 0.0, 0.1 * window_steps)  # warm-up
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(3):
        start = time.perf_counter()
        for _ in range(windows):
            data_w, t_w = stepper(data_w, t_w, t_w + 0.1 * window_steps)
        torch.cuda.synchronize()
        best = max(best, cells * window_steps * windows / (time.perf_counter() - start))
    plain_steps = 64
    plain_best = 0.0
    for _ in range(3):
        f = state.data
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(plain_steps):
            f = cc.affine_laplace_2d_plain(f, spec1)
        torch.cuda.synchronize()
        plain_best = max(plain_best, cells * plain_steps / (time.perf_counter() - start))
    spec_top = cc.affine_laplace_spec(big, a=1.0, b=0.01, k=affine_top, dtype=f32)
    out_top = torch.empty_like(state.data)
    kernel_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d(state.data, spec_top, out=out_top), 20)
    plain_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d_plain(state.data, spec_top), 5)
    library2_ms, library2_out = _library_conv(
        torch, state.data,
        _composed_stencil(torch, spec_top.a, spec_top.b, (spec_top.sx, spec_top.sy), affine_top),
        5)
    cc.affine_laplace_2d(state.data, spec_top, out=out_top)
    library2_err = float((library2_out - out_top).abs().max())
    library2_ok = library2_err <= LIBRARY_RTOL * float(out_top.abs().max())
    print(f"[throughput] 4096^2 periodic fp32 Euler diffusion on {smi}: main path "
          f"{best:.4e} cell-updates/s (best of 3 x {windows} windows of {window_steps} steps; "
          f"ladder {ladder}, {_ladder_passes(ladder, window_steps)} passes a window); plain "
          f"version {plain_best:.4e} cell-updates/s; one k={affine_top} pass: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, one circular Conv2d with the composed "
          f"{2 * affine_top + 1}x{2 * affine_top + 1} stencil {library2_ms:.4f} ms (max_abs vs kernel "
          f"{library2_err:.3e} {'ok' if library2_ok else 'FAIL'})", flush=True)
    if not library2_ok:
        raise AssertionError(f"the composed-stencil Conv2d does not compute the k={affine_top} pass")
    per_step = []
    for k in range(1, cc.MAX_STEPS + 1):
        spec_k = cc.affine_laplace_spec(big, a=1.0, b=0.01, k=k, dtype=f32)
        k_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d(state.data, spec_k, out=out_top), 20)
        b_ms = _bound(2 * cells * 4, _affine_flops((1.0, 1.0)) * k * cells)[0]
        per_step.append(f"k={k} {k_ms:.4f} ms ({k_ms / k:.5f} a step, {b_ms / k_ms:.1%} of bound)")
    print(f"[throughput] affine_laplace_2d 4096^2 periodic fp32 one pass per k on {smi}: "
          + "; ".join(per_step), flush=True)
    for (library, periodic), log in affine_2d_logs.items():
        if periodic != (True, True):
            continue
        for dtype in (f32, f64):
            itemsize = cc._DTYPES[dtype][2]
            plans = []
            for k in range(1, cc.MAX_STEPS + 1):
                tx, threads, prefetch, min_blocks = cc.affine_row_plan(k, itemsize)
                tag = "I{}Li{}ELi{}ELi{}E".format("f" if dtype == f32 else "d", k, tx, threads)
                plans.append(f"k={k} (tx {tx}, {threads} threads, prefetch {prefetch}, "
                             f"{min_blocks} blocks/SM, "
                             f"{cc.affine_row_smem(k, tx, threads, itemsize)} B shared): "
                             + " | ".join(_ptxas_of(log, f"{library}_kernel", tag)))
            chunk = (cs.chunk_rows(4096, 16) if library == "affine_laplace_2d"
                     else cs.chunk_rows(2048, 8, 4))
            print(f"[2d affine plan] {library} {str(dtype)[6:]}, periodic axes, chunks of "
                  f"{chunk} rows at 4096^2 (the ext kernel: four 2048^2 blocks); unrolled by "
                  f"{cc.ROW_PERIOD} rows, {cc.ROW_SLOTS} shared rows a level: " + "; ".join(plans),
                  flush=True)

    # -- 6. kernel vs plain (multi-field) -------------------------------------------------
    def check_multi(label, window, datas, dtype, spec=None, steps=None):
        """Generated kernel (one pass, or the ladder window for `steps`) vs plain."""
        if steps is None:
            out = cs.multi_stencil_2d(datas, spec)
            ref = cs.multi_stencil_2d_plain(datas, spec)
            n_steps = spec.k
        else:
            out = window(datas, steps)
            one = cs.multi_stencil_spec(window.program, 1, dtype)
            ref = datas
            for _ in range(steps):
                ref = cs.multi_stencil_2d_plain(ref, one)
            n_steps = steps
        torch.cuda.synchronize()
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        tol = (F64_TOL if dtype == torch.float64 else F32_STEP_RTOL * n_steps) * scale
        ok = all(bool(torch.isfinite(o).all()) for o in out) and err <= tol
        tile = "" if spec is None else f" tile={spec.tile}"
        print(f"[multi] {label} {str(dtype)[6:]} steps={n_steps}{tile}: max_abs={err:.3e} "
              f"max_rel={err / scale:.3e} tol={tol:.1e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"generated kernel disagrees with its plain version: {label}")
        return err

    multi_errs = {}
    for case in multi:
        window, datas, dtype = case["window"], case["datas"], case["dtype"]
        for spec in window.specs:
            multi_errs[(case["label"], str(dtype), spec.k)] = check_multi(
                case["label"], window, datas, dtype, spec=spec)
    ch_case = multi[0]
    check_multi(ch_case["label"] + " through the ladder", ch_case["window"], ch_case["datas"],
                f32, steps=100)

    # -- 7. main path (Cahn-Hilliard) --------------------------------------------------------
    grid_ch = pde.UnitGrid([1024, 1024], periodic=True)
    state_ch = pde.ScalarField.random_uniform(grid_ch, -0.1, 0.1, dtype=f32, device=device,
                                              rng=np.random.default_rng(0))
    eq_ch = pde.PDE({"c": "laplace(c**3 - c - laplace(c))"})
    model_ch = pde.CahnHilliardPDE()
    cc.affine_laplace_2d.launches = 0
    cs.multi_stencil_2d.launches = 0
    solver_ch = pde.EulerSolver(eq_ch, backend="cuda")
    stepper_ch = solver_ch.make_stepper(state_ch, dt=1e-3)
    result_ch, t_ch = stepper_ch(state_ch, 0.0, 0.3)
    solved_ch = eq_ch.solve(state_ch, t_range=1.0, dt=1e-3, tracker="auto", backend="cuda")
    solved_model = model_ch.solve(state_ch, t_range=1.0, dt=1e-3, tracker="auto",
                                  backend="cuda")
    torch.cuda.synchronize()
    multi_launches = cs.multi_stencil_2d.launches
    fused = (solver_ch.info.get("fused_step") and eq_ch.diagnostics["solver"].get("fused_step")
             and model_ch.diagnostics["solver"].get("fused_step"))
    if not fused:
        raise AssertionError("the Cahn-Hilliard main path did not take the fused kernel window")
    if multi_launches <= 0:
        raise AssertionError("the Cahn-Hilliard main path launched no kernel")

    plain_solver = pde.EulerSolver(eq_ch, backend="numpy")
    plain_ch, _ = plain_solver.make_stepper(state_ch, dt=1e-3)(state_ch, 0.0, 0.3)
    plain_long = eq_ch.solve(state_ch, t_range=1.0, dt=1e-3, tracker=None, backend="numpy")
    torch.cuda.synchronize()
    scale_ch = float(plain_ch.data.abs().max())
    err_stepper = float((result_ch.data - plain_ch.data).abs().max())
    err_solve = float((solved_ch.data - plain_long.data).abs().max())
    err_model = float((solved_model.data - plain_long.data).abs().max())
    drift_ch = max(abs(float(r.average) - float(state_ch.average))
                   for r in (result_ch, solved_ch, solved_model))
    checks_ch = [
        result_ch.data.shape == (1024, 1024) and result_ch.data.dtype == f32,
        all(bool(torch.isfinite(r.data).all()) for r in (result_ch, solved_ch, solved_model)),
        abs(t_ch - 0.3) < 1e-9 and solver_ch.info["steps"] == 300,
        err_stepper <= F32_STEP_RTOL * 300 * scale_ch,
        err_solve <= F32_STEP_RTOL * 1000 * float(plain_long.data.abs().max()),
        err_model <= F32_STEP_RTOL * 1000 * float(plain_long.data.abs().max()),
        drift_ch <= 1e-5,  # periodic Cahn-Hilliard conserves the mean
    ]
    print(f"[main] Cahn-Hilliard 1024^2 periodic fp32 (backend='cuda'): make_stepper 300 "
          f"steps max_abs vs plain loop {err_stepper:.3e}; PDE.solve to t=1 {err_solve:.3e}; "
          f"CahnHilliardPDE.solve to t=1 {err_model:.3e}; mean drift {drift_ch:.2e}; "
          f"kernel launches {multi_launches} {'ok' if all(checks_ch) else 'FAIL'}", flush=True)
    if not all(checks_ch):
        raise AssertionError(f"Cahn-Hilliard main path checks failed: {checks_ch}")

    # -- 8. throughput (Cahn-Hilliard) -------------------------------------------------------
    # BASELINE config 2 as scripts/performance_solvers.py defines it: warm up for
    # 100 steps, then time the stepper to t = 100
    dt_ch, t_end = 1e-3, 100.0
    bench_solver = pde.EulerSolver(eq_ch, backend="cuda")
    bench_stepper = bench_solver.make_stepper(state_ch, dt=dt_ch)
    warm, t_warm = bench_stepper(state_ch, 0.0, 100 * dt_ch)
    torch.cuda.synchronize()
    start = time.perf_counter()
    final, t_final = bench_stepper(warm, t_warm, t_end)
    torch.cuda.synchronize()
    tts = time.perf_counter() - start
    bench_steps = bench_solver.info["steps"] - 100
    final_ok = bool(torch.isfinite(final.data).all()) and abs(t_final - t_end) < 1e-6
    if not final_ok:
        raise AssertionError("the t = 100 Cahn-Hilliard run did not end finite at t = 100")
    print(f"[throughput] Cahn-Hilliard 1024^2 periodic fp32 to t=100 (dt=1e-3, "
          f"{bench_steps} steps after 100 warm-up) on {smi}: {tts:.4f} s, "
          f"{1024 * 1024 * bench_steps / tts:.4e} cell-updates/s", flush=True)

    grid_4k = pde.UnitGrid([4096, 4096], periodic=True)
    state_4k = pde.ScalarField.random_uniform(grid_4k, -0.1, 0.1, dtype=f32, device=device,
                                              rng=np.random.default_rng(3))
    stepper_4k = pde.EulerSolver(eq_ch, backend="cuda").make_stepper(state_4k, dt=dt_ch)
    data_4k, t_4k = stepper_4k(state_4k, 0.0, 0.1)  # warm-up
    torch.cuda.synchronize()
    rate_4k = 0.0
    for _ in range(2):
        start = time.perf_counter()
        data_4k, t_4k = stepper_4k(data_4k, t_4k, t_4k + 2048 * dt_ch)
        torch.cuda.synchronize()
        rate_4k = max(rate_4k, 4096 * 4096 * 2048 / (time.perf_counter() - start))
    print(f"[throughput] Cahn-Hilliard 4096^2 periodic fp32 on {smi}: {rate_4k:.4e} "
          f"cell-updates/s (best of 2 windows of 2048 steps)", flush=True)

    ch_window, ch_data = ch_case["window"], ch_case["datas"]
    per_k = {}
    for spec in ch_window.specs:
        outs = [torch.empty_like(d) for d in ch_data]
        k_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d(ch_data, spec, outs=outs), 50)
        p_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d_plain(ch_data, spec), 5)
        per_k[spec.k] = (k_ms, p_ms)
        print(f"[throughput] Cahn-Hilliard 1024^2 fp32 one k={spec.k} pass (tile {spec.tile}) "
              f"on {smi}: kernel {k_ms:.4f} ms ({1024 * 1024 * spec.k / k_ms * 1e3:.4e} "
              f"cell-updates/s), plain {p_ms:.4f} ms", flush=True)
    top_k = ch_window.specs[0].k
    window_4k = eq_ch.make_fused_euler_window(state_4k, dt_ch)
    outs_4k = [torch.empty_like(state_4k.data)]
    for spec in window_4k.specs:
        k_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d([state_4k.data], spec, outs=outs_4k), 50)
        b_ms, b_by = _bound(2 * 4096 * 4096 * 4,
                            _program_flops(window_4k.program) * spec.k * 4096 * 4096)
        print(f"[throughput] Cahn-Hilliard 4096^2 fp32 one k={spec.k} pass (tile {spec.tile}) "
              f"on {smi}: kernel {k_ms:.4f} ms ({k_ms / spec.k:.4f} ms per step), bound "
              f"{b_ms:.4f} ms ({b_by}, {b_ms / k_ms:.1%} of it); the ladder "
              f"{window_4k.program.ladder} takes "
              f"{_ladder_passes(window_4k.program.ladder, 2048)} passes a 2048-step window",
              flush=True)
    ext_program = ext_windows["cahn-hilliard periodic"].program
    ext_log = all_builds[len(all_builds) - len(late_units) + late_units.index(ext_program)]["log"]
    for label, program, log, kernel, shape, blocks in (
            ("multi_stencil_2d Cahn-Hilliard", ch_window.program, multi_builds[0]["log"],
             "multi_stencil_2d_kernel", (4096, 4096), 1),
            ("multi_stencil_ext_2d Cahn-Hilliard", ext_program, ext_log,
             "multi_stencil_ext_2d_kernel", (2048, 2048), 4)):
        layout = program.march
        for dtype in (f32, f64):
            for k, (tx, threads) in program.tiles[dtype].items():
                tag = "E{}Li{}ELi{}ELi{}E".format("f" if dtype == f32 else "d", k, tx, threads)
                chunk = cs.chunk_rows(shape[0], -(-shape[1] // tx), blocks)
                print(f"[2d plan] {label} {str(dtype)[6:]} k={k}: strips of tx={tx} columns, "
                      f"{threads} threads a block (one window column each), chunks of "
                      f"{chunk} rows at {blocks} x {shape[0]}x{shape[1]}; top halo "
                      f"{cs.TOP_HALO}, ladder {program.ladder}; stages (lag, first volume) "
                      f"{[(st.lag, st.first) for st in layout.stages]}, slots {layout.slots} "
                      f"a step; ptxas: " + " | ".join(_ptxas_of(log, kernel, tag)), flush=True)

    # -- 9. kernel vs plain (SDE) ------------------------------------------------------------
    noise_gen = torch.Generator(device=device).manual_seed(12)
    ctl = (0x1234ABCD, 0x0BADF00D, 1000)

    def sde_tolerance(dtype, route, steps):
        if route.startswith("normal (Box"):
            return F64_BOX_MULLER_TOL if dtype == f64 else F32_BOX_MULLER_STEP_RTOL * steps
        return F64_TOL if dtype == f64 else F32_STEP_RTOL * steps

    def check_sde(label, route, spec, data):
        """One pass of the route's kernel against its plain version."""
        if spec.program.noise == "staged":
            noise = 0.01 * torch.randn((spec.k, *spec.shape), generator=noise_gen,
                                       dtype=spec.dtype, device=device)
            out = sde.sde_stencil_2d(data, noise, spec)
            ref = sde.sde_stencil_2d_plain(data, noise, spec)
        else:
            out = sde.sde_kernel_noise_2d(data, ctl, spec)
            ref = sde.sde_kernel_noise_2d_plain(data, ctl, spec)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        tol = sde_tolerance(spec.dtype, route, spec.k) * scale
        ok = bool(torch.isfinite(out).all()) and err <= tol
        print(f"[sde] {label} {route} {str(spec.dtype)[6:]} k={spec.k} tile={spec.tile} "
              f"({spec.program.library}): max_abs={err:.3e} max_rel={err / scale:.3e} "
              f"tol={tol:.1e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"SDE kernel disagrees with its plain version: {label} {route}")
        return err

    sde_errs = {}
    for case in sde_cases:
        for spec in case["window"].specs:
            sde_errs[(case["label"], case["route"], str(spec.dtype), spec.k)] = check_sde(
                case["label"], case["route"], spec, case["data"])

    def check_tiling(case):
        """One k = 8 pass of in-kernel noise against eight k = 1 passes keyed
        by the following global steps: the stream is the global cell's."""
        window, data = case["window"], case["data"]
        top, one = window.specs[0], window.specs[-1]
        out = sde.sde_kernel_noise_2d(data, ctl, top)
        ref = data
        for i in range(top.k):
            ref = sde.sde_kernel_noise_2d(ref, (ctl[0], ctl[1], ctl[2] + i), one)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        tol = sde_tolerance(top.dtype, case["route"], top.k) * scale
        ok = err <= tol
        print(f"[sde] tiling {case['label']} {case['route']} {str(top.dtype)[6:]}: one k={top.k} "
              f"pass vs {top.k} k=1 passes max_abs={err:.3e} tol={tol:.1e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"in-kernel noise depends on the tiling: {case['label']}")

    for case in sde_cases:
        if case["kernel"] == "sde_kernel_noise_2d" and case["window"].specs[0].k > 1:
            check_tiling(case)

    # -- 10. main path (SDE) -------------------------------------------------------------------
    dt_sde, sde_steps = 1e-3, 2048
    state_sde = pde.ScalarField(big_sde, 0.0, dtype=f32, device=device)
    counters = (cc.affine_laplace_2d, cs.multi_stencil_2d, sde.sde_stencil_2d,
                sde.sde_kernel_noise_2d)
    sde_launches = {}
    main_sde = {}
    for route, cfg, kernel in SDE_ROUTES[:2]:
        with pde.config(cfg):
            for counter in counters:
                counter.launches = 0
            eq_kpz = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1, rng=np.random.default_rng(1))
            solver_kpz = pde.EulerSolver(eq_kpz, backend="cuda")
            stepper_kpz = solver_kpz.make_stepper(state_sde, dt=dt_sde)
            result_kpz, t_kpz = stepper_kpz(state_sde, 0.0, sde_steps * dt_sde)
            solved_kpz = eq_kpz.solve(state_sde, t_range=0.1, dt=dt_sde, tracker=None,
                                      backend="cuda")
            torch.cuda.synchronize()
            counts = {c.__name__: c.launches for c in counters}
            sde_launches[kernel] = counts[kernel]
            if not (solver_kpz.info.get("fused_step") and
                    eq_kpz.diagnostics["solver"].get("fused_step")):
                raise AssertionError(f"the SDE main path ({route}) did not take the fused window")
            if counts[kernel] <= 0:
                raise AssertionError(f"the SDE main path ({route}) launched no {kernel}")
            checks = [
                result_kpz.data.shape == (4096, 4096) and result_kpz.data.dtype == f32,
                bool(torch.isfinite(result_kpz.data).all()),
                bool(torch.isfinite(solved_kpz.data).all()),
                abs(t_kpz - sde_steps * dt_sde) < 1e-9 and solver_kpz.info["steps"] == sde_steps,
                float(result_kpz.fluctuations) > 0 and float(solved_kpz.fluctuations) > 0,
                solver_kpz.info["stochastic"] is True,
            ]
            note = ""
            if kernel == "sde_stencil_2d":
                # the staged stream is the plain loop's: same seed, same increments
                plain_kpz = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1,
                                                rng=np.random.default_rng(1))
                plain_stepper = pde.EulerSolver(plain_kpz, backend="numpy").make_stepper(
                    state_sde, dt=dt_sde)
                pl_solver = pde.EulerSolver(
                    pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1,
                                        rng=np.random.default_rng(1)), backend="cuda")
                fused_short, _ = pl_solver.make_stepper(state_sde, dt=dt_sde)(
                    state_sde, 0.0, 100 * dt_sde)
                plain_short, _ = plain_stepper(state_sde, 0.0, 100 * dt_sde)
                torch.cuda.synchronize()
                err_plain = float((fused_short.data - plain_short.data).abs().max())
                bound = F32_STEP_RTOL * 100 * float(plain_short.data.abs().max())
                checks.append(err_plain <= bound)
                note = f"; 100 steps vs the plain loop on the same stream max_abs {err_plain:.3e}"
            main_sde[route] = (float(result_kpz.fluctuations), float(solved_kpz.fluctuations))
            print(f"[main] KPZ 4096^2 periodic fp32 {route} (backend='cuda'): make_stepper "
                  f"{sde_steps} steps fluctuations {main_sde[route][0]:.4e}; solve to t=0.1 "
                  f"fluctuations {main_sde[route][1]:.4e}{note}; launches {counts} "
                  f"{'ok' if all(checks) else 'FAIL'}", flush=True)
            if not all(checks):
                raise AssertionError(f"SDE main path checks failed ({route}): {checks}")

    def check_moments(route, window):
        """One k = 8 pass from zero: every cell holds the sum of 8 increments."""
        zeros = torch.zeros(big_sde.shape, dtype=f32, device=device)
        steps = window.specs[0].k
        x = window(zeros, 77, steps).double().reshape(-1)
        n = x.numel()
        target_var = steps * zero_scale**2
        results = []
        for power, target in ((1, 0.0), (2, target_var), (3, 0.0)):
            values = x**power
            se = float(values.std()) / n**0.5
            got = float(values.mean())
            results.append((power, got, target, se, abs(got - target) <= MOMENT_SIGMAS * se))
        ok = all(r[-1] for r in results)
        text = ", ".join(f"E[x^{p}]={g:.4e} (target {t:.4e}, se {e:.1e})" for p, g, t, e, _ in results)
        print(f"[main] increment moments, one k={steps} pass of DiffusionPDE(0.0, noise=1.0) "
              f"from zero, 4096^2 fp32, {route}: {text} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"increment moments off ({route})")

    for route, window in zero_rate.items():
        check_moments(route, window)

    # -- 11. throughput (SDE) ------------------------------------------------------------------
    cells_sde = 4096 * 4096
    sde_rates = {}
    for route, cfg, kernel in SDE_ROUTES:
        with pde.config(cfg):
            eq_t = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1, rng=np.random.default_rng(1))
            stepper_t = pde.EulerSolver(eq_t, backend="cuda").make_stepper(state_sde, dt=dt_sde)
        data_t, t_t = stepper_t(state_sde, 0.0, sde_steps * dt_sde)  # warm-up
        torch.cuda.synchronize()
        best_t = 0.0
        for _ in range(3):
            start = time.perf_counter()
            data_t, t_t = stepper_t(data_t, t_t, t_t + sde_steps * dt_sde)
            torch.cuda.synchronize()
            best_t = max(best_t, cells_sde * sde_steps / (time.perf_counter() - start))
        sde_rates[route] = best_t
        print(f"[throughput] KPZ 4096^2 periodic fp32 {route} ({kernel}) on {smi}: "
              f"{best_t:.4e} cell-updates/s (best of 3 windows of {sde_steps} steps)", flush=True)
    plain_eq = pde.KPZInterfacePDE(nu=1.0, lmbda=1.0, noise=0.1, rng=np.random.default_rng(1))
    plain_stepper_t = pde.EulerSolver(plain_eq, backend="numpy").make_stepper(state_sde, dt=dt_sde)
    plain_rate = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        plain_stepper_t(state_sde, 0.0, 32 * dt_sde)
        torch.cuda.synchronize()
        plain_rate = max(plain_rate, cells_sde * 32 / (time.perf_counter() - start))
    print(f"[throughput] KPZ 4096^2 periodic fp32 normal, plain step loop on {smi}: "
          f"{plain_rate:.4e} cell-updates/s (best of 3 x 32 steps)", flush=True)

    kpz_main = {case["route"]: case for case in sde_cases
                if case["label"] == "kpz 4096^2 periodic"}
    staged_case, kn_case = kpz_main["normal"], kpz_main["irwin4"]
    staged_spec, kn_spec = staged_case["window"].specs[0], kn_case["window"].specs[0]
    data_main = staged_case["data"]
    out_main = torch.empty_like(data_main)
    noise_main = 0.01 * torch.randn((staged_spec.k, *staged_spec.shape), generator=noise_gen,
                                    dtype=f32, device=device)
    staged_ms = _cuda_ms(torch, lambda: sde.sde_stencil_2d(data_main, noise_main, staged_spec,
                                                           out=out_main), 20)
    staged_plain_ms = _cuda_ms(torch, lambda: sde.sde_stencil_2d_plain(data_main, noise_main,
                                                                       staged_spec), 3)
    kn_ms = _cuda_ms(torch, lambda: sde.sde_kernel_noise_2d(data_main, ctl, kn_spec,
                                                            out=out_main), 20)
    kn_plain_ms = _cuda_ms(torch, lambda: sde.sde_kernel_noise_2d_plain(data_main, ctl, kn_spec), 3)
    noise_fn = pde.PDE({"c": "laplace(c)"}, noise=0.1)._make_staged_noise(
        pde.ScalarField(big_sde, 0.0), dt_sde)
    stage_ms = _cuda_ms(torch, lambda: noise_fn(5, range(staged_spec.k), data_main), 5)
    print(f"[throughput] KPZ 4096^2 fp32 one k={staged_spec.k} pass on {smi}: sde_stencil_2d "
          f"{staged_ms:.4f} ms ({cells_sde * staged_spec.k / staged_ms * 1e3:.4e} "
          f"cell-updates/s; tile {staged_spec.tile}), "
          f"plain {staged_plain_ms:.4f} ms; staging its {staged_spec.k} "
          f"normal increment planes {stage_ms:.4f} ms; sde_kernel_noise_2d irwin4 "
          f"{kn_ms:.4f} ms ({cells_sde * kn_spec.k / kn_ms * 1e3:.4e} cell-updates/s; tile "
          f"{kn_spec.tile}), plain {kn_plain_ms:.4f} ms", flush=True)
    # the noise path alone: one top-k pass of each zero-rate window (identity
    # step) from zero, its increments staged (given) or drawn in the kernel
    zeros = torch.zeros(big_sde.shape, dtype=f32, device=device)
    noise_only = {}
    for route, window in zero_rate.items():
        spec = window.specs[0]
        if spec.program.noise == "staged":
            noise_zr = zero_scale * torch.randn((spec.k, *spec.shape), generator=noise_gen,
                                                dtype=f32, device=device)
            noise_only[route] = _cuda_ms(torch, lambda: sde.sde_stencil_2d(
                zeros, noise_zr, spec, out=out_main), 20)
        else:
            noise_only[route] = _cuda_ms(torch, lambda: sde.sde_kernel_noise_2d(
                zeros, ctl, spec, out=out_main), 20)
    print(f"[throughput] noise path alone, one k={staged_spec.k} pass of DiffusionPDE(0.0, "
          f"noise=1.0) 4096^2 fp32 on {smi}: " + "; ".join(
              f"{route} {ms:.4f} ms" for route, ms in noise_only.items()), flush=True)
    # registers and spills of both SDE kernels at the main path's pass (float, k, tile)
    kpz_logs = {case["route"]: built["log"] for case, built in zip(
        sde_cases, all_builds[len(multi):]) if case["label"] == "kpz 4096^2 periodic"}
    tag = f"EfLi{staged_spec.k}ELi{staged_spec.tile}E"
    for route, _, kernel in SDE_ROUTES:
        print(f"[sde ptxas] {kernel} ({route}) float k={staged_spec.k} tile={staged_spec.tile}: "
              + " | ".join(_ptxas_of(kpz_logs[route], "sde_window_2d_kernel", tag)), flush=True)

    # -- 12. kernel vs plain (3D) ------------------------------------------------------------
    affine3_errs = {}
    for label, grid, bc in _affine_3d_cases(pde):
        bcs = None if bc is None else grid.get_boundary_conditions(bc)
        for dtype in (f32, f64):
            data = random_data(grid.shape, dtype)
            results = []
            for k in range(1, c3.MAX_STEPS + 1):
                spec = c3.affine_laplace_3d_spec(grid, a=1.0, b=0.02, k=k, dtype=dtype, bcs=bcs)
                out = c3.affine_laplace_3d(data, spec)
                ref = c3.affine_laplace_3d_plain(data, spec)
                torch.cuda.synchronize()
                scale = float(ref.abs().max())
                err = float((out - ref).abs().max())
                tol = (F64_TOL if dtype == f64 else F32_STEP_RTOL * k) * scale
                ok = bool(torch.isfinite(out).all()) and err <= tol
                affine3_errs[(label, str(dtype), k)] = err
                results.append(f"k={k} tile={spec.tile} max_rel={err / scale:.3e}"
                               + ("" if ok else " FAIL"))
                if not ok:
                    print(f"[3d] affine_laplace_3d {label} {str(dtype)[6:]}: {results[-1]}")
                    raise AssertionError(f"3D affine kernel disagrees with its plain version: {label}")
            print(f"[3d] affine_laplace_3d {label} {str(dtype)[6:]}: {'; '.join(results)} ok",
                  flush=True)

    multi3_errs = {}
    for case in multi3:
        window, datas, dtype = case["window"], case["datas"], case["dtype"]
        results = []
        for spec in window.specs:
            out = s3.multi_stencil_3d(datas, spec)
            ref = s3.multi_stencil_3d_plain(datas, spec)
            torch.cuda.synchronize()
            scale = max(float(r.abs().max()) for r in ref)
            err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
            tol = (F64_TOL if dtype == f64 else F32_STEP_RTOL * spec.k) * scale
            ok = all(bool(torch.isfinite(o).all()) for o in out) and err <= tol
            multi3_errs[(case["label"], str(dtype), spec.k)] = err
            results.append(f"k={spec.k} tile={spec.tile} max_rel={err / scale:.3e}"
                           + ("" if ok else " FAIL"))
            if not ok:
                print(f"[3d] multi_stencil_3d {case['label']} {str(dtype)[6:]}: {results[-1]}")
                raise AssertionError(f"3D generated kernel disagrees with its plain version: "
                                     f"{case['label']}")
        print(f"[3d] multi_stencil_3d {case['label']} {str(dtype)[6:]} (depth "
              f"{window.program.depth}, {len(window.program.buffers)} operand buffers): "
              f"{'; '.join(results)} ok", flush=True)

    # -- 13. main path (3D) --------------------------------------------------------------------
    grid_3d = pde.UnitGrid([256, 256, 256], periodic=True)
    state_3d = pde.ScalarField.random_uniform(grid_3d, -0.1, 0.1, dtype=f32, device=device,
                                              rng=np.random.default_rng(0))
    dt_3d, cells_3d = 0.05, 256**3
    runs_3d = {
        "diffusion": (lambda: pde.DiffusionPDE(1.0), c3.affine_laplace_3d),
        "allen-cahn": (lambda: pde.PDE(ALLEN_CAHN_3D), s3.multi_stencil_3d),
    }
    counters_3d = counters + (c3.affine_laplace_3d, s3.multi_stencil_3d)
    launches_3d = {}
    steppers_3d = {}
    for run, (make_eq, kernel) in runs_3d.items():
        for counter in counters_3d:
            counter.launches = 0
        eq_3d = make_eq()
        solver_3d = pde.EulerSolver(eq_3d, backend="cuda")
        stepper_3d = solver_3d.make_stepper(state_3d, dt=dt_3d)
        result_3d, t_3d = stepper_3d(state_3d, 0.0, 37 * dt_3d)
        solved_3d = eq_3d.solve(state_3d, t_range=0.5, dt=dt_3d, tracker=None, backend="cuda")
        tracked_3d = eq_3d.solve(state_3d, t_range=0.5, dt=dt_3d, tracker="auto", backend="cuda")
        torch.cuda.synchronize()
        counts = {c.__name__: c.launches for c in counters_3d}
        launches_3d[kernel.__name__] = counts[kernel.__name__]
        if not (solver_3d.info.get("fused_step") and eq_3d.diagnostics["solver"].get("fused_step")):
            raise AssertionError(f"the 3D {run} main path did not take the fused window")
        if counts[kernel.__name__] <= 0:
            raise AssertionError(f"the 3D {run} main path launched no {kernel.__name__}")
        plain_3d, _ = pde.EulerSolver(make_eq(), backend="numpy").make_stepper(
            state_3d, dt=dt_3d)(state_3d, 0.0, 37 * dt_3d)
        torch.cuda.synchronize()
        err_3d = float((result_3d.data - plain_3d.data).abs().max())
        bound_3d = F32_STEP_RTOL * 37 * float(plain_3d.data.abs().max())
        checks_3d = [
            result_3d.data.shape == (256, 256, 256) and result_3d.data.dtype == f32,
            all(bool(torch.isfinite(r.data).all()) for r in (result_3d, solved_3d, tracked_3d)),
            abs(t_3d - 37 * dt_3d) < 1e-9 and solver_3d.info["steps"] == 37,
            err_3d <= bound_3d,
            float((solved_3d.data - tracked_3d.data).abs().max()) == 0.0,
        ]
        print(f"[3d main] {run} 256^3 periodic fp32 dt={dt_3d} (backend='cuda'): make_stepper 37 "
              f"steps max_abs vs plain loop {err_3d:.3e} (tol {bound_3d:.1e}); solve to t=0.5 "
              f"with and without trackers; launches {counts} "
              f"{'ok' if all(checks_3d) else 'FAIL'}", flush=True)
        if not all(checks_3d):
            raise AssertionError(f"3D {run} main path checks failed: {checks_3d}")
        steppers_3d[run] = stepper_3d

    # -- 14. throughput (3D) -------------------------------------------------------------------
    def window_rate(stepper):
        """Best cell-updates/s of 3 windows of 2048 steps after a warm-up window."""
        data, t = stepper(state_3d, 0.0, 2048 * dt_3d)
        torch.cuda.synchronize()
        best_rate = 0.0
        for _ in range(3):
            start = time.perf_counter()
            data, t = stepper(data, t, t + 2048 * dt_3d)
            torch.cuda.synchronize()
            best_rate = max(best_rate, cells_3d * 2048 / (time.perf_counter() - start))
        if not bool(torch.isfinite(data.data).all()):
            raise AssertionError("a 3D throughput window ended non-finite")
        return best_rate

    rates_3d = {run: window_rate(stepper) for run, stepper in steppers_3d.items()}
    via_multi = pde.EulerSolver(pde.PDE({"c": "laplace(c)"}), backend="cuda")
    rates_3d["diffusion through multi_stencil_3d"] = window_rate(
        via_multi.make_stepper(state_3d, dt=dt_3d))
    plain_rates_3d = {}
    for run, (make_eq, _) in runs_3d.items():
        plain_stepper = pde.EulerSolver(make_eq(), backend="numpy").make_stepper(state_3d, dt=dt_3d)
        best_plain = 0.0
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            plain_stepper(state_3d, 0.0, 16 * dt_3d)
            torch.cuda.synchronize()
            best_plain = max(best_plain, cells_3d * 16 / (time.perf_counter() - start))
        plain_rates_3d[run] = best_plain
    for run, rate in rates_3d.items():
        plain = plain_rates_3d.get(run)
        note = "" if plain is None else (
            f"; plain step loop {plain:.4e} cell-updates/s (best of 3 x 16 steps)")
        print(f"[3d throughput] {run} 256^3 periodic fp32 on {smi}: {rate:.4e} cell-updates/s "
              f"(best of 3 windows of 2048 steps after a warm-up){note}", flush=True)

    data_3d = state_3d.data
    out_3d = torch.empty_like(data_3d)
    affine3_ms = {}
    for k in range(1, c3.MAX_STEPS + 1):
        spec = c3.affine_laplace_3d_spec(grid_3d, a=1.0, b=dt_3d, k=k, dtype=f32)
        k_ms = _cuda_ms(torch, lambda: c3.affine_laplace_3d(data_3d, spec, out=out_3d), 20)
        p_ms = _cuda_ms(torch, lambda: c3.affine_laplace_3d_plain(data_3d, spec), 5)
        b_ms, b_by = _bound(2 * cells_3d * 4, _affine_flops(spec.scales) * k * cells_3d)
        affine3_ms[k] = (k_ms, p_ms, b_ms, b_by)
        print(f"[3d throughput] affine_laplace_3d 256^3 fp32 one k={k} pass (plan (cx, ty, tz) "
              f"{spec.tile}, halo factor {c3.halo_factor(spec.tile, k):.2f}) on {smi}: kernel "
              f"{k_ms:.4f} ms, {k_ms / k:.4f} ms per step ({cells_3d * k / k_ms * 1e3:.4e} "
              f"cell-updates/s), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    print(f"[3d plan] both affine kernels: 512 threads a block, two shared-memory planes per "
          f"level; plan (cx, ty, tz) per k, fp32 "
          f"{ {k: c3.march_plan_3d(k, 4) for k in range(1, c3.MAX_STEPS + 1)} }, fp64 "
          f"{ {k: c3.march_plan_3d(k, 8) for k in range(1, c3.MAX_STEPS + 1)} }; top k "
          f"{c3.TOP_STEPS}; least ms per step in this run at k="
          f"{min(affine3_ms, key=lambda k: affine3_ms[k][0] / k)}", flush=True)
    top_plan = c3.march_plan_3d(c3.TOP_STEPS, 4)
    for kernel_name, logs in affine_3d_logs.items():
        print(f"[3d ptxas] {kernel_name} float k={c3.TOP_STEPS} plan {top_plan} periodic: "
              + " | ".join(_ptxas_of(logs[(True,) * 3], f"{kernel_name}_kernel",
                                     "IfLi{}ELi{}ELi{}ELi{}ELb1ELb1ELb1E".format(
                                         c3.TOP_STEPS, *top_plan))), flush=True)
    multi3_ms = {}
    for label in ("allen-cahn 256^3 periodic", "diffusion 256^3 periodic through multi_stencil_3d",
                  "cahn-hilliard 256^3 periodic", "brusselator 256^3 periodic"):
        case = next(c for c in multi3 if c["label"] == label and c["dtype"] == f32)
        datas, program = case["datas"], case["window"].program
        outs = [torch.empty_like(d) for d in datas]
        for spec in case["window"].specs:
            k_ms = _cuda_ms(torch, lambda: s3.multi_stencil_3d(datas, spec, outs=outs), 20)
            p_ms = _cuda_ms(torch, lambda: s3.multi_stencil_3d_plain(datas, spec), 5)
            b_ms, b_by = _bound(2 * program.n_fields * cells_3d * 4,
                                _program_flops(program) * spec.k * cells_3d)
            multi3_ms[(label, spec.k)] = (k_ms, p_ms, b_ms, b_by)
            rungs = [spec.k >> i for i in range(spec.k.bit_length())]  # a ladder topped at k
            ptx = " | ".join(_ptxas_of(multi3_logs[label], "multi_stencil_3d_kernel",
                                       "EfLi{}ELi{}ELi{}ELi{}E".format(spec.k, *spec.tile)))
            print(f"[3d throughput] multi_stencil_3d {label} fp32 one k={spec.k} pass (plan "
                  f"(cx, ty, tz) {spec.tile}, halo factor "
                  f"{c3.halo_factor(spec.tile, spec.k * program.depth):.2f}) on {smi}: kernel "
                  f"{k_ms:.4f} ms, {k_ms / spec.k:.4f} ms per step "
                  f"({cells_3d * spec.k / k_ms * 1e3:.4e} cell-updates/s), "
                  f"{_ladder_passes(rungs, 2048)} launches per 2048-step window topped at this "
                  f"k, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); ptxas: {ptx}",
                  flush=True)
    for label in ("allen-cahn 256^3 periodic", "cahn-hilliard 256^3 periodic",
                  "brusselator 256^3 periodic"):
        program = next(c for c in multi3 if c["label"] == label)["window"].program
        layout = program.march
        print(f"[3d plan] multi_stencil_3d {label}: 512 threads a block, {len(layout.stages)} "
              f"stage(s) a step lagging {[st.lag for st in layout.stages]} planes, shared-memory "
              f"planes per volume {layout.slots}; plan (cx, ty, tz) per k, fp32 "
              f"{program.tiles[f32]}, fp64 {program.tiles[f64]}; ladder {program.ladder} "
              f"(TOP_HALO {s3.TOP_HALO}); least ms per step in this run at k="
              f"{min(program.ladder, key=lambda k: multi3_ms.get((label, k), (1e9,))[0] / k)}",
              flush=True)
    spec_top = c3.affine_laplace_3d_spec(grid_3d, a=1.0, b=dt_3d, k=c3.TOP_STEPS, dtype=f32)
    library3_ms, library3_out = _library_conv(
        torch, data_3d, _composed_stencil(torch, spec_top.a, spec_top.b, spec_top.scales,
                                          c3.TOP_STEPS), 5)
    c3.affine_laplace_3d(data_3d, spec_top, out=out_3d)
    library3_err = float((library3_out - out_3d).abs().max())
    library3_ok = library3_err <= LIBRARY_RTOL * float(out_3d.abs().max())
    print(f"[3d throughput] one circular Conv3d with the composed {2 * c3.TOP_STEPS + 1}^3 "
          f"stencil of a k={c3.TOP_STEPS} affine pass, 256^3 fp32 on {smi}: {library3_ms:.4f} ms "
          f"(max_abs vs kernel {library3_err:.3e} {'ok' if library3_ok else 'FAIL'})", flush=True)
    if not library3_ok:
        raise AssertionError("the composed-stencil Conv3d does not compute the affine pass")
    del library3_out

    ac_case = next(c for c in multi3 if c["label"] == "allen-cahn 256^3 periodic")
    ac_top = ac_case["window"].specs[0].k
    affine_ladder = [spec.k for spec in c3.make_fused_euler_window_3d(
        grid_3d, diffusivity=1.0, dt=dt_3d).specs]
    ac_ladder = ac_case["window"].program.ladder
    print(f"[3d] passes per 2048-step window: affine_laplace_3d (ladder {affine_ladder}) "
          f"{_ladder_passes(affine_ladder, 2048)}, multi_stencil_3d Allen-Cahn (ladder "
          f"{ac_ladder}) {_ladder_passes(ac_ladder, 2048)}", flush=True)
    # idle share of one traced 2048-step window: device kernel time (the trace's
    # CUDA events) over the window's wall time
    from torch.profiler import ProfilerActivity, profile

    for run, stepper in steppers_3d.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            stepper(state_3d, 0.0, 2048 * dt_3d)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - start) * 1e6
        kernel_us = {}
        for event in prof.key_averages():
            device_us = getattr(event, "self_device_time_total", None)
            if device_us is None:
                device_us = event.self_cuda_time_total
            if device_us > 0:
                kernel_us[event.key] = kernel_us.get(event.key, 0.0) + device_us
        busy_us = sum(kernel_us.values())
        top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:3]
        idle = "not measured (the trace holds no device time)" if busy_us == 0 else (
            f"{1.0 - busy_us / wall_us:.4%}")
        print(f"[3d trace] {run} 256^3 one 2048-step window (torch.profiler) on {smi}: wall "
              f"{wall_us:.1f} us, device kernels {busy_us:.1f} us, idle share {idle}; top: "
              + "; ".join(f"{name[:60]} {us:.1f} us" for name, us in top), flush=True)

    # -- 15. kernel vs plain (stencil operators) ---------------------------------------------
    cuda_engine = pde.get_backend("cuda")
    op_gen = np.random.default_rng(20)
    op_errs = {}
    for label, grid, bc in _operator_grids(pde):
        bcs = grid.get_boundary_conditions(bc)
        for dtype in (f32, f64):
            results = []
            for op in REGISTRY_OPS:
                if op == "laplace":
                    spec = cc.affine_laplace_spec(grid, a=0.0, b=1.0, k=1, dtype=dtype, bcs=bcs)
                    data = torch.as_tensor(op_gen.uniform(-1, 1, grid.shape), dtype=dtype,
                                           device=device)
                    out = cc.affine_laplace_2d(data, spec)
                    ref = cc.affine_laplace_2d_plain(data, spec)
                else:
                    spec = so.stencil_op_2d_spec(grid, op, dtype=dtype, bcs=bcs)
                    data = torch.as_tensor(op_gen.uniform(-1, 1, (spec.n_in, *grid.shape)),
                                           dtype=dtype, device=device)
                    out, ref = so.stencil_op_2d(data, spec), so.stencil_op_2d_plain(data, spec)
                torch.cuda.synchronize()
                scale = float(ref.abs().max())
                err = float((out - ref).abs().max())
                tol = (F64_TOL if dtype == f64 else F32_STEP_RTOL) * scale
                ok = bool(torch.isfinite(out).all()) and err <= tol
                op_errs[(label, str(dtype), op)] = err
                results.append(f"{op} max_rel={err / scale:.3e}" + ("" if ok else " FAIL"))
                if not ok:
                    print(f"[ops] {label} {str(dtype)[6:]}: {results[-1]} (tol {tol:.1e})")
                    raise AssertionError(f"stencil-operator kernel disagrees with its plain "
                                         f"version: {label} {op}")
            print(f"[ops] kernel vs plain, {label} {str(dtype)[6:]}: {'; '.join(results)} ok",
                  flush=True)
    refused = []
    for what, make in (
        ("an unregistered operator", lambda: cuda_engine.make_operator(big, "poisson_solver",
                                                                       "periodic")),
        ("a 1D grid", lambda: cuda_engine.make_operator(pde.UnitGrid([4096], periodic=True),
                                                        "gradient", "periodic")),
        ("an array BC value", lambda: cuda_engine.make_operator(
            pde.UnitGrid([64, 64]), "vector_laplace",
            {"x": {"value": np.linspace(0, 1, 64)}, "y": {"derivative": 0}})),
    ):
        try:
            make()
        except pde.KernelUnsupportedError as err:
            refused.append(f"{what}: {str(err)[:70]}")
        else:
            raise AssertionError(f"the cuda registry served {what}")
    print(f"[ops] the cuda registry refuses {'; '.join(refused)} ok", flush=True)

    # -- 16. main path (operators and vector states) ------------------------------------------
    counters_all = counters_3d + (so.stencil_op_2d,)
    for counter in counters_all:
        counter.launches = 0
    grid_op = pde.UnitGrid([4096, 4096], periodic=True)
    op_fields = [cls.random_uniform(grid_op, -1, 1, dtype=f32, rng=np.random.default_rng(21 + i))
                 for i, cls in enumerate((pde.ScalarField, pde.VectorField, pde.Tensor2Field))]
    if any(f.device.type != "cuda" for f in op_fields):
        raise AssertionError("a field made without device= does not lie on the card")
    op_results = []
    for op, (rank, method, _) in REGISTRY_OPS.items():
        field = op_fields[rank]
        out = cuda_engine.make_operator(grid_op, op, "periodic")(field.data)
        ref = getattr(field, method)("periodic")  # the plain operator
        torch.cuda.synchronize()
        scale = float(ref.data.abs().max())
        err = float((out - ref.data).abs().max())
        ok = (tuple(out.shape) == tuple(ref.data.shape) and bool(torch.isfinite(out).all())
              and err <= F32_STEP_RTOL * scale)
        op_results.append(f"{op} -> {type(ref).__name__}{list(out.shape[:-2])} max_rel "
                          f"{err / scale:.3e}" + ("" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"the cuda registry's {op} disagrees with the field method")
    op_counts = {c.__name__: c.launches for c in counters_all}
    if op_counts["stencil_op_2d"] <= 0 or op_counts["affine_laplace_2d"] <= 0:
        raise AssertionError(f"the operator main path launched no kernel: {op_counts}")
    stencil_op_launches = op_counts["stencil_op_2d"]
    print(f"[ops main] get_backend('cuda').make_operator on 4096^2 periodic fp32 fields (made "
          f"without device=, on {op_fields[0].device}) against the field methods' plain "
          f"operators: {'; '.join(op_results)}; launches {op_counts} ok", flush=True)

    vector_launches = {}
    vector_steppers = {}
    for run, (eq_v, dt_v, state_v) in vector_runs.items():
        kernel = s3.multi_stencil_3d if state_v.grid.num_axes == 3 else cs.multi_stencil_2d
        for counter in counters_all:
            counter.launches = 0
        solver_v = pde.EulerSolver(eq_v, backend="cuda")
        stepper_v = solver_v.make_stepper(state_v, dt=dt_v)
        result_v, t_v = stepper_v(state_v, 0.0, 37 * dt_v)
        solved_v = eq_v.solve(state_v, t_range=50 * dt_v, dt=dt_v, tracker="auto", backend="cuda")
        torch.cuda.synchronize()
        counts = {c.__name__: c.launches for c in counters_all}
        vector_launches[run] = counts[kernel.__name__]
        if not (solver_v.info.get("fused_step") and eq_v.diagnostics["solver"].get("fused_step")):
            raise AssertionError(f"the vector main path {run} did not take the fused window")
        if counts[kernel.__name__] <= 0:
            raise AssertionError(f"the vector main path {run} launched no {kernel.__name__}")
        plain_v, _ = pde.EulerSolver(eq_v, backend="numpy").make_stepper(state_v, dt=dt_v)(
            state_v, 0.0, 37 * dt_v)
        torch.cuda.synchronize()
        scale_v = float(plain_v.data.abs().max())
        err_v = float((result_v.data - plain_v.data).abs().max())
        checks_v = [
            type(result_v) is type(state_v) and type(solved_v) is type(state_v),
            result_v.data.shape == state_v.data.shape and result_v.dtype == f32,
            bool(torch.isfinite(result_v.data).all()) and bool(torch.isfinite(solved_v.data).all()),
            abs(t_v - 37 * dt_v) < 1e-9 and solver_v.info["steps"] == 37,
            err_v <= F32_STEP_RTOL * 37 * scale_v,
        ]
        print(f"[vector main] {run} {type(state_v).__name__} fp32 dt={dt_v} (backend='cuda', "
              f"{vector_windows[run].program.n_fields} planes): make_stepper 37 steps max_abs vs "
              f"plain loop {err_v:.3e} (tol {F32_STEP_RTOL * 37 * scale_v:.1e}); solve to "
              f"t={50 * dt_v:g} with the default trackers; launches {counts} "
              f"{'ok' if all(checks_v) else 'FAIL'}", flush=True)
        if not all(checks_v):
            raise AssertionError(f"vector main path checks failed ({run}): {checks_v}")
        vector_steppers[run] = stepper_v
    gl_window = vector_windows["ginzburg-landau 4096^2"]
    gl_state = vector_runs["ginzburg-landau 4096^2"][2]
    gl_planes = [gl_state.data[0], gl_state.data[1]]
    for spec in gl_window.specs:
        check_multi("vector ginzburg-landau 4096^2 (2 planes)", gl_window, gl_planes, f32,
                    spec=spec)
    gl64_state = pde.VectorField.random_uniform(pde.UnitGrid([512, 512], periodic=True), -0.5,
                                                0.5, dtype=torch.float64, device=device,
                                                rng=np.random.default_rng(4))
    gl64_window = pde.PDE(GINZBURG_LANDAU).make_fused_euler_window(gl64_state, 1e-3)
    for spec in gl64_window.specs:
        check_multi("vector ginzburg-landau 512^2 (2 planes)", gl64_window,
                    [gl64_state.data[0], gl64_state.data[1]], torch.float64, spec=spec)

    # -- 17. throughput (operators and vector states) -----------------------------------------
    cells_op = 4096 * 4096
    op_times = {}
    for op, (rank, _, flops) in REGISTRY_OPS.items():
        data = op_fields[rank].data
        if op == "laplace":
            spec = cc.affine_laplace_spec(grid_op, a=0.0, b=1.0, k=1, dtype=f32)
            planes, n_in, n_out = data, 1, 1
            out = torch.empty_like(data)
            k_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d(planes, spec, out=out), 50)
            p_ms = _cuda_ms(torch, lambda: cc.affine_laplace_2d_plain(planes, spec), 5)
            halves = so.stencil_op_2d_spec(grid_op, "gradient", dtype=f32)
        else:
            spec = halves = so.stencil_op_2d_spec(grid_op, op, dtype=f32)
            planes, n_in, n_out = data.reshape(spec.n_in, 4096, 4096), spec.n_in, spec.n_out
            out = torch.empty((n_out, 4096, 4096), dtype=f32, device=device)
            k_ms = _cuda_ms(torch, lambda: so.stencil_op_2d(planes, spec, out=out), 50)
            p_ms = _cuda_ms(torch, lambda: so.stencil_op_2d_plain(planes, spec), 5)
        op_bytes = (n_in + n_out) * cells_op * 4
        b_ms, b_by = _bound(op_bytes, flops * cells_op)
        library = _operator_conv(torch, op, halves, planes)
        lib_ms, lib_note = None, "no single library call (the square of a convolution)"
        if library is not None:
            conv, x = library
            allow_tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                with torch.no_grad():
                    lib_out = conv(x)[0].reshape(out.shape)
                    lib_ms = _cuda_ms(torch, lambda: conv(x), 10)
            finally:
                torch.backends.cudnn.allow_tf32 = allow_tf32
            lib_err = float((lib_out - out).abs().max())
            if lib_err > LIBRARY_RTOL * float(out.abs().max()):
                raise AssertionError(f"the Conv2d does not compute {op}: max_abs {lib_err:.3e}")
            lib_note = f"circular Conv2d {lib_ms:.4f} ms (max_abs vs kernel {lib_err:.3e} ok)"
            del lib_out
        op_times[op] = (k_ms, p_ms, b_ms, b_by, lib_ms)
        print(f"[ops throughput] {op} 4096^2 periodic fp32 ({n_in} -> {n_out} planes) on {smi}: "
              f"kernel {k_ms:.4f} ms ({op_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s), "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {lib_note}", flush=True)
        del out

    gl_stepper = vector_steppers["ginzburg-landau 4096^2"]
    dt_gl = vector_runs["ginzburg-landau 4096^2"][1]
    data_gl, t_gl = gl_stepper(gl_state, 0.0, 2048 * dt_gl)  # warm-up
    torch.cuda.synchronize()
    gl_rate = 0.0
    for _ in range(3):
        start = time.perf_counter()
        data_gl, t_gl = gl_stepper(data_gl, t_gl, t_gl + 2048 * dt_gl)
        torch.cuda.synchronize()
        gl_rate = max(gl_rate, cells_op * 2048 / (time.perf_counter() - start))
    if not bool(torch.isfinite(data_gl.data).all()):
        raise AssertionError("the vector Ginzburg-Landau throughput windows ended non-finite")
    gl_plain = pde.EulerSolver(pde.PDE(GINZBURG_LANDAU), backend="numpy").make_stepper(
        gl_state, dt=dt_gl)
    gl_plain_rate = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        gl_plain(gl_state, 0.0, 16 * dt_gl)
        torch.cuda.synchronize()
        gl_plain_rate = max(gl_plain_rate, cells_op * 16 / (time.perf_counter() - start))
    gl_top = gl_window.specs[0]
    gl_outs = [torch.empty_like(p) for p in gl_planes]
    gl_k_ms = _cuda_ms(torch, lambda: cs.multi_stencil_2d(gl_planes, gl_top, outs=gl_outs), 20)
    gl_b_ms, gl_b_by = _bound(2 * len(gl_planes) * cells_op * 4,
                              _program_flops(gl_window.program) * gl_top.k * cells_op)
    print(f"[vector throughput] ginzburg-landau 4096^2 periodic fp32 on {smi}: {gl_rate:.4e} "
          f"cell-updates/s per plane, both planes advanced (best of 3 windows of 2048 steps after "
          f"a warm-up; ladder {gl_window.program.ladder}, "
          f"{_ladder_passes(gl_window.program.ladder, 2048)} passes per window); plain step loop "
          f"{gl_plain_rate:.4e} (best of 3 x 16 steps); one k={gl_top.k} pass (tile "
          f"{gl_top.tile}) {gl_k_ms:.4f} ms, bound {gl_b_ms:.4f} ms ({gl_b_by})", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        gl_stepper(gl_state, 0.0, 2048 * dt_gl)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    kernel_us = {}
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", None)
        if device_us is None:
            device_us = event.self_cuda_time_total
        if device_us > 0:
            kernel_us[event.key] = kernel_us.get(event.key, 0.0) + device_us
    busy_us = sum(kernel_us.values())
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:3]
    idle = "not measured (the trace holds no device time)" if busy_us == 0 else (
        f"{1.0 - busy_us / wall_us:.4%}")
    print(f"[vector trace] ginzburg-landau 4096^2 one 2048-step window (torch.profiler) on "
          f"{smi}: wall {wall_us:.1f} us, device kernels {busy_us:.1f} us, idle share {idle}; "
          "top: " + "; ".join(f"{name[:60]} {us:.1f} us" for name, us in top), flush=True)

    ext = _decomposed(pde, torch, np, device, smi, ext_windows, best)
    ext3 = _decomposed_3d(pde, torch, np, device, smi, ext_windows_3d, ext3_logs)
    family_logs = {key: all_builds[len(all_builds) - len(late_units) + late_units.index(program)][
        "log"] for key, program in family_units}
    family_rows = _solver_family(pde, torch, np, device, smi, family, family_logs)
    sharded_family_logs = {key: all_builds[
        len(all_builds) - len(late_units) + late_units.index(window.program)]["log"]
        for key, window in sharded_family.items()}
    sharded_family_rows = _sharded_family(pde, torch, np, device, smi, sharded_family,
                                          sharded_family_logs)
    curvilinear_logs = {
        unit.digest: all_builds[len(all_builds) - len(late_units) + late_units.index(unit)]["log"]
        for unit in curvilinear["units"]}
    curvilinear_rows = _curvilinear(pde, torch, np, device, smi, curvilinear, curvilinear_logs)
    curvilinear_rows.append(_decomposed_curvilinear(pde, torch, np, device, smi, curvilinear,
                                                    curvilinear_logs))
    _poisson_phase(pde, torch, np, device, smi)
    _implicit_phase(pde, torch, np, device, smi)
    _etdrk_phase(pde, torch, np, device, smi)
    side_logs = {unit.digest: all_builds[len(all_builds) - len(late_units) + late_units.index(
        unit)]["log"] for unit in side_units["units"]}
    side_rows = _side_inputs(pde, torch, np, device, smi, side_units, side_logs, kernel_ms)
    _trackers_phase(pde, torch, np, device, smi)
    _trackers_cahn_hilliard(pde, torch, np, device, smi)
    _api_phase(pde, torch, np, device, smi)
    ks_logs = {unit.digest: all_builds[len(all_builds) - len(late_units) + late_units.index(
        unit)]["log"] for unit in ks_units}
    ks_rows = _ks_phase(pde, torch, np, device, smi, ks_windows, ks_logs)
    _rd_kg_1d_phase(pde, torch, np, device, smi)

    def late_build(unit):
        return all_builds[len(all_builds) - len(late_units) + late_units.index(unit)]

    corner_rows = _corner_phase(
        pde, torch, np, device, smi, {unit: late_build(unit) for unit in corner_units},
        {"affine_laplace_2d": late_build(cc.kernel_source((True, True))),
         "affine_laplace_ext_2d": late_build(ce.affine_ext_source((True, True)))})
    _ops_options_phase(pde, torch, np, device, smi)
    movie_result = _movie_phase(pde, torch, np, device, smi)
    _plots_phase(pde, torch, np, device, smi, movie_result)
    _bc_setter_phase(pde, torch, np, device, smi)
    sde_side_errs = _sde_sides_phase(pde, torch, np, device, smi, sde_side_units)
    sde_side_rows = _sde_sides_main(
        pde, torch, np, device, smi, sde_side_units,
        {unit.digest: late_build(unit) for unit in sde_side_units["units"]}, sde_side_errs,
        {case["route"]: built for case, built in zip(sde_cases, all_builds[len(multi):])
         if case["label"] == "kpz 4096^2 periodic"})
    _milstein_phase(pde, torch, np, device, smi)
    _correlated_noise_phase(pde, torch, np, device, smi)
    sharded_side_errs = _sharded_sides_phase(pde, torch, np, device, smi, sharded_side_units)
    scalar_ext_units = [ce.affine_ext_source(p) for p in ((True, True), (False, False))]
    ch_scalar = ext_windows["cahn-hilliard no-flux"]
    sharded_side_rows = _sharded_sides_main(
        pde, torch, np, device, smi, sharded_side_units,
        {unit.digest: late_build(unit) for unit in
         [*sharded_side_units["units"], *scalar_ext_units, ch_scalar.program]},
        sharded_side_errs, scalar_ext_units, ch_scalar)
    _a9_plain_phase(pde, torch, np, device, smi)
    sides3d_errs = _sides3d_phase(pde, torch, np, device, smi, sides3d_units)
    sides3d_rows = _sides3d_main(
        pde, torch, np, device, smi, sides3d_units,
        {unit.digest: late_build(unit) for unit in sides3d_units["units"]}, sides3d_errs)
    ac_index = next(i for i, c in enumerate(multi3) if c["label"] == "allen-cahn 256^3 periodic")
    ac_serial = multi3[ac_index]["window"].program
    ac_ext = ext_windows_3d["allen-cahn periodic"].program
    _sides3d_sass(smi, [
        ("allen-cahn 256^3 periodic", "multi_stencil_3d_kernel", ac_serial.ladder,
         ac_serial.tiles[f32], all_builds[first_3d + len(affine_units) + ac_index]),
        ("allen-cahn periodic [2, 2, 2]", "multi_stencil_ext_3d_kernel", ac_ext.ladder,
         ac_ext.tiles[f32], late_build(ac_ext))])
    this = sys.modules[__name__]
    radial_sides_errs = rsp.kernels_phase(this, pde, torch, np, device, smi)
    radial_sides_rows = rsp.main_phase(
        this, pde, torch, np, device, smi, radial_sides_errs,
        {unit.digest: late_build(unit)["log"] for unit in radial_sides_units})
    rk4_3d_errs = r3p.kernels_phase(this, pde, torch, np, device, smi, rk4_3d_units)
    rk4_3d_rows = r3p.main_phase(
        this, pde, torch, np, device, smi, rk4_3d_units, rk4_3d_errs,
        {unit.digest: late_build(unit)["log"] for unit in rk4_3d_units["units"]})
    bf16_start = time.perf_counter()
    bf16_results = bfp.kernels_phase(
        this, pde, torch, np, device, smi, bf16_units,
        {unit.digest: late_build(unit)["log"] for unit in bf16_units["units"]},
        {unit.digest: late_build(unit)["path"] for unit in bf16_units["units"]})
    bf16_71 = time.perf_counter() - bf16_start
    bf16_rows = bfp.main_phase(this, pde, torch, np, device, smi, bf16_units, bf16_results)
    bf16_builds = [late_build(unit) for unit in bf16_units["units"]]
    print(f"[bf16 time] phase 71 {bf16_71:.1f} s, phase 72 "
          f"{time.perf_counter() - bf16_start - bf16_71:.1f} s; their {len(bf16_builds)} "
          f"libraries {sum(b['cpu_seconds'] for b in bf16_builds):.1f} CPU-s of nvcc, the "
          f"last collected {max(b['seconds'] for b in bf16_builds):.1f} s into the build",
          flush=True)
    deep_start = time.perf_counter()
    deep_results = dpp.kernels_phase(
        this, pde, torch, np, device, smi, deep_units,
        {unit.digest: late_build(unit)["log"] for unit in deep_units["units"]})
    deep_73 = time.perf_counter() - deep_start
    deep_rows = dpp.main_phase(this, pde, torch, np, device, smi, deep_units, deep_results)
    deep_builds = [late_build(unit) for unit in deep_units["units"]]
    print(f"[deep time] phase 73 {deep_73:.1f} s, phase 74 "
          f"{time.perf_counter() - deep_start - deep_73:.1f} s; their {len(deep_builds)} "
          f"libraries {sum(b['cpu_seconds'] for b in deep_builds):.1f} CPU-s of nvcc, the "
          f"last collected {max(b['seconds'] for b in deep_builds):.1f} s into the build",
          flush=True)

    # -- the kernels' bounds at the shapes timed above -------------------------------------------
    cells_2d = 4096 * 4096
    affine2_bound = _bound(2 * cells_2d * 4, _affine_flops((1.0, 1.0)) * affine_top * cells_2d)
    ch_program = ch_window.program
    multi2_bound = _bound(2 * 1024 * 1024 * 4, _program_flops(ch_program) * top_k * 1024 * 1024)
    kpz_flops = _program_flops(staged_spec.program.stencil) + 1
    staged_bound = _bound((2 + staged_spec.k) * cells_2d * 4, kpz_flops * staged_spec.k * cells_2d)
    kn_bound = _bound(2 * cells_2d * 4,
                      (kpz_flops + PHILOX_OPS + IRWIN4_OPS + 1) * kn_spec.k * cells_2d)

    rows = [{
        "name": "affine_laplace_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:793",
        "launches": launches,
        "max_abs_err": main_errs[(str(f32), affine_top)],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": affine2_bound[0],
        "bound_by": affine2_bound[1],
        "library_ms": library2_ms,
    }, {
        "name": "multi_stencil_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:3755",
        "launches": multi_launches,
        "max_abs_err": multi_errs[(ch_case["label"], str(f32), top_k)],
        "ms": per_k[top_k][0],
        "plain_ms": per_k[top_k][1],
        "bound_ms": multi2_bound[0],
        "bound_by": multi2_bound[1],
        "library_ms": None,
    }, {
        "name": "sde_stencil_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/multi_stencil_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:4831",
        "launches": sde_launches["sde_stencil_2d"],
        "max_abs_err": sde_errs[("kpz 4096^2 periodic", "normal", str(f32), staged_spec.k)],
        "ms": staged_ms,
        "plain_ms": staged_plain_ms,
        "bound_ms": staged_bound[0],
        "bound_by": staged_bound[1],
        "library_ms": None,
    }, {
        "name": "sde_kernel_noise_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/philox.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:4660",
        "launches": sde_launches["sde_kernel_noise_2d"],
        "max_abs_err": sde_errs[("kpz 4096^2 periodic", "irwin4", str(f32), kn_spec.k)],
        "ms": kn_ms,
        "plain_ms": kn_plain_ms,
        "bound_ms": kn_bound[0],
        "bound_by": kn_bound[1],
        "library_ms": None,
    }, {
        "name": "affine_laplace_3d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_laplace_3d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:1501",
        "launches": launches_3d["affine_laplace_3d"],
        "max_abs_err": affine3_errs[("periodic 256^3", str(f32), c3.TOP_STEPS)],
        "ms": affine3_ms[c3.TOP_STEPS][0],
        "plain_ms": affine3_ms[c3.TOP_STEPS][1],
        "bound_ms": affine3_ms[c3.TOP_STEPS][2],
        "bound_by": affine3_ms[c3.TOP_STEPS][3],
        "library_ms": library3_ms,
    }, {
        "name": "multi_stencil_3d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/multi_stencil_3d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:2935, pde_tpu/ops/pallas_cartesian.py:2562",
        "launches": launches_3d["multi_stencil_3d"],
        "max_abs_err": multi3_errs[("allen-cahn 256^3 periodic", str(f32), ac_top)],
        "ms": multi3_ms[("allen-cahn 256^3 periodic", ac_top)][0],
        "plain_ms": multi3_ms[("allen-cahn 256^3 periodic", ac_top)][1],
        "bound_ms": multi3_ms[("allen-cahn 256^3 periodic", ac_top)][2],
        "bound_by": multi3_ms[("allen-cahn 256^3 periodic", ac_top)][3],
        "library_ms": None,
    }, {
        "name": "stencil_op_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/stencil_op_2d.cu",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:1336",
        "launches": stencil_op_launches,
        "max_abs_err": op_errs[("periodic 4096^2", str(f32), "vector_gradient")],
        "ms": op_times["vector_gradient"][0],
        "plain_ms": op_times["vector_gradient"][1],
        "bound_ms": op_times["vector_gradient"][2],
        "bound_by": op_times["vector_gradient"][3],
        "library_ms": op_times["vector_gradient"][4],
    }, {
        "name": "affine_laplace_ext_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:5792",
        **ext["affine_laplace_ext_2d"],
    }, {
        "name": "multi_stencil_ext_2d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/march_2d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:4081",
        **ext["multi_stencil_ext_2d"],
    }, {
        "name": "affine_laplace_ext_3d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/affine_laplace_ext_3d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:5523",
        **ext3["affine_laplace_ext_3d"],
    }, {
        "name": "multi_stencil_ext_3d",
        "route": "cuda",
        "source": "pde_tpu_torch/csrc/multi_stencil_3d.cuh",
        "replaces": "pde_tpu/ops/pallas_cartesian.py:3443, "
                    "pde_tpu/ops/pallas_cartesian.py:2562 (ext_x)",
        **ext3["multi_stencil_ext_3d"],
    }]
    rows += (family_rows + sharded_family_rows + curvilinear_rows + side_rows + ks_rows
             + corner_rows + sde_side_rows + sharded_side_rows + sides3d_rows
             + radial_sides_rows + rk4_3d_rows + bf16_rows + deep_rows)
    for row in rows:  # `ms` is the time of a call; the launches queued, where measured
        row.setdefault("queued_ms", None)
    print(f"[time] chip_smoke.py took {time.perf_counter() - started:.1f} s from the start of "
          "main(), the build included", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
