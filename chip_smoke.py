#!/usr/bin/env python3
"""Drive openlbmpm_torch's main paths on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; JAX is not needed.  Phases:

  1. the card (name and power limit from nvidia-smi);
  2. build the CUDA kernels from ``openlbmpm_torch/csrc`` (one nvcc per
     library, side by side);
  3. f64: kernel against the plain PyTorch step, 20 steps on a 256x128
     walled channel with a layered interface (contact lines on both walls),
     Neumann inlet, Dirichlet outlet, MRT, then on a 96x64 periodic porous
     mask (30% random solid) with Xu wetting and a droplet (xu_porous_model),
     compressed (K1) and split (K6); max |difference| <= 1e-11;
  4. the flagship configuration (1024^2, bench.py's parameters), 10 steps of
     kernel and plain path at f64 (<= 1e-11), in f32 (<= 3e-5 off the
     inlet/outlet seam rows and the corners where they meet the walls, and
     no further from f64 than the plain f32 path) and in bf16 storage
     (planes <= 3e-4 and rho_r <= 1e-4 off the seam, no further from f64
     than the plain bf16 path; then one more step of each from the same
     bf16 state, which must agree to 1 bf16 ulp per stored value, the lo
     half of rho_r wherever the hi half agrees, with at most 1e-3 of the
     values >= 1e-4 off at all, a check that a round-toward-zero or
     dropped-lo encoding of the plain result is shown to fail);
  5. the flow's main path: ``run_chunked(model.step_c, ...)`` for 1000 bf16
     steps with the NaN guard, the kernel's launch count checked (and the
     library's own count: one strip_kernel a step, nothing else), then MLUPS
     of kernel (f32, bf16) and plain path (f32, bf16), and each CUDA
     kernel's device time per launch from ``torch.profiler``;
  6. f64: the coupled flow + tracer kernels against their plain version,
     20 steps on a 96x64 walled channel (layered interface, Neumann inlet,
     Dirichlet outlet, MRT) with tracer mass on the boundary rows, in six
     tracer cases (D2Q5 SRT permeable with Inamuro inlet and free-flow
     outlet, bounce-back, three reacting tracers, D2Q5 MRT quadratic with
     anti-bounce-back inlet, D2Q9 SRT, zero inlet); max |difference| over
     the flow state and the tracer PDFs <= 1e-11;
  7. the coupled transport configuration at 1024^2 (bench_all.py config 4),
     10 steps of kernel and plain path in f32 and in bf16 flow storage:
     flow planes, rho_r and tracer PDFs off the seam within phase 4's bounds,
     tracer mass within 1e-7 per step of its start and of the plain path,
     everything finite, concentrations >= -1e-4;
  8. the coupled main path: ``run_chunked(model.step_c, (s, g), ...)`` at
     config 4 with bf16 flow storage for 500 steps with the NaN guard, the
     coupled launch count checked (the library's: two launches a step, the
     tracer's tracer_strip_kernel and the flow's strip_kernel), then MLUPS of
     kernel (f32, bf16) and
     plain path (f32, bf16), the roofline share, and each CUDA kernel's
     device time per launch;
  9. f64: the split (f_r, f_b) CSF kernel against its plain version, 20
     steps on the 256x128 channel of phase 3, SRT and MRT, with a Neumann
     inlet and Dirichlet outlet and with a per-colour Dirichlet inlet
     (nonzero densities) and convective outlet; max |difference| <= 1e-11;
 10. the golden file tests/golden/csf_mini.npz reproduced through the split
     kernel at f64 (its 48x24 setup, 50 steps, atol 1e-10);
 11. f64: the split coupled kernels against their plain version, 20 steps
     on phase 6's 96x64 channel with tracer mass on the boundary rows, in
     phase 6's six cases plus conserve_mass, the redistribute interface
     and standalone transport; max |difference| <= 1e-11;
 12. the CLI on the card: ``openlbmpm_torch.cli.main(["run", ...])`` with
     ``--model cg --block 1`` (one step a launch; phase 50 drives the
     T-step kernels) on configs/rk_csf2d.ini set to a 1024^2 domain for 1000
     f32 steps, then ``--model transport --block 1`` (phase 56 drives its
     T-step kernel) with configs/transportsetup.ini
     and that INI as the flow config for 500 steps; the split kernels'
     launch counts must rise by exactly the step counts (the libraries'
     counts a step: K6 one launch, K5s two), the final states
     must be finite, and the MLUPS of metrics.jsonl are printed (they
     include each output step's I/O);
 13. split f32 at 1024^2: MLUPS of the split CSF kernel and its plain path
     (flagship flow), of the split coupled kernels and their plain path
     (config 4, also with the conserve_mass and with the redistribute repair
     after the kernels), and each CUDA kernel's device time per launch;
 14. the split kernels in f32, the type the CLI runs, against their plain
     versions at full size, 10 steps from one f64 start: the split CSF
     kernel on the flagship flow and on the CLI's cg configuration
     (rk_csf2d.ini at 1024^2 plus its buffer rows), the split coupled
     kernels on config 4 and on the CLI's transport configuration; f64
     <= 1e-11, f32 off the seam within phase 4's 3e-5 (tracers also off the
     rows next to the seam), the kernel no further from f64 than
     max(1.5x the plain f32 path, 3e-5), rho_r and tracer mass as in
     phases 4 and 7;
 15. f64: the Shan-Chen kernel K8 against its plain version, 20 steps on a
     128x64 walled channel, in the ten kernel cases of SC_CASES (SC SRT/MRT,
     periodic, Zou-He velocity/convective and pressure/pressure rows,
     Peng-Robinson psi with one fluid, three fluids, EFS iso-4/8/10 SRT and
     MRT); max |difference| <= 1e-11; the library's own count of each
     kernel's launches a step (sc_push_kernel once, sc_outlet_kernel once
     with an outlet, the bf16 pull never); the
     guo/edm/Chang/true-convective/moving-wall cases take the plain step on
     the card;
 16. the golden file tests/golden/sc_mini.npz through K8 at f64 (50 steps,
     atol 1e-10);
 17. bench_all.py configs 2 (SC droplet on a wall) and 3 (EFS iso-8 MRT at
     viscosity contrast) at 1024^2: 10 steps of K8 and plain from one f64
     start at f64 (<= 1e-11), f32 and bf16 storage (SC_BOUNDS, about 10x
     the measured gaps; one more bf16 step within one ulp per value); the
     same at f64 and f32 on what ``run --model sc`` builds (phase 18's two
     configurations, with their inlet and outlet rows); then
     config 3 for 600 f32 steps on K8 (mass drift < 2e-5, u_max < 0.05) and
     config 2's equilibrated 256^2 contact angle on K8 (window drift < 2
     degrees, within 12 of the analytic angle);
 18. the CLI on the card: ``cli.main(["run", ...])`` with ``--model sc
     --block 1`` on
     configs/twophasesetup.ini set to 1024^2, with shanchen2D.ini and as
     EFS with efs2D.ini, 1000 f32 steps each: K8's launch count must rise
     by exactly the steps (and the library's counts: one push and one
     outlet launch a step), the final checkpoint must be finite, and the
     MLUPS of metrics.jsonl are printed;
 19. MLUPS of K8 and of its plain path at 1024^2 (configs 2 and 3, f32 and
     bf16 storage), each CUDA kernel's device time per launch, its
     launches a step by the library's own count (f32 the push alone; bf16
     collide_stream_kernel alone) and the roofline share;
 20. f64: the D3Q19 CSF kernels K9c (compressed) and K9s (split) against
     their plain versions, 20 steps, in every case of CG3D_CASES (<= 1e-11;
     the grain pack <= max(1e-11, 2x the plain path's one-ulp twin gap)),
     and K9's fields kernel (``cg3d_fields``: g and kappa) against
     ``cg3d_fields_reference`` on each case's start, both layouts
     (<= 1e-12), then K9h one step from a common bf16 state within one bf16
     ulp;
 21. configuration 5 (bench_cg3d.py's grain pack) at 128^3, 10 steps from
     one f64 start: f64 <= 1e-11, K9c and K9s f32 and K9h bf16 against
     their plain versions (``_hold``: the bound far from walls and seam,
     off the seam the bound or the capped one-ulp twin gap), total rho_r;
     ``chip_faults.py`` shows that a fault planted in one storage type's
     instance fails this phase;
 22. bench_cg3d.py's physics on K9c f32 (porosity, front advance over 4000
     steps), then the K9h and K9s main paths through ``run_chunked``;
 23. ``run --model cg3d`` on configs/rk_csf3d.ini: one K9c launch a step;
 24. MLUPS of K9c, K9h and K9s at 128^3 and 256^3 and of the plain paths at
     128^3, device time per launch and launches a step (bc_kernel,
     fields_kernel and collide_stream_kernel each in the trace, at most
     once a step, at configuration 5: 3 launches a step, 2 without an inlet
     or outlet), and the roofline share;
 25. f64: the coupled D3Q19 CSF + D3Q7 tracer kernel K9t against its plain
     version, 20 steps, in every case of CG3D_TRANSPORT_CASES (an open
     periodic box, the probe's walls and boundaries, a Dirichlet outlet with
     two tracers, no interface, the grain pack); flow state and tracer PDFs
     <= 1e-11, the grain pack to the phase 20 twin rule;
 26. benchmarks/probe_coupled3d.py's configuration at 128^3, 10 steps from
     one f64 start: f64 <= 1e-11 and the tracer's leak into the red phase <
     1e-10 of its mass; f32 and bf16 flow storage (f32 tracers) against the
     plain path by phase 21's rule (``_hold``, PROBE3D_TWIN_CAP), the bf16
     tracer mass within 1e-6 of the f32 run's; ``chip_faults.py`` shows a
     tracer fault planted in the f32 instance failing this phase;
 27. ``run --model transport3d`` on configs/transportsetup.ini with
     rk_csf3d.ini, 1000 steps: one K9t launch a step, finite tracer masses;
     then ``run_chunked(step_c)`` with bf16 flow storage at 128^3;
 28. MLUPS of K9t (f32 and bf16 flow storage) at 128^3 and 256^3 and of its
     plain paths at 128^3, device time per launch and the roofline share;
 29. f64: the single-phase D2Q9 kernel K7 against its plain version, 20
     steps on a 256x128 channel with side walls and a body force, SRT, TRT
     and MRT under each row pair of SINGLE_CASES (Zou-He velocity +
     pressure, Zou-He pressure + convective, periodic); <= 1e-11;
 30. bench_all.py config 1 (512x1024 box, MRT, tau 0.9, g = -1e-6) at full
     size, 10 steps of K7 and plain from one perturbed f64 start: f64
     <= 1e-11, f32 <= SINGLE_F32_BOUND, bf16 decoded <= BF16_BOUND, then
     one bf16 step within one bf16 ulp per stored value
     (``bf16_ulp_check``);
 31. the analytic Poiseuille profile through K7 (f32, 130x1024 channel,
     tau 0.9, g = 1e-6, 80,000 steps of ``run_chunked``) within 2% for SRT,
     TRT and MRT;
 32. K7's bf16 main path (``run_chunked(model.step)`` on config 1, 1000
     steps), then MLUPS of K7 and its plain path at 512x1024 and 1024^2,
     device time per launch and the roofline share;
 33. f64: the D3Q19 single-phase kernel K11 against its plain version, 20
     steps on 48x40x32 (walls on y, an obstacle), SRT and TRT with and
     without the body force; <= 1e-11;
 34. basic3d.ini's physics (SRT, tau 0.9, g_z = -1e-6, the CLI's box) at
     128^3 and 256^3, 10 steps of K11 and plain from a perturbed start in
     f32 (<= FLOW3D_F32_BOUND) and bf16 (decoded <= BF16_BOUND; one step
     within one ulp per value);
 35. tests/test_flow3d.py's plate Poiseuille flow through K11 (SRT, TRT)
     within 2% of the analytic profile;
 36. f64: the D3Q19 Shan-Chen kernel K10 against its plain version, 20
     steps on 48x40x32 in each case of SC3D_CASES (two fluids periodic; two
     fluids with y walls, G_s, tau (1.0, 0.8) and a body force; three
     fluids; one fluid with walls and an obstacle; two fluids in grains
     that cross the periodic seams); <= 1e-11; then 10 f32 steps of each
     within FLOW3D_F32_BOUND;
 37. benchmarks/probe_sc3d.py's configuration: f64 at 128^3 (10 steps,
     <= 1e-11), f32 and bf16 at 128^3 and 256^3 as phase 34, then 1000 f32
     steps on K10 at 128^3: each fluid's mass within 1e-4 (f64: 1e-12 over
     300 steps), the droplet separated;
 38. ``run --model basic|basic3d|sc3d --block 1`` on the shipped INIs through
     ``cli.main``, 1000 f32 steps each: path "kernel", K7 / K11 / K10
     launched exactly once a step, final checkpoints finite; the bf16 main
     paths of K11 and K10 through ``run_chunked``;
 39. MLUPS of K11 and K10 (f32, bf16) at 128^3 and 256^3 and of their plain
     paths at 128^3, device time per launch, the launches a step by the
     libraries' counts (FLOW3D_STEP_KERNELS: one a step, K10 in bf16 two)
     and the roofline share;
 40. f64: the Perturbation kernels K4c (compressed) and K4s (split) against
     their plain steps on a 256x128 walled channel in every case of
     PERT_CASES (SRT and MRT, isotropic and anisotropic weights, Neumann/
     Dirichlet, Dirichlet/convective and per-colour velocity/convective
     rows, a periodic droplet, unequal strengths, unequal alphas for one
     step), and K6 with the per-colour velocity inlet; <= 1e-11;
 41. the pert flagship (bench.py's flow as the Perturbation variant,
     1024^2), 10 steps from one f64 start: f64 <= 1e-11, K4c f32, K4s f32
     and K4h bf16 off the seam rows and corners within PERT_BOUNDS, then one
     more bf16 step within one ulp a value (``bf16_one_step``);
     ``chip_faults.py`` shows a fault planted in the f32 instance failing
     this phase;
 42. physics through K4: the Laplace droplet of
     tests/test_colorgradient.py (64^2, 2000 steps, f32 and f64 on K4s),
     then 1000 f32 steps of the pert flagship through
     ``run_chunked(step_c)`` on K4c, its red mass growing by |v_in| x the
     fluid inlet columns a step within 5%;
 43. the main paths: ``run_chunked(step_c)`` for 1000 bf16 steps (K4h once
     a step, by the wrapper's count and the library's), ``run --model cg
     --block 1`` on rk_csf2d.ini at 1024^2 with
     SurfaceTensionType 'Perturbation' for 1000 steps (K4s once a step, a
     finite split checkpoint), and a short run with the averaged convective
     outlet (path "plain", no launch);
 44. MLUPS of K4c, K4h and K4s and of their plain paths at 1024^2, device
     time per launch and the roofline share;
 45. f64: the T-step colour-gradient kernel K3 (both variants; compressed
     K3c and split K3s) against T plain steps, T = 2, 3, 4 (the
     Perturbation variant also 10 and 16, past its launch limit), two calls
     in a row, on a periodic droplet, two walled channels whose ny (100) is
     no multiple of a tile (the flagship's rows; Dirichlet inlet and
     convective outlet) and, split, the CLI's rk_csf2d.ini at 1044x1024,
     and (CSF, both layouts, T = 2, 3, 4) phase 3's Xu porous case;
     max |difference| <= 1e-11 (both variants are the row-march of
     csrc/march2d.cuh); the line gives the flagship rows' layouts at T = 4;
 46. f64: the T-step Shan-Chen kernel K8-T (the row-march of
     csrc/sc2d_march.cuh) on every kernel case of SC_CASES (100x64), and
     47. the T-step single-phase kernel K7-T on every case of SINGLE_CASES
     (100x72), T = 2, 3, 4; <= 1e-11; the line gives K8-T's layouts at
     T = 4;
 48. the T-step kernels at full size, T = 2 and 4, 8 steps from one f64
     start against their plain versions (bf16 decoded once and encoded
     once a call by both): K3c, K3s (f32) and K3h (bf16) of both
     flagships within the bounds of phases 4, 14 and 41 off the seam, K8-T
     at configs 2 and 3 and K7-T at config 1 in f32 and bf16 within those
     of phases 17 and 30;
 49. speed per time step at T = 1 (the T=1 kernel), 2 and 4 (CUDA events;
     device time per launch from ``torch.profiler``), MLUPS, the bound
     per step, launches per step from the counters (1/T), each launch's
     layout (the row-march's waves, rows a wave, ring MB and grid for K3
     and K8-T, whose device time a launch comes from CUDA events between
     launches; the window's tile, bytes and memory for K7-T) and the
     plain version's time: K3 at both flagships (1024^2), K8-T at configs
     2 and 3, K7-T at config 1 and at 1024^2;
 50. the main paths of the T-step kernels: bench.py's loop
     (``run_chunked`` of ``make_block_step(steps_per_call=4,
     compressed=True, storage="bf16" | "f32")``) on both flagships, the
     bf16 loops of K8-T and K7-T, and ``run --model cg|sc|basic --block 4``
     against ``--block 1`` (metrics.jsonl at every output step within 1e-4
     relative, the steady criterion 1e-2, the T-step kernel launched once
     per 4 steps and the T=1
     kernel never), and ``--block 0`` picking T = 2 where 4 does not
     divide the output interval;
 51. the CLI's default, ``--block 0``, at the shipped sizes of phases 12,
     18 and 38 (``run --model cg`` CSF 1044x1024, ``sc`` SC 1024^2,
     ``basic`` 512x1024, 1000 f32 steps): the T-step kernel launched
     1000 / T times and the T=1 kernel never, and the seconds with I/O
     beside those phases' ``--block 1`` runs in the same call;
 52. f64: the T-step coupled flow + tracer kernel K5c-T (compressed and
     split) against T plain coupled steps, T = 2, 3, 4, two calls in a row,
     on a 100x64 walled channel with tracer mass on the boundary rows, in
     every case of BLOCK_COUPLED_CASES (phase 6's six, D2Q9 MRT, an
     interface of kind "none", config 4's tracer) on the flagship's flow,
     two cases on the Dirichlet inlet / convective outlet flow, and config
     4's tracer on phase 3's Xu porous case (both layouts); <= 1e-11 (the
     row-march); the line gives the flagship flow's layouts at
     T = 4;
 53. f64: the T-step D3Q19 kernels K11-T (every case of SINGLE3D_CASES) and
     K10-T (K = 1, 2, 3: BLOCK_SC3D_CASES) on 48x40x32, T = 2, 3, 4, each
     on the wrapper's plan and on a plan in three y-bands whose last
     overhangs ny, K11-T also at 1 and 2 slabs a wave; <= 1e-11;
 54. the new T-step kernels at full size, T = 2 and 4, 8 steps (3-D: 4)
     against their plain versions: K5c-T at config 4 (1024^2) compressed f32 and
     bf16 and split f32 within phase 7's bounds off the seam, K11-T at
     basic3d and K10-T at probe_sc3d at 128^3 and 256^3 in f32 and bf16
     within phases 34 and 37's bounds; each bf16 state one more step within
     one ulp a value;
 55. speed per time step of K5c-T (config 4, three layouts), K11-T and
     K10-T (128^3, f32 and bf16) at T = 1, 2, 4, as phase 49, with K5c-T's
     row-march and K10-T's z-march plans (bands, rings in MB, the
     cooperative grid, waves, lag) and their device time a launch from CUDA
     events between launches;
 56. their main paths: bench.py's loop (``run_chunked`` of
     ``make_block_step(4, ...)``) on config 4 in bf16, f32 and split, and
     on basic3d and probe_sc3d in bf16 at 128^3; ``run --model
     transport|basic3d|sc3d --block 4`` against ``--block 1`` as phase 50,
     and ``--block 0`` picking T = 2 where 4 does not divide the interval;
 57. the CLI's default ``--block 0`` at the shipped sizes of phases 12 and
     38 (``transport`` 1044x1024 500 steps, ``basic3d`` and ``sc3d`` as
     shipped, 1000 steps): the T-step kernel launched steps / T times, the
     T=1 kernel never, the seconds with I/O beside the ``--block 1`` runs;
 58. four Shan-Chen fluids on the runtime-K instances of K8 / K8-T and K10 /
     K10-T: every case of SC4_CASES (128x64) and SC3D4_CASES (48x40x32) at
     f64 against the plain step, 20 steps as T = 1, 2, 4 a call (<= 1e-11);
     at full size (1024^2, 128^3) in f32 within phases 17 and 37's bounds,
     path "kernel", the main paths through ``run_chunked`` and times;
 59. ``run --model M --no-pallas`` for the eight models on their shipped
     INIs, 20 steps: no kernel launched (the model's line names "the plain
     step"), metrics.jsonl within 1e-4 relative of the run without the flag
     (umax 2e-3);
 60. f64: the 3-D CSF T-step kernel K9-T (compressed and split) against T
     plain steps, T = 2, 3, 4, two calls, in BLOCK_CG3D_CASES (wetting walls
     periodic, velocity inlet with the convective and with the pressure
     outlet, the grain pack at 32^3), on the wrapper's plan and on a plan in
     three y-bands whose last overhangs ny; <= 1e-11;
 61. K9-T at configuration 5 (128^3), T = 2 and 4, 8 steps: f32
     (compressed, split) and bf16 against their plain versions by phase
     21's rule, then one more bf16 step within one ulp a value;
 62. K9-T's speed per time step at T = 1, 2, 4 at 128^3 and 256^3 (CUDA
     events), device time per launch (CUDA events between launches), the
     z-march plan (bands, rings in
     MB, the cooperative grid, waves, lag) and plain time, and
     bench_cg3d.py's loop (``run_chunked`` of ``make_block_step(4, ...)``
     over 120 steps in f32, bf16 and split) with its launches and MLUPS;
 63. f64: the sharded colour-gradient step (K12a, ``build_csf_sharded_step``
     on a ``LocalMesh``: all shards on this card, halos by device copies)
     of both variants with Neumann/Dirichlet and Dirichlet/convective rows,
     256^2 on (4, 1) and (2, 2) meshes at T = 1, 2, 4 and 104x256 (shards of
     26 rows) on (4, 1) at T = 1, 2, and CSF on phase 3's Xu porous case
     on (2, 2) at T = 1, 2, two calls: the gathered state against
     the single-device K3 at the same T (<= 1e-12, expected bit for bit)
     and against the plain step (<= 1e-11), one local launch a shard a call;
 64. f64: K12a with transport, phase 6's tracer cases at 96^2 on (4, 1) and
     (2, 2) at T = 1, 2 (96 columns, not phase 6's 64, so that (2, 2) at T
     = 2 passes the JAX builder's rule nx/px > 2H): against K5c-T (<= 1e-12)
     and the plain step (<= 1e-11), flow and tracers;
 65. f64: the sharded single-phase step (K12b, ``build_single_sharded_step``)
     on (4, 1) at T = 1, 2: config 1's box at 256x128 and three walled
     cases with Zou-He and convective rows, against K7-T (<= 1e-12) and the
     plain step (<= 1e-11);
 66. full width, f32: the flagship 1024^2 on (4, 1) and (2, 2), config 4 at
     1024^2 and config 1 at 512x1024 on (4, 1), 10 steps at T = 1 and 12 at
     T = 4: the gathered state against the single-device kernel (printed,
     expected 0) and within phases 48 and 54's bounds of the plain step;
     ms a time step of the sharded step (kernels and exchange), of the
     exchange alone and of the single-device kernel, the bound; the
     launches of these main paths (counts set to 0 just before); then
     ``parallel.dryrun --in-process --device cuda`` in this process, and
     with two cards or more ``parallel.dryrun --device cuda --ranks 2|4``
     over NCCL in a subprocess (with one card it says so); both run the
     dry run's 3-D lines (K12d, K12e) too;
 67. f64: the sharded D3Q19 CSF step (K12d, ``build_cg3d_sharded_step`` on
     a ``LocalMesh``): configuration 5's flow (grain pack, velocity inlet,
     convective outlet) at 64^3 on (4, 1) and (2, 2), walled 24x40x32
     channels with the convective and the Dirichlet outlet on (6, 1) and
     (4, 1) (shards of 4 and 6 slabs: the outlet's cascade ends on the
     bottom shard's last slab, next to the seam), and the coupled probe and
     a two-tracer Dirichlet case at 48x40x32 on (4, 1), two calls: against
     the single-device K9 / K9t (<= 1e-12, expected bit for bit) and the
     plain step (<= 1e-11; not at the grain pack, whose seam amplifies
     rounding, phase 20), one local launch a shard a call;
 68. f64: the sharded D3Q19 Shan-Chen step (K12e,
     ``build_sc3d_sharded_step``) on (4, 1) at 48x40x32, K = 2 at T = 1, 2,
     4 and K = 4 at T = 2, two calls: against T steps of the single-device
     K10 and against K10-T (<= 1e-12) and the plain step (<= 1e-11);
 69. full width, f32: configuration 5 at 128^3 and 256^3 on (4, 1) and (2,
     2), the coupled probe at 128^3 on (4, 1), probe_sc3d at 128^3 on (4, 1)
     at T = 1 and 4: the gathered state against the single-device kernels
     (<= 1e-5, expected 0), each local kernel (the slab kernel, the step)
     against its plain version on the same padded buffers, one call, in
     every run (<= 1e-5; K12d's step on the periodic z seam, an interface,
     <= 1.5x the plain version's gap to its one-ulp twin, as phase 21),
     the launches of these main paths (counts set to
     0 just before), ms a time step sharded (slabs, exchange and kernels),
     of the exchange alone, of the slab kernel alone, of the local kernels
     alone, the host's time to issue a call (host clock, no wait), of the
     single-device kernel (and K10-T), the plain versions' time, and the
     bound (least bytes a cell-step plus the frames' reads and copies, over
     3.35 TB/s); at 128^3 the device µs a launch of each kind of kernel,
     sharded and on one device (``torch.profiler``);
 70. f64: the sharded 2-D Shan-Chen step (K12c, ``build_sc_sharded_step`` on
     a ``LocalMesh``): bench_all.py configs 2 and 3 at 256^2, the case of
     tests/test_multichip.py:278-315 at 64^2, EFS iso-10 with Zou-He
     velocity / pressure rows at 104x64, the Peng-Robinson droplet and four
     fluids (the runtime-K local passes) at 128x64 (convective outlet) and
     104x64 (EFS, Zou-He pressure outlet), each from a noisy start,
     on (4, 1) and (2, 1) at T = 1, 2, two calls: against the single-device
     K8-T at the same T, K8 for T steps (<= 1e-12, expected bit for bit)
     and the plain step (<= 1e-12), one local call a shard a call;
 71. full width, f32: configs 2 and 3 at 1024^2 on (4, 1) at T = 1 and 4,
     four fluids at 1024^2 at T = 1 and 2: the gathered state against the
     single-device K8-T at the same T (<= 1e-5), each shard's
     local call against its plain version on the same padded buffers, one
     call (<= 1e-5), the launches of these main paths (counts set to 0 just
     before), ms a time step sharded, of the exchange alone, of the local
     kernels alone, the host's time to issue a call, of the single-device
     K8-T at the same T and of K8, the plain version's time, the bound
     (least bytes a cell-step plus the frames' reads and copies, over 3.35
     TB/s), and the device µs a launch of each kind of kernel, sharded and
     on one device (``torch.profiler``);
 72. T-step calls past one launch's step limit at f64, T = 10 and 16
     against T plain steps (<= 1e-11): K3c of both variants and the
     Perturbation K3s (two 100x72 channels), K8-T (the velocity /
     convective and EFS iso-10 velocity / pressure rows, 100x64), K5c-Tc,
     K11-T, K10-T and K9-Tc, each call run as
     ``build.split_steps``'s launches (counted, with the launch's limit and
     layout); the launch limits' Python mirrors against the libraries
     that set them; ``run --model sc3d --block 10`` on shanchen3d.ini
     against ``--block 1`` (metrics.jsonl within 1e-4, two T-step
     launches a call, the T=1 kernel never).

Every phase prints one line or more, each number line with the card's name
and power limit, and any failure exits non-zero.  Then the wall time, the
card's name and power limit again, a JSON line of the kernels (with each
one's bound: the least time for its least bytes at 3.35 TB/s or its least
operations at the f32 peak, whichever is longer), and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP_N = 1024
MAIN_STEPS = 1000
COUPLED_STEPS = 500


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def walled(ny, nx):
    from openlbmpm_torch import geometry
    solid = np.zeros((ny, nx), bool)
    solid[:, 0] = solid[:, -1] = True
    return geometry.from_solid_mask(solid)


def flagship_flow():
    """bench.py's flagship flow, also bench_all.py config 4's: CSF MRT,
    Akai wetting, tau_type 2, Neumann inlet at v = -1e-4, Dirichlet outlet
    with the phi repair.  Returns (ColorGradientParams, CGBoundaryConfig)."""
    from openlbmpm_torch.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams)
    params = ColorGradientParams(
        tau_r=1.0, tau_b=1.0, surface_tension=0.1, contact_angle_deg=60.0,
        beta=0.7, delta=0.98, tau_type=2, wetting_type=2, variant="CSF",
        collision="MRT")
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    return params, bcs


def flagship_model(device, storage, dtype=torch.float32, n=FLAGSHIP_N):
    """The flagship flow on a 1024^2 walled channel."""
    from openlbmpm_torch.models.colorgradient import ColorGradientRK
    return ColorGradientRK(walled(n, n), *flagship_flow(), dtype=dtype,
                           device=device, storage=storage)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def poiseuille_error(profile, g: float, nu: float) -> float:
    """max |u - u_analytic| / max |u_analytic| over the fluid cells of a
    channel profile whose first and last cells are solid: half-way
    bounce-back puts the walls half a cell inside the solid, so with
    H = n - 2 fluid cells u(x) = g / (2 nu) ((H/2)^2 - (x - xc)^2), xc the
    middle of the profile.  The CPU tests use it too."""
    u = np.asarray(profile, np.float64)
    n = u.shape[0]
    x = np.arange(1, n - 1)
    ana = g / (2.0 * nu) * (((n - 2) / 2.0) ** 2 - (x - (n - 1) / 2.0) ** 2)
    return float(np.abs(u[1:-1] - ana).max() / np.abs(ana).max())


def xu_porous_params():
    """The MRT CSF flow of phase 3's cases with Xu wetting (wetting_type
    1), which makes a unit normal of any nonzero gradient."""
    from openlbmpm_torch.models.colorgradient import ColorGradientParams
    return ColorGradientParams(
        variant="CSF", collision="MRT", surface_tension=0.01, tau_r=1.0,
        tau_b=0.8, tau_type=2, wetting_type=1, contact_angle_deg=60.0)


def xu_porous_geometry(ny=96, nx=64):
    """A periodic porous mask: 30% random solid cells (one-cell slivers
    among them, solids on the seams)."""
    from openlbmpm_torch import geometry
    return geometry.from_solid_mask(
        np.random.default_rng(3).random((ny, nx)) < 0.3)


def xu_porous_model(device, dtype=torch.float64):
    """The Xu porous case of phases 3, 45, 52 and 63: xu_porous_params on
    xu_porous_geometry with periodic rows, and its split start, a droplet
    of radius 20."""
    from openlbmpm_torch.models.colorgradient import (
        CGBoundaryConfig, ColorGradientRK)
    m = ColorGradientRK(xu_porous_geometry(), xu_porous_params(),
                        CGBoundaryConfig(), dtype=dtype, device=device)
    return m, m.init_state_droplet(1.0, 1.0, radius=20.0)


def phase_f64(device, ny=256, nx=128, steps=20, tol=1e-11):
    """Kernel vs plain at f64 on the golden setup scaled up (K1), then on a
    periodic porous mask with Xu wetting and a droplet (xu_porous_model),
    in the compressed (K1) and split (K6) layouts, within `tol`: {case: max
    |diff| over `steps` steps}.  Xu wetting makes a unit normal of any
    nonzero gradient, so one-ulp differences near solids grow: phi extended
    onto solid cells as num times the reciprocal of den, not num / den,
    opens about 2e-5 here, and f64 instances that contract a * b + c into
    FMAs 5.8e-8 (the csf2d_f64 library is built with -fmad=false)."""
    from openlbmpm_torch.kernels.csf import (
        csf_step_compressed, csf_step_compressed_reference, csf_step_split,
        csf_step_split_reference)
    from openlbmpm_torch.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
    params = ColorGradientParams(
        variant="CSF", collision="MRT", surface_tension=0.01, tau_r=1.0,
        tau_b=0.8, tau_type=2, wetting_type=2, contact_angle_deg=60.0)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    m = ColorGradientRK(walled(ny, nx), params, bcs, dtype=torch.float64,
                        device=device)
    a = m.pack_state(*m.init_state_layers(1.0, 1.0, invading_rows=ny // 5))
    b = a.clone()
    res = {"channel": 0.0}
    for _ in range(steps):
        a = csf_step_compressed(a, m)
        b = csf_step_compressed_reference(b, m)
        res["channel"] = max(res["channel"], float((a - b).abs().max()))
    check(bool(torch.isfinite(a).all()), "f64 kernel state not finite")
    m, split = xu_porous_model(device)
    check(m.path == "kernel", "Xu porous: not on the kernel")
    for case, x, step, plain in (
            ("Xu porous K1", m.pack_state(*split), csf_step_compressed,
             csf_step_compressed_reference),
            ("Xu porous K6", split, csf_step_split, csf_step_split_reference)):
        a = b = x
        res[case] = 0.0
        for _ in range(steps):
            a, b = step(a, m), plain(b, m)
            res[case] = max(res[case], *(
                float((u - v).abs().max()) for u, v in
                (zip(a, b) if isinstance(a, tuple) else [(a, b)])))
    for case, err in res.items():
        check(err <= tol, f"f64 {case}: kernel vs plain {err:.3e} > {tol:g}")
    return res


def seam_masks(ny, nx, steps, device):
    """Cells off the inlet/outlet seam rows and off the corners where they
    meet the walls (see phase_flagship)."""
    corner = steps + 2
    away = torch.ones((ny, nx), dtype=torch.bool, device=device)
    away[[0, 1, ny - 2, ny - 1], :] = False
    for ys in (slice(0, corner), slice(ny - corner, ny)):
        for xs in (slice(0, corner), slice(nx - corner, nx)):
            away[ys, xs] = False
    return away


def phase_flagship(device, n=FLAGSHIP_N, steps=10):
    """Kernel vs plain at the flagship size: f64, f32 and bf16 storage, all
    from one f64 initial state.

    f32 and bf16 are held to the f64 plain run as well as to the plain
    run in their own storage.  On the boundary rows (0, 1, ny-2, ny-1: the
    periodic seam between the red inlet and the blue outlet is an
    interface) and at the four corners where that seam meets the wetting
    walls, wetting tie-breaks flip under 1-ulp differences, and there the
    plain f32 path is itself ~3e-3 away from f64.  So there the kernel is
    held to be no further from f64 than the plain path; elsewhere the two
    paths agree to 3e-5 (f32), and to about ten times their measured gap
    in bf16 storage.  One further bf16 step from a common state is held
    to one ulp of each stored value (off the seam), which a wrong
    rounding mode or a dropped lo plane of rho_r cannot meet."""
    from openlbmpm_torch.kernels.csf import (
        csf_step_compressed, csf_step_compressed_reference)

    def run(s, m, fn):
        for _ in range(steps):
            s = fn(s, m)
        return s

    res = {}
    m64 = flagship_model(device, "f32", dtype=torch.float64, n=n)
    s64 = m64.pack_state(*m64.init_state_layers(
        1.0, 1.0, invading_rows=100 * n // 1024))
    p64 = run(s64, m64, csf_step_compressed_reference)
    k64 = run(s64, m64, csf_step_compressed)
    res["f64"] = float((k64 - p64).abs().max())
    check(res["f64"] <= 1e-11, f"f64 kernel vs plain {res['f64']:.3e} > 1e-11")

    corner = steps + 2     # tie-break noise spreads about a cell per step
    away = seam_masks(n, n, steps, device)
    seam = ~away
    seam[:, :corner] = False
    seam[:, n - corner:] = False
    # bounds off the seam rows and corners: (PDF planes, rho_r)
    bounds = {"f32": (3e-5, 3e-5), "bf16": (3e-4, 1e-4)}
    for storage in ("f32", "bf16"):
        m = flagship_model(device, storage, n=n)
        s0 = s64.float() if storage == "f32" \
            else m.pack_compressed_bf16(s64.float())
        a = run(s0, m, csf_step_compressed)
        b = run(s0, m, csf_step_compressed_reference)
        if storage == "bf16":
            res["ulp"] = bf16_one_step(m, b, away)
            a, b = m.unpack_bf16(a), m.unpack_bf16(b)
        check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
              f"{storage}: state not finite")
        d = (a - b).abs()
        planes, rho_r = float(d[:9, away].max()), float(d[9, away].max())
        acc_k = float((a.double() - p64).abs().max())
        acc_p = float((b.double() - p64).abs().max())
        check(planes <= bounds[storage][0], f"{storage} planes |diff| off "
              f"the seam {planes:.3e} > {bounds[storage][0]:g}")
        check(rho_r <= bounds[storage][1], f"{storage} rho_r |diff| off "
              f"the seam {rho_r:.3e} > {bounds[storage][1]:g}")
        check(acc_k <= 1.5 * acc_p, f"{storage} kernel is {acc_k:.3e} from "
              f"f64, the plain path {acc_p:.3e}")
        tot_k, tot_p, tot_0 = (float(x[9].double().sum()) for x in (a, b, s64))
        drift = abs(tot_k - tot_p) / tot_p
        change = abs(tot_k - tot_0) / tot_0
        check(drift <= 1e-4, f"{storage}: total rho_r kernel vs plain {drift:.2e}")
        check(change <= 1e-4, f"{storage}: total rho_r change {change:.2e}")
        res[storage] = {
            "max": float(d.max()), "planes": planes, "rho_r": rho_r,
            "seam": float(d[:, seam].max()), "from_f64": (acc_k, acc_p),
            "mass": (drift, change)}
    return res


def _bf16_rz(x):
    """x rounded toward zero to bfloat16 (a wrong rounding mode)."""
    return (x.float().view(torch.int32) & ~0xFFFF).view(
        torch.float32).to(torch.bfloat16)


def bf16_one_step(m, s, away, kernel=None, max_share=1e-3):
    """Kernel and plain bf16 step from the common bf16 state `s`, held
    value by value off the seam to one bf16 ulp (``compare_bf16_states``)
    with at most `max_share` of the values of magnitude >= 1e-4 off at
    all.  Two faulty encodings of the plain path's own f32 result, one
    rounding toward zero and one dropping the lo plane of rho_r, must
    fail the same check.  `kernel` is the compressed step's wrapper
    (``csf_step_compressed`` unless given)."""
    from openlbmpm_torch.kernels.csf import (
        compare_bf16_states, csf_step_compressed)
    plain = m.plain_step_c(s)
    r = compare_bf16_states((kernel or csf_step_compressed)(s, m), plain,
                            away)
    check(r["excess"] <= 1.0, f"bf16 one step: a value {r['excess']:.3g} "
          "ulp off the plain path")
    check(r["share"] <= max_share, f"bf16 one step: {r['share']:.2e} of the "
          f"values differ > {max_share:g}")
    x = m.plain_step_c(m.unpack_bf16(s))
    w = torch.as_tensor(m.lat.w, dtype=x.dtype, device=x.device)
    hi = _bf16_rz(x[9])
    rz = torch.cat([_bf16_rz(x[:9] - w.reshape(-1, 1, 1) * m.fluid_mask),
                    hi[None], _bf16_rz(x[9] - hi.float())[None]])
    no_lo = plain.clone()
    no_lo[10] = 0
    r["rz_share"] = compare_bf16_states(rz, plain, away)["share"]
    r["no_lo_excess"] = compare_bf16_states(no_lo, plain, away)["excess"]
    check(r["rz_share"] > max_share and r["no_lo_excess"] > 1.0,
          f"bf16 one-step check cannot see a rounding-toward-zero "
          f"({r['rz_share']:.2e}) or dropped-lo ({r['no_lo_excess']:.3g}) "
          "encoding")
    return r


def _time_steps(step, s, n, device):
    """Seconds per step over `n` steps after a warm-up, CUDA events."""
    for _ in range(5):
        s = step(s)
    torch.cuda.synchronize(device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        s = step(s)
    t1.record()
    torch.cuda.synchronize(device)
    return t0.elapsed_time(t1) / 1e3 / n


def phase_main(device, n=FLAGSHIP_N, steps=MAIN_STEPS, kernel_steps=500,
               plain_steps=50):
    """The main path through the model's public step, then timings."""
    from openlbmpm_torch.kernels.csf import (
        csf_step_compressed, csf_step_compressed_reference, launch_csf2d)
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    m32 = flagship_model(device, "f32", n=n)
    csf_step_compressed.launches = 0
    counts = cg2d_counts("csf2d")
    s32 = run_chunked(m32.step_c, m32.pack_state(*m32.init_state_layers(
        1.0, 1.0, invading_rows=100 * n // 1024)), num_steps=steps // 4,
        io_interval=250, nan_guard=True)
    launches32 = csf_step_compressed.launches
    check(launches32 == steps // 4 and bool(torch.isfinite(s32).all()),
          f"f32 main path: {launches32} launches, want {steps // 4}")
    per32 = cg2d_launches_a_step("csf2d", counts, steps // 4,
                                 "K1 main path")
    m = flagship_model(device, "bf16", n=n)
    s = m.pack_state_bf16(*m.init_state_layers(1.0, 1.0,
                                               invading_rows=100 * n // 1024))
    meter = RunMetrics(n * n)
    csf_step_compressed.launches = 0
    counts = cg2d_counts("csf2d")
    s = run_chunked(m.step_c, s, num_steps=steps, io_interval=500,
                    metrics=meter, nan_guard=True)
    launches = csf_step_compressed.launches
    check(launches == steps, f"kernel launched {launches} times, want {steps}")
    per = cg2d_launches_a_step("csf2d", counts, steps, "K2 main path")
    u = m.unpack_bf16(s)
    check(bool(torch.isfinite(u).all()), "main path state not finite")
    check(tuple(s.shape) == (11, n, n) and s.dtype == torch.bfloat16,
          f"main path state {tuple(s.shape)} {s.dtype}")

    models = {st: flagship_model(device, st, n=n) for st in ("f32", "bf16")}
    states = {"f32": models["f32"].pack_state(*models["f32"].init_state_layers(
        1.0, 1.0, invading_rows=100 * n // 1024)), "bf16": s}
    runs = time_paths(models, states, csf_step_compressed,
                      csf_step_compressed_reference, kernel_steps,
                      plain_steps, device)
    profile = {}
    for st, m in models.items():
        times = device_times(
            lambda s, m=m: launch_csf2d(s, m.kernel_params, m.geo_planes),
            states[st], KERNELS)
        profile.update({(st, k): v for k, v in times.items()})
    return {"launches": launches, "launches_f32": launches32,
            "run_mlups": meter.mlups, "sec": runs, "profile": profile,
            "per_step": per, "per_step_f32": per32}


def time_paths(models, states, kernel, plain, kernel_steps, plain_steps,
               device):
    """Seconds per step of kernel(x, model) and plain(x, model) for each
    storage: plain, kernel, kernel, plain -- twice over, keeping the best
    of each."""
    runs = {}
    order = [("plain", "f32"), ("kernel", "f32"), ("kernel", "bf16"),
             ("plain", "bf16")]
    for path, st in order + order[::-1]:
        fn, k = (kernel, kernel_steps) if path == "kernel" \
            else (plain, plain_steps)
        sec = _time_steps(lambda x, m=models[st], fn=fn: fn(x, m), states[st],
                          k, device)
        runs[(path, st)] = min(runs.get((path, st), float("inf")), sec)
    return runs


KERNELS = ("strip_kernel",)
# the coupled step's kernels (the tracer's strip march on the state before
# the flow's boundary rows; the flow step is strip_kernel)
COUPLED_KERNELS = ("tracer_strip_kernel", "strip_kernel")
# each one-step 2-D colour-gradient library's kernels a step, once each, by
# the library's own count (csf.kernel_launches): K1 / K2 / K6 one launch,
# K5c / K5s two, K4 one
CG2D_STEP_KERNELS = {
    "csf2d": ("strip_kernel",),
    "coupled2d": COUPLED_KERNELS,
    "pert2d": ("pert_strip_kernel",)}


def cg2d_counts(lib):
    """A one-step 2-D colour-gradient library's launch counts."""
    from openlbmpm_torch.kernels.csf import kernel_launches
    return kernel_launches(lib)


def cg2d_launches_a_step(lib, before, steps, what):
    """{kernel: launches a step} of `lib` since the counts `before` over
    `steps` steps, checked against CG2D_STEP_KERNELS (the pert2d_f64 library
    as pert2d)."""
    per = per_step(before, cg2d_counts(lib), steps)
    want = CG2D_STEP_KERNELS[lib.replace("_f64", "")]
    check(all(v == (k in want) for k, v in per.items()),
          f"{what}: {lib} launches a step {per}, want {want} once each")
    return per


def _fmt_counts(per):
    return ", ".join(f"{k} {v:g}" for k, v in per.items() if v) + \
        f" (total {sum(per.values()):g})"


def device_times(step, x, names, steps=100):
    """(device microseconds per launch, launches per call) of each CUDA
    kernel in `names` over `steps` calls x = step(x), from torch.profiler;
    None where the trace shows no device time for a kernel.  The trace
    misses launches, mostly the first after it starts (a bare ``profile``
    block counted 17-18 of 20 a kernel, this one 19-20), so two calls run
    traced before the counted ones (the schedule's warmup) and each call
    ends on the card before the next; a count is at most the launches."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(5):
        x = step(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
            wait=0, warmup=2, active=steps, repeat=1)) as prof:
        for _ in range(steps + 2):
            x = step(x)
            torch.cuda.synchronize()
            prof.step()
    out = {}
    for k in names:
        out[k] = None
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
            if k in ev.key and ev.count and t:
                out[k] = (t / ev.count, ev.count / steps)
    return out


def launch_times(step, x, calls=8):
    """(device microseconds a call, 1.0) of x = step(x) where a call is one
    kernel launch: CUDA events recorded between consecutive calls on the
    current stream, the median of the `calls` gaps.  The host queues each
    call while the one before runs on the card, so a gap is one launch's
    device time.  For the cooperative z-march launches (K10-T, K9-T),
    which torch.profiler's trace mostly misses."""
    for _ in range(3):
        x = step(x)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
    ev[0].record()
    for e in ev[1:]:
        x = step(x)
        e.record()
    torch.cuda.synchronize()
    gaps = sorted(a.elapsed_time(b) * 1e3 for a, b in zip(ev, ev[1:]))
    return gaps[len(gaps) // 2], 1.0


def phase4_line(res) -> str:
    line = [f"phase 4 flagship 1024^2, 10 steps: f64 max |diff| "
            f"{res['f64']:.3e} (<= 1e-11)"]
    for st, (bp, br) in (("f32", (3e-5, 3e-5)), ("bf16", (3e-4, 1e-4))):
        r = res[st]
        line.append(
            f"{st}: off the seam rows and corners planes {r['planes']:.3e} "
            f"(<= {bp:g}), rho_r {r['rho_r']:.3e} (<= {br:g}); seam rows "
            f"{r['seam']:.3e}, max {r['max']:.3e}; from f64 kernel "
            f"{r['from_f64'][0]:.3e} vs plain {r['from_f64'][1]:.3e} "
            f"(<= 1.5x); total rho_r kernel vs plain {r['mass'][0]:.2e}, "
            f"change {r['mass'][1]:.2e} (<= 1e-4)")
    u = res["ulp"]
    line.append(
        f"bf16 one more step from a common state, off the seam: largest gap "
        f"{u['excess']:.3g} ulp (<= 1), {u['share']:.3e} of values >= 1e-4 "
        f"differ (<= 1e-3), {u['hi_flips']} rho_r hi flips; the same check "
        f"on round-toward-zero {u['rz_share']:.3e} differ, on a dropped "
        f"rho_r lo plane {u['no_lo_excess']:.3g} ulp")
    return "; ".join(line)


def phase5_lines(main_res, card, t_build, n=FLAGSHIP_N):
    mlups = {k: n * n / v / 1e6 for k, v in main_res["sec"].items()}
    return [
        f"phase 5 main path: run_chunked(step_c) {MAIN_STEPS} bf16 steps, "
        f"{main_res['launches']} kernel launches (the library's count a "
        f"step: {_fmt_counts(main_res['per_step'])}), "
        f"{main_res['run_mlups']:.1f} MLUPS incl. host loop; "
        f"{MAIN_STEPS // 4} f32 steps, {main_res['launches_f32']} launches "
        f"[{card}]",
        f"phase 5 MLUPS {n}^2 [{card}]: kernel f32 "
        f"{mlups[('kernel', 'f32')]:.1f}, kernel bf16 "
        f"{mlups[('kernel', 'bf16')]:.1f}, plain f32 "
        f"{mlups[('plain', 'f32')]:.1f}, plain bf16 "
        f"{mlups[('plain', 'bf16')]:.1f}; build {t_build:.2f} s",
        f"phase 5 torch.profiler device us per launch {n}^2 [{card}]: " +
        ", ".join(f"{k} {st} " + ("not measured" if v is None else
                                  f"{v[0]:.2f}")
                  for (st, k), v in main_res["profile"].items())]


# -- coupled flow + tracer transport ------------------------------------------

# the coupled tracer cases of phase 6 (and of tests/test_torch_*.py), as
# TransportParams fields: (a) D2Q5 SRT, permeable, Inamuro inlet, free-flow
# outlet; (b) the same with a bounce-back interface; (c) three reacting
# tracers; (d) D2Q5 anisotropic MRT, quadratic equilibrium, anti-bounce-back
# inlet; (e) D2Q9 SRT; (f) the zero inlet
COUPLED_CASES = {
    "a": dict(num_tracers=2, scheme=5, tau=(1.0, 0.9), j0=(1 / 3, 1 / 3),
              interface_mode="permeable", beta_interface=(0.5, 0.2),
              inlet="inamuro", inlet_conc=(1.0, 0.5), outlet="freeflow"),
    "b": dict(num_tracers=2, scheme=5, tau=(1.0, 0.9), j0=(1 / 3, 1 / 3),
              interface_mode="bounceback", inlet="inamuro",
              inlet_conc=(1.0, 0.5), outlet="freeflow"),
    "c": dict(num_tracers=3, scheme=5, tau=(1.0, 0.9, 0.8),
              j0=(1 / 3, 0.25, 0.2), interface_mode="permeable",
              beta_interface=(0.5, 0.2, 0.0), reaction_rate=0.05,
              reaction_stoich=(-1.0, -1.0, 1.0), outlet="freeflow"),
    "d": dict(num_tracers=2, scheme=5, relaxation="MRT",
              mrt_equilibrium="quadratic", diff_x=(0.1, 0.05),
              diff_y=(0.08, 0.05), diff_xy=(0.02, 0.0), diff_yx=(0.01, 0.0),
              interface_mode="permeable", beta_interface=(0.3,),
              inlet="anti_bounce_back", inlet_conc=(1.0, 0.2)),
    "e": dict(num_tracers=2, scheme=9, tau=(1.0, 0.8),
              interface_mode="permeable", beta_interface=(0.5, 0.2)),
    "f": dict(num_tracers=1, scheme=5, tau=(1.0,), j0=(1 / 3,),
              interface_mode="bounceback", inlet="zero", outlet="freeflow"),
}

# design HBM bytes per cell-step of the coupled kernels, one f32 D2Q5
# tracer (csrc/coupled2d.cu source note): the tracer's strip march (the
# state, the fluid plane, g in and out) and the flow's (the state in and
# out, a 1-byte mask)
COUPLED_BYTES = {"f32": 40 + 4 + 40 + 81, "bf16": 22 + 4 + 40 + 45}
HBM_BYTES_PER_S = 3.35e12
# The f32 peak outside the tensor cores, H100 SXM: 132 SMs x 128 lanes x
# 2 operations (one FMA) x 1.98 GHz.
F32_FLOPS_PER_S = 67e12

# Least floating-point operations per fluid cell-step of each kernel's
# function, for the operations half of its bound.  An FMA counts as two
# operations (a multiply and an add), as the peak above counts it; a
# division, a reciprocal square root and a square root as one each.  Each
# piece is counted in the cheapest form of its formula found (opposite
# directions share the even terms of their equilibria, sources and
# recolouring); the MRT collisions are counted at the SRT relaxation's
# cost, which is less than any MRT (the non-equilibrium parts, a moment
# transform and its inverse); boundary rows, wetting, solids and guards are
# not counted.  So each count is at most what the function needs.
#   D2Q9: moments rho (8 adds), j_x and j_y (5 each) 18; u = j / rho 3;
#     the second-order equilibrium 41 (u.u 3, A = 1 - 1.5 u.u 2, rho w and
#     3 rho w 5, each of 4 opposite pairs (c.u)^2, FMA with A, x rho w,
#     x 3 rho w c.u, the two signs: 7, c.u of the 2 diagonal pairs 2, the
#     rest 1); f + omega (feq - f) over 9 directions 27.  SRT step 89.
#   A body force in a D2Q9 step: the half-force shift of u (2 FMAs) 4 and
#     at least one operation a population to add its source 9: 13.
#   CSF (K1/K2/K6/K3, both colours in one state): phi 3 (rho_b, rho_r -
#     rho_b, the division); the 8-neighbour isotropic gradient 12 (axis
#     differences 2, diagonal combinations 4, c1 axis + c2 diagonal 3 a
#     component); the unit normal 6; the curvature, the normal's divergence
#     with the same stencil, 13; the force sigma kappa / 2 grad phi 3; the
#     body-force terms 13; the recolouring of the compressed state 38
#     (rho_r / rho 1, beta rho_r rho_b / rho^2 4, x w 2, a pair: B w c.n
#     and two FMAs 5, c.n of the diagonals 2, the rest 1, rho_r' = the sum
#     of the 9 streamed red parts 8).  89 + 88 = 177.
#   Perturbation (K4/K3): the SRT step 89 (the RK equilibrium is the
#     second-order one with other constants), rho_b and d = rho_r - rho_b 2,
#     the gradient of d 12, |g|^2 and |g| 4, the perturbation operator 30
#     (1 / |g|^2, the prefactor and its 5 weighted forms 7, a pair:
#     (c.g)^2 and one FMA, added to both 5, c.g of the diagonals 2, the rest
#     1), the recolouring 38.  175.
#   One D2Q5 tracer (K5c/K5s): C 4, its equilibrium C w (1 + 3 c.u) 9
#     (C w 2, a pair: one product and two signs 3, the rest 1), relaxation
#     15: 28.
#   Shan-Chen D2Q9, K = 2 fluids (K8, K8-T): each fluid's moments,
#     equilibrium and relaxation 86, its interaction force (the gradient of
#     the other fluid's psi 12, x -G psi 3) 15 and its shifted velocity 6;
#     the common velocity 12.  2 x 107 + 12 = 226, for SC and for EFS
#     iso-8 MRT alike (its 24-neighbour stencil and MRT cost more).
#   Single-phase D2Q9 with a body force (K7, config 1): 89 + 13 = 102.
#   D3Q19: moments 45 (rho 18, each j component 9); u 4; equilibrium 82
#     (u.u 5, A 2, rho w and 3 rho w 5, 9 opposite pairs x 7, c.u of the 6
#     edge pairs 6, the rest 1); relaxation 57.  SRT step 188.
#   K11 (SRT + Guo): 188 + the shift 6 + a source operation a population
#     19 = 213.  K10, K = 2: each fluid's moments, equilibrium and
#     relaxation 184, its force (the 18-neighbour gradient: 5 pair
#     differences, 3 adds and c1 axis + c2 edges a component, 33; x -G psi
#     4) 37 and its shifted velocity 8; the common velocity 16: 474.
#   K9 (3-D CSF, SRT + Guo): 188 + phi 3 + gradient 33 + normal 9 +
#     curvature 35 + force 4 + body-force terms 25 + recolouring 77 (A 1,
#     B 4, B w 2, 9 pairs x 5, c.n of the 6 edge pairs 6, the rest 1, the
#     red sum 18) = 374; K9t adds one D3Q7 tracer (C 6, equilibrium 12,
#     relaxation 21) 39: 413.
D2Q9_SRT_OPS = 18 + 3 + 41 + 27
CSF_OPS = D2Q9_SRT_OPS + 3 + 12 + 6 + 13 + 3 + 13 + 38
PERT_OPS = D2Q9_SRT_OPS + 2 + 12 + 4 + 30 + 38
TRACER2D_OPS = 4 + 9 + 15
SC2_OPS = 2 * (18 + 41 + 27 + 15 + 6) + 12
SINGLE_OPS = D2Q9_SRT_OPS + 13
D3Q19_SRT_OPS = 45 + 4 + 82 + 57
CG3D_OPS = D3Q19_SRT_OPS + 3 + 33 + 9 + 35 + 4 + 25 + 77


def coupled_model(device, storage, tp, dtype=torch.float32, ny=FLAGSHIP_N,
                  nx=FLAGSHIP_N, standalone=False):
    """The flagship flow (which is bench_all.py config 4's flow) coupled
    with the tracers `tp` (a dict of TransportParams fields)."""
    from openlbmpm_torch.models.transport import TransportParams, TransportRK
    params, bcs = flagship_flow()
    return TransportRK(walled(ny, nx), params, TransportParams(**tp), bcs,
                       standalone=standalone, dtype=dtype, device=device,
                       storage=storage)


CONFIG4_TRACER = dict(num_tracers=1, scheme=5, tau=(1.0,), j0=(1 / 3,),
                      interface_mode="permeable", beta_interface=(0.5,))


def config4_state(m, n=FLAGSHIP_N):
    """bench_all.py config 4's start: 100 invading rows, the tracer band
    rows n-280 to n-120; returns (TransportState, its f64 tracer mass)."""
    conc0 = np.zeros((1, n, n))
    conc0[0, n - 280:n - 120, :] = 1.0
    st = m.init_state(m.flow.init_state_layers(1.0, 1.0, 100 * n // 1024),
                      conc0)
    return st, float(st.g.double().sum())


def coupled_conc0(nt, ny, nx, seed=0):
    """A tracer band across the interface of layers with ny // 5 red rows
    on top, plus random mass on the three inlet and the three outlet rows."""
    rng = np.random.default_rng(seed)
    c = np.zeros((nt, ny, nx))
    c[:, ny - ny // 5 - 4:ny - ny // 5 + 4] = 1.0
    c[:, :3] = rng.uniform(0.2, 1.0, (nt, 3, nx))
    c[:, -3:] = rng.uniform(0.2, 1.0, (nt, 3, nx))
    return c


def phase_coupled_f64(device, ny=96, nx=64, steps=20, tol=1e-11):
    """Coupled kernels against their plain version at f64, every tracer
    case, with tracer mass on the inlet and outlet rows."""
    from openlbmpm_torch.kernels.transport import (
        coupled_step_compressed, coupled_step_compressed_reference)
    out = {}
    for seed, (name, tp) in enumerate(COUPLED_CASES.items()):
        m = coupled_model(device, "f32", tp, dtype=torch.float64, ny=ny,
                          nx=nx)
        a = b = m.pack(m.init_state(
            m.flow.init_state_layers(1.0, 1.0, invading_rows=ny // 5),
            coupled_conc0(m.tp.num_tracers, ny, nx, seed)))
        es = eg = 0.0
        for _ in range(steps):
            a = coupled_step_compressed(*a, m)
            b = coupled_step_compressed_reference(*b, m)
            es = max(es, float((a[0] - b[0]).abs().max()))
            eg = max(eg, float((a[1] - b[1]).abs().max()))
        check(all(bool(torch.isfinite(x).all()) for x in a),
              f"f64 coupled case {name}: state not finite")
        check(es <= tol and eg <= tol, f"f64 coupled case {name}: kernel vs "
              f"plain flow {es:.3e}, tracers {eg:.3e} > {tol:g}")
        out[name] = (es, eg)
    return out


def phase_coupled_config4(device, n=FLAGSHIP_N, steps=10):
    """Config 4 at full size: kernel against plain in f32 and in bf16 flow
    storage, off the seam rows and corners within phase 4's flow bounds
    (the tracer PDFs held to the plane bound), tracer mass within bench_all's
    1e-7 per step of its start and of the plain path."""
    from openlbmpm_torch.kernels.transport import (
        coupled_step_compressed, coupled_step_compressed_reference)
    away = seam_masks(n, n, steps, device)
    bounds = {"f32": (3e-5, 3e-5), "bf16": (3e-4, 1e-4)}
    res = {}
    for storage in ("f32", "bf16"):
        m = coupled_model(device, storage, CONFIG4_TRACER, ny=n, nx=n)
        st, mass0 = config4_state(m, n)
        a = b = m.pack(st)
        for _ in range(steps):
            a = coupled_step_compressed(*a, m)
            b = coupled_step_compressed_reference(*b, m)
        sa, sb = a[0], b[0]
        if storage == "bf16":
            sa, sb = m.flow.unpack_bf16(sa), m.flow.unpack_bf16(sb)
        check(all(bool(torch.isfinite(x).all()) for x in (sa, sb, a[1], b[1])),
              f"config 4 {storage}: state not finite")
        d = (sa - sb).abs()
        dg = (a[1] - b[1]).abs()
        r = {"planes": float(d[:9, away].max()), "rho_r": float(d[9, away].max()),
             "g": float(dg[:, :, away].max()), "max": max(float(d.max()),
                                                          float(dg.max()))}
        mk, mp = (float(x[1].double().sum()) for x in (a, b))
        r["mass_gap"] = abs(mk - mp) / mass0
        r["mass_change"] = max(abs(mk - mass0), abs(mp - mass0)) / mass0
        r["conc_min"] = min(float(m.concentration(x[1]).min()) for x in (a, b))
        bp, br = bounds[storage]
        check(r["planes"] <= bp and r["rho_r"] <= br and r["g"] <= bp,
              f"config 4 {storage} off the seam: planes {r['planes']:.3e}, "
              f"rho_r {r['rho_r']:.3e}, tracers {r['g']:.3e} over "
              f"{bp:g}/{br:g}/{bp:g}")
        check(r["mass_gap"] <= 1e-7 * steps and r["mass_change"] <= 1e-7 * steps,
              f"config 4 {storage}: tracer mass kernel vs plain "
              f"{r['mass_gap']:.2e}, from the start {r['mass_change']:.2e}")
        check(r["conc_min"] >= -1e-4,
              f"config 4 {storage}: concentration {r['conc_min']:.2e}")
        res[storage] = r
    return res


def phase_coupled_main(device, n=FLAGSHIP_N, steps=COUPLED_STEPS,
                       kernel_steps=300, plain_steps=20):
    """The coupled main path through the model's public step, then
    timings of kernel and plain path, in turns."""
    from openlbmpm_torch.kernels.transport import (
        coupled_step_compressed, coupled_step_compressed_reference,
        launch_coupled2d)
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    m = coupled_model(device, "bf16", CONFIG4_TRACER)
    st, mass0 = config4_state(m, n)
    meter = RunMetrics(n * n)
    coupled_step_compressed.launches = 0
    counts = cg2d_counts("coupled2d")
    s, g = run_chunked(m.step_c, m.pack(st), num_steps=steps,
                       io_interval=250, metrics=meter, nan_guard=True)
    launches = coupled_step_compressed.launches
    per = cg2d_launches_a_step("coupled2d", counts, steps,
                               "K5c main path")
    check(launches == steps,
          f"coupled kernel launched {launches} times, want {steps}")
    check(tuple(s.shape) == (11, n, n) and s.dtype == torch.bfloat16 and
          tuple(g.shape) == (1, 5, n, n) and g.dtype == torch.float32,
          f"coupled main path state {tuple(s.shape)} {s.dtype}, "
          f"{tuple(g.shape)} {g.dtype}")
    check(bool(torch.isfinite(m.flow.unpack_bf16(s)).all()) and
          bool(torch.isfinite(g).all()), "coupled main path state not finite")
    drift = abs(float(g.double().sum()) - mass0) / mass0
    conc_min = float(m.concentration(g).min())
    check(drift <= 1e-7 * steps, f"coupled main path tracer mass drift "
          f"{drift:.2e} over {steps} steps")
    check(conc_min >= -1e-4, f"coupled main path concentration {conc_min:.2e}")

    models = {st_: coupled_model(device, st_, CONFIG4_TRACER)
              for st_ in ("f32", "bf16")}
    states = {"f32": models["f32"].pack(config4_state(models["f32"], n)[0]),
              "bf16": (s, g)}
    runs = time_paths(
        models, states, lambda x, m: coupled_step_compressed(*x, m),
        lambda x, m: coupled_step_compressed_reference(*x, m), kernel_steps,
        plain_steps, device)
    profile = {}
    for st_, m in models.items():
        args = (m.flow.kernel_params, m.tracer_params, m.flow.geo_planes,
                m.tracer_table)
        times = device_times(lambda x, args=args: launch_coupled2d(*x, *args),
                             states[st_], COUPLED_KERNELS)
        profile.update({(st_, k): v for k, v in times.items()})
    return {"launches": launches, "run_mlups": meter.mlups, "sec": runs,
            "drift": drift, "conc_min": conc_min, "profile": profile,
            "per_step": per}


def phase6_line(res) -> str:
    return ("phase 6 f64 coupled kernels vs plain, 96x64, 20 steps, max "
            "|diff| flow/tracers: " + ", ".join(
                f"{k} {es:.3e}/{eg:.3e}" for k, (es, eg) in res.items()) +
            " (<= 1e-11)")


def phase7_line(res, card) -> str:
    parts = []
    for st, (bp, br) in (("f32", (3e-5, 3e-5)), ("bf16", (3e-4, 1e-4))):
        r = res[st]
        parts.append(
            f"{st}: off the seam planes {r['planes']:.3e} (<= {bp:g}), rho_r "
            f"{r['rho_r']:.3e} (<= {br:g}), tracers {r['g']:.3e} "
            f"(<= {bp:g}); max {r['max']:.3e}; tracer mass kernel vs plain "
            f"{r['mass_gap']:.2e}, from the start {r['mass_change']:.2e} "
            f"(<= 1e-6); conc min {r['conc_min']:.2e} (>= -1e-4)")
    return f"phase 7 config 4 1024^2, 10 steps [{card}]: " + "; ".join(parts)


def phase8_lines(res, card, n=FLAGSHIP_N):
    mlups = {k: n * n / v / 1e6 for k, v in res["sec"].items()}
    roof = {st: COUPLED_BYTES[st] * n * n / HBM_BYTES_PER_S /
            res["sec"][("kernel", st)] for st in ("f32", "bf16")}
    return [
        f"phase 8 coupled main path: run_chunked(step_c) {COUPLED_STEPS} "
        f"bf16 steps, {res['launches']} coupled launches (the library's "
        f"count a step: {_fmt_counts(res['per_step'])}), "
        f"{res['run_mlups']:.1f} MLUPS incl. host loop, tracer mass drift "
        f"{res['drift']:.2e}, conc min {res['conc_min']:.2e}; [{card}]",
        f"phase 8 coupled MLUPS {n}^2 flow + tracer [{card}]: kernel f32 "
        f"{mlups[('kernel', 'f32')]:.1f}, kernel bf16 "
        f"{mlups[('kernel', 'bf16')]:.1f}, plain f32 "
        f"{mlups[('plain', 'f32')]:.1f}, plain bf16 "
        f"{mlups[('plain', 'bf16')]:.1f}; ms/step kernel f32 "
        f"{res['sec'][('kernel', 'f32')] * 1e3:.4f}, bf16 "
        f"{res['sec'][('kernel', 'bf16')] * 1e3:.4f}; roofline share of the "
        f"design bytes ({COUPLED_BYTES['f32']} / {COUPLED_BYTES['bf16']} B "
        f"at 3.35 TB/s) f32 {roof['f32']:.3f}, bf16 {roof['bf16']:.3f}",
        f"phase 8 torch.profiler device us per launch (launches per step) "
        f"{n}^2 [{card}]: " + ", ".join(
            f"{k} {st} " + ("not measured" if v is None else
                            f"{v[0]:.2f} ({v[1]:g})")
            for (st, k), v in res["profile"].items())]


# -- the split (f_r, f_b) layout: K6 and K5s -------------------------------

def golden_flow():
    """tests/test_golden.py's csf_mini flow (phase 3's, scaled up there):
    CSF MRT, tau_b 0.8, tau_type 2, Akai wetting at 60 degrees, Neumann
    inlet at v = -1e-4, Dirichlet outlet.  Returns (params, boundaries)."""
    from openlbmpm_torch.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams)
    params = ColorGradientParams(
        variant="CSF", collision="MRT", surface_tension=0.01, tau_r=1.0,
        tau_b=0.8, tau_type=2, wetting_type=2, contact_angle_deg=60.0)
    bcs = CGBoundaryConfig(inlet="neumann", outlet="dirichlet",
                           inlet_velocity=-1e-4, outlet_density_r=0.0,
                           outlet_density_b=1.0)
    return params, bcs


def split_cases():
    """name -> (params, boundaries) of phase 9: both collisions under the
    golden boundary rows, and under a per-colour Dirichlet inlet (nonzero
    target densities) with a convective outlet."""
    import dataclasses
    params, bcs = golden_flow()
    dc = dataclasses.replace(bcs, inlet="dirichlet", outlet="convective",
                             inlet_density_r=1.0005, inlet_density_b=2e-3)
    srt = dataclasses.replace(params, collision="SRT", tau_type=1)
    return {"mrt_neumann_dirichlet": (params, bcs),
            "srt_neumann_dirichlet": (srt, bcs),
            "mrt_dirichlet_convective": (params, dc),
            "srt_dirichlet_convective": (srt, dc)}


def phase_split_f64(device, ny=256, nx=128, steps=20, tol=1e-11):
    """The split CSF kernel against its plain version at f64."""
    from openlbmpm_torch.kernels.csf import (
        csf_step_split, csf_step_split_reference)
    from openlbmpm_torch.models.colorgradient import ColorGradientRK
    out = {}
    for name, (params, bcs) in split_cases().items():
        m = ColorGradientRK(walled(ny, nx), params, bcs, dtype=torch.float64,
                            device=device)
        a = b = m.init_state_layers(1.0, 1.0, invading_rows=ny // 5)
        err = 0.0
        for _ in range(steps):
            a = csf_step_split(a, m)
            b = csf_step_split_reference(b, m)
            err = max(err, *(float((x - y).abs().max()) for x, y in zip(a, b)))
        check(all(bool(torch.isfinite(x).all()) for x in a),
              f"split f64 {name}: state not finite")
        check(err <= tol, f"split f64 {name}: kernel vs plain {err:.3e} > "
              f"{tol:g}")
        out[name] = err
    return out


def phase_golden(device, atol=1e-10):
    """tests/golden/csf_mini.npz through the split kernel at f64 (the setup
    of tests/test_golden.py::test_golden_csf_mini)."""
    import os
    from openlbmpm_torch.kernels.csf import csf_step_split
    from openlbmpm_torch.models.colorgradient import ColorGradientRK
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden", "csf_mini.npz")
    m = ColorGradientRK(walled(48, 24), *golden_flow(), dtype=torch.float64,
                        device=device)
    st = m.init_state_layers(1.0, 1.0, invading_rows=10)
    before = csf_step_split.launches
    for _ in range(50):
        st = m.step(st)
    check(csf_step_split.launches - before == 50,
          "golden run did not go through the split kernel")
    with np.load(path) as z:
        err = max(float(np.abs(st[0].sum(0).cpu().numpy() - z["rho_r"]).max()),
                  float(np.abs(st[1].sum(0).cpu().numpy() - z["rho_b"]).max()))
    check(err <= atol, f"csf_mini.npz through the split kernel: {err:.3e} > "
          f"{atol:g}")
    return err


def split_coupled_cases():
    """Phase 6's tracer cases plus the split step's own options: (model
    keyword changes, TransportParams fields)."""
    cases = {k: ({}, v) for k, v in COUPLED_CASES.items()}
    cases["conserve_mass"] = ({}, COUPLED_CASES["a"] | {"conserve_mass": True})
    cases["redistribute"] = ({}, COUPLED_CASES["b"] |
                             {"interface_mode": "redistribute"})
    cases["standalone"] = ({"standalone": True}, COUPLED_CASES["a"])
    return cases


def phase_split_coupled_f64(device, ny=96, nx=64, steps=20, tol=1e-11):
    """The split coupled step on the kernels (``TransportRK.step``: the
    kernels, then the repairs) against the plain split coupled step
    (``plain_step``) at f64, with tracer mass on the BC rows."""
    out = {}
    for seed, (name, (kw, tp)) in enumerate(split_coupled_cases().items()):
        m = coupled_model(device, "f32", tp, dtype=torch.float64, ny=ny,
                          nx=nx, **kw)
        a = b = m.init_state(
            m.flow.init_state_layers(1.0, 1.0, invading_rows=ny // 5),
            coupled_conc0(m.tp.num_tracers, ny, nx, seed))
        es = eg = 0.0
        for _ in range(steps):
            a = m.step(a)
            b = m.plain_step(b)
            es = max(es, *(float((x - y).abs().max())
                           for x, y in zip(a[:2], b[:2])))
            eg = max(eg, float((a.g - b.g).abs().max()))
        check(all(bool(torch.isfinite(x).all()) for x in a[:3]),
              f"split f64 coupled case {name}: state not finite")
        check(es <= tol and eg <= tol, f"split f64 coupled case {name}: "
              f"kernel vs plain flow {es:.3e}, tracers {eg:.3e} > {tol:g}")
        out[name] = (es, eg)
    return out


def _ini_copy(src: str, dst: str, values: dict):
    """`src` with each `key = ...` line of `values` set to its value,
    written to `dst`."""
    text = open(src).read()
    for key, v in values.items():
        text = re.sub(rf"(?m)^{key} = .*$", f"{key} = {v}", text)
    with open(dst, "w") as fh:
        fh.write(text)


def _mini_ini(src: str, dst: str, n: int, interval: int):
    """`src` with the domain set to n x n and the output interval to
    `interval`, written to `dst`."""
    _ini_copy(src, dst, {"xDomain": n, "yDomain": n,
                         "TimeInterval": interval})


def _mlups(metrics_path: str) -> list:
    with open(metrics_path) as fh:
        return [json.loads(ln).get("mlups") for ln in fh if ln.strip()][1:]


def phase_cli(device, n=FLAGSHIP_N, cg_steps=1000, tr_steps=500):
    """The user's entry point on the card: ``run --model cg`` and ``run
    --model transport`` through ``openlbmpm_torch.cli.main``."""
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.checkpoint import load_checkpoint
    from openlbmpm_torch.kernels.csf import csf_step_split
    from openlbmpm_torch.kernels.transport import coupled_step_split
    root = os.path.dirname(os.path.abspath(__file__))
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ini = os.path.join(tmp, "rk_csf2d.ini")
        _mini_ini(os.path.join(root, "configs", "rk_csf2d.ini"), ini, n, 500)
        out = os.path.join(tmp, "cg")
        csf_step_split.launches = 0
        counts = cg2d_counts("csf2d")
        t0 = time.perf_counter()
        rc = cli.main(["run", ini, "--model", "cg", "--steps", str(cg_steps),
                       "--output", out, "--device", "cuda", "--block", "1"])
        res["cg_sec"] = time.perf_counter() - t0
        res["cg_launches"] = csf_step_split.launches
        res["cg_per_step"] = cg2d_launches_a_step("csf2d", counts, cg_steps,
                                                  "cli cg (K6)")
        check(rc == 0, f"cli run --model cg returned {rc}")
        check(res["cg_launches"] == cg_steps, f"cli cg: split kernel launched "
              f"{res['cg_launches']} times, want {cg_steps}")
        with np.load(os.path.join(out, "checkpoint.npz")) as z:
            shapes = [z[f"leaf{i}"].shape for i in range(2)]
        like = tuple(torch.zeros(sh, device=device) for sh in shapes)
        (f_r, f_b), step = load_checkpoint(os.path.join(out, "checkpoint.npz"),
                                           like)
        check(step == cg_steps and f_r.shape[0] == 9 and
              bool(torch.isfinite(f_r).all() and torch.isfinite(f_b).all()),
              f"cli cg: checkpoint at step {step} {tuple(f_r.shape)} not a "
              "finite split state")
        res["cg_mlups"] = _mlups(os.path.join(out, "metrics.jsonl"))
        res["cg_shape"] = tuple(f_r.shape[1:])

        out = os.path.join(tmp, "transport")
        coupled_step_split.launches = 0
        counts = cg2d_counts("coupled2d")
        t0 = time.perf_counter()
        rc = cli.main(["run", os.path.join(root, "configs",
                                           "transportsetup.ini"),
                       "--model", "transport", "--physics-config", ini,
                       "--steps", str(tr_steps), "--output", out,
                       "--device", "cuda", "--block", "1"])
        res["tr_sec"] = time.perf_counter() - t0
        res["tr_launches"] = coupled_step_split.launches
        res["tr_per_step"] = cg2d_launches_a_step(
            "coupled2d", counts, tr_steps, "cli transport (K5s)")
        check(rc == 0, f"cli run --model transport returned {rc}")
        check(res["tr_launches"] == tr_steps, f"cli transport: split coupled "
              f"kernels launched {res['tr_launches']} times, want {tr_steps}")
        with open(os.path.join(out, "metrics.jsonl")) as fh:
            recs = [json.loads(ln) for ln in fh if ln.strip()]
        mass = recs[-1]["tracer0_mass"]
        check(recs[-1]["step"] == tr_steps and np.isfinite(mass) and mass > 0,
              f"cli transport: last record {recs[-1]}")
        res["tr_mass"] = mass
        res["tr_mlups"] = _mlups(os.path.join(out, "metrics.jsonl"))
    return res


def time_pair(kernel, plain, x, kernel_steps, plain_steps, device):
    """Seconds per step of x = kernel(x) and x = plain(x): plain, kernel,
    kernel, plain, keeping the best of each."""
    best = {}
    for path in ("plain", "kernel", "kernel", "plain"):
        fn, k = (kernel, kernel_steps) if path == "kernel" \
            else (plain, plain_steps)
        best[path] = min(best.get(path, float("inf")),
                         _time_steps(fn, x, k, device))
    return best


def phase_split_speed(device, n=FLAGSHIP_N):
    """Split f32 at 1024^2: the split CSF step (flagship flow) and the
    split coupled step (config 4, also with the conserve_mass and with the
    redistribute repair after the kernels), kernel and plain path, and the
    device time of each CUDA kernel per launch.  conserve_mass adds tracer
    mass each step (ROADMAP section 3), so it is timed over 20 steps."""
    from openlbmpm_torch.kernels.csf import (
        csf_step_split, csf_step_split_reference, launch_csf2d_split)
    from openlbmpm_torch.kernels.transport import launch_coupled2d_split
    m = flagship_model(device, "f32", n=n)
    st = m.init_state_layers(1.0, 1.0, invading_rows=100 * n // 1024)
    res = {"flow": time_pair(lambda x: csf_step_split(x, m),
                             lambda x: csf_step_split_reference(x, m), st,
                             500, 30, device)}
    res["flow_profile"] = device_times(
        lambda x: launch_csf2d_split(*x, m.kernel_params, m.geo_planes), st,
        KERNELS)
    for name, tp, k in (
            ("coupled", CONFIG4_TRACER, 300),
            ("conserve_mass", CONFIG4_TRACER | {"conserve_mass": True}, 20),
            ("redistribute", CONFIG4_TRACER |
             {"interface_mode": "redistribute"}, 300)):
        mc = coupled_model(device, "f32", tp)
        cst, _ = config4_state(mc, n)
        res[name] = time_pair(mc.step, mc.plain_step, cst, k, 20, device)
        if name == "coupled":
            args = (mc.flow.kernel_params, mc.tracer_params,
                    mc.flow.geo_planes, mc.tracer_table)
            res["coupled_profile"] = device_times(
                lambda x: launch_coupled2d_split(*x, *args)[:3],
                tuple(cst[:3]), COUPLED_KERNELS)
    return res


def cli_configs(n=FLAGSHIP_N):
    """What ``run --model cg|transport`` builds from configs/rk_csf2d.ini
    set to an n x n domain (plus its buffer rows) and from
    configs/transportsetup.ini: (params, boundaries, geometry, invading
    rows, TransportParams)."""
    import os
    import tempfile
    from openlbmpm_torch.cli import _build_geometry
    from openlbmpm_torch.config import load_colorgradient, load_transport
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ini = os.path.join(tmp, "rk_csf2d.ini")
        _mini_ini(os.path.join(root, "configs", "rk_csf2d.ini"), ini, n, 500)
        params, bcs, domain, _ = load_colorgradient(ini)
    tp = load_transport(os.path.join(root, "configs", "transportsetup.ini"))
    return (params, bcs, _build_geometry(domain),
            max(domain.buffer_layers, 10), tp)


def _cast(state, dtype):
    vals = [t.to(dtype) for t in state]
    return type(state)(*vals) if hasattr(state, "_fields") else tuple(vals)


def _steps(fn, x, steps):
    for _ in range(steps):
        x = fn(x)
    return x


def split_gaps(models, st64, kernel, plain, steps, away):
    """Kernel and plain path from the f64 split state `st64`, `steps` steps
    at f64 (models[torch.float64]) and at f32: the gaps of phase_split_full
    over the colour planes, and over the tracer PDFs where the state has
    them (`away` masks the cells off the seam)."""
    f64, f32 = torch.float64, torch.float32
    runs = {(dt, path): _steps(lambda x, f=fn, m=models[dt]: f(x, m),
                               _cast(st64, dt), steps)
            for dt in (f64, f32) for path, fn in (("kernel", kernel),
                                                   ("plain", plain))}
    flow = {k: torch.cat([v[0], v[1]]) for k, v in runs.items()}
    gap = lambda a, b: float((a - b).abs().max())  # noqa: E731
    d = (flow[f32, "kernel"] - flow[f32, "plain"]).abs()
    ref = flow[f64, "plain"]
    r = {"f64": gap(flow[f64, "kernel"], ref),
         "planes": float(d[:, away].max()), "max": float(d.max()),
         "from_f64": (gap(flow[f32, "kernel"].double(), ref),
                      gap(flow[f32, "plain"].double(), ref)),
         "finite": all(bool(torch.isfinite(t).all()) for v in runs.values()
                       for t in v[:3])}
    tot = [float(runs[f32, p][0].double().sum()) for p in ("kernel", "plain")]
    tot0 = float(st64[0].sum())
    r["mass"] = (abs(tot[0] - tot[1]) / tot[1], abs(tot[0] - tot0) / tot0)
    if hasattr(st64, "g"):
        gk, gp = runs[f32, "kernel"].g, runs[f32, "plain"].g
        r["f64"] = max(r["f64"], gap(runs[f64, "kernel"].g,
                                     runs[f64, "plain"].g))
        r["g"] = float((gk - gp).abs()[:, :, away].max())
        r["max"] = max(r["max"], gap(gk, gp))
        mk, mp = float(gk.double().sum()), float(gp.double().sum())
        m0 = float(st64.g.sum())
        r["tracer_mass"] = (abs(mk - mp) / m0, abs(mk - m0) / m0)
        r["conc_min"] = min(float(x.sum(1).min()) for x in (gk, gp))
    return r


def phase_split_full(device, n=FLAGSHIP_N, steps=10, tol=3e-5):
    """The split counterpart of phases 4 and 7, at full size and at f32,
    the type the CLI runs: K6 on the flagship flow and on the CLI's cg
    configuration, K5s on config 4 and on the CLI's transport
    configuration.  From one f64 start, kernel and plain path run `steps`
    steps at f64 (<= 1e-11) and in f32, where off the seam rows and corners
    the colour planes (and the tracer PDFs, there and off the `steps` + 2
    rows next to the seam) agree to `tol`; the kernel is no further from the
    f64 plain run than max(1.5x the plain f32 path, `tol`); total rho_r
    within 1e-4 of the plain path (and of the start on phase 4's and
    phase 7's flow: the CLI's configuration, with 10 invading rows against
    100, gains 1.2e-4 of its red mass through the inlet in 10 steps);
    tracer mass within 1e-7 per step of the plain path (and, in config 4,
    which has no tracer inlet or outlet, of the start); concentrations
    >= -1e-4."""
    from openlbmpm_torch.kernels.csf import (
        csf_step_split, csf_step_split_reference)
    from openlbmpm_torch.models.colorgradient import ColorGradientRK
    from openlbmpm_torch.models.transport import TransportParams, TransportRK
    params, bcs, geo_cli, rows_cli, tp_cli = cli_configs(n)
    flows = {"flagship": (walled(n, n), *flagship_flow(), 100 * n // 1024),
             "cli_cg": (geo_cli, params, bcs, rows_cli)}
    dts = (torch.float64, torch.float32)
    res = {}
    for name, (geo, p, b, rows) in flows.items():
        models = {dt: ColorGradientRK(geo, p, b, dtype=dt, device=device)
                  for dt in dts}
        st = models[torch.float64].init_state_layers(1.0, 1.0,
                                                     invading_rows=rows)
        res[name] = split_gaps(models, st, csf_step_split,
                               csf_step_split_reference, steps,
                               seam_masks(*geo.shape, steps, device))
    coupled = {"config4": ("flagship", TransportParams(**CONFIG4_TRACER)),
               "cli_transport": ("cli_cg", tp_cli)}
    for name, (flow, tp) in coupled.items():
        geo, p, b, rows = flows[flow]
        models = {dt: TransportRK(geo, p, tp, b, dtype=dt, device=device)
                  for dt in dts}
        ny, nx = geo.shape
        conc0 = np.zeros((tp.num_tracers, ny, nx))
        if name == "config4":
            conc0[:, ny - 280 * n // 1024:ny - 120 * n // 1024] = 1.0
        else:     # a band across the interface, below the tracer inlet
            conc0[:, ny - rows - 50:ny - 5] = 1.0
        m64 = models[torch.float64]
        st = m64.init_state(m64.flow.init_state_layers(1.0, 1.0, rows),
                            conc0)
        away = seam_masks(ny, nx, steps, device)
        away[:steps + 2] = away[ny - steps - 2:] = False
        res[name] = split_gaps(models, st, lambda x, m: m.step(x),
                               lambda x, m: m.plain_step(x), steps, away)
    for name, r in res.items():
        acc_k, acc_p = r["from_f64"]
        check(r["finite"], f"split full size {name}: state not finite")
        check(r["f64"] <= 1e-11, f"split full size {name}: f64 kernel vs "
              f"plain {r['f64']:.3e} > 1e-11")
        check(r["planes"] <= tol and r.get("g", 0.0) <= tol,
              f"split full size {name} f32 off the seam: planes "
              f"{r['planes']:.3e}, tracers {r.get('g', 0.0):.3e} > {tol:g}")
        check(acc_k <= max(1.5 * acc_p, tol), f"split full size {name} f32: "
              f"kernel {acc_k:.3e} from f64, the plain path {acc_p:.3e}")
        check(r["mass"][0] <= 1e-4 and (name.startswith("cli") or
                                        r["mass"][1] <= 1e-4),
              f"split full size {name}: total rho_r kernel vs plain "
              f"{r['mass'][0]:.2e}, change {r['mass'][1]:.2e}")
        if "g" in r:
            gap, change = r["tracer_mass"]
            check(gap <= 1e-7 * steps and (name != "config4" or
                                           change <= 1e-7 * steps),
                  f"split full size {name}: tracer mass kernel vs plain "
                  f"{gap:.2e}, from the start {change:.2e}")
            check(r["conc_min"] >= -1e-4, f"split full size {name}: "
                  f"concentration {r['conc_min']:.2e}")
    return res


def phase14_line(res, card) -> str:
    parts = []
    for k, r in res.items():
        txt = (f"{k}: f64 {r['f64']:.3e} (<= 1e-11); f32 off the seam planes "
               f"{r['planes']:.3e}")
        if "g" in r:
            txt += f", tracers {r['g']:.3e}"
        txt += (f" (<= 3e-5), max {r['max']:.3e}; from f64 kernel "
                f"{r['from_f64'][0]:.3e} vs plain {r['from_f64'][1]:.3e}; "
                f"total rho_r kernel vs plain {r['mass'][0]:.2e}, change "
                f"{r['mass'][1]:.2e}")
        if "g" in r:
            txt += (f"; tracer mass kernel vs plain {r['tracer_mass'][0]:.2e},"
                    f" from the start {r['tracer_mass'][1]:.2e}; conc min "
                    f"{r['conc_min']:.2e}")
        parts.append(txt)
    return (f"phase 14 split kernels vs plain at full size, 10 steps, f64 and "
            f"f32 [{card}]: " + "; ".join(parts))


def phase9_13_lines(r9, r10, r11, r12, r13, card, n=FLAGSHIP_N):
    def mlups(sec):
        return n * n / sec / 1e6

    def prof(p):
        return ", ".join(f"{k} " + ("not measured" if v is None else
                                    f"{v[0]:.2f} ({v[1]:g})")
                         for k, v in p.items())
    cg_cells = r12["cg_shape"][0] * r12["cg_shape"][1]
    return [
        "phase 9 split f64 kernel vs plain, 256x128, 20 steps: max |diff| " +
        ", ".join(f"{k} {v:.3e}" for k, v in r9.items()) + " (<= 1e-11)",
        f"phase 10 tests/golden/csf_mini.npz through the split kernel, f64, "
        f"50 steps: max |diff| {r10:.3e} (<= 1e-10)",
        "phase 11 split f64 coupled kernels vs plain, 96x64, 20 steps, max "
        "|diff| flow/tracers: " + ", ".join(
            f"{k} {es:.3e}/{eg:.3e}" for k, (es, eg) in r11.items()) +
        " (<= 1e-11)",
        f"phase 12 cli run --model cg, {r12['cg_shape'][0]}x"
        f"{r12['cg_shape'][1]} ({cg_cells} cells), 1000 f32 steps: "
        f"{r12['cg_launches']} split kernel launches (the library's count "
        f"a step: {_fmt_counts(r12['cg_per_step'])}), {r12['cg_sec']:.2f} s "
        f"with I/O, metrics.jsonl MLUPS {r12['cg_mlups']} [{card}]",
        f"phase 12 cli run --model transport, same domain, 500 f32 steps: "
        f"{r12['tr_launches']} split coupled launches (the library's count "
        f"a step: {_fmt_counts(r12['tr_per_step'])}), {r12['tr_sec']:.2f} s "
        f"with I/O, tracer0 mass {r12['tr_mass']:.6g}, metrics.jsonl MLUPS "
        f"{r12['tr_mlups']} [{card}]",
        f"phase 13 split f32 MLUPS {n}^2 [{card}]: flow kernel "
        f"{mlups(r13['flow']['kernel']):.1f} "
        f"({r13['flow']['kernel'] * 1e3:.4f} ms), flow plain "
        f"{mlups(r13['flow']['plain']):.1f} "
        f"({r13['flow']['plain'] * 1e3:.4f} ms); coupled config 4 kernel "
        f"{mlups(r13['coupled']['kernel']):.1f} "
        f"({r13['coupled']['kernel'] * 1e3:.4f} ms), coupled plain "
        f"{mlups(r13['coupled']['plain']):.1f} "
        f"({r13['coupled']['plain'] * 1e3:.4f} ms); " + "; ".join(
            f"{k} (kernels + repair) {mlups(r13[k]['kernel']):.1f} "
            f"({r13[k]['kernel'] * 1e3:.4f} ms), plain "
            f"{mlups(r13[k]['plain']):.1f} ({r13[k]['plain'] * 1e3:.4f} ms)"
            for k in ("conserve_mass", "redistribute")),
        f"phase 13 torch.profiler device us per launch (launches per step) "
        f"{n}^2 split f32 [{card}]: flow: {prof(r13['flow_profile'])}; "
        f"coupled: {prof(r13['coupled_profile'])}"]


# -- the Shan-Chen family: K8 ----------------------------------------------

_SC = dict(g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(-0.3, 0.3),
           tau=(1.0, 0.8))
_EFS = dict(g_matrix=((0.0, 0.2), (0.2, 0.0)), g_solid=(-0.14, 0.14),
            tau=(1.0, 0.8), scheme="EFS")
# shanchen2D.ini's rows, efs2D.ini's rows, and Zou-He pressure at both ends
_VC = dict(inlet="zou_he_velocity", outlet="convective",
           inlet_velocity=(-1e-3, 0.0))
_VP = dict(inlet="zou_he_velocity", outlet="zou_he_pressure",
           inlet_velocity=(-1e-3, 0.0), outlet_density=(0.02, 1.0))
_PP = dict(inlet="zou_he_pressure", outlet="zou_he_pressure",
           inlet_density=(1.0, 0.02), outlet_density=(0.02, 1.0))
_G3 = ((0.0, 3.6, 3.6), (3.6, 0.0, 3.6), (3.6, 3.6, 0.0))

# name -> (ShanChenParams fields, SCBoundaryConfig fields, initial state);
# the first ten take the kernel (the JAX fused builder takes them), the
# rest the plain step on every device (the JAX package keeps them on its
# jnp path too).  Phase 15 and tests/test_torch_*.py use this table.
SC_CASES = {
    "sc_srt_periodic_body_force": (_SC | dict(body_force=(1e-6, -2e-6)), {},
                                   "droplet"),
    "sc_srt_velocity_convective": (_SC, _VC, "layers"),
    "sc_srt_pressure_pressure": (_SC, _PP, "layers"),
    "sc_mrt_velocity_convective": (_SC | dict(collision="MRT"), _VC,
                                   "layers"),
    "sc_peng_robinson_one_fluid": (dict(g_matrix=((-1.0,),), g_solid=(0.0,),
                                        tau=(1.0,), psi="PR"), {},
                                   "pr_droplet"),
    "sc_three_fluids": (dict(g_matrix=_G3, g_solid=(0.1, 0.0, -0.1),
                             tau=(1.0, 0.9, 0.8)), {}, "bands"),
    "efs4_srt_velocity_pressure": (_EFS, _VP, "layers"),
    "efs8_mrt_velocity_convective": (_EFS | dict(iso_order=8,
                                                 collision="MRT"), _VC,
                                     "layers"),
    "efs10_srt_pressure_pressure": (_EFS | dict(iso_order=10), _PP, "layers"),
    "efs10_mrt_velocity_pressure": (_EFS | dict(iso_order=10,
                                                collision="MRT"), _VP,
                                    "layers"),
    "guo_srt": (_SC | dict(forcing="guo"), _VC, "layers"),
    "guo_mrt": (_SC | dict(forcing="guo", collision="MRT"), {}, "droplet"),
    "edm_srt": (_SC | dict(forcing="edm"), {}, "droplet"),
    "edm_mrt": (_SC | dict(forcing="edm", collision="MRT"), _VC, "layers"),
    "chang_velocity": (_SC, _VC | dict(inlet="chang_velocity"), "layers"),
    "chang_pressure": (_SC, dict(inlet="chang_pressure",
                                 outlet="chang_pressure",
                                 inlet_density=(1.01, 0.02),
                                 outlet_density=(0.02, 1.0)), "layers"),
    "convective_true": (_SC, _VC | dict(outlet="convective_true",
                                        inlet_velocity=(-5e-3, 0.0)),
                        "layers"),
    "moving_wall": (dict(g_matrix=((0.0, 0.5), (0.5, 0.0)),
                         g_solid=(0.0, 0.0), tau=(0.8, 0.8)), {}, "couette"),
}
SC_KERNEL_CASES = tuple(SC_CASES)[:10]
WALL_VELOCITY = (0.05, 0.0)


def _g4(g):
    """The 4 x 4 fluid-fluid matrix with g off the diagonal."""
    return tuple(tuple(0.0 if i == j else g for j in range(4))
                 for i in range(4))


_SC4 = dict(g_matrix=_g4(3.6), g_solid=(-0.3, 0.3, 0.1, -0.1),
            tau=(1.0, 0.8, 0.9, 1.1))
_EFS4 = dict(g_matrix=_g4(0.2), g_solid=(-0.14, 0.14, 0.0, 0.07),
             tau=(1.0, 0.8, 0.9, 1.1), scheme="EFS")
_VC4 = dict(inlet="zou_he_velocity", outlet="convective",
            inlet_velocity=(-1e-3, 0.0, 0.0, 0.0))
_VP4 = _VC4 | dict(outlet="zou_he_pressure",
                   outlet_density=(0.02, 1.0, 0.02, 0.02))
_PP4 = dict(inlet="zou_he_pressure", outlet="zou_he_pressure",
            inlet_density=(1.0, 0.02, 0.02, 0.02),
            outlet_density=(0.02, 1.0, 0.02, 0.02))
# K = 4 fluids in four bands (as SC_CASES): the runtime-K instance of K8 /
# K8-T (phase 58, tests/test_torch_shanchen.py)
SC4_CASES = {
    "sc4_srt_periodic_body_force": (_SC4 | dict(body_force=(1e-6, -2e-6)),
                                    {}, "bands"),
    "sc4_mrt_velocity_convective": (_SC4 | dict(collision="MRT"), _VC4,
                                    "bands"),
    "sc4_srt_pressure_pressure": (_SC4, _PP4, "bands"),
    "efs4_4f_velocity_pressure": (_EFS4, _VP4, "bands"),
    "efs10_4f_mrt_velocity_convective": (_EFS4 | dict(iso_order=10,
                                                      collision="MRT"),
                                         _VC4, "bands"),
}


def sc_solid(ny, nx, init):
    """The case's solid nodes: side walls, or for the moving-wall case a
    stationary bottom wall and a moving lid (the top two rows).  Returns
    (solid, moving-wall mask or None)."""
    solid = np.zeros((ny, nx), bool)
    if init != "couette":
        solid[:, 0] = solid[:, -1] = True
        return solid, None
    solid[:2] = solid[-2:] = True
    moving = np.zeros_like(solid)
    moving[-2:] = True
    return solid, moving


def sc_rho0(k, ny, nx, init):
    """Initial fluid densities (K, ny, nx) of the case (before masking)."""
    rho = np.full((k, ny, nx), 0.02)
    if init == "pr_droplet":        # liquid-vapour, one fluid
        yy, xx = np.mgrid[0:ny, 0:nx]
        inside = (yy - ny / 2) ** 2 + (xx - nx / 2) ** 2 <= (ny / 4) ** 2
        return np.where(inside, 0.2, 0.05)[None]
    if init == "bands":             # three immiscible bands
        for i in range(k):
            rho[i, i * ny // k:(i + 1) * ny // k] = 1.0
        return rho
    if init == "droplet":
        yy, xx = np.mgrid[0:ny, 0:nx]
        inside = (yy - ny / 2) ** 2 + (xx - nx / 2) ** 2 <= (ny / 5) ** 2
        rho[0][inside] = 1.0
        rho[1][~inside] = 1.0
        return rho
    top = np.arange(ny)[:, None] >= ny - ny // 4    # layers, couette
    rho[0] = np.where(top, 1.0, 0.02)
    rho[1] = np.where(top, 0.02, 1.0)
    return np.broadcast_to(rho, (k, ny, nx)).copy()


def sc_case(name, device, ny=128, nx=64, dtype=torch.float64,
            storage="f32"):
    """The port's ShanChenMCMP of case `name` on an ny x nx domain and its
    initial state."""
    from openlbmpm_torch.geometry import from_solid_mask
    from openlbmpm_torch.models.shanchen import (
        SCBoundaryConfig, ShanChenMCMP, ShanChenParams)
    p, b, init = (SC_CASES | SC4_CASES)[name]
    solid, moving = sc_solid(ny, nx, init)
    m = ShanChenMCMP(from_solid_mask(solid), ShanChenParams(**p),
                     SCBoundaryConfig(**b), dtype=dtype, device=device,
                     storage=storage, moving_wall_mask=moving,
                     wall_velocity=WALL_VELOCITY)
    return m, m._feq_init(sc_rho0(m.k, ny, nx, init) * m.geo.is_fluid)


# phase 15's launches a step of each kernel of the sc2d_f64 library by
# case, as the library counts them ({case: {kernel: launches a step}})
SC_STEP_LAUNCHES: dict = {}


def per_step(before, after, steps):
    """{kernel: launches a step} from a library's counts before and after
    `steps` steps."""
    return {k: (after[k] - before[k]) / steps for k in after}


def sc_want_kernels(storage, outlet):
    """The kernels of K8 a step, once each: f32 / f64 the push (and the
    outlet rows with an outlet), bf16 the pull."""
    if storage == "bf16":
        return ("collide_stream_kernel",)
    return ("sc_push_kernel",) + (("sc_outlet_kernel",) if outlet else ())


def phase_sc_f64(device, ny=128, nx=64, steps=20, tol=1e-11):
    """K8 against its plain version at f64 in every kernel case, each
    kernel's launches a step by the library's count (SC_STEP_LAUNCHES:
    sc_want_kernels once each, the others never); the plain cases take the
    plain step on the card and launch nothing."""
    from openlbmpm_torch.kernels.shanchen import (kernel_launches, sc_step,
                                                  sc_step_reference)
    out = {}
    for name in SC_CASES:
        m, a = sc_case(name, device, ny, nx)
        kernel = name in SC_KERNEL_CASES
        check(m.path == ("kernel" if kernel else "plain"),
              f"sc {name}: path {m.path}")
        before = sc_step.launches
        if not kernel:
            for _ in range(3):
                a = m.step(a)
            check(sc_step.launches == before and bool(torch.isfinite(a).all())
                  and a.device == m.device,
                  f"sc {name}: the plain step on the card")
            continue
        b = a
        err = 0.0
        counts = kernel_launches("sc2d_f64")
        for _ in range(steps):
            a = sc_step(a, m)
            b = sc_step_reference(b, m)
            err = max(err, float((a - b).abs().max()))
        per = per_step(counts, kernel_launches("sc2d_f64"), steps)
        want = sc_want_kernels("f64", m.bcs.outlet != "periodic")
        SC_STEP_LAUNCHES[name] = per
        check(all(v == (k in want) for k, v in per.items()),
              f"sc {name}: kernel launches a step {per}, want {want} once")
        check(sc_step.launches - before == steps and
              bool(torch.isfinite(a).all()), f"sc {name}: launches or state")
        check(err <= tol, f"sc f64 {name}: kernel vs plain {err:.3e} > {tol:g}")
        out[name] = err
    return out


def phase_sc_golden(device, atol=1e-10):
    """tests/golden/sc_mini.npz through K8 at f64 (the setup of
    tests/test_golden.py::test_golden_sc_mini: 48x24 walled, a droplet,
    50 steps)."""
    import os
    from openlbmpm_torch.kernels.shanchen import sc_step
    from openlbmpm_torch.models.shanchen import ShanChenMCMP, ShanChenParams
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden", "sc_mini.npz")
    p = ShanChenParams(g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(-0.3, 0.3),
                       tau=(1.0, 1.0))
    m = ShanChenMCMP(walled(48, 24), p, dtype=torch.float64, device=device)
    f = m.init_state_droplet((1.0, 1.0), (0.02, 0.02), center=(24, 12),
                             radius=7.0)
    before = sc_step.launches
    for _ in range(50):
        f = m.step(f)
    check(sc_step.launches - before == 50,
          "golden run did not go through the Shan-Chen kernel")
    with np.load(path) as z:
        err = float(np.abs(f.sum(1).cpu().numpy() - z["rho"]).max())
    check(err <= atol, f"sc_mini.npz through K8: {err:.3e} > {atol:g}")
    return err


def sc_config(name, device, storage="f32", dtype=torch.float32,
              n=FLAGSHIP_N):
    """benchmarks/bench_all.py's Shan-Chen configurations on n x n: config
    2, an original-SC droplet (G = 3.8, G_s = -0.4 / 0.4) on a wall of two
    solid rows, radius 100 n/1024; config 3, an EFS iso-8 MRT droplet at
    viscosity contrast (tau 1.0 / 0.55), periodic, radius 120 n/1024; or
    one of the CLI's configurations (``sc_cli_config``, f32 storage).
    Returns (model, initial state in dtype)."""
    from openlbmpm_torch.geometry import from_solid_mask
    from openlbmpm_torch.models.shanchen import ShanChenMCMP, ShanChenParams
    if name.startswith("cli"):
        return sc_cli_config(name, device, dtype, n)
    solid = np.zeros((n, n), bool)
    if name == "config2":
        solid[:2, :] = True
        p = ShanChenParams(g_matrix=((0.0, 3.8), (3.8, 0.0)),
                           g_solid=(-0.4, 0.4), tau=(1.0, 1.0))
    else:
        p = ShanChenParams(g_matrix=((0.0, 0.2), (0.2, 0.0)),
                           g_solid=(0.0, 0.0), tau=(1.0, 0.55), scheme="EFS",
                           iso_order=8, collision="MRT")
    m = ShanChenMCMP(from_solid_mask(solid), p, dtype=dtype, device=device,
                     storage=storage)
    if name == "config2":
        f = m.init_state_droplet((1.0, 1.0), (0.02, 0.02),
                                 center=(2.0, n / 2), radius=100.0 * n / 1024)
    else:
        f = m.init_state_droplet((1.0, 1.0), (0.02, 0.02),
                                 radius=120.0 * n / 1024)
    return m, f


def sc_cli_config(name, device, dtype=torch.float32, n=FLAGSHIP_N):
    """What ``run --model sc`` builds (``cli._shanchen_setup``) from
    configs/twophasesetup.ini at n x n: "cli_sc" with shanchen2D.ini (SC,
    Zou-He velocity inlet, convective outlet), "cli_efs" as EFS with
    efs2D.ini (iso-4, Zou-He pressure outlet).  Returns (model, initial
    state in dtype)."""
    import os
    import tempfile
    from openlbmpm_torch.cli import _shanchen_setup
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ini, phys = _sc_ini(root, tmp, n, name == "cli_efs")
        m, f, _ = _shanchen_setup(ini, phys, dtype, device)
    return m, f


# bounds of phase 17, about 10x the gaps measured on an H100 (f32 1.8e-7,
# bf16 3.2e-4 over 10 steps at 1024^2; one more bf16 step from a common
# state: at most 8.9e-4 of the values off, by one ulp, held to 1e-2, which
# a round-toward-zero encoding exceeds, as phase 4 shows)
SC_BOUNDS = {"f32": 2e-6, "bf16": 3e-3}
# phase 17's configurations and the storage types each is checked in (the
# CLI runs f32 only)
SC_CHECKED = {"config2": ("f32", "bf16"), "config3": ("f32", "bf16"),
              "cli_sc": ("f32",), "cli_efs": ("f32",)}


def phase_sc_configs(device, n=FLAGSHIP_N, steps=10):
    """Configs 2 and 3 and the CLI's two configurations at full size: from
    one f64 start, 10 steps of K8 and of the plain path at f64 (<= 1e-11),
    in f32 and (configs 2 and 3) in bf16 storage (within SC_BOUNDS, and the
    kernel no further from the f64 plain run than max(1.5x the plain path,
    the bound)); one more bf16 step of each from a common bf16 state, value
    by value within one bf16 ulp."""
    from openlbmpm_torch.kernels.csf import compare_bf16_states
    from openlbmpm_torch.kernels.shanchen import sc_step, sc_step_reference
    res = {}
    for name, storages in SC_CHECKED.items():
        m64, s64 = sc_config(name, device, dtype=torch.float64, n=n)
        ref = _steps(lambda x: sc_step_reference(x, m64), s64, steps)
        r = {"f64": float((_steps(lambda x: sc_step(x, m64), s64, steps) -
                           ref).abs().max())}
        check(r["f64"] <= 1e-11, f"sc {name} f64 kernel vs plain "
              f"{r['f64']:.3e} > 1e-11")
        fluid = m64.fluid_mask > 0
        for st in storages:
            m = sc_config(name, device, storage=st, n=n)[0]
            s0 = s64.float() if st == "f32" else m.pack_state_bf16(s64.float())
            a = _steps(lambda x: sc_step(x, m), s0, steps)
            b = _steps(lambda x: sc_step_reference(x, m), s0, steps)
            if st == "bf16":
                one = [compare_bf16_states(x, y, fluid) for x, y in
                       zip(sc_step(b, m), sc_step_reference(b, m))]
                r["ulp"] = max(o["excess"] for o in one)
                r["share"] = max(o["share"] for o in one)
                check(r["ulp"] <= 1.0 and r["share"] <= 1e-2,
                      f"sc {name} bf16 one step: a value {r['ulp']:.3g} ulp "
                      f"off the plain path, {r['share']:.2e} of them off")
                a, b = m.unpack_bf16(a), m.unpack_bf16(b)
            check(bool(torch.isfinite(a).all()), f"sc {name} {st}: not finite")
            gap = float((a - b).abs().max())
            acc_k = float((a.double() - ref).abs().max())
            acc_p = float((b.double() - ref).abs().max())
            bound = SC_BOUNDS[st]
            check(gap <= bound, f"sc {name} {st}: kernel vs plain {gap:.3e} > "
                  f"{bound:g}")
            check(acc_k <= max(1.5 * acc_p, bound), f"sc {name} {st}: kernel "
                  f"{acc_k:.3e} from f64, the plain path {acc_p:.3e}")
            r[st] = (gap, acc_k, acc_p)
        res[name] = r
    return res


def phase_sc_physics(device, n=FLAGSHIP_N, n_angle=256, mass_steps=600,
                     equil_steps=50000):
    """bench_all.py's physics checks on K8 (f32): config 3 after 600 steps,
    per-fluid mass drift < 2e-5, both phases kept (max rho_k > 0.9) and
    u_max < 0.05; config 2's droplet on a 256^2 domain (radius 50) after
    `equil_steps` steps, then two windows of five samples 2000 steps apart:
    the window means of the spherical-cap angle agree within 2 degrees and
    lie within 12 degrees of the Huang analytic angle."""
    from openlbmpm_torch.kernels.shanchen import sc_step
    from openlbmpm_torch.metrics import (analytic_sc_contact_angle,
                                         measured_contact_angle)
    res = {}
    m, f = sc_config("config3", device, n=n)
    m0 = f.double().sum((1, 2, 3))
    before = sc_step.launches
    f = _steps(m.step, f, mass_steps)
    rho_k, (ux, uy) = m.macro(f)
    res["drift"] = float((f.double().sum((1, 2, 3)) / m0 - 1.0).abs().max())
    res["umax"] = float(torch.sqrt(ux * ux + uy * uy).max())
    res["rho_max"] = min(float(rho_k[0].max()), float(rho_k[1].max()))
    res["steps"] = mass_steps
    check(sc_step.launches - before == mass_steps, "config 3 off the kernel")
    check(res["drift"] < 2e-5, f"config 3 mass drift {res['drift']:.2e}")
    check(res["umax"] < 0.05, f"config 3 spurious currents {res['umax']:.3f}")
    check(res["rho_max"] > 0.9, "config 3 phases collapsed")

    m, f = sc_config("config2", device, n=n_angle)
    f = m.init_state_droplet((1.0, 1.0), (0.02, 0.02),
                             center=(2.0, n_angle / 2), radius=50.0)
    t0 = time.perf_counter()
    f = _steps(m.step, f, equil_steps)

    def window(f):
        thetas = []
        for _ in range(5):
            f = _steps(m.step, f, 2000)
            rho0 = m.macro(f)[0][0].cpu().numpy()
            thetas.append(measured_contact_angle(rho0 > 0.5, wall_row=2))
        return float(np.mean(thetas)), f, rho0

    theta_a, f, _ = window(f)
    theta, f, rho0 = window(f)
    res["angle_sec"] = time.perf_counter() - t0
    drop = rho0 > 0.5
    rho_main = float(rho0[drop].mean())
    rho_diss = float(rho0[~drop & m.geo.is_fluid].mean())
    res["theta"] = (theta_a, theta)
    res["theta_pred"] = analytic_sc_contact_angle(-0.4, 0.4, 3.8, rho_main,
                                                  rho_diss)
    check(bool(torch.isfinite(f).all()), "config 2 angle run not finite")
    check(abs(theta - theta_a) < 2.0,
          f"angle not equilibrated: {theta_a:.1f} -> {theta:.1f}")
    check(abs(theta - res["theta_pred"]) < 12.0,
          f"angle {theta:.1f} vs analytic {res['theta_pred']:.1f}")
    return res


def _sc_ini(root, tmp, n, efs):
    """configs/twophasesetup.ini set to an n x n domain (EFS selected when
    `efs`), written to `tmp`; returns (its path, the physics INI)."""
    import os
    path = os.path.join(tmp, "efs.ini" if efs else "sc.ini")
    _ini_copy(os.path.join(root, "configs", "twophasesetup.ini"), path,
              {"xGrid": n, "yGrid": n} | (
                  {"InteractionType": "'EFS'"} if efs else {}))
    return path, os.path.join(root, "configs",
                              "efs2D.ini" if efs else "shanchen2D.ini")


def phase_sc_cli(device, n=FLAGSHIP_N, steps=1000):
    """``run --model sc`` through ``openlbmpm_torch.cli.main`` at n x n,
    with shanchen2D.ini (SC, Zou-He velocity inlet, convective outlet) and
    as EFS with efs2D.ini (Zou-He pressure outlet), `steps` f32 steps each:
    K8 launched exactly `steps` times, the final checkpoint finite."""
    import contextlib
    import io
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.kernels.shanchen import kernel_launches, sc_step
    root = os.path.dirname(os.path.abspath(__file__))
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for scheme in ("sc", "efs"):
            ini, phys = _sc_ini(root, tmp, n, scheme == "efs")
            out = os.path.join(tmp, scheme)
            sc_step.launches = 0
            before = kernel_launches("sc2d_f32")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as text:
                rc = cli.main(["run", ini, "--model", "sc", "--physics-config",
                               phys, "--steps", str(steps), "--output", out,
                               "--device", "cuda", "--block", "1"])
            sec = time.perf_counter() - t0
            launches = sc_step.launches
            per = per_step(before, kernel_launches("sc2d_f32"), steps)
            check(all(v == (k in sc_want_kernels("f32", True))
                      for k, v in per.items()),
                  f"cli {scheme}: kernel launches a step {per}")
            check(rc == 0, f"cli run --model sc ({scheme}) returned {rc}")
            check("the kernel step on cuda" in text.getvalue(),
                  f"cli {scheme}: {text.getvalue().splitlines()[:1]}")
            check(launches == steps, f"cli {scheme}: K8 launched {launches} "
                  f"times, want {steps}")
            with np.load(os.path.join(out, "checkpoint.npz")) as z:
                f, step = z["leaf0"], int(z["__step__"])
            check(step == steps and f.shape == (2, 9, n, n) and
                  bool(np.isfinite(f).all()),
                  f"cli {scheme}: checkpoint at step {step} {f.shape}")
            res[scheme] = {"launches": launches, "sec": sec, "steps": steps,
                           "per_step": per,
                           "mlups": _mlups(os.path.join(out, "metrics.jsonl"))}
    return res


# K8's kernels: f32 / f64 the push and the outlet rows, bf16 the pull
SC_KERNELS = ("sc_push_kernel", "sc_outlet_kernel", "collide_stream_kernel")
# least bytes of K8's function per cell-step, K = 2: the state (72 B f32,
# 44 B bf16) read and written once, plus the solid mask at one byte (the
# kernel's geometry planes, 3 for SC and 5 for EFS in the compute type, all
# follow from the mask)
SC_BYTES = {"f32": 2 * 72 + 1, "bf16": 2 * 44 + 1}


def phase_sc_speed(device, n=FLAGSHIP_N, kernel_steps=500, plain_steps=20):
    """MLUPS of K8 and of the plain path at 1024^2 (config 2: SC, config 3:
    EFS iso-8 MRT; f32 and bf16 storage, in turns), device microseconds per
    launch from torch.profiler, each kernel's launches a step by the
    library's count over 10 steps (sc_want_kernels once, the others
    never), and the roofline share of the design bytes."""
    from openlbmpm_torch.kernels.shanchen import (kernel_launches,
                                                  launch_sc2d, sc_step,
                                                  sc_step_reference)
    res = {}
    for name in ("config2", "config3"):
        pairs = {st: sc_config(name, device, storage=st, n=n)
                 for st in ("f32", "bf16")}
        models = {st: m for st, (m, _) in pairs.items()}
        states = {"f32": pairs["f32"][1],
                  "bf16": models["bf16"].pack_state_bf16(pairs["f32"][1])}
        sec = time_paths(models, states, sc_step, sc_step_reference,
                         kernel_steps, plain_steps, device)
        profile, launches = {}, {}
        for st, m in models.items():
            want = sc_want_kernels(st, False)
            times = device_times(
                lambda s, m=m: launch_sc2d(s, m.kernel_params, m.geo_planes),
                states[st], want)
            profile.update({(st, k): v for k, v in times.items()})
            lib = f"sc2d_{st}"
            x, before = states[st], kernel_launches(lib)
            for _ in range(10):
                x = sc_step(x, m)
            torch.cuda.synchronize()
            launches[st] = per_step(before, kernel_launches(lib), 10)
            check(all(v == (k in want) for k, v in launches[st].items()),
                  f"K8 {name} {st}: launches a step {launches[st]}")
        res[name] = {"sec": sec, "profile": profile, "launches": launches,
                     "roof": {st: SC_BYTES[st] * n * n / HBM_BYTES_PER_S
                              / sec[("kernel", st)] for st in models}}
    return res


def phase15_19_lines(r15, r16, r17, phys, cli, r19, card, n=FLAGSHIP_N):
    def count(per):
        return ", ".join(f"{k} {v:g}" for k, v in per.items() if v)
    lines = [
        "phase 15 K8 f64 vs plain, 128x64, 20 steps: max |diff| " + ", ".join(
            f"{k} {v:.3e}" for k, v in r15.items()) + " (<= 1e-11); the "
        "guo/edm/Chang/convective_true/moving-wall cases took the plain "
        "step on the card; kernel launches a step (sc2d_f64's count): " +
        "; ".join(f"{k} {count(v)}" for k, v in SC_STEP_LAUNCHES.items()),
        f"phase 16 tests/golden/sc_mini.npz through K8, f64, 50 steps: max "
        f"|diff| {r16:.3e} (<= 1e-10)"]
    for name, r in r17.items():
        txt = (f"phase 17 {name} {n}^2, 10 steps [{card}]: f64 {r['f64']:.3e} "
               f"(<= 1e-11); " + "; ".join(
                   f"{st} kernel vs plain {r[st][0]:.3e} (<= "
                   f"{SC_BOUNDS[st]:g}), from f64 kernel {r[st][1]:.3e} vs "
                   f"plain {r[st][2]:.3e}" for st in SC_CHECKED[name]))
        if "ulp" in r:
            txt += (f"; bf16 one more step: largest gap {r['ulp']:.3g} ulp "
                    f"(<= 1), {r['share']:.3e} of values >= 1e-4 differ "
                    f"(<= 1e-2)")
        lines.append(txt)
    p = phys
    lines.append(
        f"phase 17 physics on K8, f32 [{card}]: config 3 {p['steps']} steps "
        f"mass drift {p['drift']:.3e} (< 2e-5), u_max {p['umax']:.5f} "
        f"(< 0.05), min max rho_k {p['rho_max']:.3f}; config 2 256^2 angle "
        f"windows {p['theta'][0]:.2f} -> {p['theta'][1]:.2f} deg (< 2), "
        f"analytic {p['theta_pred']:.2f} (< 12), {p['angle_sec']:.1f} s")
    for scheme, r in cli.items():
        lines.append(
            f"phase 18 cli run --model sc ({scheme.upper()}), {n}x{n}, "
            f"{r['steps']} f32 steps: {r['launches']} K8 launches (a step: "
            f"{count(r['per_step'])}), {r['sec']:.2f} s with I/O, "
            f"metrics.jsonl MLUPS {r['mlups']} [{card}]")
    for name, r in r19.items():
        mlups = {k: n * n / v / 1e6 for k, v in r["sec"].items()}
        lines.append(
            f"phase 19 K8 {name} {n}^2 [{card}]: MLUPS kernel f32 "
            f"{mlups[('kernel', 'f32')]:.1f} "
            f"({r['sec'][('kernel', 'f32')] * 1e3:.4f} ms), kernel bf16 "
            f"{mlups[('kernel', 'bf16')]:.1f} "
            f"({r['sec'][('kernel', 'bf16')] * 1e3:.4f} ms), plain f32 "
            f"{mlups[('plain', 'f32')]:.1f} "
            f"({r['sec'][('plain', 'f32')] * 1e3:.3f} ms), plain bf16 "
            f"{mlups[('plain', 'bf16')]:.1f}; roofline share of "
            f"{SC_BYTES['f32']} / {SC_BYTES['bf16']} B at 3.35 "
            f"TB/s f32 {r['roof']['f32']:.3f}, bf16 {r['roof']['bf16']:.3f}; "
            "device us per launch (launches per step): " + ", ".join(
                f"{k} {st} " + ("not measured" if v is None else
                                f"{v[0]:.2f} ({v[1]:g})")
                for (st, k), v in r["profile"].items()) +
            "; launches a step by the library's count: " + "; ".join(
                f"{st} {count(v)}" for st, v in r["launches"].items()))
    return lines


# -- the D3Q19 CSF step: K9 ------------------------------------------------

_CG3D = dict(surface_tension=0.01, tau_r=1.0, tau_b=0.8,
             contact_angle_deg=60.0)
_VCONV = dict(inlet="velocity", outlet="convective", inlet_velocity=-1e-3)
# configuration 5 (BASELINE.json), benchmarks/bench_cg3d.py:67-71: an
# imaged grain pack, velocity inlet, convective outlet
CONFIG5 = (dict(tau_r=1.0, tau_b=1.0, surface_tension=0.05,
                contact_angle_deg=45.0, beta=0.7, tau_type=2),
           dict(inlet="velocity", outlet="convective", inlet_velocity=-2e-3))
# name -> (ColorGradientParams3D fields, CG3DBoundaryConfig fields,
# geometry, initial state).  Phase 20 and tests/test_torch_*.py use it.
CG3D_CASES = {
    "periodic_droplet": (_CG3D, {}, "open", "droplet"),
    "akai60_walls": (_CG3D, {}, "walls", "layers"),
    "velocity_convective": (_CG3D, _VCONV, "walls", "layers"),
    "velocity_dirichlet": (_CG3D, dict(inlet="velocity", outlet="dirichlet",
                                       inlet_velocity=-1e-3,
                                       outlet_density=1.0), "walls", "layers"),
    "body_force": (_CG3D | dict(body_force=(1e-5, 0.0, -2e-5)), {}, "walls",
                   "droplet"),
    "tau_type1": (_CG3D | dict(tau_type=1), _VCONV, "walls", "layers"),
    "grain_pack": CONFIG5 + ("grains", "layers"),
}


def pore_grains(n, n_grains=60, seed=7):
    """The (n, n) solid cross-section of benchmarks/bench_cg3d.py: its
    make_pore_png grain loop, then what load_structure_image reads back
    from that PNG (the solid pixels, cropped to their bounding box) and
    run_bench's pad back to n x n.  numpy only: the card has no PNG
    writer."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    solid = np.zeros((n, n), bool)
    for _ in range(n_grains):
        cy, cx = rng.randint(0, n, 2)
        r = rng.randint(n // 24, n // 10)
        solid |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    band = slice(n // 2 - n // 10, n // 2 + n // 10)
    solid[:, band] &= rng.rand(n, band.stop - band.start) > 0.6
    ys, xs = np.nonzero(solid)
    solid = solid[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    solid = np.pad(solid, ((0, max(n - solid.shape[0], 0)),
                           (0, max(n - solid.shape[1], 0))))
    return solid[:n, :n]


def grain_pack(n):
    """Configuration 5's (n, n, n) geometry: the grain pack extruded along z
    with 8 open buffer slabs at each face, walls on the x and y faces."""
    from openlbmpm_torch.geometry import extrude_image_3d
    return extrude_image_3d(pore_grains(n), n, buffer_slabs=8)


def cg3d_solid(kind, shape):
    if kind == "grains":
        return grain_pack(shape[0])
    solid = np.zeros(shape, bool)
    if kind == "walls":
        solid[:, 0, :] = solid[:, -1, :] = True
    return solid


def cg3d_case(name, device, shape=(48, 40, 32), dtype=torch.float64,
              storage="f32"):
    """The port's ColorGradientRK3D of case `name` on an (nz, ny, nx)
    domain (the grain pack: (nz,)*3) and its split initial state."""
    from openlbmpm_torch.geometry import from_solid_mask
    from openlbmpm_torch.models.flow3d import (
        CG3DBoundaryConfig, ColorGradientParams3D, ColorGradientRK3D)
    p, b, kind, init = CG3D_CASES[name]
    if kind == "grains":
        shape = (shape[0],) * 3
    m = ColorGradientRK3D(from_solid_mask(cg3d_solid(kind, shape)),
                          ColorGradientParams3D(**p), CG3DBoundaryConfig(**b),
                          dtype=dtype, device=device, storage=storage)
    if init == "droplet":
        return m, m.init_state_droplet(1.0, 1.0, radius=min(shape) / 4)
    return m, m.init_state_layers(1.0, 1.0, invading_slabs=shape[0] // 4)


_CONFIG5_MODELS = {}


def config5_model(device, storage="f32", dtype=torch.float32, n=128):
    """Configuration 5 at n^3 (bench_cg3d.run_bench's model).  A model holds
    no state, so phases 21, 22 and 24 share one per (device, storage,
    dtype, n)."""
    from openlbmpm_torch.geometry import from_solid_mask
    from openlbmpm_torch.models.flow3d import (
        CG3DBoundaryConfig, ColorGradientParams3D, ColorGradientRK3D)
    key = (str(device), storage, dtype, n)
    if key not in _CONFIG5_MODELS:
        _CONFIG5_MODELS[key] = ColorGradientRK3D(
            from_solid_mask(grain_pack(n)),
            ColorGradientParams3D(**CONFIG5[0]),
            CG3DBoundaryConfig(**CONFIG5[1]), dtype=dtype, device=device,
            storage=storage)
    return _CONFIG5_MODELS[key]


def config5_start(m):
    """bench_cg3d's initial state: red in the top 16 of 128 slabs."""
    return m.init_state_layers(1.0, 1.0, invading_slabs=m.geo.shape[0] // 8)


def _dilate_yx(mask, r):
    """Cells within r of `mask` in (y, x), slab by slab."""
    x = mask.float()[:, None]
    return torch.nn.functional.max_pool2d(x, 2 * r + 1, stride=1,
                                          padding=r)[:, 0] > 0


def cg3d_masks(m, steps, device):
    """(away, far) cell masks of a K9 comparison after `steps` steps.  away:
    off the seam slabs 0-2 and nz-2, nz-1 (the periodic z seam where the red
    inlet slabs meet the blue outlet slabs is an interface) and off their
    wall edges (cells within steps + 2 slabs of them and steps + 2 cells of
    a solid cell in (y, x)); far: away and also steps + 2 cells from every
    solid cell, off the contact lines (rounding noise spreads about a cell
    a step)."""
    nz = m.geo.shape[0]
    c = steps + 2
    solid = torch.as_tensor(m.geo.is_solid, device=device)
    seam = torch.zeros_like(solid)
    seam[:3] = seam[nz - 2:] = True
    near_seam = torch.zeros_like(solid)
    near_seam[:3 + c] = near_seam[nz - 2 - c:] = True
    near_wall = _dilate_yx(solid, c)
    away = ~seam & ~(near_seam & near_wall)
    return away, away & ~near_wall


def _twin(x, seed=0):
    """x with each value moved by -1, 0 or +1 ulp at random (a rounding-level
    change of the input; float32 / float64)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = torch.randint(-1, 2, x.shape, generator=g).to(x.device, x.dtype)
    return x * (1 + r * torch.finfo(x.dtype).eps / 2)


def _run(fn, x, m, steps):
    for _ in range(steps):
        x = fn(x, m)
    return x


def _split_gap(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def phase_cg3d_f64(device, shape=(48, 40, 32), grain=32, steps=20,
                   tol=1e-11):
    """K9c (compressed) and K9s (split) against their plain versions at f64
    in every case of CG3D_CASES, `steps` steps; then K9h one step from a
    common bf16 state.  The grain pack is held to max(tol, 2x the plain
    path's own gap when its input moves by one ulp): its periodic z seam,
    where |g| = 1 meets noise gradients near the 1e-8 normal threshold,
    amplifies rounding (ROADMAP section 3)."""
    from openlbmpm_torch.kernels.cg3d import (
        cg3d_fields, cg3d_fields_reference,
        cg3d_step_compressed as kc, cg3d_step_compressed_reference as pc,
        cg3d_step_split as ks, cg3d_step_split_reference as ps)
    res = {"fields": 0.0}
    for name in CG3D_CASES:
        m, st = cg3d_case(name, device, shape=(grain,) * 3
                          if name == "grain_pack" else shape)
        s = m.pack_state(*st)
        for x in (s, st):
            gf = float((cg3d_fields(x, m) -
                        cg3d_fields_reference(x, m)).abs().max())
            check(gf <= 1e-12, f"K9 fields f64 {name}: {gf:.3e} > 1e-12")
            res["fields"] = max(res["fields"], gf)
        a, b, gc = s, s, 0.0
        x, y, gs = st, st, 0.0
        for _ in range(steps):
            a, b = kc(a, m), pc(b, m)
            gc = max(gc, float((a - b).abs().max()))
            x, y = ks(x, m), ps(y, m)
            gs = max(gs, _split_gap(x, y))
        check(bool(torch.isfinite(a).all()) and
              all(bool(torch.isfinite(t).all()) for t in x),
              f"K9 f64 {name}: state not finite")
        bound_c = bound_s = tol
        if name == "grain_pack":
            bound_c = max(tol, 2 * float(
                (_run(pc, _twin(s), m, steps) - b).abs().max()))
            bound_s = max(tol, 2 * _split_gap(
                _run(ps, tuple(_twin(t, 1) for t in st), m, steps), y))
        check(gc <= bound_c, f"K9c f64 {name}: {gc:.3e} > {bound_c:.3e}")
        check(gs <= bound_s, f"K9s f64 {name}: {gs:.3e} > {bound_s:.3e}")
        res[name] = (gc, gs, bound_c, bound_s)
    mh, st = cg3d_case("velocity_convective", device, shape=shape,
                       dtype=torch.float32, storage="bf16")
    h = _run(pc, mh.pack_state_bf16(*st), mh, 5)
    away = torch.ones(mh.geo.shape, dtype=torch.bool, device=device)
    away[:3] = away[shape[0] - 2:] = False
    res["bf16_ulp"] = bf16_one_step_3d(mh, h, away)
    return res


def bf16_one_step_3d(m, h, away, max_share=1e-2, kernel=None, plain=None):
    """K9h (or `kernel`, with its plain version `plain`) and its plain
    version one step from the common bf16 state `h`, held value by value
    on `away` to one bf16 ulp (``compare_bf16_states``) with at most
    `max_share` of the values >= 1e-4 off at all (measured 4e-3 to 5e-3:
    the 19-direction sums leave more values at a rounding boundary than
    D2Q9's 9); a round-toward-zero and a dropped-lo encoding of the plain
    result must fail the same check."""
    from openlbmpm_torch.kernels.cg3d import (
        cg3d_step_compressed, cg3d_step_compressed_reference)
    from openlbmpm_torch.kernels.csf import compare_bf16_states
    kernel = kernel or cg3d_step_compressed
    plain = (plain or cg3d_step_compressed_reference)(h, m)
    r = compare_bf16_states(kernel(h, m), plain, away)
    check(r["excess"] <= 1.0, f"K9h one step: a value {r['excess']:.3g} ulp "
          "off the plain path")
    check(r["share"] <= max_share, f"K9h one step: {r['share']:.2e} of the "
          f"values differ > {max_share:g}")
    x = m._physics_c(m.unpack_bf16(m._bc_slabs_c(h, m._dec_slab,
                                                 m._enc_slab)))
    w = torch.as_tensor(m.lat.w, dtype=x.dtype, device=x.device)
    hi = _bf16_rz(x[19])
    rz = torch.cat([_bf16_rz(x[:19] - w.reshape(-1, 1, 1, 1) * m.fluid_mask),
                    hi[None], _bf16_rz(x[19] - hi.float())[None]])
    no_lo = plain.clone()
    no_lo[20] = 0
    r["rz_share"] = compare_bf16_states(rz, plain, away)["share"]
    r["no_lo_excess"] = compare_bf16_states(no_lo, plain, away)["excess"]
    check(r["rz_share"] > max_share and r["no_lo_excess"] > 1.0,
          f"K9h one-step check cannot see a rounding-toward-zero "
          f"({r['rz_share']:.2e}) or dropped-lo ({r['no_lo_excess']:.3g}) "
          "encoding")
    return r


def _gaps(kern, plain, twin, ref, away, far):
    """max |kernel - plain| everywhere / on away / on far, the plain twin's
    gap (its input one ulp away) on away, and kernel / plain / twin from
    the f64 plain run."""
    d = (kern - plain).abs().amax(0)
    t = (twin - plain).abs().amax(0)
    return {"max": float(d.max()), "away": float(d[away].max()),
            "far": float(d[far].max()), "twin_away": float(t[away].max()),
            "from_f64": tuple(float((x.double() - ref).abs().max())
                              for x in (kern, plain, twin))}


# Caps on the twin term of the phase 21 bounds: twice the plain path's
# one-ulp twin gap off the seam measured at configuration 5, 128^3, 10
# steps, rounded up (readings 7.983e-4, 1.788e-7, 7.820e-5, 7.782e-4 on an
# H100; PERF.md section 2), so a fault on the contact lines cannot hide
# under a twin that a change of the plain path widened.
CONFIG5_TWIN_CAP = {"K9c f32": 1.6e-3, "K9s f32": 3.6e-7, "K9h planes": 1.6e-4,
                    "K9h rho_r": 1.6e-3}


def _hold(tag, g, bound):
    """The phase 21 bounds (phase 26's too): `bound` on the cells far from
    walls and seam; on `away` no more than `bound` or the plain path's own
    twin gap, the latter capped at TWIN_CAP[tag]; and no further from f64
    than 1.5x the plain path or its twin, or `bound`."""
    cap = TWIN_CAP[tag]
    check(g["far"] <= bound, f"{tag}: |kernel - plain| far from walls and "
          f"seam {g['far']:.3e} > {bound:g}")
    twin = min(g["twin_away"], cap)
    check(g["away"] <= max(bound, twin), f"{tag}: |kernel - plain| off the "
          f"seam {g['away']:.3e} > max({bound:g}, plain twin "
          f"{g['twin_away']:.3e} capped at {cap:g})")
    k, p, t = g["from_f64"]
    check(k <= max(bound, 1.5 * max(p, t)), f"{tag}: kernel {k:.3e} from "
          f"f64, plain {p:.3e}, twin {t:.3e}")


def phase_config5(device, n=128, steps=10):
    """Configuration 5 at n^3, `steps` steps of kernel and plain path from
    one f64 start: f64 (K9c, K9s <= 1e-11), f32 (K9c, K9s) and bf16
    storage (K9h), held by ``_hold`` against the plain path, its one-ulp
    twin and the f64 run; total rho_r kernel vs plain <= 1e-4."""
    from openlbmpm_torch.kernels.cg3d import (
        cg3d_step_compressed as kc, cg3d_step_compressed_reference as pc,
        cg3d_step_split as ks, cg3d_step_split_reference as ps)
    m64 = config5_model(device, dtype=torch.float64, n=n)
    st64 = config5_start(m64)
    s64 = m64.pack_state(*st64)
    p64, sp64 = _run(pc, s64, m64, steps), _run(ps, st64, m64, steps)
    res = {"f64": (float((_run(kc, s64, m64, steps) - p64).abs().max()),
                   _split_gap(_run(ks, st64, m64, steps), sp64))}
    check(max(res["f64"]) <= 1e-11, f"config 5 f64 kernel vs plain "
          f"{res['f64']}")
    m32 = config5_model(device, n=n)
    away, far = cg3d_masks(m32, steps, device)
    s32 = s64.float()
    kern, plain = _run(kc, s32, m32, steps), _run(pc, s32, m32, steps)
    res["f32"] = _gaps(kern, plain, _run(pc, _twin(s32), m32, steps), p64,
                       away, far)
    _hold("K9c f32", res["f32"], 3e-5)
    st32 = tuple(t.float() for t in st64)
    res["split"] = _gaps(*(torch.cat(x) for x in (
        _run(ks, st32, m32, steps), _run(ps, st32, m32, steps),
        _run(ps, tuple(_twin(t, 1) for t in st32), m32, steps))),
        torch.cat(sp64), away, far)
    _hold("K9s f32", res["split"], 3e-5)
    mh = config5_model(device, storage="bf16", n=n)
    h = mh.pack_compressed_bf16(s32)
    kh, ph = _run(kc, h, mh, steps), _run(pc, h, mh, steps)
    k, p, t = (mh.unpack_bf16(x) for x in (
        kh, ph, _run(pc, mh.pack_compressed_bf16(_twin(s32)), mh, steps)))
    res["bf16"] = {"planes": _gaps(k[:19], p[:19], t[:19], p64[:19], away,
                                   far),
                   "rho_r": _gaps(k[19:], p[19:], t[19:], p64[19:], away,
                                  far),
                   "max": float((k - p).abs().max())}
    _hold("K9h planes", res["bf16"]["planes"], 3e-4)
    _hold("K9h rho_r", res["bf16"]["rho_r"], 1e-4)
    for x, y, tag in ((kern, plain, "f32"), (k, p, "bf16")):
        tot_k, tot_p = float(x[19].double().sum()), float(y[19].double().sum())
        res[f"mass_{tag}"] = abs(tot_k - tot_p) / tot_p
        check(res[f"mass_{tag}"] <= 1e-4, f"config 5 {tag}: total rho_r "
              f"kernel vs plain {res[f'mass_{tag}']:.2e}")
    res["ulp"] = bf16_one_step_3d(mh, ph, away)
    return res


def _front(m, s):
    """The lowest slab the red phase (rho_r > 0.5) has reached
    (bench_cg3d's front)."""
    rho_r = m.unpack_bf16(s)[19] if s.dtype == torch.bfloat16 else s[19]
    occ = torch.nonzero((rho_r > 0.5).any(dim=2).any(dim=1))
    return int(occ.min()) if len(occ) else m.geo.shape[0]


def phase_cg3d_main(device, n=128, physics_steps=4000, bf16_steps=500,
                    split_steps=200):
    """bench_cg3d.py's physics on K9c (f32, n^3): porosity in (0.2, 0.9),
    then 120 steps, then ``run_chunked(model.step_c)`` for `physics_steps`
    with the NaN guard: the front advances >= 0.4 x the ballistic 2e-3 x
    `physics_steps` slabs, the state stays finite.  Then the main paths of
    K9h (``run_chunked(step_c)`` on the bf16 state) and K9s
    (``run_chunked(step)`` on (f_r, f_b)), each with its launches counted."""
    from openlbmpm_torch.kernels.cg3d import (cg3d_step_compressed,
                                              cg3d_step_split)
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    m = config5_model(device, n=n)
    res = {"porosity": m.geo.porosity}
    check(0.2 < res["porosity"] < 0.9, f"porosity {res['porosity']:.3f}")
    st = config5_start(m)
    s = m.pack_state(*st)
    for _ in range(120):
        s = m.step_c(s)
    front0 = _front(m, s)
    cg3d_step_compressed.launches = 0
    s = run_chunked(m.step_c, s, num_steps=physics_steps, io_interval=1000,
                    nan_guard=True)
    res["launches_f32"] = cg3d_step_compressed.launches
    res["advance"] = front0 - _front(m, s)
    expected = 2e-3 * physics_steps
    check(res["launches_f32"] == physics_steps, f"K9c launched "
          f"{res['launches_f32']} times, want {physics_steps}")
    check(res["advance"] >= 0.4 * expected, f"front advanced "
          f"{res['advance']} slabs in {physics_steps} steps (expected "
          f"~{expected:.0f})")
    check(bool(torch.isfinite(s).all()), "config 5 state not finite")
    mh = config5_model(device, storage="bf16", n=n)
    meter = RunMetrics(n ** 3)
    cg3d_step_compressed.launches = 0
    h = run_chunked(mh.step_c, mh.pack_state_bf16(*st), num_steps=bf16_steps,
                    io_interval=250, metrics=meter, nan_guard=True)
    res["launches_bf16"] = cg3d_step_compressed.launches
    res["run_mlups_bf16"] = meter.mlups
    check(res["launches_bf16"] == bf16_steps and h.dtype == torch.bfloat16
          and tuple(h.shape) == (21, n, n, n), f"K9h main path: "
          f"{res['launches_bf16']} launches, state {tuple(h.shape)}")
    meter = RunMetrics(n ** 3)
    cg3d_step_split.launches = 0
    f = run_chunked(m.step, st, num_steps=split_steps, io_interval=100,
                    metrics=meter, nan_guard=True)
    res["launches_split"] = cg3d_step_split.launches
    res["run_mlups_split"] = meter.mlups
    check(res["launches_split"] == split_steps and len(f) == 2,
          f"K9s main path: {res['launches_split']} launches")
    return res


def phase_cg3d_cli(device, steps=1000):
    """``run --model cg3d`` on configs/rk_csf3d.ini (32x32x96, its 1000
    steps, f32) through ``openlbmpm_torch.cli.main``: the packed state on
    K9c, launched exactly `steps` times, the final checkpoint finite."""
    import contextlib
    import io
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.kernels.cg3d import cg3d_step_compressed
    ini = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                       "rk_csf3d.ini")
    with tempfile.TemporaryDirectory() as tmp:
        cg3d_step_compressed.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = cli.main(["run", ini, "--model", "cg3d", "--steps",
                           str(steps), "--output", tmp, "--device", "cuda"])
        sec = time.perf_counter() - t0
        launches = cg3d_step_compressed.launches
        check(rc == 0, f"cli run --model cg3d returned {rc}")
        check("the kernel step on cuda, packed state" in text.getvalue(),
              f"cli cg3d: {text.getvalue().splitlines()[:1]}")
        check(launches == steps, f"cli cg3d: K9c launched {launches} times, "
              f"want {steps}")
        with np.load(os.path.join(tmp, "checkpoint.npz")) as z:
            s, step = z["leaf0"], int(z["__step__"])
        check(step == steps and s.shape == (20, 96, 32, 32) and
              bool(np.isfinite(s).all()),
              f"cli cg3d: checkpoint at step {step} {s.shape}")
        return {"launches": launches, "sec": sec, "steps": steps,
                "mlups": _mlups(os.path.join(tmp, "metrics.jsonl"))}


CG3D_KERNELS = ("bc_kernel", "fields_kernel", "collide_stream_kernel")
# least bytes per cell-step of K9's function: the state in and out plus a
# 1-byte solid mask (every geo_stack3 plane follows from it): compressed
# f32 2 x 80 + 1, bf16 2 x 42 + 1, split f32 2 x 152 + 1
CG3D_BYTES = {"f32": 2 * 80 + 1, "bf16": 2 * 42 + 1, "split": 2 * 152 + 1}
CG3D_FLOPS = CG3D_OPS   # least operations per cell-step (F32_FLOPS_PER_S)


def phase_cg3d_speed(device, sizes=(128, 256), steps=(50, 20),
                     plain_steps=3):
    """MLUPS of K9c (f32), K9h (bf16) and K9s (split f32) at each size and of
    the plain f32 path at the first, in turns (plain, kernels, kernels,
    plain), each kernel's device microseconds per launch from
    torch.profiler, and the roofline share of CG3D_BYTES."""
    from openlbmpm_torch.kernels.cg3d import (
        cg3d_step_compressed as kc, cg3d_step_compressed_reference as pc,
        cg3d_step_split as ks, cg3d_step_split_reference as ps,
        kernel_launches, launch_cg3d, launch_cg3d_split)
    res = {}
    for n, k_steps in zip(sizes, steps):
        m = config5_model(device, n=n)
        mh = config5_model(device, storage="bf16", n=n)
        st = config5_start(m)
        s = m.pack_state(*st)
        runs = {"f32": (lambda x: kc(x, m), s),
                "bf16": (lambda x: kc(x, mh), mh.pack_state_bf16(*st)),
                "split": (lambda x: ks(x, m), st)}
        order = list(runs)
        if n == sizes[0]:
            runs |= {"plain": (lambda x: pc(x, m), s),
                     "plain_bf16": (lambda x: pc(x, mh), runs["bf16"][1]),
                     "plain_split": (lambda x: ps(x, m), st)}
            order = ["plain", "plain_bf16", "plain_split"] + order
        sec = {}
        for key in order + order[::-1]:
            fn, x = runs[key]
            t = _time_steps(fn, x, plain_steps if key.startswith("plain")
                            else k_steps, device)
            sec[key] = min(sec.get(key, float("inf")), t)
        profile, launches = {}, {}
        for key, lib, fn in (
                ("f32", "cg3d_f32", lambda x: launch_cg3d(
                    x, m.kernel_params, m.geo_planes)),
                ("bf16", "cg3d_bf16", lambda x: launch_cg3d(
                    x, mh.kernel_params, mh.geo_planes)),
                ("split", "cg3d_f32", lambda x: launch_cg3d_split(
                    *x, m.kernel_params, m.geo_planes))):
            times = device_times(fn, runs[key][1], CG3D_KERNELS, steps=20)
            check(all(v is not None for v in times.values()),
                  f"K9 {key} {n}^3: a kernel shows no device time")
            profile.update({(key, k): v for k, v in times.items()})
            # configuration 5 has an inlet and an outlet: each of the three
            # kernels runs once a step, as the library counts its launches
            # (the profiler's trace misses some)
            x, before = runs[key][1], kernel_launches(lib)
            for _ in range(10):
                x = fn(x)
            torch.cuda.synchronize()
            after = kernel_launches(lib)
            launches[key] = {k: (after[k] - before[k]) / 10
                             for k in CG3D_KERNELS}
            check(all(v == 1 for v in launches[key].values()),
                  f"K9 {key} {n}^3: launches a step " + ", ".join(
                      f"{k} {v:g}" for k, v in launches[key].items()))
        res[n] = {"sec": sec, "profile": profile, "launches": launches,
                  "mlups": {
            key: n ** 3 / t / 1e6 for key, t in sec.items()},
            "roof": {key: CG3D_BYTES[key] * n ** 3 / HBM_BYTES_PER_S
                     / sec[key] for key in CG3D_BYTES}}
    return res


def phase20_24_lines(r20, r21, r22, r23, r24, card):
    lines = ["phase 20 K9 f64 vs plain, 48x40x32 (grain pack 32^3), 20 "
             "steps: max |diff| compressed / split " + ", ".join(
                 f"{k} {v[0]:.3e} / {v[1]:.3e}" for k, v in r20.items()
                 if k not in ("bf16_ulp", "fields")) + " (<= 1e-11; grain "
             "pack <= "
             f"{r20['grain_pack'][2]:.3e} / {r20['grain_pack'][3]:.3e}); "
             f"fields_kernel vs cg3d_fields_reference {r20['fields']:.3e} "
             "(<= 1e-12); "
             f"K9h one step: {r20['bf16_ulp']['excess']:g} ulp, share "
             f"{r20['bf16_ulp']['share']:.2e}, hi flips "
             f"{r20['bf16_ulp']['hi_flips']} (round-toward-zero share "
             f"{r20['bf16_ulp']['rz_share']:.2e}, dropped lo "
             f"{r20['bf16_ulp']['no_lo_excess']:.3g} ulp)"]

    def g(x):
        k, p, t = x["from_f64"]
        return (f"max {x['max']:.3e}, off seam {x['away']:.3e} (plain twin "
                f"{x['twin_away']:.3e}), far {x['far']:.3e}; from f64 kernel "
                f"{k:.3e}, plain {p:.3e}, twin {t:.3e}")
    u = r21["ulp"]
    lines.append(
        f"phase 21 config 5 128^3, 10 steps [{card}]: f64 K9c "
        f"{r21['f64'][0]:.3e}, K9s {r21['f64'][1]:.3e}; K9c f32 "
        f"{g(r21['f32'])}; K9s f32 {g(r21['split'])}; K9h planes "
        f"{g(r21['bf16']['planes'])}; K9h rho_r {g(r21['bf16']['rho_r'])}; "
        f"total rho_r kernel vs plain f32 {r21['mass_f32']:.2e}, bf16 "
        f"{r21['mass_bf16']:.2e}; K9h one step {u['excess']:g} ulp, share "
        f"{u['share']:.2e} (rz {u['rz_share']:.2e}, no lo "
        f"{u['no_lo_excess']:.3g})")
    lines.append(
        f"phase 22 physics on K9c f32 128^3 [{card}]: porosity "
        f"{r22['porosity']:.4f}, front advanced {r22['advance']} slabs in "
        f"4000 steps (>= 3.2), {r22['launches_f32']} launches; main paths: "
        f"K9h run_chunked {r22['launches_bf16']} launches, "
        f"{r22['run_mlups_bf16']:.1f} MLUPS; K9s run_chunked "
        f"{r22['launches_split']} launches, {r22['run_mlups_split']:.1f} "
        "MLUPS")
    lines.append(
        f"phase 23 cli run --model cg3d, rk_csf3d.ini 32x32x96, "
        f"{r23['steps']} f32 steps [{card}]: {r23['launches']} K9c launches, "
        f"{r23['sec']:.2f} s, metrics.jsonl MLUPS {r23['mlups']}")
    for n, r in r24.items():
        sec, mlups = r["sec"], r["mlups"]
        lines.append(
            f"phase 24 K9 {n}^3 [{card}]: MLUPS " + ", ".join(
                f"{k} {mlups[k]:.1f} ({sec[k] * 1e3:.4f} ms)" for k in sec) +
            "; bound ms " + ", ".join(
                f"{k} {CG3D_BYTES[k] * n ** 3 / HBM_BYTES_PER_S * 1e3:.4f}"
                for k in CG3D_BYTES) + "; roofline share " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["roof"].items()) +
            "; device us per launch (launches per step, the libraries' "
            "counts): " + ", ".join(
                f"{k} {key} " + ("not measured" if v is None else
                                 f"{v[0]:.2f}") +
                f" ({r['launches'][key][k]:g})"
                for (key, k), v in r["profile"].items()))
    return lines


# -- the coupled D3Q19 CSF + D3Q7 tracer step: K9t ----------------------------

_TRACER3D = dict(num_tracers=1, tau=(1.0,), j0=(0.25,),
                 interface_mode="bounceback")
# name -> (ColorGradientParams3D fields, CG3DBoundaryConfig fields,
# geometry, flow start as in CG3D_CASES or "half" (red in the top half),
# TransportRK3D tracer arguments, tracer start: "blue" at 1 in slabs
# [nz/10, 3nz/10), "bottom" at 1 in the bottom quarter, "random" uniform
# in [0, 1) on every cell, red and solid included).  Phase 25 and
# tests/test_torch_transport3d.py use it.
CG3D_TRANSPORT_CASES = {
    # tests/test_flow3d.py's coupled setup: an open periodic box
    "periodic_box": (dict(surface_tension=0.005), {}, "open", "half",
                     _TRACER3D, "blue"),
    # benchmarks/probe_coupled3d.py: y walls, velocity inlet, convective
    "probe": CG3D_CASES["velocity_convective"] + (_TRACER3D, "bottom"),
    "dirichlet_nt2": CG3D_CASES["velocity_dirichlet"] + (dict(
        num_tracers=2, tau=(1.0, 0.8), j0=(0.25, 0.4),
        interface_mode="bounceback"), "random"),
    # three tracers: two collide_stream launches a step in f64, whose
    # shared memory holds two a launch
    "dirichlet_nt3": CG3D_CASES["velocity_dirichlet"] + (dict(
        num_tracers=3, tau=(1.0, 0.8, 0.9), j0=(0.25, 0.4, 0.3),
        interface_mode="bounceback"), "random"),
    "interface_none": CG3D_CASES["velocity_convective"] + (
        _TRACER3D | dict(interface_mode="none"), "random"),
    "grain_pack": CG3D_CASES["grain_pack"] + (_TRACER3D, "bottom"),
}


def tracer_start(kind, nt, shape, seed=0):
    """(nt, nz, ny, nx) initial concentrations of a CG3D_TRANSPORT_CASES
    start (numpy, from `seed`)."""
    nz = shape[0]
    conc0 = np.zeros((nt,) + tuple(shape))
    if kind == "blue":
        conc0[:, nz // 10:3 * nz // 10] = 1.0
    elif kind == "bottom":
        conc0[:, :nz // 4] = 1.0
    else:
        conc0[:] = np.random.default_rng(seed).uniform(0.0, 1.0, conc0.shape)
    return conc0


def transport3d_case(name, device, shape=(48, 40, 32), dtype=torch.float64,
                     storage="f32"):
    """The port's TransportRK3D of case `name` on an (nz, ny, nx) domain
    (the grain pack: (nz,)*3) and its split state (f_r, f_b, g)."""
    from openlbmpm_torch.geometry import from_solid_mask
    from openlbmpm_torch.models.flow3d import (
        CG3DBoundaryConfig, ColorGradientParams3D, TransportRK3D)
    p, b, kind, init, tracer, start = CG3D_TRANSPORT_CASES[name]
    if kind == "grains":
        shape = (shape[0],) * 3
    m = TransportRK3D(from_solid_mask(cg3d_solid(kind, shape)),
                      ColorGradientParams3D(**p),
                      boundaries=CG3DBoundaryConfig(**b), dtype=dtype,
                      device=device, storage=storage, **tracer)
    if init == "droplet":
        fs = m.flow.init_state_droplet(1.0, 1.0, radius=min(shape) / 4)
    else:
        fs = m.flow.init_state_layers(1.0, 1.0, invading_slabs=shape[0] // (
            2 if init == "half" else 4))
    return m, m.init_state(fs, tracer_start(start, m.transport.num_tracers,
                                            shape))


def _step2(fn):
    """fn(s, g, model) as a step of the pair x = (s, g)."""
    return lambda x, m: fn(*x, m)


def _pair_gap(a, b):
    """(max |s - s'|, max |g - g'|) of two coupled states."""
    return tuple(float((x - y).abs().max()) for x, y in zip(a, b))


def phase_transport3d_f64(device, shape=(48, 40, 32), grain=32, steps=20,
                          tol=1e-11):
    """K9t against its plain version at f64 in every case of
    CG3D_TRANSPORT_CASES, `steps` steps from the packed state: flow state
    and tracer PDFs each <= tol; the grain pack <= max(tol, 2x the plain
    path's own gap when its input moves by one ulp), as in phase 20."""
    from openlbmpm_torch.kernels.cg3d import (
        coupled3d_step_compressed, coupled3d_step_compressed_reference)
    kt = _step2(coupled3d_step_compressed)
    pt = _step2(coupled3d_step_compressed_reference)
    res = {}
    for name in CG3D_TRANSPORT_CASES:
        m, st = transport3d_case(name, device, shape=(grain,) * 3
                                 if name == "grain_pack" else shape)
        x = m.pack(st)
        a, b, gap = x, x, (0.0, 0.0)
        for _ in range(steps):
            a, b = kt(a, m), pt(b, m)
            gap = tuple(map(max, gap, _pair_gap(a, b)))
        check(all(bool(torch.isfinite(t).all()) for t in a),
              f"K9t f64 {name}: state not finite")
        bound = (tol, tol)
        if name == "grain_pack":
            twin = _run(pt, (_twin(x[0]), _twin(x[1], 1)), m, steps)
            bound = tuple(max(tol, 2 * v) for v in _pair_gap(twin, b))
        check(gap[0] <= bound[0], f"K9t f64 {name}: flow {gap[0]:.3e} > "
              f"{bound[0]:.3e}")
        check(gap[1] <= bound[1], f"K9t f64 {name}: tracer {gap[1]:.3e} > "
              f"{bound[1]:.3e}")
        res[name] = gap + bound
    return res


_PROBE3D_MODELS = {}


def probe3d_model(device, storage="f32", dtype=torch.float32, n=128):
    """benchmarks/probe_coupled3d.py's configuration at n^3: an n^3 channel
    with walls on the y faces, sigma 0.01, tau_r 1.0, tau_b 0.8, 60 degrees,
    velocity inlet v_z = -1e-3, convective outlet, one tracer (tau 1.0, j0
    0.25, bounce-back).  Phases 26-28 share one per (device, storage,
    dtype, n)."""
    from openlbmpm_torch.geometry import from_solid_mask
    from openlbmpm_torch.models.flow3d import (
        CG3DBoundaryConfig, ColorGradientParams3D, TransportRK3D)
    key = (str(device), storage, dtype, n)
    if key not in _PROBE3D_MODELS:
        _PROBE3D_MODELS[key] = TransportRK3D(
            from_solid_mask(cg3d_solid("walls", (n,) * 3)),
            ColorGradientParams3D(**_CG3D), boundaries=CG3DBoundaryConfig(
                **_VCONV), dtype=dtype, device=device, storage=storage,
            **_TRACER3D)
    return _PROBE3D_MODELS[key]


def probe3d_start(m):
    """The probe's start (f_r, f_b, g): red in the top n/8 slabs, the tracer
    at 1 in the bottom n/4."""
    nz = m.geo.shape[0]
    fs = m.flow.init_state_layers(1.0, 1.0, invading_slabs=nz // 8)
    return m.init_state(fs, tracer_start("bottom", 1, m.geo.shape))


# Caps on the twin term of the phase 26 bounds: twice the plain path's
# one-ulp twin gap off the seam measured at the probe's configuration,
# 128^3, 10 steps, rounded up (readings 2.056e-4, 3.725e-8, 1.309e-5,
# 2.060e-4, 3.725e-8 on an H100; PERF.md section 2).
PROBE3D_TWIN_CAP = {"K9t f32": 4.2e-4, "K9t f32 tracer": 7.5e-8,
                    "K9t bf16 planes": 2.7e-5, "K9t bf16 rho_r": 4.2e-4,
                    "K9t bf16 tracer": 7.5e-8}
TWIN_CAP = CONFIG5_TWIN_CAP | PROBE3D_TWIN_CAP


def _flat(g):
    """Tracer PDFs (NT, 7, nz, ny, nx) as planes (NT * 7, nz, ny, nx)."""
    return g.flatten(0, 1)


def phase_probe3d(device, n=128, steps=10):
    """The probe's configuration at n^3, `steps` steps of K9t and its plain
    version from one f64 start: f64 (flow and tracer <= 1e-11, the tracer's
    leak into rho_r > 0.5 < 1e-10 of its mass), f32 and bf16 flow storage
    (f32 tracers) held by ``_hold`` against the plain path, its one-ulp twin
    and the f64 run (flow as phase 21: 3e-5, bf16 planes 3e-4, rho_r 1e-4;
    tracers 3e-5); total rho_r kernel vs plain <= 1e-4; the bf16 tracer
    mass within 1e-6 of the f32 run's."""
    from openlbmpm_torch.kernels.cg3d import (
        coupled3d_step_compressed, coupled3d_step_compressed_reference)
    kt = _step2(coupled3d_step_compressed)
    pt = _step2(coupled3d_step_compressed_reference)
    m64 = probe3d_model(device, dtype=torch.float64, n=n)
    x64 = m64.pack(probe3d_start(m64))
    p64, k64 = _run(pt, x64, m64, steps), _run(kt, x64, m64, steps)
    res = {"f64": _pair_gap(k64, p64)}
    check(max(res["f64"]) <= 1e-11, f"K9t probe f64 kernel vs plain "
          f"{res['f64']}")
    conc = m64.concentration(k64[1])[0]
    res["mass64"] = (float(conc.sum()),
                     float(m64.concentration(x64[1])[0].sum()))
    res["leak"] = float(conc[k64[0][19] > 0.5].sum()) / res["mass64"][0]
    check(res["leak"] < 1e-10, f"K9t probe f64: tracer leak {res['leak']:.2e}")
    m32 = probe3d_model(device, n=n)
    away, far = cg3d_masks(m32.flow, steps, device)
    x32 = tuple(t.float() for t in x64)
    tw32 = (_twin(x32[0]), _twin(x32[1], 1))
    kern, plain, twin = (_run(fn, x, m32, steps) for fn, x in (
        (kt, x32), (pt, x32), (pt, tw32)))
    res["f32"] = _gaps(kern[0], plain[0], twin[0], p64[0], away, far)
    res["f32_tracer"] = _gaps(*(_flat(y[1]) for y in (kern, plain, twin,
                                                      p64)), away, far)
    _hold("K9t f32", res["f32"], 3e-5)
    _hold("K9t f32 tracer", res["f32_tracer"], 3e-5)
    mh = probe3d_model(device, storage="bf16", n=n)
    enc = mh.flow.pack_compressed_bf16
    kh, ph, th = (_run(fn, x, mh, steps) for fn, x in (
        (kt, (enc(x32[0]), x32[1])), (pt, (enc(x32[0]), x32[1])),
        (pt, (enc(tw32[0]), tw32[1]))))
    k, p, t = (mh.flow.unpack_bf16(y[0]) for y in (kh, ph, th))
    res["bf16"] = {"planes": _gaps(k[:19], p[:19], t[:19], p64[0][:19], away,
                                   far),
                   "rho_r": _gaps(k[19:], p[19:], t[19:], p64[0][19:], away,
                                  far),
                   "tracer": _gaps(*(_flat(y[1]) for y in (kh, ph, th, p64)),
                                   away, far),
                   "max": float((k - p).abs().max())}
    _hold("K9t bf16 planes", res["bf16"]["planes"], 3e-4)
    _hold("K9t bf16 rho_r", res["bf16"]["rho_r"], 1e-4)
    _hold("K9t bf16 tracer", res["bf16"]["tracer"], 3e-5)
    for x, y, tag in ((kern[0], plain[0], "f32"), (k, p, "bf16")):
        tot_k, tot_p = float(x[19].double().sum()), float(y[19].double().sum())
        res[f"mass_{tag}"] = abs(tot_k - tot_p) / tot_p
        check(res[f"mass_{tag}"] <= 1e-4, f"K9t probe {tag}: total rho_r "
              f"kernel vs plain {res[f'mass_{tag}']:.2e}")
    m_f32, m_bf16 = (float(y[1].double().sum()) for y in (kern, kh))
    res["tracer_mass_bf16"] = abs(m_bf16 - m_f32) / m_f32
    check(res["tracer_mass_bf16"] <= 1e-6, f"K9t probe: bf16 tracer mass "
          f"{res['tracer_mass_bf16']:.2e} from the f32 run's")
    return res


def phase_transport3d_cli(device, steps=1000, n=128, bf16_steps=200):
    """The main paths of K9t: ``run --model transport3d`` through
    ``openlbmpm_torch.cli.main`` on configs/transportsetup.ini with
    configs/rk_csf3d.ini (32x32x96, NEBB inlet, pressure outlet) as the flow
    INI, f32, `steps` steps: the packed state on K9t, launched exactly
    `steps` times, every tracer mass of metrics.jsonl finite; then
    ``run_chunked(model.step_c)`` on the probe's configuration at n^3 with
    bf16 flow storage for `bf16_steps` steps with the NaN guard."""
    import contextlib
    import io
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.kernels.cg3d import coupled3d_step_compressed
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    with tempfile.TemporaryDirectory() as tmp:
        coupled3d_step_compressed.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = cli.main(["run", os.path.join(root, "transportsetup.ini"),
                           "--model", "transport3d", "--physics-config",
                           os.path.join(root, "rk_csf3d.ini"), "--steps",
                           str(steps), "--output", tmp, "--device", "cuda"])
        sec = time.perf_counter() - t0
        launches = coupled3d_step_compressed.launches
        check(rc == 0, f"cli run --model transport3d returned {rc}")
        check("the kernel step on cuda, packed state" in text.getvalue(),
              f"cli transport3d: {text.getvalue().splitlines()[:1]}")
        check(launches == steps, f"cli transport3d: K9t launched {launches} "
              f"times, want {steps}")
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            recs = [json.loads(ln) for ln in fh if ln.strip()]
        masses = [(r["step"], r["tracer0_mass"]) for r in recs]
        check(masses[-1][0] == steps and
              all(np.isfinite(v) for _, v in masses),
              f"cli transport3d: tracer masses {masses}")
        res = {"launches": launches, "sec": sec, "steps": steps,
               "masses": masses,
               "mlups": _mlups(os.path.join(tmp, "metrics.jsonl"))}
    mh = probe3d_model(device, storage="bf16", n=n)
    meter = RunMetrics(n ** 3)
    coupled3d_step_compressed.launches = 0
    s, g = run_chunked(mh.step_c, mh.pack(probe3d_start(mh)),
                       num_steps=bf16_steps, io_interval=100, metrics=meter,
                       nan_guard=True)
    res["launches_bf16"] = coupled3d_step_compressed.launches
    res["run_mlups_bf16"] = meter.mlups
    check(res["launches_bf16"] == bf16_steps and s.dtype == torch.bfloat16
          and g.dtype == torch.float32 and tuple(g.shape) == (1, 7, n, n, n),
          f"K9t bf16 main path: {res['launches_bf16']} launches, state "
          f"{s.dtype} {g.dtype} {tuple(g.shape)}")
    return res


# K9t's kernels: K9's bc and fields, and collide_stream with the tracers
# (collide_stream_tracer_kernel, counted with collide_stream by the library)
TRANSPORT3D_KERNELS = ("bc_kernel", "fields_kernel",
                       "collide_stream_tracer_kernel")
# least bytes per cell-step of K9t's function: K9's state in and out, one
# f32 D3Q7 tracer (28 B) in and out, a 1-byte solid mask
TRANSPORT3D_BYTES = {"f32": 2 * 80 + 2 * 28 + 1, "bf16": 2 * 42 + 2 * 28 + 1}
TRANSPORT3D_FLOPS = CG3D_OPS + 39   # + one D3Q7 tracer (F32_FLOPS_PER_S)


def phase_transport3d_speed(device, sizes=(128, 256), steps=(50, 20),
                            plain_steps=3):
    """MLUPS of K9t with f32 and bf16 flow storage at each size and of the
    plain paths at the first, in turns (plain, kernels, kernels, plain),
    each kernel's device microseconds per launch from torch.profiler, and
    the roofline share of TRANSPORT3D_BYTES.  Launches a step by the
    libraries' own counts: bc, fields and collide_stream once each on the
    probe (an inlet and an outlet), fields and collide_stream on a periodic
    box (``periodic_box`` at 64^3); no separate tracer pass in the trace."""
    from openlbmpm_torch.kernels.cg3d import (
        coupled3d_step_compressed, coupled3d_step_compressed_reference,
        kernel_launches, launch_cg3d_coupled)
    res = {}
    for n, k_steps in zip(sizes, steps):
        models = {"f32": probe3d_model(device, n=n),
                  "bf16": probe3d_model(device, storage="bf16", n=n)}
        st = probe3d_start(models["f32"])
        xs = {k: mod.pack(st) for k, mod in models.items()}
        runs = {k: (lambda x, m=models[k]: coupled3d_step_compressed(*x, m),
                    xs[k]) for k in models}
        order = list(runs)
        if n == sizes[0]:
            runs |= {f"plain_{k}": (
                lambda x, m=models[k]: coupled3d_step_compressed_reference(
                    *x, m), xs[k]) for k in models}
            order = ["plain_f32", "plain_bf16"] + order
        sec = {}
        for key in order + order[::-1]:
            fn, x = runs[key]
            t = _time_steps(fn, x, plain_steps if key.startswith("plain")
                            else k_steps, device)
            sec[key] = min(sec.get(key, float("inf")), t)
        profile, launches = {}, {}
        for key, m in models.items():
            times = device_times(lambda x, m=m: launch_cg3d_coupled(
                *x, m.flow.kernel_params, m.tracer_params, m.flow.geo_planes,
                m.tracer_table), xs[key], TRANSPORT3D_KERNELS + (
                    "tracer_collide", "tracer_stream"), steps=20)
            check(times.pop("tracer_collide") is None and
                  times.pop("tracer_stream") is None,
                  f"K9t {key} {n}^3: a tracer pass in the trace")
            profile.update({(key, k): v for k, v in times.items()})
            launches[key] = _coupled_launches(
                m, xs[key], f"cg3d_{key}", coupled3d_step_compressed,
                kernel_launches, 3, f"K9t {key} {n}^3")
        if n == sizes[0]:
            mp, xp = transport3d_case("periodic_box", device, shape=(64,) * 3,
                                      dtype=torch.float32)
            launches["periodic f32"] = _coupled_launches(
                mp, mp.pack(xp), "cg3d_f32", coupled3d_step_compressed,
                kernel_launches, 2, "K9t periodic f32")
            del mp, xp
        res[n] = {"sec": sec, "profile": profile, "launches": launches,
                  "mlups": {
            key: n ** 3 / t / 1e6 for key, t in sec.items()},
            "roof": {key: TRANSPORT3D_BYTES[key] * n ** 3 / HBM_BYTES_PER_S
                     / sec[key] for key in TRANSPORT3D_BYTES}}
    return res


def _coupled_launches(m, x, lib, step, counts, want, tag):
    """Launches a step of each of K9's kernels by the library `lib` over 10
    coupled steps of x = step(*x, m); `want` launches in all, one of each
    kernel at most."""
    before = counts(lib)
    for _ in range(10):
        x = step(*x, m)
    torch.cuda.synchronize()
    after = counts(lib)
    got = {k: (after[k] - before[k]) / 10 for k in after}
    check(sum(got.values()) == want and all(v in (0, 1) for v in
                                            got.values()),
          f"{tag}: launches a step " + ", ".join(
              f"{k} {v:g}" for k, v in got.items()) + f" (want {want})")
    return got


def phase25_28_lines(r25, r26, r27, r28, card):
    lines = ["phase 25 K9t f64 vs plain, 48x40x32 (grain pack 32^3), 20 "
             "steps: max |diff| flow / tracer " + ", ".join(
                 f"{k} {v[0]:.3e} / {v[1]:.3e}" for k, v in r25.items()) +
             " (<= 1e-11; grain pack <= "
             f"{r25['grain_pack'][2]:.3e} / {r25['grain_pack'][3]:.3e})"]

    def g(x):
        k, p, t = x["from_f64"]
        return (f"max {x['max']:.3e}, off seam {x['away']:.3e} (plain twin "
                f"{x['twin_away']:.3e}), far {x['far']:.3e}; from f64 kernel "
                f"{k:.3e}, plain {p:.3e}, twin {t:.3e}")
    b = r26["bf16"]
    lines.append(
        f"phase 26 probe_coupled3d 128^3, 10 steps [{card}]: f64 flow "
        f"{r26['f64'][0]:.3e}, tracer {r26['f64'][1]:.3e}, leak "
        f"{r26['leak']:.2e}, tracer mass {r26['mass64'][1]:.10g} -> "
        f"{r26['mass64'][0]:.10g}; f32 flow {g(r26['f32'])}; f32 tracer "
        f"{g(r26['f32_tracer'])}; bf16 planes {g(b['planes'])}; bf16 rho_r "
        f"{g(b['rho_r'])}; bf16 tracer {g(b['tracer'])}; total rho_r kernel "
        f"vs plain f32 {r26['mass_f32']:.2e}, bf16 {r26['mass_bf16']:.2e}; "
        f"bf16 tracer mass vs f32 {r26['tracer_mass_bf16']:.2e}")
    lines.append(
        f"phase 27 cli run --model transport3d, rk_csf3d.ini 32x32x96 + "
        f"transportsetup.ini, {r27['steps']} f32 steps [{card}]: "
        f"{r27['launches']} K9t launches, {r27['sec']:.2f} s, metrics.jsonl "
        f"MLUPS {r27['mlups']}, tracer0_mass " + ", ".join(
            f"step {k} {v:.10g}" for k, v in r27["masses"]) +
        f"; bf16 main path run_chunked {r27['launches_bf16']} launches, "
        f"{r27['run_mlups_bf16']:.1f} MLUPS")
    for n, r in r28.items():
        sec = r["sec"]
        lines.append(
            f"phase 28 K9t {n}^3 [{card}]: MLUPS " + ", ".join(
                f"{k} {r['mlups'][k]:.1f} ({sec[k] * 1e3:.4f} ms)"
                for k in sec) + "; bound ms " + ", ".join(
                f"{k} {v * n ** 3 / HBM_BYTES_PER_S * 1e3:.4f}"
                for k, v in TRANSPORT3D_BYTES.items()) +
            "; roofline share " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["roof"].items()) +
            "; device us per launch (launches per step in the trace): " +
            ", ".join(f"{k} {key} " + ("not measured" if v is None else
                                       f"{v[0]:.2f} ({v[1]:g})")
                      for (key, k), v in r["profile"].items()) +
            "; launches a step by the libraries' counts: " + "; ".join(
                f"{key} " + ", ".join(f"{k} {v:g}" for k, v in c.items())
                for key, c in r["launches"].items()))
    return lines


# -- the single-phase D2Q9 step: K7 -------------------------------------------

# name -> (collision, BoundaryConfig fields): each collision under each row
# pair of tests/test_single_phase.py:84-91 (phase 29; test_torch_cuda.py)
_ZH = dict(inlet="zou_he_velocity", outlet="zou_he_pressure",
           inlet_velocity=-1e-3, outlet_density=1.0)
_PC = dict(inlet="zou_he_pressure", outlet="convective", inlet_density=1.02)
SINGLE_CASES = {f"{c.lower()}_{b}": (c, bcs) for c in ("SRT", "TRT", "MRT")
                for b, bcs in (("zou_he", _ZH), ("convective", _PC),
                               ("periodic", {}))}
SINGLE_FORCE = (1e-5, -2e-5)


def single_case(name, device, ny=256, nx=128, dtype=torch.float64,
                storage="f32"):
    """A SINGLE_CASES model on an ny x nx channel with side walls, tau 0.8,
    the body force SINGLE_FORCE."""
    from openlbmpm_torch.models.single_phase import (BoundaryConfig,
                                                     SinglePhaseD2Q9)
    collision, bcs = SINGLE_CASES[name]
    return SinglePhaseD2Q9(walled(ny, nx), tau=0.8, collision=collision,
                           body_force=SINGLE_FORCE,
                           boundaries=BoundaryConfig(**bcs), dtype=dtype,
                           device=device, storage=storage)


def flow_start(m, seed=0, k=None):
    """A perturbed equilibrium of model `m` on its fluid (one fluid, or the
    k fluids of a Shan-Chen model): rho in [0.97, 1.03] (fluid j scaled by
    (1, 0.3, 0.6, 0.45)[j]), |u| <= 0.02 per component, made in float64
    from a numpy seed and cast to the model's arithmetic type."""
    from openlbmpm_torch.ops.equilibrium import feq_quadratic
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    shape = lead + tuple(m.geo.shape)
    rho = rng.uniform(0.97, 1.03, shape)
    if k is not None:
        rho *= np.array([1.0, 0.3, 0.6, 0.45][:k]).reshape((-1,) + (1,) * (
            len(shape) - 1))
    u = tuple(torch.as_tensor(rng.uniform(-0.02, 0.02, shape),
                              device=m.device) for _ in range(m.lat.dim))
    f = feq_quadratic(m.lat, torch.as_tensor(rho, device=m.device), u)
    return (f * m.fluid_mask.double()).to(m.dtype)


def config1_model(device, storage="f32", dtype=torch.float32, nx=512,
                  ny=1024):
    """bench_all.py config 1 (benchmarks/bench_all.py:50-75): a 512 x 1024
    box with walls, MRT, tau 0.9, body force (0, -1e-6), periodic rows."""
    from openlbmpm_torch.geometry import box_with_walls
    from openlbmpm_torch.models.single_phase import SinglePhaseD2Q9
    return SinglePhaseD2Q9(box_with_walls(nx, ny), tau=0.9, collision="MRT",
                           body_force=(0.0, -1e-6), dtype=dtype,
                           device=device, storage=storage)


def _bf16_encode_rz(x, lat):
    """A stepped state (..., Q, *spatial) encoded to bf16 rounding toward
    zero (a wrong rounding mode), per fluid: deviations, rho hi, rho lo."""
    from openlbmpm_torch.ops.macroscopic import density
    rho = density(x, lat.dim)
    w = torch.as_tensor(lat.w, dtype=x.dtype, device=x.device).reshape(
        (-1,) + (1,) * lat.dim)
    hi = _bf16_rz(rho)
    qax = -(lat.dim + 1)
    return torch.cat([_bf16_rz(x - w * rho.unsqueeze(qax)), hi.unsqueeze(qax),
                      _bf16_rz(rho - hi.float()).unsqueeze(qax)], dim=qax)


def bf16_ulp_check(m, h, kernel, where, max_share, tag):
    """K7, K10 and K11 in bf16 storage: the kernel and its plain version one
    step from the common bf16 state `h`, every stored value within one bf16
    ulp on `where` (``compare_bf16_states``, per fluid), at most
    `max_share` of the values >= 1e-4 off at all; the same check must fail
    a round-toward-zero encoding of the plain path's own f32 result."""
    from openlbmpm_torch.kernels.csf import compare_bf16_states
    plain = m.plain_step(h)
    kern = kernel(h, m)
    rz = _bf16_encode_rz(m._step_impl(m.unpack_bf16(h)), m.lat)
    per = [(kern, plain, rz)] if kern.dim() == m.lat.dim + 1 else \
        list(zip(kern, plain, rz))
    r = {"excess": 0.0, "share": 0.0, "hi_flips": 0, "rz_share": 0.0}
    for a, b, c in per:
        x = compare_bf16_states(a, b, where)
        r = {"excess": max(r["excess"], x["excess"]),
             "share": max(r["share"], x["share"]),
             "hi_flips": r["hi_flips"] + x["hi_flips"],
             "rz_share": max(r["rz_share"],
                             compare_bf16_states(c, b, where)["share"])}
    check(r["excess"] <= 1.0, f"{tag} bf16 one step: a value "
          f"{r['excess']:.3g} ulp off the plain path")
    check(r["share"] <= max_share, f"{tag} bf16 one step: {r['share']:.2e} of "
          f"the values differ (> {max_share:g})")
    check(r["rz_share"] > max_share, f"{tag} bf16 one-step check cannot see a "
          f"rounding-toward-zero encoding ({r['rz_share']:.2e})")
    return r


def phase_single_f64(device, steps=20, tol=1e-11):
    """K7 against its plain version at f64, `steps` steps on a 256 x 128
    channel with side walls from a perturbed start, in every case of
    SINGLE_CASES (with the body force); max |difference| <= tol."""
    from openlbmpm_torch.kernels.single import (single_step,
                                                single_step_reference)
    res = {}
    for name in SINGLE_CASES:
        m = single_case(name, device)
        check(m.path == "kernel", f"K7 {name}: path {m.path}")
        f = flow_start(m, seed=len(res))
        a = _run(single_step, f, m, steps)
        b = _run(single_step_reference, f, m, steps)
        res[name] = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()) and res[name] <= tol,
              f"K7 {name} f64: max |kernel - plain| {res[name]:.3e}")
    return res


# f32 kernel against plain, 10 steps from one start: about 10x the gap
# measured on an H100 (1.490e-7 at config 1; PERF.md section 6)
SINGLE_F32_BOUND = 2e-6
# the share of bf16 values >= 1e-4 that may differ at all after one step:
# K7 relaxes MRT in moment space, the plain path through the dense
# M^-1 S M, so their f32 results round apart (3.4e-3 measured at config 1,
# 1.8e-2 at 70 x 45 three steps from rest, on an H100); the 3-D steps
# follow the plain formulas (2.4e-3 measured for K11)
SINGLE_BF16_SHARE = 3e-2
FLOW3D_BF16_SHARE = 1e-2


def phase_config1(device, nx=512, ny=1024, steps=10):
    """bench_all.py config 1 at full size, `steps` steps of K7 and its plain
    version from one perturbed f64 start: f64 <= 1e-11, f32 <=
    SINGLE_F32_BOUND; bf16 storage: the state after `steps` steps, decoded,
    within BF16_BOUND["K7"] of the plain path's, then one more step of each
    from a common bf16 state by ``bf16_ulp_check``."""
    from openlbmpm_torch.kernels.single import (single_step,
                                                single_step_reference)
    m64 = config1_model(device, dtype=torch.float64, nx=nx, ny=ny)
    f64 = flow_start(m64, seed=11)
    res = {"f64": float((_run(single_step, f64, m64, steps) - _run(
        single_step_reference, f64, m64, steps)).abs().max())}
    check(res["f64"] <= 1e-11, f"config 1 f64: {res['f64']:.3e}")
    m32 = config1_model(device, nx=nx, ny=ny)
    f32 = f64.float()
    k32 = _run(single_step, f32, m32, steps)
    res["f32"] = float((k32 - _run(single_step_reference, f32, m32,
                                   steps)).abs().max())
    check(res["f32"] <= SINGLE_F32_BOUND, f"config 1 f32: {res['f32']:.3e}")
    mh = config1_model(device, storage="bf16", nx=nx, ny=ny)
    h = mh.pack_state_bf16(f32)
    kh = _run(single_step, h, mh, steps)
    ph = _run(single_step_reference, h, mh, steps)
    res["bf16"] = float((mh.unpack_bf16(kh) - mh.unpack_bf16(ph)).abs().max())
    check(res["bf16"] <= BF16_BOUND["K7"], f"config 1 bf16: "
          f"{res['bf16']:.3e}")
    res["ulp"] = bf16_ulp_check(mh, ph, single_step, mh.fluid_mask > 0,
                                SINGLE_BF16_SHARE, "K7")
    res["finite"] = bool(torch.isfinite(k32).all())
    check(res["finite"], "config 1 f32 kernel state not finite")
    return res


def poiseuille2d_model(collision, device, nx=130, ny=1024,
                       dtype=torch.float32):
    """A body-force channel: side walls (nx - 2 = 128 fluid columns),
    periodic along y, tau 0.9, g = 1e-6 along y."""
    from openlbmpm_torch.models.single_phase import SinglePhaseD2Q9
    return SinglePhaseD2Q9(walled(ny, nx), tau=0.9, collision=collision,
                           body_force=(0.0, 1e-6), dtype=dtype, device=device)


def phase_single_poiseuille(device, steps=80_000, tol=0.02):
    """The analytic Poiseuille profile through K7 for SRT, TRT and MRT, in
    f32 (keys "SRT", "TRT", "MRT") and in f64 (keys "... f64", which set
    f32 rounding apart from the method): ``run_chunked(model.step)`` for
    `steps` steps from rest on the 130 x 1024 channel (the slowest mode
    decays in (H/pi)^2 / nu ~ 12,500 steps, so 80,000 leave < 0.5 % of the
    transient); the mid-row profile within `tol` of g / (2 nu) ((H/2)^2 -
    x^2); K7 launched exactly `steps` times."""
    from openlbmpm_torch.kernels.single import single_step
    from openlbmpm_torch.models.base import run_chunked
    res = {}
    for dtype, suffix in ((torch.float32, ""), (torch.float64, " f64")):
        for collision in ("SRT", "TRT", "MRT"):
            m = poiseuille2d_model(collision, device, dtype=dtype)
            single_step.launches = 0
            f = run_chunked(m.step, m.init_state(1.0), num_steps=steps,
                            io_interval=steps // 4, nan_guard=True)
            launches = single_step.launches
            _, (_, uy) = m.macro(f)
            err = poiseuille_error(uy[m.geo.ny // 2].double().cpu().numpy(),
                                   m.body_force[1], m.nu)
            key = collision + suffix
            res[key] = (err, launches, float(uy.max()))
            check(launches == steps, f"K7 Poiseuille {key}: {launches} "
                  f"launches, want {steps}")
            check(err < tol, f"K7 Poiseuille {key}: profile {err:.4f} from "
                  "the analytic one")
    return res


# config 1 has no inlet or outlet, so bc_rows_kernel does not run there
SINGLE_KERNELS = ("collide_stream_kernel",)
# least bytes per cell-step of K7's function: the state in and out plus a
# 1-byte mask: f32 2 x 36 + 1, bf16 2 x 22 + 1
SINGLE_BYTES = {"f32": 2 * 36 + 1, "bf16": 2 * 22 + 1}
SINGLE_FLOPS = SINGLE_OPS   # least operations per cell-step (F32_FLOPS_PER_S)


def phase_single_main(device, sizes=((1024, 512), (1024, 1024)),
                      main_steps=1000, kernel_steps=500, plain_steps=20):
    """The main path of K7 in bf16 storage: ``run_chunked(model.step)`` on
    config 1 for `main_steps` steps with the NaN guard, its launches counted
    and its MLUPS; then MLUPS of kernel and plain path (f32, bf16) at each
    (ny, nx) of `sizes` from CUDA events (plain, kernel, kernel, plain), each
    CUDA kernel's device microseconds per launch from torch.profiler, and
    the roofline share of SINGLE_BYTES."""
    from openlbmpm_torch.kernels.single import (
        launch_single2d, single_step, single_step_reference)
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    mh = config1_model(device, storage="bf16")
    meter = RunMetrics(mh.geo.num_fluid_nodes)
    single_step.launches = 0
    h = run_chunked(mh.step, mh.pack_state_bf16(mh.init_state(1.0)),
                    num_steps=main_steps, io_interval=main_steps // 2,
                    metrics=meter, nan_guard=True)
    res = {"launches_bf16": single_step.launches, "run_mlups_bf16":
           meter.mlups}
    check(res["launches_bf16"] == main_steps and h.dtype == torch.bfloat16,
          f"K7 bf16 main path: {res['launches_bf16']} launches")
    _, (_, uy) = mh.macro(h)
    res["uy_min"] = float(uy.min())
    check(bool(torch.isfinite(uy).all()) and res["uy_min"] < 0,
          f"K7 bf16 main path: u_y min {res['uy_min']}")
    for ny, nx in sizes:
        models = {st: config1_model(device, storage=st, nx=nx, ny=ny)
                  for st in ("f32", "bf16")}
        f = models["f32"].init_state(1.0)
        states = {"f32": f, "bf16": models["bf16"].pack_state_bf16(f)}
        sec = time_paths(models, states, single_step, single_step_reference,
                         kernel_steps, plain_steps, device)
        profile = {}
        for st, m in models.items():
            times = device_times(lambda x, m=m: launch_single2d(
                x, m.kernel_params, m.fluid_u8), states[st], SINGLE_KERNELS)
            profile.update({(st, k): v for k, v in times.items()})
        cells = nx * ny
        res[(ny, nx)] = {
            "sec": sec, "profile": profile,
            "mlups": {k: cells / t / 1e6 for k, t in sec.items()},
            "roof": {st: SINGLE_BYTES[st] * cells / HBM_BYTES_PER_S /
                     sec[("kernel", st)] for st in SINGLE_BYTES}}
    return res


def phase29_32_lines(r29, r30, r31, r32, card):
    lines = ["phase 29 K7 f64 vs plain, 256x128 side walls, body force, 20 "
             "steps: max |diff| " + ", ".join(
                 f"{k} {v:.3e}" for k, v in r29.items()) + " (<= 1e-11)"]
    u = r30["ulp"]
    lines.append(
        f"phase 30 config 1 512x1024 MRT, 10 steps [{card}]: f64 "
        f"{r30['f64']:.3e} (<= 1e-11), f32 {r30['f32']:.3e} (<= "
        f"{SINGLE_F32_BOUND:g}), bf16 decoded {r30['bf16']:.3e} (<= "
        f"{BF16_BOUND['K7']:g}); "
        f"K7 bf16 one step {u['excess']:g} ulp, share {u['share']:.2e} (<= "
        f"{SINGLE_BF16_SHARE:g}), hi flips {u['hi_flips']}, round-toward-"
        f"zero share {u['rz_share']:.2e}")
    lines.append(
        f"phase 31 K7 Poiseuille 130x1024, tau 0.9, g 1e-6, 80000 steps "
        f"(f32, then f64) [{card}]: " + ", ".join(
            f"{k} {v[0] * 100:.3f}% of the analytic profile (u max "
            f"{v[2]:.6g}, {v[1]} launches)" for k, v in r31.items()) +
        " (< 2%)")
    lines.append(
        f"phase 32 K7 main path config 1 bf16 [{card}]: run_chunked "
        f"{r32['launches_bf16']} launches, {r32['run_mlups_bf16']:.1f} MLUPS, "
        f"u_y min {r32['uy_min']:.4g}")
    for key, r in r32.items():
        if not isinstance(key, tuple):
            continue
        ny, nx = key
        sec = r["sec"]
        lines.append(
            f"phase 32 K7 {nx}x{ny} [{card}]: MLUPS " + ", ".join(
                f"{p} {st} {r['mlups'][(p, st)]:.1f} ("
                f"{sec[(p, st)] * 1e3:.4f} ms)" for p, st in sec) +
            "; bound ms " + ", ".join(
                f"{st} {b * nx * ny / HBM_BYTES_PER_S * 1e3:.4f}"
                for st, b in SINGLE_BYTES.items()) + "; roofline share " +
            ", ".join(f"{st} {v:.3f}" for st, v in r["roof"].items()) +
            "; device us per launch (launches per step): " + ", ".join(
                f"{st} {k} " + ("not measured" if v is None else
                                f"{v[0]:.2f} ({v[1]:g})")
                for (st, k), v in r["profile"].items()))
    return lines


# -- the D3Q19 single-phase and Shan-Chen steps: K11 and K10 -----------------

# name -> (collision, body force): K11's cases on walls along y (phase 33)
SINGLE3D_CASES = {"srt_force": ("SRT", (2e-5, -1e-5, 3e-5)),
                  "srt": ("SRT", (0.0, 0.0, 0.0)),
                  "trt_force": ("TRT", (2e-5, -1e-5, 3e-5)),
                  "trt": ("TRT", (0.0, 0.0, 0.0))}


def _walls_y(shape, obstacle=False):
    from openlbmpm_torch.geometry import from_solid_mask
    solid = np.zeros(shape, bool)
    solid[:, 0, :] = solid[:, -1, :] = True
    if obstacle:
        nz, ny, nx = shape
        z, y, x = nz // 3, ny // 3, nx // 3
        solid[z:z + 4, y:y + 4, x:x + 5] = True
    return from_solid_mask(solid)


def single3d_case(name, device, shape=(48, 40, 32), dtype=torch.float64):
    """A SINGLE3D_CASES model (tau 0.8) on walls along y with an obstacle."""
    from openlbmpm_torch.models.flow3d import SinglePhaseD3Q19
    collision, force = SINGLE3D_CASES[name]
    return SinglePhaseD3Q19(_walls_y(shape, obstacle=True), tau=0.8,
                            collision=collision, body_force=force,
                            dtype=dtype, device=device)


def basic3d_model(device, n=128, storage="f32", dtype=torch.float32):
    """configs/basic3d.ini's physics (SRT, tau 0.9, g_z = -1e-6) at n^3 in
    the CLI's box (walls on the x and y faces, ``cli._box3d``)."""
    from openlbmpm_torch.cli import _box3d
    from openlbmpm_torch.models.flow3d import SinglePhaseD3Q19
    return SinglePhaseD3Q19(_box3d({"nz": n, "ny": n, "nx": n}), tau=0.9,
                            body_force=(0.0, 0.0, -1e-6), dtype=dtype,
                            device=device, storage=storage)


_SC2 = dict(g_matrix=((0.0, 3.6), (3.6, 0.0)), g_solid=(-0.3, 0.3),
            tau=(1.0, 0.8))
# name -> (ShanChenParams3D fields, geometry: "open", "walls" along y,
# "obstacle" (walls and a block) or "grains" (``periodic_grains``), start):
# K10's cases (phase 36; test_torch_cuda.py)
SC3D_CASES = {
    "k2_periodic": (dict(g_matrix=((0.0, 3.6), (3.6, 0.0)),
                         g_solid=(0.0, 0.0), tau=(1.0, 1.0)), "open",
                    "droplet"),
    "k2_walls_force": (_SC2 | dict(body_force=(1e-5, -1e-5, -1e-5)), "walls",
                       "droplet"),
    "k3": (dict(g_matrix=((0.0, 2.0, 1.0), (2.0, 0.0, 1.5), (1.0, 1.5, 0.0)),
                g_solid=(0.1, -0.2, 0.0), tau=(1.0, 0.8, 1.2)), "walls",
           "random"),
    "k1_obstacle": (dict(g_matrix=((0.0,),), g_solid=(-0.2,), tau=(0.9,),
                         body_force=(1e-5, 0.0, -2e-5)), "obstacle",
                    "random"),
    "k2_grains": (_SC2 | dict(body_force=(0.0, 0.0, -1e-5)), "grains",
                  "droplet"),
}


def periodic_grains(shape, n_grains=16, seed=11):
    """(nz, ny, nx) solid mask of spherical grains in a periodic box: the
    first centred on the corner cell (0, 0, 0), so it crosses the periodic
    seams in z, y and x, the others at random centres (numpy `seed`), radii
    0.12-0.2 of the shortest side; distances wrap, so every grain cut by a
    face continues across it.  Some solid cells sit a cell wide between
    grains (one-cell slivers)."""
    rng = np.random.default_rng(seed)
    idx = np.indices(shape)
    solid = np.zeros(shape, bool)
    for g in range(n_grains):
        c = np.zeros(3) if g == 0 else rng.uniform(0.0, 1.0, 3) * shape
        r = rng.uniform(0.12, 0.2) * min(shape)
        d2 = sum(np.minimum(np.abs(idx[a] - c[a]), shape[a] - np.abs(
            idx[a] - c[a])) ** 2 for a in range(3))
        solid |= d2 < r * r
    return solid


# K = 4 fluids: the runtime-K instance of K10 / K10-T (phase 58)
SC3D4_CASES = {
    "k4_walls_force": (dict(g_matrix=_g4(1.0), g_solid=(0.1, -0.2, 0.0, 0.05),
                            tau=(1.0, 0.8, 1.2, 0.9),
                            body_force=(1e-5, -1e-5, -1e-5)), "walls",
                       "random"),
    "k4_periodic": (dict(g_matrix=_g4(1.0), g_solid=(0.0,) * 4,
                         tau=(1.0, 0.9, 1.1, 1.0)), "open", "random"),
}


def sc3d_case(name, device, shape=(48, 40, 32), dtype=torch.float64,
              storage="f32"):
    """A SC3D_CASES model and its start: fluid 0 a sphere of radius
    min(shape)/4 at densities (1, 0.02), or a perturbed equilibrium."""
    from openlbmpm_torch.geometry import from_solid_mask
    from openlbmpm_torch.models.flow3d import ShanChenMCMP3D, ShanChenParams3D
    kw, kind, start = (SC3D_CASES | SC3D4_CASES)[name]
    if kind == "grains":
        g = from_solid_mask(periodic_grains(shape))
    elif kind == "open":
        g = from_solid_mask(np.zeros(shape, bool))
    else:
        g = _walls_y(shape, obstacle=kind == "obstacle")
    m = ShanChenMCMP3D(g, ShanChenParams3D(**kw), dtype=dtype, device=device,
                       storage=storage)
    if start == "droplet":
        f = m.init_state_droplet((1.0,) * m.k, (0.02,) * m.k,
                                 radius=min(shape) / 4)
    else:
        f = flow_start(m, seed=3, k=m.k)
    return m, f


def probe_sc3d_model(device, n=128, storage="f32", dtype=torch.float32):
    """benchmarks/probe_sc3d.py's configuration at n^3: walls on the y
    faces, G = 3.6, G_s = (-0.3, 0.3), tau = (1.0, 0.8), g_z = -1e-6."""
    from openlbmpm_torch.models.flow3d import ShanChenMCMP3D, ShanChenParams3D
    return ShanChenMCMP3D(_walls_y((n,) * 3), ShanChenParams3D(
        **_SC2, body_force=(0.0, 0.0, -1e-6)), dtype=dtype, device=device,
        storage=storage)


def probe_sc3d_start(m):
    """The probe's start: a droplet of fluid 0 of radius n/4, densities
    (1.0, 0.02) in and out."""
    return m.init_state_droplet((1.0, 1.0), (0.02, 0.02),
                                radius=m.geo.shape[0] / 4)


def phase_single3d_f64(device, steps=20, tol=1e-11):
    """K11 against its plain version at f64, `steps` steps on 48x40x32 with
    walls along y and an obstacle from a perturbed start, in every case of
    SINGLE3D_CASES; max |difference| <= tol."""
    from openlbmpm_torch.kernels.flow3d import (single3d_step,
                                                single3d_step_reference)
    res = {}
    for name in SINGLE3D_CASES:
        m = single3d_case(name, device)
        check(m.path == "kernel", f"K11 {name}: path {m.path}")
        f = flow_start(m, seed=len(res))
        a = _run(single3d_step, f, m, steps)
        res[name] = float((a - _run(single3d_step_reference, f, m,
                                    steps)).abs().max())
        check(bool(torch.isfinite(a).all()) and res[name] <= tol,
              f"K11 {name} f64: max |kernel - plain| {res[name]:.3e}")
    return res


# kernel against plain, 10 steps from one start (bf16 decoded): about 10x
# the gaps measured on an H100 (K11 f32 2.086e-7, bf16 1.273e-5 at 256^3;
# K7 bf16 2.310e-5 at config 1; PERF.md section 6)
FLOW3D_F32_BOUND = {"K11": 2e-6, "K10": 1e-5}
BF16_BOUND = {"K7": 3e-4, "K11": 1.5e-4, "K10": 3e-4}


def _flow3d_compare(device, kernel, plain, make, start, steps, tag, sizes):
    """At each n of `sizes`: f32 and bf16 storage, `steps` steps of kernel
    and plain version from `start(model)`, max |difference| (bf16 decoded)
    within FLOW3D_F32_BOUND[tag] (f32) and BF16_BOUND[tag] (bf16); then at
    the first n one more step from a common bf16 state
    (``bf16_ulp_check``)."""
    res = {}
    for n in sizes:
        m32 = make(device, n=n)
        f = start(m32)
        a, b = _run(kernel, f, m32, steps), _run(plain, f, m32, steps)
        r = {"f32": float((a - b).abs().max()),
             "finite": bool(torch.isfinite(a).all())}
        del a, b
        mh = make(device, n=n, storage="bf16")
        h = mh.pack_state_bf16(f)
        del f
        a, b = _run(kernel, h, mh, steps), _run(plain, h, mh, steps)
        r["bf16"] = float((mh.unpack_bf16(a) - mh.unpack_bf16(b)).abs().max())
        if n == sizes[0]:
            r["ulp"] = bf16_ulp_check(mh, b, kernel, mh.fluid_mask > 0,
                                      FLOW3D_BF16_SHARE, tag)
        del a, b, h
        check(r["finite"] and r["f32"] <= FLOW3D_F32_BOUND[tag],
              f"{tag} {n}^3 f32: max |kernel - plain| {r['f32']:.3e}")
        check(r["bf16"] <= BF16_BOUND[tag], f"{tag} {n}^3 bf16: "
              f"{r['bf16']:.3e}")
        res[n] = r
        torch.cuda.empty_cache()
    return res


def phase_basic3d(device, sizes=(128, 256), steps=10):
    """basic3d.ini's physics at each n of `sizes`, K11 against its plain
    version from a perturbed start (``_flow3d_compare``)."""
    from openlbmpm_torch.kernels.flow3d import (single3d_step,
                                                single3d_step_reference)
    return _flow3d_compare(
        device, single3d_step, single3d_step_reference, basic3d_model,
        lambda m: flow_start(m, seed=5), steps, "K11", sizes)


def phase_single3d_poiseuille(device, steps=4000, tol=0.02):
    """tests/test_flow3d.py:15-34's plate Poiseuille flow through K11 (f32):
    4 x 18 x 4, walls on the y faces, tau 0.9, g_x = 1e-6, 4000 steps, SRT
    and TRT; the profile u_x(y) within `tol` of the analytic one."""
    from openlbmpm_torch.kernels.flow3d import single3d_step
    from openlbmpm_torch.models.base import run_chunked
    from openlbmpm_torch.models.flow3d import SinglePhaseD3Q19
    res = {}
    for collision in ("SRT", "TRT"):
        m = SinglePhaseD3Q19(_walls_y((4, 18, 4)), tau=0.9,
                             collision=collision, body_force=(1e-6, 0.0, 0.0),
                             dtype=torch.float32, device=device)
        single3d_step.launches = 0
        f = run_chunked(m.step, m.init_state(), num_steps=steps,
                        io_interval=steps, nan_guard=True)
        check(single3d_step.launches == steps, f"K11 Poiseuille: "
              f"{single3d_step.launches} launches")
        _, (ux, _, _) = m.macro(f)
        res[collision] = poiseuille_error(ux[2, :, 2].double().cpu().numpy(),
                                          1e-6, m.nu)
        check(res[collision] < tol, f"K11 Poiseuille {collision}: profile "
              f"{res[collision]:.4f} from the analytic one")
    return res


def phase_sc3d_f64(device, steps=20, tol=1e-11, f32_steps=10):
    """K10 against its plain version at f64, `steps` steps on 48x40x32 in
    every case of SC3D_CASES (K = 1, 2, 3; open, walls, an obstacle, and
    grains across the periodic seams); max |difference| <= tol.  Then the
    same cases from the same start in f32 storage, `f32_steps` steps, within
    FLOW3D_F32_BOUND["K10"] (the push of the f32 instance)."""
    from openlbmpm_torch.kernels.flow3d import sc3d_step, sc3d_step_reference
    res = {}
    for name in SC3D_CASES:
        m, f = sc3d_case(name, device)
        check(m.path == "kernel", f"K10 {name}: path {m.path}")
        a = _run(sc3d_step, f, m, steps)
        res[name] = float((a - _run(sc3d_step_reference, f, m,
                                    steps)).abs().max())
        check(bool(torch.isfinite(a).all()) and res[name] <= tol,
              f"K10 {name} f64: max |kernel - plain| {res[name]:.3e}")
        m32, _ = sc3d_case(name, device, dtype=torch.float32)
        f = f.float()
        a = _run(sc3d_step, f, m32, f32_steps)
        res[f"{name} f32"] = float((a - _run(sc3d_step_reference, f, m32,
                                             f32_steps)).abs().max())
        check(bool(torch.isfinite(a).all()) and res[f"{name} f32"] <=
              FLOW3D_F32_BOUND["K10"], f"K10 {name} f32: max |kernel - "
              f"plain| {res[f'{name} f32']:.3e}")
    return res


def phase_probe_sc3d(device, sizes=(128, 256), steps=10, n_phys=128,
                     phys_steps=1000):
    """probe_sc3d.py's configuration: f64 at the first size (10 steps,
    <= 1e-11), f32 and bf16 at each size (``_flow3d_compare``); then the
    physics on K10 f32 at n_phys^3: ``run_chunked(model.step)`` for
    `phys_steps` steps, each fluid's mass within 1e-4 of its start (f32
    rounding of the equilibria drifts it: 1.84e-5 measured on an H100; the
    f64 instance holds it to 1e-12 over 300 steps), the droplet separated
    (rho_0 > 0.5 at its centre, < 0.2 far from it and from the walls)."""
    from openlbmpm_torch.kernels.flow3d import sc3d_step, sc3d_step_reference
    from openlbmpm_torch.models.base import run_chunked
    m64 = probe_sc3d_model(device, n=sizes[0], dtype=torch.float64)
    f = probe_sc3d_start(m64)
    res = {"f64": float((_run(sc3d_step, f, m64, steps) - _run(
        sc3d_step_reference, f, m64, steps)).abs().max())}
    check(res["f64"] <= 1e-11, f"probe_sc3d f64: {res['f64']:.3e}")
    del m64, f
    res |= _flow3d_compare(device, sc3d_step, sc3d_step_reference,
                           probe_sc3d_model,
                           probe_sc3d_start, steps, "K10", sizes)
    m = probe_sc3d_model(device, n=n_phys)
    f = probe_sc3d_start(m)
    m0 = f.double().sum(dim=(1, 2, 3, 4))
    sc3d_step.launches = 0
    f = run_chunked(m.step, f, num_steps=phys_steps, io_interval=phys_steps,
                    nan_guard=True)
    check(sc3d_step.launches == phys_steps, f"K10 physics: "
          f"{sc3d_step.launches} launches")
    drift = ((f.double().sum(dim=(1, 2, 3, 4)) - m0).abs() / m0).max()
    rho0 = f[0].sum(0)
    c = n_phys // 2
    res["phys"] = {"drift": float(drift), "centre": float(rho0[c, c, c]),
                   "far": float(rho0[c, c, 2])}
    check(res["phys"]["drift"] < 1e-4, f"K10 mass drift {float(drift):.2e}")
    # 100 steps of the kernel and of its plain version from the start, to
    # set the f32 drift beside the plain path's (recorded, not checked)
    f = probe_sc3d_start(m)
    for key, fn in (("kernel100", sc3d_step),
                    ("plain100", sc3d_step_reference)):
        g = _run(fn, f, m, 100)
        res["phys"][key] = float(((g.double().sum(dim=(1, 2, 3, 4)) - m0).abs()
                                  / m0).max())
        del g
    del m, f
    m = probe_sc3d_model(device, n=n_phys, dtype=torch.float64)
    f = probe_sc3d_start(m)
    m0 = f.sum(dim=(1, 2, 3, 4))
    f = _run(sc3d_step, f, m, 300)
    res["phys"]["drift64"] = float(((f.sum(dim=(1, 2, 3, 4)) - m0).abs() /
                                    m0).max())
    check(res["phys"]["drift64"] < 1e-12, f"K10 f64 mass drift "
          f"{res['phys']['drift64']:.2e}")
    check(res["phys"]["centre"] > 0.5 and res["phys"]["far"] < 0.2,
          f"K10 droplet: rho_0 centre {res['phys']['centre']:.4f}, far "
          f"{res['phys']['far']:.4f}")
    return res


def phase_flow_cli(device, steps=1000):
    """``run --model basic`` on configs/basicsetup.ini (512 x 1024, MRT),
    ``--model basic3d`` on configs/basic3d.ini (32 x 32 x 64) and ``--model
    sc3d`` on configs/shanchen3d.ini (32 x 32 x 64) as shipped, `steps` f32
    steps each with the output interval set to `steps`, through
    ``openlbmpm_torch.cli.main``: path "kernel", K7 / K11 / K10 launched
    exactly `steps` times, the final checkpoint finite; then the bf16 main
    paths of K11 and K10 (``run_chunked(model.step)``, 200 steps at 128^3)
    with their launches counted."""
    import contextlib
    import io
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.kernels.flow3d import sc3d_step, single3d_step
    from openlbmpm_torch.kernels.single import single_step
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for model, name, counter, key, shape in (
                ("basic", "basicsetup.ini", single_step, "TimeInterval",
                 (9, 1024, 512)),
                ("basic3d", "basic3d.ini", single3d_step, "TimeInterval",
                 (19, 64, 32, 32)),
                ("sc3d", "shanchen3d.ini", sc3d_step, "TimeInterval",
                 (2, 19, 64, 32, 32))):
            ini = os.path.join(tmp, name)
            _ini_copy(os.path.join(root, name), ini, {key: steps})
            out = os.path.join(tmp, model)
            counter.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as text:
                rc = cli.main(["run", ini, "--model", model, "--steps",
                               str(steps), "--output", out, "--device",
                               "cuda", "--block", "1"])
            sec = time.perf_counter() - t0
            launches = counter.launches
            check(rc == 0, f"cli run --model {model} returned {rc}")
            check("the kernel step on cuda" in text.getvalue(),
                  f"cli {model}: {text.getvalue().splitlines()[:1]}")
            check(launches == steps, f"cli {model}: {launches} launches, "
                  f"want {steps}")
            with np.load(os.path.join(out, "checkpoint.npz")) as z:
                s, step = z["leaf0"], int(z["__step__"])
            check(step == steps and s.shape == shape and
                  bool(np.isfinite(s).all()),
                  f"cli {model}: checkpoint at step {step} {s.shape}")
            res[model] = {"launches": launches, "sec": sec,
                          "mlups": _mlups(os.path.join(out, "metrics.jsonl"))}
    for tag, make, start, counter in (
            ("K11", basic3d_model, lambda m: m.init_state(), single3d_step),
            ("K10", probe_sc3d_model, probe_sc3d_start, sc3d_step)):
        m = make(device=device, n=128, storage="bf16")
        meter = RunMetrics(m.geo.num_fluid_nodes)
        counter.launches = 0
        h = run_chunked(m.step, m.pack_state_bf16(start(m)), num_steps=200,
                        io_interval=100, metrics=meter, nan_guard=True)
        res[f"{tag}_bf16"] = {"launches": counter.launches,
                              "run_mlups": meter.mlups}
        check(counter.launches == 200 and h.dtype == torch.bfloat16,
              f"{tag} bf16 main path: {counter.launches} launches")
    return res


# the kernels a step launches once each, by storage (the libraries'
# counts, kernel_launches): K11 single_push_kernel in f32 (and f64)
# storage, march_kernel in bf16; K10 sc_push_kernel in f32 (and f64)
# storage, rho_kernel and march_kernel in bf16
FLOW3D_STEP_KERNELS = {"K11": {"f32": ("single_push_kernel",),
                               "bf16": ("march_kernel",)},
                       "K10": {"f32": ("sc_push_kernel",),
                               "bf16": ("rho_kernel", "march_kernel")}}
FLOW3D_KERNELS = ("sc_push_kernel", "rho_kernel", "march_kernel",
                  "single_push_kernel")
# least bytes per cell-step: the state in and out plus a 1-byte mask: K11
# f32 2 x 76 + 1, bf16 2 x 42 + 1; K10 with two fluids twice the state
FLOW3D_BYTES = {"K11": {"f32": 2 * 76 + 1, "bf16": 2 * 42 + 1},
                "K10": {"f32": 2 * 152 + 1, "bf16": 2 * 84 + 1}}
# least operations per cell-step (F32_FLOPS_PER_S): K11 SRT with the Guo
# source, K10 with two fluids
FLOW3D_FLOPS = {"K11": D3Q19_SRT_OPS + 6 + 19,
                "K10": 2 * (45 + 82 + 57 + 37 + 8) + 16}


def phase_flow3d_speed(device, sizes=(128, 256), steps=(50, 20),
                       plain_steps=3):
    """MLUPS of K11 (basic3d physics) and K10 (probe_sc3d) in f32 and bf16
    storage at each size and of their plain paths at the first, in turns
    (plain, kernels, kernels, plain), each CUDA kernel's device
    microseconds per launch from torch.profiler, its launches a step by the
    library's own count (exactly one launch a step of each kernel of
    FLOW3D_STEP_KERNELS and none of the others), and the roofline share of
    FLOW3D_BYTES."""
    from openlbmpm_torch.kernels.flow3d import (
        kernel_launches, launch_sc3d, launch_single3d, sc3d_step,
        sc3d_step_reference, single3d_step, single3d_step_reference)
    res = {}
    for tag, make, start, kern, plain, launch in (
            ("K11", basic3d_model, lambda m: flow_start(m, seed=5),
             single3d_step, single3d_step_reference, launch_single3d),
            ("K10", probe_sc3d_model, probe_sc3d_start, sc3d_step,
             sc3d_step_reference, launch_sc3d)):
        for n, k_steps in zip(sizes, steps):
            models = {"f32": make(device=device, n=n),
                      "bf16": make(device=device, n=n, storage="bf16")}
            f = start(models["f32"])
            xs = {"f32": f, "bf16": models["bf16"].pack_state_bf16(f)}
            runs = {st: (lambda x, m=models[st]: kern(x, m), xs[st])
                    for st in models}
            order = list(runs)
            if n == sizes[0]:
                runs |= {f"plain_{st}": (lambda x, m=models[st]: plain(x, m),
                                         xs[st]) for st in models}
                order = ["plain_f32", "plain_bf16"] + order
            sec = {}
            for key in order + order[::-1]:
                fn, x = runs[key]
                t = _time_steps(fn, x, plain_steps if key.startswith("plain")
                                else k_steps, device)
                sec[key] = min(sec.get(key, float("inf")), t)
            profile, launches = {}, {}
            for st, m in models.items():
                want = FLOW3D_STEP_KERNELS[tag][st]
                times = device_times(lambda x, m=m: launch(
                    x, m.kernel_params, m.fluid_u8), xs[st], want, steps=20)
                profile.update({(st, k): v for k, v in times.items()})
                lib = f"flow3d_{st}"
                x, before = xs[st], kernel_launches(lib)
                for _ in range(10):
                    x = kern(x, m)
                torch.cuda.synchronize()
                after = kernel_launches(lib)
                launches[st] = {k: (after[k] - before[k]) / 10 for k in after}
                check(all(v == (k in want) for k, v in launches[st].items()),
                      f"{tag} {st} {n}^3: launches a step " + ", ".join(
                          f"{k} {v:g}" for k, v in launches[st].items()))
            res[(tag, n)] = {
                "sec": sec, "profile": profile, "launches": launches,
                "mlups": {k: n ** 3 / t / 1e6 for k, t in sec.items()},
                "roof": {st: FLOW3D_BYTES[tag][st] * n ** 3 / HBM_BYTES_PER_S
                         / sec[st] for st in ("f32", "bf16")}}
            del models, xs, runs, f
            torch.cuda.empty_cache()
    return res


def phase33_39_lines(r33, r34, r35, r36, r37, r38, r39, card):
    def cmp(r):
        out = [f"{n}^3 f32 {v['f32']:.3e}, bf16 decoded {v['bf16']:.3e}"
               for n, v in r.items() if isinstance(n, int)]
        u = next(v["ulp"] for n, v in r.items() if isinstance(n, int)
                 and "ulp" in v)
        return ("; ".join(out) + f"; bf16 one step {u['excess']:g} ulp, share "
                f"{u['share']:.2e}, round-toward-zero share "
                f"{u['rz_share']:.2e}")
    p = r37["phys"]
    lines = [
        "phase 33 K11 f64 vs plain, 48x40x32 walls + obstacle, 20 steps: "
        "max |diff| " + ", ".join(f"{k} {v:.3e}" for k, v in r33.items()) +
        " (<= 1e-11)",
        f"phase 34 K11 basic3d physics, 10 steps [{card}]: {cmp(r34)} "
        f"(f32 <= {FLOW3D_F32_BOUND['K11']:g}, bf16 <= "
        f"{BF16_BOUND['K11']:g})",
        f"phase 35 K11 plate Poiseuille 4x18x4, 4000 f32 steps [{card}]: " +
        ", ".join(f"{k} {v * 100:.3f}%" for k, v in r35.items()) +
        " of the analytic profile (< 2%)",
        "phase 36 K10 vs plain, 48x40x32, f64 20 steps (<= 1e-11), f32 10 "
        f"steps (<= {FLOW3D_F32_BOUND['K10']:g}): max |diff| " +
        ", ".join(f"{k} {v:.3e}" for k, v in r36.items()),
        f"phase 37 K10 probe_sc3d, 10 steps [{card}]: f64 128^3 "
        f"{r37['f64']:.3e}; {cmp(r37)} (f32 <= {FLOW3D_F32_BOUND['K10']:g}, "
        f"bf16 <= {BF16_BOUND['K10']:g}); physics 1000 f32 steps at 128^3: "
        f"mass drift {p['drift']:.2e} (< 1e-4; f64, 300 steps "
        f"{p['drift64']:.2e}; f32, 100 steps: kernel {p['kernel100']:.2e}, "
        f"plain {p['plain100']:.2e}), rho_0 centre {p['centre']:.4f} "
        f"(> 0.5), far {p['far']:.4f} (< 0.2)"]
    lines.append(
        f"phase 38 cli [{card}]: " + ", ".join(
            f"--model {k} {v['launches']} launches, {v['sec']:.2f} s, "
            f"metrics.jsonl MLUPS {v['mlups']}"
            for k, v in r38.items() if not k.endswith("bf16")) +
        "; bf16 main paths run_chunked 128^3: " + ", ".join(
            f"{k[:3]} {v['launches']} launches, {v['run_mlups']:.1f} MLUPS"
            for k, v in r38.items() if k.endswith("bf16")))
    for (tag, n), r in r39.items():
        sec = r["sec"]
        lines.append(
            f"phase 39 {tag} {n}^3 [{card}]: MLUPS " + ", ".join(
                f"{k} {r['mlups'][k]:.1f} ({sec[k] * 1e3:.4f} ms)"
                for k in sec) + "; bound ms " + ", ".join(
                f"{st} {b * n ** 3 / HBM_BYTES_PER_S * 1e3:.4f}"
                for st, b in FLOW3D_BYTES[tag].items()) +
            "; roofline share " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["roof"].items()) +
            "; device us per launch (launches per step in the trace): " +
            ", ".join(f"{st} {k} " + ("not measured" if v is None else
                                      f"{v[0]:.2f} ({v[1]:g})")
                      for (st, k), v in r["profile"].items()) +
            "; launches a step by the library's count: " + ", ".join(
                f"{st} {k} {v:g}" for st, c in r["launches"].items()
                for k, v in c.items() if v))
    return lines


# -- the Perturbation variant (K4) ------------------------------------------

# ColorGradientParams fields shared by the Perturbation cases: MRT, tau
# 1.0 / 0.8, matched alphas (4/9: equal densities at equal pressure)
PERT_BASE = dict(variant="Perturbation", collision="MRT", tau_r=1.0,
                 tau_b=0.8, beta=0.7, delta=0.98, alpha_r=4 / 9,
                 alpha_b=4 / 9, a_kr=1e-3, a_kb=1e-3, solid_phi=0.5,
                 gradient_type="Isotropic")
_P_NEU_DIR = dict(inlet="neumann", outlet="dirichlet", inlet_velocity=-1e-4,
                  outlet_density_r=0.0, outlet_density_b=1.0)
_P_DIR_CONV = dict(inlet="dirichlet", outlet="convective",
                   inlet_density_r=1.0005, inlet_density_b=2e-3)
_P_PC_CONV = dict(inlet="neumann_per_color", outlet="convective",
                  inlet_velocity_r=-1e-3, inlet_velocity_b=-2e-4)
# name -> (parameter changes, boundary fields, initial condition, steps) of
# phase 40 (and tests/test_torch_pert.py): both collisions and gradient
# weights, the Neumann/Dirichlet, per-colour Dirichlet/convective and
# per-colour velocity/convective rows (split only), a periodic droplet,
# unequal strengths, and unequal alphas (which put the phases at unequal
# pressure: one step)
PERT_CASES = {
    "mrt_iso_neumann_dirichlet": ({}, _P_NEU_DIR, "layers", 20),
    "srt_iso_neumann_dirichlet": ({"collision": "SRT"}, _P_NEU_DIR,
                                  "layers", 20),
    "mrt_aniso_dirichlet_convective": ({"gradient_type": "Anisotropic"},
                                       _P_DIR_CONV, "layers", 20),
    "srt_aniso_percolor_convective": (
        {"collision": "SRT", "gradient_type": "Anisotropic"}, _P_PC_CONV,
        "layers", 20),
    "mrt_periodic_droplet": ({"a_kr": 5e-3, "a_kb": 5e-3}, {}, "droplet",
                             20),
    "srt_akr_ne_akb": ({"collision": "SRT", "a_kr": 2e-3, "a_kb": 5e-4},
                       _P_NEU_DIR, "layers", 20),
    "mrt_alpha_r_ne_alpha_b": ({"alpha_b": 0.3}, _P_NEU_DIR, "layers", 1),
}


def pert_fields(name):
    """(ColorGradientParams fields, CGBoundaryConfig fields) of a case of
    PERT_CASES."""
    change, bcs, _, _ = PERT_CASES[name]
    return PERT_BASE | change, dict(bcs)


def pert_start(m, kind):
    """The split start of a Perturbation case: red layers on top (a fifth
    of the rows), or a red droplet of radius ny/8 in blue."""
    if kind == "layers":
        return m.init_state_layers(1.0, 1.0, invading_rows=m.geo.ny // 5)
    return m.init_state_droplet(1.0, 1.0, radius=m.geo.ny / 8)


def pert_case(name, device, ny=256, nx=128, dtype=torch.float64,
              storage="f32"):
    """The model of a case of PERT_CASES on a walled ny x nx channel."""
    from openlbmpm_torch.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
    pf, bf = pert_fields(name)
    return ColorGradientRK(walled(ny, nx), ColorGradientParams(**pf),
                           CGBoundaryConfig(**bf), dtype=dtype,
                           device=device, storage=storage)


def state_gap(a, b) -> float:
    """max |a - b| over a state: one tensor or a tuple of them."""
    if isinstance(a, tuple):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))
    return float((a - b).abs().max())


def pert_flagship_flow():
    """bench.py's flagship flow (bench.py:78-90) as the Perturbation
    variant: MRT, tau 1.0 / 1.0, beta 0.7, delta 0.98, alphas 4/9, A_R = A_B
    = 1e-4, solid_phi 0.5, isotropic weights; Neumann inlet at v = -1e-4,
    Dirichlet outlet (rho_b = 1) with the phi repair.  Returns
    (ColorGradientParams, CGBoundaryConfig)."""
    from openlbmpm_torch.models.colorgradient import ColorGradientParams
    params = ColorGradientParams(**(PERT_BASE | {"tau_b": 1.0, "a_kr": 1e-4,
                                                "a_kb": 1e-4}))
    return params, flagship_flow()[1]


def pert_flagship_model(device, storage="f32", dtype=torch.float32,
                        n=FLAGSHIP_N):
    """The Perturbation flagship flow on an n x n walled channel."""
    from openlbmpm_torch.models.colorgradient import ColorGradientRK
    return ColorGradientRK(walled(n, n), *pert_flagship_flow(), dtype=dtype,
                           device=device, storage=storage)


def phase_pert_f64(device, ny=256, nx=128, tol=1e-11):
    """K4c and K4s against their plain steps at f64 on a walled 256x128
    channel, each case of PERT_CASES for its steps (the compressed layout
    refuses the per-colour velocity inlet), and K6 with that inlet."""
    import dataclasses
    from openlbmpm_torch.kernels.csf import (
        csf_step_split, csf_step_split_reference, pert_step_compressed,
        pert_step_compressed_reference, pert_step_split,
        pert_step_split_reference)
    from openlbmpm_torch.models.colorgradient import ColorGradientRK
    out = {}
    for name, (_, bcs, kind, steps) in PERT_CASES.items():
        m = pert_case(name, device, ny, nx)
        st = pert_start(m, kind)
        runs = [("split", st, pert_step_split, pert_step_split_reference)]
        if bcs.get("inlet") != "neumann_per_color":
            runs.append(("compressed", m.pack_state(*st),
                         pert_step_compressed,
                         pert_step_compressed_reference))
        for layout, x, kern, plain in runs:
            a = b = x
            err = 0.0
            for _ in range(steps):
                a, b = kern(a, m), plain(b, m)
                err = max(err, state_gap(a, b))
            check(all(bool(torch.isfinite(t).all()) for t in
                      (a if layout == "split" else (a,))),
                  f"pert f64 {name} {layout}: state not finite")
            check(err <= tol, f"pert f64 {name} {layout}: kernel vs plain "
                  f"{err:.3e} > {tol:g}")
            out[(name, layout)] = err
    params, bcs = split_cases()["mrt_dirichlet_convective"]
    m = ColorGradientRK(walled(ny, nx), params, dataclasses.replace(
        bcs, inlet="neumann_per_color", inlet_velocity_r=-1e-3,
        inlet_velocity_b=-2e-4), dtype=torch.float64, device=device)
    a = b = m.init_state_layers(1.0, 1.0, invading_rows=ny // 5)
    err = 0.0
    for _ in range(20):
        a = csf_step_split(a, m)
        b = csf_step_split_reference(b, m)
        err = max(err, state_gap(a, b))
    check(err <= tol, f"K6 neumann_per_color f64: kernel vs plain {err:.3e} "
          f"> {tol:g}")
    out[("K6 neumann_per_color", "split")] = err
    return out


# the pert flagship's kernel-vs-plain bounds (PDF planes, rho_r) off the
# seam rows and corners after 10 steps: f32 about 10x the gaps measured on
# an H100 (K4c 1.8e-7 / 4.8e-7, K4s 1.5e-7 / 3.0e-7); bf16 as phase 4
PERT_BOUNDS = {"f32": (2e-6, 5e-6), "split": (2e-6, 3e-6),
               "bf16": (3e-4, 1e-4)}


def phase_pert_flagship(device, n=FLAGSHIP_N, steps=10):
    """Kernel vs plain at the pert flagship: f64 (K4c and K4s, <= 1e-11),
    then from the same f64 start K4c in f32, K4s in f32 and K4h in bf16
    storage, held off the seam rows and corners (seam_masks) to
    PERT_BOUNDS, no further from the f64 plain run than max(1.5x the plain
    path, the bound), total rho_r within 1e-4 of the plain path; then one
    more bf16 step from a common state within one ulp a value
    (``bf16_one_step``)."""
    from openlbmpm_torch.kernels.csf import (
        pert_step_compressed, pert_step_compressed_reference, pert_step_split,
        pert_step_split_reference)
    res = {}
    m64 = pert_flagship_model(device, dtype=torch.float64, n=n)
    st64 = m64.init_state_layers(1.0, 1.0, invading_rows=100 * n // 1024)
    s64 = m64.pack_state(*st64)
    p64 = _steps(lambda x: pert_step_compressed_reference(x, m64), s64, steps)
    k64 = _steps(lambda x: pert_step_compressed(x, m64), s64, steps)
    ps64 = _steps(lambda x: pert_step_split_reference(x, m64), st64, steps)
    ks64 = _steps(lambda x: pert_step_split(x, m64), st64, steps)
    res["f64"] = max(float((k64 - p64).abs().max()),
                     *(float((a - b).abs().max()) for a, b in zip(ks64, ps64)))
    check(res["f64"] <= 1e-11, f"pert f64 kernel vs plain {res['f64']:.3e} "
          "> 1e-11")
    away = seam_masks(n, n, steps, device)
    split_ref = m64.pack_state(*ps64)
    for key in ("f32", "split", "bf16"):
        m = pert_flagship_model(device, "bf16" if key == "bf16" else "f32",
                                n=n)
        if key == "split":
            x0 = tuple(t.float() for t in st64)
            a = m.pack_state(*_steps(lambda x: pert_step_split(x, m), x0,
                                     steps))
            b = m.pack_state(*_steps(lambda x: pert_step_split_reference(
                x, m), x0, steps))
            ref = split_ref
        else:
            x0 = s64.float() if key == "f32" else \
                m.pack_compressed_bf16(s64.float())
            a = _steps(lambda x: pert_step_compressed(x, m), x0, steps)
            b = _steps(lambda x: pert_step_compressed_reference(x, m), x0,
                       steps)
            ref = p64
            if key == "bf16":
                res["ulp"] = bf16_one_step(m, b, away, pert_step_compressed)
                a, b = m.unpack_bf16(a), m.unpack_bf16(b)
        check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
              f"pert {key}: state not finite")
        d = (a - b).abs()
        planes, rho_r = float(d[:9, away].max()), float(d[9, away].max())
        acc_k = float((a.double() - ref).abs().max())
        acc_p = float((b.double() - ref).abs().max())
        bp, br = PERT_BOUNDS[key]
        check(planes <= bp and rho_r <= br, f"pert {key} off the seam: "
              f"planes {planes:.3e} (<= {bp:g}), rho_r {rho_r:.3e} "
              f"(<= {br:g})")
        check(acc_k <= max(1.5 * acc_p, bp), f"pert {key}: kernel "
              f"{acc_k:.3e} from f64, the plain path {acc_p:.3e}")
        tot_k, tot_p = (float(x[9].double().sum()) for x in (a, b))
        drift = abs(tot_k - tot_p) / tot_p
        check(drift <= 1e-4, f"pert {key}: total rho_r kernel vs plain "
              f"{drift:.2e}")
        res[key] = {"max": float(d.max()), "planes": planes, "rho_r": rho_r,
                    "from_f64": (acc_k, acc_p), "mass": drift}
    return res


def phase_pert_physics(device, n=FLAGSHIP_N, laplace_steps=2000,
                       steps=1000, rate_tol=0.05):
    """Physics through K4: the Laplace droplet of
    tests/test_colorgradient.py::test_laplace_law_perturbation_variant
    (64^2 periodic, SRT, alphas 4/9, A = 0.005, radius 14, 2000 steps) on
    K4s in f32 and f64: the droplet stays whole (phi > 0.9 on > 300 cells,
    < -0.9 on > 2000) and the pressure inside exceeds the pressure outside.
    Then the pert flagship for `steps` f32 steps of
    ``run_chunked(model.step_c)`` (K4c, the launches counted): finite, its
    red mass growing by |v_in| x (fluid inlet columns) a step within
    `rate_tol`; the plain path's rate is read over the same steps."""
    from openlbmpm_torch import geometry
    from openlbmpm_torch.kernels.csf import (
        pert_step_compressed, pert_step_compressed_reference)
    from openlbmpm_torch.models.base import run_chunked
    from openlbmpm_torch.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
    res = {}
    g = geometry.from_solid_mask(np.zeros((64, 64), bool))
    p = ColorGradientParams(**(PERT_BASE | {
        "collision": "SRT", "tau_b": 1.0, "a_kr": 0.005, "a_kb": 0.005}))
    for dt in (torch.float32, torch.float64):
        m = ColorGradientRK(g, p, CGBoundaryConfig(), dtype=dt, device=device)
        check(m.path == "kernel", "laplace droplet: not on the kernel")
        st = run_chunked(m.step, m.init_state_droplet(1.0, 1.0, radius=14.0),
                         num_steps=laplace_steps, io_interval=laplace_steps,
                         nan_guard=True)
        rho_r, rho_b, phi, _ = m.macro(st)
        rho = rho_r + rho_b
        inside, outside = int((phi > 0.9).sum()), int((phi < -0.9).sum())
        dp = float((rho[phi > 0.8].mean() - rho[phi < -0.8].mean()) / 3.0)
        check(inside > 300 and outside > 2000 and dp > 0,
              f"laplace droplet {dt}: phi > 0.9 on {inside}, < -0.9 on "
              f"{outside}, dp {dp:.3e}")
        res[str(dt).split(".")[-1]] = (inside, outside, dp)
    m = pert_flagship_model(device, n=n)
    s0 = m.pack_state(*m.init_state_layers(1.0, 1.0,
                                           invading_rows=100 * n // 1024))
    cols = int(m.is_fluid[n - 2].sum())
    want = abs(m.bcs.inlet_velocity) * cols
    pert_step_compressed.launches = 0
    counts = cg2d_counts("pert2d")
    s = run_chunked(m.step_c, s0, num_steps=steps, io_interval=steps,
                    nan_guard=True)
    res["launches_f32"] = pert_step_compressed.launches
    res["per_step"] = cg2d_launches_a_step("pert2d", counts, steps,
                                           "K4c flagship f32")
    check(res["launches_f32"] == steps, f"pert flagship f32: "
          f"{res['launches_f32']} K4c launches, want {steps}")
    check(bool(torch.isfinite(s).all()), "pert flagship f32: not finite")
    def red(x):
        return float(x[9].double().sum())
    rate = (red(s) - red(s0)) / steps
    b = _steps(lambda x: pert_step_compressed_reference(x, m), s0, steps)
    rate_p = (red(b) - red(s0)) / steps
    res["rate"] = (rate, rate_p, want)
    check(abs(rate / want - 1) <= rate_tol, f"pert flagship: red mass "
          f"{rate:.6g} a step, |v| x {cols} columns = {want:.6g} "
          f"(plain path {rate_p:.6g})")
    return res


def phase_pert_main(device, n=FLAGSHIP_N, steps=MAIN_STEPS, cli_steps=1000):
    """The main paths: ``run_chunked(model.step_c)`` on the pert flagship
    for `steps` bf16 steps (K4h once a step), then ``run --model cg`` on
    configs/rk_csf2d.ini at n^2 with SurfaceTensionType 'Perturbation'
    (K4s once a step; the checkpoint a finite split state), then a short
    run of that INI with the averaged convective outlet (path "plain", no
    launch)."""
    import contextlib
    import io
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.checkpoint import load_checkpoint
    from openlbmpm_torch.kernels.csf import (
        pert_step_compressed, pert_step_split)
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    res = {}
    m = pert_flagship_model(device, "bf16", n=n)
    s = m.pack_state_bf16(*m.init_state_layers(
        1.0, 1.0, invading_rows=100 * n // 1024))
    meter = RunMetrics(n * n)
    pert_step_compressed.launches = 0
    counts = cg2d_counts("pert2d")
    s = run_chunked(m.step_c, s, num_steps=steps, io_interval=500,
                    metrics=meter, nan_guard=True)
    res["launches_bf16"] = pert_step_compressed.launches
    res["per_step"] = cg2d_launches_a_step("pert2d", counts, steps,
                                           "K4h main path")
    res["run_mlups"] = meter.mlups
    check(res["launches_bf16"] == steps and s.dtype == torch.bfloat16 and
          bool(torch.isfinite(m.unpack_bf16(s)).all()),
          f"pert bf16 main path: {res['launches_bf16']} launches, want "
          f"{steps}")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ini = os.path.join(tmp, "pert.ini")
        _ini_copy(os.path.join(root, "configs", "rk_csf2d.ini"), ini, {
            "xDomain": n, "yDomain": n, "TimeInterval": 500,
            "SurfaceTensionType": "'Perturbation'"})
        out = os.path.join(tmp, "cg")
        pert_step_split.launches = 0
        counts = cg2d_counts("pert2d")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = cli.main(["run", ini, "--model", "cg", "--steps",
                           str(cli_steps), "--output", out, "--device",
                           device.type, "--block", "1"])
        res["cli_sec"] = time.perf_counter() - t0
        res["cli_launches"] = pert_step_split.launches
        res["cli_per_step"] = cg2d_launches_a_step(
            "pert2d", counts, cli_steps, "cli pert (K4s)")
        check(rc == 0 and "variant Perturbation" in text.getvalue() and
              "the kernel step" in text.getvalue(),
              f"cli pert: rc {rc}, {text.getvalue()[:300]}")
        check(res["cli_launches"] == cli_steps, f"cli pert: K4s launched "
              f"{res['cli_launches']} times, want {cli_steps}")
        with np.load(os.path.join(out, "checkpoint.npz")) as z:
            shapes = [z[f"leaf{i}"].shape for i in range(2)]
        like = tuple(torch.zeros(sh, device=device) for sh in shapes)
        (f_r, f_b), step = load_checkpoint(os.path.join(out, "checkpoint.npz"),
                                           like)
        check(step == cli_steps and f_r.shape[0] == 9 and
              bool(torch.isfinite(f_r).all() and torch.isfinite(f_b).all()),
              f"cli pert: checkpoint at step {step} not a finite split state")
        res["cli_mlups"] = _mlups(os.path.join(out, "metrics.jsonl"))
        res["cli_shape"] = tuple(f_r.shape[1:])
        _ini_copy(ini, ini, {"BoundaryTypeOutlet": "'AverageConvective'",
                             "TimeInterval": 10})
        before = (pert_step_split.launches, pert_step_compressed.launches)
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = cli.main(["run", ini, "--model", "cg", "--steps", "10",
                           "--output", os.path.join(tmp, "avg"), "--device",
                           device.type])
        line = next(ln for ln in text.getvalue().splitlines()
                    if "--model cg" in ln)
        check(rc == 0 and f"the plain step on {device.type}" in line and
              (pert_step_split.launches, pert_step_compressed.launches) ==
              before, f"cli pert AverageConvective: rc {rc}, {line}")
        res["avg_line"] = line
    return res


# Least bytes per cell-step of K4 (as KERNEL_BYTES): the state in and out
# plus a 1-byte solid mask
PERT_BYTES = {"f32": 2 * 40 + 1, "bf16": 2 * 22 + 1, "split": 2 * 72 + 1}
# least operations per cell-step (F32_FLOPS_PER_S), the compressed layout's
# for all three (the split layout relaxes and perturbs two colours: more)
PERT_FLOPS = {"f32": PERT_OPS, "bf16": PERT_OPS, "split": PERT_OPS}


def phase_pert_speed(device, n=FLAGSHIP_N, kernel_steps=500, plain_steps=20):
    """MLUPS of K4c (f32), K4h (bf16) and K4s (split f32) and of their plain
    paths at the pert flagship (CUDA events, plain, kernel, kernel, plain,
    best of each), each kernel's device time per launch (torch.profiler),
    and the roofline share from PERT_BYTES."""
    from openlbmpm_torch.kernels.csf import (
        launch_csf2d, launch_csf2d_split, pert_step_compressed,
        pert_step_compressed_reference, pert_step_split,
        pert_step_split_reference)
    res = {"sec": {}, "profile": {}}
    for key in ("f32", "bf16", "split"):
        m = pert_flagship_model(device, "bf16" if key == "bf16" else "f32",
                                n=n)
        st = m.init_state_layers(1.0, 1.0, invading_rows=100 * n // 1024)
        if key == "split":
            kern = lambda x, m=m: pert_step_split(x, m)  # noqa: E731
            plain = lambda x, m=m: pert_step_split_reference(x, m)  # noqa
            launch = lambda x, m=m: launch_csf2d_split(  # noqa: E731
                *x, m.kernel_params, m.geo_planes, "pert2d")
            x = st
        else:
            kern = lambda x, m=m: pert_step_compressed(x, m)  # noqa: E731
            plain = lambda x, m=m: pert_step_compressed_reference(  # noqa
                x, m)
            launch = lambda x, m=m: launch_csf2d(  # noqa: E731
                x, m.kernel_params, m.geo_planes, "pert2d")
            x = m.pack_state_bf16(*st) if key == "bf16" else m.pack_state(*st)
        best = time_pair(kern, plain, x, kernel_steps, plain_steps, device)
        res["sec"][key] = best["kernel"]
        res["sec"][f"plain_{key}"] = best["plain"]
        res["profile"][key] = device_times(launch, x, (
            "pert_strip_kernel",))["pert_strip_kernel"]
    res["mlups"] = {k: n * n / v / 1e6 for k, v in res["sec"].items()}
    res["roof"] = {k: PERT_BYTES[k] * n * n / HBM_BYTES_PER_S /
                   res["sec"][k] for k in PERT_BYTES}
    return res


def phase40_44_lines(r40, r41, r42, r43, r44, card, n=FLAGSHIP_N):
    def gaps(r):
        return (f"planes {r['planes']:.3e}, rho_r {r['rho_r']:.3e}, max "
                f"{r['max']:.3e}; from f64 kernel {r['from_f64'][0]:.3e} vs "
                f"plain {r['from_f64'][1]:.3e}; total rho_r {r['mass']:.2e}")
    u = r41["ulp"]
    rate, rate_p, want = r42["rate"]
    cells = r43["cli_shape"][0] * r43["cli_shape"][1]
    bound = {k: b * n * n / HBM_BYTES_PER_S * 1e3
             for k, b in PERT_BYTES.items()}
    return [
        "phase 40 K4 f64 kernel vs plain, 256x128, max |diff|: " + ", ".join(
            f"{k} {lay} {v:.3e}" for (k, lay), v in r40.items()) +
        " (<= 1e-11)",
        f"phase 41 pert flagship {n}^2, 10 steps [{card}]: f64 K4c/K4s "
        f"{r41['f64']:.3e} (<= 1e-11); off the seam rows and corners: "
        + "; ".join(f"{k} ({PERT_BOUNDS[k][0]:g} / {PERT_BOUNDS[k][1]:g}) "
                    f"{gaps(r41[k])}" for k in ("f32", "split", "bf16")) +
        f"; bf16 one more step: largest gap {u['excess']:.3g} ulp, "
        f"{u['share']:.3e} of values >= 1e-4 differ, {u['hi_flips']} rho_r "
        f"hi flips; round-toward-zero {u['rz_share']:.3e}, dropped lo "
        f"{u['no_lo_excess']:.3g} ulp",
        "phase 42 laplace droplet on K4s, 2000 steps (phi > 0.9 cells, "
        "phi < -0.9 cells, dp): " + ", ".join(
            f"{k} {v[0]}, {v[1]}, {v[2]:.4e}" for k, v in r42.items()
            if k in ("float32", "float64")) +
        f"; pert flagship 1000 f32 steps on K4c ({r42['launches_f32']} "
        f"launches; the library's count a step: "
        f"{_fmt_counts(r42['per_step'])}): red mass {rate:.6g} a step (plain {rate_p:.6g}), "
        f"|v_in| x columns {want:.6g}, ratio {rate / want:.4f} [{card}]",
        f"phase 43 main path: run_chunked(step_c) {MAIN_STEPS} bf16 steps, "
        f"{r43['launches_bf16']} K4h launches (the library's count a step: "
        f"{_fmt_counts(r43['per_step'])}), {r43['run_mlups']:.1f} MLUPS "
        f"incl. host loop; cli run --model cg Perturbation "
        f"{r43['cli_shape'][0]}x{r43['cli_shape'][1]} ({cells} cells), 1000 "
        f"f32 steps: {r43['cli_launches']} K4s launches ("
        f"{_fmt_counts(r43['cli_per_step'])}), "
        f"{r43['cli_sec']:.2f} s with I/O, metrics.jsonl MLUPS "
        f"{r43['cli_mlups']}; AverageConvective: {r43['avg_line']} [{card}]",
        f"phase 44 K4 {n}^2 [{card}]: MLUPS (ms a step) " + ", ".join(
            f"{k} {r44['mlups'][k]:.1f} ({r44['sec'][k] * 1e3:.4f})"
            for k in r44["sec"]) + "; bound ms " + ", ".join(
            f"{k} {v:.4f}" for k, v in bound.items()) +
        "; roofline share " + ", ".join(
            f"{k} {v:.3f}" for k, v in r44["roof"].items()) +
        "; device us per launch (launches per step): " + ", ".join(
            f"{k} " + ("not measured" if v is None else
                       f"{v[0]:.2f} ({v[1]:g})")
            for k, v in r44["profile"].items())]


# kernels whose first integer template argument is the state layout
LAYOUT_KERNELS = ("collide_stream_kernel", "tracer_strip_kernel",
                  "bc_kernel", "strip_kernel", "pert_strip_kernel")


def ptxas_summary(log: str, sc: bool = False) -> str:
    """'kernel<type[,q]>: registers, smem, spill stores' per entry function
    of an `nvcc -Xptxas -v` log; for an sc2d, single2d or flow3d library
    (one storage type each) the kernel's integer template arguments as they
    are: 'kernel<K,order>' (K8), 'kernel<collision,force>' (K7),
    'kernel<mode,K>' (K11, K10)."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = m.group(1)
            base = next((k for k in ("pert_strip_kernel",) +
                         COUPLED_KERNELS + SC_KERNELS +
                         TRANSPORT3D_KERNELS + ("single3d_march_kernel",
                                                "sc3d_march_kernel") +
                         FLOW3D_KERNELS +
                         tuple(BLOCK_KERNEL_NAMES.values()) +
                         MARCH2D_KERNEL_NAMES +
                         ("bc_rows_kernel",) if k in mangled),
                        mangled)
            args = mangled.split(base)[-1]
            kind = ("bf16" if "bfloat16" in mangled else
                    "f64" if re.search(r"I[^E]*d", args) else "f32")
            ints = re.findall(r"L[ib](\d+)E" if sc else r"Li(\d+)E", args)
            split = not sc and base in LAYOUT_KERNELS and ints and \
                ints.pop(0) == "1"
            name = (f"{base}<{','.join(ints)}>" if sc else
                    f"{base}<{kind}{',split' if split else ''}"
                    f"{',q' + ints[0] if ints else ''}>")
            spill = "?"
        elif name and "spill stores" in ln:
            spill = ln.split(",")[1].strip()
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name} {regs} regs, "
                       f"{smem.group(1) if smem else 0} B smem, {spill}")
            name = None
    return " | ".join(out)


# -- the T-step (temporally blocked) 2-D kernels: K3, K8-T, K7-T -----------

BLOCK_TS = (2, 3, 4)
# domains of phase 45: a periodic droplet, the flagship's rows and the
# Dirichlet inlet / convective outlet on walled channels whose ny (100) is no
# multiple of any tile height (the window wraps the last tile), and the
# CLI's rk_csf2d.ini (1044 x 1024 with its buffer rows)
K3_DOMAINS = ("periodic_96x64", "neumann_dirichlet_100x72",
              "dirichlet_convective_100x72", "cli_rk_csf2d")


def k3_wrappers(variant, key):
    """(kernel wrapper, plain version) of K3 for a variant and a layout key:
    "f32" / "bf16" (compressed), "split"."""
    from openlbmpm_torch.kernels import csf as k
    pre = "csf" if variant == "CSF" else "pert"
    lay = "split" if key == "split" else "compressed"
    return (getattr(k, f"{pre}_block_{lay}"),
            getattr(k, f"{pre}_block_{lay}_reference"))


def cli_cg_config(variant, n=FLAGSHIP_N):
    """(params, boundaries, geometry, invading rows) that ``run --model cg``
    builds from configs/rk_csf2d.ini at n x n, as the CSF or the
    Perturbation variant."""
    import os
    import tempfile
    from openlbmpm_torch.cli import _build_geometry
    from openlbmpm_torch.config import load_colorgradient
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ini = os.path.join(tmp, "rk_csf2d.ini")
        _ini_copy(os.path.join(root, "configs", "rk_csf2d.ini"), ini, {
            "xDomain": n, "yDomain": n, "SurfaceTensionType": f"'{variant}'"})
        params, bcs, domain, _ = load_colorgradient(ini)
    return params, bcs, _build_geometry(domain), max(domain.buffer_layers, 10)


def k3_case(name, variant, device, dtype=torch.float64):
    """A K3_DOMAINS model of the variant and its split start."""
    import dataclasses
    from openlbmpm_torch.geometry import from_solid_mask
    from openlbmpm_torch.models.colorgradient import (
        CGBoundaryConfig, ColorGradientParams, ColorGradientRK)
    if name == "cli_rk_csf2d":
        params, bcs, g, rows = cli_cg_config(variant)
        m = ColorGradientRK(g, params, bcs, dtype=dtype, device=device)
        return m, m.init_state_layers(1.0, 1.0, invading_rows=rows)
    if variant == "CSF":
        params = flagship_flow()[0]
        params = dataclasses.replace(params, tau_b=0.8, surface_tension=0.01)
    else:
        params = ColorGradientParams(**PERT_BASE)
    if name == "periodic_96x64":
        m = ColorGradientRK(from_solid_mask(np.zeros((96, 64), bool)), params,
                            dtype=dtype, device=device)
        return m, m.init_state_droplet(1.0, 1.0, radius=16.0)
    bcs = _P_NEU_DIR if name.startswith("neumann") else _P_DIR_CONV
    m = ColorGradientRK(walled(100, 72), params, CGBoundaryConfig(**bcs),
                        dtype=dtype, device=device)
    return m, m.init_state_layers(1.0, 1.0, invading_rows=20)


def _gap(a, b) -> float:
    if isinstance(a, tuple):
        return max(_gap(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def phase_block_csf_f64(device, calls=2, tol=1e-11):
    """K3 against T plain steps at f64, both variants, T = 2, 3, 4 (and for
    the Perturbation variant 10 and 16, past its launch limit of 15 with
    boundary rows: ``build.split_steps``'s launches), two calls in a row:
    compressed (K3c) and split (K3s) on the small domains of K3_DOMAINS,
    split (the state the CLI runs) on the CLI's."""
    res = {}
    for variant in ("CSF", "Perturbation"):
        for name in K3_DOMAINS:
            m, st = k3_case(name, variant, device)
            for key in ("split",) if name.startswith("cli") else \
                    ("f32", "split"):
                kern, plain = k3_wrappers(variant, key)
                x0 = st if key == "split" else m.pack_state(*st)
                ts = BLOCK_TS + (CHUNKED_TS if variant == "Perturbation" and
                                 not name.startswith("cli") else ())
                for t in ts:
                    a = _steps(lambda x: kern(x, m, t), x0, calls)
                    b = _steps(lambda x: plain(x, m, t), x0, calls)
                    err = _gap(a, b)
                    check(err <= tol, f"K3 {variant} {key} {name} T={t}: "
                          f"kernel vs {t} plain steps {err:.3e} > {tol:g}")
                    res[(variant, key, name, t)] = err
                if name == "neumann_dirichlet_100x72" and key == "f32":
                    from openlbmpm_torch.kernels import csf as kc
                    note_layout(45, f"{variant} {name}", kc.csf_block_tiling(
                        torch.float64, False, m.kernel_params, 4))
            del m, st
            torch.cuda.empty_cache()
    # Xu wetting on a porous mask (the march's phi extension onto solids)
    m, st = xu_porous_model(device)
    for key in ("f32", "split"):
        kern, plain = k3_wrappers("CSF", key)
        x0 = st if key == "split" else m.pack_state(*st)
        for t in BLOCK_TS:
            err = _gap(_steps(lambda x: kern(x, m, t), x0, calls),
                       _steps(lambda x: plain(x, m, t), x0, calls))
            check(err <= tol, f"K3 CSF {key} xu_porous_96x64 T={t}: kernel "
                  f"vs {t} plain steps {err:.3e} > {tol:g}")
            res[("CSF", key, "xu_porous_96x64", t)] = err
    return res


def phase_block_sc_f64(device, calls=2, tol=1e-11):
    """K8-T against T plain steps at f64 on every kernel case of SC_CASES
    (periodic and channel rows, SC and EFS iso-4/8/10, SRT and MRT, psi =
    rho and Peng-Robinson, K = 1, 2, 3) on a 100 x 64 channel, T = 2, 3,
    4, two calls in a row."""
    from openlbmpm_torch.kernels.shanchen import (sc_block_step,
                                                  sc_block_step_reference)
    res = {}
    for name in SC_KERNEL_CASES:
        m, f = sc_case(name, device, ny=100, nx=64)
        for t in BLOCK_TS:
            err = _gap(_steps(lambda x: sc_block_step(x, m, t), f, calls),
                       _steps(lambda x: sc_block_step_reference(x, m, t), f,
                              calls))
            check(err <= tol, f"K8-T {name} T={t}: kernel vs {t} plain steps "
                  f"{err:.3e} > {tol:g}")
            res[(name, t)] = err
        if 46 not in LAYOUTS:
            from openlbmpm_torch.kernels.shanchen import sc_block_tiling
            note_layout(46, name, sc_block_tiling(torch.float64,
                                                  m.kernel_params, 4))
    return res


def phase_block_single_f64(device, calls=2, tol=1e-11):
    """K7-T against T plain steps at f64 on every case of SINGLE_CASES
    (SRT/TRT/MRT with the body force; Zou-He, pressure/convective and
    periodic rows) on a 100 x 72 channel, T = 2, 3, 4, two calls in a row."""
    from openlbmpm_torch.kernels.single import (single_block_step,
                                                single_block_step_reference)
    res = {}
    for name in SINGLE_CASES:
        m = single_case(name, device, ny=100, nx=72)
        f = flow_start(m)
        for t in BLOCK_TS:
            err = _gap(_steps(lambda x: single_block_step(x, m, t), f, calls),
                       _steps(lambda x: single_block_step_reference(x, m, t),
                              f, calls))
            check(err <= tol, f"K7-T {name} T={t}: kernel vs {t} plain steps "
                  f"{err:.3e} > {tol:g}")
            res[(name, t)] = err
        if 47 not in LAYOUTS:
            from openlbmpm_torch.kernels.single import single_block_tiling
            note_layout(47, name, single_block_tiling(torch.float64,
                                                      m.kernel_params, 4))
    return res


# the T=1 phases' bounds (planes, rho_r), off the seam rows and corners:
# phase 4 (K1, K2), phase 14 (K6), phase 41 (K4c, K4h, K4s)
K3_BOUNDS = {("CSF", "f32"): (3e-5, 3e-5), ("CSF", "split"): (3e-5, 3e-5),
             ("CSF", "bf16"): (3e-4, 1e-4)} | {
    ("Perturbation", k): v for k, v in PERT_BOUNDS.items()}


def phase_block_full(device, n=FLAGSHIP_N, steps=8):
    """The T-step kernels at full size against their plain versions, T = 2
    and 4, `steps` steps from one f64 start: K3c, K3s (f32) and K3h (bf16
    storage, decoded once and encoded once a call by kernel and plain
    version alike) of both flagships, held off the seam rows and corners to
    K3_BOUNDS; K8-T at configs 2 and 3 in f32 and bf16 (SC_BOUNDS); K7-T at
    config 1 in f32 and bf16 (SINGLE_F32_BOUND, BF16_BOUND["K7"])."""
    from openlbmpm_torch.kernels.shanchen import (sc_block_step,
                                                  sc_block_step_reference)
    from openlbmpm_torch.kernels.single import (single_block_step,
                                                single_block_step_reference)
    res = {}
    away = seam_masks(n, n, steps, device)
    for variant, make in (("CSF", flagship_model),
                          ("Perturbation", pert_flagship_model)):
        st64 = make(device, "f32", dtype=torch.float64, n=n).init_state_layers(
            1.0, 1.0, invading_rows=100 * n // 1024)
        for key in ("f32", "split", "bf16"):
            m = make(device, "bf16" if key == "bf16" else "f32", n=n)
            kern, plain = k3_wrappers(variant, key)
            x0 = tuple(t.float() for t in st64) if key == "split" else \
                m.pack_state(*st64).float()
            if key == "bf16":
                x0 = m.pack_compressed_bf16(x0)
            for t in (2, 4):
                a = _steps(lambda x: kern(x, m, t), x0, steps // t)
                b = _steps(lambda x: plain(x, m, t), x0, steps // t)
                if key == "split":
                    a, b = m.pack_state(*a), m.pack_state(*b)
                if key == "bf16":
                    a, b = m.unpack_bf16(a), m.unpack_bf16(b)
                check(bool(torch.isfinite(a).all()), f"K3 {variant} {key} "
                      f"T={t}: state not finite")
                d = (a - b).abs()
                planes = float(d[:9, away].max())
                rho_r = float(d[9, away].max())
                bp, br = K3_BOUNDS[(variant, key)]
                check(planes <= bp and rho_r <= br, f"K3 {variant} {key} "
                      f"T={t} off the seam: planes {planes:.3e} (<= {bp:g}), "
                      f"rho_r {rho_r:.3e} (<= {br:g})")
                res[("K3", variant, key, t)] = {
                    "max": float(d.max()), "planes": planes, "rho_r": rho_r}
            del m
            torch.cuda.empty_cache()
    for name in ("config2", "config3"):
        m64, s64 = sc_config(name, device, dtype=torch.float64, n=n)
        for st in ("f32", "bf16"):
            m = sc_config(name, device, storage=st, n=n)[0]
            x0 = s64.float() if st == "f32" else m.pack_state_bf16(s64.float())
            for t in (2, 4):
                a = _steps(lambda x: sc_block_step(x, m, t), x0, steps // t)
                b = _steps(lambda x: sc_block_step_reference(x, m, t), x0,
                           steps // t)
                if st == "bf16":
                    a, b = m.unpack_bf16(a), m.unpack_bf16(b)
                gap = _gap(a, b)
                check(bool(torch.isfinite(a).all()) and gap <= SC_BOUNDS[st],
                      f"K8-T {name} {st} T={t}: kernel vs plain {gap:.3e} "
                      f"(<= {SC_BOUNDS[st]:g})")
                res[("K8-T", name, st, t)] = gap
        del m64, s64
    m64 = config1_model(device, dtype=torch.float64)
    f64 = flow_start(m64, seed=11)
    for st, bound in (("f32", SINGLE_F32_BOUND), ("bf16", BF16_BOUND["K7"])):
        m = config1_model(device, storage=st)
        x0 = f64.float() if st == "f32" else m.pack_state_bf16(f64.float())
        for t in (2, 4):
            a = _steps(lambda x: single_block_step(x, m, t), x0, steps // t)
            b = _steps(lambda x: single_block_step_reference(x, m, t), x0,
                       steps // t)
            if st == "bf16":
                a, b = m.unpack_bf16(a), m.unpack_bf16(b)
            gap = _gap(a, b)
            check(bool(torch.isfinite(a).all()) and gap <= bound,
                  f"K7-T config 1 {st} T={t}: kernel vs plain {gap:.3e} "
                  f"(<= {bound:g})")
            res[("K7-T", "config1", st, t)] = gap
    return res


# the T-step kernels' CUDA names in the profiler (K3 and K8-T are the
# cooperative row-march, csf_march_kernel, pert_march_kernel and
# sc_march_kernel, timed by launch_times; the windows, csf_block_kernel and
# sc_local_kernel, run only K12a's and K12c's local forms)
BLOCK_KERNEL_NAMES = {"K3": "csf_block_kernel", "K8-T": "sc_march_kernel",
                      "K7-T": "single_block_kernel"}
MARCH2D_KERNEL_NAMES = ("csf_march_kernel", "pert_march_kernel",
                        "coupled_march_kernel")
# the T-step families whose launch is the cooperative row-march
MARCH2D_FAMILIES = ("K3", "K8-T")


def block_bytes(family, key):
    """Least bytes per cell and time step at T = 1 (each input read once,
    each output written once): the T=1 kernel's (K1/K2/K6, K4's alike; K8;
    K7).  A T-step launch moves them once per T steps."""
    if family == "K3":
        return {"f32": KERNEL_BYTES["K1"], "bf16": KERNEL_BYTES["K2"],
                "split": KERNEL_BYTES["K6"]}[key]
    return (SC_BYTES if family == "K8-T" else SINGLE_BYTES)[key]


def block_speed_cases(device, n=FLAGSHIP_N):
    """(label, family, key, model, state, T=1 step, T-step wrapper, its plain
    version, cells, operations per cell-step) of phase 49: K3 (both
    flagships, three layouts) at n^2, K8-T at configs 2 and 3 (n^2), K7-T
    at config 1 (512 x 1024) and at 1024^2."""
    from openlbmpm_torch.kernels import shanchen as ksc
    from openlbmpm_torch.kernels import single as ksg
    for variant, make, tag in (("CSF", flagship_model, "CSF"),
                               ("Perturbation", pert_flagship_model, "Pert")):
        for key in ("f32", "bf16", "split"):
            m = make(device, "bf16" if key == "bf16" else "f32", n=n)
            st = m.init_state_layers(1.0, 1.0, invading_rows=100 * n // 1024)
            x = st if key == "split" else m.pack_state_bf16(*st) \
                if key == "bf16" else m.pack_state(*st)
            kern, plain = k3_wrappers(variant, key)
            flops = (PERT_FLOPS[key] if tag == "Pert" else
                     KERNEL_FLOPS["K6" if key == "split" else "K1"])
            yield (f"K3{dict(f32='c', bf16='h', split='s')[key]} {tag}", "K3",
                   key, m, x, m.step if key == "split" else m.step_c, kern,
                   plain, n * n, flops)
    for name in ("config2", "config3"):
        for st in ("f32", "bf16"):
            m, f = sc_config(name, device, storage=st, n=n)
            yield (f"K8-T {name} {st}", "K8-T", st, m,
                   m.pack_state_bf16(f) if st == "bf16" else f, m.step,
                   ksc.sc_block_step, ksc.sc_block_step_reference, n * n,
                   SC_FLOPS[name])
    for nx in (512, 1024):
        for st in ("f32", "bf16"):
            m = config1_model(device, storage=st, nx=nx)
            f = flow_start(m)
            yield (f"K7-T {nx}x1024 {st}", "K7-T", st, m,
                   m.pack_state_bf16(f) if st == "bf16" else f, m.step,
                   ksg.single_block_step, ksg.single_block_step_reference,
                   nx * 1024, SINGLE_FLOPS)


def _tiling(family, key, m, t):
    from openlbmpm_torch.kernels import csf as k
    from openlbmpm_torch.kernels import shanchen as ksc
    from openlbmpm_torch.kernels import single as ksg
    dt = torch.bfloat16 if key == "bf16" else torch.float32
    if family == "K3":
        return k.csf_block_tiling(dt, key == "split", m.kernel_params, t)
    fn = ksc.sc_block_tiling if family == "K8-T" else ksg.single_block_tiling
    return fn(dt, m.kernel_params, t)


def phase_block_speed(device, n=FLAGSHIP_N, time_steps=400, calls=10):
    """Speed per time step of each T-step kernel at T = 1 (the T=1 kernel),
    2 and 4: CUDA events over `time_steps` steps (T = 1, 2, 4, 4, 2, 1,
    the best of each), device microseconds per launch from torch.profiler,
    launches per time step from the wrapper's count over `calls` calls,
    MLUPS, the bound per step (the least bytes over T, or the least
    operations of one step, whichever is longer), the plain version's time
    per step (T = 4) and the launch's tiling."""
    out = {}
    for (label, family, key, m, x, step1, kern, plain, cells,
         flops) in block_speed_cases(device, n):
        r = {"sec": {}, "launches_per_step": {}, "device_us": {},
             "tiling": {}, "cells": cells, "flops": flops}
        for t in (1, 2, 4, 4, 2, 1):
            fn = step1 if t == 1 else (lambda y, t=t: kern(y, m, t))
            sec = _time_steps(fn, x, max(time_steps // t, 10), device) / t
            r["sec"][t] = min(r["sec"].get(t, float("inf")), sec)
        for t in (2, 4):
            kern.launches = 0
            _steps(lambda y: kern(y, m, t), x, calls)
            r["launches_per_step"][t] = kern.launches / (calls * t)
            check(kern.launches == calls, f"{label} T={t}: {kern.launches} "
                  f"launches for {calls} calls")
            if family in MARCH2D_FAMILIES:   # the cooperative row-march
                r["device_us"][t] = launch_times(lambda y: kern(y, m, t), x)
            else:
                times = device_times(lambda y: kern(y, m, t), x,
                                     (BLOCK_KERNEL_NAMES[family],), steps=20)
                r["device_us"][t] = times[BLOCK_KERNEL_NAMES[family]]
            r["tiling"][t] = _tiling(family, key, m, t)
        r["plain_sec"] = _time_steps(lambda y: plain(y, m, 4), x, 2,
                                     device) / 4
        r["mlups"] = {t: cells / sec / 1e6 for t, sec in r["sec"].items()}
        r["bound_ms"] = {t: max(block_bytes(family, key) / t * cells /
                                HBM_BYTES_PER_S, flops * cells /
                                F32_FLOPS_PER_S) * 1e3 for t in (1, 2, 4)}
        out[label] = r
        del m, x
        torch.cuda.empty_cache()
    return out


def _metrics_gap(path_a, path_b):
    """(steps of a, steps of b, {field: the largest relative gap of that
    numeric field of metrics.jsonl}) over the fields other than the step
    and the timings."""
    recs = []
    for path in (path_a, path_b):
        with open(path) as fh:
            recs.append([json.loads(ln) for ln in fh if ln.strip()])
    worst = {}
    for ra, rb in zip(*recs):
        for key, va in ra.items():
            if key in ("mlups", "steps_per_s", "step") or \
                    not isinstance(va, (int, float)) or isinstance(va, bool):
                continue
            vb = rb[key]
            worst[key] = max(worst.get(key, 0.0), abs(va - vb) /
                             max(abs(va), abs(vb), 1e-3))
    return [r["step"] for r in recs[0]], [r["step"] for r in recs[1]], worst


# metrics.jsonl of a blocked run against --block 1, relative to max(|a|,
# |b|, 1e-3): the two runs' f32 kernels round apart (phase 48 holds each to
# the plain path); the masses, saturation and umax keep that small (8.2e-6
# at most on an H100), the steady criterion |u - u_prev| / |u| amplifies
# it (2.1e-4 with the Perturbation variant), so it has its own bound
BLOCK_CLI_BOUND = 1e-4
BLOCK_CLI_BOUNDS = {"steady_criterion": 1e-2}


def phase_block_main(device, n=FLAGSHIP_N, bench_steps=1000, f32_steps=400):
    """The T-step kernels' main paths, each kernel's count set to 0 just
    before the run and read just after.  bench.py's loop: ``run_chunked``
    of ``make_block_step(steps_per_call=4, compressed=True, storage=...)``
    on both flagships, bf16 (K3h) and f32 (K3c), and of ``make_block_step(4,
    storage="bf16")`` at config 1 (K7-T bf16) and config 2 (K8-T bf16).
    The user's entry point: ``run --model cg`` (CSF and Perturbation INIs,
    512^2, the I/O of its colour PDFs dominating at 1024^2), ``--model sc``
    (SC and EFS, 1024^2) and ``--model basic`` (basicsetup.ini) with
    ``--block 4`` against ``--block 1`` (96 steps, output every 48; the
    Shan-Chen INI fixes its interval at 1000, so it writes steps 0 and 96):
    metrics.jsonl at every output step within BLOCK_CLI_BOUND (the steady
    criterion within BLOCK_CLI_BOUNDS), the T-step
    kernel launched 24 times and the T=1 kernel never; then ``--block 0``
    with output every 30 steps (or 90 steps), which 4 does not divide,
    picks T = 2 as the JAX ``_pick_block`` does."""
    import contextlib
    import io
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.kernels import csf as k
    from openlbmpm_torch.kernels import shanchen as ksc
    from openlbmpm_torch.kernels import single as ksg
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    res = {}
    for variant, make, tag in (("CSF", flagship_model, "CSF"),
                               ("Perturbation", pert_flagship_model, "Pert")):
        counter = k.csf_block_compressed if tag == "CSF" else \
            k.pert_block_compressed
        for st, steps in (("bf16", bench_steps), ("f32", f32_steps)):
            m = make(device, st, n=n)
            blk = m.make_block_step(steps_per_call=4, compressed=True,
                                    storage=st)
            init = m.init_state_layers(1.0, 1.0, invading_rows=100 * n // 1024)
            s0 = m.pack_state_bf16(*init) if st == "bf16" else \
                m.pack_state(*init)
            meter = RunMetrics(n * n)
            counter.launches = 0
            s = run_chunked(blk, s0, num_steps=steps // 4,
                            io_interval=steps // 8, metrics=meter,
                            nan_guard=True)
            launches = counter.launches
            x = m.unpack_bf16(s) if st == "bf16" else s
            check(launches == steps // 4 and bool(torch.isfinite(x).all()),
                  f"bench loop {tag} {st}: {launches} launches, want "
                  f"{steps // 4}")
            res[("bench", tag, st)] = {"launches": launches, "steps": steps,
                                       "mlups": 4 * meter.mlups}
            del m, s, s0, x
    for label, m, f0, counter in (
            ("K8-T bf16", *sc_config("config2", device, storage="bf16", n=n),
             ksc.sc_block_step),
            ("K7-T bf16", config1_model(device, storage="bf16"), None,
             ksg.single_block_step)):
        f0 = flow_start(m) if f0 is None else f0
        blk = m.make_block_step(steps_per_call=4, storage="bf16")
        counter.launches = 0
        s = run_chunked(blk, m.pack_state_bf16(f0), num_steps=f32_steps // 4,
                        io_interval=f32_steps // 8, nan_guard=True)
        launches = counter.launches
        check(launches == f32_steps // 4 and
              bool(torch.isfinite(m.unpack_bf16(s)).all()),
              f"{label} main path: {launches} launches")
        res[("loop", label)] = {"launches": launches, "steps": f32_steps}
    root = os.path.dirname(os.path.abspath(__file__))
    runs = (("cg", "CSF", k.csf_block_split, k.csf_step_split),
            ("cg", "Perturbation", k.pert_block_split, k.pert_step_split),
            ("sc", "sc", ksc.sc_block_step, ksc.sc_step),
            ("sc", "efs", ksc.sc_block_step, ksc.sc_step),
            ("basic", "basic", ksg.single_block_step, ksg.single_step))
    with tempfile.TemporaryDirectory() as tmp:
        for model, tag, blocked, one in runs:
            extra = []
            ini = os.path.join(tmp, f"{tag}.ini")
            if model == "cg":
                _ini_copy(os.path.join(root, "configs", "rk_csf2d.ini"), ini,
                          {"xDomain": 512, "yDomain": 512,
                           "SurfaceTensionType": f"'{tag}'"})
            elif model == "sc":
                ini, phys = _sc_ini(root, tmp, n, tag == "efs")
                extra = ["--physics-config", phys]
            else:
                _ini_copy(os.path.join(root, "configs", "basicsetup.ini"), ini,
                          {})
            r = {}
            # the Shan-Chen INI fixes its output interval at 1000 steps
            plan = (("1", 96, 48), ("4", 96, 48), ("0", 90, 30)) if \
                model != "sc" else (("1", 96, None), ("4", 96, None),
                                    ("0", 90, None))
            for block, steps, interval in plan:
                if interval is not None:
                    _ini_copy(ini, ini, {"TimeInterval": interval})
                out = os.path.join(tmp, f"{tag}_{block}")
                blocked.launches = one.launches = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()) as text:
                    rc = cli.main(["run", ini, "--model", model, *extra,
                                   "--steps", str(steps), "--output", out,
                                   "--device", "cuda", "--block", block])
                sec = time.perf_counter() - t0
                want_t = {"1": 1, "4": 4, "0": 2}[block]
                line = next((ln for ln in text.getvalue().splitlines()
                             if f"--model {model}" in ln), "")
                said = f"{want_t} steps a launch" if want_t > 1 else \
                    "one step a launch"
                counts = (blocked.launches, one.launches)
                want = (0, steps) if want_t == 1 else (steps // want_t, 0)
                check(rc == 0 and said in line and counts == want,
                      f"cli {model} {tag} --block {block}: rc {rc}, "
                      f"launches {counts} (want {want}), {line}")
                r[block] = {"sec": sec, "launches": counts, "line": line,
                            "mlups": _mlups(os.path.join(out,
                                                         "metrics.jsonl"))}
            sa, sb, gaps = _metrics_gap(
                os.path.join(tmp, f"{tag}_1", "metrics.jsonl"),
                os.path.join(tmp, f"{tag}_4", "metrics.jsonl"))
            want_steps = [0, 96] if model == "sc" else [0, 48, 96]
            over = {k: v for k, v in gaps.items()
                    if v > BLOCK_CLI_BOUNDS.get(k, BLOCK_CLI_BOUND)}
            check(sa == sb == want_steps and not over,
                  f"cli {model} {tag}: --block 4 metrics at {sb}, --block 1 "
                  f"at {sa}, relative gaps over their bounds: {over}")
            gap = max(gaps.values())
            r["gap"], r["gaps"] = gap, gaps
            res[("cli", tag)] = r
    return res


def phase_cli_default(device, n=FLAGSHIP_N, steps=1000):
    """The CLI's default ``--block 0`` at the shipped sizes of phases 12
    (``cg``, CSF, rk_csf2d.ini, output every 500 steps), 18 (``sc``, SC,
    1024^2) and 38 (``basic``, basicsetup.ini, output every `steps`):
    `steps` f32 steps each; T from the printed path line, the T-step
    kernel launched `steps` / T times and the T=1 kernel never, the
    seconds with I/O."""
    import contextlib
    import io
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.kernels.csf import csf_block_split, csf_step_split
    from openlbmpm_torch.kernels.shanchen import sc_block_step, sc_step
    from openlbmpm_torch.kernels.single import single_block_step, single_step
    root = os.path.dirname(os.path.abspath(__file__))
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        cg_ini = os.path.join(tmp, "rk_csf2d.ini")
        _mini_ini(os.path.join(root, "configs", "rk_csf2d.ini"), cg_ini, n,
                  500)
        sc_ini, sc_phys = _sc_ini(root, tmp, n, False)
        basic_ini = os.path.join(tmp, "basicsetup.ini")
        _ini_copy(os.path.join(root, "configs", "basicsetup.ini"), basic_ini,
                  {"TimeInterval": steps})
        for model, args, blk, one in (
                ("cg", [cg_ini], csf_block_split, csf_step_split),
                ("sc", [sc_ini, "--physics-config", sc_phys], sc_block_step,
                 sc_step),
                ("basic", [basic_ini], single_block_step, single_step)):
            out = os.path.join(tmp, model)
            blk.launches = one.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as text:
                rc = cli.main(["run", *args, "--model", model, "--steps",
                               str(steps), "--output", out, "--device",
                               "cuda", "--block", "0"])
            sec = time.perf_counter() - t0
            found = re.search(r"(\d+) steps a launch", text.getvalue())
            t = int(found.group(1)) if found else 1
            check(rc == 0, f"cli default {model}: returned {rc}")
            check(t in (2, 4) and blk.launches * t == steps and
                  one.launches == 0, f"cli default {model}: T = {t}, "
                  f"{blk.launches} T-step and {one.launches} T=1 launches "
                  f"for {steps} steps")
            res[model] = {"t": t, "launches": blk.launches, "sec": sec}
    return res


def phase45_50_lines(r45, r46, r47, r48, r49, r50, card):
    def worst(r, pick):
        return max(v for k, v in r.items() if pick(k))
    lines = [
        "phase 45 K3 f64, T steps a launch vs T plain steps (T = 2, 3, 4, "
        "Perturbation also 10 and 16 off the CLI's domain, two calls; " +
        ", ".join(K3_DOMAINS) + "; CSF also xu_porous_96x64), max |diff|: "
        + ", ".join(
            f"{v} {lay} {worst(r45, lambda k: k[:2] == (v, lay)):.3e}"
            for v in ("CSF", "Perturbation") for lay in ("f32", "split")) +
        f" over {len(r45)} runs (<= 1e-11); " + layouts_text(45),
        f"phase 46 K8-T f64 (T = 2, 3, 4, every kernel case of SC_CASES, "
        f"100x64): max |diff| {max(r46.values()):.3e} over {len(r46)} runs "
        "(<= 1e-11); " + layouts_text(46),
        f"phase 47 K7-T f64 (T = 2, 3, 4, every case of SINGLE_CASES, "
        f"100x72): max |diff| {max(r47.values()):.3e} over {len(r47)} runs "
        "(<= 1e-11); " + layouts_text(47),
        f"phase 48 T-step kernels at full size vs their plain versions, 8 "
        f"steps from one f64 start [{card}]: " + "; ".join(
            (f"{k[0]} {k[1]} {k[2]} T={k[3]} planes {v['planes']:.3e} rho_r "
             f"{v['rho_r']:.3e} off the seam (<= "
             f"{K3_BOUNDS[k[1:3]][0]:g} / {K3_BOUNDS[k[1:3]][1]:g})")
            if k[0] == "K3" else
            f"{k[0]} {k[1]} {k[2]} T={k[3]} {v:.3e}" for k, v in r48.items())]
    for label, r in r49.items():
        dev = r["device_us"]
        lines.append(
            f"phase 49 {label} [{card}]: ms a time step T=1/2/4 " + "/".join(
                f"{r['sec'][t] * 1e3:.4f}" for t in (1, 2, 4)) +
            ", MLUPS " + "/".join(f"{r['mlups'][t]:.1f}" for t in (1, 2, 4)) +
            ", bound ms a step " + "/".join(
                f"{r['bound_ms'][t]:.4f}" for t in (1, 2, 4)) +
            "; launches a step T=2/4 " + "/".join(
                f"{r['launches_per_step'][t]:g}" for t in (2, 4)) +
            "; device us a launch T=2/4 " + "/".join(
                "not measured" if dev[t] is None else f"{dev[t][0]:.2f}"
                for t in (2, 4)) +
            "; " + "; ".join(layout_text(r["tiling"][t], t)
                             for t in (2, 4)) +
            f"; plain ms a step {r['plain_sec'] * 1e3:.3f}")
    for (kind, *rest), r in r50.items():
        if kind == "cli":
            lines.append(
                f"phase 50 cli {rest[0]} [{card}]: --block 1/4/0 launches "
                "(T-step, T=1) " + "/".join(
                    str(r[b]["launches"]) for b in ("1", "4", "0")) +
                ", seconds with I/O " + "/".join(
                    f"{r[b]['sec']:.2f}" for b in ("1", "4", "0")) +
                "; metrics.jsonl --block 4 vs 1 relative gaps " + ", ".join(
                    f"{k} {v:.2e}" for k, v in r["gaps"].items()) +
                f" (<= {BLOCK_CLI_BOUND:g}, steady_criterion <= "
                f"{BLOCK_CLI_BOUNDS['steady_criterion']:g}); " +
                r["0"]["line"])
        else:
            lines.append(
                f"phase 50 {kind} {' '.join(rest)}: run_chunked of "
                f"make_block_step(4), {r['steps']} steps, {r['launches']} "
                "launches" + (f", {r['mlups']:.1f} MLUPS incl. host loop"
                              if "mlups" in r else "") + f" [{card}]")
    return lines


def block_entries(r45, r46, r47, r48, r49, r50):
    """The kernels line's entries of the T-step kernels: ms, plain_ms and
    bound_ms a time step at T = 4, launches from phase 50's main paths."""
    csf = "openlbmpm_tpu/pallas/csf.py:147"
    entries = []
    for variant, tag in (("CSF", "CSF"), ("Perturbation", "Pert")):
        pre = "csf" if tag == "CSF" else "pert"
        sub = "_substep{_c} :998, :1033" if tag == "CSF" else \
            "_substep_pert{_c} :1118, :1246"
        for key, name, launches in (
                ("bf16", f"{pre}_block_compressed",
                 r50[("bench", tag, "bf16")]["launches"]),
                ("f32", f"{pre}_block_compressed_f32",
                 r50[("bench", tag, "f32")]["launches"]),
                ("split", f"{pre}_block_split",
                 r50[("cli", variant)]["4"]["launches"][0])):
            label = f"K3{dict(f32='c', bf16='h', split='s')[key]} {tag}"
            sp = r49[label]
            lay = "split" if key == "split" else "f32"
            entries.append(kernel_entry(
                name, label, "openlbmpm_torch/csrc/march2d.cuh",
                f"{csf} (steps_per_call=T, variant='{variant}', {sub}, "
                + ("state_mode=" if key == "split" else "storage=")
                + f"{key!r})",
                launches, max(r48[("K3", variant, key, t)]["max"]
                              for t in (2, 4)),
                sp["sec"][4], sp["plain_sec"], block_bytes("K3", key) / 4,
                sp["flops"], sp["cells"], steps_per_call=4,
                max_abs_err_f64=max(v for k, v in r45.items()
                                    if k[:2] == (variant, lay)),
                **block_extras(sp)))
    for name, cfg, st, launches in (
            ("sc_block_step", "config2", "f32", r50[("cli", "sc")]["4"]),
            ("sc_block_step_efs", "config3", "f32", r50[("cli", "efs")]["4"]),
            ("sc_block_step_bf16", "config2", "bf16",
             r50[("loop", "K8-T bf16")])):
        sp = r49[f"K8-T {cfg} {st}"]
        entries.append(kernel_entry(
            name, f"K8-T {cfg} {st}", "openlbmpm_torch/csrc/sc2d_march.cuh",
            "openlbmpm_tpu/pallas/shanchen.py:92 (steps_per_call=T, "
            "sub-steps :723-740, " + ("original SC" if cfg == "config2"
                                      else "EFS iso-8 MRT") +
            f", storage='{st}')",
            launches["launches"][0] if "line" in launches else
            launches["launches"],
            max(r48[("K8-T", cfg, st, t)] for t in (2, 4)),
            sp["sec"][4], sp["plain_sec"], block_bytes("K8-T", st) / 4,
            sp["flops"], sp["cells"], steps_per_call=4,
            max_abs_err_f64=max(r46.values()), **block_extras(sp)))
    for name, st, launches in (
            ("single_block_step", "f32", r50[("cli", "basic")]["4"]
             ["launches"][0]),
            ("single_block_step_bf16", "bf16",
             r50[("loop", "K7-T bf16")]["launches"])):
        sp, big = r49[f"K7-T 512x1024 {st}"], r49[f"K7-T 1024x1024 {st}"]
        entries.append(kernel_entry(
            name, f"K7-T {st}", "openlbmpm_torch/csrc/single2d_block.cuh",
            "openlbmpm_tpu/pallas/single.py:43 (steps_per_call=T, call :440, "
            f"rows after each sub-step :366-373, storage='{st}')", launches,
            max(r48[("K7-T", "config1", st, t)] for t in (2, 4)),
            sp["sec"][4], sp["plain_sec"], block_bytes("K7-T", st) / 4,
            sp["flops"], sp["cells"], steps_per_call=4,
            max_abs_err_f64=max(r47.values()), **block_extras(sp),
            ms_1024=big["sec"][4] * 1e3, ms_t1_1024=big["sec"][1] * 1e3,
            bound_ms_1024=big["bound_ms"][4]))
    return entries


def block_extras(sp):
    """A phase 49 row's numbers at T = 1 and 2 beside the entry's T = 4."""
    return {"ms_t1": sp["sec"][1] * 1e3, "ms_t2": sp["sec"][2] * 1e3,
            "bound_ms_t1": sp["bound_ms"][1], "bound_ms_t2": sp["bound_ms"][2],
            "mlups": sp["mlups"][4],
            "device_us_t4": None if sp["device_us"][4] is None
            else sp["device_us"][4][0],
            "launches_per_step": sp["launches_per_step"][4]}


def build_report(build, lib: str, sc: bool = False) -> str:
    logs = list(build.BUILD_DIR.glob(f"lib{lib}-*.log"))
    if not logs:
        return "no build log"
    log = max(logs, key=lambda p: p.stat().st_mtime).read_text()
    return ptxas_summary(log, sc)


# Least bytes per cell-step of each kernel's function at the main path's
# shapes: each input read once, each output written once; the geometry is a
# 1-byte solid mask (every geometry plane the kernels read follows from
# it).  K2/K1: the compressed flow state (22 / 40 B) in and out; K5c: K2's
# plus one f32 D2Q5 tracer (20 B) in and out; K6: two f32 colour PDFs
# (72 B) in and out; K5s: K6's plus the tracer.
KERNEL_BYTES = {"K2": 2 * 22 + 1, "K1": 2 * 40 + 1, "K5c": 2 * 22 + 2 * 20 + 1,
                "K6": 2 * 72 + 1, "K5s": 2 * 72 + 2 * 20 + 1}
# Least operations per cell-step (F32_FLOPS_PER_S): the CSF flow step, and
# with one D2Q5 tracer; K8 with K = 2, SC and EFS iso-8 alike.  The bytes
# bind every T=1 kernel, and every T-step kernel of phase 49 at T = 2 and
# 4 too (K3h at T = 4: 45 / 4 B against 177 operations a cell-step).
KERNEL_FLOPS = {"K2": CSF_OPS, "K1": CSF_OPS, "K5c": CSF_OPS + TRACER2D_OPS,
                "K6": CSF_OPS, "K5s": CSF_OPS + TRACER2D_OPS}
SC_FLOPS = {"config2": SC2_OPS, "config3": SC2_OPS}


def kernel_entry(name, label, source, replaces, launches, max_abs_err, sec,
                 plain_sec, bytes_per_cell, flops_per_cell, cells, **extra):
    """One entry of the kernels line: times in ms, the bound from this
    run's shapes (the larger of bytes over 3.35 TB/s and operations over the
    f32 peak), no library call (no single PyTorch call computes a step)."""
    t_bytes = bytes_per_cell * cells / HBM_BYTES_PER_S
    t_ops = flops_per_cell * cells / F32_FLOPS_PER_S
    return {"name": name, "label": label, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": sec * 1e3,
            "plain_ms": plain_sec * 1e3, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, **extra}


# -- the T-step kernels of coupled 2-D transport and of the 3-D flows: K5c-T,
# K10-T, K11-T -----------------------------------------------------------------

# phase 52's tracer cases: COUPLED_CASES (permeable and bounce-back
# interfaces, the Inamuro, anti-bounce-back and zero inlets with the free-flow
# outlet, three reacting tracers, D2Q5 MRT, D2Q9 SRT) plus a D2Q9 MRT case
# and an interface of kind "none" with the tracer rows
BLOCK_COUPLED_CASES = COUPLED_CASES | {
    "g": dict(num_tracers=1, scheme=9, relaxation="MRT",
              diff_x=(0.1,), diff_y=(0.05,), diff_xy=(0.01,),
              diff_yx=(0.01,), interface_mode="permeable",
              beta_interface=(0.3,)),
    "h": dict(num_tracers=1, scheme=5, tau=(0.9,), j0=(1 / 3,),
              interface_mode="none", inlet="inamuro", inlet_conc=(1.0,),
              outlet="freeflow"),
    "config4": CONFIG4_TRACER,
}
# the flows of phase 52: the flagship's (neumann inlet, Dirichlet outlet with
# the phi repair) and the Dirichlet inlet with the convective outlet
BLOCK_COUPLED_FLOWS = ("flagship", "dirichlet_convective")


def coupled_block_case(name, device, flow="flagship", ny=100, nx=64,
                       dtype=torch.float64):
    """A BLOCK_COUPLED_CASES model on a walled ny x nx channel (ny = 100 is
    no multiple of any tile height, so the last tile's window wraps), on the
    flagship's flow or with its rows replaced by _P_DIR_CONV, and its split
    start with tracer mass on the boundary rows."""
    import dataclasses
    from openlbmpm_torch.models.colorgradient import CGBoundaryConfig
    from openlbmpm_torch.models.transport import TransportParams, TransportRK
    params, bcs = flagship_flow()
    if flow == "dirichlet_convective":
        bcs = CGBoundaryConfig(**_P_DIR_CONV)
    params = dataclasses.replace(params, surface_tension=0.01, tau_b=0.8)
    m = TransportRK(walled(ny, nx), params,
                    TransportParams(**BLOCK_COUPLED_CASES[name]), bcs,
                    dtype=dtype, device=device)
    st = m.init_state(m.flow.init_state_layers(1.0, 1.0,
                                               invading_rows=ny // 5),
                      coupled_conc0(m.tp.num_tracers, ny, nx,
                                    seed=len(name)))
    return m, st


def k5ct_wrappers(layout):
    """(kernel wrapper, plain version) of K5c-T for a layout: "f32" / "bf16"
    (compressed), "split"."""
    from openlbmpm_torch.kernels import transport as kt
    lay = "split" if layout == "split" else "compressed"
    return (getattr(kt, f"coupled_block_{lay}"),
            getattr(kt, f"coupled_block_{lay}_reference"))


def phase_block_coupled_f64(device, calls=2, tol=1e-11):
    """K5c-T against T plain coupled steps at f64, T = 2, 3, 4, two calls in
    a row, on 100 x 64: every case of BLOCK_COUPLED_CASES on the flagship's
    flow, compressed and split; cases (a) and (f) on the Dirichlet inlet /
    convective outlet flow, compressed (the split Dirichlet inlet is the
    K6 path's)."""
    res = {}
    for flow in BLOCK_COUPLED_FLOWS:
        names = BLOCK_COUPLED_CASES if flow == "flagship" else ("a", "f")
        for name in names:
            m, st = coupled_block_case(name, device, flow)
            for lay in ("f32", "split") if flow == "flagship" else ("f32",):
                kern, plain = k5ct_wrappers(lay)
                x0 = st if lay == "split" else m.pack(st)
                for t in BLOCK_TS:
                    a = _steps(lambda x: kern(x, m, t), x0, calls)
                    b = _steps(lambda x: plain(x, m, t), x0, calls)
                    err = _gap(tuple(a), tuple(b))
                    check(all(bool(torch.isfinite(x).all()) for x in a) and
                          err <= tol, f"K5c-T {flow} {name} {lay} T={t}: "
                          f"kernel vs {t} plain steps {err:.3e} > {tol:g}")
                    res[(flow, name, lay, t)] = err
                if 52 not in LAYOUTS:
                    from openlbmpm_torch.kernels import transport as kt
                    note_layout(52, f"{flow} {name}", kt.coupled_block_tiling(
                        torch.float64, False, kt.coupled_block_params(m), 4))
            del m, st
    # Xu wetting on a porous mask: the tracer's and the flow's normals
    m, st = xu_porous_coupled(device)
    for lay in ("f32", "split"):
        kern, plain = k5ct_wrappers(lay)
        x0 = st if lay == "split" else m.pack(st)
        for t in BLOCK_TS:
            a = _steps(lambda x: kern(x, m, t), x0, calls)
            err = _gap(tuple(a), tuple(_steps(lambda x: plain(x, m, t), x0,
                                              calls)))
            check(all(bool(torch.isfinite(x).all()) for x in a) and
                  err <= tol, f"K5c-T xu_porous {lay} T={t}: kernel vs {t} "
                  f"plain steps {err:.3e} > {tol:g}")
            res[("xu_porous", "permeable", lay, t)] = err
    return res


def xu_porous_coupled(device, dtype=torch.float64):
    """xu_porous_model's flow coupled with CONFIG4_TRACER, and its split
    start: the droplet and a random tracer on every cell."""
    from openlbmpm_torch.models.colorgradient import CGBoundaryConfig
    from openlbmpm_torch.models.transport import TransportParams, TransportRK
    g = xu_porous_geometry()
    m = TransportRK(g, xu_porous_params(), TransportParams(**CONFIG4_TRACER),
                    CGBoundaryConfig(), dtype=dtype, device=device)
    conc = np.random.default_rng(5).uniform(0.0, 1.0, (1,) + g.shape)
    return m, m.init_state(m.flow.init_state_droplet(1.0, 1.0, radius=20.0),
                           conc)


# phase 53's 3-D Shan-Chen cases: SC3D_CASES (K = 2 periodic, K = 2 on
# walls with a body force, K = 3 on walls) plus one fluid on walls with the
# adhesion field and a body force
BLOCK_SC3D_CASES = ("k2_periodic", "k2_walls_force", "k3", "k1_walls_force")


def block_sc3d_case(name, device, shape=(48, 40, 32), dtype=torch.float64):
    """A BLOCK_SC3D_CASES model and its start (``sc3d_case``; the K = 1 case
    from a perturbed equilibrium)."""
    if name != "k1_walls_force":
        return sc3d_case(name, device, shape, dtype)
    m, _ = sc3d_case("k1_obstacle", device, shape, dtype)
    return m, flow_start(m, seed=9, k=1)


def banded_march(m, steps, split=None, slabs_per_wave=None):
    """A z-march plan in y-bands for the f64 model `m` and `steps` steps,
    with its table on the model's card: K11-T's (`m` a SinglePhaseD3Q19),
    K10-T's (`split` None, `m` a ShanChenMCMP3D) or K9-T's (`m` a
    ColorGradientRK3D, the split layout or the compressed one).  The bands
    are banded_rows(ny) high, so there are three and the last overhangs ny;
    the wrappers' plans cut no bands below their ring budget of 4 GiB, so
    phases 53 and 60 run these through march_call.  `slabs_per_wave` (K11-T
    only) None: the bands at the wrapper's slabs a wave; a number: one band
    at that many slabs a wave."""
    from openlbmpm_torch.kernels import march3d
    from openlbmpm_torch.models.flow3d import SinglePhaseD3Q19
    p = m.kernel_params
    shape = (p.nz, p.ny, p.nx)
    if isinstance(m, SinglePhaseD3Q19):
        if slabs_per_wave is not None:
            plan = march3d.single3d_march_plan(shape, steps, 8,
                                               slabs_per_wave)
            return plan, plan.tensor().to(m.fluid_u8.device)
        plan = march3d.single3d_march_plan(shape, steps, 8,
                                           band_rows=banded_rows(p.ny))
    elif split is None:
        plan = march3d.sc3d_march_plan(shape, p.k, steps, 8,
                                       band_rows=banded_rows(p.ny))
    else:
        plan = march3d.cg3d_march_plan(shape, steps, 8, split, p.inlet,
                                       p.outlet, bool(p.has_wetting),
                                       band_rows=banded_rows(p.ny))
    check(plan.bands == 3 and plan.bands * plan.band_rows > p.ny,
          f"banded plan: {plan.bands} bands of {plan.band_rows} rows for "
          f"ny {p.ny}, want 3 with the last overhanging")
    return plan, plan.tensor().to(
        (m.fluid_u8 if split is None else m.geo_planes).device)


def banded_rows(ny: int) -> int:
    """The band height of banded_march: two fifths of ny."""
    return 2 * ny // 5


def march_call(x, m, steps, plan, table):
    """One launch of K11-T (`x` a single-phase state), K10-T (a Shan-Chen
    state) or K9-T (a compressed state, or the split pair) on `plan` and its
    `table`, the tensors as the wrappers hand them to the kernel.  Not
    counted as a launch."""
    from openlbmpm_torch.kernels import cg3d as k9
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import march3d
    p = m.kernel_params
    if plan.family in ("sc", "single"):
        f = x.contiguous()
        out = torch.empty_like(f)
        march3d.march_launch(kf._BLOCK_LIBS[f.dtype], kf._PREFIX[
            plan.family], (steps,), (f, out, m.fluid_u8), plan, table, p)
        return out
    split = not torch.is_tensor(x)
    if split:
        a, b = (y.contiguous() for y in x)
        out = (torch.empty_like(a), torch.empty_like(b))
        tensors = (a, b, *out, m.geo_planes)
    else:
        a = x.contiguous()
        out = torch.empty_like(a)
        tensors = (a, None, out, None, m.geo_planes)
    march3d.march_launch(k9._BLOCK_LIBS[a.dtype], "cg3d",
                         (int(split), steps), tensors, plan, table, p)
    return out


def phase_block3d_f64(device, calls=2, tol=1e-11):
    """K11-T and K10-T against T plain steps at f64 on 48 x 40 x 32 (walls
    along y), T = 2, 3, 4, two calls in a row: every case of SINGLE3D_CASES
    (SRT and TRT, with and without the body force, an obstacle) and of
    BLOCK_SC3D_CASES (K = 1, 2, 3); each once on the wrapper's plan and
    once on banded_march's, three y-bands of 16 rows; K11-T also on one
    band at 1 and 2 slabs a wave (the wrapper's plan has more)."""
    from openlbmpm_torch.kernels import flow3d as kf
    res = {}
    for tag, names in (("K11-T", SINGLE3D_CASES), ("K10-T", BLOCK_SC3D_CASES)):
        for name in names:
            if tag == "K11-T":
                m = single3d_case(name, device)
                f = flow_start(m, seed=len(res))
                kern, plain = kf.single3d_block_step, \
                    kf.single3d_block_step_reference
            else:
                m, f = block_sc3d_case(name, device)
                kern, plain = kf.sc3d_block_step, kf.sc3d_block_step_reference
            for t in BLOCK_TS:
                b = _steps(lambda x: plain(x, m, t), f, calls)
                runs = {name: lambda x: kern(x, m, t)}
                plans = {"banded": banded_march(m, t)}
                if tag == "K11-T":
                    plans |= {f"Z={z}": banded_march(m, t, slabs_per_wave=z)
                              for z in (1, 2)}
                for pk, (plan, table) in plans.items():
                    runs[f"{name} {pk}"] = lambda x, plan=plan, \
                        table=table: march_call(x, m, t, plan, table)
                for key, fn in runs.items():
                    a = _steps(fn, f, calls)
                    err = _gap(a, b)
                    check(bool(torch.isfinite(a).all()) and err <= tol,
                          f"{tag} {key} T={t}: kernel vs {t} plain steps "
                          f"{err:.3e} > {tol:g}")
                    res[(tag, key, t)] = err
            if tag not in LAYOUTS.get(53, {}):
                note_layout(53, tag, kf.flow3d_block_tiling(
                    torch.float64, "single" if tag == "K11-T" else "sc",
                    m.kernel_params, 4))
    return res


# phase 54's bounds, off the seam rows and corners: the T=1 phases' (K5c
# phase 7: the flow's planes, rho_r and the tracers' PDFs; K11, K10: phases
# 34, 37 over 10 steps)
K5CT_BOUNDS = {"f32": (3e-5, 3e-5), "split": (3e-5, 3e-5),
               "bf16": (3e-4, 1e-4)}


def _coupled_flow(m, x, key):
    """The decoded compressed flow state of a K5c-T state of layout `key`."""
    if key == "split":
        return m.flow.pack_state(x[0], x[1])
    return m.flow.unpack_bf16(x[0]) if key == "bf16" else x[0]


def phase_block_full_3(device, n=FLAGSHIP_N, steps=8, sizes=(128, 256),
                       steps3=4):
    """The new T-step kernels at full size against their plain versions,
    T = 2 and 4, `steps` steps from one start: K5c-T at config 4 (n^2,
    bench_all.py:211-242: the flagship flow, one D2Q5 tracer) compressed in
    f32 and bf16 flow storage and split in f32, held off the seam rows and
    corners to K5CT_BOUNDS (tracers: the first bound); K11-T at basic3d and
    K10-T at probe_sc3d, `steps3` steps at each n of `sizes`, in f32 and
    bf16 storage, within FLOW3D_F32_BOUND and BF16_BOUND.  Each bf16 state then takes one
    more step (the T-step kernel at T = 1) from a common bf16 state, every
    value within one bf16 ulp of the plain step (``bf16_one_step``,
    ``bf16_ulp_check``)."""
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import transport as kt
    res = {}
    away = seam_masks(n, n, steps, device)
    for key in ("f32", "bf16", "split"):
        m = coupled_model(device, "bf16" if key == "bf16" else "f32",
                          CONFIG4_TRACER, ny=n, nx=n)
        st, _ = config4_state(m, n)
        x0 = st if key == "split" else m.pack(st)
        kern, plain = k5ct_wrappers(key)
        for t in (2, 4):
            a = _steps(lambda x: kern(x, m, t), x0, steps // t)
            b = _steps(lambda x: plain(x, m, t), x0, steps // t)
            fa, fb = _coupled_flow(m, a, key), _coupled_flow(m, b, key)
            ga, gb = a[-2] if key == "split" else a[1], \
                b[-2] if key == "split" else b[1]
            check(bool(torch.isfinite(fa).all()) and
                  bool(torch.isfinite(ga).all()),
                  f"K5c-T {key} T={t}: state not finite")
            d, dg = (fa - fb).abs(), (ga - gb).abs()
            r = {"planes": float(d[:9, away].max()),
                 "rho_r": float(d[9, away].max()),
                 "g": float(dg[:, :, away].max()),
                 "max": max(float(d.max()), float(dg.max()))}
            bp, br = K5CT_BOUNDS[key]
            check(r["planes"] <= bp and r["rho_r"] <= br and r["g"] <= bp,
                  f"K5c-T config 4 {key} T={t} off the seam: planes "
                  f"{r['planes']:.3e}, rho_r {r['rho_r']:.3e}, tracers "
                  f"{r['g']:.3e} over {bp:g}/{br:g}/{bp:g}")
            res[("K5c-T", key, t)] = r
        if key == "bf16":
            g = b[1]
            res[("K5c-T", "bf16", "ulp")] = bf16_one_step(
                m.flow, b[0], away,
                kernel=lambda s, _m: kt.coupled_block_compressed(
                    (s, g), m, 1)[0])
        del m, st, x0, a, b
        torch.cuda.empty_cache()
    for tag, make, start, kern, plain, bound in (
            ("K11-T", basic3d_model, lambda m: flow_start(m, seed=5),
             kf.single3d_block_step, kf.single3d_block_step_reference, "K11"),
            ("K10-T", probe_sc3d_model, probe_sc3d_start, kf.sc3d_block_step,
             kf.sc3d_block_step_reference, "K10")):
        for size in sizes:
            f = start(make(device, n=size))
            for st in ("f32", "bf16"):
                m = make(device, n=size, storage=st)
                x0 = m.pack_state_bf16(f) if st == "bf16" else f
                for t in (2, 4):
                    a = _steps(lambda x: kern(x, m, t), x0, steps3 // t)
                    b = _steps(lambda x: plain(x, m, t), x0, steps3 // t)
                    if st == "bf16":
                        a, b = m.unpack_bf16(a), m.unpack_bf16(b)
                    gap = _gap(a, b)
                    lim = FLOW3D_F32_BOUND[bound] if st == "f32" else \
                        BF16_BOUND[bound]
                    check(bool(torch.isfinite(a).all()) and gap <= lim,
                          f"{tag} {size}^3 {st} T={t}: kernel vs plain "
                          f"{gap:.3e} (<= {lim:g})")
                    res[(tag, f"{size}^3 {st}", t)] = gap
                    del a, b
                if st == "bf16" and size == sizes[0]:
                    h = _steps(lambda x: plain(x, m, 4), x0, 1)
                    res[(tag, "bf16", "ulp")] = bf16_ulp_check(
                        m, h, lambda x, mm: kern(x, mm, 1),
                        m.fluid_mask > 0, FLOW3D_BF16_SHARE, tag)
                del m, x0
                torch.cuda.empty_cache()
            del f
    return res


# the new T-step kernels' CUDA names in the profiler; None: timed by
# launch_times (the cooperative marches, coupled_march_kernel and
# sc3d_march_kernel)
BLOCK3_KERNEL_NAMES = {"K5c-T": None,
                       "K11-T": None,
                       "K10-T": None}
# least bytes per cell and time step at T = 1 (each input read once, each
# output written once): the T=1 kernel's, K5c (one f32 D2Q5 tracer) in its
# three layouts, K11 and K10 (two fluids) in f32 and bf16
BLOCK3_BYTES = {("K5c-T", "f32"): 2 * 40 + 2 * 20 + 1,
                ("K5c-T", "bf16"): KERNEL_BYTES["K5c"],
                ("K5c-T", "split"): KERNEL_BYTES["K5s"],
                ("K11-T", "f32"): FLOW3D_BYTES["K11"]["f32"],
                ("K11-T", "bf16"): FLOW3D_BYTES["K11"]["bf16"],
                ("K10-T", "f32"): FLOW3D_BYTES["K10"]["f32"],
                ("K10-T", "bf16"): FLOW3D_BYTES["K10"]["bf16"]}
BLOCK3_FLOPS = {"K5c-T": KERNEL_FLOPS["K5c"], "K11-T": FLOW3D_FLOPS["K11"],
                "K10-T": FLOW3D_FLOPS["K10"]}


def block3_speed_cases(device, n=FLAGSHIP_N, n3=128):
    """(label, family, key, model, state, T=1 step, T-step wrapper, its plain
    version, cells) of phase 55: K5c-T at config 4 (n^2) in its three
    layouts, K11-T at basic3d and K10-T at probe_sc3d (n3^3) in f32 and
    bf16."""
    from openlbmpm_torch.kernels import flow3d as kf
    for key in ("f32", "bf16", "split"):
        m = coupled_model(device, "bf16" if key == "bf16" else "f32",
                          CONFIG4_TRACER, ny=n, nx=n)
        st, _ = config4_state(m, n)
        kern, plain = k5ct_wrappers(key)
        yield (f"K5c-T{dict(f32='c', bf16='h', split='s')[key]}", "K5c-T", key,
               m, st if key == "split" else m.pack(st),
               m.step if key == "split" else m.step_c, kern, plain, n * n)
    for tag, make, start, kern, plain in (
            ("K11-T", basic3d_model, lambda m: flow_start(m, seed=5),
             kf.single3d_block_step, kf.single3d_block_step_reference),
            ("K10-T", probe_sc3d_model, probe_sc3d_start, kf.sc3d_block_step,
             kf.sc3d_block_step_reference)):
        f = start(make(device, n=n3))
        for st in ("f32", "bf16"):
            m = make(device, n=n3, storage=st)
            yield (f"{tag} {n3}^3 {st}", tag, st, m,
                   m.pack_state_bf16(f) if st == "bf16" else f, m.step, kern,
                   plain, n3 ** 3)


def _tiling3(family, key, m, t):
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import transport as kt
    dt = torch.bfloat16 if key == "bf16" else torch.float32
    if family == "K5c-T":
        return kt.coupled_block_tiling(dt, key == "split",
                                       kt.coupled_block_params(m), t)
    return kf.flow3d_block_tiling(dt, "single" if family == "K11-T" else "sc",
                                  m.kernel_params, t)


def phase_block3_speed(device, time_steps=100, calls=6):
    """Speed per time step of each new T-step kernel at T = 1 (the T=1
    kernel), 2 and 4: CUDA events over `time_steps` steps (T = 1, 2, 4, 4,
    2, 1, the best of each), device microseconds per launch from
    torch.profiler (K10-T's cooperative launch: launch_times), launches per
    time step from the wrapper's count over
    `calls` calls, MLUPS, the bound per step (the T=1 least bytes over T, or
    the least operations of one step, whichever is longer), the plain
    version's time per step (T = 4) and the launch's tiling.  A trace that
    shows no device time for the kernel (torch.profiler loses some of
    these millisecond launches in a long run) is taken once more."""
    out = {}
    for (label, family, key, m, x, step1, kern, plain,
         cells) in block3_speed_cases(device):
        flops = BLOCK3_FLOPS[family]
        r = {"sec": {}, "launches_per_step": {}, "device_us": {},
             "tiling": {}, "cells": cells, "flops": flops}
        for t in (1, 2, 4, 4, 2, 1):
            fn = step1 if t == 1 else (lambda y, t=t: kern(y, m, t))
            sec = _time_steps(fn, x, max(time_steps // t, 10), device) / t
            r["sec"][t] = min(r["sec"].get(t, float("inf")), sec)
        for t in (2, 4):
            kern.launches = 0
            _steps(lambda y: kern(y, m, t), x, calls)
            r["launches_per_step"][t] = kern.launches / (calls * t)
            check(kern.launches == calls, f"{label} T={t}: {kern.launches} "
                  f"launches for {calls} calls")
            name = BLOCK3_KERNEL_NAMES[family]
            for _ in range(0 if name is None else 2):
                r["device_us"][t] = device_times(lambda y: kern(y, m, t), x,
                                                 (name,), steps=4)[name]
                if r["device_us"][t] is not None:
                    break
            if name is None:
                r["device_us"][t] = launch_times(lambda y: kern(y, m, t), x)
            r["tiling"][t] = _tiling3(family, key, m, t)
        r["plain_sec"] = _time_steps(lambda y: plain(y, m, 4), x, 1,
                                     device) / 4
        r["mlups"] = {t: cells / sec / 1e6 for t, sec in r["sec"].items()}
        r["bound_ms"] = {t: max(BLOCK3_BYTES[(family, key)] / t * cells /
                                HBM_BYTES_PER_S, flops * cells /
                                F32_FLOPS_PER_S) * 1e3 for t in (1, 2, 4)}
        out[label] = r
        del m, x
        torch.cuda.empty_cache()
    return out


def _cli_run(cli, argv):
    """``cli.main(argv)`` with its output captured: (rc, text, seconds)."""
    import contextlib
    import io
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = cli.main(argv)
    return rc, text.getvalue(), time.perf_counter() - t0


def phase_block3_main(device, n=FLAGSHIP_N, steps=400, n3=128, cli_n=512):
    """The new T-step kernels' main paths, each kernel's count set to 0 just
    before the run and read just after.  bench.py's loop on config 4:
    ``run_chunked`` of ``TransportRK.make_block_step(steps_per_call=4,
    compressed=True, storage=...)`` in bf16 and f32 flow storage, and of
    ``make_block_step(4, compressed=False)`` on the split state; of
    ``make_block_step(4, storage="bf16")`` of basic3d and probe_sc3d at
    n3^3.  The user's entry point: ``run --model transport`` (the
    transport INI on rk_csf2d.ini at cli_n^2), ``--model basic3d`` and
    ``--model sc3d`` (the shipped INIs) with ``--block 4`` against
    ``--block 1`` (96 steps, output every 48): metrics.jsonl at every output
    step within BLOCK_CLI_BOUND, the T-step kernel launched 24 times and the
    T=1 kernel never; then ``--block 0`` with output every 30 steps (90
    steps), which 4 does not divide, picks T = 2 as the JAX
    ``_pick_block`` does."""
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import transport as kt
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    res = {}
    for key in ("bf16", "f32", "split"):
        m = coupled_model(device, "bf16" if key == "bf16" else "f32",
                          CONFIG4_TRACER, ny=n, nx=n)
        st, mass0 = config4_state(m, n)
        blk = m.make_block_step(steps_per_call=4, compressed=key != "split",
                                storage="bf16" if key == "bf16" else "f32")
        counter = k5ct_wrappers(key)[0]
        meter = RunMetrics(n * n)
        counter.launches = 0
        out = run_chunked(blk, st if key == "split" else m.pack(st),
                          num_steps=steps // 4, io_interval=steps // 8,
                          metrics=meter, nan_guard=True)
        launches = counter.launches
        g = out[-2] if key == "split" else out[1]
        drift = abs(float(g.double().sum()) - mass0) / mass0
        check(launches == steps // 4 and drift <= 1e-7 * steps,
              f"K5c-T bench loop {key}: {launches} launches (want "
              f"{steps // 4}), tracer mass drift {drift:.2e}")
        res[("loop", "K5c-T", key)] = {"launches": launches, "steps": steps,
                                       "mlups": 4 * meter.mlups,
                                       "drift": drift}
        del m, st, out
    for tag, make, start, counter in (
            ("K11-T", basic3d_model, lambda m: m.init_state(),
             kf.single3d_block_step),
            ("K10-T", probe_sc3d_model, probe_sc3d_start, kf.sc3d_block_step)):
        m = make(device, n=n3, storage="bf16")
        blk = m.make_block_step(steps_per_call=4, storage="bf16")
        meter = RunMetrics(m.geo.num_fluid_nodes)
        counter.launches = 0
        h = run_chunked(blk, m.pack_state_bf16(start(m)), num_steps=200 // 4,
                        io_interval=100 // 4, metrics=meter, nan_guard=True)
        launches = counter.launches
        check(launches == 50 and h.dtype == torch.bfloat16,
              f"{tag} bf16 main path: {launches} launches")
        res[("loop", tag, "bf16")] = {"launches": launches, "steps": 200,
                                      "mlups": 4 * meter.mlups}
        del m, h
        torch.cuda.empty_cache()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    runs = (("transport", kt.coupled_block_compressed, kt.coupled_step_split),
            ("basic3d", kf.single3d_block_step, kf.single3d_step),
            ("sc3d", kf.sc3d_block_step, kf.sc3d_step))
    with tempfile.TemporaryDirectory() as tmp:
        flow_ini = os.path.join(tmp, "rk_csf2d.ini")
        _mini_ini(os.path.join(root, "rk_csf2d.ini"), flow_ini, cli_n, 48)
        for model, blocked, one in runs:
            if model == "transport":
                ini = os.path.join(root, "transportsetup.ini")
                extra, edit = ["--physics-config", flow_ini], flow_ini
            else:
                name = "basic3d.ini" if model == "basic3d" else \
                    "shanchen3d.ini"
                ini = edit = os.path.join(tmp, name)
                _ini_copy(os.path.join(root, name), ini, {})
                extra = []
            r = {}
            for block, steps_, interval in (("1", 96, 48), ("4", 96, 48),
                                            ("0", 90, 30)):
                _ini_copy(edit, edit, {"TimeInterval": interval})
                out = os.path.join(tmp, f"{model}_{block}")
                blocked.launches = one.launches = 0
                rc, text, sec = _cli_run(cli, [
                    "run", ini, "--model", model, *extra, "--steps",
                    str(steps_), "--output", out, "--device", "cuda",
                    "--block", block])
                want_t = {"1": 1, "4": 4, "0": 2}[block]
                line = next((ln for ln in text.splitlines()
                             if f"--model {model}" in ln), "")
                said = f"{want_t} steps a launch" if want_t > 1 else \
                    "one step a launch"
                counts = (blocked.launches, one.launches)
                want = (0, steps_) if want_t == 1 else (steps_ // want_t, 0)
                check(rc == 0 and said in line and counts == want,
                      f"cli {model} --block {block}: rc {rc}, launches "
                      f"{counts} (want {want}), {line}")
                r[block] = {"sec": sec, "launches": counts, "line": line}
            sa, sb, gaps = _metrics_gap(
                os.path.join(tmp, f"{model}_1", "metrics.jsonl"),
                os.path.join(tmp, f"{model}_4", "metrics.jsonl"))
            over = {k: v for k, v in gaps.items()
                    if v > BLOCK_CLI_BOUNDS.get(k, BLOCK_CLI_BOUND)}
            check(sa == sb == [0, 48, 96] and not over,
                  f"cli {model}: --block 4 metrics at {sb}, --block 1 at "
                  f"{sa}, relative gaps over their bounds: {over}")
            r["gap"], r["gaps"] = max(gaps.values()), gaps
            res[("cli", model)] = r
    return res


def phase_cli_default_3(device, n=FLAGSHIP_N, steps=1000, tr_steps=500):
    """The CLI's default ``--block 0`` at the shipped sizes of phases 12
    (``transport``, transportsetup.ini on rk_csf2d.ini at n^2, output every
    500 steps, `tr_steps` steps) and 38 (``basic3d`` and ``sc3d``,
    basic3d.ini and shanchen3d.ini, output every `steps`): T from the
    printed path line, the T-step kernel launched steps / T times and the
    T=1 kernel never, the seconds with I/O."""
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import transport as kt
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        flow_ini = os.path.join(tmp, "rk_csf2d.ini")
        _mini_ini(os.path.join(root, "rk_csf2d.ini"), flow_ini, n, 500)
        basic_ini = os.path.join(tmp, "basic3d.ini")
        _ini_copy(os.path.join(root, "basic3d.ini"), basic_ini,
                  {"TimeInterval": steps})
        sc_ini = os.path.join(tmp, "shanchen3d.ini")
        _ini_copy(os.path.join(root, "shanchen3d.ini"), sc_ini,
                  {"TimeInterval": steps})
        for model, args, n_steps, blk, one in (
                ("transport", [os.path.join(root, "transportsetup.ini"),
                               "--physics-config", flow_ini], tr_steps,
                 kt.coupled_block_compressed, kt.coupled_step_split),
                ("basic3d", [basic_ini], steps, kf.single3d_block_step,
                 kf.single3d_step),
                ("sc3d", [sc_ini], steps, kf.sc3d_block_step, kf.sc3d_step)):
            blk.launches = one.launches = 0
            rc, text, sec = _cli_run(cli, [
                "run", *args, "--model", model, "--steps", str(n_steps),
                "--output", os.path.join(tmp, model), "--device", "cuda",
                "--block", "0"])
            found = re.search(r"(\d+) steps a launch", text)
            t = int(found.group(1)) if found else 1
            check(rc == 0, f"cli default {model}: returned {rc}")
            check(t in (2, 4) and blk.launches * t == n_steps and
                  one.launches == 0, f"cli default {model}: T = {t}, "
                  f"{blk.launches} T-step and {one.launches} T=1 launches "
                  f"for {n_steps} steps")
            res[model] = {"t": t, "launches": blk.launches, "sec": sec,
                          "steps": n_steps}
    return res


def layout_text(g, t) -> str:
    """One launch's layout for a phase line: the row-march's waves, rows a
    wave (Z), ring MB, cooperative grid and lag (K3, K5c-T, K8-T); the
    z-march's plan (K11-T, K10-T, K9-T: bands of rows plus halo, the rings'
    MB, the grid, the waves and the lag); a 2-D window's tile, KB and
    memory (K7-T); else the tiling as JSON."""
    if g.get("march") == "rows":
        return (f"row-march T={t}: {g['waves']} waves of "
                f"{g['slabs_per_wave']} rows, rings "
                f"{g['scratch_bytes'] / 2 ** 20:.1f} MB, grid {g['grid']} "
                f"blocks, lag {g['lag']} rows, {g['stages']} stages")
    if "bands" in g:
        return (f"plan T={t}: {g['bands']} band(s) of {g['band_rows']} rows"
                f" + {g['halo']} halo, rings "
                f"{g['scratch_bytes'] / 2 ** 20:.1f} MB, grid {g['grid']} "
                f"blocks, {g['waves']} waves, lag "
                f"{g['lag']}, {g['slabs_per_wave']} slab(s) a wave")
    if "tz" not in g:
        return (f"window T={t}: tile {g['tx']}x{g['ty']}, window "
                f"{g['window_bytes'] / 1024:.1f} KB, global {g['gmem']}")
    return f"tiling T={t} " + json.dumps(g, separators=(",", ":"))


# the layouts at T = 4 of the f64 T-step phases' first cases, printed on
# their lines: {phase: {label: layout_text}}
LAYOUTS: dict = {}


def note_layout(phase: int, label: str, tiling: dict, t: int = 4) -> None:
    LAYOUTS.setdefault(phase, {})[label] = layout_text(tiling, t)


def layouts_text(phase: int) -> str:
    return "; ".join(f"{k}: {v}" for k, v in LAYOUTS.get(phase, {}).items())


def tiling_text(tilings) -> str:
    """A launch's layout at T = 2 and 4 for a phase line (layout_text)."""
    return "; ".join(layout_text(tilings[t], t) for t in (2, 4))


def phase52_57_lines(r52, r53, r54, r55, r56, r57, r12, r38, card):
    def worst(r, pick):
        return max(v for k, v in r.items() if pick(k))
    lines = [
        "phase 52 K5c-T f64, T steps a launch vs T plain coupled steps (T = "
        "2, 3, 4, two calls, 100x64; cases " + ",".join(BLOCK_COUPLED_CASES)
        + " on the flagship flow, a and f on the Dirichlet/convective flow, "
        "config4's tracer on the Xu porous droplet), max |diff|: " + ", ".join(
            f"{flow} {lay} {worst(r52, lambda k: k[0] == flow and k[2] == lay):.3e}"
            for flow, lay in (("flagship", "f32"), ("flagship", "split"),
                              ("dirichlet_convective", "f32"),
                              ("xu_porous", "f32"), ("xu_porous", "split"))) +
        f" over {len(r52)} runs (<= 1e-11); " + layouts_text(52),
        "phase 53 K11-T / K10-T f64 (T = 2, 3, 4, two calls, 48x40x32; "
        "SINGLE3D_CASES, BLOCK_SC3D_CASES K = 1, 2, 3): max |diff| on the "
        "wrappers' plans K11-T "
        f"{worst(r53, lambda k: k[0] == 'K11-T' and ' ' not in k[1]):.3e}, "
        "K10-T "
        f"{worst(r53, lambda k: k[0] == 'K10-T' and ' ' not in k[1]):.3e}"
        "; in three y-bands K11-T "
        f"{worst(r53, lambda k: k[0] == 'K11-T' and 'banded' in k[1]):.3e}"
        ", K10-T "
        f"{worst(r53, lambda k: k[0] == 'K10-T' and 'banded' in k[1]):.3e}"
        "; K11-T at 1 and 2 slabs a wave "
        f"{worst(r53, lambda k: 'Z=' in k[1]):.3e} over {len(r53)} runs "
        "(<= 1e-11); " + layouts_text(53),
        f"phase 54 new T-step kernels at full size vs their plain versions, "
        f"8 steps (3-D 4) from one start [{card}]: " + "; ".join(
            (f"{k[0]} {k[1]} one bf16 step: excess {v['excess']:.3g} ulp, "
             f"share {v['share']:.2e}, round-toward-zero share "
             f"{v['rz_share']:.2e}") if k[2] == "ulp" else
            (f"{k[0]} config4 {k[1]} T={k[2]} planes {v['planes']:.3e} rho_r "
             f"{v['rho_r']:.3e} tracers {v['g']:.3e} off the seam (<= "
             f"{K5CT_BOUNDS[k[1]][0]:g} / {K5CT_BOUNDS[k[1]][1]:g})")
            if k[0] == "K5c-T" else
            f"{k[0]} {k[1]} T={k[2]} {v:.3e}" for k, v in r54.items())]
    for label, r in r55.items():
        dev = r["device_us"]
        lines.append(
            f"phase 55 {label} [{card}]: ms a time step T=1/2/4 " + "/".join(
                f"{r['sec'][t] * 1e3:.4f}" for t in (1, 2, 4)) +
            ", MLUPS " + "/".join(f"{r['mlups'][t]:.1f}" for t in (1, 2, 4)) +
            ", bound ms a step " + "/".join(
                f"{r['bound_ms'][t]:.4f}" for t in (1, 2, 4)) +
            "; launches a step T=2/4 " + "/".join(
                f"{r['launches_per_step'][t]:g}" for t in (2, 4)) +
            "; device us a launch T=2/4 " + "/".join(
                "not measured" if dev[t] is None else f"{dev[t][0]:.2f}"
                for t in (2, 4)) +
            "; " + tiling_text(r["tiling"]) +
            f"; plain ms a step {r['plain_sec'] * 1e3:.3f}")
    for (kind, *rest), r in r56.items():
        if kind == "cli":
            lines.append(
                f"phase 56 cli {rest[0]} [{card}]: --block 1/4/0 launches "
                "(T-step, T=1) " + "/".join(
                    str(r[b]["launches"]) for b in ("1", "4", "0")) +
                ", seconds with I/O " + "/".join(
                    f"{r[b]['sec']:.2f}" for b in ("1", "4", "0")) +
                "; metrics.jsonl --block 4 vs 1 relative gaps " + ", ".join(
                    f"{k} {v:.2e}" for k, v in r["gaps"].items()) +
                f" (<= {BLOCK_CLI_BOUND:g}); " + r["0"]["line"])
        else:
            lines.append(
                f"phase 56 {' '.join(rest)}: run_chunked of "
                f"make_block_step(4), {r['steps']} steps, {r['launches']} "
                f"launches, {r['mlups']:.1f} MLUPS incl. host loop"
                + (f", tracer mass drift {r['drift']:.2e}" if "drift" in r
                   else "") + f" [{card}]")
    lines.append(
        f"phase 57 cli default --block 0 at the shipped sizes [{card}]: " +
        "; ".join(f"{m} T={r57[m]['t']} {r57[m]['launches']} T-step "
                  f"launches for {r57[m]['steps']} steps, "
                  f"{r57[m]['sec']:.2f} s with I/O against {sec1:.2f} s with "
                  f"--block 1 (phase {ph})"
                  for m, sec1, ph in (("transport", r12["tr_sec"], 12),
                                      ("basic3d", r38["basic3d"]["sec"], 38),
                                      ("sc3d", r38["sc3d"]["sec"], 38))))
    return lines


def block3_entries(r52, r53, r54, r55, r56):
    """The kernels line's entries of K5c-T, K11-T and K10-T: ms, plain_ms
    and bound_ms a time step at T = 4, launches from phase 56's main
    paths."""
    csf = "openlbmpm_tpu/pallas/csf.py:147"
    entries = []
    for key, name, launches in (
            ("bf16", "coupled_block_compressed",
             r56[("loop", "K5c-T", "bf16")]["launches"]),
            ("f32", "coupled_block_compressed_f32",
             r56[("cli", "transport")]["4"]["launches"][0]),
            ("split", "coupled_block_split",
             r56[("loop", "K5c-T", "split")]["launches"])):
        label = f"K5c-T{dict(f32='c', bf16='h', split='s')[key]}"
        sp = r55[label]
        lay = "split" if key == "split" else "f32"
        entries.append(kernel_entry(
            name, label, "openlbmpm_torch/csrc/march2d.cuh",
            f"{csf} (transport_params, steps_per_call=T, tracer sub-step "
            ":1385, order :1729-1751, " + ("state_mode='split')"
                                           if key == "split" else
                                           f"storage={key!r})"),
            launches, max(r54[("K5c-T", key, t)]["max"] for t in (2, 4)),
            sp["sec"][4], sp["plain_sec"], BLOCK3_BYTES[("K5c-T", key)] / 4,
            sp["flops"], sp["cells"], steps_per_call=4,
            max_abs_err_f64=max(v for k, v in r52.items() if k[2] == lay),
            **block_extras(sp)))
    for family, name, tpu, kind in (
            ("K11-T", "single3d_block_step",
             "openlbmpm_tpu/pallas/single3d.py:47 (steps_per_call=T, "
             "_substep :150, kernel :205", "single"),
            ("K10-T", "sc3d_block_step",
             "openlbmpm_tpu/pallas/sc3d.py:79 (steps_per_call=T, _substep "
             ":218, kernel :292", "sc")):
        for st, launches in (
                ("f32", r56[("cli", "basic3d" if kind == "single" else
                             "sc3d")]["4"]["launches"][0]),
                ("bf16", r56[("loop", family, "bf16")]["launches"])):
            sp = r55[f"{family} 128^3 {st}"]
            entries.append(kernel_entry(
                name + ("_bf16" if st == "bf16" else ""), f"{family} {st}",
                "openlbmpm_torch/csrc/flow3d_block.cuh",
                f"{tpu}, storage='{st}')", launches,
                max(r54[(family, f"{n}^3 {st}", t)] for n in (128, 256)
                    for t in (2, 4)),
                sp["sec"][4], sp["plain_sec"],
                BLOCK3_BYTES[(family, st)] / 4, sp["flops"], sp["cells"],
                steps_per_call=4,
                max_abs_err_f64=max(v for k, v in r53.items()
                                    if k[0] == family),
                **block_extras(sp)))
    return entries


# -- four Shan-Chen fluids (the runtime-K instances), --no-pallas, and the
# 3-D CSF T-step kernel K9-T ---------------------------------------------------

def phase_sc4(device, steps=20, tol=1e-11, n=FLAGSHIP_N, n3=128,
              steps_full=10, main_steps=40):
    """K8 / K8-T and K10 / K10-T with four fluids (the runtime-K instances
    ``csrc/sc2d_rt.cuh``, ``csrc/sc3d_rt.cuh``): every case of SC4_CASES
    (128 x 64) and of SC3D4_CASES (48 x 40 x 32) at f64 against the plain
    step, `steps` steps as T = 1, 2 and 4 steps a call (<= tol); at full
    size (sc4_mrt_velocity_convective at n^2, k4_walls_force at n3^3) in
    f32, `steps_full` steps within phase 17's and phase 37's bounds, and in
    bf16 storage (``sc4_bf16``); the main paths: ``run_chunked`` of
    ``model.step`` and of ``make_block_step(4)`` of each full-size model,
    each count set to 0 just before; ms a step of kernel and plain
    version."""
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import shanchen as ks
    from openlbmpm_torch.models.base import run_chunked
    res = {}
    fams = (("K8", SC4_CASES, lambda nm, **kw: sc_case(nm, device, **kw),
             ks.sc_step, ks.sc_block_step, ks.sc_block_step_reference),
            ("K10", SC3D4_CASES, lambda nm, **kw: sc3d_case(nm, device, **kw),
             kf.sc3d_step, kf.sc3d_block_step, kf.sc3d_block_step_reference))
    for tag, cases, make, one, blk, plain in fams:
        for name in cases:
            m, f = make(name)
            check(m.path == "kernel" and m.k == 4, f"{tag} {name}: path "
                  f"{m.path}, {m.k} fluids")
            ref = _steps(lambda x: plain(x, m, 1), f, steps)
            for t in (1, 2, 4):
                fn = (lambda x: one(x, m)) if t == 1 else \
                    (lambda x, t=t: blk(x, m, t))
                a = _steps(fn, f, steps // t)
                err = _gap(a, ref)
                check(bool(torch.isfinite(a).all()) and err <= tol,
                      f"{tag} K=4 {name} T={t} f64: kernel vs plain "
                      f"{err:.3e} > {tol:g}")
                res[(tag, name, t)] = err
    for (tag, cases, make, one, blk, plain), name, kw, bound, bound16, \
            cells in zip(fams, ("sc4_mrt_velocity_convective",
                                "k4_walls_force"),
                         (dict(ny=n, nx=n), dict(shape=(n3,) * 3)),
                         (SC_BOUNDS["f32"], FLOW3D_F32_BOUND["K10"]),
                         (SC_BOUNDS["bf16"], BF16_BOUND["K10"]),
                         (n * n, n3 ** 3)):
        m64, f64 = make(name, **kw)
        m, _ = make(name, dtype=torch.float32, **kw)
        x0 = f64.float()
        del m64, f64
        a = _steps(lambda x: one(x, m), x0, steps_full)
        gap = _gap(a, _steps(lambda x: plain(x, m, 1), x0, steps_full))
        check(bool(torch.isfinite(a).all()) and gap <= bound,
              f"{tag} K=4 {name} f32 full size: kernel vs plain {gap:.3e} > "
              f"{bound:g}")
        r = {"gap": gap, "path": m.path, "cells": cells,
             "sec": _time_steps(lambda x: one(x, m), x0, 20, device),
             "plain_sec": _time_steps(lambda x: plain(x, m, 1), x0, 2,
                                      device),
             "sec_t4": _time_steps(lambda x: blk(x, m, 4), x0, 5, device) / 4}
        for fn, counter, key in ((m.step, one, "launches"),
                                 (m.make_block_step(4), blk,
                                  "launches_t4")):
            calls = main_steps // getattr(fn, "steps_per_call", 1)
            counter.launches = 0
            run_chunked(fn, x0, num_steps=calls, io_interval=calls // 2,
                        nan_guard=True)
            r[key] = counter.launches
            check(counter.launches == calls, f"{tag} K=4 main path: "
                  f"{counter.launches} launches for {calls} calls")
        res[(tag, "full")] = r
        del m, a
        mh, _ = make(name, dtype=torch.float32, storage="bf16", **kw)
        res[(tag, "bf16")] = sc4_bf16(mh, x0, one, blk, plain, steps_full,
                                      bound16, tag)
        del mh, x0
        torch.cuda.empty_cache()
    return res


def sc4_bf16(m, x0, one, blk, plain, steps, bound, tag):
    """The runtime-K instance in bf16 storage: the four-fluid model `m`
    from the f32 start `x0`, encoded once; `steps` steps at T = 1 and
    steps // 4 calls at T = 4 of the kernel and its plain version (a bf16
    state decoded once a call), both decoded at the end, max |difference|
    within `bound` (phase 17's or 37's); then one more step from the plain
    version's state, value by value within one bf16 ulp
    (``bf16_ulp_check``)."""
    h = m.pack_state_bf16(x0)
    r = {}
    for t in (1, 4):
        fn = (lambda x: one(x, m)) if t == 1 else (lambda x: blk(x, m, 4))
        a = m.unpack_bf16(_steps(fn, h, steps // t))
        b = _steps(lambda x: plain(x, m, t), h, steps // t)
        r[t] = _gap(a, m.unpack_bf16(b))
        check(bool(torch.isfinite(a).all()) and r[t] <= bound,
              f"{tag} K=4 bf16 T={t}: kernel vs plain {r[t]:.3e} > {bound:g}")
    r["ulp"] = bf16_ulp_check(m, b, lambda x, mm: one(x, mm),
                              m.fluid_mask > 0, FLOW3D_BF16_SHARE,
                              f"{tag} K=4")
    return r


def _launch_counters():
    """{name: wrapper} of every kernel wrapper with a launch count."""
    from openlbmpm_torch.kernels import (cg3d, csf, flow3d, shanchen, single,
                                         transport)
    out = {}
    for mod in (csf, transport, shanchen, cg3d, single, flow3d):
        for attr in dir(mod):
            fn = getattr(mod, attr)
            if callable(fn) and hasattr(fn, "launches"):
                out[f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}"] = fn
    return out


# phase 59's bounds on metrics.jsonl, relative to max(|a|, |b|, 1e-3): the
# kernels against the plain step in f32; the masses and the saturation move
# by rounding (<= 8e-6 measured on an H100), umax, a maximum over the cells,
# sits at the contact lines and boundary slabs, where f32 rounding (1.6e-4
# for basic) and, for cg3d, the compressed and split slab rules part (the
# kernel runs the packed state, --no-pallas the split one, as the JAX CLI;
# 7.3e-4), so it has its own bound, as the steady criterion has
NO_PALLAS_BOUNDS = BLOCK_CLI_BOUNDS | {"umax": 2e-3}
# the runs of phase 59: the shipped INIs (main, then --physics-config)
NO_PALLAS_RUNS = {"cg": ("rk_csf2d.ini",),
                  "transport": ("transportsetup.ini", "rk_csf2d.ini"),
                  "cg3d": ("rk_csf3d.ini",),
                  "transport3d": ("transportsetup.ini", "rk_csf3d.ini"),
                  "sc": ("twophasesetup.ini", "shanchen2D.ini"),
                  "sc3d": ("shanchen3d.ini",),
                  "basic": ("basicsetup.ini",), "basic3d": ("basic3d.ini",)}


def phase_no_pallas(device, steps=20, interval=10):
    """``run --model M --no-pallas`` for each of the eight models on its
    shipped INIs (the output every `interval` steps where the INI sets it;
    ``sc`` writes at the start and the end), `steps` f32 steps on the
    card: every kernel wrapper's count stays 0, the model's own line names
    its path, "the plain step on cuda", and metrics.jsonl stays within BLOCK_CLI_BOUND (relative; the
    steady criterion and umax NO_PALLAS_BOUNDS) of the same run without the
    flag (the kernels, blocked as the default ``--block 0`` picks)."""
    import os
    import tempfile
    from openlbmpm_torch import cli
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    counters = _launch_counters()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for model, inis in NO_PALLAS_RUNS.items():
            paths = []
            for ini in inis:
                dst = os.path.join(tmp, f"{model}_{ini}")
                _ini_copy(os.path.join(root, ini), dst,
                          {"TimeInterval": interval})
                paths.append(dst)
            argv = [paths[0], "--model", model] + (
                ["--physics-config", paths[1]] if len(paths) > 1 else [])
            r = {}
            for flag in ([], ["--no-pallas"]):
                out = os.path.join(tmp, f"{model}{'_np' if flag else ''}")
                for fn in counters.values():
                    fn.launches = 0
                rc, text, sec = _cli_run(cli, ["run", *argv, "--steps",
                                               str(steps), "--output", out,
                                               "--device", "cuda", *flag])
                launched = {k: fn.launches for k, fn in counters.items()
                            if fn.launches}
                key = "plain" if flag else "kernel"
                r[key] = {"rc": rc, "sec": sec, "launched": launched}
                check(rc == 0, f"cli {model} {' '.join(flag)}: returned {rc}")
                if flag:
                    check(not launched and
                          f"the plain step on {device.type}" in text,
                          f"cli {model} --no-pallas: launched {launched}")
                else:
                    check(bool(launched), f"cli {model}: no kernel launched")
            sa, sb, gaps = _metrics_gap(
                os.path.join(tmp, model, "metrics.jsonl"),
                os.path.join(tmp, f"{model}_np", "metrics.jsonl"))
            over = {k: v for k, v in gaps.items()
                    if v > NO_PALLAS_BOUNDS.get(k, BLOCK_CLI_BOUND)}
            check(sa == sb and len(sa) >= 2 and sa[-1] == steps and not over,
                  f"cli {model} --no-pallas: metrics at {sb} against {sa}, "
                  f"relative gaps over their bounds: {over}")
            r["gaps"] = gaps
            res[model] = r
    return res


# phase 60's cases: periodic with wetting walls, the velocity inlet with the
# convective and with the pressure outlet, the grain pack cut small
BLOCK_CG3D_CASES = ("akai60_walls", "velocity_convective",
                    "velocity_dirichlet", "grain_pack")


def phase_block_cg3d_f64(device, calls=2, tol=1e-11, shape=(48, 40, 32),
                         grain=32):
    """K9-T against T plain steps at f64, T = 2, 3, 4, two calls in a row,
    compressed (K9-Tc) and split (K9-Ts), in every case of
    BLOCK_CG3D_CASES (48 x 40 x 32, the grain pack at 32^3), each once on
    the wrapper's plan and once on banded_march's (three y-bands of 16
    rows, 12 in the grain pack)."""
    from openlbmpm_torch.kernels import cg3d as k9
    res = {}
    for name in BLOCK_CG3D_CASES:
        m, st = cg3d_case(name, device, shape=(grain,) * 3
                          if name == "grain_pack" else shape)
        for lay, x0, kern, plain in (
                ("compressed", m.pack_state(*st), k9.cg3d_block_compressed,
                 k9.cg3d_block_compressed_reference),
                ("split", st, k9.cg3d_block_split,
                 k9.cg3d_block_split_reference)):
            for t in (2, 3, 4):
                b = _steps(lambda x: plain(x, m, t), x0, calls)
                plan, table = banded_march(m, t, lay == "split")
                for key, fn in ((name, lambda x: kern(x, m, t)),
                                (f"{name} banded", lambda x: march_call(
                                    x, m, t, plan, table))):
                    a = _steps(fn, x0, calls)
                    if lay == "split":
                        a = tuple(a)
                    err = _gap(a, tuple(b) if lay == "split" else b)
                    fin = all(bool(torch.isfinite(y).all()) for y in
                              (a if lay == "split" else (a,)))
                    check(fin and err <= tol, f"K9-T {key} {lay} T={t}: "
                          f"kernel vs {t} plain steps {err:.3e} > {tol:g}")
                    res[(key, lay, t)] = err
    return res


def phase_block_config5(device, n=128, steps=8):
    """K9-T at configuration 5 (n^3), T = 2 and 4, `steps` steps from one f64
    start against T plain steps a call: K9-Tc and K9-Ts in f32 and K9-Th in
    bf16 (decoded once and encoded once a call by both), held by phase 21's
    rule (``_hold``: its bounds far from walls and seam, off the seam the
    bound or the capped twin gap); then one more bf16 step (the T-step
    kernel at T = 1) from a common bf16 state within one ulp a value."""
    from openlbmpm_torch.kernels import cg3d as k9
    kc, pc = k9.cg3d_block_compressed, k9.cg3d_block_compressed_reference
    ks, ps = k9.cg3d_block_split, k9.cg3d_block_split_reference
    m64 = config5_model(device, dtype=torch.float64, n=n)
    st64 = config5_start(m64)
    s64 = m64.pack_state(*st64)
    p64 = _steps(lambda x: pc(x, m64, 1), s64, steps)
    sp64 = torch.cat(_steps(lambda x: ps(x, m64, 1), st64, steps))
    m32 = config5_model(device, n=n)
    mh = config5_model(device, storage="bf16", n=n)
    away, far = cg3d_masks(m32, steps, device)
    s32 = s64.float()
    st32 = tuple(t.float() for t in st64)
    res = {}
    for t in (2, 4):
        def run(fn, x, m, t=t):
            return _steps(lambda y: fn(y, m, t), x, steps // t)
        kern, plain = run(kc, s32, m32), run(pc, s32, m32)
        res[("f32", t)] = _gaps(kern, plain, run(pc, _twin(s32), m32), p64,
                                away, far)
        _hold("K9c f32", res[("f32", t)], 3e-5)
        res[("split", t)] = _gaps(*(torch.cat(x) for x in (
            run(ks, st32, m32), run(ps, st32, m32),
            run(ps, tuple(_twin(u, 1) for u in st32), m32))), sp64, away,
            far)
        _hold("K9s f32", res[("split", t)], 3e-5)
        h = mh.pack_compressed_bf16(s32)
        kh, ph = run(kc, h, mh), run(pc, h, mh)
        k, p, tw = (mh.unpack_bf16(x) for x in (
            kh, ph, run(pc, mh.pack_compressed_bf16(_twin(s32)), mh)))
        res[("bf16", t)] = {
            "planes": _gaps(k[:19], p[:19], tw[:19], p64[:19], away, far),
            "rho_r": _gaps(k[19:], p[19:], tw[19:], p64[19:], away, far),
            "max": float((k - p).abs().max())}
        _hold("K9h planes", res[("bf16", t)]["planes"], 3e-4)
        _hold("K9h rho_r", res[("bf16", t)]["rho_r"], 1e-4)
        for x, y, tag in ((kern, plain, "f32"), (k, p, "bf16")):
            tot_k = float(x[19].double().sum())
            tot_p = float(y[19].double().sum())
            res[(f"mass_{tag}", t)] = abs(tot_k - tot_p) / tot_p
            check(res[(f"mass_{tag}", t)] <= 1e-4, f"K9-T config 5 {tag} "
                  f"T={t}: total rho_r kernel vs plain "
                  f"{res[(f'mass_{tag}', t)]:.2e}")
        if t == 4:
            res[("bf16", "ulp")] = bf16_one_step_3d(
                mh, ph, away, kernel=lambda y, m: kc(y, m, 1),
                plain=lambda y, m: pc(y, m, 1))
        del kern, plain, kh, ph, k, p, tw
        torch.cuda.empty_cache()
    return res


# K9-T's least bytes per cell-step at T = 1 (its T=1 kernel's function):
# CG3D_BYTES (compressed f32 161, bf16 85, split f32 305); a T-step launch
# moves them once a T steps
BLOCK_CG3D_LABELS = {"f32": "K9-Tc", "bf16": "K9-Th", "split": "K9-Ts"}


def phase_block_cg3d_speed(device, sizes=(128, 256), time_steps=(24, 8),
                           loop_steps=120, calls=4):
    """K9-T's speed at configuration 5 per time step at T = 1 (the T=1
    kernel K9c / K9h / K9s), 2 and 4 (CUDA events; T = 1, 2, 4, 4, 2, 1, the
    best of each), device microseconds per launch (launch_times), the
    bound per step (CG3D_BYTES / T over 3.35 TB/s) at each n of
    `sizes`; at n = sizes[0] also launches per step from the wrapper's
    count over `calls` calls, the launch's tiling and the plain version's
    time per step; then bench_cg3d.py's loop at n = sizes[0]:
    ``run_chunked`` of
    ``make_block_step(4, compressed=True, storage="f32" | "bf16")`` and of
    ``make_block_step(4)`` (split) over `loop_steps` steps, each count set
    to 0 just before, with the host loop's MLUPS."""
    from openlbmpm_torch.kernels import cg3d as k9
    from openlbmpm_torch.models.base import RunMetrics, run_chunked
    out = {}
    for n, t_steps in zip(sizes, time_steps):
        m = config5_model(device, n=n)
        mh = config5_model(device, storage="bf16", n=n)
        st = config5_start(m)
        s = m.pack_state(*st)
        runs = {"f32": (m, s, m.step_c, k9.cg3d_block_compressed,
                        k9.cg3d_block_compressed_reference),
                "bf16": (mh, mh.pack_compressed_bf16(s), mh.step_c,
                         k9.cg3d_block_compressed,
                         k9.cg3d_block_compressed_reference),
                "split": (m, st, m.step, k9.cg3d_block_split,
                          k9.cg3d_block_split_reference)}
        for key, (mm, x, step1, kern, plain) in runs.items():
            r = {"sec": {}, "device_us": {}, "tiling": {},
                 "launches_per_step": {}, "cells": n ** 3}
            for t in (1, 2, 4, 4, 2, 1):
                fn = step1 if t == 1 else (lambda y, t=t: kern(y, mm, t))
                sec = _time_steps(fn, x, max(t_steps // t, 2), device) / t
                r["sec"][t] = min(r["sec"].get(t, float("inf")), sec)
            for t in (2, 4) if n == sizes[0] else ():
                kern.launches = 0
                _steps(lambda y: kern(y, mm, t), x, calls)
                r["launches_per_step"][t] = kern.launches / (calls * t)
                check(kern.launches == calls, f"K9-T {key} {n}^3 T={t}: "
                      f"{kern.launches} launches for {calls} calls")
                r["device_us"][t] = launch_times(lambda y: kern(y, mm, t), x)
                r["tiling"][t] = k9.cg3d_block_tiling(
                    torch.bfloat16 if key == "bf16" else torch.float32,
                    key == "split", mm.kernel_params, t)
            if n == sizes[0]:
                r["plain_sec"] = _time_steps(lambda y: plain(y, mm, 2), x, 1,
                                             device) / 2
            r["bound_ms"] = {t: CG3D_BYTES[key] / t * n ** 3 /
                             HBM_BYTES_PER_S * 1e3 for t in (1, 2, 4)}
            r["mlups"] = {t: n ** 3 / sec / 1e6 for t, sec in r["sec"].items()}
            out[(key, n)] = r
            if n == sizes[0]:
                blk = mm.make_block_step(4, compressed=key != "split",
                                         storage="bf16" if key == "bf16"
                                         else "f32")
                meter = RunMetrics(n ** 3)
                kern.launches = 0
                y = run_chunked(blk, x, num_steps=loop_steps // 4,
                                io_interval=loop_steps // 8, metrics=meter,
                                nan_guard=True)
                launches = kern.launches
                check(launches == loop_steps // 4, f"K9-T bench loop {key}: "
                      f"{launches} launches for {loop_steps} steps")
                out[("loop", key)] = {"launches": launches,
                                      "steps": loop_steps,
                                      "mlups": 4 * meter.mlups}
                del y
        del m, mh, st, s, runs
        torch.cuda.empty_cache()
    return out


def phase58_62_lines(r58, r59, r60, r61, r62, card):
    def worst(r, pick):
        return max(v for k, v in r.items() if pick(k))
    lines = [
        "phase 58 K = 4 fluids, the runtime-K instances, f64 vs plain (20 "
        "steps as T = 1, 2, 4; SC4_CASES 128x64, SC3D4_CASES 48x40x32): max "
        f"|diff| K8 {worst(r58, lambda k: k[0] == 'K8' and len(k) == 3):.3e}"
        f", K10 {worst(r58, lambda k: k[0] == 'K10' and len(k) == 3):.3e}"
        " (<= 1e-11)"]
    for tag, where in (("K8", f"{FLAGSHIP_N}^2 sc4_mrt_velocity_convective"),
                       ("K10", "128^3 k4_walls_force")):
        r = r58[(tag, "full")]
        lines.append(
            f"phase 58 {tag} K = 4 {where} f32 [{card}]: path {r['path']}, "
            f"kernel vs plain 10 steps {r['gap']:.3e}; main path run_chunked "
            f"{r['launches']} launches (step), {r['launches_t4']} "
            f"(make_block_step(4)); ms a step {r['sec'] * 1e3:.4f} (T = 1), "
            f"{r['sec_t4'] * 1e3:.4f} (T = 4), plain "
            f"{r['plain_sec'] * 1e3:.3f}, MLUPS "
            f"{r['cells'] / r['sec'] / 1e6:.1f}")
        r = r58[(tag, "bf16")]
        lines.append(
            f"phase 58 {tag} K = 4 {where} bf16 [{card}]: kernel vs plain "
            f"decoded, 10 steps at T = 1 {r[1]:.3e}, 8 at T = 4 {r[4]:.3e}; "
            f"one more step {r['ulp']['excess']:.3g} ulp at most, "
            f"{r['ulp']['share']:.2e} of the values off")
    lines.append(
        f"phase 59 run --no-pallas, {len(r59)} models at the shipped INIs, "
        f"20 f32 steps [{card}]: " + "; ".join(
            f"{m} kernels launched {sum(r['plain']['launched'].values())} "
            f"(without the flag {sum(r['kernel']['launched'].values())}), "
            f"{r['plain']['sec']:.2f} s against {r['kernel']['sec']:.2f} s, "
            f"metrics gap {max(r['gaps'].values(), default=0.0):.2e}"
            for m, r in r59.items()))
    lines.append(
        "phase 60 K9-T f64 vs T plain steps (T = 2, 3, 4, two calls; "
        + ", ".join(BLOCK_CG3D_CASES) + "): max |diff| " + ", ".join(
            f"{lay}{' in three y-bands' if band else ''} "
            f"{worst(r60, lambda k: k[1] == lay and ('banded' in k[0]) == band):.3e}"
            for band in (False, True) for lay in ("compressed", "split")) +
        f" over {len(r60)} runs (<= 1e-11)")
    parts = []
    for (key, t), v in r61.items():
        if key in ("f32", "split"):
            parts.append(f"{key} T={t} far {v['far']:.3e} away {v['away']:.3e}"
                         f" (twin {v['twin_away']:.3e}) max {v['max']:.3e}")
        elif key == "bf16" and t != "ulp":
            parts.append(f"bf16 T={t} planes far {v['planes']['far']:.3e} "
                         f"away {v['planes']['away']:.3e}, rho_r far "
                         f"{v['rho_r']['far']:.3e} away "
                         f"{v['rho_r']['away']:.3e}")
        elif key == "bf16":
            parts.append(f"one more bf16 step: excess {v['excess']:.3g} ulp, "
                         f"share {v['share']:.2e}")
    lines.append(f"phase 61 K9-T config 5 128^3, 8 steps [{card}]: "
                 + "; ".join(parts))
    for (key, n), r in r62.items():
        if key == "loop":
            lines.append(
                f"phase 62 bench_cg3d loop {n}: run_chunked of "
                f"make_block_step(4), {r['steps']} steps, {r['launches']} "
                f"launches, {r['mlups']:.1f} MLUPS incl. host loop [{card}]")
            continue
        dev = r["device_us"]
        lines.append(
            f"phase 62 {BLOCK_CG3D_LABELS[key]} {n}^3 [{card}]: ms a time "
            "step T=1/2/4 " + "/".join(
                f"{r['sec'][t] * 1e3:.4f}" for t in (1, 2, 4)) +
            ", MLUPS " + "/".join(f"{r['mlups'][t]:.1f}" for t in (1, 2, 4)) +
            ", bound ms a step " + "/".join(
                f"{r['bound_ms'][t]:.4f}" for t in (1, 2, 4)) +
            ("; launches a step T=2/4 " + "/".join(
                f"{r['launches_per_step'][t]:g}" for t in (2, 4)) +
             "; device us a launch T=2/4 " + "/".join(
                 "not measured" if dev[t] is None else f"{dev[t][0]:.2f}"
                 for t in (2, 4)) +
             "; " + tiling_text(r["tiling"]) +
             f"; plain ms a step {r['plain_sec'] * 1e3:.3f}"
             if "plain_sec" in r else ""))
    return lines


def phase58_62_entries(r58, r60, r61, r62):
    """The kernels line's entries of K9-Tc, K9-Th, K9-Ts (ms, plain_ms and
    bound_ms a time step at T = 4 at 128^3, launches from bench_cg3d's loop)
    and of the runtime-K K8 and K10 (K = 4, T = 1, launches from phase 58's
    main paths)."""
    cg3d = "openlbmpm_tpu/pallas/cg3d.py:132"
    entries = []
    for key, name, extra in (
            ("f32", "cg3d_block_compressed_f32", "storage='f32'"),
            ("bf16", "cg3d_block_compressed", "storage='bf16'"),
            ("split", "cg3d_block_split", "state_mode='split'")):
        sp, big = r62[(key, 128)], r62[(key, 256)]
        lay = "split" if key == "split" else "compressed"
        err = max(r61[(key, t)]["max"] for t in (2, 4))
        dev = sp["device_us"][4]
        entries.append(kernel_entry(
            name, BLOCK_CG3D_LABELS[key], "openlbmpm_torch/csrc/cg3d_block.cuh",
            f"{cg3d} (steps_per_call=T, in-window slabs :557, :624, :881-958, "
            f"{extra})", r62[("loop", key)]["launches"], err, sp["sec"][4],
            sp["plain_sec"], CG3D_BYTES[key] / 4, CG3D_FLOPS, 128 ** 3,
            steps_per_call=4,
            max_abs_err_f64=max(v for k, v in r60.items() if k[1] == lay),
            ms_t1=sp["sec"][1] * 1e3, ms_t2=sp["sec"][2] * 1e3,
            bound_ms_t1=sp["bound_ms"][1], bound_ms_t2=sp["bound_ms"][2],
            mlups=sp["mlups"][4], device_us_t4=None if dev is None else dev[0],
            launches_per_step=sp["launches_per_step"][4],
            ms_256=big["sec"][4] * 1e3, ms_256_t1=big["sec"][1] * 1e3,
            bound_ms_256=big["bound_ms"][4]))
    for tag, name, source, tpu, nbytes, flops in (
            ("K8", "sc_step_k4", "openlbmpm_torch/csrc/sc2d_rt.cuh",
             "openlbmpm_tpu/pallas/shanchen.py:92 (K = 4 fluids, MRT, Zou-He "
             "velocity inlet, convective outlet)", 2 * 144 + 1, 2 * SC2_OPS),
            ("K10", "sc3d_step_k4", "openlbmpm_torch/csrc/sc3d_rt.cuh",
             "openlbmpm_tpu/pallas/sc3d.py:79 (K = 4 fluids)", 2 * 304 + 1,
             2 * FLOW3D_FLOPS["K10"])):
        r = r58[(tag, "full")]
        entries.append(kernel_entry(
            name, f"{tag} K=4", source, tpu, r["launches"], r["gap"],
            r["sec"], r["plain_sec"], nbytes, flops, r["cells"],
            max_abs_err_f64=max(v for k, v in r58.items()
                                if k[0] == tag and len(k) == 3),
            max_abs_err_bf16=max(r58[(tag, "bf16")][t] for t in (1, 4)),
            ms_t4=r["sec_t4"] * 1e3, launches_t4=r["launches_t4"]))
    return entries


# -- the sharded steps: K12a (colour gradient, with transport) and K12b
# (single phase), one shard a local launch ---------------------------------

K12_MESHES = ((4, 1), (2, 2))


def _sharded(step, start, calls):
    """`calls` calls of a sharded step from the global arrays `start`;
    the gathered global arrays (a tuple)."""
    state = step.shard(*start)
    for _ in range(calls):
        state = step(state)
    out = step.gather(state)
    return out if isinstance(out, tuple) else (out,)


def _noisy_layers(m, seed, rows=None):
    """The compressed start of a colour-gradient model: red layers on top
    (a fifth of the rows, or `rows`), each colour's PDFs scaled by 1 +
    1e-3 noise (a numpy seed) so that the boundary rows see varied
    values."""
    f_r, f_b = m.init_state_layers(1.0, 1.0, invading_rows=rows or
                                   m.geo.ny // 5)
    rng = np.random.default_rng(seed)

    def noise():
        return torch.as_tensor(1 + 1e-3 * rng.standard_normal(f_r.shape),
                               dtype=f_r.dtype, device=f_r.device)
    return m.pack_state(f_r * noise(), f_b * noise())


def k12a_params(variant):
    """Phase 63's flow parameters: phase 45's (the flagship's with tau_b 0.8
    and sigma 0.01, or PERT_BASE)."""
    import dataclasses
    from openlbmpm_torch.models.colorgradient import ColorGradientParams
    if variant == "CSF":
        return dataclasses.replace(flagship_flow()[0], tau_b=0.8,
                                   surface_tension=0.01)
    return ColorGradientParams(**PERT_BASE)


def phase_sharded_csf_f64(device, n=256, calls=2, tol=1e-12, tol_plain=1e-11):
    """K12a at f64 against the single-device K3 and the plain step (see the
    module docstring, phase 63)."""
    from openlbmpm_torch.kernels import csf as kc
    from openlbmpm_torch.models.colorgradient import CGBoundaryConfig
    from openlbmpm_torch.parallel import make_mesh
    res = {}
    seed = 0
    for variant in ("CSF", "Perturbation"):
        params = k12a_params(variant)
        kern, plain = k3_wrappers(variant, "f32")
        for bname, bkw in (("neumann_dirichlet", _P_NEU_DIR),
                           ("dirichlet_convective", _P_DIR_CONV)):
            for (ny, nx), meshes, ts in (((n, n), K12_MESHES, (1, 2, 4)),
                                         ((104, n), ((4, 1),), (1, 2))):
                for shape in meshes:
                    mesh = make_mesh(shape=shape, kind="local", device=device)
                    for t in ts:
                        seed += 1
                        step = kc.build_csf_sharded_step(
                            walled(ny, nx), params, mesh, torch.float64,
                            steps_per_call=t,
                            bc_config=CGBoundaryConfig(**bkw))
                        tag = f"K12a {variant} {bname} {ny}x{nx} {shape} T={t}"
                        check(step is not None, f"{tag}: no sharded step")
                        m = step.model
                        x0 = _noisy_layers(m, seed)
                        kc.csf_local_step.launches = 0
                        (a,) = _sharded(step, (x0,), calls)
                        check(kc.csf_local_step.launches == calls * mesh.size,
                              f"{tag}: {kc.csf_local_step.launches} local "
                              f"launches for {calls} calls")
                        ek = _gap(a, _steps(lambda x: kern(x, m, t), x0, calls))
                        ep = _gap(a, _steps(lambda x: plain(x, m, t), x0,
                                            calls))
                        check(bool(torch.isfinite(a).all()) and ek <= tol and
                              ep <= tol_plain, f"{tag}: sharded vs K3 "
                              f"{ek:.3e} (<= {tol:g}), vs plain {ep:.3e} "
                              f"(<= {tol_plain:g})")
                        res[(variant, bname, f"{ny}x{nx}", shape, t)] = (ek, ep)
    # Xu wetting on a porous mask (the windows' phi extension onto solids)
    kern, plain = k3_wrappers("CSF", "f32")
    for shape in ((2, 2),):
        mesh = make_mesh(shape=shape, kind="local", device=device)
        for t in (1, 2):
            step = kc.build_csf_sharded_step(
                xu_porous_geometry(), xu_porous_params(), mesh,
                torch.float64, steps_per_call=t,
                bc_config=CGBoundaryConfig())
            tag = f"K12a CSF xu_porous 96x64 {shape} T={t}"
            check(step is not None, f"{tag}: no sharded step")
            m = step.model
            x0 = m.pack_state(*m.init_state_droplet(1.0, 1.0, radius=20.0))
            (a,) = _sharded(step, (x0,), calls)
            ek = _gap(a, _steps(lambda x: kern(x, m, t), x0, calls))
            ep = _gap(a, _steps(lambda x: plain(x, m, t), x0, calls))
            check(bool(torch.isfinite(a).all()) and ek <= tol and
                  ep <= tol_plain, f"{tag}: sharded vs K3 {ek:.3e} (<= "
                  f"{tol:g}), vs plain {ep:.3e} (<= {tol_plain:g})")
            res[("CSF", "xu_porous", "96x64", shape, t)] = (ek, ep)
    return res


def phase_sharded_coupled_f64(device, n=96, calls=2, tol=1e-12,
                              tol_plain=1e-11):
    """K12a with transport at f64 against K5c-T and the plain step (see the
    module docstring, phase 64)."""
    from openlbmpm_torch.kernels import csf as kc
    from openlbmpm_torch.kernels import transport as kt
    from openlbmpm_torch.models.transport import TransportParams
    from openlbmpm_torch.parallel import make_mesh
    params, bcs = flagship_flow()
    res = {}
    for seed, (name, tp) in enumerate(COUPLED_CASES.items()):
        for shape in K12_MESHES:
            mesh = make_mesh(shape=shape, kind="local", device=device)
            for t in (1, 2):
                step = kc.build_csf_sharded_step(
                    walled(n, n), params, mesh, torch.float64,
                    steps_per_call=t, bc_config=bcs,
                    transport_params=TransportParams(**tp))
                tag = f"K12a coupled case {name} {shape} T={t}"
                check(step is not None, f"{tag}: no sharded step")
                m = step.model
                x0 = m.pack(m.init_state(
                    m.flow.init_state_layers(1.0, 1.0, invading_rows=n // 5),
                    coupled_conc0(m.tp.num_tracers, n, n, seed)))
                kt.coupled_local_step.launches = 0
                a = _sharded(step, x0, calls)
                check(kt.coupled_local_step.launches == calls * mesh.size,
                      f"{tag}: {kt.coupled_local_step.launches} local "
                      f"launches for {calls} calls")
                ek = _gap(a, _steps(lambda x: kt.coupled_block_compressed(
                    x, m, t), x0, calls))
                ep = _gap(a, _steps(
                    lambda x: kt.coupled_block_compressed_reference(x, m, t),
                    x0, calls))
                check(all(bool(torch.isfinite(y).all()) for y in a) and
                      ek <= tol and ep <= tol_plain, f"{tag}: sharded vs "
                      f"K5c-T {ek:.3e} (<= {tol:g}), vs plain {ep:.3e} "
                      f"(<= {tol_plain:g})")
                res[(name, shape, t)] = (ek, ep)
    return res


def k12b_cases(ny=256, nx=128):
    """Phase 65's single-phase cases: name -> (geometry, tau, collision,
    body force, BoundaryConfig)."""
    from openlbmpm_torch.geometry import box_with_walls
    from openlbmpm_torch.models.single_phase import BoundaryConfig
    out = {"config1_box": (box_with_walls(nx, ny), 0.9, "MRT", (0.0, -1e-6),
                           BoundaryConfig())}
    for name in ("srt_convective", "trt_zou_he", "mrt_zou_he"):
        collision, bcs = SINGLE_CASES[name]
        out[name] = (walled(ny, nx), 0.8, collision, SINGLE_FORCE,
                     BoundaryConfig(**bcs))
    return out


def phase_sharded_single_f64(device, calls=2, tol=1e-12, tol_plain=1e-11):
    """K12b at f64 against K7-T and the plain step (see the module
    docstring, phase 65)."""
    from openlbmpm_torch.kernels import single as ks
    from openlbmpm_torch.parallel import make_mesh
    mesh = make_mesh(shape=(4, 1), kind="local", device=device)
    res = {}
    for seed, (name, (g, tau, coll, force, bcs)) in enumerate(
            k12b_cases().items()):
        for t in (1, 2):
            step = ks.build_single_sharded_step(
                g, tau, coll, force, mesh, bc_config=bcs,
                dtype=torch.float64, steps_per_call=t)
            tag = f"K12b {name} (4, 1) T={t}"
            check(step is not None, f"{tag}: no sharded step")
            m = step.model
            x0 = flow_start(m, seed=20 + seed)
            ks.single_local_step.launches = 0
            (a,) = _sharded(step, (x0,), calls)
            check(ks.single_local_step.launches == calls * mesh.size,
                  f"{tag}: {ks.single_local_step.launches} local launches "
                  f"for {calls} calls")
            ek = _gap(a, _steps(lambda x: ks.single_block_step(x, m, t), x0,
                                calls))
            ep = _gap(a, _steps(lambda x: ks.single_block_step_reference(
                x, m, t), x0, calls))
            check(bool(torch.isfinite(a).all()) and ek <= tol and
                  ep <= tol_plain, f"{tag}: sharded vs K7-T {ek:.3e} (<= "
                  f"{tol:g}), vs plain {ep:.3e} (<= {tol_plain:g})")
            res[(name, t)] = (ek, ep)
    return res


# least HBM bytes a cell of the state the sharded steps move (f32): the
# compressed flow state, with config 4's one D2Q5 tracer, the single-phase
# PDFs; each cell also has a 1-byte solid mask
K12_STATE_BYTES = {"flagship": 40, "config4": 40 + 20, "config1": 36}


def k12_bytes(step, state_bytes) -> int:
    """The least bytes of one call of a sharded step: each shard's padded
    state and mask read once, its centre written once, and the exchange's
    frame cells read and written once."""
    total = 0
    for g in step.grids:
        tail = int(np.prod(g.tail))
        padded, centre = g.py * g.px * tail, g.ny * g.nx * tail
        total += (state_bytes + 1) * padded + state_bytes * centre + \
            2 * state_bytes * (padded - centre)
    return total


def k12_full_cases(device, n=FLAGSHIP_N):
    """Phase 66's cases: name -> (label, builder thunk of T, single-device
    kernel of (x, model, T), plain version, start thunk of the model, key
    of K12_STATE_BYTES, the wrapper whose launches count)."""
    from openlbmpm_torch.kernels import csf as kc
    from openlbmpm_torch.kernels import single as ks
    from openlbmpm_torch.kernels import transport as kt
    from openlbmpm_torch.geometry import box_with_walls
    from openlbmpm_torch.models.single_phase import BoundaryConfig
    from openlbmpm_torch.models.transport import TransportParams
    from openlbmpm_torch.parallel import make_mesh
    params, bcs = flagship_flow()
    out = {}
    for shape in K12_MESHES:
        mesh = make_mesh(shape=shape, kind="local", device=device)
        out[f"flagship {shape}"] = (
            "K12a", lambda t, mesh=mesh: kc.build_csf_sharded_step(
                walled(n, n), params, mesh, torch.float32, steps_per_call=t,
                bc_config=bcs), kc.csf_block_compressed,
            kc.csf_block_compressed_reference,
            lambda m: (m.pack_state(*m.init_state_layers(
                1.0, 1.0, invading_rows=100 * n // 1024)),),
            "flagship", kc.csf_local_step)
    mesh = make_mesh(shape=(4, 1), kind="local", device=device)
    out["config4 (4, 1)"] = (
        "K12a coupled", lambda t: kc.build_csf_sharded_step(
            walled(n, n), params, mesh, torch.float32, steps_per_call=t,
            bc_config=bcs, transport_params=TransportParams(**CONFIG4_TRACER)),
        kt.coupled_block_compressed, kt.coupled_block_compressed_reference,
        lambda m: m.pack(config4_state(m, n)[0]), "config4",
        kt.coupled_local_step)
    out["config1 (4, 1)"] = (
        "K12b", lambda t: ks.build_single_sharded_step(
            box_with_walls(512, n), 0.9, "MRT", (0.0, -1e-6), mesh,
            bc_config=BoundaryConfig(), dtype=torch.float32,
            steps_per_call=t), ks.single_block_step,
        ks.single_block_step_reference, lambda m: (flow_start(m, seed=11),),
        "config1", ks.single_local_step)
    return out


def _exchange_only(step):
    def fn(state):
        step.exchange(state)
        return state
    return fn


def _one(x):
    return x if len(x) > 1 else x[0]


def phase_sharded_full(device, n=FLAGSHIP_N, steps=(10, 12), time_calls=40):
    """Phase 66 (see the module docstring): correctness, speed and launches
    of K12a and K12b at full width in f32, then the dry run."""
    res = {"cases": {}}
    away = seam_masks(n, n, max(steps), device)
    for name, (label, build_t, kern, plain, start, key, counter) in \
            k12_full_cases(device, n).items():
        for t, total in zip((1, 4), steps):
            calls = total // t
            step = build_t(t)
            tag = f"{label} {name} T={t}"
            check(step is not None, f"{tag}: no sharded step")
            m = step.model
            x0 = start(m)
            counter.launches = 0
            a = _sharded(step, x0, calls)
            launches = counter.launches
            check(launches == calls * step.mesh.size, f"{tag}: {launches} "
                  f"local launches for {calls} calls")
            b = _steps(lambda x: kern(x, m, t), _one(x0), calls)
            c = _steps(lambda x: plain(x, m, t), _one(x0), calls)
            b, c = (b,) if torch.is_tensor(b) else b, \
                (c,) if torch.is_tensor(c) else c
            r = {"launches": launches, "calls": calls,
                 "vs_kernel": _gap(a, b), "max": _gap(a, c)}
            check(all(bool(torch.isfinite(y).all()) for y in a),
                  f"{tag}: state not finite")
            if key == "config1":
                r["plain"] = r["max"]
                check(r["plain"] <= SINGLE_F32_BOUND, f"{tag}: sharded vs "
                      f"plain {r['plain']:.3e} (<= {SINGLE_F32_BOUND:g})")
            else:
                bp, br = (K3_BOUNDS[("CSF", "f32")] if key == "flagship"
                          else K5CT_BOUNDS["f32"])
                d = (a[0] - c[0]).abs()
                r["planes"] = float(d[:9, away].max())
                r["rho_r"] = float(d[9, away].max())
                r["g"] = float((a[1] - c[1]).abs()[:, :, away].max()) \
                    if key == "config4" else 0.0
                check(r["planes"] <= bp and r["rho_r"] <= br and
                      r["g"] <= bp, f"{tag} off the seam: planes "
                      f"{r['planes']:.3e}, rho_r {r['rho_r']:.3e}, tracers "
                      f"{r['g']:.3e} over {bp:g}/{br:g}")
            state = step.shard(*x0)
            r["sec"] = _time_steps(step, state, max(time_calls // t, 4),
                                   device) / t
            r["exchange_sec"] = _time_steps(_exchange_only(step), state,
                                            time_calls, device) / t
            r["kernel_sec"] = _time_steps(lambda x: kern(x, m, t), _one(x0),
                                          max(time_calls // t, 4), device) / t
            r["bound_ms"] = k12_bytes(step, K12_STATE_BYTES[key]) / \
                HBM_BYTES_PER_S * 1e3 / t
            r["frame"] = step.frame
            r["cells"] = step.ny * step.nx
            if t == 4 and name != "flagship (2, 2)":
                # the plain version of the local kernels: every shard's
                # padded buffer stepped in the whole domain
                from openlbmpm_torch.parallel.mesh import exchange
                exchange(step.mesh, state.bufs, step.frame,
                         step.grids[0].ny, step.grids[0].nx)
                ref = {"K12a": "csf", "K12a coupled": "coupled",
                       "K12b": "single"}[label]
                r["plain_sec"] = _time_local_plain(step, state, ref,
                                                   device) / t
            res["cases"][(name, t)] = r
            del step, state, a, b, c
            torch.cuda.empty_cache()
    res["dryrun"] = _dryrun_in_process()
    res["nccl"] = _dryrun_nccl()
    return res


def _time_local_plain(step, state, family, device):
    """Seconds of one call of the local kernels' plain versions over every
    shard (one pass, after a synchronise)."""
    from openlbmpm_torch.kernels import csf as kc
    from openlbmpm_torch.kernels import single as ks
    from openlbmpm_torch.kernels import transport as kt
    m, t = step.model, step.steps_per_call
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for g, ins in zip(step.grids, state.bufs):
        if family == "csf":
            kc.csf_local_step_reference(ins[0], m, g, t)
        elif family == "coupled":
            kt.coupled_local_step_reference(ins, m, g, t)
        else:
            ks.single_local_step_reference(ins[0], m, g, t)
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _dryrun_in_process():
    """``parallel.dryrun --in-process --device cuda`` in this process, the
    local launch counts set to 0 just before and read just after."""
    import contextlib
    import io
    from openlbmpm_torch.parallel import dryrun
    counters = {k: fn for k, fn in _launch_counters().items()
                if "_local_" in k}
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--in-process", "--device", "cuda", "--ranks", "4"])
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == len(dryrun.CASES),
          f"dryrun --in-process: rc {rc}, {len(lines)} lines")
    return {"lines": lines, "sec": time.perf_counter() - t0,
            "launches": {k: fn.launches for k, fn in counters.items()}}


def _dryrun_nccl(timeout=600):
    """``parallel.dryrun --device cuda --ranks 2|4`` over NCCL in a
    subprocess where the machine has two cards or more; None with one."""
    import os
    count = torch.cuda.device_count()
    if count < 2:
        return None
    ranks = 4 if count >= 4 else 2
    out = subprocess.run(
        [sys.executable, "-m", "openlbmpm_torch.parallel.dryrun", "--device",
         "cuda", "--ranks", str(ranks), "--timeout", str(timeout - 60)],
        capture_output=True, text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and len(lines) >= 4,
          f"dryrun over NCCL, {ranks} ranks: rc {out.returncode}\n"
          f"{out.stderr[-2000:]}")
    return {"ranks": ranks, "lines": lines}


def phase63_66_lines(r63, r64, r65, r66, card):
    lines = [
        f"phase 63 K12a f64, sharded vs single-device K3 / vs plain ({len(r63)} "
        "runs: CSF and Perturbation, 2 row kinds, 256^2 on (4, 1), (2, 2) at "
        "T = 1, 2, 4 and 104x256 on (4, 1) at T = 1, 2, the CSF Xu porous "
        "96x64 on (2, 2) at T = 1, 2, two calls): max "
        f"|diff| {max(v[0] for v in r63.values()):.3e} (<= 1e-12) / "
        f"{max(v[1] for v in r63.values()):.3e} (<= 1e-11)",
        f"phase 64 K12a coupled f64, sharded vs K5c-T / vs plain ({len(r64)} "
        "runs: phase 6's cases at 96^2 on (4, 1), (2, 2), T = 1, 2): max "
        f"|diff| {max(v[0] for v in r64.values()):.3e} (<= 1e-12) / "
        f"{max(v[1] for v in r64.values()):.3e} (<= 1e-11)",
        f"phase 65 K12b f64, sharded vs K7-T / vs plain ({len(r65)} runs: "
        + ", ".join(sorted({k[0] for k in r65})) + " at 256x128 on (4, 1), T "
        f"= 1, 2): max |diff| {max(v[0] for v in r65.values()):.3e} (<= "
        f"1e-12) / {max(v[1] for v in r65.values()):.3e} (<= 1e-11)"]
    for (name, t), r in r66["cases"].items():
        f = r["frame"]
        lines.append(
            f"phase 66 {name} f32 T={t} [{card}]: {r['calls']} calls, "
            f"{r['launches']} local launches; vs single-device kernel "
            f"{r['vs_kernel']:.3e}, vs plain max {r['max']:.3e}"
            + (f" (off the seam planes {r['planes']:.3e}, rho_r "
               f"{r['rho_r']:.3e}, tracers {r['g']:.3e})" if "planes" in r
               else "") +
            f"; ms a step sharded {r['sec'] * 1e3:.4f}, exchange "
            f"{r['exchange_sec'] * 1e3:.4f}, single-device kernel "
            f"{r['kernel_sec'] * 1e3:.4f}, bound {r['bound_ms']:.4f}"
            + (f", plain {r['plain_sec'] * 1e3:.2f}" if "plain_sec" in r
               else "") + f"; frame lo {f.lo} hi {f.hi} x {f.x}")
    d = r66["dryrun"]
    lines += [f"phase 66 dryrun --in-process --device cuda: {ln}"
              for ln in d["lines"]]
    lines.append(f"phase 66 dryrun --in-process: {d['sec']:.1f} s, local "
                 "launches " + ", ".join(f"{k} {v}" for k, v in
                                         d["launches"].items()))
    if r66["nccl"] is None:
        lines.append("phase 66 nccl: not run (1 card); its lines, the 3-D "
                     "ones of K12d and K12e among them, run wherever two "
                     "cards exist")
    else:
        lines += [f"phase 66 nccl {r66['nccl']['ranks']} ranks: {ln}"
                  for ln in r66["nccl"]["lines"]]
    return lines


def phase63_66_entries(r63, r64, r65, r66):
    """The kernels line's entries of K12a, K12a with transport and K12b: ms,
    plain ms and bound a time step at T = 4 on the (4, 1) mesh, launches
    from phase 66's main path at T = 4 (and at T = 1 beside), max_abs_err
    the f32 gap to the plain step."""
    entries = []
    for name, label, source, tpu, key, ops, f64 in (
            ("csf_local_step", "K12a", "openlbmpm_torch/csrc/csf2d_block.cuh "
             "(csf2d_local_{f64,f32}.cu)", "openlbmpm_tpu/pallas/csf.py:1954 "
             "(local kernel call :1896)", "flagship (4, 1)", CSF_OPS, r63),
            ("coupled_local_step", "K12a coupled",
             "openlbmpm_torch/csrc/coupled2d_block.cuh "
             "(coupled2d_local_{f64,f32}.cu)",
             "openlbmpm_tpu/pallas/csf.py:1954 (transport_params; local "
             "kernel call :1896)", "config4 (4, 1)", CSF_OPS + TRACER2D_OPS,
             r64),
            ("single_local_step", "K12b", "openlbmpm_torch/csrc/"
             "single2d_block.cuh (single2d_local_{f64,f32}.cu)",
             "openlbmpm_tpu/pallas/single.py:459 (local kernel call :418)",
             "config1 (4, 1)", SINGLE_OPS, r65)):
        r, r1 = r66["cases"][(key, 4)], r66["cases"][(key, 1)]
        cells = r["cells"]
        nbytes = r["bound_ms"] * 1e-3 * HBM_BYTES_PER_S / cells
        entries.append(kernel_entry(
            name, label, source, tpu, r["launches"],
            r["max"], r["sec"], r["plain_sec"], nbytes, ops, cells,
            steps_per_call=4, mesh=[4, 1], launches_t1=r1["launches"],
            max_abs_err_f64=max(
                v[1] for v in f64.values()),
            ms_t1=r1["sec"] * 1e3, bound_ms_t1=r1["bound_ms"],
            exchange_ms=r["exchange_sec"] * 1e3,
            exchange_ms_t1=r1["exchange_sec"] * 1e3,
            single_device_ms=r["kernel_sec"] * 1e3,
            single_device_ms_t1=r1["kernel_sec"] * 1e3,
            vs_single_device=max(r["vs_kernel"], r1["vs_kernel"])))
    return entries


# -- the 3-D sharded steps: K12d (D3Q19 CSF, with tracers) and K12e (D3Q19
# Shan-Chen), one shard a local launch -------------------------------------

K12D_MESHES = ((4, 1), (2, 2))


def k12d_cases(device):
    """Phase 67's flow cases: name -> (builder thunk of a mesh, start
    thunk of the model, meshes).  Configuration 5 (its grain pack, CONFIG5's
    parameters: velocity inlet, convective outlet) at 64^3 on both meshes;
    walled 24x40x32 channels with the convective and the Dirichlet outlet
    on (6, 1) and (4, 1), shards of 4 and 6 slabs, so that the outlet's
    cascade (slab 0 takes slab 3's value) ends on the bottom shard's last
    centre slab, next to the seam, or crosses an odd depth."""
    from openlbmpm_torch.geometry import from_solid_mask
    from openlbmpm_torch.kernels.cg3d import build_cg3d_sharded_step
    from openlbmpm_torch.models.flow3d import (CG3DBoundaryConfig,
                                               ColorGradientParams3D)
    out = {}
    p5, b5 = ColorGradientParams3D(**CONFIG5[0]), CG3DBoundaryConfig(
        **CONFIG5[1])
    out["config5 64^3"] = (
        lambda mesh: build_cg3d_sharded_step(
            from_solid_mask(grain_pack(64)), p5, mesh, torch.float64,
            bc_config=b5), lambda m: _noisy_slabs(m, 31, 8), K12D_MESHES)
    for name in ("velocity_convective", "velocity_dirichlet"):
        p, b, kind, _ = CG3D_CASES[name]
        out[f"{name} 24x40x32"] = (
            lambda mesh, p=p, b=b, kind=kind: build_cg3d_sharded_step(
                from_solid_mask(cg3d_solid(kind, (24, 40, 32))),
                ColorGradientParams3D(**p), mesh, torch.float64,
                bc_config=CG3DBoundaryConfig(**b)),
            lambda m: _noisy_slabs(m, 32, 6), ((6, 1), (4, 1)))
    return out


def _noisy_slabs(m, seed, slabs):
    """The compressed start of a ColorGradientRK3D: red in the top `slabs`
    slabs, each colour's PDFs scaled by 1 + 1e-3 noise (a numpy seed)."""
    f_r, f_b = m.init_state_layers(1.0, 1.0, invading_slabs=slabs)
    rng = np.random.default_rng(seed)

    def noise():
        return torch.as_tensor(1 + 1e-3 * rng.standard_normal(f_r.shape),
                               dtype=f_r.dtype, device=f_r.device)
    return m.pack_state(f_r * noise(), f_b * noise())


def tracer3d_of(model, device, dtype=torch.float32):
    """A TransportD3Q7 on `device` with the tracer arguments of `model`'s
    (a TransportRK3D): what ``build_cg3d_sharded_step`` takes."""
    from openlbmpm_torch.models.flow3d import TransportD3Q7
    t = model.transport
    return TransportD3Q7(model.geo, t.num_tracers, tuple(t.tau),
                         tuple(t.j_coeffs[:, 0]), t.criteria,
                         t.interface_mode, dtype=dtype, device=device)


def phase_sharded_cg3d_f64(device, calls=2, tol=1e-12, tol_plain=1e-11):
    """K12d at f64 against the single-device K9 / K9t and the plain step
    (see the module docstring, phase 67)."""
    from openlbmpm_torch.kernels import cg3d as kg
    from openlbmpm_torch.parallel import make_mesh
    res = {}
    for name, (build_on, start, meshes) in k12d_cases(device).items():
        for shape in meshes:
            mesh = make_mesh(shape=shape, kind="local", device=device)
            step = build_on(mesh)
            tag = f"K12d {name} {shape}"
            check(step is not None, f"{tag}: no sharded step")
            m = step.model
            x0 = start(m)
            kg.cg3d_local_step.launches = 0
            (a,) = _sharded(step, (x0,), calls)
            check(kg.cg3d_local_step.launches == calls * mesh.size,
                  f"{tag}: {kg.cg3d_local_step.launches} local launches for "
                  f"{calls} calls")
            ek = _gap(a, _steps(lambda x: kg.cg3d_step_compressed(x, m), x0,
                                calls))
            ep = _gap(a, _steps(m.plain_step_c, x0, calls)) \
                if "config5" not in name else 0.0
            check(bool(torch.isfinite(a).all()) and ek <= tol and
                  ep <= tol_plain, f"{tag}: sharded vs K9 {ek:.3e} (<= "
                  f"{tol:g}), vs plain {ep:.3e} (<= {tol_plain:g})")
            res[(name, shape)] = (ek, ep)
    # the coupled step: the probe and a two-tracer Dirichlet case
    for name in ("probe", "dirichlet_nt2"):
        m0, st = transport3d_case(name, device)
        mesh = make_mesh(shape=(4, 1), kind="local", device=device)
        step = kg.build_cg3d_sharded_step(
            m0.geo, m0.flow.p, mesh, torch.float64, bc_config=m0.flow.bcs,
            transport=tracer3d_of(m0, device, torch.float64))
        tag = f"K12d coupled {name} (4, 1)"
        check(step is not None, f"{tag}: no sharded step")
        m = step.model
        x0 = m.pack(st)
        kg.coupled3d_local_step.launches = 0
        a = _sharded(step, x0, calls)
        check(kg.coupled3d_local_step.launches == calls * mesh.size,
              f"{tag}: {kg.coupled3d_local_step.launches} local launches")
        ek = _gap(a, _steps(lambda x: kg.coupled3d_step_compressed(*x, m),
                            x0, calls))
        ep = _gap(a, _steps(m.plain_step_c, x0, calls))
        check(all(bool(torch.isfinite(y).all()) for y in a) and ek <= tol and
              ep <= tol_plain, f"{tag}: sharded vs K9t {ek:.3e} (<= {tol:g}),"
              f" vs plain {ep:.3e} (<= {tol_plain:g})")
        res[("coupled " + name, (4, 1))] = (ek, ep)
    return res


def phase_sharded_sc3d_f64(device, calls=2, tol=1e-12, tol_plain=1e-11):
    """K12e at f64 against the single-device K10 (T steps), K10-T and the
    plain step (see the module docstring, phase 68)."""
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.parallel import make_mesh
    mesh = make_mesh(shape=(4, 1), kind="local", device=device)
    res = {}
    for name, ts in (("k2_walls_force", (1, 2, 4)), ("k4_walls_force", (2,))):
        m0, f0 = sc3d_case(name, device)
        for t in ts:
            step = kf.build_sc3d_sharded_step(m0.geo, m0.p, mesh,
                                              torch.float64, steps_per_call=t)
            tag = f"K12e {name} (4, 1) T={t}"
            check(step is not None, f"{tag}: no sharded step")
            m = step.model
            kf.sc3d_local_step.launches = 0
            (a,) = _sharded(step, (f0,), calls)
            check(kf.sc3d_local_step.launches == calls * mesh.size,
                  f"{tag}: {kf.sc3d_local_step.launches} local launches")
            e1 = _gap(a, _steps(lambda x: kf.sc3d_step(x, m), f0, calls * t))
            et = _gap(a, _steps(lambda x: kf.sc3d_block_step(x, m, t), f0,
                                calls))
            ep = _gap(a, _steps(m.plain_step, f0, calls * t))
            check(bool(torch.isfinite(a).all()) and max(e1, et) <= tol and
                  ep <= tol_plain, f"{tag}: sharded vs K10 {e1:.3e}, vs "
                  f"K10-T {et:.3e} (<= {tol:g}), vs plain {ep:.3e} (<= "
                  f"{tol_plain:g})")
            res[(name, t)] = (e1, et, ep)
    return res


# least HBM bytes a cell of the 3-D states (f32): the compressed D3Q19 CSF
# state, with the probe's one D3Q7 tracer, two Shan-Chen fluids; each cell
# also has a 1-byte solid mask
K12_STATE_BYTES_3D = {"config5": 80, "probe": 80 + 28, "probe_sc3d": 152}


def k12_3d_full_cases(device):
    """Phase 69's cases: name -> (label, builder thunk, single-device
    kernel of (x, model, T), start thunk of the model, key of
    K12_STATE_BYTES_3D, steps per call, calls)."""
    from openlbmpm_torch.kernels import cg3d as kg
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.parallel import make_mesh
    out = {}
    for n in (128, 256):
        for shape in K12D_MESHES:
            mesh = make_mesh(shape=shape, kind="local", device=device)
            out[f"config5 {n}^3 {shape}"] = (
                "K12d", lambda mesh=mesh, n=n: kg.build_cg3d_sharded_step(
                    config5_model(device, n=n).geo, config5_model(
                        device, n=n).p, mesh, torch.float32,
                    bc_config=config5_model(device, n=n).bcs),
                lambda x, m, t: (kg.cg3d_step_compressed(x[0], m),),
                lambda m: (m.pack_state(*config5_start(m)),), "config5", 1,
                10 if n == 128 else 4)
    mesh = make_mesh(shape=(4, 1), kind="local", device=device)

    def probe_step():
        m0 = probe3d_model(device)
        return kg.build_cg3d_sharded_step(
            m0.geo, m0.flow.p, mesh, torch.float32, bc_config=m0.flow.bcs,
            transport=tracer3d_of(m0, device))
    out["probe 128^3 (4, 1)"] = (
        "K12d coupled", probe_step,
        lambda x, m, t: kg.coupled3d_step_compressed(*x, m),
        lambda m: m.pack(probe3d_start(m)), "probe", 1, 10)
    for t in (1, 4):
        out[f"probe_sc3d 128^3 (4, 1) T={t}"] = (
            "K12e", lambda t=t: kf.build_sc3d_sharded_step(
                probe_sc3d_model(device).geo, probe_sc3d_model(device).p,
                mesh, torch.float32, steps_per_call=t),
            lambda x, m, t: (_steps(lambda y: kf.sc3d_step(y, m), x[0],
                                    t),),
            lambda m: (probe_sc3d_start(m),), "probe_sc3d", t, 12 // t)
    return out


def _counted_call(step, counters, x0, calls):
    """`calls` calls of `step` from the global arrays `x0`, the launch
    counts of `counters` set to 0 just before and read just after: (the
    gathered arrays, {name: launches})."""
    for fn in counters.values():
        fn.launches = 0
    a = _sharded(step, x0, calls)
    return a, {k: fn.launches for k, fn in counters.items()}


def _seconds(fn, device):
    """Seconds of fn() on the host clock between two synchronises."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0


# f32 limit of phase 69's comparisons of the local kernels with their plain
# versions, one call from the same padded buffers: K12e and the slab kernel
# everywhere, K12d's step off the seam (``_hold_local``)
K12_3D_F32_PLAIN_TOL = 1e-5


def _cell_gap(a, b):
    """max |a - b| over the leading axes of two (..., nz, ny, nx) arrays: a
    (nz, ny, nx) array of cells."""
    return (a - b).abs().reshape(-1, *a.shape[-3:]).amax(0)


def _local_vs_plain_3d(step, state, label, device):
    """K12d's / K12e's local kernels against their plain versions on the
    same padded buffers of `state`, one call: each shard's slab kernel (the
    step's prologue) against ``cg3d_local_slabs_reference`` of a copy of its
    buffer taken before, then, after the exchange, each shard's local step
    (``step.local``) against its plain version on the buffers it read.
    Returns {"step": max |diff| of the step's centres, "sec": the plain
    step's seconds for one call over every shard, with boundary slabs
    "slabs", "slabs_sec" the same of the slab kernel over the shards that
    hold them, and for K12d "cells": shard by shard, for the flow state
    (and the tracers) the (nz, ny, nx) arrays of the kernel's gap and of
    the gap of the plain version's one-ulp twin (``_twin`` of its
    input)}."""
    from openlbmpm_torch.kernels import cg3d as kg
    from openlbmpm_torch.kernels import flow3d as kf
    m, t = step.model, step.steps_per_call
    flow = getattr(m, "flow", m)
    plain = {"K12e": lambda g, x: (kf.sc3d_local_step_reference(
                 x[0], m, g, t),),
             "K12d": lambda g, x: (kg.cg3d_local_step_reference(
                 x[0], m, g),),
             "K12d coupled": lambda g, x: kg.coupled3d_local_step_reference(
                 x, m, g)}[label]
    res = {}

    def timed(fn):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    if step.prologue is not None:
        owners = [i for i, g in enumerate(step.grids)
                  if kg._owns_slabs(flow, g)]
        before = {i: state.bufs[i][0].clone() for i in owners}
        for k, g, ins in zip(step.ids, step.grids, state.bufs):
            step.prologue(k, g, ins)
        refs, res["slabs_sec"] = timed(lambda: {
            i: kg.cg3d_local_slabs_reference(before[i], flow, step.grids[i])
            for i in owners})
        res["slabs"] = max(_gap(step.grids[i].centre(state.bufs[i][0]),
                                refs[i]) for i in owners)
        del before, refs
    step.exchange(state)
    for k, g, ins, outs in zip(step.ids, step.grids, state.bufs,
                               state.spare):
        step.local(k, g, ins, outs)
    refs, res["sec"] = timed(lambda: [plain(g, x) for g, x in
                                      zip(step.grids, state.bufs)])
    res["step"] = max(_gap(tuple(g.centre(o) for o in outs), ref)
                      for g, outs, ref in zip(step.grids, state.spare, refs))
    if label != "K12e":
        res["cells"] = []
        for g, x, outs, ref in zip(step.grids, state.bufs, state.spare,
                                   refs):
            twin = plain(g, tuple(_twin(y, i) for i, y in enumerate(x)))
            res["cells"].append([(_cell_gap(g.centre(o), r),
                                  _cell_gap(w, r))
                                 for o, r, w in zip(outs, ref, twin)])
    return res


def _hold_local(tag, step, cells, device):
    """One call of K12d against its plain version, state by state over the
    shards' centres: <= the limit off the seam (``cg3d_masks``' away after
    one step: the periodic z seam where the red inlet slabs meet the blue
    outlet slabs is an interface, whose f32 rounding the recolouring
    amplifies, phase 21); on it <= the limit or 1.5x the plain version's own
    gap to its one-ulp twin.  Returns {state: (max, off the seam, twin
    max)}."""
    from openlbmpm_torch.parallel.mesh import take_centre
    flow = getattr(step.model, "flow", step.model)
    away = cg3d_masks(flow, 1, device)[0]
    lim = K12_3D_F32_PLAIN_TOL
    out = {}
    for j, what in enumerate(("flow", "tracers")[:len(cells[0])]):
        r = [0.0] * 3
        for g, per in zip(step.grids, cells):
            d, w = per[j]
            for i, v in enumerate((d, d[take_centre(away, g)], w)):
                if v.numel():
                    r[i] = max(r[i], float(v.max()))
        out[what] = tuple(r)
        check(r[1] <= lim, f"{tag} {what}: local kernel vs plain off the "
              f"seam {r[1]:.3e} > {lim:g}")
        check(r[0] <= max(lim, 1.5 * r[2]), f"{tag} {what}: local kernel "
              f"vs plain {r[0]:.3e} > max({lim:g}, 1.5 x plain twin "
              f"{r[2]:.3e})")
    return out


def _host_seconds(step, state, n, device):
    """The host's seconds to issue one call of `step`, without waiting for
    the card: `n` calls after a synchronise, on the host clock."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        state = step(state)
    sec = (time.perf_counter() - t0) / n
    torch.cuda.synchronize(device)
    return sec


# kernel-name pieces of phase 69's device breakdown, in order: a kernel
# counts under the first piece its name holds ("other" for the rest: the
# exchange's copies)
K12_KERNEL_GROUPS = ("collide_stream", "sc_push", "march", "rt3_",
                     "local_bc", "tracer_collide", "tracer_stream",
                     "fields_kernel")


def device_breakdown(step, x, steps, groups=K12_KERNEL_GROUPS):
    """Device µs a launch of each group of `groups` (and "other") over
    `steps` calls x = step(x), from torch.profiler, after a warm-up: the
    mean over the launches the trace holds (it may drop some, so no total a
    call is taken from it); empty where it shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        x = step(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            x = step(x)
        torch.cuda.synchronize()
    sums = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total",
                    getattr(ev, "cuda_time_total", 0.0))
        if t and ev.count and getattr(ev, "device_type", None) in (
                None, torch.autograd.DeviceType.CUDA):
            key = next((g for g in groups if g in ev.key), "other")
            total, count = sums.get(key, (0.0, 0))
            sums[key] = (total + t, count + ev.count)
    return {k: t / n for k, (t, n) in sums.items()}


def _local_only(step):
    """One call's local kernels alone, on buffers as they stand."""
    def fn(state):
        for k, g, ins, outs in zip(step.ids, step.grids, state.bufs,
                                   state.spare):
            step.local(k, g, ins, outs)
        return state
    return fn


def _prologue_only(step):
    def fn(state):
        for k, g, ins in zip(step.ids, step.grids, state.bufs):
            step.prologue(k, g, ins)
        return state
    return fn


def phase_sharded3d_full(device, time_calls=20):
    """Phase 69 (see the module docstring): correctness, speed and launches
    of K12d and K12e at full width in f32."""
    import math
    from openlbmpm_torch.kernels import cg3d as kg
    from openlbmpm_torch.kernels import flow3d as kf
    counters = {"cg3d_local_step": kg.cg3d_local_step,
                "cg3d_local_slabs": kg.cg3d_local_slabs,
                "coupled3d_local_step": kg.coupled3d_local_step,
                "sc3d_local_step": kf.sc3d_local_step}
    res = {}
    for name, (label, build_t, kern, start, key, t, calls) in \
            k12_3d_full_cases(device).items():
        step = build_t()
        tag = f"{label} {name}"
        check(step is not None, f"{tag}: no sharded step")
        m = step.model
        x0 = start(m)
        a, launches = _counted_call(step, counters, x0, calls)
        main = {"K12d": "cg3d_local_step", "K12e": "sc3d_local_step",
                "K12d coupled": "coupled3d_local_step"}[label]
        check(launches[main] == calls * step.mesh.size, f"{tag}: "
              f"{launches[main]} local launches for {calls} calls")
        b = _steps(lambda x: kern(x, m, t), x0, calls)
        r = {"launches": launches, "calls": calls, "steps": t,
             "vs_kernel": _gap(a, b), "mesh": step.mesh.shape}
        check(all(bool(torch.isfinite(y).all()) for y in a),
              f"{tag}: state not finite")
        # f32 rounding only: the local kernels run the single-device
        # kernels' arithmetic (phases 67-68 hold them bit for bit at f64)
        check(r["vs_kernel"] <= 1e-5, f"{tag}: sharded vs single-device "
              f"{r['vs_kernel']:.3e} (<= 1e-5)")
        state = step.shard(*x0)
        n_time = max(time_calls // t, 4) if "256" not in name else 6
        r["sec"] = _time_steps(step, state, n_time, device) / t
        r["host_sec"] = _host_seconds(step, state, n_time, device) / t
        r["exchange_sec"] = _time_steps(_exchange_only(step), state,
                                        time_calls, device) / t
        if step.prologue is not None:
            r["slabs_sec"] = _time_steps(_prologue_only(step), state,
                                         time_calls, device) / t
        r["local_sec"] = _time_steps(_local_only(step), state, n_time,
                                     device) / t
        r["kernel_sec"] = _time_steps(lambda x: kern(x, m, t), x0, n_time,
                                      device) / t
        if label == "K12e":
            r["block_sec"] = _time_steps(
                lambda x: (kf.sc3d_block_step(x[0], m, t),), x0, n_time,
                device) / t
        if "256" not in name:
            r["device_us"] = device_breakdown(step, state, 4)
            r["device_us_single"] = device_breakdown(
                lambda x: kern(x, m, t), x0, 4)
            check(not {"tracer_collide", "tracer_stream"} & (
                set(r["device_us"]) | set(r["device_us_single"])),
                f"{tag}: a tracer pass in the trace")
        cells = math.prod(step.shape)
        r["cells"] = cells
        r["bound_ms"] = k12_bytes(step, K12_STATE_BYTES_3D[key]) / \
            HBM_BYTES_PER_S * 1e3 / t
        r["frame"] = step.frame
        p = _local_vs_plain_3d(step, state, label, device)
        r["vs_plain"], r["plain_sec"] = p["step"], p["sec"] / t
        if "cells" in p:
            r["hold"] = _hold_local(tag, step, p["cells"], device)
        else:
            check(r["vs_plain"] <= K12_3D_F32_PLAIN_TOL, f"{tag}: local "
                  f"kernel vs plain {r['vs_plain']:.3e} "
                  f"(<= {K12_3D_F32_PLAIN_TOL:g})")
        if "slabs" in p:
            r["slabs_vs_plain"], r["slabs_plain_sec"] = \
                p["slabs"], p["slabs_sec"] / t
            check(r["slabs_vs_plain"] <= K12_3D_F32_PLAIN_TOL,
                  f"{tag}: slab kernel vs plain {r['slabs_vs_plain']:.3e} "
                  f"(<= {K12_3D_F32_PLAIN_TOL:g})")
        del p
        res[name] = r
        del step, state, a, b
        torch.cuda.empty_cache()
    return res


def phase67_69_lines(r67, r68, r69, card):
    lines = [
        f"phase 67 K12d f64, sharded vs single-device K9 / K9t and vs plain "
        f"({len(r67)} runs: config 5 64^3 on (4, 1), (2, 2); walled "
        "24x40x32 convective and Dirichlet outlets on (6, 1), (4, 1); the "
        "coupled probe and a two-tracer Dirichlet case at 48x40x32 on (4, "
        f"1); two calls): max |diff| {max(v[0] for v in r67.values()):.3e} "
        f"(<= 1e-12) / {max(v[1] for v in r67.values()):.3e} (<= 1e-11)",
        f"phase 68 K12e f64, sharded vs K10 (T steps) / K10-T / plain "
        f"({len(r68)} runs: K = 2 at T = 1, 2, 4 and K = 4 at T = 2, "
        "48x40x32 on (4, 1), two calls): max |diff| "
        f"{max(v[0] for v in r68.values()):.3e} / "
        f"{max(v[1] for v in r68.values()):.3e} (<= 1e-12) / "
        f"{max(v[2] for v in r68.values()):.3e} (<= 1e-11)"]
    for name, r in r69.items():
        f = r["frame"]
        launches = ", ".join(f"{k} {v}" for k, v in r["launches"].items()
                             if v)
        lines.append(
            f"phase 69 {name} f32 [{card}]: {r['calls']} calls, launches "
            f"{launches}; vs single-device kernel {r['vs_kernel']:.3e}; "
            f"local kernels vs plain, one call {r['vs_plain']:.3e}"
            + "".join(f" ({k}: off the seam {v[1]:.3e}, plain one-ulp "
                      f"twin {v[2]:.3e})"
                      for k, v in r.get("hold", {}).items())
            + (f", slab kernel vs plain {r['slabs_vs_plain']:.3e}"
               if "slabs_vs_plain" in r else "")
            + f" (limit {K12_3D_F32_PLAIN_TOL:g}); ms a "
            f"step sharded {r['sec'] * 1e3:.4f}, exchange "
            f"{r['exchange_sec'] * 1e3:.4f}"
            + (f", slabs {r['slabs_sec'] * 1e3:.4f}" if "slabs_sec" in r
               else "")
            + f", local kernels {r['local_sec'] * 1e3:.4f}"
            + f", host issue {r['host_sec'] * 1e3:.4f}"
            + f", single-device {r['kernel_sec'] * 1e3:.4f}"
            + (f" (K10-T {r['block_sec'] * 1e3:.4f})" if "block_sec" in r
               else "")
            + f", bound {r['bound_ms']:.4f}"
            + f", plain {r['plain_sec'] * 1e3:.2f}"
            + f"; frame lo {f.lo} hi {f.hi} x {f.x}")
        for key in ("device_us", "device_us_single"):
            if key in r:
                d = r[key]
                lines.append(
                    f"phase 69 {name} device µs a launch "
                    + ("sharded" if key == "device_us" else
                       "single-device kernel") + f" [{card}]: " + ", ".join(
                        f"{k} {v:.1f}" for k, v in sorted(
                            d.items(), key=lambda kv: -kv[1])))
    return lines


# least operations per cell-step of the 3-D kernels (see CSF_OPS): K9, K9t
# with one tracer, K10 with two fluids
K9_OPS, K9T_OPS, K10_OPS = 374, 413, 474
# least bytes a column of the boundary-slab kernel: the convective outlet
# reads slab 3 and writes slabs 0-2, the inlet reads slab nz-2 and writes
# it and its ghost (80 B a cell each, f32), with a 1-byte mask a slab
K12D_SLAB_BYTES = (80 + 3 * 80 + 3) + (80 + 2 * 80 + 2)


def phase67_69_entries(r67, r68, r69):
    """The kernels line's entries of K12d (step, slabs, coupled) and K12e:
    ms, plain ms and bound a time step on (4, 1) at 128^3 (K12e at T = 4),
    launches from phase 69's main path, max_abs_err the largest f32 gap to
    the plain version over phase 69's runs of the kernel (one call from the
    same padded buffers; for K12d's step also off the seam),
    vs_single_device the gap of the sharded step to the single-device
    kernel."""
    entries = []

    def vs_plain(labels, key="vs_plain"):
        return max(r[key] for n, r in r69.items() if key in r and
                   n.split()[0] in labels)

    def off_seam(labels):
        return max(v[1] for n, r in r69.items() if n.split()[0] in labels
                   for v in r.get("hold", {}).values())
    c5, c5_1 = r69["config5 128^3 (4, 1)"], r69["config5 256^3 (4, 1)"]
    pr = r69["probe 128^3 (4, 1)"]
    sc4, sc1 = r69["probe_sc3d 128^3 (4, 1) T=4"], \
        r69["probe_sc3d 128^3 (4, 1) T=1"]
    f64_d = max(v[0] for v in r67.values())
    f64_e = max(max(v[:2]) for v in r68.values())
    tpu_d = "openlbmpm_tpu/pallas/cg3d.py:1381 (local kernel call :1096)"
    for name, label, r, key, ops, extra in (
            ("cg3d_local_step", "K12d", c5, "config5", K9_OPS, dict(
                ms_256=c5_1["sec"] * 1e3, bound_ms_256=c5_1["bound_ms"],
                single_device_ms_256=c5_1["kernel_sec"] * 1e3,
                ms_2x2=r69["config5 128^3 (2, 2)"]["sec"] * 1e3)),
            ("coupled3d_local_step", "K12d coupled", pr, "probe", K9T_OPS,
             {})):
        nbytes = r["bound_ms"] * 1e-3 * HBM_BYTES_PER_S / r["cells"]
        entries.append(kernel_entry(
            name, label, "openlbmpm_torch/csrc/cg3d_local.cuh "
            "(cg3d_local_{f64,f32}.cu, on cg3d.cuh)",
            tpu_d if "coupled" not in label else tpu_d + " (transport=)",
            r["launches"][name], vs_plain(("probe",) if "coupled" in label
                                          else ("config5",)),
            r["sec"], r["plain_sec"], nbytes, ops, r["cells"], mesh=[4, 1],
            max_abs_err_off_seam=off_seam(("probe",) if "coupled" in label
                                          else ("config5",)),
            vs_single_device=r["vs_kernel"], max_abs_err_f64=f64_d,
            exchange_ms=r["exchange_sec"] * 1e3,
            single_device_ms=r["kernel_sec"] * 1e3, **extra))
    # the slab kernel: its own time a call over the shards holding boundary
    # slabs, its bound that of the slabs' columns
    entries.append(kernel_entry(
        "cg3d_local_slabs", "K12d slabs", "openlbmpm_torch/csrc/"
        "cg3d_local.cuh (local_bc_kernel)", tpu_d + " (its jnp prologue "
        ":1474, :1519-1522)", c5["launches"]["cg3d_local_slabs"],
        vs_plain(("config5", "probe"), "slabs_vs_plain"), c5["slabs_sec"],
        c5["slabs_plain_sec"],
        K12D_SLAB_BYTES, 0, 128 * 128, mesh=[4, 1], max_abs_err_f64=f64_d))
    nbytes = sc4["bound_ms"] * 1e-3 * HBM_BYTES_PER_S / sc4["cells"]
    entries.append(kernel_entry(
        "sc3d_local_step", "K12e", "openlbmpm_torch/csrc/flow3d_local.cuh "
        "(flow3d_local_{f64,f32}.cu, on flow3d.cuh and sc3d_rt.cuh)",
        "openlbmpm_tpu/pallas/sc3d.py:419 (local kernel call :378)",
        sc4["launches"]["sc3d_local_step"], vs_plain(("probe_sc3d",)),
        sc4["sec"], sc4["plain_sec"], nbytes, K10_OPS, sc4["cells"],
        steps_per_call=4, mesh=[4, 1], max_abs_err_f64=f64_e,
        vs_single_device=max(sc4["vs_kernel"], sc1["vs_kernel"]),
        launches_t1=sc1["launches"]["sc3d_local_step"],
        ms_t1=sc1["sec"] * 1e3, bound_ms_t1=sc1["bound_ms"],
        exchange_ms=sc4["exchange_sec"] * 1e3,
        single_device_ms=sc4["kernel_sec"] * 1e3,
        single_device_block_ms=sc4["block_sec"] * 1e3,
        single_device_ms_t1=sc1["kernel_sec"] * 1e3))
    return entries


# -- the sharded 2-D Shan-Chen step: K12c, one shard a local call -----------

K12C_MESHES = ((4, 1), (2, 1))


def k12c_cases(device, dtype=torch.float64):
    """Phase 70's cases: name -> (model of the global domain, noisy start):
    bench_all.py configs 2 and 3 at 256^2, the case of tests/test_multichip
    .py:278-315 (64x64, side walls, Zou-He velocity inlet, convective
    outlet), the EFS iso-10 Zou-He velocity / pressure case at 104x64
    (shards of 26 and 52 rows), the Peng-Robinson droplet and four fluids
    (the runtime-K local passes) with the convective outlet at 128x64 and
    with the Zou-He pressure outlet at 104x64."""
    from openlbmpm_torch.parallel import dryrun
    out = {}
    for name in ("config2", "config3"):
        m, f = sc_config(name, device, dtype=dtype, n=256)
        out[f"{name} 256^2"] = (m, f)
    from openlbmpm_torch.models.shanchen import ShanChenMCMP
    g, kw, (f,) = dryrun.case_model("sc", (64, 64), dtype)
    m = ShanChenMCMP(g, kw["params"], kw["bc_config"], dtype=dtype,
                     device=device)
    out["multichip 64^2"] = (m, f.to(device))
    for name, ny in (("efs10_mrt_velocity_pressure", 104),
                     ("sc_peng_robinson_one_fluid", 128),
                     ("sc4_mrt_velocity_convective", 128),
                     ("efs4_4f_velocity_pressure", 104)):
        out[f"{name} {ny}x64"] = sc_case(name, device, ny, 64, dtype)
    rng = np.random.default_rng(70)
    return {k: (m, f * torch.as_tensor(
        1 + 1e-3 * rng.standard_normal(tuple(f.shape)), dtype=f.dtype,
        device=f.device) * m.fluid_mask) for k, (m, f) in out.items()}


def phase_sharded_sc_f64(device, calls=2, tol=1e-12, tol_plain=1e-12):
    """K12c at f64 against the single-device K8-T at the same T, K8 (T
    steps) and the plain step (see the module docstring, phase 70)."""
    from openlbmpm_torch.kernels import shanchen as ks
    from openlbmpm_torch.parallel import make_mesh
    res = {}
    for name, (m0, f0) in k12c_cases(device).items():
        for shape in K12C_MESHES:
            mesh = make_mesh(shape=shape, kind="local", device=device)
            for t in (1, 2):
                step = ks.build_sc_sharded_step(
                    m0.geo, m0.p, mesh, torch.float64, steps_per_call=t,
                    bc_config=m0.bcs)
                tag = f"K12c {name} {shape} T={t}"
                check(step is not None, f"{tag}: no sharded step")
                m = step.model
                ks.sc_local_step.launches = 0
                (a,) = _sharded(step, (f0,), calls)
                check(ks.sc_local_step.launches == calls * mesh.size,
                      f"{tag}: {ks.sc_local_step.launches} local launches")
                et = _gap(a, _steps(lambda x: ks.sc_block_step(x, m, t), f0,
                                    calls))
                e1 = _gap(a, _steps(lambda x: ks.sc_step(x, m), f0,
                                    calls * t))
                ep = _gap(a, _steps(m.plain_step, f0, calls * t))
                check(bool(torch.isfinite(a).all()) and max(et, e1) <= tol
                      and ep <= tol_plain, f"{tag}: sharded vs K8-T "
                      f"{et:.3e}, vs K8 {e1:.3e} (<= {tol:g}), vs plain "
                      f"{ep:.3e} (<= {tol_plain:g})")
                res[(name, shape, t)] = (et, e1, ep)
    return res


# least HBM bytes a cell of the two- and four-fluid states (f32)
K12C_STATE_BYTES = {2: 72, 4: 144}
# kernel-name pieces of phase 71's device breakdown, in order
K12C_KERNEL_GROUPS = ("sc_local_kernel", "sc_march_kernel", "rtl_psi",
                      "rtl_collide", "rtl_stream", "rtl_outlet", "rt_psi",
                      "rt_collide", "rt_stream", "rt_outlet", "rt_decode",
                      "rt_encode", "sc_push_kernel", "sc_outlet_kernel")
# f32 limit of phase 71's comparisons: the sharded state against the
# single-device kernel, and each local call against its plain version on
# the same padded buffers
K12C_F32_TOL = 1e-5


def k12c_full_cases(device, n=FLAGSHIP_N):
    """Phase 71's cells: name -> (model thunk, T, calls): configs 2 and 3
    at 1024^2 on (4, 1) at T = 1 and 4, and the four-fluid case at 1024^2
    at T = 1 and 2."""
    out = {}
    for name in ("config2", "config3"):
        for t in (1, 4):
            out[f"{name} {n}^2 (4, 1) T={t}"] = (
                lambda name=name: sc_config(name, device, n=n), t, 12 // t)
    for t in (1, 2):
        out[f"sc4_mrt_velocity_convective {n}^2 (4, 1) T={t}"] = (
            lambda: sc_case("sc4_mrt_velocity_convective", device, n, n,
                            torch.float32), t, 4 // t)
    return out


def _sc_local_vs_plain(step, state, device):
    """One call's local kernels against their plain versions on the same
    exchanged padded buffers of `state`: (max |diff| over the centres, the
    plain versions' seconds over every shard)."""
    from openlbmpm_torch.kernels import shanchen as ks
    m, t = step.model, step.steps_per_call
    step.exchange(state)
    for k, g, ins, outs in zip(step.ids, step.grids, state.bufs,
                               state.spare):
        step.local(k, g, ins, outs)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    refs = [ks.sc_local_step_reference(x[0], m, g, t)
            for g, x in zip(step.grids, state.bufs)]
    torch.cuda.synchronize(device)
    sec = time.perf_counter() - t0
    gap = max(_gap(g.centre(outs[0]), r)
              for g, outs, r in zip(step.grids, state.spare, refs))
    return gap, sec


def phase_sharded_sc_full(device, time_calls=20):
    """Phase 71 (see the module docstring): correctness, speed and launches
    of K12c at full width in f32."""
    from openlbmpm_torch.kernels import shanchen as ks
    from openlbmpm_torch.parallel import make_mesh
    mesh = make_mesh(shape=(4, 1), kind="local", device=device)
    counters = {"sc_local_step": ks.sc_local_step}
    res = {}
    for name, (model_of, t, calls) in k12c_full_cases(device).items():
        m0, f0 = model_of()
        step = ks.build_sc_sharded_step(m0.geo, m0.p, mesh, torch.float32,
                                        steps_per_call=t, bc_config=m0.bcs)
        tag = f"K12c {name}"
        check(step is not None, f"{tag}: no sharded step")
        m = step.model
        def kern(x):
            return ks.sc_block_step(x, m, t)
        (a,), launches = _counted_call(step, counters, (f0,), calls)
        check(launches["sc_local_step"] == calls * mesh.size, f"{tag}: "
              f"{launches['sc_local_step']} local launches for {calls} "
              "calls")
        r = {"launches": launches["sc_local_step"], "calls": calls,
             "steps": t, "k": m.k,
             "vs_kernel": _gap(a, _steps(kern, f0, calls))}
        check(bool(torch.isfinite(a).all()), f"{tag}: state not finite")
        check(r["vs_kernel"] <= K12C_F32_TOL, f"{tag}: sharded vs "
              f"single-device {r['vs_kernel']:.3e} (<= {K12C_F32_TOL:g})")
        state = step.shard(f0)
        n_time = max(time_calls // t, 4)
        r["sec"] = _time_steps(step, state, n_time, device) / t
        r["host_sec"] = _host_seconds(step, state, n_time, device) / t
        r["exchange_sec"] = _time_steps(_exchange_only(step), state,
                                        time_calls, device) / t
        r["local_sec"] = _time_steps(_local_only(step), state, n_time,
                                     device) / t
        r["kernel_sec"] = _time_steps(kern, f0, n_time, device) / t
        r["k8_sec"] = _time_steps(lambda x: ks.sc_step(x, m), f0, n_time,
                                  device)
        r["device_us"] = device_breakdown(step, state, 4, K12C_KERNEL_GROUPS)
        r["device_us_single"] = device_breakdown(kern, f0, 4,
                                                 K12C_KERNEL_GROUPS)
        r["cells"] = step.ny * step.nx
        r["bound_ms"] = k12_bytes(step, K12C_STATE_BYTES[m.k]) / \
            HBM_BYTES_PER_S * 1e3 / t
        r["frame"] = step.frame
        gap, sec = _sc_local_vs_plain(step, state, device)
        r["vs_plain"], r["plain_sec"] = gap, sec / t
        check(gap <= K12C_F32_TOL, f"{tag}: local kernels vs plain "
              f"{gap:.3e} (<= {K12C_F32_TOL:g})")
        res[name] = r
        del step, state, a
        torch.cuda.empty_cache()
    return res


def phase70_71_lines(r70, r71, card):
    lines = [
        f"phase 70 K12c f64, sharded vs single-device K8-T (same T) / K8 (T "
        f"steps) / plain ({len(r70)} runs: "
        + ", ".join(sorted({k[0] for k in r70})) + " on (4, 1) and (2, 1) "
        "at T = 1, 2, two calls): max |diff| "
        f"{max(v[0] for v in r70.values()):.3e} / "
        f"{max(v[1] for v in r70.values()):.3e} (<= 1e-12) / "
        f"{max(v[2] for v in r70.values()):.3e} (<= 1e-12)"]
    for name, r in r71.items():
        f = r["frame"]
        lines.append(
            f"phase 71 {name} f32 [{card}]: {r['calls']} calls, "
            f"{r['launches']} local launches; vs single-device kernel "
            f"{r['vs_kernel']:.3e}; local kernels vs plain, one call "
            f"{r['vs_plain']:.3e} (limit {K12C_F32_TOL:g}); ms a step "
            f"sharded {r['sec'] * 1e3:.4f}, exchange "
            f"{r['exchange_sec'] * 1e3:.4f}, local kernels "
            f"{r['local_sec'] * 1e3:.4f}, host issue "
            f"{r['host_sec'] * 1e3:.4f}, single-device K8-T "
            f"{r['kernel_sec'] * 1e3:.4f} (K8 {r['k8_sec'] * 1e3:.4f})"
            f", bound {r['bound_ms']:.4f}, plain "
            f"{r['plain_sec'] * 1e3:.2f}; frame lo {f.lo} hi {f.hi}")
        for key in ("device_us", "device_us_single"):
            d = r[key]
            lines.append(
                f"phase 71 {name} device µs a launch "
                + ("sharded" if key == "device_us" else
                   "single-device kernel") + f" [{card}]: " + ", ".join(
                    f"{k} {v:.1f}" for k, v in sorted(
                        d.items(), key=lambda kv: -kv[1])))
    return lines


def phase70_71_entries(r70, r71):
    """The kernels line's entry of K12c: ms, plain ms and bound a time step
    of config 2 at 1024^2 on (4, 1) at T = 4, launches from phase 71's main
    path there, max_abs_err the largest f32 gap to the plain version over
    phase 71's runs (one call from the same padded buffers), and beside
    them T = 1, config 3 and four fluids."""
    n = FLAGSHIP_N
    c2 = r71[f"config2 {n}^2 (4, 1) T=4"]
    c2_1 = r71[f"config2 {n}^2 (4, 1) T=1"]
    c3 = r71[f"config3 {n}^2 (4, 1) T=4"]
    k4 = r71[f"sc4_mrt_velocity_convective {n}^2 (4, 1) T=2"]
    nbytes = c2["bound_ms"] * 1e-3 * HBM_BYTES_PER_S / c2["cells"]
    return [kernel_entry(
        "sc_local_step", "K12c", "openlbmpm_torch/csrc/sc2d_local.cuh "
        "(sc2d_local_{f64,f32}.cu, on sc2d_block.cuh and sc2d_rt.cuh)",
        "openlbmpm_tpu/pallas/shanchen.py:850 (local kernel call :794)",
        c2["launches"], max(r["vs_plain"] for r in r71.values()),
        c2["sec"], c2["plain_sec"], nbytes, SC2_OPS, c2["cells"],
        steps_per_call=4, mesh=[4, 1],
        max_abs_err_f64=max(v[2] for v in r70.values()),
        vs_single_device=max(r["vs_kernel"] for r in r71.values()),
        launches_t1=c2_1["launches"], ms_t1=c2_1["sec"] * 1e3,
        bound_ms_t1=c2_1["bound_ms"], exchange_ms=c2["exchange_sec"] * 1e3,
        host_ms=c2["host_sec"] * 1e3,
        single_device_ms=c2["kernel_sec"] * 1e3,
        single_device_ms_t1=c2_1["kernel_sec"] * 1e3,
        single_device_k8_ms=c2["k8_sec"] * 1e3,
        ms_config3=c3["sec"] * 1e3, bound_ms_config3=c3["bound_ms"],
        ms_k4_t2=k4["sec"] * 1e3, bound_ms_k4_t2=k4["bound_ms"],
        plain_ms_k4_t2=k4["plain_sec"] * 1e3)]


# -- T-step calls past a launch's step limit ---------------------------------

CHUNKED_TS = (10, 16)


def limit_mirrors():
    """The Python mirrors of the launch limits against the libraries that
    set them: march3d.MAX_STAGES / MAX_RINGS against csf2d_march_limits and
    sc2d_march_limits,
    flow3d.MAX_BLOCK_STEPS and cg3d.MAX_BLOCK_STEPS against
    flow3d_block_max_steps and cg3d_block_max_steps (kMaxSteps3), in every
    storage type; {name: (library, mirror)}."""
    import ctypes
    from openlbmpm_torch.kernels import build
    from openlbmpm_torch.kernels import cg3d as k9
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import march3d
    out = {}
    for fam in ("csf2d", "sc2d"):
        for st in ("f64", "f32", "bf16"):
            lib = f"{fam}_block_{st}"
            v = (ctypes.c_longlong * 2)()
            getattr(build.load_library(lib), f"{fam}_march_limits")(v)
            out[f"{lib} stages, rings"] = (tuple(v), (march3d.MAX_STAGES,
                                                      march3d.MAX_RINGS))
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        for kind in ("single", "sc"):
            out[f"flow3d {kind} {dt}"] = (kf.flow3d_block_max_steps(dt, kind),
                                          kf.MAX_BLOCK_STEPS)
        for split in (False, True) if dt != torch.bfloat16 else (False,):
            out[f"cg3d split={split} {dt}"] = (
                k9.cg3d_block_max_steps(dt, split), k9.MAX_BLOCK_STEPS)
    for name, (lib, mirror) in out.items():
        check(lib == mirror, f"launch limit {name}: library {lib}, Python "
              f"mirror {mirror}")
    return out


def phase_block_chunked(device, tol=1e-11, cli_tol=BLOCK_CLI_BOUND):
    """T-step calls past one launch's step limit, at f64 against T plain
    steps, T = 10 and 16 (CHUNKED_TS): K3c of both variants and the
    Perturbation K3s on the flagship's rows and on the Dirichlet inlet /
    convective outlet (100 x 72), K8-T on SC_CASES' velocity / convective
    and EFS iso-10 velocity / pressure rows (100 x 64), K5c-Tc (case a,
    flagship flow), K11-T, K10-T (K = 2) and K9-Tc (the velocity inlet and
    convective outlet) at 48 x 40 x 32, each one call that runs as
    ``build.split_steps(T, limit)`` launches, counted on the wrapper; the
    limits' Python mirrors against their libraries (limit_mirrors); and
    ``run --model sc3d --block 10`` on configs/shanchen3d.ini (100 steps,
    output every 50) with metrics.jsonl within BLOCK_CLI_BOUND of
    ``--block 1``, the T-step kernel launched twice a call."""
    import os
    import tempfile
    from openlbmpm_torch import cli
    from openlbmpm_torch.kernels import build
    from openlbmpm_torch.kernels import cg3d as k9
    from openlbmpm_torch.kernels import csf as k
    from openlbmpm_torch.kernels import flow3d as kf
    from openlbmpm_torch.kernels import shanchen as ksc
    from openlbmpm_torch.kernels import transport as kt
    res = {"mirrors": limit_mirrors()}

    def hold(label, kern, plain, x0, m, limit, layout, ts=CHUNKED_TS):
        for t in ts:
            kern.launches = 0
            a = kern(x0, m, t)
            launches = kern.launches
            b = plain(x0, m, t)
            want = len(build.split_steps(t, limit))
            err = _gap(tuple(a) if isinstance(a, tuple) else a,
                       tuple(b) if isinstance(b, tuple) else b)
            fin = all(bool(torch.isfinite(y).all()) for y in
                      (a if isinstance(a, tuple) else (a,)))
            check(fin and err <= tol and launches == want,
                  f"{label} T={t}: {launches} launches (want {want} of at "
                  f"most {limit}), vs {t} plain steps {err:.3e} > {tol:g}")
            res[(label, t)] = {"err": err, "launches": launches,
                               "limit": limit, "layout": layout}

    for name in ("neumann_dirichlet_100x72", "dirichlet_convective_100x72"):
        for variant, pre in (("CSF", "csf"), ("Perturbation", "pert")):
            m, st = k3_case(name, variant, device)
            for split in (False, True) if variant == "Perturbation" else \
                    (False,):
                x0 = st if split else m.pack_state(*st)
                lay = "split" if split else "compressed"
                lim = k.csf_block_max_steps(torch.float64, split,
                                            m.kernel_params)
                hold(f"K3{'s' if split else 'c'} {variant} {name}",
                     getattr(k, f"{pre}_block_{lay}"),
                     getattr(k, f"{pre}_block_{lay}_reference"), x0, m, lim,
                     layout_text(k.csf_block_tiling(
                         torch.float64, split, m.kernel_params, lim), lim))
            del m, st, x0
    for name in ("sc_srt_velocity_convective", "efs10_mrt_velocity_pressure"):
        m, f = sc_case(name, device, ny=100, nx=64)
        lim = ksc.sc_block_max_steps(torch.float64, m.kernel_params)
        hold(f"K8-T {name}", ksc.sc_block_step, ksc.sc_block_step_reference,
             f, m, lim, layout_text(ksc.sc_block_tiling(
                 torch.float64, m.kernel_params, lim), lim))
    m, st = coupled_block_case("a", device)
    p = kt.coupled_block_params(m)
    lim = kt.coupled_block_max_steps(torch.float64, False, p)
    hold("K5c-Tc a", kt.coupled_block_compressed,
         kt.coupled_block_compressed_reference, m.pack(st), m, lim,
         layout_text(kt.coupled_block_tiling(torch.float64, False, p, lim),
                     lim))
    m = single3d_case("trt_force", device)
    lim = kf.flow3d_block_max_steps(torch.float64, "single")
    hold("K11-T trt_force", kf.single3d_block_step,
         kf.single3d_block_step_reference, flow_start(m), m, lim,
         tiling_text({t: kf.flow3d_block_tiling(
             torch.float64, "single", m.kernel_params, t) for t in (2, 4)}))
    m, f = block_sc3d_case("k2_walls_force", device)
    lim = kf.flow3d_block_max_steps(torch.float64, "sc")
    hold("K10-T k2_walls_force", kf.sc3d_block_step,
         kf.sc3d_block_step_reference, f, m, lim, tiling_text(
             {t: kf.flow3d_block_tiling(torch.float64, "sc", m.kernel_params,
                                        t) for t in (2, 4)}))
    m, st = cg3d_case("velocity_convective", device)
    lim = k9.cg3d_block_max_steps(torch.float64, False)
    hold("K9-Tc velocity_convective", k9.cg3d_block_compressed,
         k9.cg3d_block_compressed_reference, m.pack_state(*st), m, lim,
         tiling_text({t: k9.cg3d_block_tiling(torch.float64, False,
                                              m.kernel_params, t)
                      for t in (2, 4)}))
    del m, st, f
    torch.cuda.empty_cache()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    with tempfile.TemporaryDirectory() as tmp:
        ini = os.path.join(tmp, "shanchen3d.ini")
        _ini_copy(os.path.join(root, "shanchen3d.ini"), ini,
                  {"TimeInterval": 50})
        r = {}
        for block in ("1", "10"):
            out = os.path.join(tmp, f"sc3d_{block}")
            kf.sc3d_block_step.launches = kf.sc3d_step.launches = 0
            rc, text, sec = _cli_run(cli, [
                "run", ini, "--model", "sc3d", "--steps", "100", "--output",
                out, "--device", "cuda", "--block", block])
            line = next((ln for ln in text.splitlines()
                         if "--model sc3d" in ln), "")
            counts = (kf.sc3d_block_step.launches, kf.sc3d_step.launches)
            want = (0, 100) if block == "1" else (20, 0)
            check(rc == 0 and counts == want, f"cli sc3d --block {block}: "
                  f"rc {rc}, launches {counts} (want {want}), {line}")
            r[block] = {"sec": sec, "launches": counts, "line": line}
        sa, sb, gaps = _metrics_gap(
            os.path.join(tmp, "sc3d_1", "metrics.jsonl"),
            os.path.join(tmp, "sc3d_10", "metrics.jsonl"))
        over = {key: v for key, v in gaps.items() if v > cli_tol}
        check(sa == sb == [0, 50, 100] and not over,
              f"cli sc3d --block 10: metrics at {sb}, --block 1 at {sa}, "
              f"relative gaps over {cli_tol:g}: {over}")
        r["gaps"] = gaps
        res["cli sc3d"] = r
    return res


def phase72_line(r72, card) -> str:
    mirrors = r72["mirrors"]
    cli = r72["cli sc3d"]
    return (
        "phase 72 T-step calls past a launch's step limit, f64 vs T plain "
        "steps (<= 1e-11): " + "; ".join(
            f"{key[0]} T={key[1]} {v['launches']} launches of at most "
            f"{v['limit']}, max |diff| {v['err']:.3e} ({v['layout']})"
            for key, v in r72.items() if isinstance(key, tuple)) +
        "; launch limits library = mirror: " + ", ".join(
            f"{name} {lib}" for name, (lib, _) in mirrors.items()) +
        f"; cli sc3d --block 10 vs 1 [{card}]: launches (T-step, T=1) "
        f"{cli['10']['launches']} / {cli['1']['launches']}, seconds with I/O "
        f"{cli['10']['sec']:.2f} / {cli['1']['sec']:.2f}, metrics.jsonl "
        "relative gaps " + ", ".join(f"{key} {v:.2e}" for key, v in
                                     cli["gaps"].items()) +
        f" (<= {BLOCK_CLI_BOUND:g}); {cli['10']['line']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from openlbmpm_torch.kernels import build
    from openlbmpm_torch.kernels.flow3d import LIBRARIES as FLOW3D_LIBS
    from openlbmpm_torch.kernels.shanchen import LIBRARIES as SC_LIBS
    from openlbmpm_torch.kernels.single import LIBRARIES as SINGLE_LIBS
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    card = card_line()
    print(card)
    print(f"phase 1 card: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    libs = build.LIBRARIES
    t0 = time.perf_counter()
    build.load_libraries(libs)
    t_build = time.perf_counter() - t0
    print(f"phase 2 build: {', '.join(libs)} side by side in "
          f"{t_build:.2f} s (nvcc " + ", ".join(
              f"{lib} {build.build_seconds.get(lib, 0.0):.2f} s"
              for lib in libs) + ")")
    raw_ints = SC_LIBS + SINGLE_LIBS + FLOW3D_LIBS + tuple(
        lib for lib in libs if "_block_" in lib or lib.endswith("_rt"))
    for lib in libs:
        print(f"phase 2 ptxas {lib}: "
              f"{build_report(build, lib, lib in raw_ints)}")

    r3 = phase_f64(device)
    print(f"phase 3 f64 kernel vs plain, 20 steps, max |diff|: 256x128 "
          f"channel {r3['channel']:.3e} (<= 1e-11); 96x64 porous mask, Xu "
          f"wetting, droplet: K1 {r3['Xu porous K1']:.3e}, K6 "
          f"{r3['Xu porous K6']:.3e} (<= 1e-11)")

    res = phase_flagship(device)
    print(phase4_line(res))

    main_res = phase_main(device)
    for ln in phase5_lines(main_res, card, t_build):
        print(ln)

    print(phase6_line(phase_coupled_f64(device)))

    res7 = phase_coupled_config4(device)
    print(phase7_line(res7, card))

    res8 = phase_coupled_main(device)
    for ln in phase8_lines(res8, card):
        print(ln)

    r9 = phase_split_f64(device)
    r10 = phase_golden(device)
    r11 = phase_split_coupled_f64(device)
    r12 = phase_cli(device)
    r13 = phase_split_speed(device)
    for ln in phase9_13_lines(r9, r10, r11, r12, r13, card):
        print(ln)
    r14 = phase_split_full(device)
    print(phase14_line(r14, card))

    t_old = time.perf_counter() - t_start
    r15 = phase_sc_f64(device)
    r16 = phase_sc_golden(device)
    r17 = phase_sc_configs(device)
    phys = phase_sc_physics(device)
    cli = phase_sc_cli(device)
    r19 = phase_sc_speed(device)
    for ln in phase15_19_lines(r15, r16, r17, phys, cli, r19, card):
        print(ln)

    t_2d = time.perf_counter() - t_start
    t_k9 = {}
    for key, fn in (("r20", phase_cg3d_f64), ("r21", phase_config5),
                    ("r22", phase_cg3d_main), ("r23", phase_cg3d_cli),
                    ("r24", phase_cg3d_speed)):
        t0 = time.perf_counter()
        t_k9[key] = (fn(device), time.perf_counter() - t0)
    r20, r21, r22, r23, r24 = (t_k9[k][0] for k in sorted(t_k9))
    print("phases 20-24 wall s: " + ", ".join(
        f"{k[1:]} {v[1]:.1f}" for k, v in sorted(t_k9.items())))
    for ln in phase20_24_lines(r20, r21, r22, r23, r24, card):
        print(ln)

    t_3d = time.perf_counter() - t_start
    t_k9t = {}
    for key, fn in (("r25", phase_transport3d_f64), ("r26", phase_probe3d),
                    ("r27", phase_transport3d_cli),
                    ("r28", phase_transport3d_speed)):
        t0 = time.perf_counter()
        t_k9t[key] = (fn(device), time.perf_counter() - t0)
    r25, r26, r27, r28 = (t_k9t[k][0] for k in sorted(t_k9t))
    print("phases 25-28 wall s: " + ", ".join(
        f"{k[1:]} {v[1]:.1f}" for k, v in sorted(t_k9t.items())))
    for ln in phase25_28_lines(r25, r26, r27, r28, card):
        print(ln)

    t_k9t = time.perf_counter() - t_start
    t_flow = {}
    for key, fn in (("r29", phase_single_f64), ("r30", phase_config1),
                    ("r31", phase_single_poiseuille),
                    ("r32", phase_single_main), ("r33", phase_single3d_f64),
                    ("r34", phase_basic3d),
                    ("r35", phase_single3d_poiseuille),
                    ("r36", phase_sc3d_f64), ("r37", phase_probe_sc3d),
                    ("r38", phase_flow_cli), ("r39", phase_flow3d_speed)):
        t0 = time.perf_counter()
        t_flow[key] = (fn(device), time.perf_counter() - t0)
        torch.cuda.empty_cache()
    (r29, r30, r31, r32, r33, r34, r35, r36, r37, r38,
     r39) = (t_flow[k][0] for k in sorted(t_flow))
    print("phases 29-39 wall s: " + ", ".join(
        f"{k[1:]} {v[1]:.1f}" for k, v in sorted(t_flow.items())))
    for ln in phase29_32_lines(r29, r30, r31, r32, card) + phase33_39_lines(
            r33, r34, r35, r36, r37, r38, r39, card):
        print(ln)

    t_flow = time.perf_counter() - t_start
    t_k4 = {}
    for key, fn in (("r40", phase_pert_f64), ("r41", phase_pert_flagship),
                    ("r42", phase_pert_physics), ("r43", phase_pert_main),
                    ("r44", phase_pert_speed)):
        t0 = time.perf_counter()
        t_k4[key] = (fn(device), time.perf_counter() - t0)
        torch.cuda.empty_cache()
    r40, r41, r42, r43, r44 = (t_k4[k][0] for k in sorted(t_k4))
    print("phases 40-44 wall s: " + ", ".join(
        f"{k[1:]} {v[1]:.1f}" for k, v in sorted(t_k4.items())))
    for ln in phase40_44_lines(r40, r41, r42, r43, r44, card):
        print(ln)

    t_k4 = time.perf_counter() - t_start
    t_blk = {}
    for key, fn in (("r45", phase_block_csf_f64), ("r46", phase_block_sc_f64),
                    ("r47", phase_block_single_f64), ("r48", phase_block_full),
                    ("r49", phase_block_speed), ("r50", phase_block_main)):
        t0 = time.perf_counter()
        t_blk[key] = (fn(device), time.perf_counter() - t0)
        torch.cuda.empty_cache()
    r45, r46, r47, r48, r49, r50 = (t_blk[k][0] for k in sorted(t_blk))
    print("phases 45-50 wall s: " + ", ".join(
        f"{k[1:]} {v[1]:.1f}" for k, v in sorted(t_blk.items())))
    for ln in phase45_50_lines(r45, r46, r47, r48, r49, r50, card):
        print(ln)
    t0 = time.perf_counter()
    r51 = phase_cli_default(device)
    print(f"phase 51 cli default --block 0 at the shipped sizes [{card}]: "
          + "; ".join(f"{m} T={r51[m]['t']} {r51[m]['launches']} T-step "
                      f"launches, {r51[m]['sec']:.2f} s with I/O against "
                      f"{sec1:.2f} s with --block 1 (phase {ph})"
                      for m, sec1, ph in (("cg", r12["cg_sec"], 12),
                                          ("sc", cli["sc"]["sec"], 18),
                                          ("basic", r38["basic"]["sec"], 38)))
          + f"; wall {time.perf_counter() - t0:.1f} s")

    t_blk3 = {}
    for key, fn in (("r52", phase_block_coupled_f64),
                    ("r53", phase_block3d_f64), ("r54", phase_block_full_3),
                    ("r55", phase_block3_speed), ("r56", phase_block3_main),
                    ("r57", phase_cli_default_3)):
        t0 = time.perf_counter()
        t_blk3[key] = (fn(device), time.perf_counter() - t0)
        torch.cuda.empty_cache()
    r52, r53, r54, r55, r56, r57 = (t_blk3[k][0] for k in sorted(t_blk3))
    print("phases 52-57 wall s: " + ", ".join(
        f"{k[1:]} {v[1]:.1f}" for k, v in sorted(t_blk3.items())))
    for ln in phase52_57_lines(r52, r53, r54, r55, r56, r57, r12, r38, card):
        print(ln)

    t_new = {}
    for key, fn in (("r58", phase_sc4), ("r59", phase_no_pallas),
                    ("r60", phase_block_cg3d_f64), ("r61", phase_block_config5),
                    ("r62", phase_block_cg3d_speed)):
        t0 = time.perf_counter()
        t_new[key] = (fn(device), time.perf_counter() - t0)
        torch.cuda.empty_cache()
    r58, r59, r60, r61, r62 = (t_new[k][0] for k in sorted(t_new))
    print("phases 58-62 wall s: " + ", ".join(
        f"{k[1:]} {v[1]:.1f}" for k, v in sorted(t_new.items())))
    for ln in phase58_62_lines(r58, r59, r60, r61, r62, card):
        print(ln)

    t_k12 = {}
    for key, fn in (("r63", phase_sharded_csf_f64),
                    ("r64", phase_sharded_coupled_f64),
                    ("r65", phase_sharded_single_f64),
                    ("r66", phase_sharded_full)):
        t0 = time.perf_counter()
        t_k12[key] = (fn(device), time.perf_counter() - t0)
        torch.cuda.empty_cache()
    r63, r64, r65, r66 = (t_k12[k][0] for k in sorted(t_k12))
    print("phases 63-66 wall s: " + ", ".join(
        f"{k[1:]} {v[1]:.1f}" for k, v in sorted(t_k12.items())))
    for ln in phase63_66_lines(r63, r64, r65, r66, card):
        print(ln)

    t_k12_3d = {}
    for key, fn in (("r67", phase_sharded_cg3d_f64),
                    ("r68", phase_sharded_sc3d_f64),
                    ("r69", phase_sharded3d_full)):
        t0 = time.perf_counter()
        t_k12_3d[key] = (fn(device), time.perf_counter() - t0)
        torch.cuda.empty_cache()
    r67, r68, r69 = (t_k12_3d[k][0] for k in sorted(t_k12_3d))
    print("phases 67-69 wall s: " + ", ".join(
        f"{k[1:]} {v[1]:.1f}" for k, v in sorted(t_k12_3d.items())))
    for ln in phase67_69_lines(r67, r68, r69, card):
        print(ln)

    t_k12c = {}
    for key, fn in (("r70", phase_sharded_sc_f64),
                    ("r71", phase_sharded_sc_full)):
        t0 = time.perf_counter()
        t_k12c[key] = (fn(device), time.perf_counter() - t0)
        torch.cuda.empty_cache()
    r70, r71 = (t_k12c[k][0] for k in sorted(t_k12c))
    print("phases 70-71 wall s: " + ", ".join(
        f"{k[1:]} {v[1]:.1f}" for k, v in sorted(t_k12c.items())))
    for ln in phase70_71_lines(r70, r71, card):
        print(ln)

    t0 = time.perf_counter()
    r72 = phase_block_chunked(device)
    torch.cuda.empty_cache()
    print(f"phase 72 wall s: {time.perf_counter() - t0:.1f}")
    print(phase72_line(r72, card))

    n2 = FLAGSHIP_N * FLAGSHIP_N
    csf = "openlbmpm_tpu/pallas/csf.py:147"
    entries = [kernel_entry(
        "csf_step_compressed", "K2", "openlbmpm_torch/csrc/csf2d.cu", csf,
        main_res["launches"], res["bf16"]["max"],
        main_res["sec"][("kernel", "bf16")], main_res["sec"][("plain", "bf16")],
        KERNEL_BYTES["K2"], KERNEL_FLOPS["K2"], n2,
        launches_a_step=sum(main_res["per_step"].values())), kernel_entry(
        "coupled_step_compressed", "K5c", "openlbmpm_torch/csrc/coupled2d.cu",
        f"{csf} (transport_params)", res8["launches"], res7["bf16"]["max"],
        res8["sec"][("kernel", "bf16")], res8["sec"][("plain", "bf16")],
        KERNEL_BYTES["K5c"], KERNEL_FLOPS["K5c"], n2,
        launches_a_step=sum(res8["per_step"].values())), kernel_entry(
        "csf_step_compressed_f32", "K1", "openlbmpm_torch/csrc/csf2d.cu",
        f"{csf} (storage='f32')", main_res["launches_f32"], res["f32"]["max"],
        main_res["sec"][("kernel", "f32")], main_res["sec"][("plain", "f32")],
        KERNEL_BYTES["K1"], KERNEL_FLOPS["K1"], n2,
        launches_a_step=sum(main_res["per_step_f32"].values())), kernel_entry(
        "csf_step_split", "K6", "openlbmpm_torch/csrc/csf2d.cu",
        f"{csf} (state_mode='split')", r12["cg_launches"],
        r14["flagship"]["max"], r13["flow"]["kernel"], r13["flow"]["plain"],
        KERNEL_BYTES["K6"], KERNEL_FLOPS["K6"], n2,
        max_abs_err_f64=max(r9.values()),
        launches_a_step=sum(r12["cg_per_step"].values())), kernel_entry(
        "coupled_step_split", "K5s", "openlbmpm_torch/csrc/coupled2d.cu",
        f"{csf} (transport_params, state_mode='split')", r12["tr_launches"],
        r14["config4"]["max"], r13["coupled"]["kernel"],
        r13["coupled"]["plain"], KERNEL_BYTES["K5s"], KERNEL_FLOPS["K5s"], n2,
        max_abs_err_f64=max(max(v) for v in r11.values()),
        launches_a_step=sum(r12["tr_per_step"].values()))]
    sc_src = "openlbmpm_torch/csrc/sc2d.cuh"
    for entry, cfg, scheme in (("sc_step", "config2", "sc"),
                               ("sc_step_efs", "config3", "efs")):
        r = r19[cfg]
        # f32 kernel vs plain on the bench_all configuration and on the
        # CLI's configuration of the same scheme
        gap = max(r17[cfg]["f32"][0], r17[f"cli_{scheme}"]["f32"][0])
        entries.append(kernel_entry(
            entry, "K8", sc_src, "openlbmpm_tpu/pallas/shanchen.py:92 ("
            + ("original SC" if scheme == "sc" else "EFS iso-8 MRT") + ")",
            cli[scheme]["launches"], gap,
            r["sec"][("kernel", "f32")], r["sec"][("plain", "f32")],
            SC_BYTES["f32"], SC_FLOPS[cfg], n2,
            max_abs_err_f64=max(r15.values()),
            ms_bf16=r["sec"][("kernel", "bf16")] * 1e3,
            plain_ms_bf16=r["sec"][("plain", "bf16")] * 1e3,
            launches_a_step=sum(r["launches"]["f32"].values()),
            launches_a_step_cli=sum(cli[scheme]["per_step"].values()),
            launches_a_step_bf16=sum(r["launches"]["bf16"].values())))
    cg3d = "openlbmpm_tpu/pallas/cg3d.py:132"
    c5 = r24[128]
    f64_c = max(v[0] for k, v in r20.items() if k not in ("bf16_ulp",
                                                          "fields"))
    f64_s = max(v[1] for k, v in r20.items() if k not in ("bf16_ulp",
                                                          "fields"))
    for entry, label, key, launches, err, f64, extra in (
            ("cg3d_step_compressed", "K9h", "bf16", r22["launches_bf16"],
             r21["bf16"]["max"], f64_c, "storage='bf16'"),
            ("cg3d_step_compressed_f32", "K9c", "f32", r23["launches"],
             r21["f32"]["max"], f64_c, "storage='f32'"),
            ("cg3d_step_split", "K9s", "split", r22["launches_split"],
             r21["split"]["max"], f64_s, "state_mode='split'")):
        entries.append(kernel_entry(
            entry, label, "openlbmpm_torch/csrc/cg3d.cuh", f"{cg3d} ({extra})",
            launches, err, c5["sec"][key],
            c5["sec"]["plain" if key == "f32" else f"plain_{key}"],
            CG3D_BYTES[key], CG3D_FLOPS, 128 ** 3,
            max_abs_err_f64=f64, ms_256=r24[256]["sec"][key] * 1e3,
            bound_ms_256=CG3D_BYTES[key] * 256 ** 3 / HBM_BYTES_PER_S * 1e3,
            fields_max_abs_err_f64=r20["fields"],
            launches_a_step=sum(c5["launches"][key].values())))
    k9t = r28[128]
    f64_t = max(max(v[:2]) for v in r25.values())
    for entry, label, key, launches, err in (
            ("coupled3d_step_compressed", "K9t f32", "f32", r27["launches"],
             max(r26["f32"]["max"], r26["f32_tracer"]["max"])),
            ("coupled3d_step_compressed_bf16", "K9t bf16", "bf16",
             r27["launches_bf16"],
             max(r26["bf16"]["max"], r26["bf16"]["tracer"]["max"]))):
        entries.append(kernel_entry(
            entry, label, "openlbmpm_torch/csrc/cg3d.cuh",
            f"{cg3d} (transport=, storage='{key}'; step :1324-1355)",
            launches, err, k9t["sec"][key], k9t["sec"][f"plain_{key}"],
            TRANSPORT3D_BYTES[key], TRANSPORT3D_FLOPS, 128 ** 3,
            max_abs_err_f64=f64_t, mlups=k9t["mlups"][key],
            launches_a_step=sum(k9t["launches"][key].values()),
            ms_256=r28[256]["sec"][key] * 1e3,
            mlups_256=r28[256]["mlups"][key],
            bound_ms_256=TRANSPORT3D_BYTES[key] * 256 ** 3 /
            HBM_BYTES_PER_S * 1e3))
    c1, c1_big = r32[(1024, 512)], r32[(1024, 1024)]
    k7_f64 = max(max(r29.values()), r30["f64"])
    for entry, label, st, launches, err in (
            ("single_step", "K7 f32", "f32", r38["basic"]["launches"],
             r30["f32"]),
            ("single_step_bf16", "K7 bf16", "bf16", r32["launches_bf16"],
             r30["bf16"])):
        entries.append(kernel_entry(
            entry, label, "openlbmpm_torch/csrc/single2d.cuh",
            f"openlbmpm_tpu/pallas/single.py:43 (storage='{st}')", launches,
            err, c1["sec"][("kernel", st)], c1["sec"][("plain", st)],
            SINGLE_BYTES[st], SINGLE_FLOPS, 512 * 1024,
            max_abs_err_f64=k7_f64, mlups=c1["mlups"][("kernel", st)],
            ms_1024=c1_big["sec"][("kernel", st)] * 1e3,
            mlups_1024=c1_big["mlups"][("kernel", st)],
            bound_ms_1024=SINGLE_BYTES[st] * 1024 ** 2 / HBM_BYTES_PER_S *
            1e3))
    for entry, tag, tpu, cmp, launches_f32, f64 in (
            ("single3d_step", "K11", "openlbmpm_tpu/pallas/single3d.py:47",
             r34, r38["basic3d"]["launches"], max(r33.values())),
            ("sc3d_step", "K10", "openlbmpm_tpu/pallas/sc3d.py:79", r37,
             r38["sc3d"]["launches"], max(max(
                 v for k, v in r36.items() if not k.endswith(" f32")),
                 r37["f64"]))):
        for st, launches in (("f32", launches_f32),
                             ("bf16", r38[f"{tag}_bf16"]["launches"])):
            r, r256 = r39[(tag, 128)], r39[(tag, 256)]
            entries.append(kernel_entry(
                entry + ("_bf16" if st == "bf16" else ""), f"{tag} {st}",
                "openlbmpm_torch/csrc/flow3d.cuh", f"{tpu} (storage='{st}')",
                launches, max(v[st] for n, v in cmp.items()
                              if isinstance(n, int)),
                r["sec"][st], r["sec"][f"plain_{st}"], FLOW3D_BYTES[tag][st],
                FLOW3D_FLOPS[tag], 128 ** 3, max_abs_err_f64=f64,
                mlups=r["mlups"][st], ms_256=r256["sec"][st] * 1e3,
                mlups_256=r256["mlups"][st],
                bound_ms_256=FLOW3D_BYTES[tag][st] * 256 ** 3 /
                HBM_BYTES_PER_S * 1e3,
                launches_a_step=sum(r["launches"][st].values())))
    f64_k4 = {lay: max(v for (_, ly), v in r40.items() if ly == lay)
              for lay in ("compressed", "split")}
    for entry, label, key, launches, f64, extra in (
            ("pert_step_compressed_f32", "K4c", "f32", r42["launches_f32"],
             f64_k4["compressed"], "_substep_pert_c :1246, storage='f32'"),
            ("pert_step_compressed", "K4h", "bf16", r43["launches_bf16"],
             f64_k4["compressed"], "_substep_pert_c :1246, storage='bf16'"),
            ("pert_step_split", "K4s", "split", r43["cli_launches"],
             f64_k4["split"], "_substep_pert :1118, state_mode='split'")):
        entries.append(kernel_entry(
            entry, label, "openlbmpm_torch/csrc/pert2d.cu",
            f"{csf} (variant='Perturbation', {extra})", launches,
            r41[key]["max"], r44["sec"][key], r44["sec"][f"plain_{key}"],
            PERT_BYTES[key], PERT_FLOPS[key], n2, max_abs_err_f64=f64,
            mlups=r44["mlups"][key], launches_a_step=sum(
                {"f32": r42["per_step"], "bf16": r43["per_step"],
                 "split": r43["cli_per_step"]}[key].values())))
    entries += block_entries(r45, r46, r47, r48, r49, r50)
    entries += block3_entries(r52, r53, r54, r55, r56)
    entries += phase58_62_entries(r58, r60, r61, r62)
    entries += phase63_66_entries(r63, r64, r65, r66)
    entries += phase67_69_entries(r67, r68, r69)
    entries += phase70_71_entries(r70, r71)
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s "
          f"(phases 1-14 {t_old:.1f} s, 1-19 {t_2d:.1f} s, 1-24 "
          f"{t_3d:.1f} s, 1-28 {t_k9t:.1f} s, 1-39 {t_flow:.1f} s, 1-44 "
          f"{t_k4:.1f} s, build {t_build:.1f} s)")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
