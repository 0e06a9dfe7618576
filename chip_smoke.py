#!/usr/bin/env python3
"""Drive tpuflows_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, one JSON line each on stdout with its wall time in seconds:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every kernel with nvcc, all units in parallel: K1
               (csrc/nuts_transition.cu), K4/K5 (csrc/rqs_spline.cu),
               K6/K7 (csrc/coupling_tile.cu, and the earlier
               csrc/coupling_block.cu they replaced, the yardstick), K3
               (csrc/fused_logp.cu) and K2 (csrc/nuts_window.cu), and
               ptxas' registers, shared memory and spills per kernel;
  3. rqs_vs_plain — K4 (forward and inverse spline) and K5 (their
               pullbacks), the group kernels of csrc/rqs_lanes.cuh, against
               their plain PyTorch versions at the fit's shape (1024 x 64,
               K = 8), three others (d = 8, 96, 256; K = 4, 12), config
               c2's fit (512 x 8, K = 8; phase 21), config c3's fit
               batch and NUTS chains (1200 x 16 and 64 x 16, K = 8),
               K = 64
               (16 lanes of 4 bins), K = 2 and 24 (the group kernel's
               other lane counts) and a ragged row whose inputs and draw are
               views 4 bytes into their buffers (the 4-byte copies),
               raw ~ N(0, 1), x spread over [-6, 6], on y,
               ladj, dx and draw. The bar is the JAX package's for its
               Pallas spline against the oracle (tests/test_pallas.py:
               jnp.allclose, atol 1e-4 and its default rtol 1e-5), with the
               plain version in float64 as referee: float32 itself does not
               resolve some ill-conditioned elements of dx and draw to that
               bar, so the kernel must be as accurate against float64 as
               the two float32 plain versions (`judge`);
     k4_vs_earlier, k5_vs_earlier — K4 and K5 against the one-thread
               kernels they replaced (kept built as the oracles) on the
               same rows and directions, each a phase of its own: the
               elements of y and ladj (K5: dx and draw) whose bits differ
               and the largest difference. Any differing bit fails: the
               group kernels take every ordered sum in rqs_math.cuh's order
               and round the bin's arithmetic as the one-thread kernels'
               code does;
  4. kernel_vs_plain — K1 against its plain PyTorch version
               (`transition_math_torch`) at the bench widths (1024 chains,
               d = 64, max_depth 6, MLP 64-128-128-128) on the same
               precomputed randomness, through a seeded random flow with a
               non-zero last layer. The bar is the JAX kernel's own on-chip
               bar (docs/artifacts/nuts_kernel_onchip_diff.json): at most 5
               of 1024 chains disagree on tree decisions; on the rest
               energy agrees to 0.012 and q to 2.3e-4 (absolute);
     kernel_shapes — the same, under the same bar (flips scaled to the
               chain count), at one shape for each other instantiation of
               K1 (d = 32..256), hidden widths 32..256, depths to 10,
               random masks, random Standardize leaves and random metrics,
               and at the bench shape with random leaves and metric;
  5. kernel_vs_plain_spline — K1's module-list kernel against the plain
               version (streamed per-block gradient on the p-major flow)
               under K1's bar, through a seeded arqs flow at the bench
               widths (3 x (affine + spline), K = 8, mixed masks) whose
               last layers are random and small, 1024 chains, depth 6,
               eps 0.3, unit metric; and at d = 32 and 256 (K = 16, 54 KB of
               shared memory per warp). One more row,
               with large random last layers (SPLINE_CHAOS), is printed
               beside the spread of two plain versions on the same inputs
               and is not held to the bar: there the trajectories are so
               sensitive that two float32 evaluations of the same math
               disagree on many chains;
     targets_vs_plain — K1, K2 and K3 over every kind of the target
               library (csrc/targets.cuh) at the width a config gives it
               (banana 2, correlated 8, mixture 16, hierarchical 256, the
               funnel, std_normal, diag_normal, rosenbrock and cauchy 64;
               K1 on 32 lanes below 32), each under a leading-mask affine
               flow and a 2-block rqs flow (64 x 64, K = 8), but
               correlated rqs and hierarchical affine under the flows of
               the runner's nuts variants that run K1 there (c2's 4 rqs
               blocks, 64 x 64; c5's 2 leading-mask affine couplings,
               128 x 128), 1024 chains started at the flow's image of the
               target's exact draws (the funnel's at N(0, 1), the
               Cauchy's from its central 99.8%), depth 4: K1 against its
               plain version run in float64 on the same inputs, within
               K1's bar or twice the float32 plain version's own distance
               from float64 where larger, at most 16 flips of 1024 and
               10 times K1's bar (`refereed_bar`: float32 resolves the
               spline rows only to that); K2 over a window of 8 slots,
               every slot equal to the bit to a K1 launch from K2's own
               previous draw (`bitwise_k1` 0) and its first slot held
               likewise against float64; K3 against its plain version
               (`judge`); at the variants' two rows the tile kernels
               equal to the per-warp ones, and K1 timed beside its
               bound, whose operations add the target's own
               (`target_flops`: the correlated precision matvec, 2 d^2);
     reach_vs_plain — the reach past the register units (`REACH_ROWS`,
               held as targets_vs_plain holds its rows): hidden widths
               [48, 48], [100] and [512, 512] on the tile kernels (each
               padded to a multiple of 32 with zero units), max_depth 12
               at c1_std_normal_h48_depth12_nuts's own shape (c1's
               std_normal, its flow at hidden [48], 256 chains) and on
               the ceiling flow with a step small enough that trees pass
               depth 10, c5's flow over the hierarchical model at d = 514
               and 2 rqs blocks over the funnel at d = 288 on the wide
               units (csrc/*_wide.cu, built here first: their build
               seconds), which must also equal the per-warp kernels in
               value in K1, K2 and K3 on every target kind under a tanh
               flow (`wide_vs_warp_targets`); K1 timed beside its bound
               on every row, K2 and K3 too past d = 256;
  6. main_path — config 4 of bench.py (`ceiling` variant): a 6000-step
               reverse-KL/STL fit at batch 1024 of Standardize + one
               leading-mask affine coupling on the 64-d funnel, then NUTS
               with 1024 chains through K1's tile kernel (R = 8, the
               weights resident): 128 warmup steps, then windows
               of 512 draws until max split-R-hat < 1.05 and min ESS >=
               10000 on data-space draws (at most 4 windows, else it fails).
               K1's launch count is set to 0 before and must equal the
               number of transitions after; v's draws must pass a 5-sigma
               moment check against N(0, 9);
  7. timing  — K1 and its plain version with CUDA events at the main path's
               post-warmup state (trained flow, adapted metric and step
               size), beside the bound of the work; the two are held to the
               same bar there. The tile kernel is timed at R = 4 and 8 with
               its weights through the ring and resident in shared memory,
               launched from the host and replayed from a CUDA graph,
               beside the per-warp module-list kernel (`warp_ms`);
  8. main_path_generic — the `generic` variant of bench.py: the arqs flow
               (Standardize + 3 x (affine + spline), K = 8, hidden 128 x
               128, mixed masks, clamp 8) fitted the same way for
               GENERIC_TRAIN_STEPS (2000) steps, every spline
               through K4 and K5, then NUTS through K1's module-list kernel
               under the same gates. The launch counts are set to 0 before:
               K1's must equal the transitions, K4's and K5's 6 per fit step
               (3 spline blocks, inverse and forward) plus the final ELBO's
               and the data-space mapping's inverses;
  9. timing_generic — K4 and K5 at the fit's shape (also replayed from a
               CUDA graph, the device's time alone, with the inputs warm
               in L2 and, over copies of them that together pass the 50 MB
               L2, cold; each beside the one-thread kernel it replaced, in
               turns, with both kernels' registers and spills), and K1 at
               the generic path's post-warmup state, with CUDA events,
               beside their bounds and their plain versions' times. K1 is
               held to K1's bar there, with q's bar raised to twice the
               spread of two plain versions on the same inputs
               (`time_kernel`). The tile
               kernel is timed at each R, launched from the host and
               replayed from a CUDA graph, beside the per-warp kernel
               (`warp_ms`), with the tile lockstep's efficiency (useful
               gradients over the gradients the lockstep computes);
 10. coupling_vs_plain — K6 (the whole spline coupling block) and K7 (its
               pullback) against their plain PyTorch versions, both
               directions, on z, ladj, dx and every weight's and bias's
               cotangent: the fit's shape (1024 x 64, hidden 128 x 128,
               K = 8) under each mixed mask, a ragged batch of 37, d = 256
               (a 3 MB last layer, streamed), two rows off the main
               path (tanh and relu conditioners, one and three hidden
               layers) and a hidden layer of 3200 units (K6 without its
               weight ring; K7 on the wide unit, the earlier K7 refusing
               it); last layers 0.1 N(0, 1) and 0.01 x He. The bar is
               K4/K5's (`judge`, refereed by float64), at the quantile
               `block_quantile`; K7 must repeat itself to the bit. Each
               row prints its launch plans (`tile_plan`: rows per tile,
               spline dims per chunk, the ring's stage, shared memory,
               pass 2's row slices; the library's layout must agree) and
               the largest difference from the earlier kernels' outputs;
 10b. spline_reach_vs_plain (its checks in a process of their own beside
               run_configs, phase 21, its timing after that phase) —
               reach F: K4 and K5 past 64 knots
               (`SPLINE_REACH_RQS_ROWS`: K = 65 to 1,453, through 16 and
               32 lanes and blocks of 8 and 4 elements) judged against
               their plain versions with the float64 referee, each timed
               (inverse, `graph_ms`) beside its bound and its plain
               version, and equal to the one-thread kernels bit for bit,
               also at K = 2,905, 5,810 (blocks of 2 and 1) and 9,684
               (K5's largest; `SPLINE_REACH_BITS_ROWS`); K5 at 9,685 knots
               and K4 at 11,621 refused naming shared memory; K6 and K7
               (`SPLINE_REACH_BLOCK_SHAPES`) at K = 96 and 1000 on the
               tile kernels and on the wide unit (csrc/coupling_wide.cu,
               built on first use: hidden layers of 3200 and 8192 units,
               10 layers of 256, d = 4096, also bf16 gelu) by
               coupling_vs_plain's bar with two more float32 witnesses
               (the plain version with its hidden units reordered), each
               timed; the wide unit forced at shapes the tile kernels
               take, every activation, float32 and bf16, equal to them to
               the bit (`wide_vs_tile`); and K1, K2 and K3 under 2 rqs
               blocks of [64, 64] over the 64-d funnel at K = 96 (the
               tile kernels, R = 1, 1024 chains, eps 0.1, two float32
               witnesses in the float64 bar, the per-warp K1 and the
               plain version in the kernel's order of sums reported)
               and K = 1000 (the wide units, 64 chains, depth 2, eps
               0.01, K1 and one slot of K2 held to their float32 plain
               versions by K1's bar, float64 reported);
 11. main_path_generic_fused — the generic variant with every spline block
               on the fused tier (use_pallas="fused"), its fit cut to
               FUSED_TRAIN_STEPS (1000) steps, under the same gates;
               K6's and K7's launch counts must equal the counts the
               path implies (K7: `K7_LAUNCHES` per call) and K4/K5 and the
               earlier K6/K7 must launch 0 times;
 12. timing_coupling — K6 and K7 with CUDA events at the fit's shape and at
               d = 256 (also replayed from a CUDA graph), beside their
               bounds, their plain versions and the earlier kernels (device
               ms in turns, earlier, new, new, earlier), K7's pass 2
               alone, and the same block's times on the K4/K5 tier.
 13. fused_logp_vs_plain — K3 (the latent log density and its gradient,
               one launch per batch of rows) against its plain version on
               lp and g under K4/K5's bar (`judge`, refereed by float64):
               the ceiling shape (1024 x 64, a random non-zero head), the
               generic arqs shape (0.01 x He heads), a ragged batch of 37,
               affine and spline flows at d = 32 and 256 (K = 16 there),
               and both paths' trained flows at their post-warmup states;
 13b. tile_vs_warp — the tile kernels (csrc/tile_grad.cuh: one block of R
               warps per tile of R rows that share every weight read; K1's
               and K2's in both weight modes, the ring and, where they fit,
               the weights resident in shared memory) against the per-warp
               module-list kernels, kept built as the oracle: K1 on every
               row of phase 4's kernel_shapes (the affine flows, d = 32..256,
               random masks), every row of phase 5 and both post-warmup
               states; K3 on every row of phase 13 (the affine flows in
               both weight modes) and both post-warmup states; K2 on every
               row of phase 18 (its
               seeded windows, affine and spline), the bench and first
               spline rows at 1,003 chains (a ragged last tile) and both
               post-warmup states (S = 32); and all three on a flow whose
               row leaves no room for the 96 KB weight ring (d = 256, K =
               64: R = 1 on a smaller ring), at R = 4 and 8 where the tile
               fits, and the wrappers' default R. Every element of every
               output must equal the per-warp kernel's in value (the tile
               kernels skip products with a zero factor, which can change
               only a zero's sign, counted apart as zero_signs); the count
               of differing elements, the largest difference, the tile
               lockstep's efficiency and, for K1, flips and max dq are
               printed per mode;
 14. main_path_portable, main_path_portable_generic — flow-preconditioned
               NUTS through the portable route, `NUTSDriver(log p~,
               max_depth=6, logp_and_grad=K3)`, on the trained flows of
               phases 6 and 8 (no new fit), under the same gates. K3's
               launch count must equal the gradient calls the transitions
               counted, K1's stays 0, K4 launches only for the data-space
               mapping; ms per transition and the lockstep leaf steps per
               transition are printed;
 15. portable_vs_k1 — one portable transition (the host-driven lockstep
               loop with K3) against one K1 transition on the same
               randomness at each post-warmup state, under K1's bar (q's
               bar at the generic state as in phase 9);
 16. hmc_vs_plain — `make_hmc_kernel`'s transition (10 leapfrogs) with K3
               against the same with K3's plain version at the ceiling
               post-warmup state: at most 5 of 1024 accept decisions
               flipped, q within 2.3e-4 on the rest;
 17. timing_fused_logp — K3 at both post-warmup states with CUDA events
               (also replayed from a CUDA graph), beside its bound, its
               plain version and its launches on the portable path, the
               tile kernel at each R and weight mode beside the per-warp
               module-list kernel (`warp_ms`); and a portable transition's
               time beside K1's on the same inputs.
 18. window_vs_plain — K2 (a window of S transitions per chain in one
               launch), held slot by slot: slot s of its window against
               one transition from K2's own draw of slot s - 1 on slot s's
               randomness, by K1, by the plain window (`window_math_torch`
               one slot per call) and by K1's plain version, so that no
               rounding difference carries from slot to slot: the bench
               widths (1024 chains, d = 64, depth 6, unit metric, S = 4),
               the seeded arqs flow of phase 5 (S = 2; both to bound the
               plain versions' time), both kernels at d = 32 and d = 256
               (S = 4 affine, 2 spline), all at eps 0.1, and both trained
               flows at their post-warmup states (S = 32, the first
               POST_WARMUP_CHECKED_SLOTS = 2 slots held slot by slot). K1's bar in every slot (a chain
               flips if it
               differs in leapfrog count, depth, divergence or U-turn, or
               its draw by more than 1e-3, at most 5 of 1024 may; on the
               others energy within 0.012 and q within 2.3e-4), each of
               the three raised to twice the widest spread of two plain
               versions on the same slots where that is larger (the
               plain window against K1's plain version, and on spline
               flows K1's plain version with the streamed against the
               autograd gradient: `window_bar`); flips and
               max |dq| per slot are printed, the slots whose energies
               equal K1's to the bit, the elements in which K2 differs from
               the chained K1 launches in bits (`bitwise_k1`: both are tile
               kernels on every flow), and whether K2 meets K1's bar
               itself. At the post-warmup states
               the plain window also runs the whole window (timed for
               phase 20), and how far the free-running windows part is
               printed;
 19. main_path_window, main_path_window_generic — bench.py's window path
               (TPUFLOWS_BENCH_WINDOW=1) on the trained flows of phases 6
               and 8: `NUTSDriver(transition=K1, window_transition=K2)`,
               warmup through K1, draws through K2 in windows of S = 32,
               under the same gates. The launch counts are set to 0
               before: K1's must equal the warmup steps (none in the
               draws), K2's the draws / 32, K4 launches only for the
               data-space mapping; ms per transition of warmup and draws;
 20. timing_window — K2 per launch at both post-warmup states with CUDA
               events (also replayed from a CUDA graph), per transition
               beside K1's (phases 7 and 9), beside its bound (one latent
               gradient per chain per window plus one per leapfrog) and its
               plain version's time (phase 18); the tile kernel at each R
               (at the ceiling with the ring and resident weights) beside
               the per-warp module-list window (`warp_ms`) and the
               lockstep's efficiency, as phases 7 and 9 time K1.
 21. run_configs — the config runner, `tpuflows_torch.run.run`, on
               configs/c1_std_normal_affine.json (forward-KL fit),
               c2_correlated_rqs.json (VI of a 4-block spline flow, its
               splines through K4 and K5), c4_funnel_nuts.json (VI, then
               1024 chains of NUTS through K1), c6_banana_mh.json
               (adaptive RWMH, 256 chains), c7_mixture_pt.json (parallel
               tempering, 8 temperatures x 64 chains) and
               c3_mixture_adaptive.json (the adaptive loop: NUTS, then a
               forward-KL fit of a 4-block spline flow, K4/K5 forward,
               and its IS-ESS, K4 inverse), as written, and c3 with two
               rounds forced (RUN_VARIANTS: the second round samples in
               the flow's latent space, K4/K5 inverse), each record
               captured through a `MetricsLogger` into this phase's line,
               with the wall times of the fits, warmups and draws; c3
               and its variant each run in a process of this script of
               its own beside the rest (`run_aside`: all three lists are
               paced by the host).
               Gates: the JAX runner's record keys; every phase timed;
               finite results; each result of RUN_REFERENCE within
               RUN_MARGIN_SIGMAS standard deviations of the JAX package's
               results on three seeds (c3's rounds and convergence
               equal to them); the samplers' max split-R-hat < 1.05; c6's
               and c7's draws through `moment_gate` (RUN_MOMENTS); K1
               launched once per transition of c4 (640); K4 inverse once
               per spline block per step of c2 and for its final ELBO, K5
               inverse once per block per step, nothing forward; c3's
               K4/K5 launches as its path implies (`adaptive_launches`),
               every direction of both in the variant;
               c2_correlated_rqs_nuts and c5_hierarchical_affine_nuts
               (RUN_VARIANTS: the `nuts` task with fused_kernel "on" over
               c2's 8-d AR(1) Gaussian and 4-block rqs flow and c5's
               256-d hierarchical target and 2-block affine flow, at cut
               depth), gated against the JAX package's results on three
               seeds, split-R-hat < 1.05, `moment_gate` against the
               target's exact moments (c5's family-corrected) and K1
               launched once per transition; c1_std_normal_affine_nuts
               and c1_std_normal_h48_depth12_nuts (c1's target and flow,
               "auto"; the second with hidden [48] and max_depth 12, so
               that K1 runs its wide unit, `k1_wide_launches`), gated
               alike; c2_correlated_rqs_k96_nuts (c2's nuts variant with
               96 knots a spline, "auto": K4/K5 past 64 knots in its fit,
               in a process of its own beside the rest), gated by R-hat,
               the moment gate and its launches (no JAX reference); every
               nuts task over an rqs flow K4 inverse once per block per
               fit step, for the final ELBO and per chunk of draws mapped
               to the data space, K5 inverse once per block per step; and
               c5_hierarchical_smc.json as written (the 256-d
               hierarchical target, 65,536 particles, annealed SMC from an
               affine flow pretrained on prior draws; its "sharded": true
               runs the sharded stage over `worker_mesh()`, a NCCL world
               of one, the resample through the ring exchange at this
               payload, the retrains through `optimize_flow_dp`), its
               pretrain, stages and retrains timed, gated by
               `smc_gates`: final beta 1, log Z within 4 sigma + 0.05 of
               the quadrature truth, the particles through the
               family-corrected moment gate at 3 sigma with the measured
               ESS; its row names the world, the backend and the
               collectives a stage issues; no kernel launched on its
               path;
 22. evidence_c5 — the three evidence routes with c5's final flow at
               d = 256 (IS on 65,536 flow draws, the Meng-Wong bridge with
               the SMC particles and 16,384 flow draws, the harmonic mean
               on the particles) against the quadrature truth, each with
               its weight ESS and delta-method standard error; each must
               be finite, and where its weight ESS reaches 10% of its n
               it must lie within 4 standard errors + 0.02 of the truth;
 23. test_only_modules — the ensemble sampler, the Cauchy target, the
               priors, `Posterior` and `find_mode` on the card, each at
               the size of the JAX package's test of it with that test's
               assertion as the gate (`test_only_modules`).
 24. dist_world_of_one — the distributed layer in c5's NCCL world of
               one (`dist_world_of_one`): each collective on CUDA tensors
               against its local math and `heartbeat`'s latency;
               `resample_sharded` at 65,536 x 256 through the all_gather
               and the ring exchange, ancestors equal to
               `systematic_indices_math`; one sharded SMC stage against the
               unsharded one at c5's shapes on the same draws; one
               `optimize_flow_dp` step against one `optimize_flow` step;
               the stage and c5's retrain timed both ways, three times
               each, in one process;
               `run_nuts_sharded` through K1 on the ceiling flow from the
               main path's post-warmup positions (1024 chains, 128 warmup
               transitions, one window of 512 draws), K1 launched once per
               transition, max split-R-hat < 1.05, v's moment gate.
Then the card's nvidia-smi line, the kernels' JSON line (the rows of K1,
K2 and K3 with the tile kernel's device time, its R and weight mode, and
`earlier_ms` / `earlier_device_ms`, the per-warp kernel's it replaced in
the same run, K1's affine row with c4's launches through the runner and
the sharded NUTS's (`launches_dist`); K1's rows over the correlated
d = 8 rqs and the hierarchical d = 256 affine flows of targets_vs_plain
with the launches of the runner's variant of each; K1's on every
reach_vs_plain row (the wide unit's where `wide_path` sends it), K2's
and K3's wide units past d = 256, launches 0 but on the row at
c1_std_normal_h48_depth12_nuts's shape, which carries that variant's;
K4's and K5's with the one-thread kernels', the cold device time and
c2's and c3's launches through the runner; K6's and K7's with their
tile plan, the earlier kernels' times and K7's pass 2 alone) and, last,
{"ok": true, "device": {...}}. Any failure raises: the exit code is not 0
and the last line is not printed. It imports nothing of JAX.
"""
import json
import math
import os
import re
import subprocess
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

DIM = 64
N_CHAINS = 1024
HIDDEN = (128, 128)
CLAMP = 8.0
MAX_DEPTH = 6
# the ceiling's fit: bench.py's 6000 steps
TRAIN_STEPS = 6000
# the fused tier's fit (K6/K7 at the generic fit's shapes, every launch at
# TRAIN_BATCH rows): a sixth of the depth, to make room for the runner's
# configs within the script's time limit; its NUTS keeps every gate
FUSED_TRAIN_STEPS = 1000
# the generic variant's fit (K4/K5 at the fit's shapes): a third of the
# depth, to make room for c5, the modules only tests reach and the
# distributed phase (6000 steps took 147-153 s of a script at 800 s, 3000
# 72-80 s of one at 704 s); its NUTS keeps every gate (the same flow
# fitted 1000 steps on the fused tier passes them in two windows)
GENERIC_TRAIN_STEPS = 2000
TRAIN_BATCH = 1024
NUM_WARMUP = 128
DRAW_WINDOW = 512
MAX_WINDOWS = 4
RHAT_GATE = 1.05
ESS_GATE = 10_000.0
# the generic variant's flow (bench.py `make_flow0`)
KNOTS = 8
GENERIC_BLOCKS = 3
# kernel-vs-plain bar: the JAX kernel's on-chip bar
MAX_FLIPS = 5
MAX_DENERGY = 0.012
MAX_DQ = 2.3e-4
# transitions per K2 launch on the window path (bench.py's window=32)
WINDOW_SLOTS = 32
# the post-warmup rows of `window_vs_plain` hold the first 2 of their 32
# slots slot by slot (three plain versions a slot: 54 s of the generic
# row's 70 s at all 32 on an H100's host; 8 to make room for the
# distributed phase, 4 for the target library's phase, 2 for the
# conditioners' phase); the whole window still runs in K2 and in the
# plain version, which times it
POST_WARMUP_CHECKED_SLOTS = 2
# warmup and draw steps of `test_only_modules`' bounded-posterior NUTS
# (the JAX test's 200 + 200 cut to pay for the conditioners' phase)
POSTERIOR_NUTS_STEPS = 100
# the seeded flows' step size in the K2 comparison: at K1's eps 0.3 about
# half (bench) and three quarters (spline) of the chains diverge in one
# transition from N(0, 1) starts (the divergent counts of phases 4-5), and
# after a divergent slot the window machine's blends cancel through the
# divergent leaf's position (PERF.md, Findings)
WINDOW_EPS = 0.1
# spline-kernel bar: jnp.allclose(atol=1e-4) of tests/test_pallas.py,
# with jnp.allclose's default rtol
RQS_ATOL = 1e-4
RQS_RTOL = 1e-5
# random last layers of the spline flows held to K1's bar, as a multiple
# of the He scale (biases 0.1); SPLINE_CHAOS is the informative row's
SPLINE_HEAD = 0.01
SPLINE_CHAOS = 0.3
# the moment check on v's draws: MOMENT_SIGMA Monte-Carlo standard errors
MOMENT_SIGMA = 5.0
# published float32 (non-tensor-core) rate and memory rate of one H100 SXM
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# bytes of input copies for a cold-L2 time: 1.6 x the H100's 50 MB L2
COLD_BYTES = 80e6

T0 = time.perf_counter()


def emit(phase, t_start, **kw):
    print(json.dumps({"phase": phase,
                      "seconds": round(time.perf_counter() - t_start, 3),
                      **kw}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _kernel_key(name):
    """A short name for a kernel's mangled name."""
    t = re.search(r"ILi(\d+)E", name)
    if "nuts_transition_kernel" in name and t:
        return f"d/32={t.group(1)}"
    if "nuts_chain_kernel" in name and t:
        return f"chain d/32={t.group(1)}"
    res = " resident" if re.search(r"ILi\d+ELb1E", name) else ""
    if "nuts_chain_tile_kernel" in name and t:
        return f"chain tile d/32={t.group(1)}{res}"
    if "nuts_chain_tile_funnel_kernel" in name and t:
        return f"chain tile funnel d/32={t.group(1)}{res}"
    if "fused_logp_affine_kernel" in name and t:
        return f"K3 d/32={t.group(1)}"
    if "fused_logp_chain_kernel" in name and t:
        return f"K3 chain d/32={t.group(1)}"
    if "fused_logp_tile_kernel" in name and t:
        return f"K3 tile d/32={t.group(1)}{res}"
    if "fused_logp_tile_funnel_kernel" in name and t:
        return f"K3 tile funnel d/32={t.group(1)}{res}"
    if "nuts_window_kernel" in name and t:
        return f"K2 d/32={t.group(1)}"
    if "nuts_window_chain_kernel" in name and t:
        return f"K2 chain d/32={t.group(1)}"
    if "nuts_window_tile_kernel" in name and t:
        return f"K2 tile d/32={t.group(1)}{res}"
    rows = re.search(
        r"coupling_tile_(fwd|bwd)_kernelILb(\d)ELi(\d+)E(?:Lb(\d)E)?", name)
    if rows:
        label = "K6 tile" if rows.group(1) == "fwd" else "K7 tile pass 1"
        direction = "inverse" if rows.group(2) == "1" else "forward"
        dtype = " bf16" if rows.group(4) == "1" else ""
        return f"{label} {direction} R={rows.group(3)}{dtype}"
    lanes = re.search(
        r"rqs_(eval|grad)_lanes_kernelILb(\d)ELi(\d+)E(?:Li(\d+)E)?", name)
    if lanes:
        label = "K4" if lanes.group(1) == "eval" else "K5"
        direction = "inverse" if lanes.group(2) == "1" else "forward"
        L, E = lanes.group(3), lanes.group(4)
        elements = "" if E is None or int(L) * int(E) == 256 else f" E={E}"
        return f"{label} {direction} L={L}{elements}"
    wide = re.search(r"coupling_wide_(fwd|bwd)_kernelILb(\d)ELb(\d)E", name)
    if wide:
        label = "K6 wide" if wide.group(1) == "fwd" else "K7 wide pass 1"
        direction = "inverse" if wide.group(2) == "1" else "forward"
        dtype = " bf16" if wide.group(3) == "1" else ""
        return f"{label} {direction}{dtype}"
    for kern, label in (("rqs_eval_kernel", "K4 one-thread"),
                        ("rqs_grad_kernel", "K5 one-thread"),
                        ("coupling_fwd_kernel", "K6"),
                        ("coupling_bwd_kernel", "K7 pass 1")):
        if kern in name:
            return f"{label} {'inverse' if 'ILb1E' in name else 'forward'}"
    if "coupling_tile_wgrad_kernel" in name:
        return "K7 tile pass 2"
    if "weight_grad_kernel" in name:
        return "K7 pass 2"
    return name


def ptxas_summary(log):
    """Registers, shared memory, spills and ptxas' compile time of each
    kernel (K1's keyed by its template argument d / 32), from nvcc
    -Xptxas -v."""
    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _kernel_key(m.group(1))
            rows[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[cur]["spill_stores"] = int(m.group(1))
            rows[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rows[cur]["static_smem"] = int(s.group(1)) if s else 0
        m = re.search(r"Compile time = ([\d.]+) ms", line)
        if m:
            rows[cur]["compile_ms"] = float(m.group(1))
    return rows


def timed(fn, reps, warmup=3):
    """Mean ms of fn() over `reps` calls with CUDA events, and its last
    result."""
    import torch

    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def graph_ms(fn, reps=20, replays=10):
    """Mean ms of fn() on the device alone: `reps` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events. `timed`
    launches from the host, and a kernel shorter than its wrapper's host
    work (checks, ctypes, allocation) is timed at the host's pace."""
    return graph_calls_ms([fn] * reps, replays)


def graph_calls_ms(calls, replays=10):
    """Mean ms of a call of `calls`, each made once in turn, captured in
    one CUDA graph and replayed `replays` times between CUDA events. Calls
    on distinct copies of their inputs that together pass the 50 MB L2
    (`cold_calls`) are timed with their inputs read from device memory."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(calls) * replays)


# ---------------------------------------------------------------------------
# K4 / K5
# ---------------------------------------------------------------------------
# (rows, d, knots): the fit's shape, three others, the shape of config
# c2's fit (batch 512, d = 8, K = 8) and config c3's, its forward-KL
# batch (19,200 pooled draws / 16 batches) and its NUTS's 64 chains, at
# d = 16 (the dense-mask blocks run the spline on every dim; phase
# run_configs prints the shapes c3 launches)
RQS_SHAPES = [(TRAIN_BATCH, DIM, KNOTS), (333, 8, 4), (200, 96, 12),
              (64, 256, 4), (512, 8, KNOTS), (1200, 16, KNOTS),
              (64, 16, KNOTS)]
# K5's other rows (rows, d, knots, offset): K = 64 (16 lanes of 4 bins
# in the group kernel), every input and draw a view 4 bytes into its
# buffer (the 4-byte copies; a ragged last block too), and the knots that
# reach the group kernel's other instantiations (1 and 8 lanes)
RQS_EXTRA_SHAPES = [(96, 32, 64, False), (257, 24, KNOTS, True),
                    (128, 16, 2, False), (80, 16, 24, False)]


def rqs_cases():
    """(rows, d, knots, offset) of every K4/K5 comparison."""
    return [(*r, False) for r in RQS_SHAPES] + RQS_EXTRA_SHAPES


def at_offset(t):
    """A contiguous copy of t that starts 4 bytes into its buffer."""
    import torch

    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def rqs_inputs(device, n, d, K, seed):
    """x over [-6, 6], raw ~ N(0, 1) and cotangents ~ N(0, 1); past K =
    1 / min_bin = 1000 a bin is min_bin - (min_bin K - 1) softmax, which
    only width and height logits near 0 keep positive (0.01 N(0, 1))."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = 12.0 * torch.rand((n, d), generator=g, device=device) - 6.0
    raw = torch.randn((n, d, 3 * K - 1), generator=g, device=device)
    if K > 1000:
        raw[..., :2 * K] *= 0.01
    gy = torch.randn((n, d), generator=g, device=device)
    gl = torch.randn((n, d), generator=g, device=device)
    return x, raw, gy, gl


def _within(a, b):
    """Elements where a agrees with b to the bar: jnp.allclose's test
    |a - b| <= atol + rtol |b|."""
    return (a - b).abs() <= RQS_ATOL + RQS_RTOL * b.abs()


def _units(a, b):
    """|a - b| in units of the bar around b."""
    return (a - b).abs() / (RQS_ATOL + RQS_RTOL * b.abs())


def _quantile(v, q):
    """torch.quantile of a flat tensor (linear interpolation), also past
    the 2^24 values it takes (a weight's cotangent at K = 1000 has 25
    million), there by two order statistics."""
    import torch

    n = v.numel()
    if n <= 1 << 24:
        return float(torch.quantile(v, q))
    pos = q * (n - 1)
    lo = math.floor(pos)
    a = float(torch.kthvalue(v, lo + 1).values)
    b = float(torch.kthvalue(v, min(lo + 2, n)).values)
    return a + (b - a) * (pos - lo)


def judge(kern, plain, oracle, exact, quantile=0.999, witnesses=()):
    """The spline kernels' bar on one output, refereed by `exact`, the
    plain version in float64. Two float32 evaluations of the same
    function, `plain` (the tile math) and `oracle` (`flows/rqs_ref.py`),
    give float32's own error: a few ill-conditioned elements of dx and
    draw (very narrow or flat bins) miss the JAX package's bar in every
    float32 evaluation, some by thousands of bars, so the largest error is
    noise. The kernel must be as accurate as they are: its count of
    elements beyond the bar of float64 and its `quantile` error (in units
    of the bar; the 99.9th percentile for K4/K5) may exceed the worse
    plain version's by at most 25% (plus one element, plus 0.1 bar).
    `witnesses` are further float32 evaluations of the function counted
    among the plain versions (a coupling block's plain version with its
    hidden units reordered, `permuted_params`)."""
    import torch

    exact = exact.float()
    evals = [("kernel", kern), ("plain", plain), ("oracle", oracle)]
    evals += [(f"witness{i}", w) for i, w in enumerate(witnesses)]
    errs = {k: _units(t, exact).flatten() for k, t in evals}
    miss = {k: int((v > 1.0).sum()) for k, v in errs.items()}
    q = {k: _quantile(v, quantile) for k, v in errs.items()}
    worst_miss = max(v for k, v in miss.items() if k != "kernel")
    worst_q = max(v for k, v in q.items() if k != "kernel")
    return {"max_abs": float((kern - plain).abs().max()),
            "beyond_bar_of_plain": int((~_within(kern, plain)).sum()),
            "beyond_bar_of_f64": miss, "quantile": quantile, "q_bars": q,
            "max_bars": {k: float(v.max()) for k, v in errs.items()},
            "passed": bool(torch.isfinite(kern).all()
                           and miss["kernel"] <= 1.25 * worst_miss + 1
                           and q["kernel"] <= 1.25 * worst_q + 0.1)}


def judge_rows(kern, plain, oracle, exact, quantile=0.999):
    """`judge` for an output of a bf16 conditioner, by row (a row's lp and
    g). An operand on a bf16 rounding edge rounds to one bf16 value in one
    evaluation and to its neighbour in another, and moves most of its
    row's values past the bar together, so misses come in rows, a few per
    1024 in every float32 evaluation. A row misses where any of its values
    lies beyond the bar of float64. The kernel's missed rows may number
    at most `refereed_bar`'s flips for the worse float32 plain version's
    (twice its count, at least 5 of 1024 and at most 1/64 of the rows),
    or that count itself where it is more; on the rows that no
    evaluation misses, `judge` holds as before."""
    import torch

    ex = exact.float()
    n = kern.shape[0]

    def missed(t):
        return (_units(t, ex).reshape(n, -1) > 1.0).any(dim=1)

    rows = {k: missed(t) for k, t in (("kernel", kern), ("plain", plain),
                                      ("oracle", oracle))}
    counts = {k: int(v.sum()) for k, v in rows.items()}
    spread = {"flips": max(counts["plain"], counts["oracle"]),
              "max_denergy": 0.0, "max_dq": 0.0}
    bar = max(spread["flips"], refereed_bar([spread], n)["max_flips"])
    ok = ~(rows["kernel"] | rows["plain"] | rows["oracle"])
    rest = judge(kern[ok], plain[ok], oracle[ok], exact[ok], quantile) \
        if bool(ok.any()) else {"passed": True}
    return {"rows_missed": counts, "max_rows_missed": bar,
            "max_abs": float((kern - plain).abs().max()), "rest": rest,
            "passed": bool(torch.isfinite(kern).all()
                           and counts["kernel"] <= bar and rest["passed"])}


def oracle_eval(x, raw, inverse):
    from tpuflows_torch.flows import rqs_ref

    fn = rqs_ref.rqs_inverse_from_raw if inverse else \
        rqs_ref.rqs_forward_from_raw
    return fn(x, raw, 4.0)


def oracle_grad(x, raw, gy, gl, inverse):
    import torch

    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        rg = raw.detach().requires_grad_(True)
        return torch.autograd.grad(oracle_eval(xg, rg, inverse), (xg, rg),
                                   (gy, gl))


def k5_call(x, raw, gy, gl, inverse, offset, earlier=False):
    """K5 (the group kernel, or with `earlier` the one-thread kernel it
    replaced), its draw written into a view 4 bytes into its buffer where
    `offset` says (the inputs are then such views too)."""
    from tpuflows_torch.kernels import rqs_cuda

    draw = at_offset(raw) if offset else None
    if earlier:
        return rqs_cuda.earlier_spline_grad(x, raw, gy, gl, 4.0, inverse,
                                            draw=draw)
    if offset:
        return rqs_cuda._launch_grad(x, raw, gy, gl, 4.0, inverse,
                                     draw=draw)
    return rqs_cuda.spline_grad(x, raw, gy, gl, 4.0, inverse)


def rqs_row_inputs(device, n, d, K, offset):
    ins = rqs_inputs(device, n, d, K, seed=n + d + K)
    return [at_offset(t) for t in ins] if offset else ins


def rqs_vs_plain(device, rows=None):
    """K4 and K5 against their plain versions, both directions, refereed
    by the plain version in float64 (`judge`), on every row of
    `rqs_cases`."""
    from tpuflows_torch.kernels import rqs_cuda

    out = []
    for n, d, K, offset in rows or rqs_cases():
        x, raw, gy, gl = rqs_row_inputs(device, n, d, K, offset)
        f64 = [t.double() for t in (x, raw, gy, gl)]
        for inverse in (False, True):
            outs = (
                ("y", "ladj", rqs_cuda.spline_eval(x, raw, 4.0, inverse),
                 rqs_cuda.plain_eval(x, raw, 4.0, inverse),
                 oracle_eval(x, raw, inverse),
                 rqs_cuda.plain_eval(*f64[:2], 4.0, inverse)),
                ("dx", "draw", k5_call(x, raw, gy, gl, inverse, offset),
                 rqs_cuda.plain_grad(x, raw, gy, gl, 4.0, inverse),
                 oracle_grad(x, raw, gy, gl, inverse),
                 rqs_cuda.plain_grad(*f64, 4.0, inverse)))
            row = {"n": n, "d": d, "knots": K, "offset": offset,
                   "direction": "inverse" if inverse else "forward"}
            for n1, n2, k, p, o, e in outs:
                for j, name in enumerate((n1, n2)):
                    row[name] = judge(k[j], p[j], o[j], e[j])
            row["passed"] = all(row[m]["passed"]
                                for m in ("y", "ladj", "dx", "draw"))
            out.append(row)
    return out


def k4_call(x, raw, inverse, earlier=False):
    """K4 (the group kernel, or with `earlier` the one-thread kernel it
    replaced)."""
    from tpuflows_torch.kernels import rqs_cuda

    if earlier:
        return rqs_cuda.earlier_spline_eval(x, raw, 4.0, inverse)
    return rqs_cuda.spline_eval(x, raw, 4.0, inverse)


def bits_vs_earlier(device, names, call, rows=None):
    """A group kernel against the one-thread kernel it replaced, on the
    same inputs, both directions, every row of `rqs_cases`: the elements of
    each output (`names`) whose bits differ (expected 0) and the largest
    difference. `call(x, raw, gy, gl, inverse, offset, earlier)` runs
    either kernel."""
    import torch

    out = []
    for n, d, K, offset in rows or rqs_cases():
        x, raw, gy, gl = rqs_row_inputs(device, n, d, K, offset)
        for inverse in (False, True):
            new = call(x, raw, gy, gl, inverse, offset, False)
            old = call(x, raw, gy, gl, inverse, offset, True)
            row = {"n": n, "d": d, "knots": K, "offset": offset,
                   "direction": "inverse" if inverse else "forward"}
            for name, a, b in zip(names, new, old):
                a, b = a.contiguous(), b.contiguous()
                row[name] = {
                    "bits_differ": int((a.view(torch.int32)
                                        != b.view(torch.int32)).sum()),
                    "max_abs": float((a - b).abs().max())}
            row["bits_differ"] = sum(row[m]["bits_differ"] for m in names)
            out.append(row)
    return out


def k4_vs_earlier(device, rows=None):
    """K4's group kernel against the one-thread K4 on y and ladj."""
    return bits_vs_earlier(
        device, ("y", "ladj"),
        lambda x, raw, gy, gl, inverse, offset, earlier: k4_call(
            x, raw, inverse, earlier), rows)


def k5_vs_earlier(device, rows=None):
    """K5's group kernel against the one-thread K5 on dx and draw."""
    return bits_vs_earlier(device, ("dx", "draw"), k5_call, rows)


def rqs_bytes_ops(n_el, K):
    """(K4 bytes, K4 ops, K5 bytes, K5 ops) for n_el elements: each input
    read once and each output written once (x, 3K-1 raw in, y and ladj
    out; K5 also reads gy, gl and writes dx, draw), and a count of the
    spline's arithmetic that takes each exp, log, division and select as
    one operation (normalisation ~8K, running knot select ~17K, evaluation
    ~30; the pullback about as much again plus ~12K)."""
    P = 3 * K - 1
    k4_ops = 25 * K + 30
    return (4.0 * n_el * (1 + P + 2), float(n_el * k4_ops),
            4.0 * n_el * (1 + P + 2 + 1 + P), float(n_el * (2 * k4_ops
                                                             + 12 * K + 60)))


def time_rqs(device, ptxas=None, n_reps=200, plain_reps=20):
    """K4 and K5 at the fit's shape, forward and inverse, with CUDA events
    (launched from the host, and replayed from a CUDA graph: `graph_ms`),
    beside their bounds and the plain versions, and beside the one-thread
    kernels they replaced, host-launched and in turns on the device
    (`in_turns`: earlier, new, new, earlier), with both kernels' registers
    and spills from `ptxas` (`ptxas_summary` of the build). The device
    times are taken twice: on one set of inputs, which stays in L2 between
    calls (`device_ms`), and over `cold_calls` copies of them, each read
    from device memory (`cold_device_ms`), the time the bound, a read from
    device memory, is compared with (`bound_share`)."""
    from tpuflows_torch.kernels import rqs_cuda

    n, d, K = RQS_SHAPES[0]
    b4, o4, b5, o5 = rqs_bytes_ops(n * d, K)
    ptxas = ptxas or {}
    out = {}
    for inverse in (False, True):
        direction = "inverse" if inverse else "forward"
        for kname, nbytes, ops, bins in (("k4", b4, o4,
                                          rqs_cuda.EVAL_LANE_BINS),
                                         ("k5", b5, o5, rqs_cuda.LANE_BINS)):
            def kern(x, raw, gy, gl, earlier=False):
                if kname == "k4":
                    return k4_call(x, raw, inverse, earlier)
                return k5_call(x, raw, gy, gl, inverse, False, earlier)

            def plain(x, raw, gy, gl):
                if kname == "k4":
                    return rqs_cuda.plain_eval(x, raw, 4.0, inverse)
                return rqs_cuda.plain_grad(x, raw, gy, gl, 4.0, inverse)

            ins = rqs_inputs(device, n, d, K, seed=n + d + K)
            ms, res = timed(lambda: kern(*ins), n_reps)
            plain_ms, ref = timed(lambda: plain(*ins), plain_reps)
            earlier_ms, _ = timed(lambda: kern(*ins, earlier=True), n_reps)
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = ops / PEAK_F32_FLOPS * 1e3
            L, NB, _ = rqs_cuda.lane_layout(K, bins)
            label = kname.upper()
            row = out[f"{kname}_{direction}"] = {
                "ms": ms, "plain_ms": plain_ms, "earlier_ms": earlier_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops,
                "max_abs_err": max(float((a - b).abs().max())
                                   for a, b in zip(res, ref)),
                "lanes": L, "bins_per_lane": NB,
                "ptxas": ptxas.get(f"{label} {direction} L={L}"),
                "earlier_ptxas": ptxas.get(f"{label} one-thread {direction}")}
            (row["device_ms"], row["earlier_device_ms"],
             row["device_turns"], row["earlier_turns"]) = in_turns(
                lambda: kern(*ins), lambda: kern(*ins, earlier=True))
            copies = cold_calls(nbytes)
            cold = [rqs_inputs(device, n, d, K, seed=n + d + K + c)
                    for c in range(copies)]
            (row["cold_device_ms"], row["earlier_cold_device_ms"],
             row["cold_turns"], row["earlier_cold_turns"]) = in_turns(
                [lambda c=c: kern(*c) for c in cold],
                [lambda c=c: kern(*c, earlier=True) for c in cold],
                graph_calls_ms)
            row["cold_copies"] = copies
            row["bound_share"] = row["bound_ms"] / row["cold_device_ms"]
            row["warm_bound_share"] = row["bound_ms"] / row["device_ms"]
            del cold
    return out


def cold_calls(nbytes):
    """Copies of a call's inputs that together pass the L2: COLD_BYTES
    over the bytes one call moves."""
    return math.ceil(COLD_BYTES / nbytes)


# ---------------------------------------------------------------------------
# K6 / K7
# ---------------------------------------------------------------------------
# (rows, d, hidden, knots, mask, head, activation): the fit's shape under
# each of the mixed masks, a ragged batch, d = 256 (where the JAX package's
# own "auto" picks this tier; its last layer, 128 x 5888 floats, is
# streamed), and two rows off the main path: the other activations, one
# and three hidden layers, other knots, and spline dims that fill no whole
# chunk (16 of 32) or end in a partial one (48). head: the last layer's
# weights, "n0.1" = 0.1 N(0, 1) (the JAX tests'), "he0.01" = 0.01 x the He
# scale (SPLINE_HEAD, as the gated spline rows of K1); other weights He,
# biases 0.1 N(0, 1).
COUPLING_SHAPES = [
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating0", "n0.1", "silu"),
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating1", "n0.1", "silu"),
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "block0", "n0.1", "silu"),
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "block1", "n0.1", "silu"),
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating0", "he0.01", "silu"),
    (37, DIM, HIDDEN, KNOTS, "alternating1", "n0.1", "silu"),
    (TRAIN_BATCH, 256, HIDDEN, KNOTS, "alternating0", "n0.1", "silu"),
    (TRAIN_BATCH, 256, HIDDEN, KNOTS, "block1", "he0.01", "silu"),
    (300, 32, (64,), 4, "alternating0", "n0.1", "tanh"),
    (513, 96, (96, 48, 80), 12, "block0", "he0.01", "relu"),
    (45, DIM, (3200,), KNOTS, "alternating1", "he0.01", "silu")]
# the conditioners the earlier kernels refuse (no earlier column), at the
# fused fit's shape: gelu, and bf16 operands (a row's compute_dtype after
# its activation)
COUPLING_FORM_SHAPES = [
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating0", "n0.1", "gelu"),
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating0", "n0.1", "silu",
     "bf16"),
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating0", "n0.1", "gelu",
     "bf16")]
COUPLING_PARAMS = ("w0", "b0", "w1", "b1", "w2", "b2")


def param_names(n_params):
    """w0, b0, w1, b1, ... for a conditioner's flat parameters."""
    return tuple(f"{'wb'[j % 2]}{j // 2}" for j in range(n_params))


def coupling_mask(name, d):
    from tpuflows_torch.util.shapes import alternating_mask, block_mask

    kind, i = name[:-1], int(name[-1])
    return alternating_mask(d, i) if kind == "alternating" else \
        block_mask(d, i)


def coupling_inputs(device, n, d, hidden, K, head, seed):
    """(x, flat p-major params, gz, gladj), drawn on `device`: x ~ 2 N(0,
    1) (the JAX test's spread; some of it beyond B = 4), He hidden
    weights, the last layer's weights as `head` says, biases 0.1 N(0, 1),
    cotangents N(0, 1)."""
    import torch
    from tpuflows_torch.kernels.tile_flow import p_major

    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    P = 3 * K - 1
    sizes = (d, *hidden, P * d)
    params = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = randn(a, b)
        if i < len(hidden):
            w = math.sqrt(2.0 / a) * w
        elif head == "n0.1":
            w = 0.1 * w
        else:
            w = 0.01 * math.sqrt(2.0 / a) * w
        bias = 0.1 * randn(b)
        if i == len(hidden):  # drawn d-major, as a module holds them
            w, bias = p_major(w, d, P), p_major(bias, d, P)
        params += [w.contiguous(), bias.reshape(1, -1).contiguous()]
    return 2.0 * randn(n, d), tuple(params), randn(n, d), randn(n)


def oracle_block(x, params, mask, K, inverse, activation="silu",
                 compute_dtype="f32"):
    """The block through the oracle spline (`flows/rqs_ref.py`) on the
    same flat p-major parameters (bf16 operands for a bf16 conditioner):
    a float32 evaluation independent of the tile math. Returns (z, ladj
    (T,))."""
    import torch
    from tpuflows_torch.flows import rqs_ref
    from tpuflows_torch.flows.nets import _ACTIVATIONS, _bf16_operand

    act = _ACTIVATIONS[activation]
    T, d = x.shape
    ws, bs = params[0::2], params[1::2]

    def dot(a, w):
        if compute_dtype == "bf16":
            return _bf16_operand(a) @ _bf16_operand(w)
        return a @ w

    h = x * mask
    for w, b in zip(ws[:-1], bs[:-1]):
        h = act(dot(h, w) + b)
    raw = (dot(h, ws[-1]) + bs[-1]).reshape(T, 3 * K - 1, d).transpose(1,
                                                                       2)
    fn = rqs_ref.rqs_inverse_from_raw if inverse else \
        rqs_ref.rqs_forward_from_raw
    y, ladj_el = fn(x, raw, 4.0)
    z = mask * x + (1.0 - mask) * y
    return z, torch.sum((1.0 - mask) * ladj_el, dim=-1)


def oracle_block_vjp(x, params, mask, K, inverse, gz, gl, activation,
                     compute_dtype="f32"):
    import torch

    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        pg = [p.detach().requires_grad_(True) for p in params]
        out = oracle_block(xg, pg, mask, K, inverse, activation,
                           compute_dtype)
        return torch.autograd.grad(out, (xg, *pg), (gz, gl))


def block_quantile(n):
    """The error quantile `judge` compares for an output of n values: the
    99.9th percentile, or the 10th-largest error where that is lower (the
    median at most). A bias's cotangent or a per-row ladj has only
    10^2-10^3 values, and there the 99.9th percentile is the largest
    error, which is noise (`judge`)."""
    return max(0.5, min(0.999, 1.0 - 10.0 / n))


def tile_plans(cc, widths, K, nt, n, device, wide=False):
    """K6's and K7's launch plans (`tile_plan`; the wide unit's where
    `wide`) as dicts; on the card each tile plan's shared memory, or each
    wide plan's work buffer, is also asked of its library, and the two
    must agree (the plan is Python, the layout CUDA)."""
    import torch

    plans = {}
    for key, grad in (("k6", False), ("k7", True)):
        plan = cc.tile_plan(widths, K, nt, n, grad, wide)
        plans[key] = plan._asdict()
        if torch.device(device).type != "cuda":
            continue
        if plan.wide:
            floats = cc.wide_floats(widths, K, plan.dc, grad, n)
            plans[key]["work_floats"] = floats
            got = cc.WIDE_LIBRARY.load().coupling_wide_floats(
                cc._ints(widths), len(widths) - 1, K, plan.dc, int(grad), n)
            what = "floats of work buffer"
            want = floats
        else:
            got = cc.LIBRARY.load().coupling_tile_smem(
                cc._ints(widths), len(widths) - 1, K, plan.rows, plan.dc,
                plan.stage, int(grad))
            what = "bytes of shared memory"
            want = plan.smem
        if got != want:
            raise RuntimeError(f"tile_plan's {want} {what} for widths "
                               f"{widths}, the kernel's layout {got}")
    return plans


def earlier_diffs(names, new, old):
    """How far the new kernels' outputs part from the earlier kernels'
    (the yardstick): the largest difference of each, and whether all are
    equal to the bit."""
    import torch

    return {"max_abs": {k: float((a - b).abs().max()) if a.numel() else 0.0
                        for k, a, b in zip(names, new, old)},
            "bitwise": all(torch.equal(a, b) for a, b in zip(new, old))}


def earlier_vs_new(cc, x, params, spec, gz, gl, new, names):
    """`earlier_diffs` of the earlier kernels against the new ones' outputs
    `new` (z, ladj, dx, the parameters' cotangents), over what the earlier
    kernels take: K6's outputs alone where the earlier K7 refuses the
    block (its tile cannot hold it), none where the earlier K6 does."""
    try:
        old = list(cc.earlier_block_eval(x, params, spec))
    except ValueError as e:
        return {"refused": str(e)}
    try:
        wdx, wdp = cc.earlier_block_grad(x, params, spec, gz, gl)
    except ValueError as e:
        out = earlier_diffs(names[:2], new[:2], old)
        out["k7_refused"] = str(e)
        return out
    return earlier_diffs(names, new, [*old, wdx, *wdp])


def coupling_vs_plain(device, shapes=(*COUPLING_SHAPES,
                                      *COUPLING_FORM_SHAPES), witnesses=0):
    """K6 and K7 against their plain versions, both directions, on z, ladj,
    dx and every weight's and bias's cotangent, refereed by the plain
    version in float64 (`judge`, the spline kernels' bar, at the quantile
    `block_quantile`). Both plain versions take their conditioner from
    PyTorch's matmul, so they share its rounding; the kernels sum their own
    products and round differently, which the bar's comparison against
    float64 allows for. K7 runs twice and must repeat itself to the bit
    (its sums have a fixed order), and its dx without the weights' pass
    must equal its dx with it. On the card each row also prints the launch
    plans and how far the earlier kernels' outputs (8 rows a block, the
    yardstick) part from the new ones: a second reference, not a bar.
    Where no tile of K7 fits the shared memory (a hidden layer of 3200
    units), K7 runs on the wide unit, and the earlier K7, which refuses
    the block, has no column. A row may name the
    conditioner's compute_dtype after its activation ("bf16"); the
    earlier kernels, which refuse gelu and bf16, more than 64 knots and
    more than 8 layers, have no column there. `witnesses` more float32
    evaluations, the plain version under `permuted_params`, count in
    `judge` beside the plain version and the oracle."""
    import torch
    from tpuflows_torch.kernels import coupling_cuda as cc

    on_card = torch.device(device).type == "cuda"
    rows = []
    for n, d, hidden, K, mask_name, head, act, *dtype in shapes:
        dtype = dtype[0] if dtype else "f32"
        earlier = (act in cc.EARLIER_ACTIVATIONS and dtype == "f32"
                   and K <= cc.EARLIER_MAX_KNOTS
                   and len(hidden) < cc.EARLIER_MAX_LAYERS)
        mask_t = coupling_mask(mask_name, d)
        x, params, gz, gl = coupling_inputs(device, n, d, hidden, K, head,
                                            seed=n + d + K)
        m32 = torch.tensor(mask_t, dtype=torch.float32, device=device)
        f64 = [t.double() for t in (x, *params, gz, gl)]
        x64, p64, gz64, gl64 = f64[0], tuple(f64[1:-2]), f64[-2], f64[-1]
        widths = [d, *hidden, (3 * K - 1) * d]
        nt = sum(1 for m in mask_t if m == 0)
        plans = tile_plans(cc, widths, K, nt, n, device)
        for inverse in (False, True):
            spec = cc.BlockSpec(mask_t, K, 4.0, act, inverse, dtype)
            kz = cc.block_eval(x, params, spec)
            pz = cc.plain_block(x, params, m32, K, 4.0, act, inverse, dtype)
            oz = oracle_block(x, params, m32, K, inverse, act, dtype)
            ez = cc.plain_block(x64, p64, m32.double(), K, 4.0, act, inverse,
                                dtype)
            row = {"n": n, "d": d, "hidden": list(hidden), "knots": K,
                   "mask": mask_name, "head": head, "activation": act,
                   "compute_dtype": dtype,
                   "direction": "inverse" if inverse else "forward",
                   "plans": plans}
            outs = [("z", kz[0], pz[0], oz[0], ez[0]),
                    ("ladj", kz[1], pz[1], oz[1], ez[1])]
            kdx, kdp = cc.block_grad(x, params, spec, gz, gl)
            rdx, rdp = cc.block_grad(x, params, spec, gz, gl)
            odx, _ = cc.block_grad(x, params, spec, gz, gl,
                                   need_params=False)
            pdx, pdp = cc.plain_block_vjp(x, params, m32, gz, gl, K, 4.0,
                                          act, inverse, dtype)
            odx2, *odp = oracle_block_vjp(x, params, m32, K, inverse, gz,
                                          gl, act, dtype)
            edx, edp = cc.plain_block_vjp(x64, p64, m32.double(), gz64,
                                          gl64, K, 4.0, act, inverse,
                                          dtype)
            outs += [("dx", kdx, pdx, odx2, edx)]
            outs += [(name, k, p, o, e) for name, k, p, o, e in zip(
                param_names(len(params)), kdp, pdp, odp, edp)]
            wits = [[] for _ in outs]
            for i in range(witnesses):
                perms = hidden_perms(widths, n + d + K + 7 * (i + 1), device)
                wp = permuted_params(params, perms)
                wz = cc.plain_block(x, wp, m32, K, 4.0, act, inverse, dtype)
                wdx, wdp = cc.plain_block_vjp(x, wp, m32, gz, gl, K, 4.0,
                                              act, inverse, dtype)
                for j, t in enumerate([*wz, wdx,
                                       *unpermute_cotangents(wdp, perms)]):
                    wits[j].append(t)
            row["repeats_bitwise"] = bool(
                torch.equal(kdx, rdx) and torch.equal(kdx, odx)
                and all(torch.equal(a, b) for a, b in zip(kdp, rdp)))
            for (name, k, p, o, e), w in zip(outs, wits):
                row[name] = judge(k, p, o, e, block_quantile(k.numel()), w)
            if on_card and earlier:
                row["earlier"] = earlier_vs_new(
                    cc, x, params, spec, gz, gl, [kz[0], kz[1], kdx, *kdp],
                    [name for name, *_ in outs])
            row["passed"] = row["repeats_bitwise"] and all(
                row[name]["passed"] for name, *_ in outs)
            rows.append(row)
    return rows


def coupling_work(n, d, hidden, K, nt):
    """(K6 ops, K6 bytes, K7 ops, K7 bytes, K7 pass-1 ops, pass-1 bytes)
    of a block on n rows with nt spline dims. The work the function needs:
    the conditioner's products over the hidden layers and over the spline
    dims' P nt columns of the last layer (a pass-through dim's columns
    reach nothing), 2 operations per multiply-add, and the spline's
    arithmetic counted as in `rqs_bytes_ops`; K7 recomputes the
    conditioner, pulls back through each layer (2 products) and, for the
    weights, forms H^T G (one more). Bytes: each input read once (x, the
    cotangents, the weights it needs) and each output written once (z and
    ladj; dx and, for K7, the whole of every cotangent of the weights)."""
    P = 3 * K - 1
    widths = (d, *hidden)
    mac = sum(a * b for a, b in zip(widths[:-1], widths[1:])) \
        + hidden[-1] * P * nt
    k4_ops = 25 * K + 30
    spline = n * nt * k4_ops
    spline_vjp = n * nt * (2 * k4_ops + 12 * K + 60)
    need = mac + sum(hidden) + P * nt  # weights and biases read
    full = sum(a * b + b for a, b in zip((*widths,), (*hidden, P * d)))
    k6_ops = 2.0 * n * mac + spline
    k6_bytes = 4.0 * (n * d + need + d + n * d + n)
    k7a_ops = 4.0 * n * mac + spline_vjp
    k7a_bytes = 4.0 * (2 * n * d + n + need + d + n * d)
    return (k6_ops, k6_bytes, k7a_ops + 2.0 * n * mac,
            k7a_bytes + 4.0 * full, k7a_ops, k7a_bytes)


def _bound(ops, nbytes):
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def wgrad_work(n, d, hidden, K, nt):
    """(ops, bytes) of K7's pass 2 alone: dW_l = H_l^T G_l with a row of
    ones for the bias, over n rows, the last layer's over the spline dims;
    it reads pass 1's scratch once and writes every weight's and bias's
    cotangent (the last layer's whole p-major arrays)."""
    P = 3 * K - 1
    ins = (d, *hidden)
    outs = (*hidden, P * nt)
    ops = 2.0 * n * sum((a + 1) * b for a, b in zip(ins, outs))
    full = sum(a * b + b for a, b in zip(ins, (*hidden, P * d)))
    return ops, 4.0 * (n * (sum(ins) + sum(outs)) + full)


def in_turns(new_fn, old_fn, ms=graph_ms):
    """Device ms of two functions from CUDA graphs (`graph_ms`, or `ms`),
    in turns old, new, new, old: (new mean, old mean, both readings of
    each)."""
    o1 = ms(old_fn)
    n1 = ms(new_fn)
    n2 = ms(new_fn)
    o2 = ms(old_fn)
    return (n1 + n2) / 2, (o1 + o2) / 2, [n1, n2], [o1, o2]


# (rows, d, hidden, knots, mask): the fit's shape and d = 256
COUPLING_TIMING_SHAPES = [(TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating0"),
                          (TRAIN_BATCH, 256, HIDDEN, KNOTS, "alternating0")]


def time_coupling(device, shapes=COUPLING_TIMING_SHAPES, n_reps=200,
                  plain_reps=20):
    """K6 and K7 with CUDA events at the fit's shape and at d = 256, both
    directions, launched from the host (`timed`) and replayed from a CUDA
    graph (`graph_ms`, the device alone), beside their bounds, their plain
    versions and the earlier kernels (8 rows a block, timed in turns with
    the new ones: `earlier_device_ms`). K7 is timed as the fit runs it:
    with the weights' pass in the inverse direction (the sample path,
    whose weights train) and without it in the forward direction (the STL
    loss's detached pass); the other variant is timed too, and pass 2
    alone (`pass2`). Beside them, the same block on the K4/K5 tier
    (torch.matmul conditioner + K4/K5) and on this tier through autograd,
    forward alone and forward + backward with every cotangent: a
    comparison of tiers, not a library call (no single PyTorch call
    computes a block)."""
    import torch
    from tpuflows_torch.flows import MLP, RQSCouplingBlock
    from tpuflows_torch.kernels import coupling_cuda as cc

    rows = []
    for n, d, hidden, K, mask_name in shapes:
        mask_t = coupling_mask(mask_name, d)
        nt = sum(1 for m in mask_t if m == 0)
        x, params, gz, gl = coupling_inputs(device, n, d, hidden, K, "n0.1",
                                            seed=n + d + K)
        m32 = torch.tensor(mask_t, dtype=torch.float32, device=device)
        widths = [d, *hidden, (3 * K - 1) * d]
        k6_ops, k6_bytes, k7_ops, k7_bytes, k7a_ops, k7a_bytes = \
            coupling_work(n, d, hidden, K, nt)
        row = {"n": n, "d": d, "hidden": list(hidden), "knots": K,
               "mask": mask_name, "spline_dims": nt,
               "plans": tile_plans(cc, widths, K, nt, n, device)}
        for inverse in (False, True):
            direction = "inverse" if inverse else "forward"
            spec = cc.BlockSpec(mask_t, K, 4.0, "silu", inverse)
            fit_params = inverse  # what the fit runs
            cases = (
                ("k6", k6_ops, k6_bytes,
                 lambda: cc.block_eval(x, params, spec),
                 lambda: cc.earlier_block_eval(x, params, spec),
                 lambda: cc.plain_block(x, params, m32, K, 4.0, "silu",
                                        inverse)),
                ("k7", *((k7_ops, k7_bytes) if fit_params
                         else (k7a_ops, k7a_bytes)),
                 lambda: cc.block_grad(x, params, spec, gz, gl,
                                       need_params=fit_params),
                 lambda: cc.earlier_block_grad(x, params, spec, gz, gl,
                                               need_params=fit_params),
                 lambda: cc.plain_block_vjp(x, params, m32, gz, gl, K, 4.0,
                                            "silu", inverse)))
            for kname, ops, nbytes, kern, old, plain in cases:
                ms, _ = timed(kern, n_reps)
                earlier_ms, _ = timed(old, n_reps)
                dev, old_dev, dev_turns, old_turns = in_turns(kern, old)
                plain_ms, _ = timed(plain, plain_reps)
                bound_ms, bound_by = _bound(ops, nbytes)
                row[f"{kname}_{direction}"] = {
                    "ms": ms, "device_ms": dev, "device_ms_turns": dev_turns,
                    "earlier_ms": earlier_ms, "earlier_device_ms": old_dev,
                    "earlier_device_ms_turns": old_turns,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "ops": ops, "bytes": nbytes,
                    "with_weight_pass": kname == "k7" and fit_params}
            k7 = row[f"k7_{direction}"]
            k7["other_variant_ms"], _ = timed(lambda: cc.block_grad(
                x, params, spec, gz, gl, need_params=not fit_params), n_reps)
            k7["other_variant_device_ms"] = graph_ms(lambda: cc.block_grad(
                x, params, spec, gz, gl, need_params=not fit_params))
            k7["earlier_other_variant_device_ms"] = graph_ms(
                lambda: cc.earlier_block_grad(x, params, spec, gz, gl,
                                              need_params=not fit_params))
            # pass 2 alone, on pass 1's scratch
            plan = cc.tile_plan(widths, K, nt, n, True)
            _, Hs, Gs = cc._pass1(x, params, spec, widths, gz, gl, plan,
                                  True)
            p2_ops, p2_bytes = wgrad_work(n, d, hidden, K, nt)
            p2_bound, p2_by = _bound(p2_ops, p2_bytes)
            k7["pass2"] = {
                "device_ms": graph_ms(lambda: cc._pass2(
                    x, params, spec, widths, plan, Hs, Gs)),
                "slices": plan.slices, "ops": p2_ops, "bytes": p2_bytes,
                "bound_ms": p2_bound, "bound_by": p2_by}
            # the same block on both tiers, through the module
            ws = list(params[0::2])
            bs = [b.reshape(-1) for b in params[1::2]]
            P = 3 * K - 1
            ws[-1] = ws[-1].reshape(-1, P, d).transpose(1, 2).reshape(
                -1, d * P)
            bs[-1] = bs[-1].reshape(P, d).t().reshape(-1)
            net = MLP([w.contiguous() for w in ws],
                      [b.contiguous() for b in bs])
            tiers = {}
            for tier in (True, "fused"):
                blk = RQSCouplingBlock(mask_t, net, knots=K,
                                       use_pallas=tier)
                f = blk.inverse_and_ladj if inverse else blk.forward_and_ladj

                def ev(f=f):
                    with torch.no_grad():
                        return f(x)

                def ev_grad(f=f):
                    xx = x.detach().requires_grad_(True)
                    z, ladj = f(xx)
                    return torch.autograd.grad(
                        (z, ladj), (xx, *net.parameters()), (gz, gl))

                tiers["k4k5" if tier is True else "fused"] = {
                    "eval_ms": timed(ev, n_reps // 4)[0],
                    "eval_grad_ms": timed(ev_grad, n_reps // 4)[0]}
            row[f"tiers_{direction}"] = tiers
        rows.append(row)
    return rows


# the conditioners K6/K7 take beyond float32 silu, tanh and relu, timed at
# the fused fit's shape: (activation, compute_dtype)
COUPLING_FORMS = (("gelu", "f32"), ("silu", "bf16"), ("gelu", "bf16"))


def time_coupling_forms(device, forms=COUPLING_FORMS, n_reps=50,
                        plain_reps=5):
    """K6 and K7 on the conditioners of `forms` at the fit's shape (1024 x
    64, hidden 128 x 128, K = 8, alternating mask), both directions, K7
    as the fit runs it (the weights' pass in the inverse direction):
    launched from the host (`timed`) and replayed from a CUDA graph
    (`graph_ms`), beside the bound (`coupling_work`) and the plain
    version. No earlier kernel takes them."""
    import torch
    from tpuflows_torch.kernels import coupling_cuda as cc

    n, d, hidden, K, mask_name = COUPLING_TIMING_SHAPES[0]
    mask_t = coupling_mask(mask_name, d)
    nt = sum(1 for m in mask_t if m == 0)
    x, params, gz, gl = coupling_inputs(device, n, d, hidden, K, "n0.1",
                                        seed=n + d + K)
    m32 = torch.tensor(mask_t, dtype=torch.float32, device=device)
    k6_ops, k6_bytes, k7_ops, k7_bytes, k7a_ops, k7a_bytes = \
        coupling_work(n, d, hidden, K, nt)
    rows = []
    for act, dtype in forms:
        row = {"activation": act, "compute_dtype": dtype, "n": n, "d": d,
               "hidden": list(hidden), "knots": K, "mask": mask_name,
               "plans": tile_plans(cc, [d, *hidden, (3 * K - 1) * d], K,
                                   nt, n, device)}
        for inverse in (False, True):
            direction = "inverse" if inverse else "forward"
            spec = cc.BlockSpec(mask_t, K, 4.0, act, inverse, dtype)
            cases = (
                ("k6", k6_ops, k6_bytes,
                 lambda: cc.block_eval(x, params, spec),
                 lambda: cc.plain_block(x, params, m32, K, 4.0, act,
                                        inverse, dtype)),
                ("k7", *((k7_ops, k7_bytes) if inverse
                         else (k7a_ops, k7a_bytes)),
                 lambda: cc.block_grad(x, params, spec, gz, gl,
                                       need_params=inverse),
                 lambda: cc.plain_block_vjp(x, params, m32, gz, gl, K, 4.0,
                                            act, inverse, dtype)))
            for kname, ops, nbytes, kern, plain in cases:
                bound_ms, bound_by = _bound(ops, nbytes)
                row[f"{kname}_{direction}"] = {
                    "ms": timed(kern, n_reps)[0], "device_ms": graph_ms(kern),
                    "plain_ms": timed(plain, plain_reps)[0],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "with_weight_pass": kname == "k7" and inverse}
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------
def bench_flow_with_random_head(device, seed):
    """The flow the JAX kernel's on-chip bar was measured with
    (scripts/nuts_kernel_onchip_diff.py: `build_flow` on N(0, 1) samples),
    except that its last layer is random and non-zero, so that the MLP
    path is exercised."""
    import torch
    from tpuflows_torch.flows import build_flow

    g = torch.Generator(device=device).manual_seed(seed)
    init = torch.randn((1024, DIM), generator=g, device=device)
    flow = build_flow(init, g, kind="affine", n_blocks=1, hidden=HIDDEN,
                      mask_scheme="leading", clamp=CLAMP, device=device)
    net = flow.transforms[1].net
    with torch.no_grad():
        w3, b3 = net.weights[2], net.biases[2]
        w3.copy_(0.3 * math.sqrt(2.0 / w3.shape[0]) * torch.randn(
            w3.shape, generator=g, device=device))
        b3.copy_(0.1 * torch.randn(b3.shape, generator=g, device=device))
    return flow


def spline_flow_with_random_heads(device, seed, dim=DIM, hidden=HIDDEN,
                                  knots=KNOTS, n_blocks=GENERIC_BLOCKS,
                                  head=SPLINE_HEAD, kind="arqs",
                                  mask_scheme="mixed", n_leading=1,
                                  clamp=CLAMP, activation="silu"):
    """The generic path's arqs flow as bench.py builds it on N(0, 1)
    samples (or another `kind`, `mask_scheme`, `n_leading`, `clamp` and
    `activation` of `build_flow`), with every conditioner's last layer
    random: weights
    `head` times the He scale, biases 0.1 N(0, 1). Drawn on the CPU, so
    that the same flow can be carried to the JAX package there."""
    import torch
    from tpuflows_torch.flows import build_flow

    g = torch.Generator().manual_seed(seed)
    init = torch.randn((1024, dim), generator=g)
    flow = build_flow(init, g, kind=kind, n_blocks=n_blocks, knots=knots,
                      hidden=hidden, mask_scheme=mask_scheme, clamp=clamp,
                      n_leading=n_leading, activation=activation,
                      use_pallas="auto", device=device)
    with torch.no_grad():
        for t in flow.transforms[1:]:
            w, b = t.net.weights[-1], t.net.biases[-1]
            w.copy_(head * math.sqrt(2.0 / w.shape[0])
                    * torch.randn(w.shape, generator=g))
            b.copy_(0.1 * torch.randn(b.shape, generator=g))
    return flow


def random_flow(device, seed, dim, hidden, mask, activation="silu",
                compute_dtype="f32"):
    """Standardize + one affine coupling with every leaf random from
    `seed` (non-zero last layer), its MLP of `activation` and
    `compute_dtype`."""
    import torch
    from tpuflows_torch.flows import AffineCoupling, Chain, MLP, Standardize

    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    sizes = (dim, *hidden, 2 * dim)
    ws = [math.sqrt(2.0 / a) * randn(a, b)
          for a, b in zip(sizes[:-1], sizes[1:])]
    ws[-1] = 0.3 * ws[-1]
    bs = [0.1 * randn(b) for b in sizes[1:]]
    return Chain([Standardize(0.3 * randn(dim), 0.2 * randn(dim)),
                  AffineCoupling(mask, MLP(ws, bs, activation=activation,
                                           compute_dtype=compute_dtype),
                                 clamp=CLAMP)])


def compare(plain, kern, max_dq=MAX_DQ):
    """Knife-edge chains (any disagreement on leapfrog count, depth,
    divergence or U-turn, or a q difference above 1e-3 that reveals a
    flipped proposal) and the largest differences on the other chains,
    against K1's bar (with `max_dq` for q)."""
    flip = knife_edge(plain, kern)
    dq = (plain[0] - kern[0]).abs().amax(dim=1)
    agree = ~flip

    def worst(x):
        return float(x[agree].max()) if bool(agree.any()) else float("nan")

    n = int(plain[1].numel())
    res = {"chains": n, "flips": int(flip.sum()), "max_dq": worst(dq),
           "max_denergy": worst((plain[7] - kern[7]).abs()),
           "max_dlogp": worst((plain[1] - kern[1]).abs())}
    # the bar, with the flips scaled to the chain count
    res["passed"] = bool(res["flips"] <= max(1, n * MAX_FLIPS // 1024)
                         and res["max_denergy"] <= MAX_DENERGY
                         and res["max_dq"] <= max_dq)
    return res


def spline_inputs(device, n, d, depth, seed, unit_metric):
    """q ~ N(0, 1), the metric and the randomness of a spline row, drawn on
    the CPU (as `spline_flow_with_random_heads`) and moved to `device`."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda

    g = torch.Generator().manual_seed(seed)
    q = torch.randn((n, d), generator=g)
    im = torch.ones(d) if unit_metric else 0.5 + torch.rand(d, generator=g)
    rnd = nuts_cuda.draw_randomness(g, n, d, depth, im)
    return [t.to(device) for t in (q, im, *rnd)]


def card_inputs(device, n, d, depth, seed, unit_metric):
    """q ~ N(0, 1), a unit or a random diagonal metric and the
    precomputed randomness of K1, drawn on `device` from `seed`."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda

    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((n, d), generator=g, device=device)
    im = (torch.ones(d, device=device) if unit_metric
          else 0.5 + torch.rand(d, generator=g, device=device))
    return [q, im, *nuts_cuda.draw_randomness(g, n, d, depth, im)]


def kernel_vs_plain(device, flow, n, depth, eps, seed, unit_metric,
                    plain_spread=False, cpu_inputs=False):
    """K1 against its plain version on one set of inputs: q ~ N(0, 1), a
    unit or a random diagonal metric, and the precomputed randomness
    (drawn on the card, or on the CPU with `cpu_inputs`). `plain_spread`
    also compares two plain versions (the streamed and the whole-flow
    autograd gradient) on the same inputs."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.targets import NealsFunnel

    d = flow.transforms[0].loc.numel()  # every flow here is standardized
    model = nuts_cuda.pack_flow(flow, NealsFunnel(dim=d))
    target = model.target
    if cpu_inputs:
        q, im, *rnd = spline_inputs(device, n, d, depth, seed, unit_metric)
    else:
        q, im, *rnd = card_inputs(device, n, d, depth, seed, unit_metric)
    e = torch.tensor(eps, device=device)
    kern = nuts_cuda.nuts_transition(q, *rnd, e, im, model, depth)
    plain = nuts_cuda.transition_math_torch(
        q, *rnd, e, im, nuts_cuda.plain_logp_grad(model), depth)
    for t in kern:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("K1 returned non-finite values")
    res = compare(plain, kern)
    res["depth_histogram"] = torch.bincount(
        plain[4].long(), minlength=depth + 1).tolist()
    res["divergent_chains"] = int(plain[5].sum())
    if plain_spread:
        other = nuts_cuda.transition_math_torch(
            q, *rnd, e, im,
            nuts_cuda.autograd_logp_grad(flow, target.log_density), depth)
        res["plain_vs_plain"] = compare(plain, other)
    return res


# (d, h1, h2, max_depth, eps, chains, mask): the bench shape with the
# bench's leading mask, then one shape for every other instantiation of K1
# (d / 32 = 1, 3, ..., 8), hidden widths 32..256, depths up to the
# kernel's 10, random 0/1 masks
OTHER_SHAPES = [(64, 128, 128, 6, 0.3, 1024, "leading"),
                (32, 32, 64, 3, 0.3, 256, "random"),
                (96, 64, 32, 5, 0.2, 256, "random"),
                (128, 256, 128, 4, 0.2, 256, "random"),
                (160, 96, 160, 8, 0.05, 128, "random"),
                (192, 160, 224, 7, 0.05, 128, "random"),
                (224, 32, 32, 10, 0.02, 64, "random"),
                (256, 128, 256, 2, 0.1, 256, "random")]


def shape_flow(device, d, h1, h2, scheme):
    """The random affine flow of an OTHER_SHAPES row."""
    import torch
    from tpuflows_torch.util.shapes import leading_mask

    g = torch.Generator().manual_seed(d)
    mask = (leading_mask(d) if scheme == "leading" else
            tuple(torch.randint(0, 2, (d,), generator=g).tolist()))
    return random_flow(device, d + h1, d, (h1, h2), mask)


def kernel_shapes(device, shapes=OTHER_SHAPES):
    """K1 against its plain version with every flow leaf and the metric
    random, at the bench shape and away from it."""
    rows = []
    for d, h1, h2, depth, eps, n, scheme in shapes:
        flow = shape_flow(device, d, h1, h2, scheme)
        res = kernel_vs_plain(device, flow, n, depth, eps, seed=d + h2,
                              unit_metric=False)
        rows.append({"d": d, "h1": h1, "h2": h2, "max_depth": depth,
                     "eps": eps, "mask": scheme, **res})
    return rows


# (d, hidden, knots, blocks, max_depth, eps, chains, unit metric, head):
# the setting of the bar at the bench widths, two other instantiations of
# the module-list kernel (at d = 256 with K = 16 the warp's scratch is 54
# KB, above the 48 KB a launch gets without opting in), and the
# informative row with large random heads
SPLINE_SHAPES = [(64, HIDDEN, KNOTS, GENERIC_BLOCKS, 6, 0.3, 1024, True,
                  SPLINE_HEAD),
                 (32, (32, 64), 4, 2, 5, 0.2, 256, False, SPLINE_HEAD),
                 (256, (64, 128), 16, 1, 4, 0.1, 128, False, SPLINE_HEAD)]
SPLINE_CHAOS_SHAPE = (64, HIDDEN, KNOTS, GENERIC_BLOCKS, 6, 0.3, 1024, True,
                      SPLINE_CHAOS)


def kernel_vs_plain_spline(device, shapes=SPLINE_SHAPES,
                           chaos=SPLINE_CHAOS_SHAPE):
    """K1's module-list kernel against its plain version on arqs flows;
    the `chaos` row also reports the spread of two plain versions."""
    rows = []
    for i, (d, hidden, K, nb, depth, eps, n, unit, head) in enumerate(
            [*shapes, *([chaos] if chaos else [])]):
        flow = spline_flow_with_random_heads(device, 10 + d, dim=d,
                                             hidden=hidden, knots=K,
                                             n_blocks=nb, head=head)
        res = kernel_vs_plain(device, flow, n, depth, eps, seed=20 + d,
                              unit_metric=unit, plain_spread=True,
                              cpu_inputs=True)
        rows.append({"d": d, "hidden": list(hidden), "knots": K,
                     "blocks": nb, "max_depth": depth, "eps": eps,
                     "head_scale": head, "gated": i < len(shapes), **res})
    return rows


# ---------------------------------------------------------------------------
# K1, K2 and K3 over every kind of the target library (csrc/targets.cuh)
# ---------------------------------------------------------------------------
# (kind, d): every kind the kernels take, at the width a config gives it
# (c6's banana, c2's correlated Gaussian, c3's mixture, c5's hierarchical
# model; c4's 64 for the funnel and the kinds no config sizes)
TARGET_ROWS = (("banana", 2), ("correlated", 8), ("mixture", 16),
               ("funnel", 64), ("std_normal", 64), ("diag_normal", 64),
               ("rosenbrock", 64), ("cauchy", 64), ("hierarchical", 256))
TARGET_FLOWS = ("affine", "rqs")
TARGET_HIDDEN = (64, 64)
TARGET_DEPTH = 4
TARGET_WINDOW = 8
# the slots of each window held against float64 (every slot is held to
# chained K1 launches to the bit)
TARGET_CHECKED_SLOTS = 1
# step sizes: a fraction of each target's narrowest scale near its draws
TARGET_EPS = {"banana": 0.15, "correlated": 0.15, "mixture": 0.3,
              "funnel": 0.1, "std_normal": 0.3, "diag_normal": 0.3,
              "rosenbrock": 0.01, "cauchy": 0.05, "hierarchical": 0.05}
# the rows whose tile kernels are held to the per-warp ones (a non-funnel
# kind at d = 8 and one at d = 256) and whose K1 is timed for PERF.md, each
# under the flow of the runner's variant that runs K1 there
# (`config_flow`): c2's 4 rqs blocks (64 x 64, K = 8) and c5's 2
# leading-mask affine couplings (128 x 128, the ring: more than one
# coupling), so that the check, the time and the bound are of the K1 mode
# whose launches the variant counts
TARGET_TILE_ROWS = {("correlated", "rqs"): "c2_correlated_rqs_nuts",
                    ("hierarchical", "affine"): "c5_hierarchical_affine_nuts"}
# the affine couplings' last layers in `config_flow`: random_flow's scale
CONFIG_AFFINE_HEAD = 0.3
# the central share of the Cauchy's draws the phase starts from: past it
# float32 cannot evaluate the flow and the target to K1's bar (at |x| ~
# 1e4 an affine shift cancels z, a spline's conditioner sees inputs of
# 1e4: the float32 plain versions' energies missed float64's by up to 63)
CAUCHY_START_MASS = 0.998


def smoke_target(kind, d, device):
    """The port's target of `kind` at width d as the runner builds it
    (`TargetSpec.build`: c2's AR(1) Gaussian, the bimodal mixture, c5's
    hierarchical data, ...), or a MultimodalCauchy, which no config
    names."""
    from tpuflows_torch.config import TargetSpec
    from tpuflows_torch.targets import MultimodalCauchy

    if kind == "cauchy":
        return MultimodalCauchy(d)
    return TargetSpec(kind=kind, dim=d).build(device=device)


def target_flow(device, flow_kind, d, seed):
    """The phase's flows at width d: Standardize + one leading-mask affine
    coupling (every leaf random, `random_flow`), or Standardize + 2 RQS
    blocks on alternating masks, K = 8 (random heads,
    `spline_flow_with_random_heads`); MLPs TARGET_HIDDEN."""
    from tpuflows_torch.util.shapes import leading_mask

    if flow_kind == "affine":
        return random_flow(device, seed, d, TARGET_HIDDEN,
                           leading_mask(d, 2 if d > 2 else 1))
    return spline_flow_with_random_heads(
        device, seed, dim=d, hidden=TARGET_HIDDEN, knots=KNOTS, n_blocks=2,
        kind="rqs", mask_scheme="alternating")


def config_flow(device, name, seed):
    """The flow of the runner's config `name` (`run_config_dict`'s flow
    section) as `build_flow` builds it, every conditioner's last layer
    random (`spline_flow_with_random_heads`; CONFIG_AFFINE_HEAD for affine
    couplings, SPLINE_HEAD for splines)."""
    from tpuflows_torch.config import FlowSpec

    cfg = run_config_dict(name)
    spec = FlowSpec(**{**cfg["flow"], "hidden": tuple(cfg["flow"]["hidden"])})
    return spline_flow_with_random_heads(
        device, seed, dim=cfg["target"]["dim"], hidden=spec.hidden,
        knots=spec.knots, n_blocks=spec.n_blocks,
        head=CONFIG_AFFINE_HEAD if spec.kind == "affine" else SPLINE_HEAD,
        kind=spec.kind, mask_scheme=spec.mask_scheme,
        n_leading=spec.n_leading, clamp=spec.clamp)


def target_start(target, flow, kind, n, seed, device):
    """Start points in the flow's latent space: the flow's image of the
    target's exact draws (the Cauchy's from its central CAUCHY_START_MASS),
    or N(0, 1) for the funnel (as K1's funnel rows start)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "funnel":
        return torch.randn((n, target.dim), generator=g, device=device)
    if kind == "cauchy":
        u = torch.rand((n, target.dim), generator=g, device=device)
        u = 0.5 * (1.0 - CAUCHY_START_MASS) + CAUCHY_START_MASS * u
        heads = torch.rand((n, 2), generator=g, device=device) < 0.5
        x = target.sample_math(torch.tan(math.pi * (u - 0.5)), heads)
    else:
        x = target.sample(g, n, device=device)
    with torch.no_grad():
        q, _ = flow.forward_and_ladj(x)
    return q.contiguous()


def target_flops(model):
    """Operations of one gradient of the target itself per row
    (csrc/targets.cuh), beside `mlp_flops`: the correlated Gaussian's
    precision matvec (2 d^2), the mixture's three passes over K
    components, a few per dim for the rest."""
    pt = model.packed_target
    d = pt.dim
    if pt.kind == 2:
        return 2 * d * d + 6 * d
    if pt.kind == 3:
        K = (pt.params.numel() - 1) // (1 + 2 * pt.d_pad)
        return 3 * K * 6 * d + 2 * d
    return {0: 3, 1: 6, 4: 4, 5: 10, 6: 4, 7: 10, 8: 16}[pt.kind] * d


def k1_bound(model, q, n_steps, depth):
    """(bound ms, 'operations' or 'bytes', flops, bytes) of one K1 launch
    whose chains took `n_steps` leapfrogs: one gradient at q and one per
    leapfrog, each `mlp_flops` + `target_flops`, against every input read
    once (q, the randomness, the metric, the packed flow and target) and
    q' and info written once."""
    n, d = q.shape
    flops = (float(n_steps.sum()) + n) * (mlp_flops(model)
                                          + target_flops(model))
    n_in = (2 * n * d + 2 * n * depth + n * (1 << depth) + 1 + d
            + model.params.numel() + model.packed_target.params.numel())
    nbytes = 4.0 * (n_in + n * d + 7 * n)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def hidden_perms(widths, seed, device):
    """A random permutation of each hidden layer's units (widths[1:-1])
    of a conditioner of layer widths `widths`, drawn from `seed`."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return [torch.randperm(w, generator=g).to(device) for w in widths[1:-1]]


def permuted_params(params, perms):
    """Flat conditioner parameters (w0, b0, w1, b1, ...) with each hidden
    layer's units reordered by `perms` (`hidden_perms`): the same function,
    whose products a float32 evaluation sums in another order (the
    witness of `permuted_flow`, `unpermute_cotangents` undoes it)."""
    ps = list(params)
    for l, p in enumerate(perms):
        ps[2 * l] = ps[2 * l][:, p].contiguous()
        ps[2 * l + 1] = ps[2 * l + 1][..., p].contiguous()
        ps[2 * l + 2] = ps[2 * l + 2][p, :].contiguous()
    return tuple(ps)


def unpermute_cotangents(dps, perms):
    """The cotangents of `permuted_params(params, perms)` as cotangents of
    `params`."""
    import torch

    ps = list(dps)
    for l, p in enumerate(perms):
        for i, dim in ((2 * l, -1), (2 * l + 1, -1), (2 * l + 2, 0)):
            out = torch.empty_like(ps[i])
            out.index_copy_(dim % ps[i].dim(), p, ps[i])
            ps[i] = out
    return tuple(ps)


def permuted_flow(flow, seed):
    """A copy of `flow` whose conditioners' hidden units are reordered
    (`permuted_params`): the same function, another float32 evaluation of
    it. It is the second float32 witness of a row whose kernel lies far
    from float64 where the plain version does not: the plain version and
    `oracle_block` take their conditioner from the same matmuls and share
    its rounding, the kernels and this copy do not."""
    import copy

    import torch

    out = copy.deepcopy(flow)
    for i, t in enumerate(out.transforms):
        net = getattr(t, "net", None)
        if net is None:
            continue
        ws, bs = net.weights, net.biases
        widths = [ws[0].shape[0], *(w.shape[1] for w in ws)]
        perms = hidden_perms(widths, seed + i, ws[0].device)
        flat = [x for w, b in zip(ws, bs) for x in (w.data, b.data)]
        new = permuted_params(flat, perms)
        with torch.no_grad():
            for j, x in enumerate(flat):
                x.copy_(new[j])
    return out


def kernel_order_flow(flow_p):
    """A copy of a p-major flow (`PackedFlow.flow_p`) whose conditioners
    sum every product in the tile gradient's order (csrc/tile_grad.cuh,
    `tile_matvec`): from the bias (or 0), one multiply-add an input,
    inputs ascending, in each layer's product and in its pullback (one
    torch.addcmul a step; the pullback skips the columns whose cotangent
    is 0 in every row). The function is the plain version's, its rounding
    the kernel's order of sums: a witness of how far that order alone
    takes a float32 evaluation from float64, in plain PyTorch. One launch
    an input: ~9.5 s a K = 96 transition of 1024 chains on the card."""
    import copy

    import torch
    from tpuflows_torch.flows.core import Chain
    from tpuflows_torch.flows.coupling import RQSCouplingBlock
    from tpuflows_torch.flows.nets import _ACTIVATIONS

    class Ordered(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b):
            ctx.save_for_backward(w)
            acc = b.expand(x.shape[0], -1).clone()
            for r in range(x.shape[1]):
                acc = torch.addcmul(acc, x[:, r:r + 1], w[r:r + 1])
            return acc

        @staticmethod
        def backward(ctx, g):
            (w,) = ctx.saved_tensors
            cols = torch.nonzero(g.abs().amax(0) > 0).flatten().tolist()
            acc = torch.zeros(g.shape[0], w.shape[0], dtype=g.dtype,
                              device=g.device)
            wt = w.t().contiguous()
            for c in cols:
                acc = torch.addcmul(acc, g[:, c:c + 1], wt[c:c + 1])
            return acc, None, None

    class OrderedMLP(torch.nn.Module):
        def __init__(self, mlp):
            super().__init__()
            self.mlp = mlp

        def forward(self, x):
            act = _ACTIVATIONS[self.mlp.activation]
            ws, bs = list(self.mlp.weights), list(self.mlp.biases)
            for i, (w, b) in enumerate(zip(ws, bs)):
                x = Ordered.apply(x, w, b)
                if i + 1 < len(ws):
                    x = act(x)
            return x

    out = []
    for t in flow_p.transforms:
        if isinstance(t, RQSCouplingBlock):
            t = copy.deepcopy(t)
            t.net = OrderedMLP(t.net)
        out.append(t)
    return Chain(out)


def f64_model(flow, target):
    """The packed flow over a float64 copy of `flow`: its plain version
    (`nuts_cuda.plain_logp_grad`, the target read from the float32 buffer
    in float64) is the float64 referee of the float32 evaluations."""
    import copy

    from tpuflows_torch.kernels import nuts_cuda

    model = nuts_cuda.pack_flow(copy.deepcopy(flow).double(), target)
    if model.flow_p is not None:  # its relayout is built in float32
        model = model._replace(flow_p=model.flow_p.double())
    return model


def knife_edge(ref, other, edge=None):
    """The chains (per slot of a window) on which `other` takes another
    tree decision than `ref` (leapfrog count, depth, divergence or
    U-turn) or ends more than 1e-3 away: `compare`'s flips; and those
    `edge(ref, other)` marks (`bf16_edge_chains`), where given."""
    flip = (ref[0] - other[0]).abs().amax(dim=-1) > 1e-3
    for i in (3, 4, 5, 6):
        flip |= ref[i] != other[i]
    if edge is not None:
        flip |= edge(ref, other)
    return flip


def bf16_edge_chains(exact, other):
    """The chains whose start energy `other` takes past K1's energy bar
    (MAX_DENERGY) from the float64 `exact`: under a bf16 conditioner, a
    chain with an operand on a bf16 rounding edge, which float32 rounds
    to one bf16 value and float64 to its neighbour (PERF.md: 0.51 in the
    energy of one chain of 1024 on the card, both float32 evaluations
    alike, 0.011 apart)."""
    return (exact[7] - other[7]).abs() > MAX_DENERGY


def refereed_diff(exact, other, knife, edge=None):
    """`other` (K1's or K2's outputs) against the float64 plain version
    `exact`: its flips against it (the most in a slot) and its largest q
    and energy differences on the chains outside `knife`, the knife-edge
    chains of every float32 evaluation compared (a chain that one float32
    evaluation sends down another tree is held by the flip count, not by
    its q)."""
    n = knife.shape[-1]
    ok = ~knife

    def worst(x):
        return float(x[ok].max()) if bool(ok.any()) else 0.0

    return {"flips": int(knife_edge(exact, other, edge).reshape(-1, n)
                         .sum(1).max()),
            "knife_edge": int(knife.sum()),
            "max_dq": worst((exact[0] - other[0]).abs().amax(dim=-1)),
            "max_denergy": worst((exact[7] - other[7]).abs())}


# the most refereed_bar widens K1's bar to: flips a share of the chains,
# the energy and q a factor of K1's bar
REFEREED_FLIP_SHARE = 1 / 64
REFEREED_WIDEN = 10.0


def refereed_bar(spreads, n):
    """K1's bar, or twice float32's own distance from float64 where that
    is larger, for the flips, the energy and q, but at most n
    REFEREED_FLIP_SHARE flips and REFEREED_WIDEN times K1's bar in energy
    and q: `spreads` are the `refereed_diff`s of the float32 plain
    versions of one flow and target (K1's plain transition, K2's plain
    window). The kernel's distance from float64 must stay within it: as
    accurate as its float32 plain versions, to a factor of 2 (the rule of
    K1's bar at the generic state, refereed by float64), and never far
    from K1's bar, however badly float32 does."""
    def twice(key):
        return 2.0 * max(r[key] for r in spreads)

    flips = max(1, n * MAX_FLIPS // 1024)
    return {"max_flips": max(flips, min(int(twice("flips")),
                                        int(n * REFEREED_FLIP_SHARE))),
            "max_denergy": max(MAX_DENERGY, min(
                twice("max_denergy"), REFEREED_WIDEN * MAX_DENERGY)),
            "max_dq": max(MAX_DQ, min(twice("max_dq"),
                                      REFEREED_WIDEN * MAX_DQ))}


def refereed(res, bar):
    """Whether a `refereed_diff` lies within `refereed_bar`."""
    return bool(res["flips"] <= bar["max_flips"]
                and not res["max_denergy"] > bar["max_denergy"]
                and not res["max_dq"] > bar["max_dq"])


def refereed_row(device, label, kind, target, flow, n, depth, window,
                 checked_slots, seed, eps, start=None, witnesses=0,
                 warp_witness=False, order_witness=False, gate="f64"):
    """One row of `targets_vs_plain` (and of `conditioners_vs_plain` and
    `reach_vs_plain`): K1, K2 and K3 under `flow` over `target` (of kind
    `kind`) on n chains started from `start`, or from `target_start(...,
    seed)`, held as `targets_vs_plain` says; with `checked_slots` 0, K2 by
    `bitwise_k1` alone (each slot equal to a K1 launch, itself held to
    float64). `witnesses` more float32 plain versions of K1 run under
    `permuted_flow` copies of the flow: their distances from float64
    (`witnesses` in the row's k1) count in the bar beside the plain
    version's, as the float32 evaluations whose conditioner rounds apart
    from the plain version's, as the kernel's does. `warp_witness` (the
    card) runs the per-warp K1 on the same inputs too and reports its
    distance from float64 and from the tile kernel (`warp`; no bar);
    `order_witness` the plain version under `kernel_order_flow`, its
    distance from float64 (`kernel_order`; no bar). With
    `gate` "vs_plain" K1 and K2 are held to their float32 plain versions
    by K1's bar (`compare`, `compare_window`) and the float64 referee is
    reported beside them: for a row where float32 itself takes other tree
    decisions than float64 on more chains than `refereed_bar` allows.
    Returns (row, (q, inv_mass, K1's randomness, K2's, eps, the packed
    flow)); the row's k1 has the float32 plain version's time
    (`plain_ms`)."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.kernels import nuts_window_cuda as nw
    from tpuflows_torch.kernels.tile_flow import tile_logp_and_grad_streamed

    d = target.dim
    model = nuts_cuda.pack_flow(flow, target)
    model64 = f64_model(flow, target)
    q = (target_start(target, flow, kind, n, seed, device) if start is None
         else start)
    g = torch.Generator(device=device).manual_seed(seed)
    im = 0.5 + torch.rand(d, generator=g, device=device)
    rnd = nuts_cuda.draw_randomness(g, n, d, depth, im)
    e = torch.tensor(eps, device=device)

    def plain(z, *r, f64=False):  # K1's plain version
        if f64:
            return nuts_cuda.transition_math_torch(
                z.double(), *(t.double() for t in r), e.double(),
                im.double(), nuts_cuda.plain_logp_grad(model64),
                depth)
        return nuts_cuda.transition_math_torch(
            z, *r, e, im, nuts_cuda.plain_logp_grad(model), depth)

    # a bf16 conditioner's rounding edges: a chain whose start energy a
    # float32 evaluation takes past K1's energy bar from float64's is on
    # one (an operand that rounds to one bf16 value in float32 and to its
    # neighbour in float64); it counts as a knife-edge chain
    bf16 = bool((model.forms[:, 2] & nuts_cuda.FORM_BF16).any())
    edge = bf16_edge_chains if bf16 else None
    t_row = time.perf_counter()
    kern = nuts_cuda.nuts_transition(q, *rnd, e, im, model, depth)
    for t in kern:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"K1 returned non-finite values "
                               f"({label})")
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    t_plain = time.perf_counter()
    plain32 = plain(q, *rnd)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t_plain)
    exact = plain(q, *rnd, f64=True)
    wits = [nuts_cuda.transition_math_torch(
        q, *rnd, e, im, nuts_cuda.plain_logp_grad(nuts_cuda.pack_flow(
            permuted_flow(flow, seed + 100 * (i + 1)), target)), depth)
        for i in range(witnesses)]
    knife = (knife_edge(exact, kern, edge)
             | knife_edge(exact, plain32, edge))
    if order_witness:
        pt = model.packed_target
        ordered = kernel_order_flow(model.flow_p)
        order = nuts_cuda.transition_math_torch(
            q, *rnd, e, im, lambda z: tile_logp_and_grad_streamed(
                ordered, z,
                lambda x: nuts_cuda.packed_log_density(pt, x)), depth)
        knife |= knife_edge(exact, order, edge)
    for w in wits:
        knife |= knife_edge(exact, w, edge)
    k1 = refereed_diff(exact, kern, knife, edge)
    if wits:
        k1["witnesses"] = [refereed_diff(exact, w, knife, edge)
                           for w in wits]
    if order_witness:
        k1["kernel_order"] = refereed_diff(exact, order, knife, edge)
    if warp_witness:
        warp = nuts_cuda.chain_transition_warp(q, *rnd, e, im, model,
                                               depth)
        k1["warp"] = {**refereed_diff(exact, warp, knife, edge),
                      "vs_tile": compare(warp, kern),
                      "equal_to_tile": all(torch.equal(a, b)
                                           for a, b in zip(warp, kern))}
    k1.update(f64_spread=refereed_diff(exact, plain32, knife, edge),
              vs_plain=compare(plain32, kern),
              depth_histogram=torch.bincount(
                  plain32[4].long(), minlength=depth + 1).tolist(),
              divergent_chains=int(plain32[5].sum()),
              plain_ms=plain_ms, seconds=time.perf_counter() - t_row)
    # K2: the window, then each slot from K2's own previous draw
    wrnd = window_randomness(device, n, d, window, depth, im,
                             seed + 1)
    win = nw.nuts_window(q, *wrnd, e, im, model, depth, window)
    for t in win:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"K2 returned non-finite values "
                               f"({label})")
    chained = nw.chain_slots(
        lambda z, *r: nuts_cuda.nuts_transition(z, *r, e, im, model,
                                                depth),
        q, *wrnd, window, depth, starts=win[0])
    bits = {k: value_diff(a, b)
            for k, a, b in zip(K2_OUTS, win, chained)}
    S = min(window, checked_slots)
    head = [t[:S] for t in win]
    k2 = {"window": window, "checked_slots": S,
          "bitwise_k1": sum(v[0] + v[1] for v in bits.values()),
          "bitwise_k1_by_output": {k: v[0] + v[1]
                                   for k, v in bits.items()}}

    def slots(step):
        return nw.chain_slots(step, q, *wrnd, S, depth,
                              starts=head[0])

    def one_slot(z, *r):  # K2's plain version, one slot a call
        w = nw.window_math_torch(z, *r, e, im,
                                 nuts_cuda.plain_logp_grad(model),
                                 1, depth)
        w = [x[0] for x in w]
        w[2] = w[2] * torch.clamp(w[3], min=1.0)
        return w

    t_k2 = time.perf_counter()
    spreads = [k1["f64_spread"], *k1.get("witnesses", [])]
    if S:  # slots held against float64; else K2 is held by K1's bits
        w_plain = slots(one_slot)
        w_exact = slots(lambda z, *r: plain(z, *r, f64=True))
        w_knife = (knife_edge(w_exact, head, edge)
                   | knife_edge(w_exact, w_plain, edge))
        k2.update(refereed_diff(w_exact, head, w_knife, edge),
                  f64_spread=refereed_diff(w_exact, w_plain, w_knife,
                                           edge),
                  # K1's bar where the row is held to the plain versions
                  vs_plain=compare_window(
                      w_plain, head, *(() if gate == "vs_plain"
                                       else (math.inf,) * 3)))
        spreads.append(k2["f64_spread"])
    # one bar for the row: float32's own distance from float64 in
    # both plain versions
    bar = refereed_bar(spreads, n)
    k1["bar"] = k2["bar"] = bar
    k1["gate"] = k2["gate"] = gate
    if gate == "vs_plain":
        k1["passed"] = k1["vs_plain"]["passed"]
        held = not S or k2["vs_plain"]["passed"]
    else:
        k1["passed"] = refereed(k1, bar)
        held = not S or refereed(k2, bar)
    # on the CPU both sides are plain versions, and the plain
    # window rounds apart from chained plain transitions
    k2["passed"] = bool(held and (k2["bitwise_k1"] == 0 or device == "cpu"))
    k2["seconds"] = time.perf_counter() - t_k2
    t_k3 = time.perf_counter()
    k3 = fused_logp_vs_plain(device, [(label, flow, n, q, target)],
                             by_row=edge is not None)[0]
    k3["seconds"] = time.perf_counter() - t_k3
    row = {"kind": kind, "d": d, "d_pad": model.d_pad,
           "hidden": list(model.hidden), "eps": float(e),
           "bf16_edges": edge is not None, "k1": k1,
           "k2": k2,
           "k3": {k: k3[k] for k in ("lp", "g", "passed",
                                     "seconds")}}
    row["passed"] = k1["passed"] and k2["passed"] and k3["passed"]
    return row, (q, im, rnd, wrnd, e, model)


def targets_vs_plain(device, rows=TARGET_ROWS, flows=TARGET_FLOWS,
                     n=N_CHAINS, depth=TARGET_DEPTH, window=TARGET_WINDOW,
                     checked_slots=TARGET_CHECKED_SLOTS,
                     tile_rows=TARGET_TILE_ROWS, n_reps=20):
    """Phase targets_vs_plain: for every (kind, d) of `rows` under each
    flow of `flows`, on n chains started from the flow's image of the
    target's exact draws (`target_start`):
      * K1 against its plain version run in float64 on the same inputs
        (`refereed_diff`), under `refereed_bar`: K1's bar, or twice the
        float32 plain versions' distance from float64 where that is
        larger, within a cap; the distance from the float32 plain
        version is printed (`vs_plain`);
      * K2 over a window of `window` slots: every slot equal to the bit to
        one K1 launch from K2's own previous draw (`bitwise_k1` 0, on the
        card), and its first `checked_slots` slots against the plain
        transition in float64 from the same draws, under the same bar,
        which also takes K2's float32 plain version (`window_math_torch`,
        one slot per call) into float32's distance from float64; the
        distance from that plain version is printed (`vs_plain`);
      * K3 against its plain version (`fused_logp_vs_plain`, the spline
        kernels' `judge`, float64-refereed).
    The (kind, flow) pairs of `tile_rows` run under the flow of the
    config it maps them to (`config_flow`), and there also K1's, K2's and
    K3's tile kernels against the per-warp ones in every mode
    (`tile_vs_warp`'s rule), and K1 timed against its plain version with
    its bound (`k1_bound`). Returns (rows, tile rows, timings)."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.kernels import nuts_window_cuda as nw

    out, tiles, timings = [], [], []
    for i, (kind, d) in enumerate(rows):
        target = smoke_target(kind, d, device)
        for j, flow_kind in enumerate(flows):
            seed = 7000 + 10 * i + j
            config = tile_rows.get((kind, flow_kind))
            label = f"{kind} d={d} {flow_kind}"
            if config is None:
                flow = target_flow(device, flow_kind, d, seed)
            else:
                label += f", {config}'s flow"
                flow = config_flow(device, config, seed)
            row, ctx = refereed_row(device, label, kind, target, flow, n,
                                    depth, window, checked_slots, seed,
                                    TARGET_EPS[kind])
            row.update(flow=flow_kind, flow_config=config)
            out.append(row)
            if config is None:
                continue
            row_tiles, timing = tiles_and_timing(label, flow, target, ctx,
                                                 depth, window, n_reps)
            tiles += row_tiles
            timing.update(kind=kind, flow=flow_kind, config=config,
                          max_abs_err=row["k1"]["max_dq"])
            timings.append(timing)
    return out, tiles, timings


def tiles_and_timing(label, flow, target, ctx, depth, window, n_reps,
                     candidates=None):
    """On a `refereed_row`'s inputs (`ctx`): K1's, K3's and K2's tile
    kernels against the per-warp ones in every mode of `tile_modes` over
    `candidates` (TILE_ROWS unless given; `tile_vs_warp`'s rule), and K1
    timed against its plain version with its bound (`k1_bound`). Returns
    (tile rows, timing)."""
    from tpuflows_torch.kernels import nuts_cuda

    q, im, rnd, wrnd, e, model = ctx
    candidates = candidates or TILE_ROWS
    tiles = []
    for name, res in (
            ("K1", k1_tile_vs_warp(flow, q, im, rnd, e, depth, target,
                                   candidates)),
            ("K3", k3_tile_vs_warp(flow, q, target, candidates)),
            ("K2", k2_tile_vs_warp(flow, q, im, wrnd, e, depth, window,
                                   target, candidates))):
        res = {"kernel": name, "label": label, **res}
        res["passed"] = bool(res["rows"]) and all(
            x["differ"] == 0 for x in res["rows"].values())
        tiles.append(res)
    rows = nuts_cuda.tile_rows(model)
    timing = k1_timing(label, q, im, rnd, e, model, depth, n_reps)
    timing.update(rows=rows,
                  resident=nuts_cuda.launch_resident(model, rows) > 0)
    return tiles, timing


# conditioners_vs_plain: the conditioners and modules the JAX package's
# in-kernel flow math takes beyond the main paths' 3-layer float32 silu
# MLPs, at the main paths' width (the 64-d funnel, 1024 chains): a
# leading-mask affine coupling 64 -> 128 -> 128 -> 128 with each other
# activation, with bf16 operands, at 2 and 4 layers; Whiten (fitted from
# the target's draws) before that coupling and before a 2-block rqs flow
# (64 x 64, K = 8); a 2-block rqs flow of 4-layer gelu conditioners; and
# c1's own flow (one affine coupling of a 2-layer conditioner, hidden 32)
# over c1's target, the flow of the runner's variant
# `c1_std_normal_affine_nuts` ("auto" must take K1 for it). (label, flow
# kind, `conditioner_flow` options and a step size where the row's is
# not TARGET_EPS's: the Whiten rows' latent space is the funnel's draws'
# scale, where TARGET_EPS's 0.1 diverges half the chains); the c1 row's
# flow is `config_flow`'s
CONDITIONER_DIM = 64
CONDITIONER_HIDDEN = {"affine": (128, 128), "rqs": (64, 64)}
CONDITIONER_ROWS = (
    ("affine tanh", "affine", {"activation": "tanh"}),
    ("affine relu", "affine", {"activation": "relu"}),
    ("affine gelu", "affine", {"activation": "gelu"}),
    ("affine bf16 silu", "affine", {"compute_dtype": "bf16"}),
    ("affine bf16 gelu", "affine", {"activation": "gelu",
                                    "compute_dtype": "bf16"}),
    ("affine 2 layers", "affine", {"hidden": (128,)}),
    ("affine 4 layers", "affine", {"hidden": (128, 128, 128)}),
    ("Whiten + affine", "affine", {"whiten": True, "eps": 0.02}),
    ("Whiten + rqs", "rqs", {"whiten": True, "eps": 0.02}),
    ("rqs gelu 4 layers", "rqs", {"activation": "gelu",
                                  "hidden": (64, 64, 64)}),
    ("c1_std_normal_affine_nuts's flow", "config", {}))
CONDITIONER_VARIANT = "c1_std_normal_affine_nuts"
# the phase's depth: K2's window and the tile rows held to the per-warp
# kernels (the wrappers' default R, and 8), K1's timing repetitions
CONDITIONER_WINDOW = 4
CONDITIONER_TILE_ROWS = (8,)
CONDITIONER_REPS = 10
# draws the Whiten modules are fitted from
WHITEN_DRAWS = 4096


def conditioner_flow(device, flow_kind, seed, target, activation="silu",
                     compute_dtype="f32", hidden=None, whiten=False):
    """A flow of `conditioners_vs_plain` at CONDITIONER_DIM: Standardize +
    one leading-mask affine coupling with every leaf random
    (`random_flow`), or Standardize + 2 rqs blocks on alternating masks, K
    = 8, random heads (`spline_flow_with_random_heads`), of `activation`,
    `compute_dtype` and `hidden` (CONDITIONER_HIDDEN by default); with
    `whiten`, a Whiten fitted from WHITEN_DRAWS of the target's draws in
    the Standardize's place."""
    import torch
    from tpuflows_torch.flows import Chain, Whiten
    from tpuflows_torch.util.shapes import leading_mask

    d = CONDITIONER_DIM
    hidden = hidden or CONDITIONER_HIDDEN[flow_kind]
    if flow_kind == "affine":
        flow = random_flow(device, seed, d, hidden, leading_mask(d),
                           activation=activation,
                           compute_dtype=compute_dtype)
    else:
        flow = spline_flow_with_random_heads(
            device, seed, dim=d, hidden=hidden, knots=KNOTS, n_blocks=2,
            kind="rqs", mask_scheme="alternating", activation=activation)
    if whiten:
        g = torch.Generator(device=device).manual_seed(seed + 1)
        w = Whiten.from_samples(target.sample(g, WHITEN_DRAWS,
                                              device=device))
        flow = Chain([w, *flow.transforms[1:]])
    return flow


def conditioners_vs_plain(device, rows=CONDITIONER_ROWS, n=N_CHAINS,
                          depth=TARGET_DEPTH, window=CONDITIONER_WINDOW,
                          checked_slots=TARGET_CHECKED_SLOTS,
                          candidates=CONDITIONER_TILE_ROWS,
                          n_reps=CONDITIONER_REPS, ptxas=None,
                          tile_checks=True):
    """Phase conditioners_vs_plain: each flow of `rows` over the 64-d
    funnel (c1's row over c1's target) on n chains started from the flow's
    image of the target's exact draws, held as `targets_vs_plain` holds
    its rows (`refereed_row`: K1 against float64 under `refereed_bar`, K2
    equal to chained K1 to the bit and its first slots against float64,
    K3 by `judge`), its tile kernels against the per-warp ones at the
    default R and at `candidates` (`tiles_and_timing`), and K1 timed with
    its bound, its tile rows and the ptxas registers and spills of the
    kernels it ran (the per-warp kernels and the timing need the card:
    `tile_checks` False leaves them out, for a CPU rehearsal). Returns
    (rows, tile rows, timings)."""
    from tpuflows_torch.kernels import nuts_cuda

    ptxas = ptxas or {}
    out, tiles, timings = [], [], []
    for i, (label, flow_kind, opts) in enumerate(rows):
        seed = 9000 + 10 * i
        if flow_kind == "config":
            cfg = run_config_dict(CONDITIONER_VARIANT)
            kind, d = cfg["target"]["kind"], cfg["target"]["dim"]
            target = smoke_target(kind, d, device)
            flow = config_flow(device, CONDITIONER_VARIANT, seed)
        else:
            kind, d = "funnel", CONDITIONER_DIM
            target = smoke_target(kind, d, device)
            flow = conditioner_flow(device, flow_kind, seed, target,
                                    **{k: v for k, v in opts.items()
                                       if k != "eps"})
        start = target_start(target, flow, "draws", n, seed, device)
        row, ctx = refereed_row(device, label, kind, target, flow, n, depth,
                                window, checked_slots, seed,
                                opts.get("eps", TARGET_EPS[kind]),
                                start=start)
        model = ctx[-1]
        row.update(flow=flow_kind, options={k: list(v) if isinstance(
            v, tuple) else v for k, v in opts.items()},
            layers=model.forms[:, 0].tolist(), general=bool(model.general))
        out.append(row)
        if not tile_checks:
            continue
        row_tiles, timing = tiles_and_timing(label, flow, target, ctx, depth,
                                             window, n_reps, candidates)
        tiles += row_tiles
        dpl = model.d_pad // 32
        res = " resident" if timing["resident"] else ""
        timing.update(kind=kind, flow=flow_kind,
                      max_abs_err=row["k1"]["max_dq"],
                      smem_bytes_row=nuts_cuda.smem_bytes(model),
                      ptxas={k: ptxas.get(f"{k} d/32={dpl}{res}")
                             for k in ("chain tile", "K2 tile",
                                       "K3 tile")})
        timings.append(timing)
    return out, tiles, timings


# reach_vs_plain: the reach the kernels gained past the register units of
# the tile kernels (d <= 256, max_depth <= 10, hidden widths multiples of
# 32 up to 256), each row held as `conditioners_vs_plain` holds its rows:
# hidden widths that are not multiples of 32 ([48, 48], [100], padded with
# zero units) and past 256 ([512, 512]) on the tile kernels; max_depth 12
# on the wide units at the runner variant's own shape (c1's std_normal, d
# = 2 on 32 lanes, its one affine coupling at hidden [48], 256 chains)
# and with a step small enough that trees pass depth 10; d = 514 and 288
# on the wide units. (label, target kind, d, flow kind, hidden, depth,
# chains, step size or None for TARGET_EPS's, deep); "ceiling" is the
# ceiling path's flow (`bench_flow_with_random_head`), "c5" c5's form at
# the row's width (2 leading-mask affine couplings, n_leading 2),
# "variant" REACH_VARIANT's flow (`config_flow`).
# A deep row's chains all start at the flow's image of the funnel's
# centre (x = 0), where trees turn after a similar length: at this step a
# few pass depth 10 and none needs more than 2,047 leapfrogs, the plain
# versions' lockstep length (from the funnel's draws at 0.003 six of 16
# chains ran to depth 12, 4,095 leapfrogs: 23 s a plain transition); it
# must reach trees deeper than 10, and its K2 is held by `bitwise_k1`
# alone.
REACH_DEEP_EPS = 0.0005
REACH_DEEP_CHAINS = 16
REACH_VARIANT = "c1_std_normal_h48_depth12_nuts"
REACH_ROWS = (
    ("funnel d=64 affine [48, 48]", "funnel", 64, "affine", (48, 48), 4,
     N_CHAINS, None, False),
    ("funnel d=64 rqs [100]", "funnel", 64, "rqs", (100,), 4, N_CHAINS,
     None, False),
    ("funnel d=64 affine [512, 512]", "funnel", 64, "affine", (512, 512), 4,
     N_CHAINS, None, False),
    ("funnel d=64 ceiling flow, depth 12", "funnel", 64, "ceiling", HIDDEN,
     12, REACH_DEEP_CHAINS, REACH_DEEP_EPS, True),
    ("hierarchical d=514 c5's flow", "hierarchical", 514, "c5", (128, 128),
     4, N_CHAINS, None, False),
    ("funnel d=288 rqs [64, 64]", "funnel", 288, "rqs", (64, 64), 4,
     N_CHAINS, None, False),
    (f"std_normal d=2, {REACH_VARIANT}'s flow", "std_normal", 2, "variant",
     (48,), 12, 256, None, False))
REACH_WINDOW = 4
REACH_DEEP_WINDOW = 2
REACH_REPS = 10


def reach_flow(device, flow_kind, d, hidden, seed, knots=KNOTS):
    """A flow of `reach_vs_plain`: Standardize + one leading-mask affine
    coupling (`random_flow`), Standardize + 2 rqs blocks on alternating
    masks of `knots` knots (`spline_flow_with_random_heads`), the ceiling
    path's flow, c5's form, at width d with conditioners of `hidden`, or
    REACH_VARIANT's flow (`config_flow`)."""
    from tpuflows_torch.util.shapes import leading_mask

    if flow_kind == "variant":
        return config_flow(device, REACH_VARIANT, seed)
    if flow_kind == "affine":
        return random_flow(device, seed, d, hidden, leading_mask(d))
    if flow_kind == "ceiling":
        return bench_flow_with_random_head(device, seed)
    if flow_kind == "c5":
        return spline_flow_with_random_heads(
            device, seed, dim=d, hidden=hidden, knots=KNOTS, n_blocks=2,
            head=CONFIG_AFFINE_HEAD, kind="affine", mask_scheme="leading",
            n_leading=2, clamp=CLAMP)
    return spline_flow_with_random_heads(
        device, seed, dim=d, hidden=hidden, knots=knots, n_blocks=2,
        kind="rqs", mask_scheme="alternating")


def k1_timing(label, q, im, rnd, e, model, depth, n_reps, plain_ms=None,
              graph=(20, 10)):
    """K1 through its wrapper (the tile kernel or the wide unit, as
    `nuts_cuda.wide_path` picks) timed from the host and on the device
    (`graph_ms` with `graph`'s reps and replays), beside its bound
    (`k1_bound`) and its plain version's time: `plain_ms`, or one timed
    call after one warmup (two before the conditioners' phase)."""
    from tpuflows_torch.kernels import nuts_cuda

    def fn():
        return nuts_cuda.nuts_transition(q, *rnd, e, im, model, depth)

    ms, kern = timed(fn, n_reps)
    if plain_ms is None:
        plain_ms, _ = timed(lambda: nuts_cuda.transition_math_torch(
            q, *rnd, e, im, nuts_cuda.plain_logp_grad(model), depth), 1,
            warmup=1)
    bound, by, flops, nbytes = k1_bound(model, q, kern[3], depth)
    return {"label": label, "d": int(q.shape[1]), "chains": int(q.shape[0]),
            "max_depth": depth, "ms": ms,
            "device_ms": graph_ms(fn, *graph),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "flops": flops, "bytes": nbytes, "mlp_flops": mlp_flops(model),
            "target_flops": target_flops(model),
            "leapfrogs": float(kern[3].sum()),
            "wide": nuts_cuda.wide_path(model, depth),
            "general": bool(model.general)}


def wide_k2_k3_timing(label, q, im, wrnd, e, model, depth, window,
                      n_reps):
    """K2 (a window of `window` slots) and K3 at q through their wrappers
    (the wide units past d = 256), each timed from the host and on the
    device beside its plain version and its bound: K2's as `time_window`
    counts it (a gradient at the start and one a leapfrog; q, the
    randomness, the flow in, the draws and the info out), K3's one
    gradient a row (z, the flow in, lp and g out)."""
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.kernels import nuts_window_cuda as nw
    from tpuflows_torch.kernels.fused_logp_cuda import (
        fused_latent_logp_and_grad)

    n, d = q.shape
    flow_floats = model.params.numel() + model.packed_target.params.numel()
    per = mlp_flops(model) + target_flops(model)

    def k2():
        return nw.nuts_window(q, *wrnd, e, im, model, depth, window)

    ms, out = timed(k2, 2, warmup=1)
    plain_ms, _ = timed(lambda: nw.window_math_torch(
        q, *wrnd, e, im, nuts_cuda.plain_logp_grad(model), window, depth),
        1, warmup=0)
    D = depth
    flops = (float(out[3].sum()) + n) * per
    nbytes = 4.0 * (n * d + n * window * (d + 2 * D + (1 << D)) + 1 + d
                    + flow_floats + window * n * d + 7 * window * n)
    bound, by = _bound(flops, nbytes)
    k2_res = {"label": label, "window": window, "ms": ms,
              "device_ms": graph_ms(k2, reps=2, replays=2),
              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
              "flops": flops, "bytes": nbytes,
              "wide": nuts_cuda.wide_path(model, depth)}
    hook = fused_latent_logp_and_grad(model.target, model.flow)
    z = q.contiguous()
    ms, _ = timed(lambda: hook(z), n_reps)
    plain_ms, _ = timed(lambda: hook.plain(z), 1)
    bound, by = _bound(float(n * per), 4.0 * (2 * n * d + n + flow_floats))
    k3_res = {"label": label, "ms": ms, "device_ms": graph_ms(lambda: hook(z)),
              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
              "wide": nuts_cuda.wide_path(model)}
    return k2_res, k3_res


def wide_vs_warp(q, im, rnd, wrnd, e, model, depth, window):
    """The wide units (asked for on a flow the tile kernels take) against
    the per-warp kernels on the same inputs. On a flow of the general
    path's form both compute the same operations in the same order (the
    targets and modules are written once over a row view, csrc/
    latent_grad.cuh `InRegs` / `InMem`; on the main paths' form the
    per-warp kernels sum in float32 and the wide units in double), so the
    gate: per output of K1, K2 and K3 no element whose value differs.
    K1's bar between the two for K1 and for K2's first slot (`compare`)
    is printed beside it."""
    from tpuflows_torch.kernels import fused_logp_cuda, nuts_cuda
    from tpuflows_torch.kernels import nuts_window_cuda as nw

    out = {}
    wide = nuts_cuda._launch(q, *rnd, e, im, model, depth, wide=True)
    warp = nuts_cuda.chain_transition_warp(q, *rnd, e, im, model, depth)
    w2 = nw._launch(q, *wrnd, e, im, model, depth, window, None, wide=True)
    p2 = nw.chain_window_warp(q, *wrnd, e, im, model, depth, window)
    w3 = fused_logp_cuda._launch(q, model, wide=True)
    p3 = fused_logp_cuda.chain_logp_grad_warp(q, model)
    for name, a, b, keys in (("K1", wide, warp, K1_OUTS),
                             ("K2", w2, p2, K2_OUTS),
                             ("K3", w3, p3, ("lp", "g"))):
        diffs = {k: value_diff(x, y) for k, x, y in zip(keys, a, b)}
        out[name] = {"differ": sum(v[0] for v in diffs.values()),
                     "max_abs": max(v[2] for v in diffs.values()),
                     "differ_by_output": {k: v[0] for k, v in diffs.items()}}
    out["K1"]["vs_warp"] = compare(warp, wide)
    out["K2"]["vs_warp"] = compare([x[0] for x in p2], [x[0] for x in w2])
    out["passed"] = all(out[k]["differ"] == 0 for k in ("K1", "K2", "K3"))
    return out


def wide_vs_warp_targets(device, rows=TARGET_ROWS, hidden=(48, 48),
                         n=N_CHAINS, depth=TARGET_DEPTH,
                         window=REACH_WINDOW):
    """`wide_vs_warp` once per target kind that `pack_target` packs, at
    its (kind, d) of `rows`, under Standardize + one leading-mask affine
    coupling of tanh conditioners `hidden` (the general path's form, every
    leaf random), from the flow's image of the target's draws at
    TARGET_EPS's step. Returns one row per kind."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.util.shapes import leading_mask

    out = []
    for i, (kind, d) in enumerate(rows):
        seed = 12000 + 10 * i
        target = smoke_target(kind, d, device)
        flow = random_flow(device, seed, d, hidden,
                           leading_mask(d, 2 if d > 2 else 1),
                           activation="tanh")
        model = nuts_cuda.pack_flow(flow, target)
        q = target_start(target, flow, kind, n, seed, device)
        g = torch.Generator(device=device).manual_seed(seed)
        im = 0.5 + torch.rand(d, generator=g, device=device)
        rnd = nuts_cuda.draw_randomness(g, n, d, depth, im)
        wrnd = window_randomness(device, n, d, window, depth, im, seed + 1)
        e = torch.tensor(TARGET_EPS[kind], device=device)
        row = wide_vs_warp(q, im, rnd, wrnd, e, model, depth, window)
        out.append({"kind": kind, "d": d, "d_pad": model.d_pad,
                    "hidden": list(model.hidden), **row})
    return out


def reach_vs_plain(device, rows=REACH_ROWS, window=REACH_WINDOW,
                   deep_window=REACH_DEEP_WINDOW,
                   checked_slots=TARGET_CHECKED_SLOTS, n_reps=REACH_REPS,
                   tile_checks=True, chains=None, warp_checks=True,
                   k23_timing=False, refereed_opts=None):
    """Phase reach_vs_plain: each row of `rows` held as
    `conditioners_vs_plain` holds its rows (`refereed_row`: K1 against its
    plain version in float64 under `refereed_bar`, K2 equal to chained K1
    launches to the bit and its first slots against float64, K3 by
    `judge`), on `chains` chains where given (a CPU rehearsal) and the
    row's own count otherwise; the rows the tile kernels take also their
    tile kernels against the per-warp ones (`tiles_and_timing`); K1 timed
    beside its bound on every row, K2 and K3 too on the wide units' rows
    past d = 256. A deep row starts every chain at the flow's image of x =
    0, holds K2 by `bitwise_k1` alone (its plain window would run a few
    thousand ticks) and must reach trees deeper than 10. On the card it
    builds the wide units first (their build seconds) and holds them
    against the per-warp kernels on every target kind
    (`wide_vs_warp_targets`). A row may end in its rqs flow's knots (K = 8
    otherwise). `warp_checks` False leaves out every comparison with the
    per-warp kernels (the wide units against them, and the tile kernels'
    rows, whose K1 is then timed through its wrapper alone);
    `k23_timing` times K2 and K3 on every row; `refereed_opts` are more
    keyword arguments of `refereed_row` (its witnesses and its gate).
    `tile_checks` False leaves out what needs the
    card. Returns (rows, tile rows, timings, the wide units' checks,
    build seconds)."""
    import torch
    from tpuflows_torch.kernels import (cuda_build, fused_logp_cuda,
                                        nuts_cuda)
    from tpuflows_torch.kernels import nuts_window_cuda as nw

    build_seconds, wide_rows = None, []
    if tile_checks and warp_checks:
        t = time.perf_counter()
        infos = cuda_build.build(nuts_cuda.WIDE_LIBRARY, nw.WIDE_LIBRARY,
                                 fused_logp_cuda.WIDE_LIBRARY)
        build_seconds = {"wall": time.perf_counter() - t,
                         "nvcc": max(i.seconds for i in infos.values()),
                         "ptxas": {k: v for i in infos.values()
                                   for k, v in ptxas_summary(i.log).items()}}
        wide_rows = wide_vs_warp_targets(device)
    out, tiles, timings = [], [], []
    for i, (label, kind, d, flow_kind, hidden, depth, n, eps, deep,
            *knots) in enumerate(rows):
        seed = 11000 + 10 * i
        n = chains or n
        target = smoke_target(kind, d, device)
        flow = reach_flow(device, flow_kind, d, hidden, seed, *knots)
        if deep:  # every chain from the flow's image of x = 0
            with torch.no_grad():
                q0, _ = flow.forward_and_ladj(torch.zeros((1, d),
                                                          device=device))
            start = q0.expand(n, d).contiguous()
        else:
            start = target_start(target, flow, "draws", n, seed, device)
        row, ctx = refereed_row(device, label, kind, target, flow, n, depth,
                                deep_window if deep else window,
                                0 if deep else checked_slots, seed,
                                eps or TARGET_EPS[kind], start=start,
                                **(refereed_opts or {}))
        q, im, rnd, wrnd, e, model = ctx
        wide = nuts_cuda.wide_path(model, depth)
        hist = row["k1"]["depth_histogram"]
        row.update(flow=flow_kind, max_depth=depth, wide=wide, deep=deep,
                   deeper_than_10=sum(hist[nuts_cuda.TILE_MAX_DEPTH + 1:]))
        if deep and not row["deeper_than_10"]:
            row["passed"] = False
        out.append(row)
        if not tile_checks:
            continue
        if wide or not warp_checks:
            timing = k1_timing(label, q, im, rnd, e, model, depth,
                               2 if deep else n_reps,
                               row["k1"]["plain_ms"], (2, 1 if deep else 2))
            if model.d_pad > nuts_cuda.TILE_MAX_DIM or k23_timing:
                timing["k2"], timing["k3"] = wide_k2_k3_timing(
                    label, q, im, wrnd, e, model, depth, window, n_reps)
                timing["k2"]["max_abs_err"] = row["k2"]["max_dq"]
                timing["k3"]["max_abs_err"] = max(
                    row["k3"][k]["max_abs"] for k in ("lp", "g"))
        else:
            row_tiles, timing = tiles_and_timing(label, flow, target, ctx,
                                                 depth, window, n_reps)
            tiles += row_tiles
        timing.update(kind=kind, flow=flow_kind, hidden=list(model.hidden),
                      max_abs_err=row["k1"]["max_dq"],
                      variant_shape=flow_kind == "variant")
        timings.append(timing)
    return out, tiles, timings, wide_rows, build_seconds


# ---------------------------------------------------------------------------
# The spline reach: K4-K7 at any knot count, K6/K7 past shared memory, and
# K1-K3 under flows of many knots
# ---------------------------------------------------------------------------
# K4/K5 rows (rows, d, knots): past the old 64 (K4 16 lanes, K5 32), both
# at 32 lanes, K = 1000 (min_bin K = 1: every bin min_bin wide), and the
# first K at which each block takes 4 elements in both kernels
# (`rqs_cuda.spline_plan`); each judged against the plain version with
# the float64 referee and held to the one-thread kernels bit for bit.
SPLINE_REACH_RQS_ROWS = [(1024, 8, 65), (1024, 8, 96), (512, 8, 128),
                         (512, 8, 129), (256, 8, 257), (64, 8, 1000),
                         (16, 4, 1453)]
# held to the one-thread kernels alone (which the rows above hold to the
# plain version): the first K at which each block takes 2 and 1 elements
# in both kernels, and K5's largest K. The plain version's autograd
# pullback takes 2.6-7 s a call there (run 1), 4 calls a row.
SPLINE_REACH_BITS_ROWS = [(8, 2, 2905), (4, 2, 5810), (4, 2, 9684)]
# K6/K7 rows, as COUPLING_SHAPES: on the tile kernels at K = 96 and 1000
# (R = 8, one spline dim a chunk), and on the wide unit: hidden layers of
# 3200 and 8192 units and 10 layers of 256 at the fit's d and K, and
# d = 4096 (a tile of 8 rows of its input alone takes 128 KB), there also
# with a bf16 gelu conditioner. Heads 0.01 x He: with the JAX tests' 0.1
# N(0, 1) head the raw values spread 96 bins so unevenly that no float32
# evaluation (plain, oracle, kernel) of the inverse's pullback comes
# within the bar of float64 on any weight (a float32 mirror of the tile
# K7 on the CPU: every value of w0 missed it, by 4e5 bars at the 99.9th
# percentile), and `judge` would compare noise. Each row is judged with
# SPLINE_REACH_WITNESSES more float32 evaluations beside the plain
# version and the oracle, the plain version with its hidden units
# reordered (`permuted_params`): the plain version and the oracle take
# the conditioner from the same matmuls and share its rounding. (The
# [3200] row's inverse w1 at 1024 rows: the wide unit's count of values
# past float64's bar is the highest of six float32 evaluations, its
# 99.9th percentile the lowest; PERF.md.)
SPLINE_REACH_BLOCK_SHAPES = [
    (TRAIN_BATCH, DIM, HIDDEN, 96, "alternating0", "he0.01", "silu"),
    (256, DIM, HIDDEN, 1000, "alternating1", "he0.01", "silu"),
    (TRAIN_BATCH, DIM, (3200,), KNOTS, "alternating0", "he0.01", "silu"),
    (256, DIM, (8192,), KNOTS, "alternating1", "he0.01", "silu"),
    (TRAIN_BATCH, DIM, (256,) * 9, KNOTS, "alternating0", "he0.01",
     "silu"),
    (256, 4096, (128,), KNOTS, "alternating0", "he0.01", "silu"),
    (256, 4096, (128,), KNOTS, "alternating1", "he0.01", "gelu", "bf16")]
SPLINE_REACH_WITNESSES = 2
# shapes the tile kernels take, forced onto the wide unit, which must equal
# them to the bit: the fit's (COUPLING_SHAPES' first row), tanh and relu
# (COUPLING_SHAPES' rows of other widths and depths) and gelu, bf16 silu
# and bf16 gelu (COUPLING_FORM_SHAPES): every activation and both
# operand types of the wide unit
SPLINE_REACH_FORCED = [COUPLING_SHAPES[0], COUPLING_SHAPES[8],
                       COUPLING_SHAPES[9], *COUPLING_FORM_SHAPES]
# K1/K2/K3 under 2 rqs blocks of [64, 64] over the 64-d funnel, as
# REACH_ROWS: K = 96 on the tile kernels (R = 1), 1024 chains at the
# funnel's eps 0.1, and K = 1000 on the wide units at 64 chains and depth
# 2 (its float32 plain version's gradient takes ~3,000 knot steps a
# block) at eps 0.01.
#   K = 96 is held to float64 (`refereed_row`) with two more float32
# witnesses in its bar (`permuted_flow`: the plain version with its
# hidden units reordered), and two reported beside it: the per-warp K1
# and the plain version summing in the tile kernel's order
# (`kernel_order_flow`). One chain of 1024 is sensitive: the tile
# kernel, the per-warp one and the kernel-order witness move it about
# 3e-4 from float64 (past K1's 2.3e-4), one permuted witness 2.7e-4, the
# plain version 4e-5 (PERF.md). The kernel's distance is its order of
# sums, which a float32 evaluation in plain PyTorch reproduces.
#   At K = 1000 float32 places 1000 knots only to about K ulps of B, and
# at eps 0.01 (where the chains move; at 0.1 every chain rejects its
# tree) the float32 plain version itself takes another tree decision than
# float64 on 12 of 64 chains: K1 and K2's checked slot are held to their
# float32 plain versions by K1's bar (gate "vs_plain"), the float64
# referee reported beside them.
SPLINE_REACH_K2_SLOTS = {96: TARGET_CHECKED_SLOTS, 1000: 1}
SPLINE_REACH_NUTS_OPTS = {96: {"witnesses": 2, "order_witness": True},
                          1000: {"gate": "vs_plain"}}
SPLINE_REACH_NUTS_ROWS = (
    ("funnel d=64 rqs [64, 64], K = 96", "funnel", 64, "rqs", (64, 64), 4,
     N_CHAINS, None, False, 96),
    ("funnel d=64 rqs [64, 64], K = 1000", "funnel", 64, "rqs", (64, 64),
     2, 64, 0.01, False, 1000))


def spline_row_timing(x, raw, gy, gl):
    """K4 and K5 inverse (the direction a VI fit runs) on one row: device
    ms (`graph_ms`) beside the bound (`rqs_bytes_ops`) and the plain
    version's ms (one call)."""
    from tpuflows_torch.kernels import rqs_cuda

    n_el, K = x.numel(), (raw.shape[-1] + 1) // 3
    b4, o4, b5, o5 = rqs_bytes_ops(n_el, K)
    out = {}
    for key, nbytes, ops, kern, plain in (
            ("k4", b4, o4, lambda: rqs_cuda.spline_eval(x, raw, 4.0, True),
             lambda: rqs_cuda.plain_eval(x, raw, 4.0, True)),
            ("k5", b5, o5,
             lambda: rqs_cuda.spline_grad(x, raw, gy, gl, 4.0, True),
             lambda: rqs_cuda.plain_grad(x, raw, gy, gl, 4.0, True))):
        bound, by = _bound(ops, nbytes)
        plain_ms, _ = timed(plain, 1, warmup=0)
        plan = rqs_cuda.spline_plan(K, key == "k5")
        out[key] = {"device_ms": graph_ms(kern, reps=5, replays=4),
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "bytes": nbytes, "ops": ops, "lanes": plan.lanes,
                    "elements": plan.elements, "smem": plan.smem}
    return out


def spline_reach_rqs(device, rows=SPLINE_REACH_RQS_ROWS,
                     bits_rows=SPLINE_REACH_BITS_ROWS, card=True):
    """K4 and K5 past 64 knots: each row of `rows` judged against the
    plain version with the float64 referee (`rqs_vs_plain`), both
    directions; every row of `rows` and `bits_rows` against the one-thread
    kernels bit for bit (`bits_vs_earlier`, both kernels; the card only),
    and the refusals past the one-element blocks: K5 at 9,685 knots and
    K4 at 11,621 raise naming shared memory, K4 at 9,685 launches.
    Returns (judged rows, bit rows, refusals)."""
    from tpuflows_torch.kernels import rqs_cuda

    cases = [(n, d, K, False) for n, d, K in rows]
    judged = rqs_vs_plain(device, cases)
    bits, refusals = [], {}
    if card:
        every = cases + [(n, d, K, False) for n, d, K in bits_rows]
        bits = [dict(r, kernel="k4") for r in k4_vs_earlier(device, every)]
        bits += [dict(r, kernel="k5") for r in k5_vs_earlier(device, every)]

        def refused(K, grad):
            x, raw, gy, gl = rqs_inputs(device, 1, 1, K, seed=K)
            try:
                if grad:
                    rqs_cuda.spline_grad(x, raw, gy, gl)
                else:
                    rqs_cuda.spline_eval(x, raw)
            except ValueError as e:
                return "shared memory" in str(e)
            return False

        refusals = {"k5_9685": refused(9685, True),
                    "k4_9685": refused(9685, False),
                    "k4_11621": refused(11621, False)}
    return judged, bits, refusals


def block_row_timing(device, shape):
    """K6 and K7 (with the weights' pass) forward at one block shape:
    device ms (`graph_ms`) beside the bound (`coupling_work`) and the
    plain version's ms (one call), with the plan."""
    import torch
    from tpuflows_torch.kernels import coupling_cuda as cc

    n, d, hidden, K, mask_name, head, act, *dtype = shape
    dtype = dtype[0] if dtype else "f32"
    mask_t = coupling_mask(mask_name, d)
    x, params, gz, gl = coupling_inputs(device, n, d, hidden, K, head,
                                        seed=n + d + K)
    m32 = torch.tensor(mask_t, dtype=torch.float32, device=device)
    nt = sum(1 for m in mask_t if m == 0)
    spec = cc.BlockSpec(mask_t, K, 4.0, act, False, dtype)
    k6_ops, k6_bytes, k7_ops, k7_bytes, _, _ = coupling_work(n, d, hidden, K,
                                                             nt)
    out = {"n": n, "d": d, "hidden": list(hidden), "knots": K,
           "activation": act, "compute_dtype": dtype}
    for key, ops, nbytes, kern, plain in (
            ("k6", k6_ops, k6_bytes, lambda: cc.block_eval(x, params, spec),
             lambda: cc.plain_block(x, params, m32, K, 4.0, act, False,
                                    dtype)),
            ("k7", k7_ops, k7_bytes,
             lambda: cc.block_grad(x, params, spec, gz, gl),
             lambda: cc.plain_block_vjp(x, params, m32, gz, gl, K, 4.0, act,
                                        False, dtype))):
        bound, by = _bound(ops, nbytes)
        plain_ms, _ = timed(plain, 1, warmup=1)
        plan = cc.tile_plan([d, *hidden, (3 * K - 1) * d], K, nt, n,
                            key == "k7")
        out[key] = {"device_ms": graph_ms(kern, reps=3, replays=3),
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "wide": plan.wide, "plan": plan._asdict()}
    return out


def wide_vs_tile(device, shapes=SPLINE_REACH_FORCED):
    """The wide unit forced at shapes the tile kernels take
    (SPLINE_REACH_FORCED), both directions: z, ladj, dx and every
    weight's and bias's cotangent must equal the tile kernels' to the bit
    (one order of sums, the tile plan's chunk)."""
    rows = []
    for shape in shapes:
        rows += _wide_vs_tile_shape(device, shape)
    return rows


def _wide_vs_tile_shape(device, shape):
    import torch
    from tpuflows_torch.kernels import coupling_cuda as cc

    n, d, hidden, K, mask_name, head, act, *dtype = shape
    dtype = dtype[0] if dtype else "f32"
    mask_t = coupling_mask(mask_name, d)
    x, params, gz, gl = coupling_inputs(device, n, d, hidden, K, head,
                                        seed=n + d + K)
    widths = [d, *hidden, (3 * K - 1) * d]
    nt = sum(1 for m in mask_t if m == 0)
    rows = []
    for inverse in (False, True):
        spec = cc.BlockSpec(mask_t, K, 4.0, act, inverse, dtype)
        tile = [*cc._launch_eval(x, params, spec, widths)]
        dx, dps = cc._launch_grad(x, params, spec, widths, gz, gl, True)
        tile += [dx, *dps]
        wide = [*cc._launch_eval(x, params, spec, widths, wide=True)]
        dx, dps = cc._launch_grad(x, params, spec, widths, gz, gl, True,
                                  wide=True)
        wide += [dx, *dps]
        names = ["z", "ladj", "dx", *param_names(len(params))]
        differ = {k: int((a.view(torch.int32) != b.view(torch.int32)).sum())
                  for k, a, b in zip(names, wide, tile)}
        rows.append({"n": n, "d": d, "hidden": list(hidden), "knots": K,
                     "activation": act, "compute_dtype": dtype,
                     "direction": "inverse" if inverse else "forward",
                     "plans": {"tile": tile_plans(cc, widths, K, nt, n,
                                                  device),
                               "wide": tile_plans(cc, widths, K, nt, n,
                                                  device, wide=True)},
                     "bits_differ": differ,
                     "max_abs": max(float((a - b).abs().max())
                                    for a, b in zip(wide, tile)),
                     "passed": not any(differ.values())})
    return rows


def spline_reach_vs_plain(device, nuts_chains=None, card=True,
                          rqs_rows=SPLINE_REACH_RQS_ROWS,
                          block_shapes=SPLINE_REACH_BLOCK_SHAPES):
    """The checks of phase spline_reach_vs_plain: K4/K5 at any knot count
    (`spline_reach_rqs`), K6/K7 at K = 96 and 1000 and on the wide unit
    (`coupling_vs_plain` on SPLINE_REACH_BLOCK_SHAPES), the wide unit
    equal to the tile kernels at SPLINE_REACH_FORCED (`wide_vs_tile`), and K1,
    K2 and K3 under 2 rqs blocks of 96 and 1000 knots (`reach_vs_plain` on
    SPLINE_REACH_NUTS_ROWS with SPLINE_REACH_NUTS_OPTS). On the
    card they run in a process of their own beside run_configs
    (`--spline-reach`), host-paced as both are, and the phase's timing
    apart from them (`spline_reach_timing`). `nuts_chains` cuts the
    chains of a CPU rehearsal; `card` False leaves out what needs the
    card, and `rqs_rows` and `block_shapes` cut a rehearsal's rows.
    Returns one dict of its parts and the rows that failed."""
    judged, bits, refusals = spline_reach_rqs(device, rqs_rows, card=card)
    blocks = coupling_vs_plain(device, block_shapes,
                               witnesses=SPLINE_REACH_WITNESSES)
    forced = wide_vs_tile(device) if card else []
    nuts = []
    for row in SPLINE_REACH_NUTS_ROWS:
        opts = dict(SPLINE_REACH_NUTS_OPTS[row[-1]])
        if opts.get("witnesses"):
            opts["warp_witness"] = card
        nuts += reach_vs_plain(device, [row], chains=nuts_chains,
                               checked_slots=SPLINE_REACH_K2_SLOTS[row[-1]],
                               tile_checks=False, warp_checks=False,
                               refereed_opts=opts)[0]
    res = {"rqs": judged, "rqs_bits": bits, "refusals": refusals,
           "blocks": blocks, "wide_vs_tile": forced, "nuts": nuts}
    bad = [r for r in judged + blocks + forced + nuts if not r["passed"]]
    bad += [r for r in bits if r["bits_differ"]]
    if refusals and refusals != {"k5_9685": True, "k4_9685": False,
                                 "k4_11621": True}:
        bad.append({"refusals": refusals})
    return res, bad


def spline_reach_aside():
    """Starts the checks of spline_reach_vs_plain in a process of their own
    (this script with --spline-reach, on the kernels this one built).
    Returns the process and a function that waits for it and returns
    (its result, the rows that failed, its launches, its seconds)."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--spline-reach"], stdout=subprocess.PIPE,
                            text=True)

    def wait():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"spline_reach_vs_plain in its own process "
                               f"exited {proc.returncode}")
        d = json.loads(out.strip().splitlines()[-1])
        return d["spline_reach"], d["bad"], d["launches"], d["seconds"]

    return proc, wait


def spline_reach_timing(device, nuts_rows, rqs_rows=SPLINE_REACH_RQS_ROWS,
                        block_shapes=SPLINE_REACH_BLOCK_SHAPES):
    """The timing of phase spline_reach_vs_plain, apart from its checks so
    that no other process's kernels share the card while it times: K4 and
    K5 on each row of `rqs_rows` (`spline_row_timing`), K6 and K7 at each
    block shape (`block_row_timing`), and K1 on each nuts row (`k1_timing`,
    its plain ms the checks' own, `nuts_rows`), with K2 (a window of 2)
    and K3 where the tile kernels take the flow (`wide_k2_k3_timing`; the
    wide row's plain window takes minutes), on the inputs the checks
    held (reach_vs_plain's seed of a first row)."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda

    rqs = [{"n": n, "d": d, "knots": K,
            **spline_row_timing(*rqs_inputs(device, n, d, K, n + d + K))}
           for n, d, K in rqs_rows]
    blocks = [block_row_timing(device, sh) for sh in block_shapes]
    nuts, seed = [], 11000
    for row, checked in zip(SPLINE_REACH_NUTS_ROWS, nuts_rows):
        label, kind, d, flow_kind, hidden, depth, n, eps, _, knots = row
        target = smoke_target(kind, d, device)
        flow = reach_flow(device, flow_kind, d, hidden, seed, knots)
        model = nuts_cuda.pack_flow(flow, target)
        q = target_start(target, flow, "draws", n, seed, device)
        g = torch.Generator(device=device).manual_seed(seed)
        im = 0.5 + torch.rand(d, generator=g, device=device)
        rnd = nuts_cuda.draw_randomness(g, n, d, depth, im)
        e = torch.tensor(eps or TARGET_EPS[kind], device=device)
        t = k1_timing(label, q, im, rnd, e, model, depth, REACH_REPS,
                      checked["k1"]["plain_ms"], (2, 2))
        if not t["wide"]:
            wrnd = window_randomness(device, n, d, 2, depth, im, seed + 1)
            t["k2"], t["k3"] = wide_k2_k3_timing(label, q, im, wrnd, e,
                                                 model, depth, 2, REACH_REPS)
            t["k2"]["max_abs_err"] = checked["k2"]["max_dq"]
            t["k3"]["max_abs_err"] = max(checked["k3"][k]["max_abs"]
                                         for k in ("lp", "g"))
        t["max_abs_err"] = checked["k1"]["max_dq"]
        nuts.append(t)
    return {"rqs_timing": rqs, "block_timing": blocks, "nuts_timing": nuts}


def spline_reach_kernels(reach, runner):
    """The kernels line's rows of phase spline_reach_vs_plain (`reach`):
    K4 and K5 inverse at K = 96 and 1000 (at K = 96 with the launches of
    the runner's c2_correlated_rqs_k96_nuts, `runner` its rows by
    config), K6 and K7 forward at each block shape (the tile kernels' or
    the wide unit's; no path launches them), K1 at both nuts rows and K2
    and K3 at K = 96 (no path launches them under these flows)."""
    src = "src/tpuflows_torch/csrc/"
    variant = "c2_correlated_rqs_k96_nuts"
    rows = []

    def row(name, source, replaces, launches, err, t, **extra):
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": "src/tpuflows/kernels/" + replaces,
                     "launches": launches, "max_abs_err": err,
                     "ms": t["device_ms"], "device_ms": t["device_ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None, **extra})

    for t in reach["rqs_timing"]:
        K = t["knots"]
        if K not in (96, 1000):
            continue
        judged = next(r for r in reach["rqs"] if r["knots"] == K
                      and r["direction"] == "inverse")
        for key, name, line, errs in (
                ("k4", "rqs_eval inverse (K4)", "204", ("y", "ladj")),
                ("k5", "rqs_grad inverse (K5)", "240", ("dx", "draw"))):
            row(f"{name}, K = {K}", "rqs_spline.cu",
                f"rqs_pallas.py:{line}",
                runner[variant]["rqs_launches"][f"{key}_inverse"]
                if K == 96 else 0,
                max(judged[e]["max_abs"] for e in errs), t[key],
                launches_config=variant if K == 96 else None, n=t["n"],
                d=t["d"], lanes=t[key]["lanes"],
                elements=t[key]["elements"])
    for t in reach["block_timing"]:
        judged = next(r for r in reach["blocks"] if r["n"] == t["n"]
                      and r["d"] == t["d"] and r["hidden"] == t["hidden"]
                      and r["knots"] == t["knots"]
                      and r["activation"] == t["activation"]
                      and r["compute_dtype"] == t["compute_dtype"]
                      and r["direction"] == "forward")
        label = f"d = {t['d']}, hidden {t['hidden']}, K = {t['knots']}"
        if t["compute_dtype"] != "f32":
            label += f", {t['activation']} {t['compute_dtype']}"
        for key, name, line in (("k6", "coupling_block forward (K6", "185"),
                                ("k7", "coupling_block pullback, forward "
                                       "(K7", "215")):
            x = t[key]
            errs = (("z", "ladj") if key == "k6" else
                    ("dx", *param_names(2 * len(t["hidden"]) + 2)))
            row(f"{name}{', wide' if x['wide'] else ''}), {label}",
                "coupling_wide.cu" if x["wide"] else "coupling_tile.cu",
                f"coupling_pallas.py:{line}", 0,
                max(judged[e]["max_abs"] for e in errs), x, n=t["n"])
    for t in reach["nuts_timing"]:
        row(f"nuts_transition{' wide' if t['wide'] else ''} ({t['label']})",
            "nuts_transition_wide.cu" if t["wide"] else "nuts_transition.cu",
            "nuts_pallas.py:407", 0, t["max_abs_err"], t)
        for key, source, line in (("k2", "nuts_window", "nuts_pallas.py:831"),
                                  ("k3", "fused_logp", "fused_logp.py:140")):
            if key in t:
                row(f"{source}{' wide' if t[key]['wide'] else ''} "
                    f"({t['label']})",
                    f"{source}{'_wide' if t[key]['wide'] else ''}.cu", line,
                    0, t[key]["max_abs_err"], t[key])
    return rows


def nuts_gated(device, sampler, flow, target, variant, n_chains, num_warmup,
               window, max_windows, ess_gate):
    """Warmup, then gated draw windows: windows of `window` draws until
    max split-R-hat < RHAT_GATE and min ESS >= `ess_gate` on data-space
    draws, at most `max_windows`; and the port's `moment_gate` on v's
    draws against N(0, sigma_v^2) at MOMENT_SIGMA. Returns (result dict,
    post-warmup NUTSState, rows mapped to data space per window)."""
    import torch
    from tpuflows_torch.diagnostics import (effective_sample_size,
                                            moment_gate, split_rhat)
    from tpuflows_torch.mcmc import to_data_space

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    dim = target.dim
    q0 = torch.randn((n_chains, dim), generator=gen(4), device=device)
    t = time.perf_counter()
    state = sampler.warmup(gen(5), q0, num_warmup)
    sync()
    warm_time = time.perf_counter() - t
    warm_state = state

    draw_time = 0.0
    zs, infos = [], []
    converged = False
    mapped_rows = []
    g_draw = gen(6)
    for w in range(max_windows):
        t = time.perf_counter()
        state, z, info = sampler.draws(g_draw, state, window)
        sync()
        draw_time += time.perf_counter() - t
        zs.append(z)
        infos.append(info)
        x = to_data_space(flow, torch.cat(zs))
        mapped_rows.append(x.shape[0] * n_chains)
        min_ess = float(effective_sample_size(x).min())
        max_rhat = float(split_rhat(x).max())
        print(json.dumps({"variant": variant, "window": w,
                          "draws": int(x.shape[0]), "min_ess": min_ess,
                          "max_rhat": max_rhat}),
              file=sys.stderr, flush=True)
        if max_rhat < RHAT_GATE and min_ess >= ess_gate:
            converged = True
            break
    transitions = num_warmup + window * len(zs)
    if not bool(torch.isfinite(x).all()) or x.shape != (
            window * len(zs), n_chains, dim):
        raise RuntimeError(f"draws are not finite or have shape "
                           f"{tuple(x.shape)}")
    moments = moment_gate(x[..., :1], [0.0], [target.sigma_v ** 2],
                          n_sigma=MOMENT_SIGMA)
    v = x[..., 0]
    div = torch.cat([i.diverging.reshape(-1) for i in infos]).float().mean()
    steps = torch.cat([i.num_steps.reshape(-1) for i in infos]).float()
    depths = torch.cat([i.tree_depth.reshape(-1) for i in infos]).long()
    return {
        "warmup_time_s": warm_time, "draw_time_s": draw_time,
        "windows": len(zs), "n_draws": int(x.shape[0]),
        "min_ess": min_ess, "max_rhat": max_rhat, "converged": converged,
        "v_mean": float(v.mean()), "v_var": float(v.var(correction=0)),
        "v_z_mean": moments.max_sigma_mean,
        "v_z_var": moments.max_sigma_var,
        "moment_check_passed": moments.passed,
        "divergence_rate": float(div),
        "mean_leapfrogs_per_draw": float(steps.mean()),
        "tree_depth_histogram": torch.bincount(
            depths, minlength=MAX_DEPTH + 1).tolist(),
        "step_size": float(state.step_size),
        "transitions": transitions,
    }, warm_state, mapped_rows


def main_path(device, variant="ceiling", dim=DIM, n_chains=N_CHAINS,
              hidden=HIDDEN, train_steps=TRAIN_STEPS,
              train_batch=TRAIN_BATCH, num_warmup=NUM_WARMUP,
              window=DRAW_WINDOW, max_windows=MAX_WINDOWS,
              ess_gate=ESS_GATE, knots=KNOTS, n_blocks=GENERIC_BLOCKS,
              use_pallas="auto"):
    """Fit, warmup and gated draw windows through the port's entry points,
    for bench.py's `ceiling` variant (Standardize + one leading-mask affine
    coupling) or its `generic` variant (the arqs flow, its spline blocks on
    the tier `use_pallas`: "auto" is K4/K5, "fused" K6/K7). Returns
    (result dict, trained flow, post-warmup NUTSState)."""
    import torch
    from tpuflows_torch.flows import (ClipAdamCosine, RQSCouplingBlock,
                                      build_flow, make_reverse_kl_trainer)
    from tpuflows_torch.kernels import coupling_cuda, nuts_cuda, rqs_cuda
    from tpuflows_torch.mcmc import NUTSDriver
    from tpuflows_torch.mcmc.preconditioned import _CHUNK
    from tpuflows_torch.targets import NealsFunnel
    from tpuflows_torch.vi import elbo

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    target = NealsFunnel(dim=dim)
    nuts_cuda.LAUNCHES = 0
    rqs_cuda.reset_launches()
    coupling_cuda.reset_launches()
    init = torch.randn((1024, dim), generator=gen(1), device=device)
    if variant == "generic":
        flow = build_flow(init, gen(2), kind="arqs", n_blocks=n_blocks,
                          knots=knots, hidden=hidden, mask_scheme="mixed",
                          clamp=CLAMP, use_pallas=use_pallas, device=device)
    elif variant == "ceiling":
        flow = build_flow(init, gen(2), kind="affine", n_blocks=1,
                          hidden=hidden, mask_scheme="leading", clamp=CLAMP,
                          device=device)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    n_rqs = sum(isinstance(t, RQSCouplingBlock) for t in flow.transforms)
    trainer = make_reverse_kl_trainer(
        target.log_density, dim,
        ClipAdamCosine(lr=1e-2, decay_steps=train_steps, alpha=0.03,
                       max_norm=10.0),
        batch_size=train_batch, stl=True, device=device)
    t = time.perf_counter()
    res = trainer(gen(3), flow, train_steps)
    sync()
    train_time = time.perf_counter() - t
    fit_launches = dict(rqs_cuda.LAUNCHES)
    fit_coupling = dict(coupling_cuda.LAUNCHES)
    final_elbo = float(elbo(gen(7), flow, target.log_density, dim,
                            device=device))

    transition = nuts_cuda.fused_nuts_for_flow(target, flow,
                                               max_depth=MAX_DEPTH)
    sampler = NUTSDriver(transition=transition)
    gated, warm_state, mapped_rows = nuts_gated(
        device, sampler, flow, target, variant, n_chains, num_warmup, window,
        max_windows, ess_gate)
    launches = nuts_cuda.LAUNCHES
    # On the card every fit step runs each spline block's inverse (the
    # sample path) and forward (the STL loss's log q) and both pullbacks;
    # the ELBO and each data-space mapping call run the inverses. On the
    # K4/K5 tier that is one K4 and one K5 launch each. On the fused tier
    # it is one K6 launch each; K7 launches pass 1 for both pullbacks and
    # pass 2 (the weights' cotangents) for the inverse's only, since the
    # forward pass's weights are detached (`K7_LAUNCHES`: launches per
    # call without and with the weights' pass). The earlier kernels (the
    # yardstick) launch 0 times.
    inverse_calls = 1 + sum(-(-r // _CHUNK) for r in mapped_rows)
    per = n_rqs if on_card else 0
    fused = use_pallas == "fused"
    per_rqs, per_fused = (0, per) if fused else (per, 0)
    expected = {"k4_forward": per_rqs * train_steps,
                "k4_inverse": per_rqs * (train_steps + inverse_calls),
                "k5_forward": per_rqs * train_steps,
                "k5_inverse": per_rqs * train_steps}
    expected_coupling = {
        "k6_forward": per_fused * train_steps,
        "k6_inverse": per_fused * (train_steps + inverse_calls),
        "k7_forward": coupling_cuda.K7_LAUNCHES[False] * per_fused
        * train_steps,
        "k7_inverse": coupling_cuda.K7_LAUNCHES[True] * per_fused
        * train_steps}
    out = {
        "variant": variant, "modules": len(flow.transforms),
        "train_steps": train_steps, "train_time_s": train_time,
        "train_ms_per_step": 1e3 * train_time / max(train_steps, 1),
        "train_final_loss": float(res.loss_hist[-1]),
        "final_elbo": final_elbo, **gated, "launches": launches,
        "k1_tile_rows": nuts_cuda.launch_rows(transition.model),
        "k1_resident": nuts_cuda.launch_resident(
            transition.model, nuts_cuda.launch_rows(transition.model)) > 0,
        "rqs_launches": dict(rqs_cuda.LAUNCHES),
        "rqs_launches_fit": fit_launches,
        "rqs_launches_expected": expected, "use_pallas": use_pallas,
        "coupling_launches": dict(coupling_cuda.LAUNCHES),
        "coupling_launches_fit": fit_coupling,
        "coupling_launches_expected": expected_coupling,
        "earlier_coupling_launches": dict(coupling_cuda.EARLIER_LAUNCHES),
    }
    return out, flow, warm_state


def check_main_path(res):
    if not res["converged"]:
        raise RuntimeError(f"{res['variant']}: convergence gate failed: max "
                           f"split-R-hat {res['max_rhat']}, min ESS "
                           f"{res['min_ess']}")
    if res["launches"] <= 0 or res["launches"] != res["transitions"]:
        raise RuntimeError(f"{res['variant']}: K1 launched "
                           f"{res['launches']} times for "
                           f"{res['transitions']} transitions")
    if res["rqs_launches"] != res["rqs_launches_expected"]:
        raise RuntimeError(f"{res['variant']}: K4/K5 launched "
                           f"{res['rqs_launches']}, the path implies "
                           f"{res['rqs_launches_expected']}")
    if res["coupling_launches"] != res["coupling_launches_expected"]:
        raise RuntimeError(f"{res['variant']}: K6/K7 launched "
                           f"{res['coupling_launches']}, the path implies "
                           f"{res['coupling_launches_expected']}")
    if any(res["earlier_coupling_launches"].values()):
        raise RuntimeError(f"{res['variant']}: the earlier K6/K7 launched "
                           f"{res['earlier_coupling_launches']} on the path")
    if not res["moment_check_passed"]:
        raise RuntimeError(f"{res['variant']}: v's draws fail the moment "
                           f"check: {res}")


def mlp_flops(model):
    """Flops one latent gradient needs in its MLPs: every conditioner's
    forward and input-gradient backward, 2 x 2 x (n_in h_1 + h_1 h_2 + ...
    + h_{L-1} n_out) each, at any depth. n_in counts the mask's
    pass-through dims only (the conditioner sees z * mask, so the other
    rows of the first layer multiply zeros and their input gradient is
    dropped); n_out counts the head columns of the transformed dims only
    (2 per dim affine, 3K - 1 per dim spline), the only ones that reach lp
    or g. A Whiten costs its d x d product each way: 2 x 2 x d^2."""
    from tpuflows_torch.flows import RQSCouplingBlock, Standardize, Whiten

    total = 0
    for t in (() if model.flow is None else model.flow.transforms):
        if isinstance(t, Standardize):
            continue
        if isinstance(t, Whiten):
            total += 4 * t.loc.numel() ** 2
            continue
        n_in = sum(t.mask)
        per_dim = (3 * t.knots - 1 if isinstance(t, RQSCouplingBlock)
                   else 2)
        widths = [n_in, *(w.shape[1] for w in t.net.weights[:-1]),
                  per_dim * (len(t.mask) - n_in)]
        total += 4 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    return total


def state_inputs(state, seed=8, cpu_randomness=False, depth=MAX_DEPTH):
    """(q, eps, inv_mass, p0, dirs, u_acc, u_take) for timing K1 at a
    post-warmup state; the randomness is drawn on the card, or on the CPU
    (so that `--save-generic-state` can carry it to the JAX package)."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda

    dev = state.q.device
    q, eps, im = state.q.contiguous(), state.step_size, state.inv_mass
    n, d = q.shape
    if cpu_randomness:
        g = torch.Generator().manual_seed(seed)
        rnd = nuts_cuda.draw_randomness(g, n, d, depth, im.cpu())
        rnd = [t.to(dev) for t in rnd]
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        rnd = nuts_cuda.draw_randomness(g, n, d, depth, im)
    return (q, eps, im, *rnd)


def time_kernel(flow, state, n_reps=50, plain_reps=5, cpu_randomness=False,
                graph_reps=4, graph_replays=2):
    """K1 and its plain version at a main path's post-warmup state, timed
    with CUDA events on the same inputs, and the bound of the work; the two
    are held to K1's bar. For a flow with splines the spread of two plain
    versions on the same inputs (the streamed gradient and autograd through
    the whole flow) is measured too, and q is held to the larger of K1's
    bar and twice that spread: at the generic path's state float32
    reordering alone moves q by more than K1's bar, and the largest q
    difference of two such float32 evaluations over 1024 chains varies by
    up to twice from one pair to another (PERF.md, Findings). The tile
    kernel is also timed at each R of TILE_ROWS that fits, with its
    weights through the ring and, where they fit, resident,
    launched from the host and replayed from a CUDA graph, beside the
    per-warp module-list kernel (`tile_and_warp_times`), with the tile
    lockstep's efficiency at each R
    (`lockstep_efficiency`)."""
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.targets import NealsFunnel

    model = nuts_cuda.pack_flow(flow, NealsFunnel(dim=DIM))
    q, eps, im, *rnd = state_inputs(state, cpu_randomness=cpu_randomness)
    logp_grad = nuts_cuda.plain_logp_grad(model)

    ms, kern = timed(lambda: nuts_cuda.nuts_transition(
        q, *rnd, eps, im, model, MAX_DEPTH), n_reps)
    plain_ms, plain = timed(lambda: nuts_cuda.transition_math_torch(
        q, *rnd, eps, im, logp_grad, MAX_DEPTH), plain_reps,
        warmup=min(3, plain_reps))
    # the work this run's data needs: one gradient at q plus one per
    # leapfrog, each the MLPs' forward and input-gradient backward
    d = model.d
    leaves = float(kern[3].sum()) + N_CHAINS
    flops = leaves * mlp_flops(model)
    flow_floats = (sum(p.numel() for p in flow.parameters())
                   + d * sum(1 for t in flow.transforms
                             if hasattr(t, "mask")))
    n_in = (2 * N_CHAINS * d + 2 * N_CHAINS * MAX_DEPTH
            + N_CHAINS * (1 << MAX_DEPTH) + 1 + d + flow_floats)
    n_out = N_CHAINS * d + 7 * N_CHAINS
    nbytes = 4.0 * (n_in + n_out)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    out = {"ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes, "leapfrogs": leaves,
           "achieved_tflops": flops / (ms * 1e-3) / 1e12}
    max_dq = MAX_DQ
    if model.flow_p is not None:
        other = nuts_cuda.transition_math_torch(
            q, *rnd, eps, im, nuts_cuda.autograd_logp_grad(
                flow, model.target.log_density), MAX_DEPTH)
        out["plain_vs_plain_at_state"] = compare(plain, other)
        max_dq = max(MAX_DQ,
                     2.0 * out["plain_vs_plain_at_state"]["max_dq"])
    out["dq_bar"] = max_dq
    out["vs_plain_at_state"] = compare(plain, kern, max_dq)
    out.update(tile_and_warp_times(
        model, lambda R, resident: nuts_cuda._launch(
            q, *rnd, eps, im, model, MAX_DEPTH, rows=R, resident=resident),
        lambda: nuts_cuda.chain_transition_warp(q, *rnd, eps, im, model,
                                                MAX_DEPTH),
        tile_modes(model, TILE_ROWS), n_reps, graph_reps=graph_reps,
        graph_replays=graph_replays))
    for R, r in (*out["tile"].items(), *out["tile_resident"].items()):
        r["lockstep_efficiency"] = lockstep_efficiency(kern[3], R)
    out["lockstep_efficiency"] = out["tile"][out["rows"]][
        "lockstep_efficiency"]
    return out


# ---------------------------------------------------------------------------
# K3 and the portable samplers
# ---------------------------------------------------------------------------
# (label, flow, rows, z scale) of K3's comparison: the ceiling shape with a
# random non-zero head, the generic arqs shape with 0.01 x He heads, the
# other instantiations d = 32 and d = 256 (K = 16 there: 54 KB of shared
# memory per warp), affine and spline, and a ragged batch. Flows are drawn
# from seeds; the post-warmup states are added by `main`.
def fused_logp_rows(device):
    rows = [("ceiling", bench_flow_with_random_head(device, 2), TRAIN_BATCH),
            ("generic", spline_flow_with_random_heads(device, 74),
             TRAIN_BATCH),
            ("generic ragged", spline_flow_with_random_heads(device, 74), 37)]
    for d, h1, h2 in ((32, 32, 64), (256, 128, 256)):
        mask = tuple(j % 2 for j in range(d))
        rows.append((f"affine d={d}", random_flow(device, d + h1, d,
                                                  (h1, h2), mask), 256))
    for d, hidden, K, nb in ((32, (32, 64), 4, 2), (256, (64, 128), 16, 1)):
        rows.append((f"spline d={d} K={K}", spline_flow_with_random_heads(
            device, 10 + d, dim=d, hidden=hidden, knots=K, n_blocks=nb),
            256))
    return [(label, flow, n, None) for label, flow, n in rows]


def fused_logp_vs_plain(device, rows, by_row=False):
    """K3 against its plain version (`FusedLatentLogpAndGrad.plain`) on lp
    and g, under the spline kernels' bar (`judge`, or `judge_rows` with
    `by_row`, for a bf16 conditioner): a second float32
    evaluation is autograd through the whole flow on the CPU, and the
    referee the same in float64. `rows`: (label, flow, n, z) with z None
    for z ~ N(0, 1) drawn from a seed, and optionally the target, then
    read in both from the packed buffer (`nuts_cuda.packed_log_density`;
    without it the funnel of the flow's width, through its own
    `log_density`)."""
    import copy

    import torch
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.kernels.fused_logp_cuda import (
        fused_latent_logp_and_grad)
    from tpuflows_torch.targets import NealsFunnel

    out = []
    for i, (label, flow, n, z, *target) in enumerate(rows):
        d = flow.transforms[0].loc.numel()
        hook = fused_latent_logp_and_grad(*target or [NealsFunnel(dim=d)],
                                          flow)
        if z is None:
            g = torch.Generator(device=device).manual_seed(30 + i)
            z = torch.randn((n, d), generator=g, device=device)
        z = z.contiguous()
        kern = hook(z)
        plain = hook.plain(z)
        cpu32 = copy.deepcopy(flow).cpu()
        if max(getattr(t, "knots", 0) for t in cpu32.transforms) > 64:
            # past 64 knots the K4/K5 tier's pullback on the CPU (autograd
            # of the tile math's K-unrolled lists) took a minute an
            # evaluation at K = 1000: the second evaluation and the
            # referee run the oracle tier (`flows/rqs_ref.py`)
            for t in cpu32.transforms:
                if hasattr(t, "knots"):
                    t.use_pallas = False
        packed = hook.model.packed_target._replace(
            params=hook.model.packed_target.params.cpu())

        def log_density(x):  # the target as the kernel reads it
            return nuts_cuda.packed_log_density(packed, x)

        if not target:  # the funnel's own, as before targets were packed
            log_density = hook.model.target.log_density
        oracle = nuts_cuda.autograd_logp_grad(cpu32, log_density)(z.cpu())
        exact = nuts_cuda.autograd_logp_grad(cpu32.double(), log_density)(
            z.cpu().double())
        row = {"label": label, "n": int(z.shape[0]), "d": d,
               "modules": len(flow.transforms)}
        for j, name in enumerate(("lp", "g")):
            k = kern[j].reshape(plain[j].shape)
            o, e = (t[j].reshape(plain[j].shape).to(z.device)
                    for t in (oracle, exact))
            rule = judge_rows if by_row else judge
            row[name] = rule(k, plain[j], o, e, block_quantile(k.numel()))
        row["passed"] = row["lp"]["passed"] and row["g"]["passed"]
        out.append(row)
    return out


def main_path_portable(device, variant, flow, n_chains=N_CHAINS,
                       num_warmup=NUM_WARMUP, window=DRAW_WINDOW,
                       max_windows=MAX_WINDOWS, ess_gate=ESS_GATE):
    """Flow-preconditioned NUTS through the portable route:
    `NUTSDriver(log p~, max_depth, logp_and_grad=K3)` on a trained flow of
    `main_path`, under the main paths' gates. The launch counts are set to
    0 before: K3's must equal the hook calls the transitions counted (0 on
    the CPU), K1's stays 0, and K4/K5 (spline flows on the K4/K5 tier)
    launch only the data-space mapping's inverses."""
    import torch
    from tpuflows_torch.flows import RQSCouplingBlock
    from tpuflows_torch.kernels import (coupling_cuda, fused_logp_cuda,
                                        nuts_cuda, rqs_cuda)
    from tpuflows_torch.kernels.fused_logp_cuda import (
        fused_latent_logp_and_grad)
    from tpuflows_torch.mcmc import NUTSDriver, flow_reparameterized
    from tpuflows_torch.mcmc.preconditioned import _CHUNK
    from tpuflows_torch.targets import NealsFunnel

    on_card = torch.device(device).type == "cuda"
    dim = flow.transforms[0].loc.numel()
    target = NealsFunnel(dim=dim)
    n_rqs = sum(isinstance(t, RQSCouplingBlock) for t in flow.transforms)
    nuts_cuda.LAUNCHES = 0
    fused_logp_cuda.reset_launches()
    rqs_cuda.reset_launches()
    coupling_cuda.reset_launches()
    hook = fused_latent_logp_and_grad(target, flow)
    sampler = NUTSDriver(flow_reparameterized(target.log_density, flow),
                        max_depth=MAX_DEPTH, logp_and_grad=hook)
    gated, _, mapped_rows = nuts_gated(
        device, sampler, flow, target, f"{variant} portable", n_chains,
        num_warmup, window, max_windows, ess_gate)
    calls = sampler.transition.grad_calls
    n = gated["transitions"]
    seconds = gated["warmup_time_s"] + gated["draw_time_s"]
    inverse_calls = sum(-(-r // _CHUNK) for r in mapped_rows)
    k4_tier = any(isinstance(t, RQSCouplingBlock) and t.use_pallas != "fused"
                  for t in flow.transforms)
    per = n_rqs if on_card and k4_tier else 0
    return {
        "variant": variant, "hook": "K3 fused_latent_logp_and_grad",
        **gated, "ms_per_transition": 1e3 * seconds / n,
        "hook_calls": calls,
        "leaf_steps_per_transition": (calls - n) / n,
        "k3_launches": fused_logp_cuda.LAUNCHES,
        "k3_launches_expected": calls if on_card else 0,
        "k1_launches": nuts_cuda.LAUNCHES,
        "rqs_launches": dict(rqs_cuda.LAUNCHES),
        "rqs_launches_expected": {"k4_forward": 0,
                                  "k4_inverse": per * inverse_calls,
                                  "k5_forward": 0, "k5_inverse": 0},
        "coupling_launches": dict(coupling_cuda.LAUNCHES),
    }


def check_portable(res):
    name = f"{res['variant']} portable"
    if not res["converged"]:
        raise RuntimeError(f"{name}: convergence gate failed: max "
                           f"split-R-hat {res['max_rhat']}, min ESS "
                           f"{res['min_ess']}")
    if res["k3_launches"] != res["k3_launches_expected"]:
        raise RuntimeError(f"{name}: K3 launched {res['k3_launches']} "
                           f"times, the transitions called the hook "
                           f"{res['hook_calls']} times")
    if res["k1_launches"] != 0:
        raise RuntimeError(f"{name}: K1 launched {res['k1_launches']} "
                           f"times")
    if res["rqs_launches"] != res["rqs_launches_expected"] or any(
            res["coupling_launches"].values()):
        raise RuntimeError(f"{name}: K4/K5 launched {res['rqs_launches']} "
                           f"(expected {res['rqs_launches_expected']}), "
                           f"K6/K7 {res['coupling_launches']}")
    if not res["moment_check_passed"]:
        raise RuntimeError(f"{name}: v's draws fail the moment check: "
                           f"{res}")


def portable_vs_k1(flow, state, dq_bar, cpu_randomness=False):
    """One portable transition (`nuts_transition_math` with K3 as its
    gradient, the host-driven lockstep loop) against one K1 transition on
    the same inputs and randomness (`state_inputs`), under K1's bar with
    `dq_bar` for q."""
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.kernels.fused_logp_cuda import (
        fused_latent_logp_and_grad)
    from tpuflows_torch.mcmc.nuts import nuts_transition_math
    from tpuflows_torch.targets import NealsFunnel

    target = NealsFunnel(dim=state.q.shape[1])
    model = nuts_cuda.pack_flow(flow, target)
    hook = fused_latent_logp_and_grad(target, flow)
    q, eps, im, *rnd = state_inputs(state, cpu_randomness=cpu_randomness)
    k1 = nuts_cuda.nuts_transition(q, *rnd, eps, im, model, MAX_DEPTH)
    port = nuts_transition_math(q, *rnd, eps, im, hook, MAX_DEPTH)
    res = compare(k1, port, dq_bar)
    res["dq_bar"] = dq_bar
    return res


HMC_LEAPFROGS = 10


def hmc_vs_plain(flow, state, seed=9):
    """`make_hmc_kernel`'s transition with K3 as its gradient against the
    same transition with K3's plain version, on the same momenta and
    uniforms: at most MAX_FLIPS of 1024 chains with another accept
    decision, q within MAX_DQ on the rest."""
    import torch
    from tpuflows_torch.kernels.fused_logp_cuda import (
        fused_latent_logp_and_grad)
    from tpuflows_torch.mcmc.hmc import hmc_transition_math
    from tpuflows_torch.targets import NealsFunnel

    hook = fused_latent_logp_and_grad(NealsFunnel(dim=state.q.shape[1]),
                                      flow)
    q, eps, im = state.q.contiguous(), state.step_size, state.inv_mass
    g = torch.Generator(device=q.device).manual_seed(seed)
    p0 = torch.randn(q.shape, generator=g, device=q.device) / torch.sqrt(im)
    u = torch.rand(q.shape[0], generator=g, device=q.device)
    kq, kinfo = hmc_transition_math(q, p0, u, eps, im, hook, HMC_LEAPFROGS)
    pq, pinfo = hmc_transition_math(q, p0, u, eps, im, hook.plain,
                                    HMC_LEAPFROGS)
    flip = kinfo.accepted != pinfo.accepted
    agree = ~flip
    dq = (kq - pq).abs().amax(dim=1)
    n = int(q.shape[0])
    res = {"chains": n, "leapfrogs": HMC_LEAPFROGS, "flips": int(flip.sum()),
           "accept_rate": float(pinfo.accepted.float().mean()),
           "max_dq": float(dq[agree].max()) if bool(agree.any())
           else float("nan"),
           "max_dlogp": float((kinfo.logp - pinfo.logp).abs()[agree].max())
           if bool(agree.any()) else float("nan")}
    res["passed"] = bool(res["flips"] <= max(1, n * MAX_FLIPS // 1024)
                         and res["max_dq"] <= MAX_DQ
                         and bool(torch.isfinite(kq).all()))
    return res


def time_fused_logp(flow, state, k1_ms, n_reps=100, plain_reps=10,
                    trans_reps=5, cpu_randomness=False):
    """K3 at a post-warmup state (z = the chains' q) with CUDA events,
    launched from the host and replayed from a CUDA graph (`graph_ms`),
    beside its bound and its plain version; and one portable transition
    (the host-driven lockstep loop with K3) on the inputs `time_kernel`
    timed K1 on, beside that time `k1_ms`. The tile kernel is also timed
    in each mode of `tile_modes` (each R of TILE_ROWS that fits, the ring
    and, for a flow with one coupling, the resident weights), beside the
    per-warp module-list kernel (`tile_and_warp_times`)."""
    from tpuflows_torch.kernels import fused_logp_cuda
    from tpuflows_torch.kernels.fused_logp_cuda import (
        fused_latent_logp_and_grad)
    from tpuflows_torch.mcmc.nuts import nuts_transition_math
    from tpuflows_torch.targets import NealsFunnel

    target = NealsFunnel(dim=state.q.shape[1])
    hook = fused_latent_logp_and_grad(target, flow)
    model = hook.model
    z = state.q.contiguous()
    n, d = z.shape
    ms, _ = timed(lambda: hook(z), n_reps)
    plain_ms, _ = timed(lambda: hook.plain(z), plain_reps)
    # the work: each row's MLPs, forward and input-gradient backward; the
    # bytes: z in, lp and g out, the flow's parameters and masks once
    flops = float(n * mlp_flops(model))
    flow_floats = (sum(p.numel() for p in flow.parameters())
                   + d * sum(1 for t in flow.transforms
                             if hasattr(t, "mask")))
    nbytes = 4.0 * (n * d + flow_floats + n + n * d)
    bound_ms, bound_by = _bound(flops, nbytes)
    q, eps, im, *rnd = state_inputs(state, cpu_randomness=cpu_randomness)

    def transition(logp_and_grad):
        return timed(lambda: nuts_transition_math(
            q, *rnd, eps, im, logp_and_grad, MAX_DEPTH), trans_reps,
            warmup=1)[0]

    out = {"n": n, "d": d, "ms": ms, "device_ms": graph_ms(lambda: hook(z)),
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "flops": flops, "bytes": nbytes,
           "k1_transition_ms": k1_ms}
    out["portable_transition_ms"] = transition(hook)
    out.update(tile_and_warp_times(
        model, lambda R, res: fused_logp_cuda._launch(z, model, rows=R,
                                                      resident=res),
        lambda: fused_logp_cuda.chain_logp_grad_warp(z, model),
        tile_modes(model, TILE_ROWS), n_reps))
    out["earlier"] = "per-warp module-list kernel"
    return out


# ---------------------------------------------------------------------------
# The tile gradient: K1's and K3's module-list kernels against the per-warp
# kernels they replaced
# ---------------------------------------------------------------------------
# tile rows R measured where the tile fits in SMEM_LIMIT (both kernels take
# at most nuts_cuda.MAX_TILE_ROWS: 8 warps of up to 255 registers)
TILE_ROWS = (4, 8)
# (d, hidden, knots, blocks, max_depth, eps, chains) of tile_vs_warp's row
# whose 201,728 bytes of scratch a row leave no room for the 96 KB weight
# ring: R = 1, on a ring of 3 x 10 KB (`nuts_cuda.ring_stage_floats`)
SMALL_RING_SHAPE = (256, (64, 128), 64, 1, 4, 0.1, 128)
K1_OUTS = ("q", "lp", "sum_accept", "n_steps", "depth", "diverging",
           "turning", "h0")
K2_OUTS = ("draws", "lp", "accept", "n_steps", "depth", "diverging",
           "turning", "h0")
# chains of tile_vs_warp's ragged K2 row: a last tile of 3 chains at R = 4
# and 8, whose padding rows must stay in every slot's barriers
RAGGED_CHAINS = 1003


def fitting_rows(model, candidates):
    """The tile rows of `candidates` whose tile fits in a block with a
    weight ring (`nuts_cuda.ring_stage_floats`), and the wrappers' default
    (`nuts_cuda.tile_rows`)."""
    from tpuflows_torch.kernels import nuts_cuda

    return sorted({r for r in candidates
                   if nuts_cuda.ring_stage_floats(model, r) > 0}
                  | {nuts_cuda.tile_rows(model)})


def tile_modes(model, candidates):
    """(R, resident) of every tile launch of K1 and K2 to measure: the
    ring at each R of `fitting_rows`, and the resident weights where they
    fit at that R (`nuts_cuda.resident_fits`)."""
    from tpuflows_torch.kernels import nuts_cuda

    return [(R, res) for R in fitting_rows(model, candidates)
            for res in (False, True)
            if not res or nuts_cuda.resident_fits(model, R)]


def mode_label(R, resident):
    return f"R={R} {'resident' if resident else 'ring'}"


def value_diff(a, b):
    """(elements of a and b that differ in value, NaN counting as equal to
    NaN; elements equal in value whose bits differ, which can only be a
    zero's sign; the largest |a - b|). The tile kernels leave out products
    with a zero factor and terms multiplied by zero (csrc/tile_grad.cuh),
    which can change only the sign of a zero."""
    import torch

    a, b = a.contiguous(), b.contiguous()
    nan = torch.isnan(a) & torch.isnan(b)
    same = (a == b) | nan
    bits = a.view(torch.int32) != b.view(torch.int32)
    gap = (a.double() - b.double()).abs()[~nan]
    return (int((~same).sum()), int((same & bits).sum()),
            float(gap.max()) if gap.numel() else 0.0)


def lockstep_efficiency(n_steps, rows):
    """Useful latent gradients (one per chain at its start, one per
    leapfrog) over the row gradients a tile lockstep of `rows` chains
    computes for the same transition (n_steps (n,):
    `nuts_cuda.lockstep_gradients`) or window (n_steps (S, n), one
    gradient per chain at the window's start:
    `nuts_window_cuda.window_lockstep_gradients`)."""
    from tpuflows_torch.kernels import nuts_cuda, nuts_window_cuda

    count = (nuts_window_cuda.window_lockstep_gradients if n_steps.ndim == 2
             else nuts_cuda.lockstep_gradients)
    useful = float(n_steps.sum()) + n_steps.shape[-1]
    return useful / (rows * count(n_steps, rows))


def tile_and_warp_times(model, tile_fn, warp_fn, modes, n_reps,
                        graph_reps=20, graph_replays=10, warp_turns=2):
    """A kernel's tile version at each (R, resident) of `modes`
    (`tile_fn(R, resident)`: the ring at each R that fits, and for K1 and
    K2 the resident weights where they fit, `tile_modes`) and the
    per-warp kernel it replaced (`warp_fn()`), each launched from the host
    (`timed`) and replayed from a CUDA graph (`graph_ms`), on the same
    inputs, in turns: warp, tiles, warp (warp, tiles with `warp_turns`
    1). `tile` holds the ring's times by R, `tile_resident` the resident
    weights'; `tile_device_ms` is the mode the wrappers take (`rows`,
    `resident`)."""
    from tpuflows_torch.kernels import nuts_cuda

    def both(fn):
        return {"ms": timed(fn, n_reps)[0],
                "device_ms": graph_ms(fn, reps=graph_reps,
                                      replays=graph_replays)}

    first = both(warp_fn)
    times = {m: both(lambda m=m: tile_fn(*m)) for m in modes}
    last = both(warp_fn) if warp_turns > 1 else first
    rows = nuts_cuda.tile_rows(model)
    resident = nuts_cuda.launch_resident(model, rows) > 0
    warp = {k: 0.5 * (first[k] + last[k]) for k in first}
    out = {"rows": rows, "resident": resident,
           "tile": {R: t for (R, r), t in times.items() if not r},
           "tile_resident": {R: t for (R, r), t in times.items() if r},
           "warp_ms": warp["ms"], "warp_device_ms": warp["device_ms"],
           "warp_runs": [first, last],
           "tile_ms": times[rows, resident]["ms"],
           "tile_device_ms": times[rows, resident]["device_ms"]}
    out["speedup_device"] = warp["device_ms"] / out["tile_device_ms"]
    if out["tile_resident"]:
        out["resident_vs_ring_device"] = {
            R: out["tile"][R]["device_ms"] / t["device_ms"]
            for R, t in out["tile_resident"].items()}
    return out


def k1_tile_vs_warp(flow, q, im, rnd, eps, depth, target=None,
                    candidates=TILE_ROWS):
    """K1's tile kernel (`nuts_cuda._launch(..., rows=R, resident=...)`)
    at each R of TILE_ROWS that fits, with the ring and, where they fit,
    the resident weights (`tile_modes`), against the per-warp module-list
    kernel on the same inputs: per mode, the elements of the eight outputs
    whose bits differ (expected 0) and the largest difference, K1's flips
    and max dq between the two (`compare`), and the tile lockstep's
    efficiency. `target`: the funnel of q's width unless given."""
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.targets import NealsFunnel

    model = nuts_cuda.pack_flow(flow, target or NealsFunnel(dim=q.shape[1]))
    warp = nuts_cuda.chain_transition_warp(q, *rnd, eps, im, model, depth)
    out = {"chains": int(q.shape[0]), "d": int(q.shape[1]),
           "default_rows": nuts_cuda.tile_rows(model), "rows": {}}
    for R, resident in tile_modes(model, candidates):
        tile = nuts_cuda._launch(q, *rnd, eps, im, model, depth, rows=R,
                                 resident=resident)
        diffs = {k: value_diff(t, w)
                 for k, t, w in zip(K1_OUTS, tile, warp)}
        c = compare(warp, tile)
        out["rows"][mode_label(R, resident)] = {
            "differ": sum(v[0] for v in diffs.values()),
            "zero_signs": sum(v[1] for v in diffs.values()),
            "max_abs": max(v[2] for v in diffs.values()),
            "differ_by_output": {k: v[0] for k, v in diffs.items()},
            "flips": c["flips"], "max_dq": c["max_dq"],
            "lockstep_efficiency": lockstep_efficiency(warp[3], R),
            "ring_stage_floats": nuts_cuda.ring_stage_floats(model, R)}
    return out


def k3_tile_vs_warp(flow, z, target=None, candidates=TILE_ROWS):
    """K3's tile kernel (`fused_logp_cuda._launch(z, model, rows=R,
    resident=...)`) in every mode of `tile_modes` (the affine flow's
    resident weights included) against the per-warp module-list kernel on
    the same z: per mode, the elements of lp and g whose bits differ
    (expected 0) and the largest difference."""
    from tpuflows_torch.kernels import fused_logp_cuda, nuts_cuda
    from tpuflows_torch.kernels.fused_logp_cuda import (
        fused_latent_logp_and_grad)
    from tpuflows_torch.targets import NealsFunnel

    hook = fused_latent_logp_and_grad(target or NealsFunnel(dim=z.shape[1]),
                                      flow)
    warp = fused_logp_cuda.chain_logp_grad_warp(z, hook.model)
    out = {"n": int(z.shape[0]), "d": int(z.shape[1]),
           "default_rows": nuts_cuda.tile_rows(hook.model), "rows": {}}
    for R, resident in tile_modes(hook.model, candidates):
        tile = fused_logp_cuda._launch(z, hook.model, rows=R,
                                       resident=resident)
        diffs = {k: value_diff(t, w)
                 for k, t, w in zip(("lp", "g"), tile, warp)}
        out["rows"][mode_label(R, resident)] = {
            "differ": sum(v[0] for v in diffs.values()),
            "zero_signs": sum(v[1] for v in diffs.values()),
            "max_abs": max(v[2] for v in diffs.values()),
            "differ_by_output": {k: v[0] for k, v in diffs.items()},
            "ring_stage_floats": nuts_cuda.ring_stage_floats(hook.model,
                                                             R)}
    return out


def k2_tile_vs_warp(flow, q, im, rnd, eps, depth, window, target=None,
                    candidates=TILE_ROWS):
    """K2's tile kernel (`nuts_window_cuda._launch(..., rows=R,
    resident=...)`) in every mode of `tile_modes` against the per-warp
    module-list window (`chain_window_warp`) on the same inputs: per mode,
    the elements of the draws and the seven info outputs that differ in
    value (expected 0), the largest difference, and the tile lockstep's
    efficiency over the window."""
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.kernels import nuts_window_cuda as nw
    from tpuflows_torch.targets import NealsFunnel

    model = nuts_cuda.pack_flow(flow, target or NealsFunnel(dim=q.shape[1]))
    warp = nw.chain_window_warp(q, *rnd, eps, im, model, depth, window)
    out = {"chains": int(q.shape[0]), "d": int(q.shape[1]),
           "window": window, "default_rows": nuts_cuda.tile_rows(model),
           "rows": {}}
    for R, resident in tile_modes(model, candidates):
        tile = nw._launch(q, *rnd, eps, im, model, depth, window, None,
                          rows=R, resident=resident)
        diffs = {k: value_diff(t, w)
                 for k, t, w in zip(K2_OUTS, tile, warp)}
        out["rows"][mode_label(R, resident)] = {
            "differ": sum(v[0] for v in diffs.values()),
            "zero_signs": sum(v[1] for v in diffs.values()),
            "max_abs": max(v[2] for v in diffs.values()),
            "differ_by_output": {k: v[0] for k, v in diffs.items()},
            "lockstep_efficiency": lockstep_efficiency(warp[3], R),
            "ring_stage_floats": nuts_cuda.ring_stage_floats(model, R)}
    return out


def tile_vs_warp(device, k1_states=(), k3_states=(), k2_states=()):
    """Phase tile_vs_warp: K1 on every row of `kernel_shapes` (the affine
    flows at d = 32..256, their inputs rebuilt from their seeds) and every
    module-list row of `kernel_vs_plain_spline`, and on `k1_states`
    ((label, flow, NUTSState)); K3 on every row of `fused_logp_rows`, the
    affine flows included (z ~ N(0, 1) from a seed), and on `k3_states`
    ((label, flow, z)); K2 on every row of
    `window_rows` (its flows, starts and window randomness), on its bench
    row and its first spline row at a chain count that no tile divides
    (RAGGED_CHAINS), and on `k2_states` ((label, flow, NUTSState), windows
    of WINDOW_SLOTS on the randomness of its `window_vs_plain` row); all
    three on SMALL_RING_SHAPE (q ~ N(0, 1) as `kernel_vs_plain_spline`
    draws it; K2 on a window of 4). K1, K2 and K3 run every mode of
    `tile_modes` (the ring, and the resident weights where they fit).
    Every row passes when the tile kernel equals the per-warp module-list
    kernel in value in every mode measured."""
    import torch

    rows = []
    for d, h1, h2, depth, eps, n, scheme in OTHER_SHAPES:
        flow = shape_flow(device, d, h1, h2, scheme)
        q, im, *rnd = card_inputs(device, n, d, depth, d + h2, False)
        res = k1_tile_vs_warp(flow, q, im, rnd,
                              torch.tensor(eps, device=device), depth)
        rows.append({"kernel": "K1", "label": f"affine d={d} h={h1},{h2} "
                     f"{scheme}", **res})
    for d, hidden, K, nb, depth, eps, n, unit, head in (
            *SPLINE_SHAPES, SPLINE_CHAOS_SHAPE):
        flow = spline_flow_with_random_heads(device, 10 + d, dim=d,
                                             hidden=hidden, knots=K,
                                             n_blocks=nb, head=head)
        q, im, *rnd = spline_inputs(device, n, d, depth, 20 + d, unit)
        res = k1_tile_vs_warp(flow, q, im, rnd,
                              torch.tensor(eps, device=device), depth)
        rows.append({"kernel": "K1", "label": f"spline d={d} K={K} "
                     f"head={head}", **res})
    for label, flow, state in k1_states:
        q, eps, im, *rnd = state_inputs(state, cpu_randomness=True)
        rows.append({"kernel": "K1", "label": label,
                     **k1_tile_vs_warp(flow, q, im, rnd, eps, MAX_DEPTH)})
    for i, (label, flow, n, _) in enumerate(fused_logp_rows(device)):
        d = flow.transforms[0].loc.numel()
        g = torch.Generator(device=device).manual_seed(30 + i)
        z = torch.randn((n, d), generator=g, device=device)
        rows.append({"kernel": "K3", "label": label,
                     **k3_tile_vs_warp(flow, z)})
    for label, flow, z in k3_states:
        rows.append({"kernel": "K3", "label": label,
                     **k3_tile_vs_warp(flow, z.contiguous())})
    d, hidden, K, nb, depth, eps, n = SMALL_RING_SHAPE
    flow = spline_flow_with_random_heads(device, 10 + K, dim=d,
                                         hidden=hidden, knots=K,
                                         n_blocks=nb)
    q, im, *rnd = spline_inputs(device, n, d, depth, 20 + K, False)
    label = f"spline d={d} K={K}, small ring"
    rows.append({"kernel": "K1", "label": label, **k1_tile_vs_warp(
        flow, q, im, rnd, torch.tensor(eps, device=device), depth)})
    rows.append({"kernel": "K3", "label": label,
                 **k3_tile_vs_warp(flow, q)})
    rnd = window_randomness(device, n, d, 4, depth, im, 20 + K)
    rows.append({"kernel": "K2", "label": label, **k2_tile_vs_warp(
        flow, q, im, rnd, torch.tensor(eps, device=device), depth, 4)})
    wrows = window_rows(device)
    ragged = [(f"{label}, {RAGGED_CHAINS} chains", flow,
               q[:RAGGED_CHAINS].contiguous(), im, eps, depth, S, seed)
              for label, flow, q, im, eps, depth, S, seed in (
                  wrows[0], next(r for r in wrows
                                 if r[0].startswith("spline")))]
    for label, flow, q, im, eps, depth, S, seed in (*wrows, *ragged):
        n, d = q.shape
        rnd = window_randomness(device, n, d, S, depth, im, seed)
        rows.append({"kernel": "K2", "label": label, **k2_tile_vs_warp(
            flow, q, im, rnd, torch.tensor(eps, device=device), depth, S)})
    for label, flow, state in k2_states:
        q, im = state.q.contiguous(), state.inv_mass
        rnd = window_randomness(device, *q.shape, WINDOW_SLOTS, MAX_DEPTH,
                                im, 8)
        rows.append({"kernel": "K2", "label": label, **k2_tile_vs_warp(
            flow, q, im, rnd, state.step_size, MAX_DEPTH, WINDOW_SLOTS)})
    for r in rows:
        r["passed"] = bool(r["rows"]) and all(
            x["differ"] == 0 for x in r["rows"].values())
    return rows


# ---------------------------------------------------------------------------
# K2: the streaming draw window
# ---------------------------------------------------------------------------
def window_randomness(device, n, d, window, depth, inv_mass, seed):
    """A window's randomness (`draw_window_randomness`), drawn on the CPU
    from `seed` and moved to `device`."""
    import torch
    from tpuflows_torch.mcmc.nuts import draw_window_randomness

    g = torch.Generator().manual_seed(seed)
    rnd = draw_window_randomness(g, n, d, window, depth, inv_mass.cpu())
    return [t.to(device) for t in rnd]


def compare_window(ref, kern, max_dq=MAX_DQ, max_denergy=MAX_DENERGY,
                   max_flips=None):
    """K1's bar on every slot of a window (`nuts_window`'s returns) whose
    reference `ref` ran each slot from `kern`'s own previous draw
    (`chain_slots(..., starts=kern[0])`): each slot is then one transition
    from the same state on the same randomness, judged on its own, and
    rounding differences cannot carry from slot to slot. In a slot a chain
    flips if it differs in leapfrog count, depth, divergence or U-turn, or
    if its draw differs by more than 1e-3 (a flipped proposal, as
    `compare` counts them); at most `max_flips` chains may flip in any
    slot (K1's 5 of 1024 by default), and on every other (slot, chain)
    the energy agrees to `max_denergy` and the draw to `max_dq`. Also: the
    flips and the largest |dq| per slot, the share of (slot, chain) pairs
    the maxima cover, the slots whose energies are equal to the bit (a
    slot's energy is -lp + kinetic energy at its start, so this shows
    whether the lp carried from the previous slot equals the reference's
    lp there), and whether the two windows are equal to the bit."""
    import torch

    dq = (ref[0] - kern[0]).abs().amax(dim=2)  # (S, n)
    decided = torch.zeros_like(ref[1], dtype=torch.bool)
    for i in (3, 4, 5, 6):
        decided |= ref[i] != kern[i]
    flip = decided | (dq > 1e-3)
    agree = ~flip
    S, n = ref[1].shape

    def worst(x):
        return float(x[agree].max()) if bool(agree.any()) \
            else float("nan")

    res = {"chains": n, "window": S,
           "flips_per_slot": flip.sum(dim=1).tolist(),
           "flips_by_q_only": int((flip & ~decided).sum()),
           "chains_with_a_flip": int(flip.any(dim=0).sum()),
           "divergent_transitions": int((ref[5] > 0.5).sum()),
           "max_dq_per_slot": [float(r[m].max()) if bool(m.any())
                               else float("nan")
                               for r, m in zip(dq, agree)],
           "max_dq": worst(dq),
           "covers": float(agree.float().mean()),
           "max_denergy": worst((ref[7] - kern[7]).abs()),
           "max_dlogp": worst((ref[1] - kern[1]).abs()),
           "energy_equal_per_slot": [bool(torch.equal(a, b))
                                     for a, b in zip(ref[7], kern[7])],
           "bitwise": all(torch.equal(a, b) for a, b in zip(ref, kern))}
    res["flips"] = max(res["flips_per_slot"])
    if max_flips is None:
        max_flips = max(1, n * MAX_FLIPS // 1024)
    res["passed"] = bool(res["flips"] <= max_flips
                         and not res["max_denergy"] > max_denergy
                         and not res["max_dq"] > max_dq)
    return res


def window_bar(spreads, n):
    """The bar of a slot-by-slot K2 comparison from the spread of plain
    versions on the same slots (`spreads`: `compare_window` results of
    pairs of plain versions): K1's bar, or twice the widest spread where
    that is larger, for the flips in a slot, the energy and q (the rule of
    K1's bar at the generic state, PERF.md)."""
    def twice(key):
        vals = [r[key] for r in spreads if not math.isnan(r[key])]
        return 2.0 * max(vals, default=0.0)

    return {"max_flips": max(max(1, n * MAX_FLIPS // 1024),
                             int(twice("flips"))),
            "max_denergy": max(MAX_DENERGY, twice("max_denergy")),
            "max_dq": max(MAX_DQ, twice("max_dq"))}


def window_rows(device):
    """(label, flow, q, inv_mass, eps, depth, window, seed) of the K2
    comparison on seeded flows: the bench widths (phase 4's flow) at
    S = 4, the seeded arqs flow of phase 5 at S = 2, and both kernels at
    d = 32 and d = 256 (S = 4, and 2 for the splines; 8 and 4 before the
    target library's phase took the time), all at eps WINDOW_EPS; the
    post-warmup states, added by `main`, hold the main path's S = 32."""
    import torch

    def start(n, d, seed, unit):
        g = torch.Generator().manual_seed(seed)
        q = torch.randn((n, d), generator=g)
        im = torch.ones(d) if unit else 0.5 + torch.rand(d, generator=g)
        return q.to(device), im.to(device)

    rows = [("bench", bench_flow_with_random_head(device, 2),
             *start(N_CHAINS, DIM, 3, True), WINDOW_EPS, MAX_DEPTH, 4, 31),
            ("spline bench", spline_flow_with_random_heads(device, 10 + DIM),
             *start(N_CHAINS, DIM, 20 + DIM, True), WINDOW_EPS, MAX_DEPTH, 2,
             32)]
    for d, h1, h2, depth, eps, n, S in ((32, 32, 64, 5, 0.1, 256, 4),
                                        (256, 128, 256, 4, 0.1, 128, 4)):
        mask = tuple(j % 2 for j in range(d))
        rows.append((f"affine d={d}", random_flow(device, d + h1, d,
                                                  (h1, h2), mask),
                     *start(n, d, 40 + d, False), eps, depth, S, 41 + d))
    for d, hidden, K, nb, depth, eps, n, S in (
            (32, (32, 64), 4, 2, 5, 0.1, 256, 2),
            (256, (64, 128), 16, 1, 4, 0.1, 128, 2)):
        rows.append((f"spline d={d} K={K}", spline_flow_with_random_heads(
            device, 10 + d, dim=d, hidden=hidden, knots=K, n_blocks=nb),
            *start(n, d, 50 + d, False), eps, depth, S, 51 + d))
    return rows


def window_vs_plain(device, rows, full_plain=False, checked_slots=None):
    """K2, held slot by slot: each slot s of its window against one
    transition from K2's own draw of slot s - 1 on slot s's columns
    (`chain_slots(..., starts=...)`), by K1, by the plain window
    (`window_math_torch`, one slot per call) and by K1's plain version
    (`transition_math_torch`), under `compare_window` with `window_bar`:
    K1's bar in every slot, or twice the widest spread of two plain
    versions on the same slots where that is larger (the plain window
    against K1's plain version and, on spline flows, K1's plain version
    against the same with the whole flow's autograd gradient, as K1's bar
    at the generic state). Whether K2 meets K1's bar itself against its
    plain version is printed too, and how far K1 itself is from the plain
    window on the same slots (not gated: K1 has its own phases). With
    `full_plain` the plain window also
    runs the whole window from q (its time is the plain version's time in
    `timing_window`), and how far the two free-running windows part, slot
    by slot, is printed (not gated). `checked_slots` holds only the first
    that many slots of each window slot by slot (K2 still runs the whole
    window, and the free-running plain window too). Each call is timed
    once with CUDA events on the card. A row may end with its target (the
    funnel of q's width when it does not)."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.kernels import nuts_window_cuda as nw
    from tpuflows_torch.targets import NealsFunnel

    on_card = torch.device(device).type == "cuda"

    def once(fn):
        if on_card:
            return timed(fn, 1, warmup=0)
        t = time.perf_counter()
        out = fn()
        return 1e3 * (time.perf_counter() - t), out

    out = []
    for label, flow, q, im, eps, depth, S, seed, *target in rows:
        n, d = q.shape
        model = nuts_cuda.pack_flow(flow, *target or [NealsFunnel(dim=d)])
        rnd = window_randomness(device, n, d, S, depth, im, seed)
        e = torch.as_tensor(eps, dtype=torch.float32, device=device)
        logp_grad = nuts_cuda.plain_logp_grad(model)
        kernel_ms, kern = once(lambda: nw.nuts_window(
            q, *rnd, e, im, model, depth, S))
        for t in kern:
            if not bool(torch.isfinite(t).all()):
                raise RuntimeError(f"K2 returned non-finite values ({label})")

        def one_slot(z, *r):
            # the plain window of one slot, its accept statistic summed
            # again as the per-transition calls return it
            w = nw.window_math_torch(z, *r, e, im, logp_grad, 1, depth)
            w = [x[0] for x in w]
            w[2] = w[2] * torch.clamp(w[3], min=1.0)
            return w

        checked = S if checked_slots is None else min(S, checked_slots)
        window = kern
        kern = [t[:checked] for t in window]

        def slots(step):
            return nw.chain_slots(step, q, *rnd, checked, depth,
                                  starts=kern[0])

        k1 = slots(lambda z, *r: nuts_cuda.nuts_transition(
            z, *r, e, im, model, depth))
        plain_ms, plain = once(lambda: slots(one_slot))
        transition = slots(lambda z, *r: nuts_cuda.transition_math_torch(
            z, *r, e, im, logp_grad, depth))
        spreads = {"plain_spread": compare_window(
            transition, plain, math.inf, math.inf, math.inf)}
        if model.flow_p is not None:  # the whole flow's autograd gradient
            other = slots(lambda z, *r: nuts_cuda.transition_math_torch(
                z, *r, e, im, nuts_cuda.autograd_logp_grad(
                    flow, model.target.log_density), depth))
            spreads["autograd_spread"] = compare_window(
                transition, other, math.inf, math.inf, math.inf)
        bar = window_bar(list(spreads.values()), n)
        vs_plain = compare_window(plain, kern, **bar)
        vs_plain["passed_at_k1_bar"] = compare_window(plain, kern)["passed"]
        row = {"label": label, "n": n, "d": d, "window": S,
               "checked_slots": checked, "max_depth": depth,
               "eps": float(eps), "bar": bar, "vs_plain": vs_plain,
               "vs_transition": compare_window(transition, kern, **bar),
               "vs_k1": compare_window(k1, kern, **bar),
               "k1_vs_plain": compare_window(plain, k1, math.inf, math.inf,
                                             math.inf),
               **spreads, "kernel_ms": kernel_ms,
               "plain_slots_ms": plain_ms,
               "depth_histogram": torch.bincount(
                   window[4].long().flatten(), minlength=depth + 1).tolist(),
               "divergent_transitions": int(window[5].sum())}
        if full_plain:
            row["plain_window_ms"], free = once(lambda: nw.window_math_torch(
                q, *rnd, e, im, logp_grad, S, depth))
            row["free_running_vs_plain"] = compare_window(
                free, window, math.inf, math.inf, math.inf)
        bits = {k: value_diff(a, b) for k, a, b in zip(K2_OUTS, kern, k1)}
        row["bitwise_k1"] = sum(v[0] + v[1] for v in bits.values())
        row["bitwise_k1_by_output"] = {k: v[0] + v[1]
                                       for k, v in bits.items()}
        row["passed"] = all(row[k]["passed"] for k in
                            ("vs_plain", "vs_transition", "vs_k1"))
        out.append(row)
    return out


def main_path_window(device, variant, flow, n_chains=N_CHAINS,
                     num_warmup=NUM_WARMUP, window=DRAW_WINDOW,
                     max_windows=MAX_WINDOWS, ess_gate=ESS_GATE,
                     slots=WINDOW_SLOTS):
    """bench.py's window path on a trained flow of `main_path`:
    `NUTSDriver(transition=K1, window_transition=K2)`, warmup through K1
    and draws through K2 in windows of `slots` transitions, under the main
    paths' gates. The launch counts are set to 0 before: K1's must equal
    the warmup steps, K2's the draws / `slots` (0 on the CPU), and K4/K5
    (spline flows on the K4/K5 tier) launch only the data-space mapping's
    inverses. `k2_tile_rows` is the R of K2's tile kernel, `k2_resident`
    whether its weights stay resident in shared memory."""
    import torch
    from tpuflows_torch.flows import RQSCouplingBlock
    from tpuflows_torch.kernels import (coupling_cuda, nuts_cuda,
                                        nuts_window_cuda, rqs_cuda)
    from tpuflows_torch.mcmc import NUTSDriver
    from tpuflows_torch.mcmc.preconditioned import _CHUNK
    from tpuflows_torch.targets import NealsFunnel

    on_card = torch.device(device).type == "cuda"
    dim = flow.transforms[0].loc.numel()
    target = NealsFunnel(dim=dim)
    nuts_cuda.LAUNCHES = 0
    nuts_window_cuda.LAUNCHES = 0
    rqs_cuda.reset_launches()
    coupling_cuda.reset_launches()
    window_transition = nuts_window_cuda.fused_nuts_window_for_flow(
        target, flow, window=slots, max_depth=MAX_DEPTH)
    sampler = NUTSDriver(
        transition=nuts_cuda.fused_nuts_for_flow(target, flow,
                                                 max_depth=MAX_DEPTH),
        window_transition=window_transition)
    gated, _, mapped_rows = nuts_gated(
        device, sampler, flow, target, f"{variant} window", n_chains,
        num_warmup, window, max_windows, ess_gate)
    inverse_calls = sum(-(-r // _CHUNK) for r in mapped_rows)
    k4_tier = any(isinstance(t, RQSCouplingBlock) and t.use_pallas != "fused"
                  for t in flow.transforms)
    n_rqs = sum(isinstance(t, RQSCouplingBlock) for t in flow.transforms)
    per = n_rqs if on_card and k4_tier else 0
    return {
        "variant": variant, "window_slots": slots, **gated,
        "warmup_ms_per_transition": 1e3 * gated["warmup_time_s"]
        / num_warmup,
        "draw_ms_per_transition": 1e3 * gated["draw_time_s"]
        / gated["n_draws"],
        "k1_launches": nuts_cuda.LAUNCHES,
        "k1_launches_expected": num_warmup if on_card else 0,
        "k2_launches": nuts_window_cuda.LAUNCHES,
        "k2_launches_expected": gated["n_draws"] // slots if on_card else 0,
        "k2_tile_rows": nuts_cuda.launch_rows(window_transition.model),
        "k2_resident": nuts_cuda.launch_resident(
            window_transition.model,
            nuts_cuda.launch_rows(window_transition.model)) > 0,
        "rqs_launches": dict(rqs_cuda.LAUNCHES),
        "rqs_launches_expected": {"k4_forward": 0,
                                  "k4_inverse": per * inverse_calls,
                                  "k5_forward": 0, "k5_inverse": 0},
        "coupling_launches": dict(coupling_cuda.LAUNCHES),
    }


def check_window(res):
    name = f"{res['variant']} window"
    if not res["converged"]:
        raise RuntimeError(f"{name}: convergence gate failed: max "
                           f"split-R-hat {res['max_rhat']}, min ESS "
                           f"{res['min_ess']}")
    for k in ("k1", "k2"):
        if res[f"{k}_launches"] != res[f"{k}_launches_expected"]:
            raise RuntimeError(f"{name}: {k.upper()} launched "
                               f"{res[f'{k}_launches']} times, the path "
                               f"implies {res[f'{k}_launches_expected']}")
    if res["rqs_launches"] != res["rqs_launches_expected"] or any(
            res["coupling_launches"].values()):
        raise RuntimeError(f"{name}: K4/K5 launched {res['rqs_launches']} "
                           f"(expected {res['rqs_launches_expected']}), "
                           f"K6/K7 {res['coupling_launches']}")
    if not res["moment_check_passed"]:
        raise RuntimeError(f"{name}: v's draws fail the moment check: "
                           f"{res}")


def time_window(flow, state, k1_ms, plain_ms, slots=WINDOW_SLOTS, n_reps=5,
                graph_reps=5, graph_replays=2, seed=8, warp_turns=2):
    """K2 at a main path's post-warmup state with CUDA events, launched
    from the host and replayed from a CUDA graph (`graph_ms`), on the
    randomness of its `window_vs_plain` row; per transition beside K1's
    time there (`k1_ms`, from `time_kernel`), beside the bound of the work
    and the plain version's time (`plain_ms`, from `window_vs_plain`),
    and the tile kernel in every mode of `tile_modes` beside the per-warp
    window it replaced (`tile_and_warp_times`, as `time_kernel`).
    The work: one latent gradient per chain at the window's start and one
    per leapfrog, each the MLPs' forward and input-gradient backward
    (`mlp_flops`); the bytes: q, the window's randomness, the flow's
    parameters and masks in, the draws and the info out."""
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.kernels import nuts_window_cuda as nw
    from tpuflows_torch.targets import NealsFunnel

    q, eps, im = state.q.contiguous(), state.step_size, state.inv_mass
    n, d = q.shape
    model = nuts_cuda.pack_flow(flow, NealsFunnel(dim=d))
    rnd = window_randomness(q.device, n, d, slots, MAX_DEPTH, im, seed)

    def fn():
        return nw.nuts_window(q, *rnd, eps, im, model, MAX_DEPTH, slots)

    ms, out = timed(fn, n_reps, warmup=1)
    steps = out[3]
    gradients = float(steps.sum()) + n
    flops = gradients * mlp_flops(model)
    flow_floats = (sum(p.numel() for p in flow.parameters())
                   + d * sum(1 for t in flow.transforms
                             if hasattr(t, "mask")))
    D = MAX_DEPTH
    nbytes = 4.0 * (n * d + n * slots * (d + 2 * D + (1 << D)) + 1 + d
                    + flow_floats + slots * n * d + 7 * slots * n)
    bound_ms, bound_by = _bound(flops, nbytes)
    res = {"n": n, "d": d, "window": slots, "ms": ms,
           "device_ms": graph_ms(fn, reps=graph_reps,
                                 replays=graph_replays),
           "ms_per_transition": ms / slots,
           "k1_ms_per_transition": k1_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": nbytes, "gradients": gradients,
           "leapfrogs_per_transition": (gradients - n) / (n * slots),
           "achieved_tflops": flops / (ms * 1e-3) / 1e12}
    res.update(tile_and_warp_times(
        model, lambda R, resident: nw._launch(
            q, *rnd, eps, im, model, MAX_DEPTH, slots, None, rows=R,
            resident=resident),
        lambda: nw.chain_window_warp(q, *rnd, eps, im, model, MAX_DEPTH,
                                     slots),
        tile_modes(model, TILE_ROWS), n_reps, graph_reps=graph_reps,
        graph_replays=graph_replays, warp_turns=warp_turns))
    for R, r in (*res["tile"].items(), *res["tile_resident"].items()):
        r["lockstep_efficiency"] = lockstep_efficiency(steps, R)
    res["lockstep_efficiency"] = res["tile"][res["rows"]][
        "lockstep_efficiency"]
    return res


# ---------------------------------------------------------------------------
# the config runner
# ---------------------------------------------------------------------------
RUN_CONFIGS = ("c1_std_normal_affine", "c2_correlated_rqs", "c4_funnel_nuts",
               "c6_banana_mh", "c7_mixture_pt", "c3_mixture_adaptive",
               "c3_mixture_adaptive_two_rounds", "c5_hierarchical_smc",
               "c2_correlated_rqs_nuts", "c5_hierarchical_affine_nuts",
               "c1_std_normal_affine_nuts", "c1_std_normal_h48_depth12_nuts",
               "c2_correlated_rqs_k96_nuts")
# the configs run in processes of their own beside the others, one
# process a group (`run_aside`): c3's NUTS is paced by the host (its raw
# warmup alone took 73-134 s), as are the other configs' fits and SMC
# stages, so the processes share the card's idle time and the phase takes
# about the longest of the three lists (c3 96 s, its variant 68 s, the
# rest 141 s on an H100's host) instead of their sum
RUN_ASIDE = (("c3_mixture_adaptive",), ("c3_mixture_adaptive_two_rounds",),
             ("c2_correlated_rqs_k96_nuts",))
# Variants of a config: (its file, the keys each section changes). c3 as
# written stops after round 0 in both packages (its raw NUTS draws reach
# the ESS threshold), so its flow is fitted and scored but never sampled
# through. The variant forces a second round, the one that samples in the
# flow's latent space, at c3's widths. There NUTS's step size falls to
# ~0.02 and every tree reaches max_depth 8: 256 gradient calls through the
# four spline blocks per transition, so a round of 600 transitions would
# take minutes on the card (and 16 on a CPU in the JAX package). The
# variant cuts the depth: 20 warmup steps (fewer leave round 0's step
# size unadapted: at 10 its chains accept 0.2% of their moves), 5 draws
# and 20 epochs a round.
#
# The two nuts variants run K1 ("on") over a target other than the funnel
# at its config's own width: c2's AR(1) Gaussian (d = 8, K1 on 32 lanes)
# under c2's 4-block rqs flow, and c5's 256-d hierarchical model under
# c5's 2-block leading-mask affine flow, each fitted by VI and sampled by
# flow-preconditioned NUTS as the `nuts` task does, at a depth cut to
# under 30 s on the card: 600 VI steps, 256 chains, 150 warmup steps (400
# for c5's: at 150 its worst variance z-score sat at 3.5-4.5 in the JAX
# package and on the card) and 150 draws.
NUTS_VARIANT_DEPTH = {"n_chains": 256, "num_warmup": 150,
                      "num_samples": 150, "fused_kernel": "on"}
# c1's own target and flow (std_normal, d = 2; one affine coupling of a
# 2-layer conditioner, hidden [32]) sampled as a `nuts` task at the depth
# above, with fused_kernel back at "auto": the runner must take K1 for a
# conditioner that is not the 3-layer silu one; and the same with a hidden
# width that is not a multiple of 32 ([48], padded to 64 with zero units)
# and max_depth 12, past the register units' 10: "auto" must take K1 (its
# wide unit) there too. c2_correlated_rqs_k96_nuts is
# c2_correlated_rqs_nuts with 96 knots a spline: its VI fit runs K4/K5 past
# the old 64 knots (K5 on 32 lanes, K4 on 16) under "auto", its draws K1;
# the JAX package's reference runs were not taken for it (its gates: R-hat,
# the moment gate, the launches)
RUN_VARIANTS = {
    "c1_std_normal_affine_nuts": (
        "c1_std_normal_affine",
        {"task": "nuts", "train": {"nsteps": 600},
         "nuts": {**NUTS_VARIANT_DEPTH, "fused_kernel": "auto"}}),
    "c1_std_normal_h48_depth12_nuts": (
        "c1_std_normal_affine",
        {"task": "nuts", "flow": {"hidden": [48]}, "train": {"nsteps": 600},
         "nuts": {**NUTS_VARIANT_DEPTH, "fused_kernel": "auto",
                  "max_depth": 12}}),
    "c3_mixture_adaptive_two_rounds": (
        "c3_mixture_adaptive",
        {"adaptive": {"max_rounds": 2, "ess_threshold": 1e9,
                      "num_warmup": 20, "num_samples": 5,
                      "train_epochs": 20}}),
    "c2_correlated_rqs_nuts": (
        "c2_correlated_rqs",
        {"task": "nuts", "train": {"nsteps": 600},
         "nuts": NUTS_VARIANT_DEPTH}),
    "c2_correlated_rqs_k96_nuts": (
        "c2_correlated_rqs",
        {"task": "nuts", "flow": {"knots": 96}, "train": {"nsteps": 600},
         "nuts": NUTS_VARIANT_DEPTH}),
    "c5_hierarchical_affine_nuts": (
        "c5_hierarchical_smc",
        {"task": "nuts", "train": {"nsteps": 600, "batch_size": 512},
         "nuts": {**NUTS_VARIANT_DEPTH, "num_warmup": 400}}),
}
# the variants whose samplers' R-hat is gated as the configs' as written
# are: the nuts variants, whose depth leaves enough draws for it
RUN_RHAT_VARIANTS = ("c2_correlated_rqs_nuts", "c5_hierarchical_affine_nuts",
                     "c1_std_normal_affine_nuts",
                     "c1_std_normal_h48_depth12_nuts",
                     "c2_correlated_rqs_k96_nuts")


def run_config_dict(name):
    """The JSON dict of a config of `configs/` or of a `RUN_VARIANTS`
    entry (named after the variant; an edit that is not a dict replaces a
    top-level key, such as the task), for either package's
    `RunConfig.from_dict`."""
    base, edits = RUN_VARIANTS.get(name, (name, {}))
    with open(os.path.join(ROOT, "configs", f"{base}.json")) as f:
        d = json.load(f)
    for section, changes in edits.items():
        d[section] = ({**d.get(section, {}), **changes}
                      if isinstance(changes, dict) else changes)
    if base != name:
        d["name"] = name
    return d
# The JAX package's results for each config as written (or as its variant
# changes it), on the CPU, at the config's seed and the next two
# (scripts/runner_reference.py): each of the port's results on the card
# must lie within RUN_MARGIN_SIGMAS of their standard deviations of their
# mean. With three values the standard deviation is itself uncertain: 10
# of them keeps the chance that a result from the same distribution fails
# near 1% (Student's t, 2 degrees of freedom). Where the three agree
# exactly (c3's rounds, its convergence, its best min ESS of 0 when no
# round sampled through a flow) the window is that value alone.
RUN_REFERENCE = {
    "c1_std_normal_affine": {"final_loss": (2.904125452041626,
                                            2.7373180389404297,
                                            2.8427441120147705)},
    "c2_correlated_rqs": {"final_elbo": (-0.028232574462890625,
                                         -0.058971405029296875,
                                         -0.02308368682861328)},
    "c6_banana_mh": {"accept_rate": (0.23331165313720703,
                                     0.23475094139575958,
                                     0.23489056527614594),
                     "min_ess": (13126.544921875, 10295.984375,
                                 11064.505859375)},
    "c7_mixture_pt": {"mean_swap_accept": (0.744265615940094,
                                           0.7438125014305115,
                                           0.7446551322937012),
                      "min_ess": (2274.82568359375, 1946.6734619140625,
                                  2015.6090087890625)},
    "c3_mixture_adaptive": {"n_rounds": (1, 1, 1),
                            "converged": (True, True, True),
                            "best_min_ess": (0.0, 0.0, 0.0),
                            "flow_is_ess": (0.1964937001466751,
                                            0.15713533759117126,
                                            0.05810265615582466)},
    "c2_correlated_rqs_nuts": {
        "min_ess": (41751.84765625, 44921.12890625, 43454.125),
        "step_size": (0.5646496415138245, 0.5843446850776672,
                      0.5563716292381287),
        "divergence_rate": (0.0005729167023673654, 0.0003124999930150807,
                            0.0003124999930150807)},
    "c5_hierarchical_affine_nuts": {
        "min_ess": (38161.65625, 38231.87890625, 38649.09375),
        "step_size": (0.4020515978336334, 0.40219876170158386,
                      0.4015480875968933),
        "divergence_rate": (0.0005989583441987634, 0.0013802084140479565,
                            0.0012499999720603228)},
    "c1_std_normal_affine_nuts": {
        "min_ess": (38869.15234375, 37570.26953125, 38694.93359375),
        "step_size": (1.2468318939208984, 1.2617747783660889,
                      1.250554084777832),
        "divergence_rate": (0.0, 0.0, 0.0)},
    "c1_std_normal_h48_depth12_nuts": {
        "min_ess": (39813.140625, 37597.87109375, 38315.57421875),
        "step_size": (1.2511907815933228, 1.2596187591552734,
                      1.2440900802612305),
        "divergence_rate": (0.0, 0.0, 0.0)},
    "c3_mixture_adaptive_two_rounds": {
        "n_rounds": (2, 2, 2), "converged": (False, False, False),
        "best_min_ess": (70.8592300415039, 65.95453643798828,
                         67.9321517944336),
        "flow_is_ess": (0.0011806493857875466, 0.006424020975828171,
                        0.011425626464188099)},
}
RUN_MARGIN_SIGMAS = 10.0
# The sampler configs whose draws are held to the target's analytic mean
# and variance by `moment_gate`, at the n_sigma of the JAX package's own
# tests of the sampler (tests/test_mh_tempering.py: 3.5 for RWMH, 4 for
# parallel tempering; tests/test_mcmc.py: 3.5 for NUTS). The JAX package's draws pass it on all three seeds
# of RUN_REFERENCE (scripts/runner_reference.py).
RUN_MOMENTS = {"c6_banana_mh": 3.5, "c7_mixture_pt": 4.0,
               "c2_correlated_rqs_nuts": 3.5,
               "c5_hierarchical_affine_nuts": 3.5,
               "c1_std_normal_affine_nuts": 3.5,
               "c1_std_normal_h48_depth12_nuts": 3.5,
               "c2_correlated_rqs_k96_nuts": 3.5}
# the configs whose moment gate judges the worst of its 2 d z-scores
# against the family threshold of its n_sigma (`family_threshold`: at d =
# 256 the max of 512 null z-scores concentrates near 3)
RUN_MOMENT_FAMILY = ("c5_hierarchical_affine_nuts",)
# c1's fit starts at its optimum (the flow's Standardize fits the
# standard-normal samples), so the window above, which holds the untrained
# flow's loss too, cannot tell a fit from none. A fit task's final loss is
# also held to the analytic optimum, the entropy of N(0, I_d) for c1, and
# to at most its initial loss: each loss is the negll of one batch of
# n_fit_samples / nbatches = 512 rows, whose standard deviation at the
# optimum is sqrt(d / 2) / sqrt(512) = 0.044, and FIT_NOISE_MARGIN is
# about 5 of those (4 of the difference of two batches).
RUN_OPTIMUM = {"c1_std_normal_affine": ("final_loss",
                                        1.0 + math.log(2.0 * math.pi))}
FIT_NOISE_MARGIN = 0.25
# the record's keys of each task (the JAX runner's), and those the port's
# records add
RUN_KEYS = {"fit": {"final_loss", "initial_loss"}, "vi": {"final_elbo"},
            "nuts": {"min_ess", "max_rhat", "step_size", "divergence_rate"},
            "mh": {"min_ess", "max_rhat", "accept_rate"},
            "pt": {"min_ess", "max_rhat", "mean_swap_accept"},
            "adaptive": {"n_rounds", "converged", "min_ess", "best_min_ess",
                         "flow_is_ess"},
            "smc": {"n_stages", "log_z", "final_beta", "mean_accept"}}
RUN_EXTRA_KEYS = {"nuts": {"transition"}}


def reference_window(name, key):
    """(mean, margin) of the gate on one of a config's results."""
    values = [float(v) for v in RUN_REFERENCE[name][key]]
    mean = sum(values) / len(values)
    sd = math.sqrt(sum((v - mean) ** 2 for v in values) / (len(values) - 1))
    return mean, RUN_MARGIN_SIGMAS * sd


class PhaseClock:
    """Times the runner's phases from outside: while active, the fits
    (`optimize_flow`, `fit_vi`; SMC's pretrain), the samplers' warmup
    (NUTS, RWMH, PT) and their draws (and flow-IMH's), SMC's stages (its
    equilibration stages too) and its retrains (the sharded run's
    `optimize_flow_dp`) each wait for the device
    before and after and add their wall time to `seconds` (the adaptive
    loop's, summed over its rounds), and `counts` counts the calls. It patches the module
    attributes the runner and the loop look up when they call them;
    `run_configs` fails a config whose phases were not all timed, so code
    that binds them otherwise cannot pass unnoticed."""

    def __init__(self, on_card):
        self.on_card = on_card
        self.seconds = {}
        self.counts = {}

    def _wrap(self, name, fn):
        import torch

        def timed_fn(*args, **kwargs):
            if self.on_card:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.on_card:
                torch.cuda.synchronize()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t)
            self.counts[name] = self.counts.get(name, 0) + 1
            return out

        return timed_fn

    def __enter__(self):
        from tpuflows_torch import flows, vi
        from tpuflows_torch.adaptive import loop
        from tpuflows_torch.dist import train as dist_train
        from tpuflows_torch.mcmc import mh, sample, tempering
        from tpuflows_torch.smc import sampler

        phases = [(sampler, "optimize_flow", "retrain"),
                  (dist_train, "optimize_flow_dp", "retrain"),
                  (sampler, "_execute_stage", "stages"),
                  (flows, "optimize_flow", "fit"),
                  (loop, "optimize_flow", "fit"),
                  (vi, "fit_vi", "fit"),
                  (sample.NUTSDriver, "warmup", "warmup"),
                  (sample.NUTSDriver, "draws", "draws"),
                  (mh, "_rwmh_warmup", "warmup"),
                  (mh, "_rwmh_draws", "draws"),
                  (mh, "_flow_imh_run", "draws"),
                  (tempering, "_pt_warmup", "warmup"),
                  (tempering, "_pt_sample", "draws")]
        self._saved = [(owner, attr, getattr(owner, attr))
                       for owner, attr, _ in phases]
        for (owner, attr, fn), (_, _, name) in zip(self._saved, phases):
            setattr(owner, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)


class AdaptiveProbe:
    """While active: the `AdaptiveResult` of the runner's `adaptive_fit`
    call (`result`), the spline kernels' launch shapes (`shapes`, (kernel,
    rows, d, K) -> launches) and the calls of the latent log density that
    each round's NUTS differentiates (`latent_calls`): one per gradient
    call, each running every spline block's K4 inverse and, backwards,
    its K5 inverse."""

    def __enter__(self):
        from tpuflows_torch import adaptive
        from tpuflows_torch.adaptive import loop
        from tpuflows_torch.kernels import rqs_cuda

        self.result, self.shapes, self.latent_calls = None, {}, 0

        def fit(*args, **kwargs):
            self.result = self._fit(*args, **kwargs)
            return self.result

        def reparameterized(log_density, flow):
            logp = self._reparameterized(log_density, flow)

            def counted(z):
                self.latent_calls += 1
                return logp(z)

            return counted

        def shaped(launch):
            def launch_shaped(x, raw, *args, **kwargs):
                before = dict(rqs_cuda.LAUNCHES)
                out = launch(x, raw, *args, **kwargs)
                for kernel, count in rqs_cuda.LAUNCHES.items():
                    if count != before[kernel]:
                        key = (kernel, x.numel() // x.shape[-1],
                               x.shape[-1], (raw.shape[-1] + 1) // 3)
                        self.shapes[key] = self.shapes.get(key, 0) + 1
                return out

            return launch_shaped

        self._fit = adaptive.adaptive_fit
        self._reparameterized = loop.flow_reparameterized
        self._launches = (rqs_cuda._launch_eval, rqs_cuda._launch_grad)
        adaptive.adaptive_fit = fit
        loop.flow_reparameterized = reparameterized
        rqs_cuda._launch_eval, rqs_cuda._launch_grad = (
            shaped(f) for f in self._launches)
        return self

    def __exit__(self, *exc):
        from tpuflows_torch import adaptive
        from tpuflows_torch.adaptive import loop
        from tpuflows_torch.kernels import rqs_cuda

        adaptive.adaptive_fit = self._fit
        loop.flow_reparameterized = self._reparameterized
        rqs_cuda._launch_eval, rqs_cuda._launch_grad = self._launches


class SMCProbe:
    """While active: the `SMCResult` of the runner's `run_smc` call
    (`result`), looked up by the runner in `tpuflows_torch.smc` at call
    time, and the collectives its stages issued (`stage_collectives`)."""

    def __enter__(self):
        from tpuflows_torch import smc
        from tpuflows_torch.dist import collectives
        from tpuflows_torch.smc import sampler

        self.result = None
        self.stage_collectives = 0
        self._run = smc.run_smc
        self._stage = sampler._execute_stage

        def stage(*args, **kwargs):
            before = collectives.collective_count()
            out = self._stage(*args, **kwargs)
            self.stage_collectives += collectives.collective_count() - before
            return out

        sampler._execute_stage = stage

        def run(*args, **kwargs):
            self.result = self._run(*args, **kwargs)
            return self.result

        smc.run_smc = run
        return self

    def __exit__(self, *exc):
        from tpuflows_torch import smc
        from tpuflows_torch.smc import sampler

        smc.run_smc = self._run
        sampler._execute_stage = self._stage


def kernel_launches():
    """Every kernel's launch count (K1-K7, and K1's, K2's and K3's wide
    units) since its last reset."""
    from tpuflows_torch.kernels import (coupling_cuda, fused_logp_cuda,
                                        nuts_cuda, nuts_window_cuda,
                                        rqs_cuda)

    return {"k1": nuts_cuda.LAUNCHES, "k2": nuts_window_cuda.LAUNCHES,
            "k3": fused_logp_cuda.LAUNCHES,
            "k1_wide": nuts_cuda.WIDE_LAUNCHES,
            "k2_wide": nuts_window_cuda.WIDE_LAUNCHES,
            "k3_wide": fused_logp_cuda.WIDE_LAUNCHES, **rqs_cuda.LAUNCHES,
            **coupling_cuda.LAUNCHES}


def reset_kernel_launches():
    from tpuflows_torch.kernels import (coupling_cuda, fused_logp_cuda,
                                        nuts_cuda, nuts_window_cuda,
                                        rqs_cuda)

    nuts_cuda.LAUNCHES = nuts_cuda.WIDE_LAUNCHES = 0
    nuts_window_cuda.LAUNCHES = nuts_window_cuda.WIDE_LAUNCHES = 0
    fused_logp_cuda.reset_launches()
    rqs_cuda.reset_launches()
    coupling_cuda.reset_launches()


# c5's gates (scripts/config5_artifact.py): log Z within 4 of its
# delta-method sigmas + 0.05 of the quadrature truth, and the particles
# through the family-corrected moment gate at 3 sigma with the measured
# ESS (`smc_measured_ess`)
SMC_LOGZ_SIGMAS = 4.0
SMC_LOGZ_SLACK = 0.05
SMC_MOMENT_SIGMA = 3.0


def smc_gates(res, target, device):
    """c5's record beyond the runner's keys, and its failures."""
    import torch
    from tpuflows_torch.diagnostics import moment_gate
    from tpuflows_torch.smc import smc_measured_ess

    truth = target.log_evidence()
    sigma = max(float(res.log_z_sigma), 1e-6)
    ess = smc_measured_ess(res)
    check = moment_gate(res.particles, target.mean(device),
                        torch.diagonal(target.cov(device)),
                        n_sigma=SMC_MOMENT_SIGMA, ess=ess,
                        family_correction=True)
    err = float(res.log_z) - truth
    bar = SMC_LOGZ_SIGMAS * sigma + SMC_LOGZ_SLACK
    var_ratio = (torch.var(res.particles, dim=0, correction=0)
                 / torch.diagonal(target.cov(device)))
    info = {"log_z_truth": truth, "log_z_sigma": sigma, "log_z_error": err,
            "log_z_bar": bar, "measured_ess": ess,
            "unique_ancestors": res.unique_ancestors,
            "final_kish_ess": res.final_kish_ess,
            "betas": [float(b) for b in res.betas],
            "ess_hist": [float(e) for e in res.ess_hist],
            "accept_hist": [float(a) for a in res.accept_hist],
            "var_ratio_mu_logtau": [float(v) for v in var_ratio[:2]],
            "var_ratio_theta_range": [float(var_ratio[2:].min()),
                                      float(var_ratio[2:].max())],
            "moment_gate": check._asdict()}
    failures = []
    if float(res.betas[-1]) != 1.0:
        failures.append(f"final beta {float(res.betas[-1])}")
    if not abs(err) < bar:
        failures.append(f"log_z {float(res.log_z)} is {err} from the "
                        f"quadrature truth {truth}, bar {bar}")
    if not check.passed:
        failures.append(f"moment gate {check}")
    return info, failures


def adaptive_launches(cfg, rounds, latent_calls):
    """The K4/K5 launches an adaptive run of `rounds` rounds implies, its
    flow of n spline blocks never growing: each round's forward-KL fit
    (epochs x batches steps: K4 and K5 forward per block) and IS-ESS (K4
    inverse); each round after the first the latent start f(x) (K4
    forward), the latent NUTS (`latent_calls` gradient calls: K4 and K5
    inverse) and the draws mapped back (K4 inverse, one chunk)."""
    n = cfg.flow.n_blocks if cfg.flow.kind == "rqs" else 0
    steps = cfg.adaptive.train_epochs * 16  # AdaptiveConfig.train_batches
    latent = rounds - 1
    return {"k4_forward": n * (steps * rounds + latent),
            "k4_inverse": n * (latent_calls + rounds + latent),
            "k5_forward": n * steps * rounds,
            "k5_inverse": n * latent_calls}


def run_configs(device, names=RUN_CONFIGS, overrides=None, results=None):
    """`tpuflows_torch.run.run` on each config as written (or as its
    `RUN_VARIANTS` entry changes it; `overrides`: a function of (name,
    RunConfig) that a CPU rehearsal uses to cut it), its record captured
    through a `MetricsLogger` of its own, K1's and K4/K5's launches
    counted around the call, and the phases' wall times (`PhaseClock`).
    Gates: the record's keys are the JAX runner's (and the nuts record's
    `transition`); every phase the task runs was timed; every result is
    finite; each result of `RUN_REFERENCE` within `reference_window`;
    c1's final loss within FIT_NOISE_MARGIN of its optimum and of its
    initial loss or below; the samplers' max split-R-hat below RHAT_GATE
    (the adaptive loop's, every round's), where the config runs as
    written; c6's and c7's draws (saved by
    the runner through `output_dir`, and loaded back) pass `moment_gate`
    against the target's analytic moments at `RUN_MOMENTS`' n_sigma; c4's
    transition the fused one and K1 launched once per transition
    (num_warmup + num_samples); c2's spline blocks launched K4 inverse
    once per block per step and for the final ELBO, K5 inverse once per
    block per step, nothing forward; c3's the launches
    `adaptive_launches` derives, each direction of each kernel at least
    once over c3's rows (its spline shapes printed); c5 through
    `smc_gates` (final beta 1, log Z against the quadrature truth, the
    moment gate with the measured ESS), its pretrain, stages and retrains
    timed, and no kernel launched (SMC's mutation differentiates by
    autograd, as the JAX package's does). `results`, a dict, receives
    each smc config's (SMCResult, target)."""
    import dataclasses
    import io
    import tempfile

    import torch
    import torch.distributed as tdist
    from tpuflows_torch import run as runner
    from tpuflows_torch.config import RunConfig
    from tpuflows_torch.diagnostics import moment_gate
    from tpuflows_torch.dist import collectives
    from tpuflows_torch.io import load_pytree
    from tpuflows_torch.kernels import nuts_cuda, rqs_cuda
    from tpuflows_torch.mcmc.preconditioned import (
        _CHUNK as data_space_chunk)
    from tpuflows_torch.util.profiling import MetricsLogger

    rows = []
    for name in names:
        cfg = RunConfig.from_dict(run_config_dict(name))
        if overrides is not None:
            cfg = overrides(name, cfg)
        buf = io.StringIO()
        saved = runner._metrics
        runner._metrics = MetricsLogger(stream=buf)
        reset_kernel_launches()
        collectives.reset_counts()
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            if name in RUN_MOMENTS:
                cfg = dataclasses.replace(cfg, output_dir=tmp)
            try:
                with PhaseClock(device != "cpu") as clock, \
                        AdaptiveProbe() as probe, SMCProbe() as smc_probe:
                    out = runner.run(cfg, device=device)
            finally:
                runner._metrics = saved
            seconds = time.perf_counter() - t
            draws = (load_pytree(f"{tmp}/{cfg.name}_state", device=device)
                     if name in RUN_MOMENTS else None)
        record = json.loads(buf.getvalue())
        row = {"config": name, "task": cfg.task, "record": record,
               "seconds": seconds, "phase_seconds": clock.seconds,
               "phase_calls": clock.counts,
               "k1_launches": nuts_cuda.LAUNCHES + nuts_cuda.WIDE_LAUNCHES,
               "k1_wide_launches": nuts_cuda.WIDE_LAUNCHES,
               "rqs_launches": dict(rqs_cuda.LAUNCHES),
               "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                                  if device != "cpu" else None)}
        failures = []
        if set(record) != {"ts", "name", "task", "wall_s",
                           *RUN_KEYS[cfg.task],
                           *RUN_EXTRA_KEYS.get(cfg.task, ())}:
            failures.append(f"record keys {sorted(record)}")
        phases = {"fit": {"fit"}, "vi": {"fit"}, "pt": {"warmup", "draws"},
                  "adaptive": {"fit", "warmup", "draws"}}.get(
                      cfg.task, {"warmup", "draws"})
        if ((cfg.task == "nuts" and cfg.nuts.preconditioned)
                or (cfg.task == "mh" and cfg.mh.flow_proposal)):
            phases = phases | {"fit"}
        if cfg.task == "mh" and cfg.mh.flow_proposal:
            phases = phases - {"warmup"}
        if cfg.task == "smc":
            phases = {"stages"}
            if cfg.smc.pretrain == "prior":
                phases = phases | {"fit"}
            if cfg.smc.retrain_every and (out["n_stages"]
                                          > cfg.smc.retrain_every):
                phases = phases | {"retrain"}
        if set(clock.seconds) != phases:
            failures.append(f"phases timed {sorted(clock.seconds)}, the "
                            f"task runs {sorted(phases)}")
        if not all(math.isfinite(out[k]) for k in RUN_KEYS[cfg.task]):
            failures.append(f"a non-finite result: {out}")
        row["reference"] = {}
        for key, values in RUN_REFERENCE.get(name, {}).items():
            mean, margin = reference_window(name, key)
            row["reference"][key] = {"jax_mean": mean, "margin": margin,
                                     "jax": [float(v) for v in values]}
            if not abs(out[key] - mean) <= margin:
                failures.append(f"{key} {out[key]} outside {mean} +- "
                                f"{margin}")
        if name in RUN_OPTIMUM:
            key, best = RUN_OPTIMUM[name]
            row["optimum"] = {"key": key, "value": best,
                              "margin": FIT_NOISE_MARGIN}
            if not abs(out[key] - best) <= FIT_NOISE_MARGIN:
                failures.append(f"{key} {out[key]} outside the optimum "
                                f"{best} +- {FIT_NOISE_MARGIN}")
        if (cfg.task == "fit" and not out["final_loss"]
                <= out["initial_loss"] + FIT_NOISE_MARGIN):
            failures.append(f"final_loss {out['final_loss']} above the "
                            f"initial {out['initial_loss']}")
        # the R-hat gate holds the configs as written and the nuts
        # variants; another variant's cut depth leaves too few draws for it
        as_written = name not in RUN_VARIANTS or name in RUN_RHAT_VARIANTS
        if as_written and cfg.task in ("nuts", "mh", "pt") \
                and not out["max_rhat"] < RHAT_GATE:
            failures.append(f"max split-R-hat {out['max_rhat']}")
        if name in RUN_MOMENTS:
            target = cfg.target.build(device=device)
            check = moment_gate(draws, target.mean(device),
                                torch.diagonal(target.cov(device)),
                                n_sigma=RUN_MOMENTS[name],
                                family_correction=name in RUN_MOMENT_FAMILY)
            row["moment_gate"] = check._asdict()
            if not check.passed:
                failures.append(f"moment gate {check}")
        if cfg.task == "nuts":
            want = cfg.nuts.num_warmup + cfg.nuts.num_samples
            row["k1_launches_expected"] = want if device != "cpu" else 0
            if cfg.nuts.preconditioned and out["transition"] != "fused":
                failures.append(f"the {out['transition']} NUTS ran, not "
                                f"K1's transition")
            if row["k1_launches"] != row["k1_launches_expected"]:
                failures.append(f"K1 launched {row['k1_launches']} times "
                                f"for {want} transitions")
        want = None
        if cfg.task == "vi" and cfg.flow.kind == "rqs":
            n = cfg.flow.n_blocks
            want = {"k4_forward": 0, "k4_inverse": n * (cfg.train.nsteps + 1),
                    "k5_forward": 0, "k5_inverse": n * cfg.train.nsteps}
        if (cfg.task == "nuts" and cfg.nuts.preconditioned
                and cfg.flow.kind == "rqs"):
            # the VI fit's (as the vi task's), then the draws mapped to the
            # data space, `to_data_space`'s chunks of rows; K1 takes every
            # gradient of the draws
            n = cfg.flow.n_blocks
            chunks = -(-cfg.nuts.n_chains * cfg.nuts.num_samples
                       // data_space_chunk)
            want = {"k4_forward": 0,
                    "k4_inverse": n * (cfg.train.nsteps + 1 + chunks),
                    "k5_forward": 0, "k5_inverse": n * cfg.train.nsteps}
        if cfg.task == "adaptive":
            res = probe.result
            rhats = [float(r.max_rhat) for r in res.rounds]
            row["rounds"] = [{k: float(v) for k, v in r._asdict().items()}
                             for r in res.rounds]
            row["latent_calls"] = probe.latent_calls
            row["spline_shapes"] = [
                {"kernel": k, "rows": n, "d": d, "knots": K,
                 "launches": c}
                for (k, n, d, K), c in sorted(probe.shapes.items())]
            if as_written and not max(rhats) < RHAT_GATE:
                failures.append(f"max split-R-hat by round {rhats}")
            want = adaptive_launches(cfg, res.n_rounds, probe.latent_calls)
            if device != "cpu" and res.n_rounds > 1 and not all(want.values()):
                failures.append(f"a spline kernel in one direction ran no "
                                f"time: {want}")
        if cfg.task == "smc":
            target = cfg.target.build(device=device)
            row["smc"], smc_failures = smc_gates(smc_probe.result, target,
                                                 device)
            failures += smc_failures
            row["kernel_launches"] = kernel_launches()
            if any(row["kernel_launches"].values()):
                failures.append(f"a kernel launched on SMC's path: "
                                f"{row['kernel_launches']}")
            row["sharded"] = cfg.smc.sharded
            if cfg.smc.sharded:
                # the world worker_mesh() formed (of one, without torchrun)
                row["world"] = tdist.get_world_size()
                row["backend"] = str(tdist.get_backend())
                row["collectives"] = dict(collectives.COUNTS)
                row["collectives_per_stage"] = (
                    smc_probe.stage_collectives
                    / max(clock.counts.get("stages", 0), 1))
                backend = "nccl" if device != "cpu" else "gloo"
                if row["backend"] != backend or not row["collectives"][
                        "all_reduce"]:
                    failures.append(f"the sharded run's world: "
                                    f"{row['backend']}, "
                                    f"{row['collectives']}")
            if results is not None:
                results[name] = (smc_probe.result, target)
        if want is not None:
            if device == "cpu":
                want = {k: 0 for k in want}
            row["rqs_launches_expected"] = want
            if dict(rqs_cuda.LAUNCHES) != want:
                failures.append(f"K4/K5 launched {dict(rqs_cuda.LAUNCHES)},"
                                f" the path implies {want}")
        row["failures"] = failures
        row["passed"] = not failures
        rows.append(row)
        if device != "cpu":
            torch.cuda.empty_cache()
    return rows


def run_aside(groups=RUN_ASIDE):
    """Starts `run_configs` on each group of configs of `groups` in a
    process of its own (this script with --run-configs, on the same card
    and the kernels this one built). Returns the processes and a function
    that waits for them and returns their rows; the caller kills those it
    does not wait for."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--run-configs",
         ",".join(names)], stdout=subprocess.PIPE, text=True)
        for names in groups]

    def wait():
        rows = []
        for names, proc in zip(groups, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"run_configs on {names} in its own "
                                   f"process exited {proc.returncode}")
            rows += json.loads(out.strip().splitlines()[-1])["run_configs"]
        return rows

    return procs, wait


def logmeanexp_se(log_w):
    """The delta-method standard error of logmeanexp(log_w) over iid
    draws: the normalized weights' standard deviation / sqrt(n)
    (scripts/evidence_production_dims.py)."""
    import torch

    w = torch.exp(log_w.double() - torch.max(log_w.double()))
    return float(torch.std(w, correction=1)
                 / (torch.mean(w) * math.sqrt(log_w.numel())))


# where a route's weight ESS reaches this share of its n, its estimate is
# held within EVIDENCE_SES standard errors + EVIDENCE_SLACK of the truth
# (scripts/evidence_production_dims.py's gate); below it the proposal is
# too poor to judge the estimator, and the row is printed, not gated
EVIDENCE_MIN_ESS_SHARE = 0.1
EVIDENCE_SES = 4.0
EVIDENCE_SLACK = 0.02


def evidence_c5(device, res, target, n_is=65536, n_proposal=16384, seed=13):
    """The three evidence routes (`tpuflows_torch.integration`) with c5's
    final SMC flow at d = 256 against the quadrature truth: flow IS on
    `n_is` draws, the Meng-Wong bridge with the SMC particles as the
    posterior draws and `n_proposal` flow draws, the harmonic mean on the
    SMC particles. Each row: the estimate, its error, its weight ESS and
    its delta-method standard error (the IS and harmonic weights'; the
    bridge's 1/sqrt(ESS), the script's proxy), and whether it is gated
    (`EVIDENCE_MIN_ESS_SHARE`) and passed."""
    import torch
    from tpuflows_torch.diagnostics import importance_weight_ess
    from tpuflows_torch.integration import (log_evidence_bridge,
                                            log_evidence_harmonic)
    from tpuflows_torch.integration.evidence import _flow_log_q, _is_math
    from tpuflows_torch.targets import std_normal_logpdf

    flow, post = res.flow, res.particles
    truth = target.log_evidence()
    g = torch.Generator(device=device).manual_seed(seed)
    rows = []

    def row(route, log_z, se, ess, n):
        err = float(log_z) - truth
        gated = float(ess) >= EVIDENCE_MIN_ESS_SHARE * n
        bar = EVIDENCE_SES * se + EVIDENCE_SLACK
        ok = math.isfinite(float(log_z)) and (not gated or abs(err) < bar)
        rows.append({"route": route, "log_z": float(log_z),
                     "log_z_truth": truth, "error": err, "se": se,
                     "weight_ess": float(ess), "n": n, "gated": gated,
                     "bar": bar, "passed": ok})

    with torch.no_grad():
        z = torch.randn((n_is, target.dim), generator=g, device=device)
        ires = _is_math(z, target.log_density, flow)
        x, ladj = flow.inverse_and_ladj(z)
        log_w = target.log_density(x) - (std_normal_logpdf(z) - ladj)
        row("is_flow_proposal", ires.log_z, logmeanexp_se(log_w), ires.ess,
            n_is)
        bres = log_evidence_bridge(g, target.log_density, flow, post,
                                   n_proposal=n_proposal)
        row("bridge_meng_wong", bres.log_z,
            1.0 / math.sqrt(max(float(bres.ess), 1.0)), bres.ess,
            n_proposal)
        hz = log_evidence_harmonic(target.log_density, flow, post)
        lw_h = _flow_log_q(flow, post) - target.log_density(post)
        row("harmonic_flow_aux", hz, logmeanexp_se(lw_h),
            importance_weight_ess(lw_h), post.shape[0])
    return rows


# the bars of `dist_world_of_one`: the collectives against their local math
# (the reductions' other summation order: 1e-6 relative); the sharded stage
# and the data-parallel step against their unsharded counterparts on the
# same draws and batch, to the CPU tests' bar (tests/test_torch_dist.py) in
# absolute terms (a world of one computes the same operations, so they are
# expected equal to the bit; the bits that differ are printed)
DIST_RTOL = 1e-6
DIST_STAGE_BAR = 1e-5
DIST_STEP_BAR = 1e-6
# repeats of each way in the phase's stage and retrain timings (3 before
# the conditioners' phase, cut to pay for it; a timing, not a gate)
DIST_REPEATS = 2


def _bits_differ(a, b):
    import torch

    return int(torch.sum(a.contiguous().view(torch.int32)
                         != b.contiguous().view(torch.int32)))


def dist_world_of_one(device, flow, warm_state, c5_flow, n=65536, d=256,
                      n_chains=N_CHAINS, num_warmup=NUM_WARMUP,
                      num_samples=DRAW_WINDOW, max_depth=MAX_DEPTH,
                      repeats=DIST_REPEATS, seed=31):
    """The distributed layer over `worker_mesh(device=)`: on the card a
    NCCL world of one (one H100 admits no more), the world the runner's
    c5 already formed. (a) every collective on `device` tensors against
    its local math, `fold_in_axis_index`, `replicate` and `heartbeat`'s
    latencies; (b) `resample_sharded` at n x d through both transports:
    ancestors equal to `systematic_indices_math` on the same uniform, rows
    equal; (c) one sharded SMC stage (`_stage_math(mesh=)`) against the
    unsharded one at c5's shapes on the same draws (c5's configuration,
    its final flow `c5_flow`, weights that force the resample): the
    resampling decision, ancestors and beta equal, x and the weights
    within DIST_STAGE_BAR, and each way's seconds `repeats` times;
    (d) one `optimize_flow_dp` step against one `optimize_flow` step on
    the same batch and the folded generator, parameters within
    DIST_STEP_BAR, and c5's whole retrain each way `repeats` times (ms
    a step); (e) `run_nuts_sharded` through K1
    (`fused_nuts_for_flow`) on the ceiling flow from the main path's
    post-warmup positions: `num_warmup` transitions, one window of
    `num_samples` draws, K1's launches counted from 0 (once per
    transition on the card), max split-R-hat < RHAT_GATE, v's draws
    through the moment gate. Returns (result dict, failures)."""
    import copy

    import torch
    from tpuflows_torch.diagnostics import (effective_sample_size,
                                            importance_weight_ess,
                                            moment_gate, split_rhat)
    from tpuflows_torch.dist import (heartbeat, optimize_flow_dp,
                                     replicate, resample_sharded,
                                     run_nuts_sharded, worker_mesh)
    from tpuflows_torch.dist import collectives as col
    from tpuflows_torch.flows import Adam, optimize_flow
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.mcmc import to_data_space
    from tpuflows_torch.smc import SMCConfig
    from tpuflows_torch.smc.resample import systematic_indices_math
    from tpuflows_torch.smc.sampler import _flow_log_q, _stage_math
    from tpuflows_torch.targets import HierarchicalGaussian, NealsFunnel

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def gen(k):
        return torch.Generator(device=device).manual_seed(seed * 100 + k)

    def clock(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    mesh = worker_mesh(device=device)
    failures = []
    out = {"world": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device)}

    # (a) the collectives
    g = gen(1)
    v = torch.randn(n, generator=g, device=device)
    lw = 3.0 * torch.randn(n, generator=g, device=device)
    pairs = {"psum": (col.psum(v.sum(), mesh), v.sum()),
             "pmean": (col.pmean(v.mean(), mesh), v.mean()),
             "pmax": (col.pmax(v.max(), mesh), v.max()),
             "logsumexp_g": (col.logsumexp_g(lw, mesh),
                             torch.logsumexp(lw, 0)),
             "kish_ess_g": (col.kish_ess_g(lw, mesh),
                            importance_weight_ess(lw)),
             "all_gather": (col.all_gather(v, mesh), v),
             "broadcast": (col.broadcast(v.clone(), mesh), v)}
    module = copy.deepcopy(flow)
    replicate(module, mesh)
    pairs["replicate"] = (torch.cat([p.detach().reshape(-1) for p in
                                     module.parameters()]),
                          torch.cat([p.detach().reshape(-1) for p in
                                     flow.parameters()]))
    coll = {}
    for name, (got, want) in pairs.items():
        err = float(torch.max(torch.abs(got - want)
                              / torch.clamp_min(torch.abs(want), 1.0)))
        coll[name] = {"max_rel_err": err, "passed": err <= DIST_RTOL}
        if err > DIST_RTOL:
            failures.append(f"{name} differs from its local math by {err}")
    folded = col.fold_in_axis_index(gen(2), mesh)
    if torch.equal(torch.rand(8, generator=folded, device=device),
                   torch.rand(8, generator=gen(2), device=device)):
        failures.append("fold_in_axis_index left the stream as it was")
    out["collectives"] = coll
    out["heartbeat_s"] = [heartbeat(mesh) for _ in range(5)]

    # (b) the sharded resampler at n x d
    g = gen(3)
    x = torch.randn((n, d), generator=g, device=device)
    log_w = 2.0 * torch.randn(n, generator=g, device=device)
    u0 = torch.rand((), generator=g, device=device)
    want = systematic_indices_math(u0, log_w)
    rs = {}
    for gather in (True, False):
        ((rows,), anc), secs = clock(lambda: resample_sharded(
            u0, (x,), log_w, mesh, gather_particles=gather))
        ok = torch.equal(anc, want) and torch.equal(rows, x[want.long()])
        rs["gather" if gather else "exchange"] = {"seconds": secs,
                                                  "passed": ok}
        if not ok:
            failures.append(f"resample_sharded (gather={gather}) differs "
                            f"from systematic_indices_math")
    out["resample"] = rs
    del x, rows

    # (c) one sharded stage against the unsharded one, on the same draws
    target = HierarchicalGaussian.standard(dim=d, device=device)
    cfg = SMCConfig(n_particles=n, n_mutation_steps=5, n_leapfrog=8,
                    target_rel_ess=0.8)
    g = gen(4)
    with torch.no_grad():
        x, _ = c5_flow.inverse_and_ladj(
            torch.randn((n, d), generator=g, device=device))
        log_q0 = _flow_log_q(c5_flow, x)
    log_w = torch.randn(n, generator=g, device=device)  # rel. ESS ~0.37
    anc = torch.arange(n, dtype=torch.int32, device=device)
    normals = torch.randn((cfg.n_mutation_steps, n, d), generator=g,
                          device=device)
    uniforms = torch.rand((cfg.n_mutation_steps, n), generator=g,
                          device=device)
    u0 = torch.rand((), generator=g, device=device)
    beta, eps = torch.tensor(0.3, device=device), torch.tensor(
        0.2, device=device)

    def stage(m):
        return _stage_math(target.log_density, cfg, x, log_w, log_q0, anc,
                           beta, eps, c5_flow, c5_flow, u0,
                           lambda s: (normals[s], uniforms[s]), m)

    # each way `repeats` times, in the order A B B A ..., so that the
    # medians share the host's drift
    order = [(None, mesh) if i % 2 == 0 else (mesh, None)
             for i in range(repeats)]
    order = [m for pair in order for m in pair]
    stage_s = {"unsharded": [], "sharded": []}
    outs = {}
    for m in order:
        way = "unsharded" if m is None else "sharded"
        o, secs = clock(lambda: stage(m))
        outs.setdefault(way, o)
        stage_s[way].append(secs)
        del o
    plain, sharded = outs["unsharded"], outs["sharded"]
    resampled = [bool(o[8] < cfg.resample_threshold) for o in (plain,
                                                               sharded)]
    dx = float(torch.max(torch.abs(sharded[0] - plain[0])))
    dlw = float(torch.max(torch.abs(sharded[1] - plain[1])))
    out["stage"] = {
        "seconds_unsharded": stage_s["unsharded"],
        "seconds_sharded": stage_s["sharded"],
        "median_s_unsharded": statistics.median(stage_s["unsharded"]),
        "median_s_sharded": statistics.median(stage_s["sharded"]),
        "resampled": resampled, "beta": [float(plain[4]),
                                         float(sharded[4])],
        "ancestors_equal": torch.equal(plain[3], sharded[3]),
        "max_abs_dx": dx, "max_abs_dlog_w": dlw,
        "bits_differ_x": _bits_differ(plain[0], sharded[0]),
        "bar": DIST_STAGE_BAR}
    if not (resampled[0] and resampled[1]) or not torch.equal(
            plain[3], sharded[3]) or float(plain[4]) != float(sharded[4]) \
            or not (dx <= DIST_STAGE_BAR and dlw <= DIST_STAGE_BAR):
        failures.append(f"the sharded stage differs from the unsharded "
                        f"one: {out['stage']}")
    del normals, uniforms, plain, sharded, outs

    # (d) one data-parallel step against one step on the same batch
    batch = x[:8192]
    a, b = copy.deepcopy(c5_flow), copy.deepcopy(c5_flow)
    optimize_flow_dp(gen(5), batch, a, mesh, optimizer=Adam(1e-3),
                     nbatches=1, nepochs=1)
    optimize_flow(col.fold_in_axis_index(gen(5), mesh), batch, b,
                  Adam(1e-3), nbatches=1, nepochs=1)
    dp = max(float(torch.max(torch.abs(p.detach() - q.detach())))
             for p, q in zip(a.parameters(), b.parameters()))
    out["dp_step"] = {"max_abs_dparam": dp, "bar": DIST_STEP_BAR,
                      "bits_differ": sum(_bits_differ(p.detach(), q.detach())
                                         for p, q in zip(a.parameters(),
                                                         b.parameters()))}
    if not dp <= DIST_STEP_BAR:
        failures.append(f"optimize_flow_dp's step differs: {dp}")
    del batch, a, b
    # c5's retrain both ways (`optimize_flow` as the unsharded stage loop
    # calls it, `optimize_flow_dp` as the sharded one does), in the same
    # order as the stages
    steps = cfg.retrain_batches * cfg.retrain_epochs
    fit_ms = {"unsharded": [], "sharded": []}
    for m in order:
        f = copy.deepcopy(c5_flow)
        if m is None:
            _, secs = clock(lambda: optimize_flow(
                gen(7), x, f, Adam(cfg.retrain_lr),
                nbatches=cfg.retrain_batches, nepochs=cfg.retrain_epochs))
        else:
            _, secs = clock(lambda: optimize_flow_dp(
                gen(7), x, f, mesh, optimizer=Adam(cfg.retrain_lr),
                nbatches=cfg.retrain_batches, nepochs=cfg.retrain_epochs))
        fit_ms["unsharded" if m is None else "sharded"].append(
            1e3 * secs / steps)
    out["retrain"] = {"steps": steps, "rows": n,
                      "ms_per_step_unsharded": fit_ms["unsharded"],
                      "ms_per_step_sharded": fit_ms["sharded"],
                      "median_ms_unsharded": statistics.median(
                          fit_ms["unsharded"]),
                      "median_ms_sharded": statistics.median(
                          fit_ms["sharded"])}
    del x

    # (e) sharded NUTS through K1
    funnel = NealsFunnel(dim=warm_state.q.shape[1])
    transition = nuts_cuda.fused_nuts_for_flow(funnel, flow,
                                               max_depth=max_depth)
    nuts_cuda.LAUNCHES = 0
    res, nuts_s = clock(lambda: run_nuts_sharded(
        gen(6), None, warm_state.q[:n_chains], mesh, num_warmup=num_warmup,
        num_samples=num_samples, transition=transition))
    launches = nuts_cuda.LAUNCHES
    xs = to_data_space(flow, res.samples)
    max_rhat = float(split_rhat(xs).max())
    moments = moment_gate(xs[..., :1], [0.0], [funnel.sigma_v ** 2],
                          n_sigma=MOMENT_SIGMA)
    expected = num_warmup + num_samples if on_card else 0
    out["nuts"] = {"seconds": nuts_s, "chains": n_chains,
                   "transitions": num_warmup + num_samples,
                   "launches": launches, "launches_expected": expected,
                   "max_rhat": max_rhat,
                   "min_ess": float(effective_sample_size(xs).min()),
                   "step_size": float(res.step_size),
                   "v_z_mean": moments.max_sigma_mean,
                   "v_z_var": moments.max_sigma_var,
                   "moment_check_passed": moments.passed,
                   "finite": bool(torch.isfinite(xs).all())}
    if launches != expected:
        failures.append(f"K1 launched {launches} times for {expected} "
                        f"transitions of the sharded NUTS")
    if not (max_rhat < RHAT_GATE and moments.passed
            and out["nuts"]["finite"]):
        failures.append(f"the sharded NUTS failed its gates: "
                        f"{out['nuts']}")
    return out, failures


def test_only_modules(device, seed=0):
    """The modules no config reaches, on `device`, each at the size of the
    JAX package's test of it and gated by that test's assertion (the
    Cauchy's bimodal medians excepted, see `cauchy`): the ensemble
    sampler (tests/test_ensemble_evidence.py: Gaussian moments,
    the gradient-free Laplace), the multimodal Cauchy's quantiles and
    modes (tests/test_targets.py), and the posterior layer
    (tests/test_posterior.py: the constrain round trip and support, the
    log-Jacobian against autograd, each marginal's normalization and
    sampling means, the change of variables' normalization, the
    conjugate MAP, the multi-start escape, and NUTS on a bounded
    parameter). One row each, with its values and seconds."""
    import torch
    from tpuflows_torch import targets as T
    from tpuflows_torch.mcmc import run_ensemble, run_nuts
    from tpuflows_torch.util.device import f32_device

    dev = f32_device(device)
    rows = []

    def gen(k):
        return torch.Generator(device=dev).manual_seed(seed * 1000 + k)

    def check(name, fn):
        t = time.perf_counter()
        passed, values = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rows.append({"name": name, "passed": bool(passed),
                     "seconds": time.perf_counter() - t, **values})

    def ensemble_gaussian():
        loc = torch.tensor([1.0, -2.0, 0.5], device=dev)
        scale = torch.tensor([0.5, 1.5, 1.0], device=dev)
        target = T.DiagNormal(loc=loc, scale=scale)
        w0 = torch.randn((64, 3), generator=gen(0), device=dev)
        res = run_ensemble(gen(1), target.log_density, w0, num_warmup=300,
                           num_samples=700)
        draws = res.samples.reshape(-1, 3)
        acc = float(res.accept_rate)
        dm = (draws.mean(0) - loc).abs().max()
        ds = (draws.std(0) - scale).abs().max()
        return (0.1 < acc < 0.9 and dm < 0.15 and ds < 0.2,
                {"accept_rate": acc, "max_mean_error": float(dm),
                 "max_std_error": float(ds)})

    def ensemble_laplace():
        w0 = torch.randn((32, 2), generator=gen(2), device=dev)
        res = run_ensemble(gen(3), lambda x: -torch.sum(torch.abs(x), -1),
                           w0, num_warmup=200, num_samples=400)
        draws = res.samples.reshape(-1, 2)
        dm = draws.mean(0).abs().max()
        ds = (draws.std(0) - math.sqrt(2.0)).abs().max()
        return (dm < 0.2 and ds < 0.3,
                {"max_mean_error": float(dm), "max_std_error": float(ds)})

    def cauchy():
        n, mu, sigma = 400_000, 1.0, 0.2
        t = T.MultimodalCauchy(dim=4, mu=mu, sigma=sigma)
        x = t.sample(gen(4), n, device=dev)
        med = torch.median(x, dim=0).values.abs()
        # the JAX test holds every median within 0.02; in dims 0 and 1
        # the density at the median 0 is 1 / (pi sigma (1 + (mu/sigma)^2))
        # = 0.061, so the median's standard error is 1 / (2 f sqrt(n)) =
        # 0.013 and that bar is 1.5 of them (a correct sampler misses it
        # about one time in four): those two are held to 4 of them
        f0 = 1.0 / (math.pi * sigma * (1.0 + (mu / sigma) ** 2))
        se_modes = 1.0 / (2.0 * f0 * math.sqrt(n))
        q = torch.quantile(x[:, 2], torch.tensor([0.25, 0.75], device=dev))
        dq = (q - torch.tensor([-0.2, 0.2], device=dev)).abs().max()
        near_mode = torch.mean(((x[:, 0].abs() - 1.0).abs() < 0.2).float())
        near_zero = torch.mean((x[:, 0].abs() < 0.2).float())
        return (med[2:].max() < 0.02 and med[:2].max() < 4.0 * se_modes
                and dq < 0.01 and near_mode > 2 * near_zero,
                {"abs_medians": med.tolist(), "median_se_dims01": se_modes,
                 "quartile_error": float(dq),
                 "mass_near_modes": float(near_mode),
                 "mass_near_zero": float(near_zero)})

    prior = T.IndependentPrior([T.Normal(1.0, 2.0), T.LogNormal(0.5, 0.7),
                                T.Exponential(2.0), T.HalfNormal(1.5),
                                T.Uniform(-1.0, 3.0), T.Beta(2.0, 5.0)],
                               device=dev)

    def roundtrip_and_support():
        u = torch.randn((64, 6), generator=gen(5), device=dev)
        err = (prior.unconstrain(prior.constrain(u)) - u).abs()
        th = prior.constrain(4.0 * torch.randn((256, 6), generator=gen(6),
                                               device=dev))
        support = bool((th[:, 1:4] > 0).all()
                       and ((th[:, 4] > -1) & (th[:, 4] < 3)).all()
                       and ((th[:, 5] > 0) & (th[:, 5] < 1)).all())
        ok = bool((err <= 2e-4 + 2e-4 * u.abs()).all()) and support
        return ok, {"max_roundtrip_error": float(err.max()),
                    "in_support": support}

    def ladj_vs_autograd():
        u = torch.randn((8, 6), generator=gen(7), device=dev)
        brute = torch.stack([torch.linalg.slogdet(
            torch.autograd.functional.jacobian(prior.constrain, ui))[1]
            for ui in u])
        err = (prior.constrain_ladj(u) - brute).abs()
        return (bool((err <= 1e-4 + 1e-4 * brute.abs()).all()),
                {"max_error": float(err.max())})

    def normalization():
        grids = [(-15.0, 17.0, 20001), (1e-6, 60.0, 40001),
                 (1e-6, 15.0, 20001), (1e-6, 12.0, 20001),
                 (-1 + 1e-6, 3 - 1e-6, 20001), (1e-6, 1 - 1e-6, 20001)]
        zs = []
        for m, (lo, hi, n) in zip(prior.marginals, grids):
            g = torch.linspace(lo, hi, n, device=dev)
            lp = T.IndependentPrior([m], device=dev).log_pdf(g[:, None])
            zs.append(float(torch.trapezoid(torch.exp(lp), g)))
        # the change of variables keeps the Uniform's mass: IS in u-space
        p = T.IndependentPrior([T.Uniform(-1.0, 3.0)], device=dev)
        u = 4.0 * torch.randn((150_000, 1), generator=gen(8), device=dev)
        logq = (-0.5 * (u / 4.0) ** 2 - math.log(4.0)
                - 0.5 * math.log(2 * math.pi))[:, 0]
        z_u = float(torch.mean(torch.exp(
            p.log_pdf(p.constrain(u)) + p.constrain_ladj(u) - logq)))
        return (all(abs(z - 1.0) < 2e-3 for z in zs)
                and abs(z_u - 1.0) < 0.02,
                {"marginal_masses": zs, "uniform_mass_in_u": z_u})

    def sampling_means():
        th = prior.sample(gen(9), 60_000)
        want = torch.tensor([1.0, math.exp(0.5 + 0.7 ** 2 / 2), 0.5,
                             1.5 * math.sqrt(2 / math.pi), 1.0, 2 / 7],
                            device=dev)
        err = (th.mean(0) - want).abs()
        return (bool((err <= 0.04 + 0.04 * want.abs()).all()),
                {"means": th.mean(0).tolist()})

    def modes():
        y = torch.tensor([0.8, 1.2, 1.0, 0.6], device=dev)
        post = T.Posterior(
            lambda th: -0.5 * torch.sum((y - th[..., 0][..., None]) ** 2,
                                        dim=-1),
            T.IndependentPrior([T.Normal(0.0, 1.0)], device=dev))
        res = T.find_mode(post, torch.zeros(1, device=dev), nsteps=400)
        conj = abs(float(res.mode[0]) - float(y.sum()) / 5)
        mix = T.GaussianMixture.bimodal(dim=2, separation=4.0, device=dev)
        far = T.find_mode(mix, torch.zeros(2, device=dev), nsteps=600,
                          n_starts=16, learning_rate=0.1)
        norm = float(torch.linalg.norm(far.mode))
        return (conj < 1e-3 and math.isfinite(float(res.log_density))
                and norm > 1.0,
                {"conjugate_map_error": conj, "bimodal_mode_norm": norm})

    def nuts_bounded():
        y = 1.7 * torch.randn((200,), generator=gen(10), device=dev)

        def loglik(theta):
            s = theta[..., 0]
            return -0.5 * torch.sum(y ** 2) / s ** 2 - y.shape[0] * torch.log(s)

        post = T.Posterior(loglik, T.IndependentPrior([T.LogNormal(0.0, 1.0)],
                                                      device=dev))
        q0 = post.sample_prior(gen(11), 32)
        # the JAX test's 32 chains at half its 200 + 200 steps (a host-paced
        # loop: 21.6 s at 200 + 200 on an H100's host, PERF.md)
        res = run_nuts(gen(12), post.log_density, q0,
                       num_warmup=POSTERIOR_NUTS_STEPS,
                       num_samples=POSTERIOR_NUTS_STEPS, max_depth=6,
                       per_chain_step_size=True)
        sig = post.constrain(res.samples.reshape(-1, 1))[:, 0]
        err = abs(float(sig.mean()) - float(y.std()))
        return (bool((sig > 0).all()) and err < 0.15,
                {"posterior_mean_sigma": float(sig.mean()),
                 "data_std": float(y.std()), "error": err})

    for name, fn in (("ensemble_gaussian", ensemble_gaussian),
                     ("ensemble_laplace", ensemble_laplace),
                     ("cauchy_quantiles", cauchy),
                     ("prior_roundtrip_support", roundtrip_and_support),
                     ("prior_ladj_vs_autograd", ladj_vs_autograd),
                     ("prior_normalization", normalization),
                     ("prior_sampling_means", sampling_means),
                     ("find_mode", modes),
                     ("posterior_nuts_bounded", nuts_bounded)):
        check(name, fn)
    return rows


def flow_specs(flow):
    """A flow's modules as `convert.flow_from_jax_modules` dicts
    (`convert.module_spec`, numpy leaves), for the JAX package on the
    CPU."""
    from tpuflows_torch.convert import module_spec

    def numpy(v):
        if isinstance(v, list):
            return [numpy(x) for x in v]
        return v.numpy() if hasattr(v, "numpy") else v

    return [{k: numpy(v) for k, v in module_spec(t).items()}
            for t in flow.transforms]


def save_generic_state(path, flow, state, max_depth=MAX_DEPTH):
    """The generic path's trained flow (`flow_specs`) and post-warmup
    state, for the plain-versus-JAX spread on the CPU
    (`python tests/test_torch_nuts_spline.py PATH`)."""
    import torch

    torch.save({"modules": flow_specs(flow),
                "q": state.q.detach().cpu().numpy(),
                "step_size": float(state.step_size),
                "inv_mass": state.inv_mass.detach().cpu().numpy(),
                "seed": 8, "max_depth": max_depth}, path)


def main(argv=None):
    """`--save-generic-state PATH` also writes the generic path's trained
    flow and post-warmup state to PATH. `--run-configs NAMES` runs only
    `run_configs` on the comma-separated configs NAMES, on kernels built
    already, and prints its rows as one JSON object (`run_aside`);
    `--spline-reach` likewise the checks of spline_reach_vs_plain
    (`spline_reach_aside`)."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save-generic-state", metavar="PATH")
    parser.add_argument("--run-configs", metavar="NAMES")
    parser.add_argument("--spline-reach", action="store_true")
    args = parser.parse_args(argv)
    save_state = args.save_generic_state
    t = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.run_configs:
        rows = run_configs("cuda", names=tuple(args.run_configs.split(",")))
        print(json.dumps({"run_configs": rows}), flush=True)
        return 0
    if args.spline_reach:
        from tpuflows_torch.kernels import coupling_cuda, rqs_cuda

        reset_kernel_launches()
        res, bad = spline_reach_vs_plain("cuda")
        print(json.dumps({
            "spline_reach": res, "bad": bad,
            "launches": {"k4_k5": dict(rqs_cuda.LAUNCHES),
                         "k6_k7": dict(coupling_cuda.LAUNCHES),
                         "k6_k7_wide": dict(coupling_cuda.WIDE_LAUNCHES)},
            "seconds": time.perf_counter() - t}), flush=True)
        return 0
    from tpuflows_torch.kernels import (coupling_cuda, cuda_build,
                                        fused_logp_cuda, nuts_cuda,
                                        nuts_window_cuda, rqs_cuda)

    smi = nvidia_smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", t, nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    device = "cuda"

    t = time.perf_counter()
    infos = cuda_build.build(nuts_cuda.LIBRARY, rqs_cuda.LIBRARY,
                             coupling_cuda.LIBRARY, coupling_cuda.EARLIER,
                             fused_logp_cuda.LIBRARY,
                             nuts_window_cuda.LIBRARY)
    ptxas = {k: v for i in infos.values()
             for k, v in ptxas_summary(i.log).items()}
    emit("build", t,
         nvcc_seconds=max(i.seconds for i in infos.values()),
         libraries=[i.path for i in infos.values()], ptxas=ptxas)

    t = time.perf_counter()
    rqs_rows = rqs_vs_plain(device)
    emit("rqs_vs_plain", t, rows=rqs_rows,
         bar={"atol": RQS_ATOL, "rtol": RQS_RTOL})
    bad = [r for r in rqs_rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"K4/K5 disagree with their plain versions: "
                           f"{bad}")

    for phase, fn in (("k4_vs_earlier", k4_vs_earlier),
                      ("k5_vs_earlier", k5_vs_earlier)):
        t = time.perf_counter()
        bit_rows = fn(device)
        differ = sum(r["bits_differ"] for r in bit_rows)
        emit(phase, t, rows=bit_rows, bits_differ=differ)
        if differ:
            raise RuntimeError(f"{phase}: {differ} elements differ in bits "
                               f"from the one-thread kernel")

    t = time.perf_counter()
    # the setting of the JAX kernel's on-chip bar: unit metric, eps 0.3
    cmp = kernel_vs_plain(device, bench_flow_with_random_head(device, 2),
                          N_CHAINS, MAX_DEPTH, eps=0.3, seed=3,
                          unit_metric=True)
    emit("kernel_vs_plain", t, **cmp,
         bar={"flips": MAX_FLIPS, "denergy": MAX_DENERGY, "dq": MAX_DQ})
    if not cmp["passed"]:
        raise RuntimeError(f"K1 disagrees with its plain version: {cmp}")

    t = time.perf_counter()
    rows = kernel_shapes(device)
    emit("kernel_shapes", t, rows=rows)
    bad = [r for r in rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"K1 disagrees with its plain version: {bad}")

    t = time.perf_counter()
    spline_rows = kernel_vs_plain_spline(device)
    emit("kernel_vs_plain_spline", t, rows=spline_rows,
         bar={"flips": MAX_FLIPS, "denergy": MAX_DENERGY, "dq": MAX_DQ})
    bad = [r for r in spline_rows if r["gated"] and not r["passed"]]
    if bad:
        raise RuntimeError(f"K1 (module list) disagrees with its plain "
                           f"version: {bad}")

    t = time.perf_counter()
    target_rows, target_tiles, target_times = targets_vs_plain(device)
    emit("targets_vs_plain", t, rows=target_rows, tile_vs_warp=target_tiles,
         timing=target_times,
         bar={"k1": {"flips": MAX_FLIPS, "denergy": MAX_DENERGY,
                     "dq": MAX_DQ},
              "k1_rule": "against the plain version in float64, "
                         "refereed_bar: twice the float32 plain "
                         "version's distance from float64 where larger",
              "k2": "against the plain transition in float64 slot by "
                    "slot, window_bar over the float32 plain window's "
                    "distance from it; bitwise_k1 0 on every slot",
              "k3": {"atol": RQS_ATOL, "rtol": RQS_RTOL,
                     "quantile": "block_quantile"},
              "tile_vs_warp": "equal in value in every mode"})
    bad = [r for r in target_rows + target_tiles if not r["passed"]]
    if bad:
        raise RuntimeError(f"K1, K2 or K3 over the target library disagrees "
                           f"with its plain version, with K1 or with the "
                           f"per-warp kernel: {bad}")

    t = time.perf_counter()
    cond_rows, cond_tiles, cond_times = conditioners_vs_plain(device,
                                                              ptxas=ptxas)
    emit("conditioners_vs_plain", t, rows=cond_rows, tile_vs_warp=cond_tiles,
         timing=cond_times,
         bar="as targets_vs_plain: K1 refereed_bar against float64, K2 "
             "bitwise_k1 0 and refereed slots, K3 judge; tile_vs_warp "
             "equal in value in every mode")
    bad = [r for r in cond_rows + cond_tiles if not r["passed"]]
    if bad:
        raise RuntimeError(f"K1, K2 or K3 under a conditioner of another "
                           f"form disagrees with its plain version, with K1 "
                           f"or with the per-warp kernel: {bad}")

    t = time.perf_counter()
    reach_rows, reach_tiles, reach_times, wide_checks, wide_build = \
        reach_vs_plain(device)
    emit("reach_vs_plain", t, rows=reach_rows, tile_vs_warp=reach_tiles,
         timing=reach_times, wide_vs_warp=wide_checks,
         wide_build=wide_build,
         bar="as targets_vs_plain: K1 refereed_bar against float64, K2 "
             "bitwise_k1 0 and refereed slots, K3 judge; tile_vs_warp "
             "equal in value in every mode; the deep row deeper than 10; "
             "the wide units equal in value to the per-warp kernels in "
             "K1, K2 and K3 on every target kind")
    bad = [r for r in reach_rows + reach_tiles + wide_checks
           if not r["passed"]]
    if bad or len(wide_checks) != len(TARGET_ROWS):
        raise RuntimeError(f"K1, K2 or K3 past the register units' reach "
                           f"disagrees with its plain version, with K1 or "
                           f"with the per-warp kernel: {bad}")

    t = time.perf_counter()
    res, flow, warm_state = main_path(device)
    emit("main_path", t, **res)
    check_main_path(res)

    t = time.perf_counter()
    tim = time_kernel(flow, warm_state)
    emit("timing", t, **tim)
    if not tim["vs_plain_at_state"]["passed"]:
        raise RuntimeError("K1 disagrees with its plain version at the main "
                           f"path's state: {tim['vs_plain_at_state']}")

    t = time.perf_counter()
    gres, gflow, gstate = main_path(device, variant="generic",
                                    train_steps=GENERIC_TRAIN_STEPS)
    emit("main_path_generic", t, **gres)
    check_main_path(gres)

    t = time.perf_counter()
    rqs_tim = time_rqs(device, ptxas)
    gtim = time_kernel(gflow, gstate, n_reps=10, plain_reps=2,
                       cpu_randomness=True)
    if save_state:
        save_generic_state(save_state, gflow, gstate)
    emit("timing_generic", t, rqs=rqs_tim, k1=gtim)
    if not gtim["vs_plain_at_state"]["passed"]:
        raise RuntimeError("K1 (module list) disagrees with its plain "
                           "version at the generic path's state: "
                           f"{gtim['vs_plain_at_state']}")

    t = time.perf_counter()
    block_rows = coupling_vs_plain(device)
    emit("coupling_vs_plain", t, rows=block_rows,
         bar={"atol": RQS_ATOL, "rtol": RQS_RTOL,
              "quantile": "block_quantile"})
    bad = [r for r in block_rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"K6/K7 disagree with their plain versions: "
                           f"{bad}")


    t = time.perf_counter()
    fres, _, _ = main_path(device, variant="generic", use_pallas="fused",
                           train_steps=FUSED_TRAIN_STEPS)
    emit("main_path_generic_fused", t, **fres)
    check_main_path(fres)

    t = time.perf_counter()
    block_tim = time_coupling(device)
    emit("timing_coupling", t, rows=block_tim,
         forms=time_coupling_forms(device),
         fit_step_launches={k: v // fres["train_steps"] for k, v in
                            fres["coupling_launches_fit"].items()})

    t = time.perf_counter()
    k3_rows = fused_logp_vs_plain(device, fused_logp_rows(device) + [
        ("ceiling post-warmup state", flow, N_CHAINS, warm_state.q),
        ("generic post-warmup state", gflow, N_CHAINS, gstate.q)])
    emit("fused_logp_vs_plain", t, rows=k3_rows,
         bar={"atol": RQS_ATOL, "rtol": RQS_RTOL,
              "quantile": "block_quantile"})
    bad = [r for r in k3_rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"K3 disagrees with its plain version: {bad}")

    t = time.perf_counter()
    states = [("ceiling post-warmup state", flow, warm_state),
              ("generic post-warmup state", gflow, gstate)]
    tile_rows = tile_vs_warp(
        device, k1_states=states,
        k3_states=[("ceiling post-warmup state", flow, warm_state.q),
                   ("generic post-warmup state", gflow, gstate.q)],
        k2_states=states)
    emit("tile_vs_warp", t, rows=tile_rows,
         bar="every element of every output equal in value to the "
             "per-warp kernel's at every R measured (a zero's sign may "
             "differ: zero_signs)")
    bad = [r for r in tile_rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"a tile kernel differs from the per-warp "
                           f"kernel: {bad}")

    portable = {}
    for variant, vflow, phase in ((("ceiling", flow, "main_path_portable"),
                                   ("generic", gflow,
                                    "main_path_portable_generic"))):
        t = time.perf_counter()
        portable[variant] = main_path_portable(device, variant, vflow)
        emit(phase, t, **portable[variant])
        check_portable(portable[variant])

    t = time.perf_counter()
    vs_k1 = {"ceiling": portable_vs_k1(flow, warm_state, tim["dq_bar"]),
             "generic": portable_vs_k1(gflow, gstate, gtim["dq_bar"],
                                       cpu_randomness=True)}
    emit("portable_vs_k1", t, **vs_k1,
         bar={"flips": MAX_FLIPS, "denergy": MAX_DENERGY})
    bad = {k: v for k, v in vs_k1.items() if not v["passed"]}
    if bad:
        raise RuntimeError(f"the portable transition through K3 disagrees "
                           f"with K1: {bad}")

    t = time.perf_counter()
    hmc = hmc_vs_plain(flow, warm_state)
    emit("hmc_vs_plain", t, **hmc,
         bar={"flips": MAX_FLIPS, "dq": MAX_DQ})
    if not hmc["passed"]:
        raise RuntimeError(f"HMC through K3 disagrees with its plain "
                           f"version: {hmc}")

    t = time.perf_counter()
    k3_tim = {"ceiling": time_fused_logp(flow, warm_state, tim["ms"]),
              "generic": time_fused_logp(gflow, gstate, gtim["ms"],
                                         n_reps=20, plain_reps=3,
                                         trans_reps=2, cpu_randomness=True)}
    for variant, r in k3_tim.items():
        r["launches_main_path"] = portable[variant]["k3_launches"]
        r["library_ms"] = None
    emit("timing_fused_logp", t, **k3_tim)

    t = time.perf_counter()
    win_rows = window_vs_plain(device, window_rows(device)) + \
        window_vs_plain(device, [
            (f"{variant} post-warmup state", vflow, st.q.contiguous(),
             st.inv_mass, st.step_size, MAX_DEPTH, WINDOW_SLOTS, 8)
            for variant, vflow, st in (("ceiling", flow, warm_state),
                                       ("generic", gflow, gstate))],
            full_plain=True, checked_slots=POST_WARMUP_CHECKED_SLOTS)
    emit("window_vs_plain", t, rows=win_rows,
         bar={"flips": MAX_FLIPS, "denergy": MAX_DENERGY, "dq": MAX_DQ,
              "rule": "window_bar: per slot, each slot from K2's own "
                      "previous draw; the larger of these and twice the "
                      "spread of the two plain versions, per row"})
    bad = [r for r in win_rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"K2 disagrees with its plain version or with "
                           f"K1, slot by slot: {bad}")

    window_paths = {}
    for variant, vflow, phase in (("ceiling", flow, "main_path_window"),
                                  ("generic", gflow,
                                   "main_path_window_generic")):
        t = time.perf_counter()
        window_paths[variant] = main_path_window(device, variant, vflow)
        emit(phase, t, **window_paths[variant])
        check_window(window_paths[variant])

    t = time.perf_counter()
    plain_at = {r["label"].split()[0]: r["plain_window_ms"]
                for r in win_rows if "plain_window_ms" in r}
    k2_tim = {"ceiling": time_window(flow, warm_state, tim["ms"],
                                     plain_at["ceiling"]),
              # the per-warp yardstick (0.6 s a window) once, not in
              # turns: 9 s of the phase's 24 s
              "generic": time_window(gflow, gstate, gtim["ms"],
                                     plain_at["generic"], n_reps=3,
                                     graph_reps=2, graph_replays=1,
                                     warp_turns=1)}
    for variant, r in k2_tim.items():
        r["launches_main_path"] = window_paths[variant]["k2_launches"]
        r["library_ms"] = None
    emit("timing_window", t, **k2_tim)

    t = time.perf_counter()
    smc_results = {}
    aside, wait_aside = run_aside()
    reach_proc, wait_reach = spline_reach_aside()
    try:
        here = run_configs(device, results=smc_results,
                           names=tuple(c for c in RUN_CONFIGS if not any(
                               c in g for g in RUN_ASIDE)))
        there = wait_aside()
        reach, reach_failed, reach_launches, reach_seconds = wait_reach()
    finally:
        for proc in [*aside, reach_proc]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    run_rows = sorted(here + there,
                      key=lambda r: RUN_CONFIGS.index(r["config"]))
    emit("run_configs", t, rows=run_rows,
         bar={"margin_sigmas": RUN_MARGIN_SIGMAS, "max_rhat": RHAT_GATE,
              "smc_log_z": f"{SMC_LOGZ_SIGMAS} sigma + {SMC_LOGZ_SLACK}",
              "smc_moment_sigma": SMC_MOMENT_SIGMA})
    bad = [r for r in run_rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"the config runner failed its gates: {bad}")
    runner = {r["config"]: r for r in run_rows}
    c5_launches = runner["c5_hierarchical_smc"]["kernel_launches"]

    # the checks ran beside run_configs; their failure is raised after
    # the other phases have run, so that one card run shows them too
    t = time.perf_counter()
    reach.update(spline_reach_timing(device, reach["nuts"]))
    emit("spline_reach_vs_plain", t, **reach, launches=reach_launches,
         checks_seconds=reach_seconds,
         bar={"k4_k5": "judge against the plain version with the float64 "
                       "referee; 0 differing bits against the one-thread "
                       "kernels",
              "k6_k7": "judge at block_quantile with "
                       f"{SPLINE_REACH_WITNESSES} permuted-conditioner "
                       "witnesses; the wide unit forced at "
                       "SPLINE_REACH_FORCED equal to the tile kernels to "
                       "the bit",
              "k1_k2_k3": "K = 96 as reach_vs_plain (refereed_bar, with "
                          "2 permuted-flow witnesses), K = 1000 K1 and "
                          "K2's slot against their float32 plain versions "
                          "by K1's bar; bitwise_k1 0; K3 by judge"})

    t = time.perf_counter()
    ev_rows = evidence_c5(device, *smc_results["c5_hierarchical_smc"])
    emit("evidence_c5", t, rows=ev_rows,
         bar={"min_ess_share": EVIDENCE_MIN_ESS_SHARE,
              "ses": EVIDENCE_SES, "slack": EVIDENCE_SLACK})
    bad = [r for r in ev_rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"an evidence estimate failed its gate: {bad}")
    c5_flow = smc_results["c5_hierarchical_smc"][0].flow
    del smc_results
    torch.cuda.empty_cache()

    t = time.perf_counter()
    only_rows = test_only_modules(device)
    emit("test_only_modules", t, rows=only_rows)
    bad = [r for r in only_rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"a module only tests reach failed its JAX "
                           f"test's check: {bad}")

    t = time.perf_counter()
    dist_res, dist_failures = dist_world_of_one(device, flow, warm_state,
                                                c5_flow)
    emit("dist_world_of_one", t, **dist_res,
         bar={"collectives_rtol": DIST_RTOL, "stage": DIST_STAGE_BAR,
              "dp_step": DIST_STEP_BAR, "max_rhat": RHAT_GATE,
              "moment_sigma": MOMENT_SIGMA})
    if dist_failures:
        raise RuntimeError(f"dist_world_of_one: {dist_failures}")
    torch.distributed.destroy_process_group()

    k1 = "src/tpuflows/kernels/nuts_pallas.py:407"
    kernels = [{
        "name": "nuts_transition (affine)", "route": "cuda",
        "source": "src/tpuflows_torch/csrc/nuts_transition.cu",
        "replaces": k1, "launches": res["launches"],
        "launches_runner_c4": runner["c4_funnel_nuts"]["k1_launches"],
        "launches_runner_c5": c5_launches["k1"],
        "launches_dist": dist_res["nuts"]["launches"],
        "max_abs_err": cmp["max_dq"], "ms": tim["ms"],
        "device_ms": tim["tile_device_ms"], "rows": tim["rows"],
        "resident": tim["resident"], "earlier_ms": tim["warp_ms"],
        "earlier_device_ms": tim["warp_device_ms"],
        "plain_ms": tim["plain_ms"], "bound_ms": tim["bound_ms"],
        "bound_by": tim["bound_by"], "library_ms": None,
    }, {
        "name": "nuts_transition (module list, spline)", "route": "cuda",
        "source": "src/tpuflows_torch/csrc/nuts_transition.cu",
        "replaces": k1, "launches": gres["launches"],
        "launches_runner_c5": c5_launches["k1"],
        "max_abs_err": spline_rows[0]["max_dq"], "ms": gtim["ms"],
        "device_ms": gtim["tile_device_ms"], "rows": gtim["rows"],
        "resident": gtim["resident"], "earlier_ms": gtim["warp_ms"],
        "earlier_device_ms": gtim["warp_device_ms"],
        "plain_ms": gtim["plain_ms"], "bound_ms": gtim["bound_ms"],
        "bound_by": gtim["bound_by"], "library_ms": None,
    }]
    wide_src = "src/tpuflows_torch/csrc/{}_wide.cu"
    for r in reach_times:  # K1 on every reach row; K2, K3 past d = 256
        kernels.append({
            "name": f"nuts_transition{' wide' if r['wide'] else ''} "
                    f"({r['label']})", "route": "cuda",
            "source": (wide_src.format("nuts_transition") if r["wide"]
                       else "src/tpuflows_torch/csrc/nuts_transition.cu"),
            "replaces": k1,
            "launches": (runner[REACH_VARIANT]["k1_wide_launches"]
                         if r["variant_shape"] else 0),
            "launches_config": REACH_VARIANT if r["variant_shape"] else None,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
        for key, src, replaces in (
                ("k2", "nuts_window", "nuts_pallas.py:831"),
                ("k3", "fused_logp", "fused_logp.py:140")):
            if key in r:
                x = r[key]
                kernels.append({
                    "name": f"{src} wide ({r['label']})", "route": "cuda",
                    "source": wide_src.format(src),
                    "replaces": "src/tpuflows/kernels/" + replaces,
                    "launches": 0, "max_abs_err": x["max_abs_err"],
                    "ms": x["ms"], "device_ms": x["device_ms"],
                    "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
                    "bound_by": x["bound_by"], "library_ms": None})
    for r in [*target_times, cond_times[-1]]:  # the nuts variants' flows
        config = r.get("config", CONDITIONER_VARIANT)
        kernels.append({
            "name": f"nuts_transition ({r['label']})", "route": "cuda",
            "source": "src/tpuflows_torch/csrc/nuts_transition.cu",
            "replaces": k1, "launches": runner[config]["k1_launches"],
            "launches_config": config, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "device_ms": r["device_ms"], "rows": r["rows"],
            "resident": r["resident"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    fit_rows = [r for r in rqs_rows if r["n"] == RQS_SHAPES[0][0]]
    for key, name, replaces in (
            ("k4_forward", "rqs_eval forward (K4)", ":204"),
            ("k4_inverse", "rqs_eval inverse (K4)", ":204"),
            ("k5_forward", "rqs_grad forward (K5)", ":240"),
            ("k5_inverse", "rqs_grad inverse (K5)", ":240")):
        r = rqs_tim[key]
        row = next(x for x in fit_rows if x["direction"] in key)
        errs = ("y", "ladj") if key.startswith("k4") else ("dx", "draw")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/tpuflows_torch/csrc/rqs_spline.cu",
            "replaces": "src/tpuflows/kernels/rqs_pallas.py" + replaces,
            "launches": gres["rqs_launches"][key],
            "launches_runner_c2": runner["c2_correlated_rqs"][
                "rqs_launches"][key],
            "launches_runner_c3": {
                c: runner[c]["rqs_launches"][key] for c in (
                    "c3_mixture_adaptive",
                    "c3_mixture_adaptive_two_rounds")},
            "launches_runner_c5": c5_launches[key],
            "max_abs_err": max(row[e]["max_abs"] for e in errs),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
        kernels[-1].update(  # the one-thread kernel it replaced
            earlier_ms=r["earlier_ms"],
            earlier_device_ms=r["earlier_device_ms"], lanes=r["lanes"],
            cold_device_ms=r["cold_device_ms"],
            earlier_cold_device_ms=r["earlier_cold_device_ms"])
    fit_block = block_tim[0]
    for key, name, replaces in (
            ("k6_forward", "coupling_block forward (K6)", ":185"),
            ("k6_inverse", "coupling_block inverse (K6)", ":185"),
            ("k7_forward", "coupling_block pullback, forward (K7)", ":215"),
            ("k7_inverse", "coupling_block pullback, inverse (K7)", ":215")):
        r = fit_block[key]
        row = next(x for x in block_rows if x["n"] == fit_block["n"]
                   and x["d"] == fit_block["d"]
                   and x["mask"] == fit_block["mask"]
                   and x["head"] == "n0.1" and x["direction"] in key)
        errs = (("z", "ladj") if key.startswith("k6")
                else ("dx", *COUPLING_PARAMS))
        plan = fit_block["plans"][key[:2]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/tpuflows_torch/csrc/coupling_tile.cu",
            "replaces": "src/tpuflows/kernels/coupling_pallas.py" + replaces,
            "launches": fres["coupling_launches"][key],
            "launches_runner_c5": c5_launches[key],
            "max_abs_err": max(row[e]["max_abs"] for e in errs),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "rows": plan["rows"], "cluster": coupling_cuda.CLUSTER,
            "earlier_ms": r["earlier_ms"],
            "earlier_device_ms": r["earlier_device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
        if "pass2" in r and r["with_weight_pass"]:
            kernels[-1]["pass2_device_ms"] = r["pass2"]["device_ms"]
    kernels += spline_reach_kernels(reach, runner)
    for variant, name in (("ceiling", "fused_logp (affine)"),
                          ("generic", "fused_logp (module list, spline)")):
        r = k3_tim[variant]
        row = next(x for x in k3_rows if x["label"] == variant)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/tpuflows_torch/csrc/fused_logp.cu",
            "replaces": "src/tpuflows/kernels/fused_logp.py:140",
            "launches": portable[variant]["k3_launches"],
            "launches_runner_c5": c5_launches["k3"],
            "max_abs_err": max(row[e]["max_abs"] for e in ("lp", "g")),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
        kernels[-1].update(  # the tile kernel and the per-warp one
            device_ms=r["tile_device_ms"], rows=r["rows"],
            resident=r["resident"], earlier_ms=r["warp_ms"],
            earlier_device_ms=r["warp_device_ms"])
    for variant, name, label in (
            ("ceiling", "nuts_window (affine)", "bench"),
            ("generic", "nuts_window (module list, spline)",
             "spline bench")):
        r = k2_tim[variant]
        row = next(x for x in win_rows if x["label"] == label)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/tpuflows_torch/csrc/nuts_window.cu",
            "replaces": "src/tpuflows/kernels/nuts_pallas.py:831",
            "launches": window_paths[variant]["k2_launches"],
            "launches_runner_c5": c5_launches["k2"],
            "max_abs_err": row["vs_plain"]["max_dq"],
            "max_abs_err_covers": row["vs_plain"]["covers"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
        kernels[-1].update(  # the tile kernel and the per-warp one
            device_ms=r["tile_device_ms"], rows=r["rows"],
            resident=r["resident"], earlier_ms=r["warp_ms"],
            earlier_device_ms=r["warp_device_ms"])
    if reach_failed:
        raise RuntimeError(f"spline_reach_vs_plain: K4-K7 past 64 knots or "
                           f"shared memory, or K1-K3 under them, disagree: "
                           f"{reach_failed}")
    print(json.dumps({"total_seconds": time.perf_counter() - T0}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
