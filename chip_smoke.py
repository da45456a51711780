#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py [--profile PATH]

Phases, each of which must pass (any failure exits non-zero before the
result line is printed):

1. print torch/CUDA versions and the card's name and power limit; require a
   CUDA device; pin TF32 off;
2. build both CUDA kernels from victor_tpu_torch/kernels/csrc with nvcc, one
   nvcc process per source, started together;
3. hold the ppoly_eval kernel against its plain PyTorch version at the main
   path's shapes, in f64 and f32, with clamp on and off, on queries that mix
   out-of-range, on-knot, NaN and infinite values; then its multi-channel
   form (K = 2 and 3 tables of 30 knots over one query set, per-point and
   shared tables), including channel k against the single-channel kernel on
   table k, bit for bit; time both versions on the device alone
   (`device_ms`) and the wrapper's host microseconds per call (`host_us`);
   3b. the same comparison at the launch plan's edge shapes (EDGE_CASES: a q
   at a storage offset of one element, odd M, M = 1, M under the vector
   width, one shared table over 9.6M queries, rows shorter than a tile,
   n = 2 and n = 1024, K = 1..4), NaN and inf positions identical;
4. hold the dispersion_final kernel against its plain version on the final
   stage's inputs from the port's own dispersion model (64 parameter points,
   50 x 3000 points each) with NaN, out-of-range and near-knot entries
   planted, in f64 and f32; time both;
5. run the batched BOSS DR12 CMASS likelihood (configs/boss_config.yaml,
   streaming model, exact perf modes, f64, chunk 64) at the notebook golden
   point and the 50 reference grid points of tests/fixtures/
   reference_boss.npz, and check that the ppoly_eval kernel carried it;
6. the same for the dispersion model (exact interior, exact covariance)
   with dispersion_final 'exact' and 'fused': the reference cell-22 point,
   'fused' against 'exact' on the grid, and the dispersion_final kernel's
   launches on the 'fused' path;
7. the default gradient-free modes (make_batched_loglike with no opts_kw)
   of both models, held to victor_tpu's own bounds against the exact modes,
   and the factored covariance against the dense one;
8. the other RSD, matter and real-space options on the BOSS data (kaiser
   with and without the coordinate shift and the approximation,
   euclid_special, linear_bias, anisotropic real-space input,
   realspace_ccf_from_data) at the golden and a displaced point against
   victor_tpu's values (OPTION_GOLDENS), with the ppoly_eval launches of
   each path;
9. the excursion-set fit configs/esm_sampling_config.yaml at full BOSS width
   (Eisenstein-Hu P(k), f64, chunk 64): chi2 and lnL at the config's ref
   point against victor_tpu's (ESM_GOLDENS) for the streaming and the
   dispersion model, and the dispersion model's fused final stage against
   its exact one on 64 points of the prior box;
10. time 4096 parameter points in every configuration above (for
   information);
11. the gradient-free sampling path at full BOSS width, f64:
   a. `python -m victor_tpu_torch eval` on configs/boss_sampling_config.yaml
      in a subprocess at the golden point, and through the CLI's `main` at
      the config's ref point, against victor_tpu's values (EVAL_GOLDENS);
   b. the default sampler through the CLI's `run`: adaptive random-walk
      Metropolis with its defaults (8 chains, 2000 warmup steps, rhat_stop
      0.01, at most MH_N_SAMPLES draws) on configs/boss_config.yaml with the
      params block QUAD_BLOCK, whose posterior must match the grid-quadrature
      truth (QUAD_MEAN, QUAD_STD) and whose draws and R-1 must equal those
      of the ppoly_eval design before its redesign (MH_BEFORE);
      the ppoly_eval kernel must carry the sampler's likelihood, and it is
      held against its plain version on the inputs of each lookup of one
      sampler step, the largest timed with L2 cold and warm;
   c. the ensemble sampler (differential evolution, 64 walkers);
   d. a two-quantile joint fit (two copies of the BOSS data under the
      block-diagonal stack of its covariance): its chi2 at the golden point
      is twice the single dataset's, dense and factored; then a short MH
      run on it and its evals/s;
   e. MH steps/s in the default and in the exact perf modes, and the
      kernels' device time per step under torch.profiler (information);
12. the gradient path at full BOSS width, f64 ('auto' modes resolved for
   gradients: streaming_eval and beta_covariance exact, dispersion_final
   fast):
   a. the ppoly_eval backward kernel against its plain version at the three
      lookups of one gradient of the HMC target (captured, with how their
      queries fall into intervals), at K = 2 and 3 over (8, 150000), at
      EDGE_CASES and at BWD_PATTERNS (a whole row in one interval,
      alternating intervals, sorted runs, one 9.6M-query row, one table
      read by 64 rows), in f64 and f32, NaN and inf positions identical;
      each call twice, for the same bits; the lookups' backward timed;
   b. two 10-step HMC segments from one saved state: the same bits; the
      ops that torch itself flags as non-deterministic on the path, listed;
   c. d lnL / d theta of GRAD_CASES at GOLDEN and DISPLACED against
      victor_tpu's jax.grad (GRAD_GOLDENS) within 1e-8, and 3 backward
      launches per gradient on the streaming path;
   d. `run --sampler hmc` through the CLI with its defaults on QUAD_BLOCK,
      rhat_stop 0.01, at most HMC_DRAWS draws: R-1 < 0.01, moments within
      0.2 sigma and 15% of the quadrature; leapfrogs/s;
   e. `run --sampler nuts` (NUTS_WARMUP, NUTS_SAMPLES), in a process of its
      own beside d: every draw finite and inside the prior box, the moments
      within 0.3 sigma and 25%, mean tree depth and acceptance statistic;
   f. HMC leapfrogs/s with streaming_eval 'exact' and 'fast', and the
      kernels' device time per leapfrog under torch.profiler (information);
13. second derivatives and the optimizer layer at full BOSS width, f64:
   a. the second-order terms of the spline lookup (the fused kernel,
      kernels/ppoly.py::ppoly_eval_second_order: one launch, two with
      d/dcoeffs, and no forward or backward launch) against the composed
      path (the forward and backward kernels on derived tables) entry for
      entry and against autograd with create_graph=True through the plain
      backward, at the three lookups of one Hessian of the BOSS target
      (captured), at K = 2 and 3 over (8, 150000) and at EDGE_CASES, in f64
      and f32, NaN and inf positions identical, each call twice for the
      same bits; the Hessian's lookups timed in f64, fused and composed in
      turns, L2 warm and cold;
   b. -Hessians of lnL of GRAD_CASES at GOLDEN and DISPLACED against
      victor_tpu's jax.hessian (HESS_GOLDENS) within 1e-8 of max|H|; one
      Hessian's wall and device time, second-order launches and peak memory;
   c. `python -m victor_tpu_torch fit configs/boss_sampling_config.yaml`
      with its defaults in a subprocess (the .npz --set lines,
      --covmat-out), started beside phase 12d: best fit, chi2 and Laplace
      sigmas against victor_tpu's (FIT_GOLDENS), stationary, the covmat
      file read back;
   d. `forecast` at the config's ref point: Fisher sigmas against
      FISHER_GOLDENS within 1e-8 relative;
   e. `scan --param fsigma8 --ngrid 9`: its MAP against FIT_GOLDENS, the
      profile minimum at the MAP's chi2, every grid point's profile chi2
      against SCAN_GOLDENS within 1e-5;
   f. `fit --bootstrap 4` with the launch counts set to 0 just before: the
      fit against FIT_GOLDENS at full precision, every refit finite, at
      victor_tpu's refit of the same mock (BOOT_GOLDENS) and polished
      (|grad| < 1e-3), every second-order call one launch of the fused
      kernel (two with d/dcoeffs), and the forward, backward and
      second-order launches, the last also by Hessian lookup (calls and
      kernel launches);
   g. `fit configs/esm_sampling_config.yaml` in f64 (ESM_FIT_STARTS
      starts): the exact 9 x 9 Hessian at the optimum finite (so no
      finite-difference fallback was taken), and
      the Hessian at the ESM ref point against ESM_HESS_GOLDENS within 1e-7
      of max|H|;
14. the evidence path at full BOSS width, f64, on configs/boss_config.yaml
   with the quadrature's params block QUAD_BLOCK ('auto' modes resolved
   gradient-free: streaming_eval fast, factored covariance); each logZ
   gate is 3 of its reported se around the grid-quadrature evidence
   QUAD_LOGZ, each moment gate 0.2 sigma and 15% of QUAD_MEAN/QUAD_STD:
   a. `run --sampler smc` with its defaults (2048 particles, 5 moves, seed
      0) through the CLI: logZ, moments, a finite posterior-predictive p,
      the ppoly_eval launches of every stage (counted, and counted by
      lookup), and (once the card is otherwise idle, after phase 13) the
      kernel held against its plain version on the inputs of each lookup of
      a chunk of 64 of its particles, timed;
   b. the library run_smc stopped after stage 2 (max_stages, checkpoint) and
      resumed equals a's run bit for bit: logZ, ladder, particles, aux;
   c. `run --sampler ns` with its defaults (1024 live points, 256 per
      iteration, 24 steps, dlogz 0.01): logZ, moments, the launches of
      every iteration;
   d. `post` of a's chains with data.likelihood.form=gaussian: finite
      Delta lnZ and efficiency > 0.5; a library reweight of POST_N points
      against victor_tpu's per-point deltas (POST_GOLDENS) within 1e-8;
   e. `tension` of the config against itself: concordance, ln R > 0, the
      parameter shift < 1 sigma, each dataset's logZ;
   f. `compare` of streaming with dispersion (dispersion_final 'fused'):
      |Delta lnZ| within 3 combined se, and the dispersion_final kernel
      launched and held against its plain version on the inputs of one of
      the run's launches, timed;
   g. `analyze configs/boss_sampling_config.yaml`: the MAP's chi2 within
      1e-6 of FIT_GOLDENS, logZ, every output file, the chains and covmat
      read back, and where matplotlib is installed corner.png and
      multipoles.png drawn (Agg) and listed in the report (without it
      `--no-plots`, and a line saying so);
   h. (information) the wall time and evals/s of each run, and the
      kernels' device time of one SMC stage and one NS iteration under
      torch.profiler against wall time.
   a-e and g run in a process of their own (`--evidence-child`) beside
   phase 12d, whose host-bound HMC run leaves the card ~94% idle; the
   kernel comparisons (a, f) and h time the card, so they run in the main
   process after phase 13, with f.
   Cut for time: e, f and g run 1024 particles x 4 moves (the commands'
   default is 4096 x 8: a run of 7 stages then takes ~12 s instead of
   ~80 s) and g's MAP 8 starts (16); a and c run the commands' defaults;
15. the class surface on the card, f64, adopting phase 5's and phase 9's
   bundles (`_bundle=`), against victor_tpu's values on the CPU
   (API_GOLDENS, within 1e-9 of each group's largest value):
   a. `CCFFit` on configs/boss_config.yaml: log_likelihood at GOLDEN and
      DISPLACED (chi2 65.011778, lnL 284.764389 within 1e-8), chi_squared
      and its covariance (diagonal and row sums within 1e-12),
      theory_multipoles (0, 2) and (1, 3) (odd poles ~0), theory_xi at a
      scalar and at (3, 1) x (1, 5), the node values of theory_xi_2D and
      xi_2D_from_multipoles, the interpolated real and redshift multipoles,
      the data vector, correlation_matrix, diagonal_errors, delta_profiles
      and velocity_terms; each theory call exactly 3 ppoly_eval launches;
   b. CCFFit.log_likelihood with DISP_EXACT and dispersion_final='fused'
      as keyword overrides at GOLDEN and DISPLACED within 1e-9 relative of
      the batched path, one dispersion_final launch each, the kernel held
      against its plain version on the inputs of the first;
   c. the cobaya adapter through a minimal stand-in of cobaya's Likelihood
      on the BOSS and the ESM config: logp and derived chi2 equal CCFFit's,
      the ESM derived fsigma8, get_can_provide_params for both;
   d. ExcursionSetProfile on the card: power, the enclosed and the local
      profile, density_evolution both ways after set_normalisation(0.81)
      and (0.6, z=0.57);
   e. BackgroundCosmology's growth_factor, sigma8z and fsigma8 of a card
      tensor against the host floats (1e-12) and d growth / dz by autograd;
   f. (information) the largest lookup of one log_likelihood (B = 1)
      device-only against its bound, the wrapper's host us, the wall ms of
      one log_likelihood and one theory_multipoles call: the class-surface
      rows of the kernels line. `--class-surface` runs phases 2 and 15
      alone;
16. the scale-out layer (parallel/mesh.py) at full BOSS width, f64, exact
   modes:
   a. `make_sharded_loglike` over `make_mesh(('walkers',))` (every card:
      one here) on SCALE_N prior draws against `make_batched_loglike`
      within 1e-12 relative, 3 ppoly_eval launches per chunk per shard;
   b. the same over a 2-way mesh that names cuda:0 twice: the launches
      double; every lookup of the call held against its plain version and
      timed (the phase's row of the kernels line, its launches b's);
   c. `python -m victor_tpu_torch.parallel.probe --device cuda --backend
      gloo`: two processes on cuda:0 (NCCL refuses two ranks on one card),
      started beside phase 12d; `ok`, 3 launches per process;
   d. a short MH run (SCALE_MH) and an SMC run (SCALE_SMC) on QUAD_BLOCK
      with a 2-way mesh against the same runs without: the same accept
      decisions and stage count, chains and logZ within 5e-6 relative;
   e. `utils.profiling.trace` around one 2-way sharded call: the trace
      names the ppoly_eval kernel; `throughput` of the batched path, the
      2-way mesh and the mesh over every card at SCALE_TIMED_N points,
      chunk 64, in turns, and with more than one card the default modes
      batched and over every card (for information).
   `--scale-out` runs phases 2 and 16 alone (the probe first).
   `--cli-cards` (information, for a machine with several cards) builds
   the kernels and runs `python -m victor_tpu_torch run` with its
   defaults under `--sampler smc` and with 30 + 30 steps under `--sampler
   hmc`, each with CUDA_VISIBLE_DEVICES=0 and then with every card
   visible: the CLI meshes SMC over every card and keeps HMC on one; the
   printed results must agree, and the seconds are printed.

Before them the script prints its own wall time. The last two lines are a
JSON summary of the kernels (device-only `ms`, `host_us`; the sampler
row's `ms` is its L2-cold reading, beside `warm_ms`;
a second-order row's `ms` is one call of the fused kernel (L2 warm;
`cold_ms` cold), beside the composed path's `composed_ms`,
`composed_cold_ms` and `composed_host_us`, its `calls` the calls at its
lookup in 13f, its `launches` their kernel launches and
`launches_per_call` one call's; a particle-sampler row's `launches` are its lookup's in 14a's SMC
run, `ns_launches` in 14c's NS run) and the result line {"ok": true, "device": {...}}. `--profile PATH` also
writes a torch.profiler summary of one batch of each timed configuration,
of 20 MH steps in each perf mode and of 2 HMC steps to PATH.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time



class _NoJax:
    """Import hook that refuses jax: the port must run without it."""

    def find_spec(self, name, path=None, target=None):
        if name == 'jax' or name.startswith('jax.'):
            raise ImportError(f'{name}: chip_smoke.py runs without jax')
        return None


sys.meta_path.insert(0, _NoJax())
REPO = os.path.dirname(os.path.abspath(__file__))

NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
EXACT = {'streaming_eval': 'exact', 'beta_covariance': 'exact'}
DISP_EXACT = {'rsd_model': 'dispersion', 'dispersion_interior': 'exact',
              'beta_covariance': 'exact'}
GOLDEN = [0.47, 0.37, 380.0, 1.0]
DISPLACED = [0.55, 0.45, 320.0, 1.05]   # tests/test_golden.py's second point
GOLDEN_CHI2, GOLDEN_LNL = 65.01, 284.76
CHUNK = 64
N_POINTS = 150_000            # n_v * n_mu * n_s at BOSS size
TOL = {'float64': 1e-12, 'float32': 1e-5}
KERNELS = ('ppoly_eval', 'dispersion_final')
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
L2_BYTES = 50e6               # H100 SXM L2 cache
SLEEP_CYCLES = 40_000_000     # ~20 ms of device sleep ahead of timed calls
# a plain version launches tens of kernels per call: few enough calls that
# they all fit the launch queue while the device sleeps
PLAIN_REPS = 10
FP64_FLOPS = 34e12            # H100 SXM f64 outside the tensor cores
FP32_FLOPS = 67e12            # H100 SXM f32 outside the tensor cores

# The other options on the BOSS data: (model-block replacements of
# configs/boss_config.yaml, theory options, extra parameters).
OPTION_CASES = {
    'kaiser': ({}, {'rsd_model': 'kaiser'}, {}),
    'kaiser, no coord shift': (
        {}, {'rsd_model': 'kaiser', 'kaiser_coord_shift': False}, {}),
    'kaiser, approximation': (
        {}, {'rsd_model': 'kaiser', 'kaiser_approximation': True}, {}),
    'kaiser, approximation, no coord shift': (
        {}, {'rsd_model': 'kaiser', 'kaiser_approximation': True,
             'kaiser_coord_shift': False}, {}),
    'euclid_special': ({}, {'rsd_model': 'euclid_special'}, {}),
    'linear_bias': ({'matter_ccf': {'model': 'linear_bias', 'bias': 1.9,
                                    'template_sigma8': 0.628}}, {},
                    {'bias': 1.9}),
    'assume_isotropic=False': ({}, {'assume_isotropic': False}, {}),
    'realspace_ccf_from_data': (
        {'matter_ccf': {'model': 'linear_bias', 'bias': 1.9},
         'realspace_ccf': {'reconstruction': True, 'beta_key': 'beta',
                           'format': 'multipoles',
                           'ccf_keys': ['r', 'monopole', 'quadrupole'],
                           'assume_isotropic': True, 'from_data': True}},
        {}, {'bias': 1.9}),
}
# [chi2, lnL] at GOLDEN and at DISPLACED of each case: victor_tpu on the CPU
# in f64 with streaming_eval and beta_covariance 'exact', recomputed and
# compared with these literals by
# tests/test_torch_models.py::test_chip_smoke_goldens_match_victor_tpu
OPTION_GOLDENS = {
    'kaiser': [[103.90334973043412, 266.8145635915305],
               [135.48492361103663, 252.8322158321048]],
    'kaiser, no coord shift': [[224.80671363329242, 214.80449039428282],
                               [209.96355190759368, 221.0398719623626]],
    'kaiser, approximation': [[637.5782299908184, 69.48381083058015],
                              [760.3149807475982, 33.459324997829924]],
    'kaiser, approximation, no coord shift': [
        [788.8786198337265, 25.27272513139974],
        [849.0928657165173, 8.844471914694964]],
    'euclid_special': [[4880.289795000572, -569.9303663708826],
                       [6267.705008541248, -675.7298948601889]],
    'linear_bias': [[60.62398594067092, 286.8305618815296],
                    [111.94397890650099, 263.31654121889386]],
    'assume_isotropic=False': [[64.3865793192118, 285.05826862045296],
                               [94.92951377149906, 271.03344784912537]],
    'realspace_ccf_from_data': [[60.46448418909605, 286.9058309201396],
                                [104.15990395534946, 266.832233089541]],
}
# the ref point (the `ref` locs) of configs/esm_sampling_config.yaml, and
# [chi2, lnL] there from victor_tpu on the CPU in f64 with exact modes
# (dispersion: exact interior and final stage), checked as OPTION_GOLDENS
ESM_REF = {'f': 0.78, 'sigma_8_0': 0.81, 'b10': -1.544, 'b01': -4.228,
           'Rp': 7.973, 'Rx': 0.467, 'beta': 0.4, 'sigma_v': 380.0,
           'epsilon': 1.0}
ESM_GOLDENS = {'streaming': [85.02881334423897, 275.4473891792755],
               'dispersion': [84.35647845450578, 275.75759471303223]}
# [chi2, lnL] of `python -m victor_tpu eval configs/boss_sampling_config.yaml`
# on the CPU in f64, at GOLDEN (given as --param) and at the config's ref
# point (no --param), recomputed and compared with these literals by
# tests/test_torch_cli.py::test_chip_smoke_eval_goldens
EVAL_GOLDENS = {'golden': [65.01177758054122, 284.76438934894736],
                'ref': [83.81832922423543, 276.006027683185]}
# The posterior that the grid quadrature of tools/validate_posterior.py
# integrates, and its moments (tests/test_optimize.py:25-28): the
# four-parameter block BLOCK_4P of tests/test_optimize.py:13-22 with the
# sigma_v prior [100, 500] of configs/boss_sampling_config.yaml, where the
# quadrature grid ends (BLOCK_4P's own sigma_v prior reaches 700, a wider
# posterior than the one the moments describe). Every other axis of the grid
# lies inside the block's priors, more than 3.5 sigma from each mean.
# tests/test_torch_cli.py::test_chip_smoke_quadrature_block checks these
# literals against both files and the tool's grid.
QUAD_BLOCK = {
    'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.05}},
    'beta': {'prior': {'dist': 'uniform', 'min': 0.2, 'max': 0.6},
             'ref': {'dist': 'norm', 'loc': 0.4, 'scale': 0.03}},
    'sigma_v': {'prior': {'dist': 'uniform', 'min': 100.0, 'max': 500.0},
                'ref': {'dist': 'norm', 'loc': 380.0, 'scale': 30.0}},
    'epsilon': {'prior': {'dist': 'uniform', 'min': 0.8, 'max': 1.2},
                'ref': {'dist': 'norm', 'loc': 1.0, 'scale': 0.02}},
}
QUAD_MEAN = {'fsigma8': 0.573, 'beta': 0.3667, 'sigma_v': 418.0,
             'epsilon': 1.0089}
QUAD_STD = {'fsigma8': 0.054, 'beta': 0.011, 'sigma_v': 44.0,
            'epsilon': 0.011}
# Phase 14: the evidence path. The yardstick is the grid-quadrature
# evidence of tools/validate_posterior.py under QUAD_BLOCK's uniform priors
# (BASELINE.md): a property of the likelihood, not a speed.
QUAD_LOGZ = 278.967
# Phase 14d: victor_tpu's reweight of POST_N points (uniform in QUAD_MEAN +-
# 3 QUAD_STD cut to QUAD_BLOCK's box, np.random.default_rng(POST_SEED)) of
# configs/boss_config.yaml from its sellentin form to the gaussian one, 'auto'
# modes resolved gradient-free: lnL_new - lnL_old per point, on the CPU in
# f64, recomputed and compared with these literals by
# tests/test_torch_post.py::test_chip_smoke_post_goldens_match_victor_tpu
POST_SEED = 8
POST_N = 64
POST_GOLDENS = [-1.2827547472733727, -1.1995190311847068, -1.1767734792036322,
                -1.4112040984360874, -0.8557072758407571, -1.572246313379992,
                -1.309498937378521, -0.863360675357228, -1.0689673807567033,
                -1.4471736941343352, -1.197239888350623, -0.9002395512484895,
                -0.8796718228761051, -1.1067569202106142, -1.4541486415241707,
                -1.042746516015825, -1.0694957695304765, -1.16524186988795,
                -1.1733063332690676, -1.344401847702045, -1.5193557600717895,
                -1.8084146045205216, -1.6386932515015928, -0.902714616743026,
                -1.233471439274524, -0.920215981314243, -1.4131292891319163,
                -1.0550225101915203, -1.3214103161791968, -0.960644938045732,
                -1.535834449491631, -2.014031592783681, -0.9702951389565442,
                -1.610980819281565, -2.25031290358055, -0.9787714569271202,
                -1.096660406011324, -2.0824650160337796, -1.2663624687073138,
                -1.8730752600095002, -1.5494181180057467, -1.2716647173919,
                -1.9496596953063658, -1.5765193701539033, -1.5386095682319478,
                -1.0452072510876746, -1.3312651175098154, -0.9054653354243669,
                -1.607345518694217, -2.2140349333786844, -2.2440359221120048,
                -0.9962097838221666, -1.855648248666057, -1.4182236516572857,
                -1.082757884434784, -1.1951697932025809, -1.4841489485910415,
                -0.97673046649561, -2.4732938503735795, -1.3313207987801547,
                -1.0016125948803278, -0.9075899348078451, -2.2324431298337686,
                -0.9065367389837888]
MH_N_SAMPLES = 8000           # the CLI's draw cap (the default)
# The default MH run of phase 11b before the ppoly_eval redesign (the kernel
# and wrapper of commit 8d0baf7 on an NVIDIA H100 80GB HBM3): draws and max
# R-1 to four places. The redesign keeps each query's arithmetic, so the run
# must repeat. Whether the chains repeat byte for byte is an A/B of two
# checkouts on one software stack: tools/ppoly_timing.py --mh.
MH_BEFORE = (5500, 0.0096)
# Phase 12d: the HMC run's seed and draw cap. The BOSS likelihood jumps at
# the 31 beta-grid points of its data (the reference's covariance blend,
# victor_tpu alike), which slows HMC in beta: seeds 0-5 read max R-1
# 0.012-0.035 at 700 draws, the CLI's default cap (PERF.md §6), so
# the run may take up to HMC_DRAWS draws to reach R-1 < 0.01.
HMC_SEED, HMC_DRAWS = 0, 1500
# Phase 12e's schedule: NUTS runs beside 12d, shortened to fit its time
NUTS_WARMUP, NUTS_SAMPLES = 300, 100
# Phase 12c: the cases whose d lnL / d theta the card must reproduce (opts_kw
# on configs/boss_config.yaml, 'auto' modes resolved for gradients), and
# [gradient at GOLDEN, gradient at DISPLACED] of each from victor_tpu's
# jax.grad on the CPU in f64, recomputed and compared with these literals by
# tests/test_torch_grad.py::test_chip_smoke_grad_goldens_match_victor_tpu
GRAD_CASES = {
    'streaming': {},
    "dispersion, final 'fast'": {'rsd_model': 'dispersion'},
    "dispersion, final 'exact'": {'rsd_model': 'dispersion',
                                  'dispersion_final': 'exact'},
    'kaiser': {'rsd_model': 'kaiser'},
    'assume_isotropic=False': {'assume_isotropic': False},
}
GRAD_GOLDENS = {
    'streaming': [
        [56.45344426963328, -130.2069392753318, -0.003852798635966881,
         190.61201154788787],
        [-15.75898713043464, -44.08340938350945, 0.04969156792760965,
         -194.93946974715587]],
    "dispersion, final 'fast'": [
        [56.38121156419226, -131.33309135655824, -0.0037680618338981064,
         190.06594241088052],
        [-15.85409353574934, -43.7525851912155, 0.04971361373162575,
         -195.4891547939841]],
    "dispersion, final 'exact'": [
        [56.38751430647459, -131.40486063732172, -0.003781073962232928,
         190.05311043174308],
        [-15.846006615092529, -43.88485765461545, 0.04970521800206562,
         -195.53524519149684]],
    'kaiser': [
        [-11.934515880633324, -293.3659756813795, 0.0, 187.51326225467133],
        [-55.71673424725168, -18.389099191615117, 0.0, -185.80174058428557]],
    'assume_isotropic=False': [
        [56.46664057539094, -104.50105367309465, -0.0038783333679028864,
         175.59459641578303],
        [-2.280949331992624, 3.5634327288147776, 0.04069777415296494,
         -291.18816469237646]],
}

# Phase 13: victor_tpu's values on the CPU in f64, recomputed and compared
# with these literals by tests/test_torch_hessian.py (HESS_GOLDENS,
# ESM_HESS_GOLDENS) and tests/test_torch_optimize.py (the others). HESS_GOLDENS: -jax.hessian of
# lnL (= -Hessian of ln post under the uniform priors) of each GRAD_CASES
# case at [GOLDEN, DISPLACED], AD-resolved modes.
HESS_GOLDENS = {
    'streaming': [
        [[642.1986293115659, -168.68823733978428, -0.3743719623414888,
          923.6430987435077],
         [-168.68823733978073, 12679.473342635963, -0.936086212980946,
          -2561.7148533021173],
         [-0.37437196234149095, -0.9360862129809435, 0.0007671003138827607,
          -0.11559389338885939],
         [923.6430987435047, -2561.714853302119, -0.11559389338885946,
          11608.888358023018]],
        [[569.3944630100907, -55.326208468988476, -0.26223370322211703,
          667.5567789419035],
         [-55.32620846898425, 36609.143257488824, 0.09300310335710965,
          -1195.945512474622],
         [-0.2622337032221167, 0.09300310335710726, 0.0003716740685949021,
          -0.0206144898029752],
         [667.556778941906, -1195.9455124746237, -0.02061448980297397,
          8836.736224733444]]],
    "dispersion, final 'fast'": [
        [[642.3892325548452, -166.10959758180542, -0.37453541401738616,
          924.6650486364202],
         [-166.10959758180886, 12291.13888633034, -0.936815934585301,
          -2568.656337420433],
         [-0.3745354140173869, -0.9368159345852991, 0.0007683288441190633,
          -0.12017215258219505],
         [924.6650486364206, -2568.6563374204316, -0.12017215258219578,
          11613.08466072698]],
        [[569.4705225138317, -55.31490098597439, -0.26238610774006604,
          668.6188298033003],
         [-55.314900985976735, 36610.04926219549, 0.09570613904650861,
          -1202.4244246258354],
         [-0.2623861077400651, 0.09570613904650926, 0.00037135790767175774,
          -0.02463094561825674],
         [668.6188298033017, -1202.424424625832, -0.024630945618261946,
          8837.660698718339]]],
    "dispersion, final 'exact'": [
        [[642.3777472441647, -165.9611692797953, -0.3745296029646979,
          924.696978321133],
         [-165.96116927979622, 12278.20975997514, -0.937200089814602,
          -2569.1159655919555],
         [-0.37452960296469984, -0.9372000898146062, 0.0007683569576801465,
          -0.12054853689332923],
         [924.6969783211351, -2569.1159655919537, -0.12054853689332538,
          11614.210277672777]],
        [[569.4493390927818, -55.1254381950749, -0.2623627174971978,
          668.6998768620799],
         [-55.12543819507273, 36591.2247190909, 0.09420474943870803,
          -1203.3630845797773],
         [-0.26236271749719764, 0.09420474943871326, 0.0003713874771726516,
          -0.02517229824709455],
         [668.6998768620801, -1203.3630845797745, -0.025172298247093047,
          8837.565152426852]]],
    'kaiser': [
        [[659.173385851599, -445.0571345686005, 0.0, 941.784527645065],
         [-445.0571345686008, -30519.30064489488, 0.0, -2950.410388418944],
         [0.0, 0.0, 0.0, 0.0],
         [941.7845276450654, -2950.4103884189467, 0.0, 11654.158095857658]],
        [[569.6048510591211, -96.3247799846161, 0.0, 632.5059582738215],
         [-96.32477998461587, 32520.139102532616, 0.0, -1039.3608829195698],
         [0.0, 0.0, 0.0, 0.0],
         [632.505958273822, -1039.3608829195746, 0.0, 8665.851637691514]]],
    'assume_isotropic=False': [
        [[638.3700404034586, -320.77098972260586, -0.37623241601784235,
          908.9309016923946],
         [-320.7709897226036, 11825.943019072174, -0.8083374737524004,
          -1309.6665583003985],
         [-0.37623241601784185, -0.8083374737523985, 0.0007546250962302044,
          -0.10370979413271719],
         [908.930901692395, -1309.6665583003971, -0.10370979413271668,
          11583.080310368505]],
        [[565.7246535859465, -194.11002282972404, -0.25888338202528927,
          647.1911437613155],
         [-194.11002282972336, 38980.94991208428, 0.15570057008176974,
          -183.31550432793722],
         [-0.25888338202529093, 0.15570057008176974, 0.00038669882065191837,
          -0.028773764522212808],
         [647.1911437613117, -183.3155043279408, -0.028773764522209835,
          8544.899128462532]]],
}
# victor_tpu find_map of configs/boss_sampling_config.yaml: the best fit
# (NAMES order), chi2 and the Laplace sigmas
FIT_GOLDENS = {'theta': [0.5799713488435827, 0.367701895106246,
                         429.81188080886545, 1.0082034252665462],
               'chi2': 56.95885572744639,
               'std': [0.05683596955024076, 0.0069556641895644694,
                       48.379437821201236, 0.010332906459898492]}
# victor_tpu's Fisher sigmas at the config's ref point (`forecast`)
FISHER_GOLDENS = [0.05045857861722795, 0.004714197549035467, 44.34503424818853,
                  0.010073282684302739]
# victor_tpu's profile of fsigma8 on the CLI's default grid (9 points,
# MAP +/- 4 Laplace sigmas): the grid and the profile chi2
SCAN_GOLDENS = {'grid': [0.3526274706426197, 0.4094634401928604,
                         0.4662994097431012, 0.523135379293342,
                         0.5799713488435827, 0.6368073183938234,
                         0.6936432879440642, 0.750479257494305,
                         0.8073152270445457],
                'chi2': [76.83089817150605, 67.79273851028728,
                         61.64489713765245, 58.122087916900185,
                         56.9588557314523, 57.893546220569036,
                         60.66152080896403, 65.9759581044858, 74.30866774169687]}
# victor_tpu's four refits of `fit --bootstrap 4` (seed 0: the mocks of
# np.random.default_rng(0) at its MAP), NAMES order
BOOT_GOLDENS = [[0.6081554736566837, 0.3663530173694129, 446.0569533626983,
                 1.0036276745074975],
                [0.5059848648152485, 0.36565969319344394, 393.79554773325964,
                 1.014112416348316],
                [0.6394516241451499, 0.36970143422831137, 446.89552574432594,
                 1.0218510136503545],
                [0.5372849175370796, 0.357364355328475, 397.49583179652825,
                 1.0063936251351693]]
# -jax.hessian of lnL of configs/esm_sampling_config.yaml at ESM_REF (9 x 9)
ESM_HESS_GOLDENS = [[232.27223452549725, 309.0610431653943,
                     -15.692467683961878, -22.70780039479483,
                     -13.190541698763576, 215.81392616855143,
                     -414.64073958701846, -0.2186136019556503,
                     451.1041442982507],
                    [309.0610431653956, 616.2391300835678, -30.073646986724658,
                     -37.45106354443181, -13.943250670249563, 228.2492352833239,
                     -642.1358858308531, -0.33532482582226675,
                     862.4724021177055],
                    [-15.692467683961961, -30.073646986724512,
                     4.605504731280732, 2.944518696817985, -2.087657048324395,
                     34.12021922508835, 22.663091696356826,
                     0.011320894147377443, -85.4768329168829],
                    [-22.70780039479482, -37.451063544431335,
                     2.9445186968179744, 3.698246855284093, 1.4351900383608445,
                     -23.48936067722111, 48.398421011768434,
                     0.025113671448525075, -57.07700103512196],
                    [-13.190541698763587, -13.943250670249368,
                     -2.0876570483243433, 1.4351900383608458, 5.968401204166719,
                     -90.60415424213254, 44.61932073652954,
                     0.023471795740872603, 28.403523030144115],
                    [215.81392616855072, 228.2492352833135, 34.120219225087965,
                     -23.489360677220596, -90.60415424213272,
                     1351.5268770471166, -729.6994771029265,
                     -0.38384576940632475, -464.165242021047],
                    [-414.6407395870184, -642.1358858307909,
                     22.663091696357437, 48.39842101176829, 44.619320736529914,
                     -729.6994771029441, 18002.307441817884,
                     0.08013603948461291, 565.9767202015161],
                    [-0.2186136019556505, -0.335324825822261,
                     0.011320894147377025, 0.025113671448525166,
                     0.023471795740872797, -0.383845769406322,
                     0.08013603948461423, 0.0006817662069136757,
                     0.012553850458274063],
                    [451.1041442982487, 862.4724021176961, -85.47683291688276,
                     -57.07700103512178, 28.403523030143788,
                     -464.16524202100663, 565.9767202015157,
                     0.012553850458271024, 11004.23379071277]]
# Phase 13g: the ESM fit's starts, cut from the CLI's 32 to fit the time
ESM_FIT_STARTS = 8
# Phase 15: the class surface's inputs. theory_xi at API_S (3, 1) against
# API_MU (1, 5) and at the scalar API_XI_POINT; theory_xi_2D and
# xi_2D_from_multipoles (rmax 85: a 50 x 50 grid) at the (s_perp, s_par)
# nodes API_NODES; the profiles at API_R; ExcursionSetProfile(**ESP_ARGS)'s
# P(k, z) at API_K and its profiles (Lagrangian grid linspace(1, 120, 60)) at
# ESP_PROFILE = (z, b10, b01, Rp, Rx), density_evolution after each
# set_normalisation(sigma8, z) of ESP_NORMS; BackgroundCosmology's growth at
# COSMO_Z. API_GOLDENS are victor_tpu's values on the CPU in f64, recomputed
# and compared with these literals by
# tests/test_torch_api.py::test_chip_smoke_api_goldens_match_victor_tpu.
API_BETA = 0.37
API_S = [10.0, 25.0, 40.0]
API_MU = [0.0, 0.3, 0.6, 0.9, 1.0]
API_XI_POINT = [30.0, 0.5]
API_NODES = [[0, 0], [7, 31], [23, 12], [49, 49]]
API_R = [1.0, 8.0, 20.0, 35.0, 50.0, 70.0, 95.0, 120.0]
API_K = [0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 2.0]
ESP_ARGS = {'h': 0.675, 'omega_m': 0.31, 'omega_b': 0.048, 'z': 0.57}
ESP_PROFILE = [0.57, -1.544, -4.228, 7.973, 0.467]
ESP_NORMS = [[0.81, 0.0], [0.6, 0.57]]
COSMO_Z = 0.57
API_GOLDENS = {
    'loglike_golden': [284.76438934895, 65.011777580541],
    'loglike_displaced': [269.08489176599, 99.200997608386],
    'cov_diag': [
        0.0002160237638793, 5.436705285142e-05, 4.0452930008953e-05,
        4.3510113327736e-05, 5.3319463560486e-05, 4.7142409586609e-05,
        4.5569074245635e-05, 4.4777957019377e-05, 4.4152686664616e-05,
        4.0605424284037e-05, 3.5943803141992e-05, 3.0790261781108e-05,
        2.550551256849e-05, 2.0419714157877e-05, 1.6837979258829e-05,
        1.5429492271595e-05, 1.4475025984773e-05, 1.1909766546098e-05,
        1.034753304379e-05, 9.8203453005573e-06, 9.1355130242365e-06,
        8.3660946963419e-06, 7.0270697213725e-06, 6.5632664319757e-06,
        6.139901713829e-06, 6.2406212512094e-06, 5.4365185370604e-06,
        4.7068565286521e-06, 4.5782174942887e-06, 4.3504424393897e-06,
        0.00074401947375533, 0.00012339552845679, 5.7264555241328e-05,
        5.8389494397898e-05, 8.1409820716942e-05, 0.00012342383781289,
        0.00015379554340825, 0.00016266452526203, 0.00016499037287682,
        0.00015901565212795, 0.0001521010770554, 0.00013737314293131,
        0.00012339051563625, 0.00011049251948526, 9.1243883622676e-05,
        7.5827725227156e-05, 7.3842703404049e-05, 6.8203582166802e-05,
        5.8757006953401e-05, 5.1078302741939e-05, 4.8702730695161e-05,
        4.4431325313458e-05, 4.1094652711992e-05, 3.8507916483206e-05,
        3.2120980482082e-05, 3.051482046121e-05, 2.8745123393826e-05,
        2.5670399348021e-05, 2.268922223956e-05, 2.2010677998524e-05],
    'cov_rowsum': [
        0.0003280306809921, 0.00013851266380373, 0.00012848439136585,
        0.00011624351453118, 0.00013997624223647, 0.00014894086924766,
        0.0001431256629515, 0.0001036119847954, 0.00011156560461,
        8.5940214717651e-05, 7.0963180742302e-05, 8.0765509741934e-05,
        5.9870284481166e-05, 5.1265043093096e-05, 4.7681728619361e-05,
        1.5178655258042e-05, 4.4186415906224e-06, 2.5436529117984e-05,
        1.6062794495234e-05, 2.3709110509046e-05, 5.2455042350832e-06,
        2.9774856470805e-05, 2.0435901553854e-05, 2.9625059936284e-05,
        1.9894402931436e-05, 1.6752659802208e-05, 1.1995701352953e-05,
        1.3077282979823e-05, 9.9308886484599e-06, 1.333001537911e-05,
        0.00072670346012929, 0.00013462990864676, 9.9000663814934e-05,
        5.7552571257062e-05, 0.00010262210501173, 0.00021239588918134,
        0.00025434103959987, 0.00034692358642691, 0.00037805573040745,
        0.00044012514166122, 0.00043560137163617, 0.00037241456158145,
        0.00039853574662657, 0.00037256686682165, 0.00032259077020388,
        0.0002453437631729, 0.00024216847368479, 0.00021728500798345,
        0.00025466354899197, 0.00021597566094087, 0.00018516202101237,
        0.00015522590821555, 0.00012665648213339, 0.00011504183532897,
        9.1076180795765e-05, 9.2379723568194e-05, 9.2051321558945e-05,
        7.1311254699153e-05, 4.7454143732365e-05, 4.363657245424e-05],
    'mult': [
       [-0.99984381256456, -0.99914695973197, -0.99554483383605,
        -0.95578542848263, -0.80738582115243, -0.60573181395313,
        -0.46270920345182, -0.34201920385276, -0.22081093383689,
        -0.11553171266887, -0.037619783654853, 0.012656421199107,
        0.040484844625409, 0.05288135948879, 0.055828450300869,
        0.053080338200195, 0.04745346488858, 0.04083397509085,
        0.033980757313808, 0.027384939355168, 0.02135112108347,
        0.016190659110773, 0.011510230580677, 0.0076195710521129,
        0.0048860427773929, 0.0026907614801714, 0.0012067589181233,
        0.00071649842049139, 0.00073477755547721, 0.001067566118304],
       [-3.4622856856566e-05, 9.1032816467173e-05, 0.0030446584678984,
        0.0032497061944537, -0.032701955546416, -0.056790806494971,
        -0.020595514723314, -0.0049729321594376, -0.0019983265297159,
        0.0074700146082247, 0.020138425178605, 0.029804552552038,
        0.034230101536476, 0.034217550531591, 0.031338572040692,
        0.027036104261398, 0.022173385364635, 0.017607755109683,
        0.013741869909244, 0.010116957209466, 0.0073950463177284,
        0.0056127755443268, 0.0043245767471273, 0.0033648105762659,
        0.0026196725820878, 0.0017495819772184, 0.0008849060656336,
        0.00032075180326996, -0.00012186470906518, -0.00032857818748919]],
    'xi_point': -0.34126721460528,
    'xi_grid': [
       [-0.99720376663339, -0.99667025655548, -0.99531697870384,
        -0.99340331815352, -0.99268656298783],
       [-0.48166408472899, -0.48301696783195, -0.4914712611578,
        -0.51700698568284, -0.53024612977351],
       [-0.080080369283877, -0.07804856206735, -0.072183095060326,
        -0.063144974307034, -0.059491228394103]],
    'theory_xi_2D': [
        0.023663748099859, -0.49133608442455, 0.064564619067041,
        0.0012066187938805],
    'xi_2D_from_multipoles': [
        0.023636026835269, -0.49107793814084, 0.064578810319465,
        -0.090788650629828],
    'real_mult': [
       [-1.0000384459517, -0.99924908105319, -0.99755251473949,
        -0.96233583233811, -0.78886560622701, -0.55633264368146,
        -0.42678494824759, -0.31103033571283, -0.19014830701205,
        -0.09063127100607, -0.021587530805071, 0.020258180636543,
        0.041994694954488, 0.050561888685045, 0.051509485598304,
        0.048050705518376, 0.042623409132152, 0.036573219678357,
        0.030261356626573, 0.024623591774139, 0.019353328522967,
        0.014523385841252, 0.010166032059559, 0.0065609444260249,
        0.0038946753527793, 0.0020447723853867, 0.00099284463369899,
        0.00067103906709664, 0.00094967200785236, 0.001474492315237],
       [0.0078869598642841, 0.0013841491978823, -0.00089119648046126,
        -0.00073578646516606, -0.0021862847397362, -0.006302078448614,
        -0.0021765802279985, 0.0010327572358054, 0.001477619576813,
        0.0023642510387889, 0.001195213280398, 8.1352524457285e-05,
        -0.0015394580124546, -0.0024768849611772, -0.0029742865514759,
        -0.0032532236494849, -0.0030751723915231, -0.0031356131413848,
        -0.0031288212921893, -0.0028527845412145, -0.0020903851692564,
        -0.0018407957323752, -0.0014213574602715, -0.0012194720226634,
        -0.00096020920166189, -0.00091062898737875, -0.00079062080660936,
        -0.00052705352706672, -0.00031476479964727, -0.00019731480713391]],
    'datavector': [
        -1.0151088782131, -1.0014025632057, -0.99641851812043,
        -0.95769255462126, -0.81252716734117, -0.61251941363173,
        -0.48033650157542, -0.35905938033352, -0.23467163318715,
        -0.13017126534134, -0.042417667715013, 0.023401897946938,
        0.047261785257027, 0.05276226340229, 0.058034234644395,
        0.059040792717972, 0.051380022564252, 0.041275986072168,
        0.036983837141555, 0.026482305475374, 0.025123773671863,
        0.016689235305559, 0.011854348866137, 0.0099839568410993,
        0.0055422686914744, 0.0017706589199589, 0.0010341747615201,
        -0.00054848925103032, -0.0013830932375179, -0.0020902075577403,
        -0.022962138667661, -0.0020137048040635, 0.01391689723067,
        0.00077568750813388, -0.030844931522174, -0.073565017427001,
        -0.045543306267506, -0.027450027468127, -0.014344124014858,
        0.013983453912423, 0.016934868307587, 0.018207037168664,
        0.01669565506729, 0.03856755340175, 0.022672830060036,
        0.028701483534927, 0.023314888211087, 0.020402293362926,
        0.017670386811566, 0.008253332542652, 0.0058613414893164,
        0.0045406140006156, 0.0065630682449797, 0.0031175837792137,
        0.0024099694043546, 0.0079390845548843, -0.0024418860006152,
        -0.0073386330155557, -0.0019236188245549, 0.001849146924468],
    'corr_rowsum': [
        2.1955477382692, 2.5692467087607, 2.9030044937526, 2.8813132939632,
        3.0299300040343, 3.3318510437882, 3.3404252845091, 2.7473407906756,
        2.7936821128299, 1.8574050840141, 2.0158111317652, 2.1812070121214,
        1.9408711046849, 2.0790956313938, 2.3673564837709, 1.6761431349588,
        1.692917503353, 2.2358994168319, 2.0738111205043, 2.7566199840078,
        2.4931373496591, 3.6014878550314, 3.18274649255, 3.8547717624921,
        3.2927083780015, 3.0132493897987, 2.9678718641227, 2.9792355769103,
        2.4282779588968, 2.4459783673197, 0.92614494673297, 0.79951943005652,
        1.8279572274332, 0.91962681676903, 1.2884070546035, 1.6365811519297,
        1.7307127650502, 2.1644249207674, 2.3989896111599, 2.4792893652641,
        2.6188832543042, 2.255280958552, 2.7085539380824, 2.9367624770957,
        2.9502751443468, 2.8309256743741, 3.1041151852741, 2.9929581485888,
        4.1681847008105, 3.9948726855666, 3.9220059203345, 3.5578802772941,
        3.4881487490608, 3.1970372780021, 3.2953073010874, 3.2646188600747,
        3.1792901174884, 3.0034880409563, 2.2994930600254, 2.0039943467109],
    'delta': [
       [-0.45992896536601, -0.44647630667319, -0.28695206405959,
        -0.075714262144099, 0.011248368849499, 0.017647072440833,
        0.0024720243991047, 0.00014459802555968],
       [-0.46000377985954, -0.45303428646866, -0.36670010402401,
        -0.19192147797472, -0.077847728274253, -0.016264368709722,
        -0.0015108982806426, -0.00064910211231697]],
    'velocity': [
       [10.04442532133, 79.17911640497, 160.17322400056, 146.72494777867,
        85.020934656677, 24.868247332815, 3.1355386652512, 1.6730347310129],
       [10.042905498038, 9.46583864908, 2.7840059404707, -3.4227832124458,
        -4.1379277452137, -1.866910081595, -0.22799315082757,
        -0.037831833417832]],
    'esm_loglike': [275.44738917928, 85.028813344237],
    'esm_fsigma8': 0.46992919616654,
    'esp_fiducial': [0.81124949521789, 0.60340269575539],
    'esp_power': [
        2074.8584154135, 5511.2602700744, 11818.904127548, 10616.419946716,
        3104.0321972956, 482.41292647917, 36.700656586662, 7.1788293923517],
    'esp_enclosed': [
        -0.46816273251311, -0.45026229276119, -0.36001417982956,
        -0.18742482925291, -0.06637170530593, -0.016217667329583,
        -0.005103232543801, -0.0029255723159548],
    'esp_local': [
        -0.46777958253524, -0.43825611971676, -0.29221625049102,
        -0.05839752231328, 0.016248971834861, 0.0077821707576739,
        -0.00079518257122929, 0.00031094842894761],
    'esp_evolution': [
       [-0.3139288862129, -0.30960060292451, -0.28236726090857,
        -0.18088571141646, -0.067859474725137, -0.016382148740957,
        -0.0050910252336274, -0.0029220961930621],
       [-0.35661591197664, -0.34744788410668, -0.30077094524016,
        -0.17830079947385, -0.059306232021209, -0.0098536434331071,
        -0.0016453608478633, -0.0010820189412098],
       [-0.31301744134084, -0.30864628647568, -0.28113375097291,
        -0.17952791974392, -0.06727499083693, -0.016244345735818,
        -0.005049253136109, -0.0028980658603534],
       [-0.35535470118925, -0.34618345729741, -0.2993866405049,
        -0.17696418786892, -0.058791831084671, -0.0097693332303816,
        -0.0016318215900964, -0.0010730657026014]],
    'cosmo': [
        0.74379423261561, 0.60247332841864, 0.4703226828524,
        -0.36919217670678],
}
# Phase 16: the scale-out layer. SCALE_N parameter points (draw_theta, seed
# 16) through the sharded BOSS likelihood in the exact modes, unchunked, so
# each shard launches ppoly_eval 3 times (v_r, sigma_v, xi_0); 16d's short
# MH run (chains, warmup, draws) and SMC run (particles, moves) on
# QUAD_BLOCK; 16e's throughput at SCALE_TIMED_N points, chunk 64.
SCALE_N = 256
SCALE_MH = (8, 30, 30)
SCALE_SMC = (256, 2)
SCALE_TIMED_N = 4096
SCALE_TOL = 1e-12             # sharded against batched, relative
SCALE_RUN_TOL = 5e-6          # a mesh run against its unsharded run


def check(ok, what):
    if not ok:
        raise RuntimeError(f'chip_smoke: check failed: {what}')
    print(f'  ok: {what}', flush=True)


def load_config(name='boss_config.yaml'):
    """A config of configs/ on the BOSS data, reading the .npz copies of its
    HDF5 files (data/BOSS_DR12_CMASS_npz): the script must run where h5py is
    absent."""
    import yaml
    with open(os.path.join(REPO, 'configs', name)) as f:
        cfg = yaml.safe_load(f)

    def npz(path):
        name = os.path.splitext(os.path.basename(path))[0] + '.npz'
        return os.path.join('data', 'BOSS_DR12_CMASS_npz', name)

    model, data = cfg['model'], cfg['data']
    model['input_model_data_file'] = npz(model['input_model_data_file'])
    for block in ('redshift_space_ccf', 'covariance_matrix'):
        data[block]['data_file'] = npz(data[block]['data_file'])
    model['dir'] = data['dir'] = REPO
    return cfg


def draw_theta(n, seed, device):
    """n parameter points drawn as bench.py draws them, (n, 4) f64."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.column_stack([
        rng.uniform(0.3, 0.6, n), rng.uniform(0.25, 0.55, n),
        rng.uniform(250.0, 450.0, n), rng.uniform(0.9, 1.1, n)]),
        device=device)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, reps=50):
    """Mean device milliseconds per call of `fn` over `reps` calls, with the
    host kept out of the reading: the stream first sleeps long enough for the
    host to queue every call, so the events around the calls time the card
    running them back to back, not the host issuing them. The start event
    must still be pending once all calls are queued; if it is not, the sleep
    is lengthened and the reading taken again. `reps` calls' launches must
    fit the launch queue (about a thousand), or the host waits for the
    sleeping device."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = SLEEP_CYCLES
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError('chip_smoke: the host could not queue the timed calls '
                       'within the device sleep')


def host_us(fn, calls=1000, chunk=100):
    """Host microseconds per call of `fn` (time.perf_counter over `calls`
    calls), each chunk of calls queued behind a device sleep so that a full
    launch queue never makes the host wait for the card."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // chunk):
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return 1e6 * total / (calls // chunk * chunk)


def time_in_turns(label, kernel, plain, reps=(50, PLAIN_REPS)):
    """Device-only milliseconds per call of a kernel and its plain version,
    timed in turns (kernel, plain, plain, kernel) so drift hits both alike,
    and the kernel wrapper's host microseconds per call. `reps`: the calls
    of each reading, few enough that their launches fit the launch queue;
    the host time queues a fifth of the kernel's reps at a time."""
    k1, p1, p2, k2 = (device_ms(kernel, reps[0]), device_ms(plain, reps[1]),
                      device_ms(plain, reps[1]), device_ms(kernel, reps[0]))
    ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
    us = host_us(kernel, calls=20 * reps[0], chunk=2 * reps[0])
    print(f'  {label}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms (device '
          f'only); host {us:.2f} us per kernel call', flush=True)
    return ms_k, ms_p, us


def planted_queries(x, x_np, B, M, dtype, gen):
    """(B, M) queries reaching 10% of the span beyond both ends of the knots
    x, with 4096 on-knot queries scattered and every knot, NaN, +inf and
    -inf planted at the front of each row."""
    import torch
    n = len(x_np)
    span = float(x_np[-1] - x_np[0])
    q = torch.rand((B, M), generator=gen, device='cuda', dtype=torch.float64)
    q = (x_np[0] - 0.1 * span + 1.2 * span * q).to(dtype)
    flat = q.view(-1)
    on_knot = torch.randint(0, B * M, (4096,), generator=gen, device='cuda')
    flat[on_knot] = x[torch.randint(0, n, (4096,), generator=gen,
                                    device='cuda')]
    q[:, :n] = x
    q[:, n] = float('nan')
    q[:, n + 1] = float('inf')
    q[:, n + 2] = float('-inf')
    return q


def ppoly_ops(n, K):
    """Operations per query of ppoly_eval: two clamp selects, the binary
    search's compares, the offset, and per channel three FMAs (six flops)
    and the two of the NaN term."""
    return 3 + math.ceil(math.log2(n - 1)) + 8 * K


def bound(nbytes, ops, dtype):
    """(bound_ms, bound_by): the least time for `nbytes` of device memory
    traffic and `ops` operations at the H100 SXM's peak rates."""
    import torch
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops \
        else 'operations'


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare_outputs(label, out_k, out_p, dtype):
    """Check NaN and inf positions identical and |kernel - plain| within the
    tolerance of `dtype` times max|plain|; returns the max abs error."""
    import torch
    check(torch.equal(torch.isnan(out_k), torch.isnan(out_p)) and
          torch.equal(torch.isinf(out_k), torch.isinf(out_p)),
          f'{label}: NaN and inf positions identical')
    fin = torch.isfinite(out_p)
    err = float((out_k - out_p)[fin].abs().max())
    tol = TOL[str(dtype)[6:]] * float(out_p[fin].abs().max())
    check(err <= tol, f'{label}: max|kernel - plain| = {err:.3e} <= {tol:.3e}')
    return err


def timed(label, err, kernel, plain, n_bytes, ops, reps=(50, PLAIN_REPS)):
    """A comparison's result: the max abs error, the kernel's and the plain
    version's device-only ms, the kernel wrapper's host us per call, and the
    bytes and operations of one call (for its bound)."""
    ms, plain_ms, us = time_in_turns(label, kernel, plain, reps)
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'host_us': us, 'bytes': n_bytes, 'ops': ops}


def compare_case(n, batch_coeffs, dtype, clamp, gen):
    """One kernel-vs-plain comparison at (64, 150000) queries; returns
    `timed`'s result."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels.ppoly import ppoly_eval_cuda, ppoly_eval_plain
    from victor_tpu_torch.ops.splines import Spline1D

    B, M = CHUNK, N_POINTS
    rng = np.random.default_rng(n + 7 * batch_coeffs + 3 * clamp)
    x_np = np.concatenate([[0.01], np.sort(rng.uniform(2.0, 120.0, n - 1))])
    spline = Spline1D.build(x_np, device='cuda', dtype=torch.float64)
    rows = B if batch_coeffs else 1
    y = torch.as_tensor(rng.standard_normal((rows, n)), device='cuda')
    coeffs = spline.coeffs(y).to(dtype).contiguous()
    x = spline.x.to(dtype)
    q = planted_queries(x, x_np, B, M, dtype, gen)
    if not batch_coeffs:
        q = q.reshape(1, -1)     # as ops.ppoly_eval passes a shared table

    out_k = ppoly_eval_cuda(x, coeffs, q, clamp)
    out_p = ppoly_eval_plain(x, coeffs, q, clamp)
    torch.cuda.synchronize()
    label = (f'n={n} coeffs=({rows},{n - 1},4) q={tuple(q.shape)} '
             f'{str(dtype)[6:]} clamp={clamp}')
    err = compare_outputs(label, out_k, out_p, dtype)
    return timed(label, err, lambda: ppoly_eval_cuda(x, coeffs, q, clamp),
                 lambda: ppoly_eval_plain(x, coeffs, q, clamp),
                 nbytes(x, coeffs, q, out_k), q.numel() * ppoly_ops(n, 1))


def compare_multi(K, shared, dtype, gen):
    """The multi-channel kernel against its plain version at the anisotropic
    real-space shape: K tables of 30 knots (one per multipole), per point
    or shared, over (64, 150000) queries with clamp. Channel k must equal
    the single-channel kernel on table k bit for bit, and a 1-channel call
    the single-channel path. Returns `timed`'s result."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels.ppoly import ppoly_eval_cuda, ppoly_eval_plain
    from victor_tpu_torch.ops.splines import Spline1D

    B, M, n = CHUNK, N_POINTS, 30
    rng = np.random.default_rng(100 + 10 * K + shared)
    x_np = np.sort(rng.uniform(2.0, 120.0, n))
    spline = Spline1D.build(x_np, device='cuda', dtype=torch.float64)
    y = torch.as_tensor(rng.standard_normal((1 if shared else B, K, n)),
                        device='cuda')
    coeffs = spline.coeffs(y).to(dtype).contiguous()      # (Bc, K, 29, 4)
    x = spline.x.to(dtype)
    q = planted_queries(x, x_np, B, M, dtype, gen)
    out_k = ppoly_eval_cuda(x, coeffs, q)
    out_p = ppoly_eval_plain(x, coeffs, q)
    torch.cuda.synchronize()
    label = (f'multi-channel K={K} coeffs={tuple(coeffs.shape)} '
             f'q={tuple(q.shape)} {str(dtype)[6:]}')
    err = compare_outputs(label, out_k, out_p, dtype)
    same = all(torch.equal(torch.nan_to_num(out_k[:, k]), torch.nan_to_num(
        ppoly_eval_cuda(x, coeffs[:, k].contiguous(), q))) for k in range(K))
    one = ppoly_eval_cuda(x, coeffs[:, :1].contiguous(), q)[:, 0]
    same_one = torch.equal(torch.nan_to_num(one), torch.nan_to_num(
        ppoly_eval_cuda(x, coeffs[:, 0].contiguous(), q)))
    torch.cuda.synchronize()
    check(same and same_one, f'{label}: each channel equals the '
                             'single-channel kernel on its table bit for bit, '
                             'and a 1-channel call the single-channel path')
    return timed(label, err, lambda: ppoly_eval_cuda(x, coeffs, q),
                 lambda: ppoly_eval_plain(x, coeffs, q),
                 nbytes(x, coeffs, q, out_k), q.numel() * ppoly_ops(n, K))


# Phase 3b: (label, B, M, knots, channels, shared table, clamp, storage
# offset of q in elements), each in f64 and f32
EDGE_CASES = [
    ('q at a storage offset of one element', 16, 3000, 31, 1, False, True, 1),
    ('odd M', 16, 3001, 31, 1, False, True, 0),
    ('odd M, 2 channels', 16, 3001, 31, 2, False, True, 0),
    ('M = 1', 16, 1, 31, 1, False, True, 0),
    ('M = 3, under the vector width', 16, 3, 31, 1, False, False, 0),
    ('B = 1, one table, 9.6M queries', 1, 9_600_000, 25, 1, True, False, 0),
    ('M = 49, B = 8 (Chebyshev nodes)', 8, 49, 31, 1, False, True, 0),
    ('M = 49, B = 8, 2 channels', 8, 49, 31, 2, False, True, 0),
    ('M = 64, a short row on the vector path', 16, 64, 31, 1, False, True,
     0),
    ('M = 65, a short odd row, one table', 16, 65, 31, 2, True, True, 0),
    ('M = 392, one table', 1, 392, 25, 1, True, False, 0),
    ('n = 2', 16, 3000, 2, 1, False, False, 0),
    ('n = 1024', 16, 3000, 1024, 1, False, True, 0),
    ('K = 1', 16, 3000, 30, 1, False, True, 0),
    ('K = 2', 16, 3000, 30, 2, False, True, 0),
    ('K = 3', 16, 3000, 30, 3, True, True, 0),
    ('K = 4', 16, 3000, 30, 4, False, True, 0),
    ('K = 4 at an offset', 16, 3000, 30, 4, False, False, 1),
]


def edge_inputs(B, M, n, K, shared, offset, dtype, gen):
    """The inputs of one of EDGE_CASES: knots, coefficients and queries from
    10% of the span beyond both ends with every knot, NaN, +inf and -inf
    planted at the front and at the end."""
    import numpy as np
    import torch
    rng = np.random.default_rng(B * 7 + M + n + K)
    x_np = np.concatenate([[0.01], np.sort(rng.uniform(2.0, 120.0, n - 1))])
    h = np.diff(x_np)[:, None] ** -np.arange(4.0)      # c_j scaled by h^-j
    c = rng.standard_normal((1 if shared else B, K, n - 1, 4)) * h
    coeffs = torch.as_tensor(c if K > 1 else c[:, 0], device='cuda',
                             dtype=dtype).contiguous()
    x = torch.as_tensor(x_np, device='cuda', dtype=dtype)
    span = float(x_np[-1] - x_np[0])
    base = torch.rand(B * M + offset, generator=gen, device='cuda',
                      dtype=torch.float64)
    base = (x_np[0] - 0.1 * span + 1.2 * span * base).to(dtype)
    q = base[offset:].view(B, M)
    special = torch.cat([x, x.new_tensor([float('nan'), float('inf'),
                                          float('-inf')])])
    flat = q.view(-1)
    flat[:min(len(special), flat.numel())] = special[:flat.numel()]
    if flat.numel() > 2 * len(special):
        flat[-3:] = special[-3:]
    return x, coeffs, q


def edge_case(label, B, M, n, K, shared, clamp, offset, dtype, gen):
    """One of EDGE_CASES: the kernel against its plain version, NaN and inf
    positions identical, on queries from 10% of the span beyond both ends
    with every knot, NaN, +inf and -inf planted at the front and NaN and
    infinities at the end; each channel against the 1-channel kernel on its
    table, and the offset q against an aligned copy, bit for bit."""
    import torch
    from victor_tpu_torch.kernels.ppoly import (ppoly_eval_cuda,
                                                ppoly_eval_plain)

    x, coeffs, q = edge_inputs(B, M, n, K, shared, offset, dtype, gen)
    label = (f'edge: {label}: q={tuple(q.shape)} (offset {offset}) '
             f'coeffs={tuple(coeffs.shape)} {str(dtype)[6:]} clamp={clamp}')
    out_k = ppoly_eval_cuda(x, coeffs, q, clamp)
    out_p = ppoly_eval_plain(x, coeffs, q, clamp)
    torch.cuda.synchronize()
    compare_outputs(label, out_k, out_p, dtype)
    same = True
    if K > 1:
        same = all(torch.equal(torch.nan_to_num(out_k[:, k]), torch.nan_to_num(
            ppoly_eval_cuda(x, coeffs[:, k].contiguous(), q, clamp)))
            for k in range(K))
    if offset:
        same = same and torch.equal(torch.nan_to_num(out_k), torch.nan_to_num(
            ppoly_eval_cuda(x, coeffs, q.clone(), clamp)))
    torch.cuda.synchronize()
    check(same, f'{label}: channels equal the 1-channel kernel and the offset '
                'q an aligned copy, bit for bit')


def ppoly_phase(gen):
    """Phases 3 and 3b: the ppoly_eval kernel against its plain version at
    the main path's shapes, f64 and f32 (`compare_case`, `compare_multi`),
    then at EDGE_CASES. Returns the timed results by (dtype, n, per-row
    tables, clamp) and (dtype, 'multi', K, shared table)."""
    import torch

    print('compare ppoly_eval kernel vs plain:', flush=True)
    results = {}
    for dtype in (torch.float64, torch.float32):
        # v_r (31 knots) and xi_0 (30) have per-point coefficients; sigma_v
        # (25 knots, clamp off after Bicubic2D's own clamp) has one table
        for n, batched, clamp in ((31, True, True), (31, True, False),
                                  (30, True, True), (25, False, False)):
            results[(str(dtype)[6:], n, batched, clamp)] = compare_case(
                n, batched, dtype, clamp, gen)
    # the real-space multipoles (K = 2 for the BOSS model, 3 with the
    # hexadecapole), per point; shared tables as a model with fixed input
    for dtype in (torch.float64, torch.float32):
        for K, shared in ((2, False), (3, False), (2, True), (3, True)):
            results[(str(dtype)[6:], 'multi', K, shared)] = compare_multi(
                K, shared, dtype, gen)
    print('ppoly_eval kernel vs plain at the edge shapes:', flush=True)
    for case in EDGE_CASES:
        for dtype in (torch.float64, torch.float32):
            edge_case(*case, dtype, gen)
    return results


def build_kernels():
    """Build every kernel, one nvcc process per source, all started
    together; print each build's seconds and nvcc's report."""
    from concurrent.futures import ThreadPoolExecutor
    from victor_tpu_torch.kernels import _build

    def one(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(one, KERNELS))
    for lib, sec in built:
        print(f'build: {lib.name} in {sec:.2f} s', flush=True)
        print(lib.with_suffix('.log').read_text().strip(), flush=True)


def dispersion_final_inputs(bundle):
    """The final stage's inputs as the port's own dispersion model makes
    them (exact interior, 5 Picard iterations) for 64 parameter points,
    with NaN, out-of-range and near-knot r_par entries planted."""
    import torch
    from victor_tpu_torch.likelihood.batched import theta_to_params
    from victor_tpu_torch.models import ccf_theory

    captured = []
    fused = ccf_theory.dispersion_final

    def record(*args):
        captured.append(args)
        return fused(*args)

    opts = bundle.theory_opts.replace(rsd_model='dispersion',
                                      dispersion_interior='exact',
                                      dispersion_final='fused')
    params = theta_to_params(draw_theta(CHUNK, 1, 'cuda'), NAMES)
    ccf_theory.dispersion_final = record
    try:
        ccf_theory.theory_xi_grid(bundle.tables, bundle.spec, opts, params)
    finally:
        ccf_theory.dispersion_final = fused
    x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel = (
        t.clone() for t in captured[0])
    # plant: NaN, beyond both ends of the spline, and within an ulp of knots
    # (s_perp = 0 and r_par = knot * resc_vel, so rr / resc_vel ~ knot)
    s_perp[:8, :4] = 0.0
    r_par[:8, 0, 0] = float('nan')
    r_par[:8, 1, 1] = 1e3
    r_par[:8, 2, 2] = 1e-4
    A[:8, 3, 3] = float('nan')
    knots = x[torch.arange(8 * 40, device=x.device) % x.shape[0]]
    r_par[:8, 10:50, 0] = knots.reshape(8, 40) * resc_vel[:8, None]
    return x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel


def compare_dispersion(inputs, dtype, planted=True):
    """The dispersion_final kernel against its plain version at the path's
    shape (`planted`: with the NaN entries of `dispersion_final_inputs`);
    returns `timed`'s result, the error the worst of the four outputs."""
    import torch
    from victor_tpu_torch.kernels.dispersion import (dispersion_final_cuda,
                                                     dispersion_final_plain)

    args = [t.to(dtype).contiguous() for t in inputs]
    out_k = dispersion_final_cuda(*args)
    out_p = dispersion_final_plain(*args)
    torch.cuda.synchronize()
    label = (f'dispersion_final r_par={tuple(args[3].shape)} '
             f'coeffs={tuple(args[1].shape)} {str(dtype)[6:]}')
    worst = 0.0
    for name, k, p in zip(('r_par', 'rr', 'mu_r', 'jac'), out_k, out_p):
        if planted:
            check(bool(torch.isnan(p).any()), f'{label} {name}: NaN planted')
        worst = max(worst, compare_outputs(f'{label} {name}', k, p, dtype))

    # per element: two interval searches with their clamps, three Horner
    # evaluations, two square roots and about 30 flops of the update and the
    # Jacobian: about 70 operations
    return timed(label, worst, lambda: dispersion_final_cuda(*args),
                 lambda: dispersion_final_plain(*args),
                 nbytes(*args, *out_k), args[3].numel() * 70)


def dispersion_paths(bundle, ref, grid):
    """Phase 6: the dispersion likelihood with the exact and the fused final
    stage. Returns the dispersion_final kernel's launches on the fused
    path."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels import dispersion, ppoly
    from victor_tpu_torch.likelihood.batched import make_batched_loglike

    i = [str(x) for x in ref['golden_names']].index('dispersion')
    want_chi, want_lnl = ref['golden_chi2'][i], ref['golden_lnl'][i]
    chunks = 1 + -(-len(grid) // CHUNK)
    out = {}
    for final in ('exact', 'fused'):
        loglike = make_batched_loglike(
            bundle, NAMES, opts_kw={**DISP_EXACT, 'dispersion_final': final},
            chunk=CHUNK)
        ppoly.LAUNCHES = dispersion.LAUNCHES = 0
        lnl_g, chi_g = loglike([GOLDEN])
        lnl, chi = loglike(grid)
        torch.cuda.synchronize()
        out[final] = (lnl.cpu().numpy(), chi.cpu().numpy(),
                      dispersion.LAUNCHES, ppoly.LAUNCHES)
        chi2_0, lnl_0 = float(chi_g[0]), float(lnl_g[0])
        check(bool(np.isfinite(out[final][:2]).all()),
              f'dispersion ({final}): finite outputs')
        check(abs(chi2_0 - want_chi) < 1e-8 and abs(lnl_0 - want_lnl) < 1e-8,
              f'dispersion ({final}) golden point chi2 {chi2_0:.10f} '
              f'({want_chi:.10f}), lnL {lnl_0:.10f} ({want_lnl:.10f}) '
              '(< 1e-8)')
        print(f'  dispersion ({final}) launches: dispersion_final '
              f'{out[final][2]}, ppoly_eval {out[final][3]}', flush=True)
    d_lnl, d_chi = (float(np.abs(out['fused'][k] - out['exact'][k]).max())
                    for k in (0, 1))
    check(d_chi < 1e-10 and d_lnl < 1e-10,
          f"dispersion 'fused' vs 'exact' on the {len(grid)} grid points: max "
          f'|d chi2| {d_chi:.3e}, max |d lnL| {d_lnl:.3e} (< 1e-10)')
    check(out['fused'][2] >= chunks,
          f"dispersion_final kernel launches on the 'fused' path: "
          f'{out["fused"][2]} (>= 1 per chunk, {chunks} chunks)')
    check(out['exact'][2] == 0,
          "the 'exact' final stage launches no dispersion_final kernel")
    return out['fused'][2]


def default_modes(bundle, disp_bundle, grid):
    """Phase 7: make_batched_loglike with no opts_kw (streaming_eval and
    dispersion_final 'fast', beta_covariance 'factored') held to victor_tpu's
    own bounds (tests/test_golden.py) against the exact modes at the golden
    and displaced points, and the factored covariance against the dense one
    at every point."""
    import numpy as np
    from victor_tpu_torch.likelihood.batched import make_batched_loglike

    points = np.vstack([[GOLDEN, DISPLACED], grid])

    def run(b, kw):
        lnl, chi = make_batched_loglike(b, NAMES, opts_kw=kw,
                                        chunk=CHUNK)(points)
        out = np.stack([lnl.cpu().numpy(), chi.cpu().numpy()])
        check(bool(np.isfinite(out).all()),
              f'{b.theory_opts.rsd_model} {kw or "default"}: finite outputs')
        return out

    s_def = run(bundle, None)
    s_fe = run(bundle, {'streaming_eval': 'fast', 'beta_covariance': 'exact'})
    s_ee = run(bundle, EXACT)
    d_def = run(disp_bundle, None)
    d_cf = run(disp_bundle, {'dispersion_final': 'exact'})
    d_ce = run(disp_bundle, {'dispersion_final': 'exact',
                             'beta_covariance': 'exact'})
    d_ee = run(disp_bundle, {'dispersion_interior': 'exact',
                             'dispersion_final': 'exact',
                             'beta_covariance': 'exact'})

    def shift(a, b, what, bound):
        d = np.abs(a - b)
        at_two, on_grid = float(d[:, :2].max()), float(d[:, 2:].max())
        check(at_two < bound,
              f'{what}: max |d chi2|, |d lnL| at the golden and displaced '
              f'points {at_two:.3e} (< {bound:g}); over the {len(grid)} grid '
              f'points {on_grid:.3e} (information)')

    def factored(a, b, what):
        rel = float((np.abs(a - b) / np.abs(b)).max())
        check(rel <= 1e-10,
              f'{what}: factored vs dense covariance, max relative error of '
              f'chi2 and lnL {rel:.3e} over {len(points)} points (<= 1e-10)')

    shift(s_fe, s_ee, 'streaming fast vs exact', 3e-2)
    shift(d_def, d_cf, "dispersion final 'fast' vs 'exact' (Chebyshev "
                       'interior)', 5e-3)
    shift(d_ce, d_ee, 'dispersion Chebyshev vs exact interior (exact final)',
          1e-3)
    factored(s_def, s_fe, 'streaming default')
    factored(d_cf, d_ce, 'dispersion (Chebyshev interior, exact final)')


def option_paths(cfg):
    """Phase 8: each of OPTION_CASES as a batched likelihood (exact modes,
    f64) at the golden and the displaced point against victor_tpu's values,
    within 1e-8, with the ppoly_eval launches of its run. Returns {name:
    (bundle, opts_kw, base params, (launches, multi-channel launches))}."""
    import copy
    import torch
    from victor_tpu_torch.io.tables import build_tables
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.likelihood.batched import make_batched_loglike

    out = {}
    for name, (edits, opts_kw, extra) in OPTION_CASES.items():
        b = build_tables({**copy.deepcopy(cfg['model']), **edits},
                         copy.deepcopy(cfg['data']), device='cuda')
        loglike = make_batched_loglike(b, NAMES, base_params=extra,
                                       opts_kw={**EXACT, **opts_kw},
                                       chunk=CHUNK)
        ppoly.LAUNCHES = ppoly.LAUNCHES_MULTI = 0
        lnl, chi = loglike([GOLDEN, DISPLACED])
        torch.cuda.synchronize()
        launches = (ppoly.LAUNCHES, ppoly.LAUNCHES_MULTI)
        for i, point in enumerate(('golden', 'displaced')):
            want_chi, want_lnl = OPTION_GOLDENS[name][i]
            got_chi, got_lnl = float(chi[i]), float(lnl[i])
            check(abs(got_chi - want_chi) < 1e-8 and
                  abs(got_lnl - want_lnl) < 1e-8,
                  f'{name} at the {point} point: chi2 {got_chi:.10f} '
                  f'({want_chi:.10f}), lnL {got_lnl:.10f} ({want_lnl:.10f}) '
                  '(< 1e-8)')
        check(launches[0] >= 1, f'{name}: ppoly_eval kernel launches '
                                f'{launches[0]}, of them multi-channel '
                                f'{launches[1]}')
        out[name] = (b, opts_kw, extra, launches)
    return out


def draw_prior(cfg, n, seed, device):
    """n points drawn uniformly from the prior box of a sampling config's
    params block, (n, P) f64 in the block's order."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    box = [(p['prior']['min'], p['prior']['max'])
           for p in cfg['params'].values()]
    return torch.as_tensor(np.column_stack([rng.uniform(lo, hi, n)
                                            for lo, hi in box]), device=device)


def esm_paths():
    """Phase 9: configs/esm_sampling_config.yaml at full BOSS width, f64,
    chunk 64. chi2 and lnL at its ref point against ESM_GOLDENS (streaming,
    exact modes; dispersion, exact interior and final stage), within 1e-8;
    then the dispersion model's fused final stage against its exact one on
    the ref point and 63 points of the prior box. Returns (bundle, parameter
    names, config, ppoly_eval launches of the streaming run)."""
    import numpy as np
    import torch
    from victor_tpu_torch.io.tables import build_tables
    from victor_tpu_torch.kernels import dispersion, ppoly
    from victor_tpu_torch.likelihood.batched import make_batched_loglike

    cfg = load_config('esm_sampling_config.yaml')
    t0 = time.perf_counter()
    b = build_tables(cfg['model'], cfg['data'], device='cuda')
    print(f'build_tables (ESM): {time.perf_counter() - t0:.2f} s', flush=True)
    names = list(cfg['params'])
    ref = [ESM_REF[k] for k in names]
    disp_exact = {**DISP_EXACT, 'dispersion_final': 'exact'}
    launches = {}
    for rsd, kw in (('streaming', EXACT), ('dispersion', disp_exact)):
        ppoly.LAUNCHES = ppoly.LAUNCHES_MULTI = 0
        lnl, chi = make_batched_loglike(b, names, opts_kw=kw,
                                        chunk=CHUNK)([ref])
        torch.cuda.synchronize()
        launches[rsd] = (ppoly.LAUNCHES, ppoly.LAUNCHES_MULTI)
        want_chi, want_lnl = ESM_GOLDENS[rsd]
        got_chi, got_lnl = float(chi[0]), float(lnl[0])
        check(abs(got_chi - want_chi) < 1e-8 and abs(got_lnl - want_lnl) < 1e-8,
              f'ESM {rsd} at the ref point: chi2 {got_chi:.10f} '
              f'({want_chi:.10f}), lnL {got_lnl:.10f} ({want_lnl:.10f}) '
              '(< 1e-8)')
        check(launches[rsd][0] >= 4,
              f'ESM {rsd}: ppoly_eval kernel launches {launches[rsd][0]}, of '
              f'them multi-channel {launches[rsd][1]} (>= 4)')

    theta = draw_prior(cfg, CHUNK, 2, 'cuda')
    theta[0] = torch.as_tensor(ref, device='cuda')
    out = {}
    for final in ('exact', 'fused'):
        dispersion.LAUNCHES = 0
        lnl, chi = make_batched_loglike(
            b, names, opts_kw={**disp_exact, 'dispersion_final': final},
            chunk=CHUNK)(theta)
        torch.cuda.synchronize()
        out[final] = (np.stack([chi.cpu().numpy(), lnl.cpu().numpy()]),
                      dispersion.LAUNCHES)
    a, e = out['fused'][0], out['exact'][0]
    fin = np.isfinite(e)
    rel = float((np.abs(a - e)[fin] / np.maximum(1.0, np.abs(e[fin]))).max())
    check(np.array_equal(np.isfinite(a), fin) and rel <= 1e-12,
          f"ESM dispersion 'fused' vs 'exact' on {CHUNK} points "
          f'({int(fin.all(axis=0).sum())} finite): max |d| / max(1, |value|) '
          f'of chi2 and lnL {rel:.3e} (<= 1e-12)')
    check(out['fused'][1] >= 1 and out['exact'][1] == 0,
          f"ESM dispersion_final kernel launches: 'fused' {out['fused'][1]}, "
          f"'exact' {out['exact'][1]}")
    return b, names, cfg, launches['streaming']


def throughput(configs, card, profile_path):
    """Phase 10 (information only): evaluations per second of 4096 points,
    chunk 64, one warm-up and two timed reps per configuration. Each
    configuration is (label, bundle, parameter names, theta, opts_kw, base
    params)."""
    import torch
    from victor_tpu_torch.likelihood.batched import make_batched_loglike

    tables = []
    for name, b, names, theta, kw, base in configs:
        n = theta.shape[0]
        loglike = make_batched_loglike(b, names, base_params=base, opts_kw=kw,
                                       chunk=CHUNK)
        lnl, _ = loglike(theta)
        finite = int(torch.isfinite(lnl).sum())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            loglike(theta)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rate = 2 * n / sum(times)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f'throughput {name}: {rate:.1f} evals/s (f64, {n} points, '
              f'{finite} finite, chunk {CHUNK}, reps '
              f'{[round(t, 4) for t in times]} s, peak {peak_gb:.2f} GB) on '
              f'{card}', flush=True)
        if profile_path:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                loglike(theta)
                torch.cuda.synchronize()
            tables.append(f'== {name}: {n} points, chunk {CHUNK}, f64\n'
                          + prof.key_averages().table(
                              sort_by='cuda_time_total', row_limit=30))
    if profile_path:
        os.makedirs(os.path.dirname(os.path.abspath(profile_path)),
                    exist_ok=True)
        with open(profile_path, 'w') as f:
            f.write(card + '\n' + '\n\n'.join(tables) + '\n')
        print(f'profile tables written to {profile_path}', flush=True)


def write_yaml(cfg, path):
    import yaml
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def cli_json(argv):
    """The JSON that the port's CLI prints for `argv`, run in this process
    (so the kernels' launch counters see it)."""
    import contextlib
    import io
    from victor_tpu_torch.__main__ import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    return json.loads(buf.getvalue())


def eval_cli(tmp):
    """Phase 11a: `python -m victor_tpu_torch eval` in a subprocess at the
    golden point, and the CLI's main at the config's ref point, against
    victor_tpu's values within 1e-8."""
    path = write_yaml(load_config('boss_sampling_config.yaml'),
                      os.path.join(tmp, 'boss_sampling.yaml'))
    args = [a for k, v in zip(NAMES, GOLDEN) for a in ('--param', f'{k}={v}')]
    env = {**os.environ, 'PYTHONPATH': os.pathsep.join(
        [REPO] + ([os.environ['PYTHONPATH']] if 'PYTHONPATH' in os.environ
                  else []))}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', 'victor_tpu_torch', 'eval',
                           path] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError('chip_smoke: `python -m victor_tpu_torch eval` '
                           f'exited {proc.returncode}:\n{proc.stderr[-4000:]}')
    print(f'  eval subprocess: {time.perf_counter() - t0:.2f} s', flush=True)
    results = {'golden': json.loads(proc.stdout.strip().splitlines()[-1]),
               'ref': cli_json(['eval', path])}
    for name, res in results.items():
        want_chi, want_lnl = EVAL_GOLDENS[name]
        check(abs(res['chi2'] - want_chi) < 1e-8 and
              abs(res['log_likelihood'] - want_lnl) < 1e-8,
              f"eval at the {name} point {res['params']}: chi2 "
              f"{res['chi2']:.10f} ({want_chi:.10f}), lnL "
              f"{res['log_likelihood']:.10f} ({want_lnl:.10f}) (< 1e-8)")
    g = results['golden']
    check(abs(g['chi2'] - GOLDEN_CHI2) < 0.01 and
          abs(g['log_likelihood'] - GOLDEN_LNL) < 0.01,
          f"eval golden chi2 {g['chi2']:.6f} (65.01), lnL "
          f"{g['log_likelihood']:.6f} (284.76)")


def mh_posterior(cfg, tmp):
    """Phase 11b: `run` with the default sampler on QUAD_BLOCK through the
    CLI. Returns (ppoly_eval launches, sampler steps, final chain points
    (8, 4), draws, max R-1, sha256 of the eight GetDist chain files)."""
    import hashlib

    import numpy as np
    import torch
    from victor_tpu_torch.kernels import dispersion, ppoly
    from victor_tpu_torch.sampling.diagnostics import split_rhat

    run_cfg = {**cfg, 'params': QUAD_BLOCK,
               'sampler': {'kind': 'mh', 'n_chains': 8, 'rhat_stop': 0.01}}
    path = write_yaml(run_cfg, os.path.join(tmp, 'boss_mh.yaml'))
    root = os.path.join(tmp, 'chains', 'mh')
    ppoly.LAUNCHES = ppoly.LAUNCHES_MULTI = dispersion.LAUNCHES = 0
    out = cli_json(['run', path, '--samples', str(MH_N_SAMPLES),
                    '--output', root])
    torch.cuda.synchronize()
    launches = (ppoly.LAUNCHES, dispersion.LAUNCHES)
    n_draws, n_warmup = out['n_samples'], 2000
    steps = n_warmup + n_draws
    chain_files = [f'{root}.{i}.txt' for i in range(1, 9)]
    files = chain_files + [f'{root}.{ext}' for ext in (
        'paramnames', 'ranges', 'covmat', 'progress', 'input.yaml')]
    check(all(os.path.isfile(f) for f in files),
          'MH wrote the GetDist chains (one per chain), .paramnames, '
          '.ranges, .covmat, .progress and .input.yaml')
    digest = hashlib.sha256()
    for f in chain_files:
        with open(f, 'rb') as fh:
            digest.update(fh.read())
    chains = np.stack([np.loadtxt(f, ndmin=2)[:, 2:6] for f in chain_files],
                      axis=1)                                   # (S, 8, 4)
    check(chains.shape == (n_draws, 8, 4) and np.isfinite(chains).all(),
          f'MH chains: {chains.shape}, finite')
    rm1 = float(np.max(split_rhat(chains) - 1))
    rate = steps / out['elapsed_s']
    print(f'  MH (default modes, 8 chains): {n_draws} draws after '
          f'{n_warmup} warmup steps, max R-1 {rm1:.6f} (stop at 0.01, '
          f"{'converged' if rm1 < 0.01 else 'cap reached'}), acceptance "
          f"{out['acceptance']}, {out['elapsed_s']} s, {rate:.1f} steps/s, "
          f'ppoly_eval launches {launches[0]} ({launches[0] / (steps + 1):.2f}'
          f' per likelihood call); chain files sha256 {digest.hexdigest()}',
          flush=True)
    for name in NAMES:
        got = out['summary'][name]
        mean, std = QUAD_MEAN[name], QUAD_STD[name]
        check(abs(got['mean'] - mean) < 0.2 * std and
              abs(got['std'] / std - 1.0) < 0.15,
              f"MH posterior {name}: mean {got['mean']:.5g} ({mean:g} +- "
              f"0.2 x {std:g}), std {got['std']:.4g} ({std:g} +- 15%)")
    check(launches[0] > 0 and launches[1] == 0,
          f'ppoly_eval kernel launches on the MH path: {launches[0]} (> 0); '
          f'dispersion_final {launches[1]} (streaming model: 0)')
    return launches[0], steps, chains[-1], n_draws, rm1, digest.hexdigest()


def lookup_shape(x, coeffs, q, clamp):
    """A ppoly_eval call's shapes, by which launches are counted per
    lookup."""
    return (tuple(coeffs.shape), tuple(q.shape), bool(clamp))


def rotated_ms(label, fn, rotated, moved, copies=6, reps=50):
    """Device-only ms of one call `fn(*t)` with L2 cold: `copies` clones of
    the tensors `rotated` (None stays None) taken in turn, their outputs
    kept alive, `moved` bytes per call, more than the card's 50 MB L2 in
    all, so that no call finds its data in L2."""
    import collections
    import itertools
    check(copies * moved > L2_BYTES,
          f'cold rotation: {copies} {label} of {moved / 1e6:.1f} MB exceed '
          f'the {L2_BYTES / 1e6:.0f} MB L2')
    turn = itertools.cycle([tuple(None if t is None else t.clone()
                                  for t in rotated) for _ in range(copies)])
    live = collections.deque(maxlen=copies)     # keeps the outputs distinct
    return device_ms(lambda: live.append(fn(*next(turn))), reps)


def cold_ms(x, coeffs, q, clamp, copies=6):
    """Device-only ms of one ppoly_eval call with L2 cold (`rotated_ms`:
    distinct (q, out) pairs)."""
    from victor_tpu_torch.kernels.ppoly import ppoly_eval_cuda
    return rotated_ms('(q, out) pairs',
                      lambda qq: ppoly_eval_cuda(x, coeffs, qq, clamp), (q,),
                      2 * nbytes(q), copies)


def sampler_kernel_case(bundle, theta, what='the MH step', run=None):
    """Every ppoly_eval call of one likelihood evaluation of `what` (default
    modes; theta (B, 4): the MH step's 8 chains, a particle sampler's chunk
    of 64; or the call `run()` makes) against the plain version on the same
    inputs, each timed back to
    back on one q, as the step finds it just written (L2 warm); the largest
    also with L2 cold (`cold_ms`). Returns the largest call's `timed`
    result, whose `ms` is the cold reading and `warm_ms` the warm one, and
    the results of all calls by label, each with its `lookup` key."""
    import torch
    from victor_tpu_torch.kernels.ppoly import (ppoly_eval_cuda,
                                                ppoly_eval_plain)
    from victor_tpu_torch.likelihood.batched import make_batched_loglike
    from victor_tpu_torch.ops import splines

    calls = []

    def record(*args):
        calls.append(args)
        return ppoly_eval_cuda(*args)

    splines.ppoly_eval_cuda = record
    try:
        if run is None:
            make_batched_loglike(bundle, NAMES)(theta)
        else:
            run()
    finally:
        splines.ppoly_eval_cuda = ppoly_eval_cuda
    results = {}
    for x, coeffs, q, clamp in calls:
        out_k = ppoly_eval_cuda(x, coeffs, q, clamp)
        out_p = ppoly_eval_plain(x, coeffs, q, clamp)
        torch.cuda.synchronize()
        label = (f'ppoly_eval in {what} ({len(calls)} calls): '
                 f'coeffs={tuple(coeffs.shape)} q={tuple(q.shape)} '
                 f'clamp={clamp}')
        err = compare_outputs(label, out_k, out_p, q.dtype)
        K = coeffs.shape[1] if coeffs.ndim == 4 else 1
        results[label] = {**timed(
            label, err, lambda: ppoly_eval_cuda(x, coeffs, q, clamp),
            lambda: ppoly_eval_plain(x, coeffs, q, clamp),
            nbytes(x, coeffs, q, out_k), q.numel() * ppoly_ops(x.shape[0], K)),
            'lookup': lookup_shape(x, coeffs, q, clamp)}
    x, coeffs, q, clamp = max(calls, key=lambda c: c[2].numel())
    cold = cold_ms(x, coeffs, q, clamp)
    largest = max(results.values(), key=lambda r: r['bytes'])
    print(f'  the largest, q={tuple(q.shape)}: L2 cold {cold:.4f} ms, warm '
          f'{largest["ms"]:.4f} ms (device only)', flush=True)
    return {**largest, 'ms': cold, 'warm_ms': largest['ms']}, results


def ensemble_run(bundle):
    """Phase 11c: the differential-evolution ensemble, 64 walkers, 300
    sweeps, on QUAD_BLOCK."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.sampling import run_mcmc

    ppoly.LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_mcmc(bundle, QUAD_BLOCK, n_walkers=64, max_steps=300,
                   check_every=100, rhat_stop=0.0, move='de', seed=1,
                   device='cuda')
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ppoly.LAUNCHES
    check(res.chain.shape == (300, 64, 4) and
          bool(np.isfinite(res.chain).all() and
               np.isfinite(res.log_prob).all()),
          f'ensemble (DE, 64 walkers): chain {res.chain.shape}, finite')
    check(0.05 < res.acceptance < 0.9,
          f'ensemble acceptance {res.acceptance:.3f} in (0.05, 0.9)')
    check(launches > 0, f'ppoly_eval kernel launches on the ensemble path: '
                        f'{launches}')
    moments = {k: (round(v['mean'], 5), round(v['std'], 5),
                   round(v['rhat'], 4))
               for k, v in res.summary().items()}
    print(f'  ensemble: {300 / dt:.2f} sweeps/s ({2 * 300} likelihood calls '
          f'of 32 points, {64 * 300 / dt:.1f} evals/s), {dt:.2f} s; '
          f'(mean, std, R-hat) after a third burn-in: {moments}', flush=True)


def joint_fit(cfg, bundle, tmp):
    """Phase 11d: two copies of the BOSS data under the block-diagonal stack
    of its 31 x 60 x 60 covariance."""
    import copy

    import numpy as np
    import torch
    from victor_tpu_torch.io.loaders import load_key_value_file
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.likelihood.batched import make_batched_loglike
    from victor_tpu_torch.likelihood.multiquantile import (
        build_joint_tables, make_batched_joint_loglike)
    from victor_tpu_torch.sampling import run_hmc_mcmc

    data = cfg['data']
    cd = load_key_value_file(os.path.join(
        data['dir'], data['covariance_matrix']['data_file']))
    covs = np.asarray(cd['covmat'])
    n_b, D = covs.shape[:2]
    stack = np.zeros((n_b, 2 * D, 2 * D))
    stack[:, :D, :D] = stack[:, D:, D:] = covs
    cov_path = os.path.join(tmp, 'joint_cov.npz')
    np.savez(cov_path, covmat=stack, beta=np.asarray(cd['beta']))
    q = {'model': copy.deepcopy(cfg['model']),
         'data': {'redshift_space_ccf':
                  copy.deepcopy(data['redshift_space_ccf']),
                  'dir': data['dir']}}
    jb = build_joint_tables({
        'quantiles': [q, copy.deepcopy(q)],
        'covariance_matrix': {'data_file': cov_path, 'cov_key': 'covmat',
                              'fixed_beta': False, 'beta_key': 'beta'},
        'likelihood': copy.deepcopy(data['likelihood'])}, device='cuda')
    single = float(make_batched_loglike(bundle, NAMES, opts_kw=EXACT)(
        [GOLDEN])[1][0])
    for label, kw in (('dense', EXACT),
                      ('factored', {**EXACT, 'beta_covariance': 'factored'})):
        chi = float(make_batched_joint_loglike(jb, NAMES, opts_kw=kw)(
            [GOLDEN])[1][0])
        rel = abs(chi - 2 * single) / (2 * single)
        check(rel <= 1e-9 and abs(chi - 2 * 65.0118) < 1e-3,
              f'joint chi2 ({label}) at the golden point {chi:.10f} = 2 x '
              f'{single:.10f} to {rel:.2e} relative (<= 1e-9)')
    theta = draw_theta(1024, 3, 'cuda')
    loglike = make_batched_joint_loglike(jb, NAMES, chunk=CHUNK)
    loglike(theta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lnl, _ = loglike(theta)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f'  joint fit (2 quantiles, default modes): {1024 / dt:.1f} evals/s '
          f'(1024 points, chunk {CHUNK}, {int(torch.isfinite(lnl).sum())} '
          'finite)', flush=True)
    ppoly.LAUNCHES = 0
    res = run_hmc_mcmc(jb, QUAD_BLOCK, n_chains=8, n_warmup=100,
                       n_samples=100, segment_steps=200, algorithm='mh',
                       seed=4, device='cuda')
    torch.cuda.synchronize()
    check(res.chain.shape == (100, 8, 4) and
          bool(np.isfinite(res.log_prob).all()) and ppoly.LAUNCHES > 0,
          f'MH on the joint fit: chain {res.chain.shape}, finite, acceptance '
          f'{res.acceptance:.3f}, {200 / res.elapsed_s:.1f} steps/s, '
          f'ppoly_eval launches {ppoly.LAUNCHES}')


def mh_step_rates(bundle, card, profile_path):
    """Phase 11e (information): MH steps/s of 8 chains on QUAD_BLOCK, 300
    steps (100 of warmup), in the default modes and the exact ones; then
    the device time per step of 20 more steps under torch.profiler (the
    kernels' own time, against the step's wall time; the profiler's
    post-processing grows with the steps), whose table goes to
    `profile_path` when one is given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from victor_tpu_torch.sampling import run_hmc_mcmc

    def run(kw, n_warmup, n_samples):
        return run_hmc_mcmc(bundle, QUAD_BLOCK, n_chains=8,
                            n_warmup=n_warmup, n_samples=n_samples,
                            segment_steps=300, opts_kw=kw, algorithm='mh',
                            seed=2, device='cuda')

    for label, kw in (('default', None), ('exact', EXACT)):
        res = run(kw, 100, 200)
        print(f'MH steps/s ({label} modes, 8 chains, 300 steps): '
              f'{300 / res.elapsed_s:.1f} on {card}', flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = run(kw, 10, 10)
            torch.cuda.synchronize()
        events = prof.key_averages()
        # kernels only: an operator's own device time is its kernels'
        device_us = sum(e.device_time_total for e in events
                        if e.device_type == DeviceType.CUDA)
        print(f'  MH {label} modes, 20 steps under torch.profiler: kernels '
              f'{device_us / 1e3 / 20:.3f} ms per step of '
              f'{res.elapsed_s * 1e3 / 20:.3f} ms wall', flush=True)
        if profile_path:
            with open(profile_path, 'a') as f:
                f.write(f'\n== MH, {label} modes: 20 steps of 8 chains, '
                        'f64\n' + events.table(sort_by='cuda_time_total',
                                               row_limit=30) + '\n')


# ---------------------------------------------------------------------------
# Phase 12: the gradient path
# ---------------------------------------------------------------------------

def bwd_ops(n, K):
    """Operations per query of the backward: the clip's selects and factor,
    the search's compares, and per channel the derivative's Horner form and
    product (six) and the coefficient terms (three products, four sums)."""
    return 5 + math.ceil(math.log2(n - 1)) + 13 * K


def abs_terms(x, c, q, g, clamp):
    """The scale of each coefficient gradient (f64): the sum over its
    queries of |g| (1, |t|, t^2, |t|^3)."""
    import torch
    x, q, g = x.double(), q.double(), g.double().abs()
    n = x.shape[0]
    qq = torch.clamp(q, x[0], x[-1]) if clamp else q
    idx = torch.clamp(torch.searchsorted(x, qq, right=True) - 1, 0, n - 2)
    t = torch.nan_to_num((qq - x[idx]).abs(), nan=0.0, posinf=0.0)[:, None]
    g = torch.nan_to_num(g if c.ndim == 4 else g[:, None], posinf=0.0)
    B, K, M = g.shape
    terms = torch.stack([g, g * t, g * t * t, g * t * t * t], -1)
    rows = c.shape[0]
    table = (torch.arange(B, device=q.device)[:, None] % rows) * K + \
        torch.arange(K, device=q.device)
    flat = table[:, :, None] * (n - 1) + idx[:, None, :]
    out = torch.zeros(rows * K * (n - 1), 4, dtype=torch.float64,
                      device=q.device)
    out.index_add_(0, flat.reshape(-1), terms.reshape(-1, 4))
    return out.reshape(c.shape)


def compare_backward(label, x, c, q, g, clamp, want_dq=True, want_dc=True,
                     time_it=False):
    """The backward kernel against its plain version (in f64) on the same
    inputs: NaN and inf positions identical, dq within TOL x max|dq|,
    dcoeffs within TOL x the sum of its terms' magnitudes; a second call
    gives the same bits. Returns `timed`'s result when `time_it`, else the
    max abs error."""
    import torch
    from victor_tpu_torch.kernels.ppoly import (ppoly_eval_backward_cuda,
                                                ppoly_eval_backward_plain)

    def kernel():
        return ppoly_eval_backward_cuda(x, c, q, g, clamp, want_dq, want_dc)

    got, again = kernel(), kernel()
    want = ppoly_eval_backward_plain(*(a.double() for a in (x, c, q, g)),
                                     clamp, want_dq, want_dc)
    torch.cuda.synchronize()
    tol = TOL[str(q.dtype)[6:]]
    scales = (None, abs_terms(x, c, q, g, clamp) if want_dc else None)
    err = 0.0
    for what, k, p, k2, scale in zip(('dq', 'dcoeffs'), got, want, again,
                                     scales):
        if p is None:
            check(k is None, f'{label}: no {what} when not asked for')
            continue
        k = k.double()
        check(torch.equal(torch.isnan(k), torch.isnan(p)) and
              torch.equal(torch.isinf(k), torch.isinf(p)),
              f'{label} {what}: NaN and inf positions identical')
        fin = torch.isfinite(p)
        d = (k - p)[fin].abs()
        bound = tol * (scale[fin] if scale is not None else
                       p[fin].abs().max())
        worst = float((d - bound).max()) if d.numel() else -1.0
        check(worst <= 0.0, f'{label} {what}: max|kernel - plain| = '
                            f'{float(d.max()) if d.numel() else 0.0:.3e} '
                            f'within {tol:g} x its scale')
        check(torch.equal(torch.nan_to_num(k2.double()), torch.nan_to_num(k)),
              f'{label} {what}: two calls, the same bits')
        err = max(err, float(d.max()) if d.numel() else 0.0)
    if not time_it:
        return err
    out = [t for t in got if t is not None]
    K = c.shape[1] if c.ndim == 4 else 1
    return timed(label, err, kernel,
                 lambda: ppoly_eval_backward_plain(x, c, q, g, clamp, want_dq,
                                                   want_dc),
                 nbytes(x, c, q, g, *out), q.numel() * bwd_ops(x.shape[0], K))


def grad_out_like(q, K, gen):
    import torch
    shape = (q.shape[0], K, q.shape[1]) if K > 1 else tuple(q.shape)
    return torch.randn(shape, generator=gen, device='cuda',
                       dtype=torch.float64).to(q.dtype)


def boss_logpost(bundle, opts_kw=None, block=None):
    """The HMC target: the BOSS posterior over QUAD_BLOCK (or `block`) in
    the unbounded space, the AD-resolved perf modes, as run_hmc_mcmc
    builds it. Returns (space, logpost_y)."""
    from victor_tpu_torch.sampling.priors import ParamSpace
    from victor_tpu_torch.sampling.runner import unbounded_logpost
    from victor_tpu_torch.sampling.targets import resolve_target
    space = ParamSpace(block or QUAD_BLOCK)
    tables, loglike = resolve_target(bundle, opts_kw, None,
                                     gradient_free=False)
    return space, unbounded_logpost(space, loglike, tables)


def hmc_start(space, n_chains=8, seed=5):
    import torch
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    return space.to_unbounded(space.sample_ref(gen, n_chains)), gen


def hmc_backward_calls(bundle):
    """The backward kernel's calls in one gradient of the HMC target at 8
    chains (hmc_start), captured: (x, coeffs, q, grad_out, clamp, want_dq,
    want_dcoeffs) each, in the order of the gradient (sigma_v, v_r,
    xi_0)."""
    import torch
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.sampling.hmc import value_and_grad

    calls = []
    real = ppoly.ppoly_eval_backward_cuda

    def record(x, c, q, g, clamp=True, want_dq=True, want_dcoeffs=True):
        # the Function's saved inputs still require grad; the comparisons
        # run with gradients on, where the wrappers refuse them
        calls.append(tuple(t.detach() for t in (x, c, q, g)) +
                     (clamp, want_dq, want_dcoeffs))
        return real(x, c, q, g, clamp, want_dq, want_dcoeffs)

    space, logpost_y = boss_logpost(bundle)
    y0, _ = hmc_start(space)
    ppoly.ppoly_eval_backward_cuda = record
    try:
        value_and_grad(logpost_y)(y0)
    finally:
        ppoly.ppoly_eval_backward_cuda = real
    torch.cuda.synchronize()
    return calls


def interval_groups(x, q, clamp):
    """How a call's queries fall into intervals, which sets the backward's
    reduction work: over windows of 32 consecutive queries of a row, the
    number of windows whose largest set of queries sharing one interval
    has each size (a dict size -> windows); the share of queries in the
    interval of the query before; the mean length of a run of queries in
    one interval."""
    import torch
    n = x.shape[0]
    qq = torch.clamp(q, x[0], x[-1]) if clamp else q
    idx = torch.clamp(torch.searchsorted(x, qq.contiguous(), right=True) - 1,
                      0, n - 2)
    B, M = idx.shape
    w = idx[:, :M // 32 * 32].reshape(-1, 32)
    counts = torch.zeros(w.shape[0], n - 1, dtype=torch.int64,
                         device=q.device)
    counts.scatter_add_(1, w, torch.ones_like(w))
    hist = torch.bincount(counts.max(1).values, minlength=33).tolist()
    same = idx[:, 1:] == idx[:, :-1]
    return {'largest_group': {k: v for k, v in enumerate(hist) if v},
            'same_as_previous': float(same.double().mean()),
            'mean_run': B * M / (B * M - int(same.sum()))}


def backward_cold_ms(x, c, q, g, clamp, want_dq, want_dc, copies=6):
    """Device-only ms of one backward call with L2 cold (`rotated_ms`:
    distinct (q, grad_out) pairs, with their outputs)."""
    from victor_tpu_torch.kernels.ppoly import ppoly_eval_backward_cuda
    return rotated_ms('(q, grad_out) pairs', lambda qq, gg: (
        ppoly_eval_backward_cuda(x, c, qq, gg, clamp, want_dq, want_dc)),
        (q, g), nbytes(q, g) + (nbytes(q) if want_dq else 0), copies)


# Phase 12a's query patterns for the backward's reduction: (label, B, M,
# knots, one shared table, pattern), each in f64 and f32 with clamp, NaN
# and both infinities planted at the end of every row
BWD_PATTERNS = [
    ('every query in one interval', 8, N_POINTS, 30, False, 'one'),
    ('intervals alternating at every query', 8, N_POINTS, 30, False,
     'alternate'),
    ('long sorted runs', 8, N_POINTS, 30, False, 'sorted'),
    ('B = 1, one very long row', 1, 9_600_000, 25, False, 'random'),
    ('one table read by 64 rows', 64, N_POINTS, 30, True, 'random'),
]


def pattern_inputs(B, M, n, shared, pattern, dtype, gen):
    """The inputs of one of BWD_PATTERNS: `edge_inputs`' knots and
    coefficients (one channel), queries uniform within interval n // 3
    ('one'), alternating between intervals 3 and n - 5 ('alternate'),
    sorted over [x[0], x[n-1]] along each row ('sorted') or edge_inputs'
    own ('random'), and NaN, +inf and -inf as each row's last three."""
    import torch
    x, c, q = edge_inputs(B, M, n, 1, shared, 0, dtype, gen)
    if pattern == 'random':
        return x, c, q
    xd = x.double()
    u = torch.rand((B, M), generator=gen, device='cuda', dtype=torch.float64)
    if pattern == 'sorted':
        qd = xd[0] + (xd[-1] - xd[0]) * torch.sort(u, 1).values
    else:
        m = torch.arange(M, device='cuda')
        iv = torch.full_like(m, n // 3) if pattern == 'one' else \
            torch.where(m % 2 == 0, 3, n - 5)
        qd = xd[iv] + u * (xd[iv + 1] - xd[iv])
    q = qd.to(dtype)     # in f32 a query may round into the next interval
    q[:, -3:] = torch.tensor([float('nan'), float('inf'), float('-inf')],
                             dtype=dtype, device='cuda')
    return x, c, q


def backward_phase(bundle, gen):
    """Phase 12a: the backward kernel against its plain version at the HMC
    path's three lookups (captured from one gradient of the BOSS posterior
    at 8 chains, with how their queries fall into intervals), at K = 2 and
    3 over (8, 150000), at the Chebyshev-node shapes, at EDGE_CASES and at
    BWD_PATTERNS, in f64 and f32, every comparison twice for the same bits.
    Returns the timed results of the path's lookups by label."""
    import torch

    calls = hmc_backward_calls(bundle)
    check(len(calls) == 3, f'one gradient of the HMC target: {len(calls)} '
                           'backward calls (3: sigma_v, v_r, xi_0)')
    print('compare the ppoly_eval backward kernel vs plain:', flush=True)
    results = {}
    for x, c, q, g, clamp, want_dq, want_dc in calls:
        label = (f'backward on the HMC path: coeffs={tuple(c.shape)} '
                 f'q={tuple(q.shape)} clamp={clamp} dq={want_dq} '
                 f'dcoeffs={want_dc}')
        print(f'  {label}: queries by interval {interval_groups(x, q, clamp)}',
              flush=True)
        results[label] = compare_backward(label, x, c, q, g, clamp, want_dq,
                                          want_dc, time_it=True)
    for dtype in (torch.float64, torch.float32):
        for K, shared in ((2, False), (3, False), (2, True), (3, True)):
            x, c, q = edge_inputs(8, N_POINTS, 30, K, shared, 0, dtype, gen)
            compare_backward(f'backward K={K} coeffs={tuple(c.shape)} '
                             f'q={tuple(q.shape)} {str(dtype)[6:]}', x, c, q,
                             grad_out_like(q, K, gen), True)
        for label, B, M, n, K, shared, clamp, offset in EDGE_CASES:
            x, c, q = edge_inputs(B, M, n, K, shared, offset, dtype, gen)
            compare_backward(f'backward edge: {label}: q={tuple(q.shape)} '
                             f'coeffs={tuple(c.shape)} {str(dtype)[6:]} '
                             f'clamp={clamp}', x, c, q,
                             grad_out_like(q, K, gen), clamp)
        for label, B, M, n, shared, pattern in BWD_PATTERNS:
            x, c, q = pattern_inputs(B, M, n, shared, pattern, dtype, gen)
            compare_backward(f'backward pattern: {label}: q={tuple(q.shape)} '
                             f'coeffs={tuple(c.shape)} {str(dtype)[6:]}', x,
                             c, q, grad_out_like(q, 1, gen), True)
    return results


def grad_checks(bundle):
    """Phase 12c: d lnL / d theta of each of GRAD_CASES on the card (the
    kernels forward and backward, AD-resolved modes) at GOLDEN and
    DISPLACED against victor_tpu's jax.grad (GRAD_GOLDENS) within 1e-8
    relative, and the backward kernel's launches per gradient on the
    streaming path. Returns those launches."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.sampling.targets import resolve_target

    per_call = None
    for name, kw in GRAD_CASES.items():
        tables, loglike = resolve_target(bundle, kw or None, None,
                                         gradient_free=False)
        th = torch.tensor([GOLDEN, DISPLACED], dtype=torch.float64,
                          device='cuda', requires_grad=True)
        ppoly.LAUNCHES_BWD = 0
        lnl, _ = loglike(tables, {k: th[:, i] for i, k in enumerate(NAMES)})
        (grad,) = torch.autograd.grad(lnl.sum(), th)
        torch.cuda.synchronize()
        launches = ppoly.LAUNCHES_BWD
        want = np.array(GRAD_GOLDENS[name])
        got = grad.cpu().numpy()
        # relative to each entry, or to 1e-6 of the largest where an entry
        # is zero (sigma_v under kaiser)
        rel = float((np.abs(got - want) / np.maximum(
            np.abs(want), 1e-6 * np.abs(want).max())).max())
        check(rel <= 1e-8, f'd lnL / d theta ({name}) at the golden and '
                           f'displaced points: max relative error {rel:.3e} '
                           f'against jax.grad (<= 1e-8); backward kernel '
                           f'launches {launches}')
        if name == 'streaming':
            per_call = launches
    check(per_call >= 3, f'backward kernel launches per gradient on the '
                         f'streaming path: {per_call} (>= 3)')
    return per_call


def determinism(bundle):
    """Phase 12b: two 10-step HMC segments on the BOSS posterior from one
    saved state give the same bits (positions, lnp, gradients, the adapted
    state); then the ops on the gradient path that PyTorch itself calls
    non-deterministic (use_deterministic_algorithms, warn only), listed."""
    import warnings

    import torch
    from victor_tpu_torch.sampling import hmc

    space, logpost_y = boss_logpost(bundle)
    y0, gen = hmc_start(space)
    state = hmc.init_chains(logpost_y, y0, gen)
    saved = gen.get_state()
    runs = []
    for _ in range(2):
        gen.set_state(saved)
        st, recs = hmc.run_segment(logpost_y, state, 0, 10, n_warmup=10)
        torch.cuda.synchronize()
        runs.append((st, recs))
    (a, ra), (b, rb) = runs
    same = all(torch.equal(x, y) for x, y in zip(ra, rb)) and all(
        torch.equal(getattr(a, f), getattr(b, f))
        for f in ('q', 'lnp', 'grad', 'aux', 'log_eps', 'welford_m2'))
    check(same, 'two 10-step HMC segments from one saved state: the same '
                'bits (draws, lnp, gradients, adaptation)')
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            hmc.value_and_grad(logpost_y)(y0)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split('\n')[0][:160] for w in caught
                      if 'deterministic' in str(w.message)})
    print(f'  ops that torch flags as non-deterministic on the gradient '
          f'path: {flagged or "none"}', flush=True)


def posterior_gates(out, what, mean_tol, std_tol):
    for name in NAMES:
        got = out['summary'][name]
        mean, std = QUAD_MEAN[name], QUAD_STD[name]
        check(abs(got['mean'] - mean) < mean_tol * std and
              abs(got['std'] / std - 1.0) < std_tol,
              f"{what} posterior {name}: mean {got['mean']:.5g} ({mean:g} "
              f"+- {mean_tol} x {std:g}), std {got['std']:.4g} ({std:g} +- "
              f'{std_tol:.0%})')


def chain_files(root):
    """The sampled columns of the eight GetDist chain files, (S, 8, 4), and
    their parameter names in the files' order (`.paramnames`)."""
    import numpy as np
    with open(f'{root}.paramnames') as f:
        names = [line.split()[0] for line in f][:len(NAMES)]
    return np.stack([np.loadtxt(f'{root}.{i}.txt', ndmin=2)[:, 2:6]
                     for i in range(1, 9)], axis=1), names


def hmc_cli(cfg, tmp, seed=HMC_SEED):
    """Phase 12d: `run --sampler hmc` with its defaults (8 chains, 300
    warmup steps, 16 leapfrogs) on QUAD_BLOCK, rhat_stop 0.01, at most
    HMC_DRAWS draws, generator seed `seed`. Returns (backward launches,
    leapfrogs, seconds, draws, R-1)."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels import dispersion, ppoly
    from victor_tpu_torch.sampling.diagnostics import (effective_sample_size,
                                                       split_rhat)

    run_cfg = {**cfg, 'params': QUAD_BLOCK,
               'sampler': {'n_chains': 8, 'rhat_stop': 0.01}}
    path = write_yaml(run_cfg, os.path.join(tmp, f'boss_hmc_{seed}.yaml'))
    root = os.path.join(tmp, 'chains', f'hmc_{seed}')
    ppoly.LAUNCHES = ppoly.LAUNCHES_BWD = dispersion.LAUNCHES = 0
    out = cli_json(['run', path, '--sampler', 'hmc', '--samples',
                    str(HMC_DRAWS), '--seed', str(seed), '--output', root])
    torch.cuda.synchronize()
    launches = (ppoly.LAUNCHES_BWD, ppoly.LAUNCHES, dispersion.LAUNCHES)
    # one forward and one backward lookup of each of three splines per
    # gradient; the first is the chains' initial point
    leapfrogs = launches[0] // 3 - 1
    chains, names = chain_files(root)
    n = out['n_samples']
    check(chains.shape == (n, 8, 4) and np.isfinite(chains).all(),
          f'HMC chains: {chains.shape}, finite')
    rm1 = float(np.max(split_rhat(chains) - 1))
    with open(f'{root}.progress') as f:        # R-1 after each segment
        trace = [row.split()[4] for row in f if not row.startswith('#')]
    print(f'  HMC seed {seed}: R-1 after each segment {trace}; per parameter '
          f'{dict(zip(names, np.round(split_rhat(chains) - 1, 5)))}, ESS '
          f'{dict(zip(names, np.round(effective_sample_size(chains), 1)))}',
          flush=True)
    print(f"  HMC (8 chains, AD modes): {n} draws after 300 warmup steps, "
          f"max R-1 {rm1:.6f}, acceptance {out['acceptance']}, "
          f"{out['elapsed_s']} s, {leapfrogs} leapfrogs "
          f"({leapfrogs / out['elapsed_s']:.1f} leapfrogs/s, "
          f'{leapfrogs / (300 + n):.2f} per step); kernel launches: '
          f'backward {launches[0]}, forward {launches[1]}', flush=True)
    check(rm1 < 0.01, f'HMC converged: max R-1 {rm1:.5f} < 0.01 within '
                      f'{HMC_DRAWS} draws ({n})')
    posterior_gates(out, 'HMC', 0.2, 0.15)
    check(launches[0] > 0 and launches[1] > 0 and launches[2] == 0,
          'the HMC path launched the ppoly_eval kernel forward and backward, '
          'no dispersion_final (streaming model)')
    return launches[0], leapfrogs, out['elapsed_s'], n, rm1


def nuts_cli(cfg, tmp, warmup=NUTS_WARMUP, samples=NUTS_SAMPLES):
    """Phase 12e: `run --sampler nuts` with `warmup` steps and at most
    `samples` draws (max_depth 6 and rhat_stop 0.01 by default)."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.sampling import nuts

    run_cfg = {**cfg, 'params': QUAD_BLOCK, 'sampler': {'n_chains': 8}}
    path = write_yaml(run_cfg, os.path.join(tmp, 'boss_nuts.yaml'))
    root = os.path.join(tmp, 'chains', 'nuts')
    ppoly.LAUNCHES_BWD = 0
    nuts.STATS.update(steps=0, doublings=0, accept_stat=0.0)
    out = cli_json(['run', path, '--sampler', 'nuts', '--warmup', str(warmup),
                    '--samples', str(samples), '--output', root])
    torch.cuda.synchronize()
    chains, names = chain_files(root)
    box = np.array([[QUAD_BLOCK[k]['prior']['min'],
                     QUAD_BLOCK[k]['prior']['max']] for k in names])
    inside = bool(((chains >= box[:, 0]) & (chains <= box[:, 1])).all())
    check(np.isfinite(chains).all() and inside,
          f'NUTS chains {chains.shape}: every draw finite and inside the '
          'prior box')
    stats = nuts.STATS
    leapfrogs = ppoly.LAUNCHES_BWD // 3 - 1
    print(f"  NUTS (8 chains, max_depth 6): {out['n_samples']} draws after "
          f"{warmup} warmup steps, acceptance {out['acceptance']}, mean tree depth "
          f"{stats['doublings'] / stats['steps']:.3f}, mean acceptance "
          f"statistic {float(stats['accept_stat']) / stats['steps']:.4f}, "
          f"{out['elapsed_s']} s, {leapfrogs} leapfrogs of the batch "
          f"({leapfrogs / out['elapsed_s']:.1f}/s), R-hat "
          f"{ {k: v['rhat'] for k, v in out['summary'].items()} }",
          flush=True)
    posterior_gates(out, 'NUTS', 0.3, 0.25)


def start_nuts_child(tmp):
    """Phase 12e in a process of its own (`--nuts-child`), started beside
    phase 12d: both are host-bound, and the card and the host's cores have
    room for two. Returns the Popen; `finish_nuts_child` collects it."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--nuts-child', tmp],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def finish_nuts_child(proc, timeout):
    """Wait for the phase-12e process, print what it printed, and fail if
    it failed."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        print(out, flush=True)
        raise RuntimeError('chip_smoke: the NUTS phase did not finish within '
                           f'{timeout} s')
    print(out.rstrip(), flush=True)
    check(proc.returncode == 0,
          f'the NUTS phase (its own process) exited {proc.returncode}')


def hmc_rates(bundle, card, profile_path):
    """Phase 12d's profile and 12f (information): leapfrogs per second of
    8 HMC chains on the BOSS posterior with streaming_eval 'exact' (the AD
    default), 'fast' and 'exact' again, 10 steps each after 3 (a leapfrog
    costs the same whatever the step size); then the kernels' device time
    per leapfrog of 2 more 'exact' steps under torch.profiler (its
    post-processing grows with the ~2,300 operations of each leapfrog)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from victor_tpu_torch.sampling import hmc

    for mode in ('exact', 'fast', 'exact'):
        space, logpost_y = boss_logpost(bundle, {'streaming_eval': mode})
        calls = [0]

        def counted(y):
            calls[0] += 1
            return logpost_y(y)
        y0, gen = hmc_start(space)
        st = hmc.init_chains(counted, y0, gen)
        st, _ = hmc.run_segment(counted, st, 0, 3, n_warmup=60)
        torch.cuda.synchronize()
        calls[0] = 0
        t0 = time.perf_counter()
        st, _ = hmc.run_segment(counted, st, 3, 10, n_warmup=60)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"HMC leapfrogs/s, streaming_eval '{mode}' under AD (8 chains, "
              f'10 steps, {calls[0]} leapfrogs): {calls[0] / dt:.1f} '
              f'({1e3 * dt / calls[0]:.2f} ms per leapfrog) on {card}',
              flush=True)
    calls[0] = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hmc.run_segment(counted, st, 13, 2, n_warmup=60)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    bwd_us = sum(e.device_time_total for e in events
                 if e.device_type == DeviceType.CUDA and 'ppoly_bwd' in e.key)
    print(f'  HMC under torch.profiler (streaming_eval exact, {calls[0]} '
          f'leapfrogs): kernels {device_us / 1e3 / calls[0]:.3f} ms per '
          f'leapfrog (the backward kernel {bwd_us / 1e3 / calls[0]:.3f} ms) '
          f'of {1e3 * dt / calls[0]:.3f} ms wall', flush=True)
    if profile_path:
        with open(profile_path, 'a') as f:
            f.write(f'\n== HMC, 2 steps of 8 chains, {calls[0]} leapfrogs, '
                    'f64\n' + events.table(sort_by='cuda_time_total',
                                           row_limit=30) + '\n')


# ---------------------------------------------------------------------------
# Phase 13: second derivatives and the optimizer layer
# ---------------------------------------------------------------------------

def second_order_ops(n, K):
    """Operations per query of the second-order terms as the fused kernel
    computes them: the clip's selects and factor, the search's compares,
    u c(q), and per channel the derived table (two products), u g and the
    two derivative sums on D and V (six each), the two Horner forms with
    their NaN term (eight each), the products and sums that join them
    (four), the weight (u c(q)) g and the coefficient terms (three products,
    four sums)."""
    return 6 + math.ceil(math.log2(n - 1)) + 42 * K


def second_order_plain(x, c, q, g, u, V, clamp, wants):
    """The plain version of the second-order terms: autograd with
    create_graph=True through ppoly_eval_backward_plain, the gradient of
    <u, dq> + <V, dcoeffs> to (coeffs, q, grad_out) where `wants` says so
    (None elsewhere; zeros where the gradient does not reach)."""
    import torch
    from victor_tpu_torch.kernels.ppoly import ppoly_eval_backward_plain
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(w) for a, w in zip((c, q, g),
                                                               wants)]
        dq, dc = ppoly_eval_backward_plain(x, *leaves, clamp)
        s = sum((d * w).sum() for d, w in ((dq, u), (dc, V)) if w is not None)
        asked = [a for a, w in zip(leaves, wants) if w]
        grads = iter(torch.autograd.grad(s, asked, allow_unused=True))
    out = []
    for a, w in zip(leaves, wants):
        d = next(grads) if w else None
        out.append(torch.zeros_like(a) if w and d is None else d)
    return out


def second_order_scales(x, c, q, g, u, clamp):
    """The scale of each d/dcoeffs entry (f64): (0, A_0, 2 A_1, 3 A_2) with
    A the summed magnitudes of the coefficient terms under the grad
    |u c(q) g|."""
    import torch
    from victor_tpu_torch.kernels.ppoly import clip_factor
    if u is None:
        return torch.zeros_like(c, dtype=torch.float64)
    x, q = x.double(), q.double()
    w = (u.double() * (clip_factor(x, q) if clamp else 1.0)).abs()
    w = w[:, None] * g.double().abs() if c.ndim == 4 else w * g.double().abs()
    A = abs_terms(x, c, q, w, clamp)
    return torch.stack([torch.zeros_like(A[..., 0]), A[..., 0],
                        2.0 * A[..., 1], 3.0 * A[..., 2]], -1)


def same_terms(a, b):
    """(equal, differing bits): two calls' second-order terms equal entry
    for entry (None in the same places, NaN positions identical, every other
    entry equal), and the number of entries whose bit patterns differ (a
    zero's sign or a NaN's payload)."""
    import torch
    equal, bits = True, 0
    for s, t in zip(a, b):
        if s is None or t is None:
            equal = equal and s is None and t is None
            continue
        equal = equal and torch.equal(torch.isnan(s), torch.isnan(t)) and \
            torch.equal(torch.nan_to_num(s), torch.nan_to_num(t))
        ints = torch.int64 if s.dtype == torch.float64 else torch.int32
        bits += int((s.view(ints) != t.view(ints)).sum())
    return equal, bits


def second_order_cold_ms(fn, reps, x, c, q, g, u, V, clamp, wants,
                         copies=6):
    """Device-only ms of one second-order call `fn` with L2 cold
    (`rotated_ms`: distinct (q, grad_out, u) triples, with their
    outputs)."""
    return rotated_ms('(q, grad_out, u) triples and outputs', lambda qq, gg,
                      uu: fn(x, c, qq, gg, uu, V, clamp, *wants), (q, g, u),
                      2 * nbytes(q) + 2 * nbytes(g) +
                      (nbytes(u) if u is not None else 0), copies, reps)


def compare_second_order(label, x, c, q, g, u, V, clamp, wants,
                         time_it=False):
    """The second-order terms on the card (ppoly_eval_second_order: the
    fused kernel) against the composed path (the forward and backward
    kernels on derived tables, ppoly_eval_second_order_composed), equal
    entry for entry (`same_terms`; the differing bits printed), and against
    their plain version (in f64) on the same inputs: NaN and inf positions
    identical (d/dq and d/dgrad_out NaN at an infinite query without clamp,
    the port's rule where its forward is NaN), d/dq and d/dgrad_out within
    TOL x their largest entry, d/dcoeffs within TOL x the summed magnitudes
    of its terms; a second call gives the same bits, with one launch, two
    with d/dcoeffs, and no forward or backward launch. Returns the timed
    result when `time_it`: fused and composed in turns, device only, L2
    warm and cold, and host us per call; else the max abs error."""
    import torch
    from victor_tpu_torch.kernels import ppoly

    def kernel():
        return ppoly.ppoly_eval_second_order(x, c, q, g, u, V, clamp, *wants)

    def composed():
        return ppoly.ppoly_eval_second_order_composed(x, c, q, g, u, V, clamp,
                                                      *wants)

    counts = ppoly.LAUNCHES, ppoly.LAUNCHES_BWD, ppoly.LAUNCHES_2ND
    got, again = kernel(), kernel()
    per_call = 1 + bool(wants[0] and u is not None)
    check((ppoly.LAUNCHES, ppoly.LAUNCHES_BWD, ppoly.LAUNCHES_2ND) ==
          (counts[0], counts[1], counts[2] + 2 * per_call),
          f'{label}: {per_call} second-order launch(es) per call, no '
          'forward or backward launch')
    equal, bits = same_terms(got, composed())
    torch.cuda.synchronize()
    check(equal, f'{label}: fused equals composed in every term, entry for '
                 f'entry ({bits} entries with other bits)')
    f64 = [None if a is None else a.double() for a in (x, c, q, g, u, V)]
    want = second_order_plain(*f64, clamp, wants)
    if not clamp:
        # the port's rule at an infinite query without clamp, where the
        # forward is NaN: d/dq and d/dgrad_out are NaN there
        inf = torch.isinf(q)
        want[1:] = [None if w is None else torch.where(
            inf if w.shape == q.shape else inf[:, None], math.nan, w)
            for w in want[1:]]
    torch.cuda.synchronize()
    tol = TOL[str(q.dtype)[6:]]
    scales = (second_order_scales(x, c, q, g, u, clamp), None, None)
    err = 0.0
    for what, k, p, k2, scale in zip(('d/dcoeffs', 'd/dq', 'd/dgrad_out'),
                                     got, want, again, scales):
        if p is None:
            check(k is None, f'{label}: no {what} when not asked for')
            continue
        k = torch.zeros_like(p) if k is None else k.double()
        k2 = torch.zeros_like(p) if k2 is None else k2.double()
        check(torch.equal(torch.isnan(k), torch.isnan(p)) and
              torch.equal(torch.isinf(k), torch.isinf(p)),
              f'{label} {what}: NaN and inf positions identical')
        fin = torch.isfinite(p)
        d = (k - p)[fin].abs()
        top = float(p[fin].abs().max()) if d.numel() else 0.0
        bound = tol * (scale[fin] if scale is not None else top)
        worst = float((d - bound).max()) if d.numel() else -1.0
        check(worst <= 1e-300, f'{label} {what}: max|kernel - plain| = '
                               f'{float(d.max()) if d.numel() else 0.0:.3e} '
                               f'within {tol:g} x its scale')
        check(torch.equal(torch.nan_to_num(k2), torch.nan_to_num(k)),
              f'{label} {what}: two calls, the same bits')
        err = max(err, float(d.max()) if d.numel() else 0.0)
    if not time_it:
        return err
    K = c.shape[1] if c.ndim == 4 else 1
    outs = [a for a in got if a is not None]
    ins = [a for a in (x, c, q, g, u, V) if a is not None]
    f1, c1 = device_ms(kernel), device_ms(composed, 10)
    c2, f2 = device_ms(composed, 10), device_ms(kernel)
    p1 = device_ms(lambda: second_order_plain(x, c, q, g, u, V, clamp,
                                              wants), 3)
    cold = [second_order_cold_ms(fn, reps, x, c, q, g, u, V, clamp, wants)
            for fn, reps in ((ppoly.ppoly_eval_second_order, 50),
                             (ppoly.ppoly_eval_second_order_composed, 10))]
    us, us_c = host_us(kernel), host_us(composed, calls=200, chunk=20)
    result = {'max_abs_err': err, 'ms': (f1 + f2) / 2,
              'composed_ms': (c1 + c2) / 2, 'plain_ms': p1, 'cold_ms': cold[0],
              'composed_cold_ms': cold[1], 'host_us': us,
              'composed_host_us': us_c, 'launches_per_call': per_call,
              'bytes': nbytes(*ins, *outs),
              'ops': q.numel() * second_order_ops(x.shape[0], K)}
    print(f'  {label}: fused {result["ms"]:.5f} ms (L2 cold {cold[0]:.5f}), '
          f'composed {result["composed_ms"]:.5f} ms (cold {cold[1]:.5f}), '
          f'plain {p1:.4f} ms (device only); host {us:.2f} us per fused '
          f'call, {us_c:.2f} per composed call', flush=True)
    return result


def cotangents(c, q, gen):
    import torch
    return (torch.randn(q.shape, generator=gen, device='cuda',
                        dtype=torch.float64).to(q.dtype),
            torch.randn(c.shape, generator=gen, device='cuda',
                        dtype=torch.float64).to(c.dtype))


def lookup_key(c, clamp):
    """Which spline lookup a second-order call serves, whatever its batch:
    the coefficient table's shape past its rows, and the clamp."""
    return tuple(c.shape[1:]), clamp


def hessian_second_order_calls(bundle):
    """The second-order calls of one Hessian of the BOSS streaming target
    (4 replicated rows of one point), captured: (x, coeffs, q, grad_out, u,
    V, clamp, wants) each, for sigma_v, v_r and xi_0."""
    import torch
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.sampling.optimize import value_grad_hessian

    calls = []
    real = ppoly.ppoly_eval_second_order

    def record(x, c, q, g, u, V, clamp=True, *wants):
        calls.append(tuple(None if t is None else t.detach()
                           for t in (x, c, q, g, u, V)) + (clamp, wants))
        return real(x, c, q, g, u, V, clamp, *wants)

    space, logpost_y = boss_logpost(bundle)
    y0, _ = hmc_start(space, n_chains=1)
    ppoly.ppoly_eval_second_order = record
    try:
        value_grad_hessian(lambda y: -logpost_y(y)[0], y0)
    finally:
        ppoly.ppoly_eval_second_order = real
    torch.cuda.synchronize()
    check(len(calls) == 3, f'one Hessian of the BOSS target: {len(calls)} '
                           'second-order calls (3: sigma_v, v_r, xi_0)')
    return calls


def second_order_phase(bundle, gen):
    """Phase 13a: the second-order terms on the card (the fused kernel)
    against the composed path and their plain version at the three lookups
    of one Hessian of the BOSS streaming target (captured; timed in f64), at
    K = 2 and 3 over (8, 150000) and at EDGE_CASES, in f64 and f32, every
    comparison twice for the same bits. Returns {lookup_key: (label, timed
    result)} of the Hessian's lookups."""
    import torch

    calls = hessian_second_order_calls(bundle)
    print('compare the ppoly_eval second-order terms: fused vs composed vs '
          'plain:', flush=True)
    results = {}
    for dtype in (torch.float64, torch.float32):
        for x, c, q, g, u, V, clamp, wants in calls:
            x, c, q, g, u, V = (None if a is None else a.to(dtype)
                                for a in (x, c, q, g, u, V))
            label = (f'second order on the Hessian path: coeffs='
                     f'{tuple(c.shape)} q={tuple(q.shape)} clamp={clamp} '
                     f'u={u is not None} V={V is not None} wants={wants} '
                     f'{str(dtype)[6:]}')
            res = compare_second_order(label, x, c, q, g, u, V, clamp, wants,
                                       time_it=dtype == torch.float64)
            if dtype == torch.float64:
                results[lookup_key(c, clamp)] = label, res
        for K, shared in ((2, False), (3, False), (2, True), (3, True)):
            x, c, q = edge_inputs(8, N_POINTS, 30, K, shared, 0, dtype, gen)
            u, V = cotangents(c, q, gen)
            compare_second_order(f'second order K={K} coeffs='
                                 f'{tuple(c.shape)} q={tuple(q.shape)} '
                                 f'{str(dtype)[6:]}', x, c, q,
                                 grad_out_like(q, K, gen), u, V, True,
                                 (True, True, True))
        for label, B, M, n, K, shared, clamp, offset in EDGE_CASES:
            x, c, q = edge_inputs(B, M, n, K, shared, offset, dtype, gen)
            u, V = cotangents(c, q, gen)
            compare_second_order(f'second order edge: {label}: '
                                 f'q={tuple(q.shape)} coeffs='
                                 f'{tuple(c.shape)} {str(dtype)[6:]} '
                                 f'clamp={clamp}', x, c, q,
                                 grad_out_like(q, K, gen), u, V, clamp,
                                 (True, True, True))
    return results


def neg_loglike_hessian(bundle, kw, points):
    """-Hessian of lnL (AD-resolved modes) at `points` (P, 4) on the card,
    by replicated rows (sampling.optimize.value_grad_hessian)."""
    import torch
    from victor_tpu_torch.sampling.optimize import value_grad_hessian
    from victor_tpu_torch.sampling.targets import resolve_target
    tables, loglike = resolve_target(bundle, kw or None, None,
                                     gradient_free=False)

    def neg(th):
        return -loglike(tables, {k: th[:, i] for i, k in
                                 enumerate(NAMES)})[0]
    th = torch.tensor(points, dtype=torch.float64, device='cuda')
    return value_grad_hessian(neg, th)[2]


def hessian_checks(bundle, card):
    """Phase 13b: -Hessians of lnL of GRAD_CASES at GOLDEN and DISPLACED
    against victor_tpu's jax.hessian (HESS_GOLDENS) within 1e-8 of max|H|;
    then one Hessian of the streaming case timed (wall, and device time
    under torch.profiler), its second-order launches and its peak device
    memory."""
    import numpy as np

    for name, kw in GRAD_CASES.items():
        H = neg_loglike_hessian(bundle, kw, [GOLDEN, DISPLACED]).cpu().numpy()
        want = np.array(HESS_GOLDENS[name])
        err = max(float(np.abs(h - w).max() / np.abs(w).max())
                  for h, w in zip(H, want))
        check(np.isfinite(H).all() and err <= 1e-8,
              f'-Hessian of lnL ({name}) at the golden and displaced points: '
              f'max error {err:.3e} of max|H| against jax.hessian (<= 1e-8)')
    t = hessian_timing(bundle)
    check(t['launches'] > 0, f'second-order kernel launches per Hessian '
                             f'(streaming, one point): {t["launches"]}')
    print(f'  one 4 x 4 Hessian (streaming, one point, 4 replicated rows): '
          f'{t["wall_ms"]:.2f} ms wall, {t["device_ms"]:.2f} ms of kernels '
          f'under torch.profiler, {t["launches"]} second-order launches, '
          f'peak {t["peak_gib"]:.2f} GiB on {card}', flush=True)


def hessian_timing(bundle):
    """One -Hessian of lnL of the streaming case at GOLDEN after one of
    warm-up: its wall ms, its second-order launches and peak device memory
    (GiB), then the device ms of its kernels under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from victor_tpu_torch.kernels import ppoly

    neg_loglike_hessian(bundle, {}, [GOLDEN])          # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ppoly.LAUNCHES_2ND = 0
    t0 = time.perf_counter()
    neg_loglike_hessian(bundle, {}, [GOLDEN])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ppoly.LAUNCHES_2ND
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        neg_loglike_hessian(bundle, {}, [GOLDEN])
        torch.cuda.synchronize()
    device_us = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    return {'wall_ms': 1e3 * wall, 'device_ms': device_us / 1e3,
            'launches': launches, 'peak_gib': peak}


class Captured:
    """Record the arguments and results of a function of `module` (default
    victor_tpu_torch.sampling.optimize) while a CLI command runs in this
    process (the CLI imports it at call time), so that the script reads the
    unrounded results."""

    def __init__(self, name, module=None):
        if module is None:
            from victor_tpu_torch.sampling import optimize as module
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls, self.results = [], []

    def __enter__(self):
        def wrapped(*args, **kw):
            res = self.real(*args, **kw)
            self.calls.append((args, kw))
            self.results.append(res)
            return res
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def check_map(res, what):
    """A MAP result against FIT_GOLDENS at full precision: theta within
    1e-4 Laplace sigma, chi2 within 1e-6, each sigma within 1e-6 relative,
    stationary (grad_norm < 1e-6) and a positive definite Hessian."""
    import numpy as np
    sd = np.array(FIT_GOLDENS['std'])
    # by name: the CLI's YAML round-trip sorts the params block
    order = [res.space.names.index(n) for n in NAMES]
    theta, cov = res.theta[order], res.cov[np.ix_(order, order)]
    dth = float(np.max(np.abs(theta - FIT_GOLDENS['theta']) / sd))
    dchi = abs(res.chi2 - FIT_GOLDENS['chi2'])
    dsd = float(np.max(np.abs(np.sqrt(np.diag(cov)) / sd - 1.0)))
    check(dth <= 1e-4 and dchi <= 1e-6 and dsd <= 1e-6 and
          res.grad_norm < 1e-6 and res.hessian_pd,
          f'{what}: theta within {dth:.2e} sigma (<= 1e-4), chi2 '
          f'{res.chi2:.8f} ({FIT_GOLDENS["chi2"]:.8f}), sigma within '
          f'{dsd:.2e} (<= 1e-6), |grad| {res.grad_norm:.2e} (< 1e-6), '
          f'Hessian positive definite: {res.hessian_pd}')


def start_fit_cli(tmp):
    """Phase 13c, started beside phase 12d (its host-bound HMC run leaves
    the card and most host cores idle): `python -m victor_tpu_torch fit
    configs/boss_sampling_config.yaml` with its defaults in a subprocess,
    the README's .npz --set lines and --covmat-out. Returns what
    `finish_fit_cli` reads."""
    stem = 'data/BOSS_DR12_CMASS_npz/CMASS_zobovVoids_reconRs10_0.43z0.7_' \
        'medianRvcut'
    covmat = os.path.join(tmp, 'fit.covmat')
    argv = [sys.executable, '-m', 'victor_tpu_torch', 'fit',
            'configs/boss_sampling_config.yaml',
            '--set', f'model.input_model_data_file={stem}_PatchyMean_model.npz',
            '--set', f'data.redshift_space_ccf.data_file={stem}_data.npz',
            '--set', 'data.covariance_matrix.data_file='
                     f'{stem}_variable_D_covariance.npz',
            '--covmat-out', covmat]
    env = {**os.environ, 'PYTHONPATH': os.pathsep.join(
        [REPO] + ([os.environ['PYTHONPATH']] if 'PYTHONPATH' in os.environ
                  else []))}
    # into files, not pipes: nobody reads a pipe while phase 12d runs
    logs = [open(os.path.join(tmp, f'fit.{k}'), 'w+') for k in ('out', 'err')]
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=logs[0],
                            stderr=logs[1], text=True)
    return proc, covmat, logs


def finish_fit_cli(started, timeout):
    """Phase 13c: the `fit` subprocess's printed best fit, chi2 and Laplace
    sigmas against FIT_GOLDENS at the JSON's rounding, stationary, a
    Laplace evidence (a positive definite Hessian), and the covmat file
    read back as those sigmas."""
    import numpy as np
    from victor_tpu_torch.sampling.chains import read_covmat
    proc, covmat, logs = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError('chip_smoke: the fit subprocess did not finish '
                           f'within {timeout} s')
    for f in logs:
        f.seek(0)
    stdout, stderr = (f.read() for f in logs)
    for f in logs:
        f.close()
    if proc.returncode != 0:
        raise RuntimeError('chip_smoke: `python -m victor_tpu_torch fit` '
                           f'exited {proc.returncode}:\n{stderr[-4000:]}')
    out = json.loads(stdout)
    sd = np.array(FIT_GOLDENS['std'])
    names = list(out['best_fit'])
    theta = np.array([out['best_fit'][n] for n in NAMES])
    check(names == NAMES, f'fit: the parameters {names}')
    dth = float(np.max((np.abs(theta - FIT_GOLDENS['theta']) - 5e-7) / sd))
    check(dth <= 1e-4, f'fit: best fit {out["best_fit"]} within '
                       f'{max(dth, 0.0):.2e} Laplace sigma of victor_tpu '
                       'beyond its rounding (<= 1e-4)')
    check(abs(out['chi2'] - FIT_GOLDENS['chi2']) <= 5e-5 + 1e-6,
          f'fit: chi2 {out["chi2"]} ({FIT_GOLDENS["chi2"]:.6f}) within 1e-6 '
          'beyond its rounding to 4 places')
    check(out['grad_norm'] < 1e-6 and
          out['log_evidence_laplace'] is not None,
          f'fit: |grad| {out["grad_norm"]:.2e} (< 1e-6), Laplace evidence '
          f'{out["log_evidence_laplace"]} (a positive definite Hessian)')
    cov = read_covmat(covmat, NAMES)
    file_sd = np.sqrt(np.diag(cov))
    dsd = float(np.max(np.abs(file_sd / sd - 1.0)))
    check(dsd <= 1e-6 and np.allclose(
        file_sd, [out['std_laplace'][n] for n in NAMES], rtol=0, atol=5e-7),
        f'fit --covmat-out: the file reads back as the Laplace covariance '
        f'(sigmas within {dsd:.2e} of victor_tpu, <= 1e-6; as printed)')
    print(f'  fit subprocess (32 starts, 250 Adam steps, 8 Newton steps, '
          f'beside phase 12d): the fit {out["elapsed_s"]} s', flush=True)


def forecast_check(path):
    """Phase 13d: `forecast` at the config's ref point through the CLI's
    main: each Fisher sigma against victor_tpu's (FISHER_GOLDENS) within
    1e-8 relative."""
    import numpy as np
    import torch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Captured('fisher_forecast') as cap:
        out = cli_json(['forecast', path])
    wall = time.perf_counter() - t0
    got = np.array([cap.results[0].std[n] for n in NAMES])
    rel = float(np.max(np.abs(got / FISHER_GOLDENS - 1.0)))
    check(rel <= 1e-8, f'forecast at {out["fiducial"]}: sigma_fisher '
                       f'{out["sigma_fisher"]} within {rel:.2e} of '
                       'victor_tpu (<= 1e-8)')
    print(f'  forecast: {wall:.2f} s, peak '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB', flush=True)
    return wall


def scan_check(path):
    """Phase 13e: `scan --param fsigma8 --ngrid 9` through the CLI's main:
    its MAP (32 starts, 150 Adam steps) against FIT_GOLDENS, the profile's
    minimum at the MAP's chi2 within 1e-6, and every grid point and its
    profile chi2 against victor_tpu's (SCAN_GOLDENS) within 1e-5."""
    import numpy as np
    import torch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Captured('profile_scan') as cap:
        out = cli_json(['scan', path, '--param', 'fsigma8', '--ngrid', '9'])
    wall = time.perf_counter() - t0
    res = cap.results[0]
    check_map(res.map_result, 'scan: the MAP')
    dmin = abs(float(res.chi2.min()) - res.map_result.chi2)
    check(dmin <= 1e-6, f'scan: the profile minimum {res.chi2.min():.8f} is '
                        f'the MAP chi2 {res.map_result.chi2:.8f} within '
                        f'{dmin:.2e} (<= 1e-6)')
    dgrid = float(np.max(np.abs(res.grid[:, 0] - SCAN_GOLDENS['grid'])))
    dchi = float(np.max(np.abs(res.chi2 - SCAN_GOLDENS['chi2'])))
    check(dgrid <= 1e-6 and dchi <= 1e-5,
          f'scan: grid within {dgrid:.2e} (<= 1e-6) and every profile chi2 '
          f'within {dchi:.2e} (<= 1e-5) of victor_tpu; intervals '
          f'{out["interval_68"]}, {out["interval_95"]}')
    print(f'  scan: {wall:.2f} s, peak '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB', flush=True)
    return wall


def bootstrap_check(path):
    """Phase 13f: `fit --bootstrap 4` through the CLI's main, with the
    launch counts set to 0 just before: the fit against FIT_GOLDENS at full
    precision; every refit finite, within 1e-4 Laplace sigma of
    victor_tpu's refit of the same mock (BOOT_GOLDENS) and polished
    (|grad| < 1e-3); every second-order call one launch of the fused kernel
    (two with d/dcoeffs) and none of the forward or backward kernel; bias
    and sigma (information). Returns the launches (forward, backward,
    second order) and, by lookup_key, the second-order calls and the kernel
    launches they made."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels import ppoly
    per_lookup = {}
    real = ppoly.ppoly_eval_second_order

    odd = []            # calls that did not launch the fused kernel alone

    def count(x, c, q, g, u, V, clamp=True, *wants):
        before = ppoly.LAUNCHES, ppoly.LAUNCHES_BWD, ppoly.LAUNCHES_2ND
        out = real(x, c, q, g, u, V, clamp, *wants)
        key = lookup_key(c, clamp)
        calls, launches = per_lookup.get(key, (0, 0))
        made = ppoly.LAUNCHES_2ND - before[2]
        per_lookup[key] = calls + 1, launches + made
        per_call = 1 + bool((wants[0] if wants else True) and u is not None)
        if made != per_call or (ppoly.LAUNCHES, ppoly.LAUNCHES_BWD) != \
                before[:2]:
            odd.append(key)
        return out

    torch.cuda.synchronize()
    ppoly.LAUNCHES = ppoly.LAUNCHES_BWD = ppoly.LAUNCHES_2ND = 0
    ppoly.ppoly_eval_second_order = count
    t0 = time.perf_counter()
    try:
        with Captured('find_map') as cap:
            out = cli_json(['fit', path, '--bootstrap', '4'])
        torch.cuda.synchronize()
    finally:
        ppoly.ppoly_eval_second_order = real
    wall = time.perf_counter() - t0
    launches = (ppoly.LAUNCHES, ppoly.LAUNCHES_BWD, ppoly.LAUNCHES_2ND)
    main, refits = cap.results[0], cap.results[1:]
    check_map(main, 'fit (in process)')
    sd = np.array(FIT_GOLDENS['std'])
    dev = [float(np.max(np.abs(np.array([r.params[n] for n in NAMES]) - want)
                        / sd)) for r, want in zip(refits, BOOT_GOLDENS)]
    check(len(refits) == 4 and all(np.isfinite(r.theta).all()
                                   for r in refits) and max(dev) <= 1e-4 and
          max(r.grad_norm for r in refits) < 1e-3,
          'fit --bootstrap 4: every refit finite and at victor_tpu\'s refit '
          f'of the same mock (BOOT_GOLDENS) within {max(dev):.2e} Laplace '
          f'sigma (<= 1e-4); |grad| {[f"{r.grad_norm:.1e}" for r in refits]}'
          ' (< 1e-3: polished; a Newton step whose gain is under the float '
          'resolution is rejected, as in victor_tpu)')
    b = out['bootstrap']
    check(all(math.isfinite(v) for d in (b['bias'], b['std_bootstrap'])
              for v in d.values()),
          f'fit --bootstrap 4: bias {b["bias"]}, sigma {b["std_bootstrap"]} '
          'finite')
    check(all(n > 0 for n in launches),
          f'fit --bootstrap 4 launched the forward ({launches[0]}), backward '
          f'({launches[1]}) and second-order ({launches[2]}) kernels')
    check(not odd, 'fit --bootstrap 4: every second-order call launched '
                   'the fused kernel once (twice with d/dcoeffs) and no '
                   f'forward or backward kernel ({len(odd)} did not)')
    print(f'  fit --bootstrap 4: {wall:.2f} s; second-order calls and '
          f'kernel launches by lookup {per_lookup}', flush=True)
    return launches, per_lookup


def esm_fit_check(esm_cfg, esm_bundle, tmp):
    """Phase 13g: `fit` of configs/esm_sampling_config.yaml in f64 through
    the CLI's main (starts cut to 8): the exact Hessian at the fit's optimum
    finite (so find_map's finite-difference fallback, whose condition that
    is, was not taken) and positive definite; then the 9 x 9 -Hessian of lnL
    at the ESM ref point against victor_tpu's (ESM_HESS_GOLDENS) within 1e-7
    of max|H|."""
    import numpy as np
    import torch
    from victor_tpu_torch.sampling.optimize import (_make_objectives,
                                                    value_grad_hessian)
    from victor_tpu_torch.sampling.targets import resolve_target

    path = write_yaml(esm_cfg, os.path.join(tmp, 'esm_sampling.yaml'))
    t0 = time.perf_counter()
    with Captured('find_map') as cap:
        cli_json(['fit', path, '--starts', str(ESM_FIT_STARTS)])
    wall = time.perf_counter() - t0
    res = cap.results[0]
    (fit_bundle, *_), kw = cap.calls[0]
    _, lnpost_theta, _, _ = _make_objectives(
        fit_bundle, res.space, kw.get('opts_kw'), kw.get('fit_kw'))
    H_fit = value_grad_hessian(lambda t: -lnpost_theta(t), torch.tensor(
        res.theta[None], dtype=torch.float64, device='cuda'))[2]
    exact = bool(torch.isfinite(H_fit).all())
    check(exact and np.isfinite(res.cov).all() and res.hessian_pd,
          f'ESM fit ({ESM_FIT_STARTS} starts, f64): the exact 9 x 9 Hessian '
          f'at the optimum finite ({exact}: no finite-difference fallback), '
          f'chi2 {res.chi2:.4f}, |grad| {res.grad_norm:.2e}, positive '
          'definite')
    names = list(esm_cfg['params'])
    tables, loglike = resolve_target(esm_bundle, None, None,
                                     gradient_free=False)

    def neg(th):
        return -loglike(tables, {k: th[:, i] for i, k in
                                 enumerate(names)})[0]
    ref = torch.tensor([[ESM_REF[k] for k in names]], dtype=torch.float64,
                       device='cuda')
    H = value_grad_hessian(neg, ref)[2][0].cpu().numpy()
    want = np.array(ESM_HESS_GOLDENS)
    err = float(np.abs(H - want).max() / np.abs(want).max())
    check(np.isfinite(H).all() and err <= 1e-7,
          f'ESM 9 x 9 -Hessian at the ref point: max error {err:.3e} of '
          'max|H| against jax.hessian (<= 1e-7)')
    print(f'  ESM fit: {wall:.2f} s', flush=True)
    return wall


# ---------------------------------------------------------------------------
# Phase 14: the evidence path
# ---------------------------------------------------------------------------

class LaunchLog:
    """While a CLI command runs in this process: the ppoly_eval launches of
    each call of a sampler's device function (`module.name`: smc._stage,
    nested._step) and the launches by lookup shape (`lookup_shape`) over
    the whole command."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.per_call, self.by_lookup = [], {}

    def __enter__(self):
        from victor_tpu_torch.kernels import ppoly
        from victor_tpu_torch.ops import splines
        self.cuda = splines.ppoly_eval_cuda

        def counted(*args):
            key = lookup_shape(*args)
            self.by_lookup[key] = self.by_lookup.get(key, 0) + 1
            return self.cuda(*args)

        def wrapped(*args, **kw):
            before = ppoly.LAUNCHES
            out = self.real(*args, **kw)
            self.per_call.append(ppoly.LAUNCHES - before)
            return out
        splines.ppoly_eval_cuda = counted
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        from victor_tpu_torch.ops import splines
        splines.ppoly_eval_cuda = self.cuda
        setattr(self.module, self.name, self.real)


def evidence_path(tmp):
    """The config of phase 14 (configs/boss_config.yaml with the .npz data
    and the quadrature's params block QUAD_BLOCK) written into `tmp`."""
    return write_yaml({**load_config(), 'params': QUAD_BLOCK},
                      os.path.join(tmp, 'boss_evidence.yaml'))


def smc_evals(res, n_moves):
    """The likelihood evaluations of an SMC run: the initial one of every
    particle, then one per particle and move of each stage."""
    return len(res.particles) * (1 + n_moves * (len(res.betas) - 1))


def evidence_gate(res, what, logz=QUAD_LOGZ):
    """An evidence within 3 of its reported se of the quadrature's."""
    dev = abs(res.logz - logz)
    check(math.isfinite(res.logz) and dev < 3 * res.logz_se,
          f'{what}: logZ {res.logz:.4f} +- {res.logz_se:.4f} within 3 se of '
          f'the quadrature {logz} ({dev / res.logz_se:.2f} se)')


def smc_cli(tmp):
    """Phase 14a: `run --sampler smc` with its defaults (2048 particles, 5
    moves, seed 0) on QUAD_BLOCK through the CLI, its ppoly_eval launches
    counted per stage and per lookup. Returns the run's SMCResult, its
    JSON, the LaunchLog, its launches and seconds."""
    import numpy as np
    import torch
    import victor_tpu_torch.sampling as sampling
    from victor_tpu_torch.kernels import dispersion, ppoly
    from victor_tpu_torch.sampling import smc

    root = os.path.join(tmp, 'chains', 'smc')
    ppoly.LAUNCHES = ppoly.LAUNCHES_MULTI = dispersion.LAUNCHES = 0
    t0 = time.perf_counter()
    with LaunchLog(smc, '_stage') as log, \
            Captured('run_smc', sampling) as cap:
        out = cli_json(['run', evidence_path(tmp), '--sampler', 'smc',
                        '--output', root])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (ppoly.LAUNCHES, dispersion.LAUNCHES)
    res = cap.results[0]
    stages = out['n_stages']
    evals = smc_evals(res, 5)
    print(f"  SMC (2048 particles, 5 moves, default modes): {stages} stages, "
          f"betas {np.round(res.betas, 4).tolist()}, ESS/N "
          f"{np.round(res.ess, 3).tolist()}, acceptance "
          f"{np.round(res.acceptance, 3).tolist()}; logZ {res.logz:.4f} +- "
          f"{res.logz_se:.4f} (CLT {res.logz_se_clt:.4f}); {out['elapsed_s']}"
          f' s sampling, {wall:.2f} s with the table build, {evals} '
          f"evaluations, {evals / out['elapsed_s']:.1f} evals/s", flush=True)
    print(f'  SMC ppoly_eval launches per stage {log.per_call} (and '
          f'{launches[0] - sum(log.per_call)} at the initial evaluation); by '
          f'lookup {log.by_lookup}', flush=True)
    evidence_gate(res, 'SMC')
    posterior_gates(out, 'SMC', 0.2, 0.15)
    check(math.isfinite(out['posterior_predictive_p']),
          f"SMC posterior-predictive p {out['posterior_predictive_p']}")
    check(len(log.per_call) == stages and min(log.per_call) > 0 and
          launches[1] == 0 and sum(log.by_lookup.values()) == launches[0],
          f'ppoly_eval launched on every SMC stage ({stages}): '
          f'{launches[0]} launches, all counted by lookup; dispersion_final '
          f'{launches[1]} (streaming model: 0)')
    for f in ('1.txt', 'paramnames', 'ranges', 'covmat', 'input.yaml'):
        check(os.path.isfile(f'{root}.{f}'), f'SMC wrote {root}.{f}')
    return res, out, log, launches[0], out['elapsed_s']


def smc_resume(bundle, full, tmp):
    """Phase 14b: the library run_smc with 14a's settings (the CLI's YAML
    round trip sorts the params block), stopped after stage 2 and resumed
    from its checkpoint, equals 14a's run bit for bit."""
    import numpy as np
    from victor_tpu_torch.sampling import run_smc

    ckpt = os.path.join(tmp, 'smc_resume.npz')
    block = dict(sorted(QUAD_BLOCK.items()))
    t0 = time.perf_counter()
    try:
        run_smc(bundle, block, max_stages=2, checkpoint=ckpt, device='cuda')
        raise RuntimeError('chip_smoke: run_smc with max_stages=2 finished')
    except RuntimeError as e:
        if 'did not reach beta=1' not in str(e):
            raise
    res = run_smc(bundle, block, checkpoint=ckpt, resume=True,
                  device='cuda')
    check(res.logz == full.logz and np.array_equal(res.betas, full.betas)
          and np.array_equal(res.particles, full.particles) and
          np.array_equal(res.aux, full.aux),
          f'SMC stopped after stage 2 and resumed equals the CLI run bit for '
          f'bit: logZ {res.logz!r}, {len(res.betas) - 1} stages, the 2048 '
          f'particles and aux ({time.perf_counter() - t0:.2f} s)')


def ns_cli(tmp):
    """Phase 14c: `run --sampler ns` with its defaults (1024 live points,
    256 per iteration, 24 steps, dlogz 0.01) on QUAD_BLOCK. Returns the
    NestedResult, its JSON, the LaunchLog, launches and seconds."""
    import torch
    import victor_tpu_torch.sampling as sampling
    from victor_tpu_torch.kernels import dispersion, ppoly
    from victor_tpu_torch.sampling import nested

    root = os.path.join(tmp, 'chains', 'ns')
    ppoly.LAUNCHES = ppoly.LAUNCHES_MULTI = dispersion.LAUNCHES = 0
    with LaunchLog(nested, '_step') as log, \
            Captured('run_nested', sampling) as cap:
        out = cli_json(['run', evidence_path(tmp), '--sampler', 'ns',
                        '--output', root])
    torch.cuda.synchronize()
    res = cap.results[0]
    print(f"  NS (1024 live, 256 per iteration, 24 steps): {res.n_iter} "
          f'iterations, {res.n_like} evaluations, logZ {res.logz:.4f} +- '
          f'{res.logz_se:.4f}, H {res.h:.3f} nats, ESS {res.ess:.0f}, '
          f"{out['elapsed_s']} s, {res.n_like / out['elapsed_s']:.1f} "
          f'evals/s; ppoly_eval launches per iteration {sorted(set(log.per_call))}'
          f' ({ppoly.LAUNCHES} in all), by lookup {log.by_lookup}',
          flush=True)
    evidence_gate(res, 'NS')
    posterior_gates(out, 'NS', 0.2, 0.15)
    check(len(log.per_call) == res.n_iter and min(log.per_call) > 0 and
          dispersion.LAUNCHES == 0,
          f'ppoly_eval launched on every NS iteration ({res.n_iter})')
    return res, out, log, ppoly.LAUNCHES, out['elapsed_s']


def evidence_profile(bundle, particles, card):
    """Phase 14h (information): the kernels' device time of one SMC stage
    (2048 particles, 5 moves) and of one NS iteration (256 chains of 24
    steps over 1024 live points) under torch.profiler, against wall time,
    both from the posterior particles of 14a (NAMES order)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from victor_tpu_torch.sampling import nested, smc
    from victor_tpu_torch.sampling.priors import ParamSpace
    from victor_tpu_torch.parallel.mesh import shard_map
    from victor_tpu_torch.sampling.targets import (make_unbounded_wrappers,
                                                   resolve_target)

    space = ParamSpace(QUAD_BLOCK)            # NAMES order, as `particles`
    tbl, loglike = resolve_target(bundle, None, None, gradient_free=True)
    lnprior, batched = make_unbounded_wrappers(space, loglike)
    lnlike = shard_map(batched, tbl, None, None, CHUNK)   # as the samplers
    gen = torch.Generator(device='cuda')
    gen.manual_seed(9)
    y = space.to_unbounded(torch.as_tensor(particles, device='cuda'))
    lnl, aux = lnlike(y)
    lnpri = lnprior(y)
    n = y.shape[0]
    w = torch.full((n,), 1.0 / n, dtype=y.dtype, device='cuda')
    order = torch.argsort(lnl[:1024]).cpu().numpy()
    live = [t[:1024] for t in (y, lnl, lnpri, aux)]
    ws = np.zeros(1024)
    ws[order[256:]] = 1.0 / 768
    runs = {
        'SMC stage (2048 particles, 5 moves)': lambda: smc._stage(
            lnlike, lnprior, y, lnl, lnpri, aux, w, 1.0,
            smc.draw_stage_noise(gen, n, 4, 5)),
        'NS iteration (256 chains x 24 steps)': lambda: nested._step(
            lnlike, lnprior, *live, torch.as_tensor(ws, device='cuda'),
            torch.as_tensor(order[256:][np.arange(256) % 768],
                            device='cuda'),
            torch.as_tensor(order[:256], device='cuda'),
            float(lnl[order[255]]), 1.0,
            nested.draw_step_noise(gen, 256, 4, 24))}
    for label, run in runs.items():
        # the card's activity only: a stage launches ~10^5 kernels, and the
        # host ops' records would double the profiler's post-processing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        device_us = sum(e.device_time_total for e in events
                        if e.device_type == DeviceType.CUDA)
        ppoly_us = sum(e.device_time_total for e in events
                       if e.device_type == DeviceType.CUDA and
                       'ppoly' in e.key)
        top = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.device_time_total)[:3]
        print(f'  {label} under torch.profiler on {card}: kernels '
              f'{device_us / 1e3:.2f} ms (ppoly_eval {ppoly_us / 1e3:.2f} ms)'
              f' of {1e3 * wall:.2f} ms wall ({device_us / 1e4 / wall:.1f}% '
              f'busy); top: '
              f'{[(e.key[:40], round(e.device_time_total / 1e3, 2)) for e in top]}',
              flush=True)


def evidence_child(tmp):
    """Phase 14a-e and g in a process of their own (`--evidence-child`),
    started beside phase 12d: what the parent needs of them goes to
    `tmp`/evidence.json (the kernel comparisons at their shapes and the
    profile of 14h, which time the card, run in the parent once the card
    is otherwise idle, with 14f)."""
    import numpy as np
    import torch
    from victor_tpu_torch.io.tables import build_tables

    cfg = load_config()
    bundle = build_tables(cfg['model'], cfg['data'], device='cuda',
                          dtype=torch.float64)
    print('evidence: SMC through the CLI run (14a)', flush=True)
    res, out, log, launches, smc_s = smc_cli(tmp)
    print('evidence: SMC stopped and resumed (14b)', flush=True)
    smc_resume(bundle, res, tmp)
    print('evidence: NS through the CLI run (14c)', flush=True)
    nres, _, nlog, ns_launches, ns_s = ns_cli(tmp)
    print('evidence: post of the SMC chains and reweight (14d)', flush=True)
    post_check(bundle, tmp, os.path.join(tmp, 'chains', 'smc'))
    print('evidence: tension of the data with itself (14e)', flush=True)
    tension_s = tension_check(tmp)
    print('evidence: analyze (14g)', flush=True)
    analyze_s = analyze_check(tmp)
    order = [res.space.names.index(k) for k in NAMES]
    with open(os.path.join(tmp, 'evidence.json'), 'w') as f:
        json.dump({'smc_s': smc_s, 'ns_s': ns_s, 'tension_s': tension_s,
                   'analyze_s': analyze_s, 'smc_stages': out['n_stages'],
                   'ns_iterations': nres.n_iter,
                   'smc_evals': smc_evals(res, 5),
                   'ns_evals': nres.n_like,
                   'smc_launches': launches, 'ns_launches': ns_launches,
                   'smc_by_lookup': [[list(k), v] for k, v in
                                     log.by_lookup.items()],
                   'ns_by_lookup': [[list(k), v] for k, v in
                                    nlog.by_lookup.items()],
                   'particles': np.asarray(res.particles)[:, order].tolist()},
                  f)


def particle_kernel_rows(bundle, ev, card):
    """Phase 14a's kernel comparison and 14h, in the parent on an otherwise
    idle card: ppoly_eval against its plain version on the inputs of each
    lookup of a chunk of 64 of 14a's particles (NAMES order), timed, as
    kernel rows with their lookup's launches in 14a's SMC run and 14c's NS
    run (`ns_launches`); then the profile of one SMC stage and one NS
    iteration (`evidence_profile`)."""
    import numpy as np
    import torch

    particles = np.array(ev['particles'])
    theta = torch.as_tensor(particles[:CHUNK], device='cuda')
    _, calls = sampler_kernel_case(bundle, theta,
                                   'a chunk of 64 SMC particles')

    def by_lookup(pairs):
        return {tuple(tuple(x) if isinstance(x, list) else x for x in k): v
                for k, v in pairs}
    smc_counts, ns_counts = (by_lookup(ev['smc_by_lookup']),
                             by_lookup(ev['ns_by_lookup']))
    rows = []
    for label, result in calls.items():
        key = result['lookup']
        rows.append(kernel_row(
            f'ppoly_eval, particle samplers ({label.split(": ")[1]}; '
            f'launches: this lookup in the SMC run of {ev["smc_stages"]} '
            f'stages; ns_launches: in the NS run of {ev["ns_iterations"]} '
            'iterations)', 'ppoly_eval.cu', 'victor_tpu/ops/splines.py:537',
            smc_counts.get(key, 0), result, torch.float64))
        rows[-1]['ns_launches'] = ns_counts.get(key, 0)
    check(all(r['launches'] > 0 and r['ns_launches'] > 0 for r in rows),
          f'each lookup of the chunk ({len(rows)}) was launched in the SMC '
          'and the NS run')
    evidence_profile(bundle, particles, card)
    return rows


def start_evidence_child(tmp):
    """Phase 14a-e and g in a process of their own, beside phase 12d (as
    12e): the card is ~6% busy under the host-bound HMC run."""
    log = open(os.path.join(tmp, 'evidence.log'), 'w+')
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--evidence-child', tmp],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True)
    return proc, log


def finish_evidence_child(started, timeout):
    """Wait for the phase-14 process, print what it printed, fail if it
    failed, and return what it wrote."""
    proc, log = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError('chip_smoke: the evidence phase did not finish '
                           f'within {timeout} s')
    finally:
        log.seek(0)
        print(log.read().rstrip(), flush=True)
        log.close()
    check(proc.returncode == 0,
          f'the evidence phase (its own process) exited {proc.returncode}')
    with open(os.path.join(os.path.dirname(log.name), 'evidence.json')) as f:
        return json.load(f)


def post_check(bundle, tmp, smc_root):
    """Phase 14d: `post` of 14a's chains with the gaussian form, then a
    library reweight of POST_N fixed points against victor_tpu's per-point
    deltas (POST_GOLDENS)."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.sampling import reweight

    ppoly.LAUNCHES = 0
    t0 = time.perf_counter()
    out = cli_json(['post', evidence_path(tmp), '--chains', smc_root,
                    '--set', 'data.likelihood.form=gaussian', '--output',
                    os.path.join(tmp, 'chains', 'post')])
    torch.cuda.synchronize()
    print(f"  post (2048 particles, sellentin -> gaussian): Delta lnZ "
          f"{out['delta_logz']} +- {out['delta_logz_se']}, efficiency "
          f"{out['efficiency']}, {time.perf_counter() - t0:.2f} s, "
          f'ppoly_eval launches {ppoly.LAUNCHES}', flush=True)
    check(math.isfinite(out['delta_logz']) and out['efficiency'] > 0.5 and
          ppoly.LAUNCHES > 0,
          f"post: finite Delta lnZ, efficiency {out['efficiency']} > 0.5, "
          'through the ppoly_eval kernel')
    lo = [max(QUAD_MEAN[k] - 3 * QUAD_STD[k], QUAD_BLOCK[k]['prior']['min'])
          for k in NAMES]
    hi = [min(QUAD_MEAN[k] + 3 * QUAD_STD[k], QUAD_BLOCK[k]['prior']['max'])
          for k in NAMES]
    theta = np.random.default_rng(POST_SEED).uniform(lo, hi,
                                                     (POST_N, len(NAMES)))
    res = reweight(bundle, bundle, QUAD_BLOCK, theta,
                   fit_kw_new={'form': 'gaussian'}, device='cuda')
    err = float(np.max(np.abs(res.lnl_new - res.lnl_old -
                              np.array(POST_GOLDENS))))
    check(err <= 1e-8, f'reweight of {POST_N} points: per-point deltas '
                       f'within {err:.2e} of victor_tpu (<= 1e-8)')


def tension_check(tmp):
    """Phase 14e: `tension` of the config against itself (1024 particles,
    4 moves: cut from 4096 x 8 for time)."""
    from victor_tpu_torch.sampling import smc

    path = evidence_path(tmp)
    with Captured('run_smc', smc) as cap:
        out = cli_json(['tension', path, path, '--particles', '1024',
                        '--moves', '4'])
    shift = out['parameter_shift']
    evals = sum(smc_evals(r, 4) for r in cap.results)
    print(f"  tension (1024 particles, 4 moves): ln R "
          f"{out['log_evidence_ratio']} +- {out['log_evidence_ratio_se']}, "
          f"logZ {out['log_evidence']}, shift {shift['n_sigma']} sigma, "
          f"{out['elapsed_s']} s, {[len(r.betas) - 1 for r in cap.results]} "
          f'stages, {evals} evaluations (the joint run\'s of both datasets '
          f"at once), {evals / out['elapsed_s']:.1f} evals/s", flush=True)
    check(out['verdict'] == 'concordance' and out['log_evidence_ratio'] > 0
          and shift['n_sigma'] < 1.0,
          f"tension of the data with itself: {out['verdict']}, ln R "
          f"{out['log_evidence_ratio']} > 0, shift {shift['n_sigma']} < 1 "
          'sigma')
    for what, res in zip(('a', 'b'), cap.results):
        evidence_gate(res, f'tension run {what}')
    return out['elapsed_s']


def compare_check(tmp):
    """Phase 14f: `compare` of streaming against dispersion with the fused
    final stage (1024 particles, 4 moves: cut from 4096 x 8 for time);
    dispersion_final.cu held against its plain version on the inputs of
    one of the run's launches."""
    import torch
    import victor_tpu_torch.sampling as sampling
    from victor_tpu_torch.kernels import dispersion

    captured = []
    real = dispersion.dispersion_final_cuda

    def record(*args):
        if not captured:
            captured.append(tuple(t.clone() for t in args))
        return real(*args)

    path = evidence_path(tmp)
    dispersion.LAUNCHES = 0
    dispersion.dispersion_final_cuda = record
    try:
        with Captured('run_smc', sampling) as cap:
            out = cli_json(['compare', path, path, '--set-b',
                            'model.rsd_model=dispersion', '--set-b',
                            'model.dispersion_final=fused', '--particles',
                            '1024', '--moves', '4'])
    finally:
        dispersion.dispersion_final_cuda = real
    torch.cuda.synchronize()
    launches = dispersion.LAUNCHES
    ra, rb = cap.results
    print(f"  compare (streaming vs dispersion, final 'fused'; 1024 "
          f"particles, 4 moves): Delta lnZ {out['delta_log_evidence']} +- "
          f"{out['delta_log_evidence_se']} ({out['jeffreys']}), logZ "
          f"{ra.logz:.4f} / {rb.logz:.4f}, {ra.elapsed_s:.2f} + "
          f'{rb.elapsed_s:.2f} s, '
          f'{smc_evals(ra, 4) / ra.elapsed_s:.1f} / '
          f'{smc_evals(rb, 4) / rb.elapsed_s:.1f} evals/s; dispersion_final '
          f'launches {launches}', flush=True)
    check(abs(ra.logz - rb.logz) < 3 * out['delta_log_evidence_se'],
          f"compare: |Delta lnZ| {abs(ra.logz - rb.logz):.4f} within 3 "
          f"combined se ({out['delta_log_evidence_se']})")
    check(launches > 0, f'compare launched dispersion_final: {launches}')
    result = compare_dispersion(captured[0], torch.float64, planted=False)
    return launches, result, (ra.elapsed_s, rb.elapsed_s)


def have_matplotlib():
    import importlib.util
    return importlib.util.find_spec('matplotlib') is not None


def analyze_check(tmp):
    """Phase 14g: `analyze configs/boss_sampling_config.yaml` (8 starts and
    1024 particles x 4 moves: cut from 16 and 4096 x 8 for time), with its
    figures where matplotlib is installed (Agg) and `--no-plots` where it
    is not."""
    import numpy as np
    import victor_tpu_torch.sampling as sampling
    from victor_tpu_torch.sampling.chains import read_covmat, read_getdist

    plots = have_matplotlib()
    if not plots:
        print('  analyze: the figures are not drawn on this machine: '
              'matplotlib is not installed here, so analyze runs with '
              '--no-plots', flush=True)
    path = write_yaml(load_config('boss_sampling_config.yaml'),
                      os.path.join(tmp, 'boss_sampling.yaml'))
    outdir = os.path.join(tmp, 'analysis')
    with Captured('find_map') as maps, Captured('run_smc', sampling) as smcs:
        out = cli_json(['analyze', path] + ([] if plots else ['--no-plots'])
                       + ['--starts', '8', '--particles', '1024', '--moves',
                          '4', '--output', outdir])
    mres, sres = maps.results[0], smcs.results[0]
    print(f"  analyze: MAP chi2 {mres.chi2:.8f}, logZ {sres.logz:.4f} +- "
          f"{sres.logz_se:.4f}, times {out['elapsed_s']}, SMC "
          f'{smc_evals(sres, 4) / sres.elapsed_s:.1f} evals/s', flush=True)
    check(abs(mres.chi2 - FIT_GOLDENS['chi2']) <= 1e-6,
          f"analyze: MAP chi2 {mres.chi2:.8f} within 1e-6 of victor_tpu's "
          f"{FIT_GOLDENS['chi2']:.8f}")
    evidence_gate(sres, 'analyze')
    files = ('report.md', 'input.yaml', 'chains.1.txt', 'chains.paramnames',
             'chains.ranges', 'chains.covmat')
    check(all(os.path.isfile(os.path.join(outdir, f)) for f in files),
          f'analyze wrote {files}')
    names, w, _, samples = read_getdist(os.path.join(outdir, 'chains'))
    cov = read_covmat(os.path.join(outdir, 'chains.covmat'), names[:4])
    check(samples.shape == (1024, 5) and np.isfinite(samples).all() and
          np.isfinite(cov).all(),
          f'analyze chains read back: {samples.shape}, covmat {cov.shape}')
    with open(os.path.join(outdir, 'report.md')) as f:
        report = f.read()
    sections = [ln for ln in report.splitlines() if ln.startswith('##')]
    check(sections == ['## Best fit', '## Goodness of fit', sections[2]]
          + (['## Figures'] if plots else []) + ['## Notes'] and
          sections[2].startswith('## Posterior (tempered SMC'),
          f'analyze report sections {sections}')
    figures = ('corner.png', 'multipoles.png') if plots else ()
    check(out['figures'] == [os.path.join(outdir, f) for f in figures],
          f"analyze lists its figures: {out['figures']}")
    for name in figures:
        with open(os.path.join(outdir, name), 'rb') as f:
            head = f.read(8)
        size = os.path.getsize(os.path.join(outdir, name))
        check(head == b'\x89PNG\r\n\x1a\n' and size > 0 and
              f']({name})' in report,
              f'analyze drew {name} ({size} bytes, a PNG) and the report '
              'shows it')
    return out['elapsed_s']


# ---------------------------------------------------------------------------
# Phase 15: the class surface
# ---------------------------------------------------------------------------

def golden_check(what, got, key, rtol=1e-9, scale=None):
    """`got` against API_GOLDENS[key] within rtol of the golden's largest
    |value| (or of `scale`)."""
    import numpy as np
    want = np.asarray(API_GOLDENS[key], dtype=float)
    got = np.asarray(got, dtype=float)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float('inf')
    check(err <= rtol * scale,
          f"{what}: max |card - victor_tpu's| {err:.3e} <= {rtol:g} x "
          f'{scale:.3e}')


class CountedCalls:
    """Each class call's ppoly_eval launches: `call(label, fn, expected)`
    runs fn and checks that the launch count rose by `expected`."""

    def __init__(self):
        from victor_tpu_torch.kernels import ppoly
        self.ppoly, self.log = ppoly, []

    def call(self, label, fn, expected):
        before = self.ppoly.LAUNCHES
        out = fn()
        launched = self.ppoly.LAUNCHES - before
        self.log.append((label, launched))
        check(launched == expected,
              f'{label}: {launched} ppoly_eval launches ({expected})')
        return out


def cobaya_stand_in():
    """A minimal cobaya-3.5 `cobaya.likelihood.Likelihood` (the base-class
    default get_requirements) installed in sys.modules, so that the adapter
    runs where cobaya is not installed. Returns the names installed."""
    import types
    cobaya = types.ModuleType('cobaya')
    cobaya.__version__ = '3.5'
    lik = types.ModuleType('cobaya.likelihood')

    class Likelihood:
        def get_requirements(self):
            return {}

    lik.Likelihood = Likelihood
    cobaya.likelihood = lik
    sys.modules.update({'cobaya': cobaya, 'cobaya.likelihood': lik})
    return ('cobaya', 'cobaya.likelihood')


def adapter_checks(fit, esm_fit, cfg, esm_cfg, counted):
    """Phase 15c: the cobaya adapter through the stand-in, on the BOSS and
    the ESM config, adopting the bundles built already (CCFFit is swapped
    for a subclass that takes them while initialize() runs)."""
    import importlib

    from victor_tpu_torch import api

    installed = cobaya_stand_in()
    real = api.CCFFit
    bundles = {id(cfg['model']): fit.bundle, id(esm_cfg['model']):
               esm_fit.bundle}

    class Adopting(real):
        def __init__(self, model, data, **kw):
            super().__init__(model, data, _bundle=bundles[id(model)], **kw)

    try:
        mod = importlib.reload(importlib.import_module(
            'victor_tpu_torch.likelihoods.CCFLikelihood'))
        check(mod._HAVE_COBAYA, 'the adapter bound the cobaya stand-in')
        out = {}
        api.CCFFit = Adopting
        try:
            for key, c in (('boss', cfg), ('esm', esm_cfg)):
                obj = mod.CCFLikelihood()
                obj.model, obj.data, obj.config_file = c['model'], c['data'], \
                    None
                obj.initialize()
                out[key] = obj
        finally:
            api.CCFFit = real
        boss, esm = out['boss'], out['esm']
        check(boss.device == 'cuda' and
              boss.ccf_fit.device.type == esm.ccf_fit.device.type == 'cuda',
              "the adapter's default device: cuda")
        check(boss.get_requirements() == {} and
              boss.get_can_provide_params() == ['chi2_ccf_correct'] and
              esm.get_can_provide_params() == ['chi2_ccf_correct',
                                               'fsigma8'],
              'adapter: no requirements; provides chi2_ccf_correct, and '
              'fsigma8 for the excursion-set config only')
        golden = dict(zip(NAMES, GOLDEN))
        state = {}
        counted.call('adapter calculate (BOSS)',
                     lambda: boss.calculate(state, want_derived=True,
                                            **golden), 3)
        lnl, chi2 = fit.log_likelihood(golden)
        check(state['logp'] == lnl and
              state['derived'] == {'chi2_ccf_correct': chi2},
              f"adapter logp {state['logp']:.10f} and derived chi2 equal "
              "CCFFit's")
        state = {}
        esm.calculate(state, want_derived=True, **ESM_REF)
        lnl, chi2 = esm_fit.log_likelihood(ESM_REF)
        check(state['logp'] == lnl and
              state['derived']['chi2_ccf_correct'] == chi2,
              f"adapter (ESM) logp {lnl:.10f} and chi2 equal CCFFit's")
        golden_check('CCFFit (ESM) (lnL, chi2) at ESM_REF', [lnl, chi2],
                     'esm_loglike')
        golden_check('adapter (ESM) derived fsigma8',
                     state['derived']['fsigma8'], 'esm_fsigma8')
        lean = {}
        esm.calculate(lean, want_derived=False, **ESM_REF)
        check(set(lean['derived']) == {'chi2_ccf_correct'},
              'adapter (ESM): no fsigma8 unless derived values are wanted')
    finally:
        for name in installed:
            sys.modules.pop(name, None)
        importlib.reload(importlib.import_module(
            'victor_tpu_torch.likelihoods.CCFLikelihood'))


# ---------------------------------------------------------------------------
# Phase 16: the scale-out layer
# ---------------------------------------------------------------------------

def cli_cards():
    """`--cli-cards`: the CLI's `run --sampler smc` (its defaults) and
    `--sampler hmc` (30 warmup and 30 samples) with one card visible and
    with every card, in subprocesses. Each run's JSON must be the same
    either way but for its seconds; returns False otherwise."""
    import torch
    stem = 'data/BOSS_DR12_CMASS_npz/CMASS_zobovVoids_reconRs10_0.43z0.7_' \
        'medianRvcut'
    every = ','.join(str(i) for i in range(torch.cuda.device_count()))
    ok = True
    for sampler, extra in (('smc', []),
                           ('hmc', ['--warmup', '30', '--samples', '30'])):
        outs = {}
        for visible in ('0', every):
            argv = [sys.executable, '-m', 'victor_tpu_torch', 'run',
                    'configs/boss_sampling_config.yaml', '--sampler', sampler,
                    '--set', 'model.input_model_data_file='
                             f'{stem}_PatchyMean_model.npz',
                    '--set', f'data.redshift_space_ccf.data_file={stem}'
                             '_data.npz',
                    '--set', 'data.covariance_matrix.data_file='
                             f'{stem}_variable_D_covariance.npz'] + extra
            proc = subprocess.run(
                argv, cwd=REPO, capture_output=True, text=True, timeout=600,
                env={**os.environ, 'CUDA_VISIBLE_DEVICES': visible})
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr[-4000:], flush=True)
                ok = False
                continue
            out = json.loads(proc.stdout)
            outs[visible] = out
            print(f'cli-cards: run --sampler {sampler}, cards {visible}: '
                  f"{out['elapsed_s']} s", flush=True)
        if len(outs) == 2:
            same = [{k: v for k, v in o.items() if k != 'elapsed_s'}
                    for o in outs.values()]
            agree = same[0] == same[1]
            print(f'cli-cards: {sampler} prints the same on one card and on '
                  f'{every}: {agree}; one card / every card '
                  f"{outs['0']['elapsed_s'] / outs[every]['elapsed_s']:.4f}",
                  flush=True)
            ok = ok and agree
    return ok


def start_probe(tmp):
    """Phase 16c in processes of their own, started beside phase 12d as
    phase 14 is: `python -m victor_tpu_torch.parallel.probe --device cuda
    --backend gloo`, two processes on cuda:0 (NCCL refuses two ranks on one
    card)."""
    log = open(os.path.join(tmp, 'probe.log'), 'w+')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'victor_tpu_torch.parallel.probe', '--device',
         'cuda', '--backend', 'gloo', '--timeout', '300'],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True)
    return proc, log


def finish_probe(started, timeout):
    """Phase 16c: wait for the probe, print what it printed, and check its
    summary: ok, two processes on the card through gloo, 3 ppoly_eval
    launches in each process's sharded call. Returns the summary."""
    proc, log = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError('chip_smoke: the two-process probe did not '
                           f'finish within {timeout} s')
    finally:
        log.seek(0)
        text = log.read().rstrip()
        log.close()
        print(text, flush=True)
    check(proc.returncode == 0,
          f'the two-process probe exited {proc.returncode}')
    summary = json.loads(text.splitlines()[-1])
    check(summary['ok'] and summary['n_processes'] == 2 and
          (summary['device'], summary['backend']) == ('cuda', 'gloo'),
          'two processes on cuda:0 through gloo: each shard of the BOSS batch '
          'within 1e-12 of its unsharded values, gathered, and the '
          'cross-process R-hat within 1e-12 of the single-process one')
    check(summary['ppoly_eval_launches'] == 2 * 3,
          f"the probe's ppoly_eval launches: {summary['ppoly_eval_launches']}"
          ' (3 per process)')
    return summary


def accepted(chain):
    """(S - 1, C) whether each chain moved at each recorded step."""
    import numpy as np
    return np.any(np.diff(chain, axis=0) != 0, axis=-1)


def rel_err(got, want):
    return max(float(((g - w) / w).abs().max()) for g, w in zip(got, want))


def scale_out(bundle, card, probe_summary):
    """Phase 16: the scale-out layer at full BOSS width, f64, exact modes
    (a, b, d, e; c is `finish_probe`'s `probe_summary`). Returns the
    kernels line's row of the sharded call, whose launches are those of
    16b."""
    import tempfile

    import numpy as np
    import torch
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.likelihood.batched import (make_batched_loglike,
                                                     make_sharded_loglike)
    from victor_tpu_torch.parallel import make_mesh
    from victor_tpu_torch.sampling import run_hmc_mcmc, run_smc
    from victor_tpu_torch.utils.profiling import throughput, trace

    t16 = time.perf_counter()
    theta = draw_theta(SCALE_N, 16, 'cuda')
    want = make_batched_loglike(bundle, NAMES, opts_kw=EXACT)(theta)
    meshes = {'a': make_mesh(('walkers',)),
              'b': make_mesh(('walkers',), devices=['cuda:0', 'cuda:0'])}
    sharded = {}
    for step, mesh in meshes.items():
        fn = make_sharded_loglike(bundle, NAMES, mesh, opts_kw=EXACT)
        ppoly.LAUNCHES = 0
        got = fn(theta)
        torch.cuda.synchronize()
        launches = ppoly.LAUNCHES
        err = rel_err(got, want)
        check(err <= SCALE_TOL and got[0].device == theta.device,
              f'16{step}: make_sharded_loglike over {mesh.size} shard(s) of '
              f'{SCALE_N} points: max relative |d lnL|, |d chi2| against '
              f'make_batched_loglike {err:.3e} (<= {SCALE_TOL:g}), gathered '
              'on cuda:0')
        check(launches == 3 * mesh.size,
              f'16{step}: ppoly_eval launches {launches} (3 per chunk per '
              f'shard: 1 chunk x {mesh.size} shard(s))')
        sharded[step] = (fn, launches)
    fn2, launches_b = sharded['b']
    scale_result, _ = sampler_kernel_case(
        bundle, theta, what=f'the 2-way sharded call of {SCALE_N} points',
        run=lambda: fn2(theta))

    mesh2 = meshes['b']
    chains, warmup, draws = SCALE_MH
    kw = dict(n_chains=chains, n_warmup=warmup, n_samples=draws, seed=3,
              algorithm='mh', segment_steps=warmup + draws, device='cuda')
    mh = [run_hmc_mcmc(bundle, QUAD_BLOCK, mesh=m, **kw)
          for m in (None, make_mesh(('chains',), devices=['cuda:0'] * 2))]
    err = float(np.max(np.abs(mh[1].chain / mh[0].chain - 1)))
    check(np.array_equal(accepted(mh[1].chain), accepted(mh[0].chain))
          and err <= SCALE_RUN_TOL,
          f'16d: MH ({chains} chains, {warmup} + {draws} steps) on a 2-way '
          f'mesh: the same accept decisions '
          f'({int(accepted(mh[0].chain).sum())} moves), chains within '
          f'{err:.3e} relative (<= {SCALE_RUN_TOL:g})')
    n_part, moves = SCALE_SMC
    smc = [run_smc(bundle, QUAD_BLOCK, n_particles=n_part, n_moves=moves,
                   seed=1, device='cuda', mesh=m)
           for m in (None, make_mesh(('particles',),
                                     devices=['cuda:0'] * 2))]
    dz = abs(smc[1].logz - smc[0].logz)
    check(len(smc[1].betas) == len(smc[0].betas) and
          dz <= SCALE_RUN_TOL * abs(smc[0].logz),
          f'16d: SMC ({n_part} x {moves}) on a 2-way mesh: '
          f'{len(smc[0].betas) - 1} stages as without, logZ '
          f'{smc[1].logz:.6f} against {smc[0].logz:.6f} (|d| {dz:.3e})')

    with tempfile.TemporaryDirectory() as tdir:
        with trace(tdir) as prof:
            fn2(theta)
            torch.cuda.synchronize()
        names = [f for f in os.listdir(tdir) if f.endswith('.json')]
        with open(os.path.join(tdir, names[0])) as f:
            text = f.read()
    kernel_us = sum(e.device_time_total for e in prof.key_averages()
                    if 'ppoly' in e.key)
    check('ppoly_tiles' in text and kernel_us > 0,
          f'16e: profiling.trace of one 2-way sharded call names the '
          f'ppoly_eval kernel (ppoly_tiles), {kernel_us / 1e3:.4f} ms of it '
          f'on the card')
    timed_theta = draw_theta(SCALE_TIMED_N, 0, 'cuda')
    batched = make_batched_loglike(bundle, NAMES, opts_kw=EXACT, chunk=CHUNK)
    paths = {'batched': batched,
             'sharded over 2 shards of cuda:0': make_sharded_loglike(
                 bundle, NAMES, mesh2, opts_kw=EXACT, chunk=CHUNK),
             f"sharded over every card ({meshes['a'].size})":
                 make_sharded_loglike(bundle, NAMES, meshes['a'],
                                      opts_kw=EXACT, chunk=CHUNK)}
    rates = {label: [] for label in paths}
    for label in list(paths) + list(paths)[::-1]:       # in turns
        rates[label].append(SCALE_TIMED_N * throughput(
            paths[label], timed_theta, reps=2)[1])
    print(f'  16e (for information, {card}): {SCALE_TIMED_N} points, chunk '
          f'{CHUNK}, exact modes, evals/s: ' + '; '.join(
              f"{label} {np.mean(r):.1f} ({', '.join(f'{x:.1f}' for x in r)})"
              for label, r in rates.items())
          + f"; the probe {probe_summary['seconds']} s (its own clock), "
          f"ppoly_eval launches 16a {sharded['a'][1]}, 16b {launches_b}, "
          f"probe {probe_summary['ppoly_eval_launches']}", flush=True)
    if meshes['a'].size > 1:
        # the default (fast) modes are device-bound, the exact ones
        # host-bound: only the former can gain from more cards
        paths = {'batched': make_batched_loglike(bundle, NAMES, chunk=CHUNK),
                 'every card': make_sharded_loglike(bundle, NAMES,
                                                    meshes['a'], chunk=CHUNK)}
        rates = {label: [] for label in paths}
        for label in list(paths) + list(paths)[::-1]:
            rates[label].append(SCALE_TIMED_N * throughput(
                paths[label], timed_theta, reps=1)[1])
        print(f'  16e (for information, {card}): default modes, '
              f"{meshes['a'].size} cards, evals/s: " + '; '.join(
                  f"{label} {np.mean(r):.1f} "
                  f"({', '.join(f'{x:.1f}' for x in r)})"
                  for label, r in rates.items()), flush=True)
    print(f'  phase 16: {time.perf_counter() - t16:.2f} s in this process',
          flush=True)
    return kernel_row(f'ppoly_eval, sharded BOSS likelihood (16b: '
                      f'{SCALE_N} points over a 2-way mesh of cuda:0, exact '
                      f'modes; launches: 3 per shard)', 'ppoly_eval.cu',
                      'victor_tpu/ops/splines.py:537', launches_b,
                      scale_result, torch.float64)


def class_surface(bundle, cfg, esm_bundle, esm_cfg):
    """Phase 15: the class surface on the card, adopting the bundles built
    already. Returns the kernels line's class-surface rows."""
    import numpy as np
    import torch
    from victor_tpu_torch import (BackgroundCosmology, CCFFit,
                                  ExcursionSetProfile)
    from victor_tpu_torch.kernels import dispersion, ppoly
    from victor_tpu_torch.kernels.ppoly import (ppoly_eval_cuda,
                                                ppoly_eval_plain)
    from victor_tpu_torch.likelihood.batched import make_batched_loglike
    from victor_tpu_torch.ops import splines

    t0 = time.perf_counter()
    golden, displaced = (dict(zip(NAMES, p)) for p in (GOLDEN, DISPLACED))
    fit = CCFFit(cfg['model'], cfg['data'], _bundle=bundle)
    esm_fit = CCFFit(esm_cfg['model'], esm_cfg['data'], _bundle=esm_bundle)
    check(fit.device.type == 'cuda' and fit.dtype == torch.float64,
          f'CCFFit adopted the BOSS bundle on {fit.device}, {fit.dtype}')
    counted = CountedCalls()
    ppoly.LAUNCHES = dispersion.LAUNCHES = 0

    # a. CCFFit on the BOSS config, f64: every theory call 3 lookups
    print('class surface: CCFFit (15a)', flush=True)
    for key, p in (('golden', golden), ('displaced', displaced)):
        lnl, chi2 = counted.call(f'log_likelihood ({key})',
                                 lambda: fit.log_likelihood(p), 3)
        want = API_GOLDENS[f'loglike_{key}']
        check(abs(lnl - want[0]) <= 1e-8 and abs(chi2 - want[1]) <= 1e-8,
              f'CCFFit.log_likelihood ({key}): chi2 {chi2:.8f}, lnL '
              f"{lnl:.8f} within 1e-8 of victor_tpu's")
    chi2, cov = counted.call('chi_squared', lambda: fit.chi_squared(golden),
                             3)
    check(abs(chi2 - API_GOLDENS['loglike_golden'][1]) <= 1e-8,
          f'CCFFit.chi_squared: chi2 {chi2:.8f}')
    golden_check('chi_squared covariance (60 x 60): diagonal', np.diag(cov),
                 'cov_diag', 1e-12)
    golden_check('chi_squared covariance: row sums', cov.sum(1),
                 'cov_rowsum', 1e-12)
    m = counted.call('theory_multipoles (0, 2)', lambda: fit.theory_multipoles(
        fit.s, golden, poles=(0, 2)), 3)
    golden_check('theory_multipoles (0, 2) on the data bins',
                 [m['0'], m['2']], 'mult')
    odd = counted.call('theory_multipoles (1, 3)', lambda: fit.theory_multipoles(
        fit.s, golden, poles=(1, 3)), 3)
    scale = float(np.abs(API_GOLDENS['mult']).max())
    worst = max(float(np.abs(odd[k]).max()) for k in ('1', '3'))
    check(worst <= 1e-9 * scale,
          f'theory_multipoles (1, 3): max |odd pole| {worst:.3e} <= 1e-9 x '
          f'{scale:.3e} (mu-even xi over mu in [-1, 1])')
    xi = counted.call('theory_xi (scalar)', lambda: fit.theory_xi(
        API_XI_POINT[0], API_XI_POINT[1], golden), 3)
    check(isinstance(xi, float), 'theory_xi of two scalars is a float')
    golden_check('theory_xi (scalar)', xi, 'xi_point')
    grid = counted.call('theory_xi (3, 5)', lambda: fit.theory_xi(
        np.array(API_S)[:, None], np.array(API_MU)[None, :], golden), 3)
    golden_check('theory_xi at (3, 1) x (1, 5)', grid, 'xi_grid')
    sperp, spar = np.linspace(0.01, 85), np.linspace(-85, 85)
    for key in ('theory_xi_2D', 'xi_2D_from_multipoles'):
        f2 = counted.call(key, lambda: getattr(fit, key)(golden), 3)
        golden_check(f'{key}: node values', [
            float(f2(sperp[i], spar[j])[0, 0]) for i, j in API_NODES], key)
    golden_check('get_interpolated_real_multipoles',
                 fit.get_interpolated_real_multipoles(API_BETA), 'real_mult')
    golden_check('get_interpolated_redshift_multipoles',
                 fit.get_interpolated_redshift_multipoles(API_BETA).ravel(),
                 'datavector')
    golden_check('multipole_datavector', fit.multipole_datavector(API_BETA),
                 'datavector')
    golden_check('correlation_matrix: row sums',
                 fit.correlation_matrix(API_BETA).sum(1), 'corr_rowsum')
    golden_check('diagonal_errors squared',
                 fit.diagonal_errors(API_BETA).ravel() ** 2, 'cov_diag',
                 1e-12)
    golden_check('delta_profiles', fit.delta_profiles(API_R, golden),
                 'delta')
    golden_check('velocity_terms', fit.velocity_terms(API_R, golden),
                 'velocity')

    # b. the dispersion model, fused final stage, as keyword overrides
    print("class surface: dispersion, final 'fused' (15b)", flush=True)
    fused = {**DISP_EXACT, 'dispersion_final': 'fused'}
    lnl_b, chi_b = make_batched_loglike(bundle, NAMES, opts_kw=fused,
                                        chunk=CHUNK)([GOLDEN, DISPLACED])
    captured = []
    real = dispersion.dispersion_final_cuda

    def record(*args):
        if not captured:
            captured.append(tuple(t.clone() for t in args))
        return real(*args)

    ppoly_before = ppoly.LAUNCHES
    dispersion.LAUNCHES = 0
    dispersion.dispersion_final_cuda = record
    try:
        for i, p in enumerate((golden, displaced)):
            lnl, chi2 = fit.log_likelihood(p, **fused)
            want_l, want_c = float(lnl_b[i]), float(chi_b[i])
            err = max(abs(lnl - want_l) / abs(want_l),
                      abs(chi2 - want_c) / abs(want_c))
            check(err <= 1e-9,
                  f"CCFFit.log_likelihood (dispersion, 'fused') at "
                  f'{GOLDEN if i == 0 else DISPLACED}: chi2 {chi2:.10f}, '
                  f'lnL {lnl:.10f}; relative to the batched path {err:.2e}')
    finally:
        dispersion.dispersion_final_cuda = real
    disp_launches = dispersion.LAUNCHES
    check(disp_launches == 2, f'dispersion_final launches in the two class '
          f'calls: {disp_launches} (2)')
    print(f'  the two dispersion calls: ppoly_eval '
          f'{ppoly.LAUNCHES - ppoly_before} launches', flush=True)
    disp_result = compare_dispersion(captured[0], torch.float64,
                                     planted=False)

    # c. the cobaya adapter
    print('class surface: the cobaya adapter through a stand-in (15c)',
          flush=True)
    adapter_checks(fit, esm_fit, cfg, esm_cfg, counted)
    launches = ppoly.LAUNCHES
    print(f'  ppoly_eval launches of 15a-c: {launches} ('
          + ', '.join(f'{label} {n}' for label, n in counted.log) + ')',
          flush=True)

    # d. ExcursionSetProfile on the card
    print('class surface: ExcursionSetProfile (15d)', flush=True)
    esp = ExcursionSetProfile(**ESP_ARGS)
    check(esp.device.type == 'cuda', f'ExcursionSetProfile on {esp.device}')
    golden_check('ExcursionSetProfile fiducial sigma8 (z = 0, z)',
                 [esp.s80_fiducial, esp.s8z_fiducial], 'esp_fiducial')
    golden_check('ExcursionSetProfile.power',
                 esp.power(np.array(API_K), ESP_PROFILE[0]), 'esp_power')
    lagrange = np.linspace(1.0, 120.0, 60)
    golden_check('model_enclosed_density_profile',
                 esp.model_enclosed_density_profile(lagrange, *ESP_PROFILE)(
                     np.array(API_R)), 'esp_enclosed')
    golden_check('model_density_profile', esp.model_density_profile(
        lagrange, *ESP_PROFILE)(np.array(API_R)), 'esp_local')
    evolution = []
    for s8, z in ESP_NORMS:
        esp.set_normalisation(s8, z)
        evolution += [esp.density_evolution(*ESP_PROFILE, pairwise=pw)(
            np.array(API_R)) for pw in (False, True)]
    golden_check('density_evolution after set_normalisation(0.81) and '
                 '(0.6, z=0.57), pairwise both ways', evolution,
                 'esp_evolution')

    # e. BackgroundCosmology on card tensors
    print('class surface: BackgroundCosmology on card tensors (15e)',
          flush=True)
    cosmo = BackgroundCosmology({'Omega_m': 0.31})
    zt = torch.tensor(COSMO_Z, dtype=torch.float64, device='cuda',
                      requires_grad=True)
    on_card = [cosmo.growth_factor(zt), cosmo.sigma8z(zt), cosmo.fsigma8(zt)]
    host = [cosmo.growth_factor(COSMO_Z), cosmo.sigma8z(COSMO_Z),
            cosmo.fsigma8(COSMO_Z)]
    check(all(isinstance(v, torch.Tensor) and v.is_cuda for v in on_card),
          'growth_factor, sigma8z, fsigma8 of a card tensor stay on the card')
    err = max(abs(v.detach().item() - h) / abs(h)
              for v, h in zip(on_card, host))
    check(err <= 1e-12, f'card tensors against host floats: {err:.2e} '
          '(<= 1e-12 relative)')
    on_card[0].backward()
    golden_check('growth_factor, sigma8z, fsigma8 and d growth / dz by '
                 "autograd on the card (victor_tpu's jax.grad)",
                 host + [float(zt.grad)], 'cosmo')

    # f. (information) one B = 1 lookup device-only, the class calls' wall
    print('class surface: timing (15f, information)', flush=True)
    calls = []

    def rec(*args):
        calls.append(args)
        return ppoly_eval_cuda(*args)

    splines.ppoly_eval_cuda = rec
    try:
        fit.log_likelihood(golden)
    finally:
        splines.ppoly_eval_cuda = ppoly_eval_cuda
    x, coeffs, q, clamp = max(calls, key=lambda c: c[2].numel())
    out_k = ppoly_eval_cuda(x, coeffs, q, clamp)
    out_p = ppoly_eval_plain(x, coeffs, q, clamp)
    torch.cuda.synchronize()
    label = (f'ppoly_eval, class surface: coeffs={tuple(coeffs.shape)} '
             f'q={tuple(q.shape)} clamp={clamp}')
    err = compare_outputs(label, out_k, out_p, q.dtype)
    K = coeffs.shape[1] if coeffs.ndim == 4 else 1
    result = timed(label, err, lambda: ppoly_eval_cuda(x, coeffs, q, clamp),
                   lambda: ppoly_eval_plain(x, coeffs, q, clamp),
                   nbytes(x, coeffs, q, out_k),
                   q.numel() * ppoly_ops(x.shape[0], K))

    def wall_ms(fn, reps=20):
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps
    result['loglike_wall_ms'] = wall_ms(lambda: fit.log_likelihood(golden))
    result['multipoles_wall_ms'] = wall_ms(
        lambda: fit.theory_multipoles(fit.s, golden))
    bound_ms, _ = bound(result['bytes'], result['ops'], torch.float64)
    print(f"  class surface (B = 1): the largest lookup {result['ms']:.4f} "
          f'ms device only against its bound {bound_ms:.4f} ms '
          f"({100 * bound_ms / result['ms']:.1f}%), host "
          f"{result['host_us']:.1f} us per call; CCFFit.log_likelihood "
          f"{result['loglike_wall_ms']:.2f} ms, theory_multipoles "
          f"{result['multipoles_wall_ms']:.2f} ms wall per call", flush=True)
    print(f'  phase 15: {time.perf_counter() - t0:.2f} s', flush=True)
    f64 = torch.float64
    row = kernel_row(
        'ppoly_eval, class surface, B = 1 (the largest lookup of one '
        'CCFFit.log_likelihood; launches: all class calls of 15a-c)',
        'ppoly_eval.cu', 'victor_tpu/ops/splines.py:537', launches, result,
        f64)
    row.update(loglike_wall_ms=result['loglike_wall_ms'],
               multipoles_wall_ms=result['multipoles_wall_ms'])
    return [row, kernel_row(
        "dispersion_final, class surface, B = 1 (CCFFit.log_likelihood, "
        "final 'fused')", 'dispersion_final.cu',
        'victor_tpu/ops/dispersion_pallas.py:32', disp_launches, disp_result,
        f64)]


def kernel_row(name, source, replaces, launches, result, dtype,
               calls=None):
    """One entry of the kernels summary line from a comparison's `timed`
    result (device-only ms, host us per call; the sampler's row also its L2
    warm reading, its `ms` being the cold one; a second-order row also its
    L2 cold reading, the composed path's readings, its launches per call
    and its `calls`, `ms` being one call), and bound_ms / ms as
    `bound_share`. No
    single PyTorch call computes either kernel's function, so library_ms is
    null."""
    bound_ms, bound_by = bound(result['bytes'], result['ops'], dtype)
    row = {'name': name, 'route': 'cuda',
           'source': f'victor_tpu_torch/kernels/csrc/{source}',
           'replaces': replaces, 'launches': launches,
           'max_abs_err': result['max_abs_err'], 'ms': result['ms'],
           'plain_ms': result['plain_ms'], 'bound_ms': bound_ms,
           'bound_by': bound_by, 'library_ms': None,
           'host_us': result['host_us'],
           'bound_share': bound_ms / result['ms']}
    if 'warm_ms' in result:
        row.update(cold_ms=result['ms'], warm_ms=result['warm_ms'])
    row.update({k: result[k] for k in ('cold_ms', 'composed_ms',
                                       'composed_cold_ms', 'composed_host_us',
                                       'launches_per_call') if k in result})
    if calls is not None:
        row['calls'] = calls
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', metavar='PATH',
                        help='write a torch.profiler summary of one batch of '
                             'each timed configuration and of 20 MH steps '
                             'to PATH')
    parser.add_argument('--nuts-child', metavar='DIR',
                        help='run phase 12e (NUTS through the CLI) alone, '
                             'writing into DIR; the full run starts this '
                             'itself beside phase 12d')
    parser.add_argument('--evidence-child', metavar='DIR',
                        help='run phases 14a-e and g (SMC, NS, post, '
                             'tension, analyze) alone, writing into DIR; the '
                             'full run starts this itself beside phase 12d')
    parser.add_argument('--class-surface', action='store_true',
                        help='build the kernels and run phase 15 (the class '
                             'surface) alone, printing its kernel rows')
    parser.add_argument('--scale-out', action='store_true',
                        help='build the kernels and run phase 16 (the '
                             'scale-out layer) alone, printing its kernel '
                             'row')
    parser.add_argument('--cli-cards', action='store_true',
                        help='build the kernels and time the CLI\'s run '
                             '--sampler smc and hmc on one card and on '
                             'every card (for several cards)')
    args = parser.parse_args()
    t_start = time.perf_counter()

    import dataclasses

    import numpy as np
    import torch

    # ---- 1. environment ----
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}', flush=True)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 1
    card = card_line()
    print(f'card: {card}', flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, REPO)
    from victor_tpu_torch.io.tables import build_tables
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.likelihood.batched import make_batched_loglike

    if args.nuts_child:
        nuts_cli(load_config(), args.nuts_child)
        return 0
    if args.evidence_child:
        evidence_child(args.evidence_child)
        return 0
    if args.class_surface:
        build_kernels()
        cfg, esm_cfg = load_config(), load_config('esm_sampling_config.yaml')
        rows = class_surface(
            build_tables(cfg['model'], cfg['data'], device='cuda'), cfg,
            build_tables(esm_cfg['model'], esm_cfg['data'], device='cuda'),
            esm_cfg)
        print(json.dumps({'kernels': rows}), flush=True)
        return 0
    if args.cli_cards:
        build_kernels()
        return 0 if cli_cards() else 1
    if args.scale_out:
        import tempfile
        build_kernels()
        cfg = load_config()
        with tempfile.TemporaryDirectory() as tmp:
            print('scale-out (16c): the two-process probe', flush=True)
            probe_summary = finish_probe(start_probe(tmp), timeout=300)
        row = scale_out(build_tables(cfg['model'], cfg['data'],
                                     device='cuda'), card, probe_summary)
        print(json.dumps({'kernels': [row]}), flush=True)
        return 0

    # ---- 2. build the kernels ----
    build_kernels()

    # ---- 3. ppoly_eval kernel vs plain at the main path's shapes ----
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    results = ppoly_phase(gen)

    # ---- 4. dispersion_final kernel vs plain at the path's shape ----
    cfg = load_config()
    t0 = time.perf_counter()
    bundle = build_tables(cfg['model'], cfg['data'], device='cuda',
                          dtype=torch.float64)
    print(f'build_tables: {time.perf_counter() - t0:.2f} s', flush=True)
    print('compare dispersion_final kernel vs plain:', flush=True)
    inputs = dispersion_final_inputs(bundle)
    disp_results = {str(dtype)[6:]: compare_dispersion(inputs, dtype)
                    for dtype in (torch.float64, torch.float32)}
    del inputs

    # ---- 5. the streaming main path, f64 ----
    loglike = make_batched_loglike(bundle, NAMES, opts_kw=EXACT, chunk=CHUNK)
    ref = np.load(os.path.join(REPO, 'tests', 'fixtures', 'reference_boss.npz'))
    grid = ref['grid_params']

    ppoly.LAUNCHES = 0
    lnl_g, chi_g = loglike([GOLDEN])
    lnl, chi = loglike(grid)
    torch.cuda.synchronize()
    launches = ppoly.LAUNCHES
    chunks = 1 + -(-len(grid) // CHUNK)
    print('main path:', flush=True)
    check(lnl_g.shape == (1,) and lnl.shape == chi.shape == (len(grid),),
          'output shapes')
    check(bool(torch.isfinite(lnl).all() and torch.isfinite(chi).all()),
          'finite outputs')
    chi2_0, lnl_0 = float(chi_g[0]), float(lnl_g[0])
    check(abs(chi2_0 - GOLDEN_CHI2) < 0.01 and abs(lnl_0 - GOLDEN_LNL) < 0.01,
          f'golden point chi2 {chi2_0:.6f} (65.01), lnL {lnl_0:.6f} (284.76)')
    d_chi = float(np.abs(chi.cpu().numpy() - ref['grid_chi2']).max())
    d_lnl = float(np.abs(lnl.cpu().numpy() - ref['grid_lnl']).max())
    check(d_chi < 1e-8 and d_lnl < 1e-8,
          f'50 reference grid points: max |d chi2| {d_chi:.3e}, '
          f'max |d lnL| {d_lnl:.3e} (< 1e-8)')
    check(launches >= 3 * chunks,
          f'ppoly_eval kernel launches on the main path: {launches} '
          f'(>= 3 per chunk, {chunks} chunks)')

    # ---- 6. the dispersion model, exact and fused final stage, f64 ----
    print('dispersion model:', flush=True)
    disp_launches = dispersion_paths(bundle, ref, grid)

    # ---- 7. the default gradient-free modes ----
    print('default modes:', flush=True)
    disp_bundle = dataclasses.replace(
        bundle, theory_opts=bundle.theory_opts.replace(rsd_model='dispersion'))
    default_modes(bundle, disp_bundle, grid)

    # ---- 8. the other options on the BOSS data ----
    print('other options:', flush=True)
    options = option_paths(cfg)

    # ---- 9. the excursion-set fit at full width ----
    print('excursion-set model:', flush=True)
    esm_bundle, esm_names, esm_cfg, esm_launches = esm_paths()

    # ---- 10. throughput (information only) ----
    theta = draw_theta(4096, 0, 'cuda')
    esm_theta = draw_prior(esm_cfg, 4096, 0, 'cuda')
    esm_disp = dataclasses.replace(
        esm_bundle,
        theory_opts=esm_bundle.theory_opts.replace(rsd_model='dispersion'))
    throughput(
        [('streaming exact', bundle, NAMES, theta, EXACT, None),
         ('streaming default', bundle, NAMES, theta, None, None),
         ('dispersion default', disp_bundle, NAMES, theta, None, None),
         ("dispersion final 'fused', other modes default", disp_bundle, NAMES,
          theta, {'dispersion_final': 'fused'}, None),
         ("dispersion final 'exact', other modes default", disp_bundle, NAMES,
          theta, {'dispersion_final': 'exact'}, None),
         ('dispersion exact', bundle, NAMES, theta,
          {**DISP_EXACT, 'dispersion_final': 'exact'}, None)]
        + [(f'{name} (exact modes)', b, NAMES, theta, {**EXACT, **kw}, extra)
           for name, (b, kw, extra, _) in options.items()]
        + [('ESM streaming exact', esm_bundle, esm_names, esm_theta, EXACT,
            None),
           ('ESM streaming default', esm_bundle, esm_names, esm_theta, None,
            None),
           ('ESM dispersion default', esm_disp, esm_names, esm_theta, None,
            None)],
        card, args.profile)

    print(f'ESM streaming path launches (ppoly_eval, of them multi-channel): '
          f'{esm_launches}', flush=True)

    # ---- 11. the gradient-free sampling path ----
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        print('sampling: eval through the CLI', flush=True)
        eval_cli(tmp)
        print('sampling: MH through the CLI run', flush=True)
        t0 = time.perf_counter()
        mh_launches, mh_steps, last, n_draws, rm1, _ = mh_posterior(cfg, tmp)
        print(f'  MH phase: {time.perf_counter() - t0:.2f} s', flush=True)
        check(n_draws == MH_BEFORE[0] and round(rm1, 4) == MH_BEFORE[1],
              f'MH run as before the ppoly_eval redesign: {n_draws} draws '
              f'({MH_BEFORE[0]}), R-1 {rm1:.4f} ({MH_BEFORE[1]}); if not, an '
              'operation of the MH step changed: compare its chain files '
              'with the older checkout (tools/ppoly_timing.py --mh)')
        mh_result, _ = sampler_kernel_case(bundle, last)
        print('sampling: ensemble', flush=True)
        ensemble_run(bundle)
        print('sampling: joint fit', flush=True)
        joint_fit(cfg, bundle, tmp)
    mh_step_rates(bundle, card, args.profile)

    # phase 14's files outlive phase 12's temporary directory; removed at
    # the end, or at exit after a failure
    evidence_dir = tempfile.TemporaryDirectory()
    evidence_tmp = evidence_dir.name

    # ---- 12. the gradient path ----
    print('gradients: the backward kernel', flush=True)
    bwd_results = backward_phase(bundle, gen)
    print('gradients: determinism', flush=True)
    determinism(bundle)
    print('gradients: d lnL / d theta against jax.grad', flush=True)
    grad_checks(bundle)
    with tempfile.TemporaryDirectory() as tmp:
        print('sampling: HMC through the CLI run, NUTS, phase 13c\'s fit '
              'and phase 14\'s evidence runs beside it', flush=True)
        t0 = time.perf_counter()
        child = start_nuts_child(tmp)
        fit_child = start_fit_cli(tmp)
        evidence = start_evidence_child(evidence_tmp)
        probe = start_probe(evidence_tmp)
        try:
            hmc_launches, leapfrogs, hmc_s, hmc_draws, hmc_rm1 = hmc_cli(
                cfg, tmp)
            print(f'  HMC phase: {time.perf_counter() - t0:.2f} s', flush=True)
            finish_nuts_child(child, timeout=600)
            print('optimizers (13c): fit through the CLI in a subprocess',
                  flush=True)
            finish_fit_cli(fit_child, timeout=600)
            print('evidence (14a-e, g): SMC, NS, post, tension and analyze in '
                  'a process of their own', flush=True)
            ev = finish_evidence_child(evidence, timeout=600)
            print('scale-out (16c): the two-process probe, in processes of '
                  'their own', flush=True)
            probe_summary = finish_probe(probe, timeout=300)
        finally:
            for proc in (child, fit_child[0], evidence[0], probe[0]):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        print(f'  HMC and NUTS phases: {time.perf_counter() - t0:.2f} s',
              flush=True)
    hmc_rates(bundle, card, args.profile)

    # ---- 13. second derivatives and the optimizer layer ----
    t13 = time.perf_counter()
    print('second derivatives: the fused second-order kernel', flush=True)
    hess_results = second_order_phase(bundle, gen)
    print('second derivatives: Hessians against jax.hessian', flush=True)
    hessian_checks(bundle, card)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_yaml(load_config('boss_sampling_config.yaml'),
                          os.path.join(tmp, 'boss_sampling.yaml'))
        print('optimizers: forecast through the CLI', flush=True)
        forecast_check(path)
        print('optimizers: scan through the CLI', flush=True)
        scan_check(path)
        print('optimizers: fit --bootstrap 4 through the CLI', flush=True)
        opt_launches, per_lookup = bootstrap_check(path)
        check(all(per_lookup.get(key, (0, 0))[1] > 0 for key in hess_results),
              'fit --bootstrap 4 launched the second-order kernels at each '
              f'lookup of a Hessian: {sorted(per_lookup.values())} (calls, '
              'launches)')
        print('optimizers: the ESM fit through the CLI', flush=True)
        esm_fit_check(esm_cfg, esm_bundle, tmp)
    print(f'  phase 13: {time.perf_counter() - t13:.2f} s', flush=True)

    # ---- 14. the evidence path: post, tension, compare, analyze ----
    t14 = time.perf_counter()
    print("evidence: ppoly_eval at the particle samplers' chunk of 64 (14a) "
          'and the device time per stage and iteration (14h)', flush=True)
    particle_rows = particle_kernel_rows(bundle, ev, card)
    print("evidence: compare streaming with dispersion, final 'fused' (14f)",
          flush=True)
    cmp_launches, cmp_result, cmp_s = compare_check(evidence_tmp)
    print(f"  phase 14 (for information, {card}): beside 12d SMC "
          f"{ev['smc_s']} s ({ev['smc_evals'] / ev['smc_s']:.1f} evals/s), "
          f"NS {ev['ns_s']} s ({ev['ns_evals'] / ev['ns_s']:.1f} evals/s), "
          f"tension {ev['tension_s']} s, analyze {ev['analyze_s']}; compare "
          f'{cmp_s[0]:.2f} + {cmp_s[1]:.2f} s; the parent\'s part of phase '
          f'14 {time.perf_counter() - t14:.2f} s', flush=True)

    # ---- 15. the class surface ----
    class_rows = class_surface(bundle, cfg, esm_bundle, esm_cfg)

    # ---- 16. the scale-out layer ----
    print('scale-out: make_sharded_loglike, the probe, mesh runs, the trace',
          flush=True)
    scale_row = scale_out(bundle, card, probe_summary)

    f64 = torch.float64
    print(f'chip_smoke: {time.perf_counter() - t_start:.1f} s in all '
          f'({card})', flush=True)
    print(f'card: {card}', flush=True)
    print(json.dumps({'kernels': [
        kernel_row('ppoly_eval', 'ppoly_eval.cu',
                   'victor_tpu/ops/splines.py:537', launches,
                   results[('float64', 31, True, True)], f64),
        kernel_row('ppoly_eval, K = 2 channels (anisotropic real space)',
                   'ppoly_eval.cu', 'victor_tpu/ops/splines.py:537',
                   options['assume_isotropic=False'][3][1],
                   results[('float64', 'multi', 2, False)], f64),
        kernel_row('dispersion_final', 'dispersion_final.cu',
                   'victor_tpu/ops/dispersion_pallas.py:32', disp_launches,
                   disp_results['float64'], f64),
        kernel_row(f'ppoly_eval, MH sampler ({mh_steps} steps of 8 chains, '
                   'default modes)', 'ppoly_eval.cu',
                   'victor_tpu/ops/splines.py:537', mh_launches, mh_result,
                   f64)] + [
        # neither TPU kernel had a VJP: the backward computes jax.grad of
        # victor_tpu's ppoly_eval, to which `replaces` points
        kernel_row(f'ppoly_eval backward, HMC sampler ({label.split(": ")[1]}'
                   f'; launches: all three lookups of the {hmc_draws + 300}'
                   f'-step run)', 'ppoly_eval.cu',
                   'victor_tpu/ops/splines.py:205', hmc_launches, res, f64)
        for label, res in bwd_results.items()] + [
        # the second derivatives in one fused kernel: jax.hessian of
        # victor_tpu's ppoly_eval; launches: the kernel launches of this
        # lookup's second-order calls in phase 13f's fit --bootstrap 4;
        # calls: those calls, each timed as `ms` (L2 warm; cold_ms cold)
        # beside the composed path's `composed_ms`
        kernel_row(f'ppoly_eval second order (fused kernel ppoly_2nd_chunks),'
                   f' Hessian lookup ({label.split(": ")[1]}; launches: '
                   f'kernel launches at this lookup in fit --bootstrap 4; '
                   f'calls: its calls, each one `ms`)', 'ppoly_eval.cu',
                   'victor_tpu/ops/splines.py:205', per_lookup[key][1], res,
                   f64, calls=per_lookup[key][0])
        for key, (label, res) in hess_results.items()] + particle_rows + [
        kernel_row("dispersion_final, compare's dispersion run (final "
                   "'fused', 1024 particles, chunk of 64)",
                   'dispersion_final.cu',
                   'victor_tpu/ops/dispersion_pallas.py:32', cmp_launches,
                   cmp_result, f64)] + class_rows + [scale_row]}),
          flush=True)
    evidence_dir.cleanup()
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
