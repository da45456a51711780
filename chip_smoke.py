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
      lookups of one gradient of the HMC target (captured), at K = 2 and 3
      over (8, 150000) and at EDGE_CASES, in f64 and f32, NaN and inf
      positions identical; each call twice, for the same bits; the
      lookups' backward timed;
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
   a. the second-order terms of the spline lookup (the forward and backward
      kernels on derived tables, kernels/ppoly.py::ppoly_eval_second_order)
      against autograd with create_graph=True through the plain backward,
      at the three lookups of one Hessian of the BOSS target (captured), at
      K = 2 and 3 over (8, 150000) and at EDGE_CASES, in f64 and f32, NaN
      and inf positions identical, each call twice for the same bits; the
      Hessian's lookups timed;
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
      (|grad| < 1e-3), and the forward, backward and second-order launches,
      the last also by Hessian lookup (calls and kernel launches);
   g. `fit configs/esm_sampling_config.yaml` in f64 (ESM_FIT_STARTS
      starts): the exact 9 x 9 Hessian at the optimum finite (so no
      finite-difference fallback was taken), and
      the Hessian at the ESM ref point against ESM_HESS_GOLDENS within 1e-7
      of max|H|.

The last two lines are a JSON summary of the kernels (device-only `ms`,
`host_us`; the sampler row's `ms` is its L2-cold reading, beside `warm_ms`;
a second-order row's `ms` is one composed call of several launches, its
`calls` the composed calls at its lookup and its `launches` their kernel
launches) and the result line {"ok": true, "device": {...}}. `--profile PATH` also
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


def compare_dispersion(inputs, dtype):
    """The dispersion_final kernel against its plain version at the path's
    shape; returns `timed`'s result, the error the worst of the four
    outputs."""
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


def cold_ms(x, coeffs, q, clamp, copies=6):
    """Device-only ms of one ppoly_eval call with L2 cold: `copies` distinct
    (q, out) pairs in rotation, more than the card's 50 MB L2 in all, so
    that no launch finds its data in L2."""
    import collections
    import itertools

    from victor_tpu_torch.kernels.ppoly import ppoly_eval_cuda

    check(copies * 2 * nbytes(q) > L2_BYTES,
          f'cold rotation: {copies} (q, out) pairs of '
          f'{2 * nbytes(q) / 1e6:.1f} MB exceed the '
          f'{L2_BYTES / 1e6:.0f} MB L2')
    turn = itertools.cycle([q.clone() for _ in range(copies)])
    live = collections.deque(maxlen=copies)     # keeps the outputs distinct
    return device_ms(lambda: live.append(
        ppoly_eval_cuda(x, coeffs, next(turn), clamp)))


def sampler_kernel_case(bundle, theta):
    """Every ppoly_eval call of one likelihood evaluation of the MH step
    (default modes, 8 chains) against the plain version on the same inputs,
    each timed back to back on one q, as the MH step finds it just written
    (L2 warm); the largest also with L2 cold (`cold_ms`). Returns the
    largest call's `timed` result, whose `ms` is the cold reading and
    `warm_ms` the warm one, and the results of all calls by label."""
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
        make_batched_loglike(bundle, NAMES)(theta)
    finally:
        splines.ppoly_eval_cuda = ppoly_eval_cuda
    results = {}
    for x, coeffs, q, clamp in calls:
        out_k = ppoly_eval_cuda(x, coeffs, q, clamp)
        out_p = ppoly_eval_plain(x, coeffs, q, clamp)
        torch.cuda.synchronize()
        label = (f'ppoly_eval in the MH step ({len(calls)} calls): '
                 f'coeffs={tuple(coeffs.shape)} q={tuple(q.shape)} '
                 f'clamp={clamp}')
        err = compare_outputs(label, out_k, out_p, q.dtype)
        K = coeffs.shape[1] if coeffs.ndim == 4 else 1
        results[label] = timed(
            label, err, lambda: ppoly_eval_cuda(x, coeffs, q, clamp),
            lambda: ppoly_eval_plain(x, coeffs, q, clamp),
            nbytes(x, coeffs, q, out_k), q.numel() * ppoly_ops(x.shape[0], K))
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


def backward_phase(bundle, gen):
    """Phase 12a: the backward kernel against its plain version at the HMC
    path's three lookups (captured from one gradient of the BOSS posterior
    at 8 chains), at K = 2 and 3 over (8, 150000), at the Chebyshev-node
    shapes and at EDGE_CASES, in f64 and f32, every comparison twice for
    the same bits. Returns the timed results of the path's lookups by
    label."""
    import torch
    from victor_tpu_torch.kernels import ppoly
    from victor_tpu_torch.sampling.hmc import value_and_grad

    calls = []
    real = ppoly.ppoly_eval_backward_cuda

    def record(x, c, q, g, clamp=True, want_dq=True, want_dcoeffs=True):
        # the Function's saved inputs still require grad; the comparisons
        # below run with gradients on, where the wrappers refuse them
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
    check(len(calls) == 3, f'one gradient of the HMC target: {len(calls)} '
                           'backward calls (3: sigma_v, v_r, xi_0)')
    print('compare the ppoly_eval backward kernel vs plain:', flush=True)
    results = {}
    for x, c, q, g, clamp, want_dq, want_dc in calls:
        label = (f'backward on the HMC path: coeffs={tuple(c.shape)} '
                 f'q={tuple(q.shape)} clamp={clamp} dq={want_dq} '
                 f'dcoeffs={want_dc}')
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
    """Operations per query of the composed second-order terms: two forward
    and three backward launches' work, and the elementwise products and
    the clip factor around them (about 16)."""
    return 2 * ppoly_ops(n, K) + 3 * bwd_ops(n, K) + 16


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


def compare_second_order(label, x, c, q, g, u, V, clamp, wants,
                         time_it=False):
    """The second-order terms on the card (ppoly_eval_second_order: the
    forward and backward kernels on derived tables) against their plain
    version (in f64) on the same inputs: NaN and inf positions identical
    (d/dq and d/dgrad_out NaN at an infinite query without clamp, the
    port's rule where its forward is NaN), d/dq and d/dgrad_out within TOL
    x their largest entry, d/dcoeffs within
    TOL x the summed magnitudes of its terms; a second call gives the same
    bits. Returns `timed`'s result when `time_it`, else the max abs
    error."""
    import torch
    from victor_tpu_torch.kernels.ppoly import ppoly_eval_second_order

    def kernel():
        return ppoly_eval_second_order(x, c, q, g, u, V, clamp, *wants)

    got, again = kernel(), kernel()
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
    return timed(label, err, kernel,
                 lambda: second_order_plain(x, c, q, g, u, V, clamp, wants),
                 nbytes(*ins, *outs), q.numel() * second_order_ops(
                     x.shape[0], K), reps=(10, 3))


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


def second_order_phase(bundle, gen):
    """Phase 13a: the second-order terms on the card against their plain
    version at the three lookups of one Hessian of the BOSS streaming
    target (captured: 4 replicated rows of one point), at K = 2 and 3 over
    (8, 150000) and at EDGE_CASES, in f64 and f32, every comparison twice
    for the same bits. Returns {lookup_key: (label, timed result)} of the
    Hessian's lookups."""
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
    print('compare the ppoly_eval second-order terms vs plain:', flush=True)
    results = {}
    for x, c, q, g, u, V, clamp, wants in calls:
        label = (f'second order on the Hessian path: coeffs='
                 f'{tuple(c.shape)} q={tuple(q.shape)} clamp={clamp} '
                 f'u={u is not None} V={V is not None} wants={wants}')
        results[lookup_key(c, clamp)] = label, compare_second_order(
            label, x, c, q, g, u, V, clamp, wants, time_it=True)
    for dtype in (torch.float64, torch.float32):
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
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from victor_tpu_torch.kernels import ppoly

    for name, kw in GRAD_CASES.items():
        H = neg_loglike_hessian(bundle, kw, [GOLDEN, DISPLACED]).cpu().numpy()
        want = np.array(HESS_GOLDENS[name])
        err = max(float(np.abs(h - w).max() / np.abs(w).max())
                  for h, w in zip(H, want))
        check(np.isfinite(H).all() and err <= 1e-8,
              f'-Hessian of lnL ({name}) at the golden and displaced points: '
              f'max error {err:.3e} of max|H| against jax.hessian (<= 1e-8)')
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
    check(launches > 0, f'second-order kernel launches per Hessian '
                        f'(streaming, one point): {launches}')
    print(f'  one 4 x 4 Hessian (streaming, one point, 4 replicated rows): '
          f'{1e3 * wall:.2f} ms wall, {device_us / 1e3:.2f} ms of kernels '
          f'under torch.profiler, {launches} second-order launches, peak '
          f'{peak:.2f} GiB on {card}', flush=True)


class Captured:
    """Record the arguments and results of a function of
    victor_tpu_torch.sampling.optimize while a CLI command runs in this
    process (the CLI imports it at call time), so that the script reads the
    unrounded results."""

    def __init__(self, name):
        from victor_tpu_torch.sampling import optimize
        self.module, self.name = optimize, name
        self.real = getattr(optimize, name)
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
    (|grad| < 1e-3); bias and sigma (information). Returns the launches (forward, backward, second
    order) and, by lookup_key, the second-order calls and the kernel
    launches they made."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels import ppoly
    per_lookup = {}
    real = ppoly.ppoly_eval_second_order

    def count(x, c, q, g, u, V, clamp=True, *wants):
        before = ppoly.LAUNCHES_2ND
        out = real(x, c, q, g, u, V, clamp, *wants)
        key = lookup_key(c, clamp)
        calls, launches = per_lookup.get(key, (0, 0))
        per_lookup[key] = calls + 1, launches + ppoly.LAUNCHES_2ND - before
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


def kernel_row(name, source, replaces, launches, result, dtype,
               calls=None):
    """One entry of the kernels summary line from a comparison's `timed`
    result (device-only ms, host us per call; the sampler's row also its L2
    warm reading, its `ms` being the cold one; a composed row also its
    `calls`, `ms` being one call). No single PyTorch call computes either
    kernel's function, so library_ms is null."""
    bound_ms, bound_by = bound(result['bytes'], result['ops'], dtype)
    row = {'name': name, 'route': 'cuda',
           'source': f'victor_tpu_torch/kernels/csrc/{source}',
           'replaces': replaces, 'launches': launches,
           'max_abs_err': result['max_abs_err'], 'ms': result['ms'],
           'plain_ms': result['plain_ms'], 'bound_ms': bound_ms,
           'bound_by': bound_by, 'library_ms': None,
           'host_us': result['host_us']}
    if 'warm_ms' in result:
        row.update(cold_ms=result['ms'], warm_ms=result['warm_ms'])
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
    args = parser.parse_args()

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

    # ---- 12. the gradient path ----
    print('gradients: the backward kernel', flush=True)
    bwd_results = backward_phase(bundle, gen)
    print('gradients: determinism', flush=True)
    determinism(bundle)
    print('gradients: d lnL / d theta against jax.grad', flush=True)
    grad_checks(bundle)
    with tempfile.TemporaryDirectory() as tmp:
        print('sampling: HMC through the CLI run, NUTS and phase 13c\'s '
              'fit beside it', flush=True)
        t0 = time.perf_counter()
        child = start_nuts_child(tmp)
        fit_child = start_fit_cli(tmp)
        try:
            hmc_launches, leapfrogs, hmc_s, hmc_draws, hmc_rm1 = hmc_cli(
                cfg, tmp)
            print(f'  HMC phase: {time.perf_counter() - t0:.2f} s', flush=True)
            finish_nuts_child(child, timeout=600)
            print('optimizers (13c): fit through the CLI in a subprocess',
                  flush=True)
            finish_fit_cli(fit_child, timeout=600)
        finally:
            for proc in (child, fit_child[0]):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        print(f'  HMC and NUTS phases: {time.perf_counter() - t0:.2f} s',
              flush=True)
    hmc_rates(bundle, card, args.profile)

    # ---- 13. second derivatives and the optimizer layer ----
    t13 = time.perf_counter()
    print('second derivatives: the composed second-order terms', flush=True)
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

    f64 = torch.float64
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
        # the second derivatives compose the two kernels above on derived
        # tables: jax.hessian of victor_tpu's ppoly_eval; launches: the
        # kernel launches of this lookup's second-order calls in phase 13f's
        # fit --bootstrap 4; calls: those calls, each timed as `ms`
        kernel_row(f'ppoly_eval second order (forward and backward kernels '
                   f'on derived tables), Hessian lookup '
                   f'({label.split(": ")[1]}; launches: kernel launches at '
                   f'this lookup in fit --bootstrap 4; calls: its composed '
                   f'calls, each one `ms`)', 'ppoly_eval.cu',
                   'victor_tpu/ops/splines.py:205', per_lookup[key][1], res,
                   f64, calls=per_lookup[key][0])
        for key, (label, res) in hess_results.items()]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
