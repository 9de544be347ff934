"""Chip smoke run of the PyTorch/CUDA port (admm_lstm_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - compile every CUDA kernel of the paths below from csrc/
               with nvcc (one process per source, all started together),
               and print each kernel's registers and spills;
  2. kernels - hold each kernel against its plain PyTorch version on the
               card, at its paths' shapes and more, and time kernel, plain
               version and (where one exists) the one-call PyTorch
               yardstick with CUDA events (L2 flushed before every launch);
               for the Gauss-Seidel sweep also its tile plan and its time
               per step past the first (ms_per_step), and with the
               candidate axis (CANDIDATE_SHAPES: the GoogleStock rho grid,
               the YahooFinance scenario batch) held to its plain version
               and to S launches without the axis (bit-equal on the same
               plan), timed beside those launches, with its plan and the
               registers and spills of its instance;
               for the Jacobi sweep also its plan, registers and spills,
               GB/s, its L2-resident time (warm_ms), a device copy of the
               same bytes (copy_ms), and, where it takes float4s, the
               one-float instance's time (vec1_ms) and identical bits;
               and with the candidate axis (JACOBI_CANDIDATE_SHAPES: the
               GoogleStock rho grid, the scenario batch) held to its plain
               version and to S launches without the axis (bit-equal where
               the float widths match), timed beside those launches and a
               device copy of its bytes;
               for the Cholesky kernels also a two-call yardstick, their
               registers and systems per SM, at the candidate axis's
               batched N (BATCHED_SOLVE_SHAPES, BATCHED_INVERSE_SHAPES)
               bit-equal to S calls alone and timed beside them, and gate
               (ii): the error against float64 on ill-conditioned
               Gram-like inputs, held to the plain version's;
               for the weight stage's theta tests (THETA_SHAPES: the
               GoogleStock stage and its 27-candidate rho grid) the table
               held to the plain loop at THETA_RTOL and bit-equal on a
               second launch, the plan, registers and spills, timed
               beside the plain loop; for the stacked sweep
               (STACKED_SWEEP_SHAPES: the stacked cell's batched epoch and
               the (8, 8) run's) every new slab held to
               stacked_sweep_plain at STACKED_SWEEP_RTOL of its scale and
               bit-equal on a second launch, the path and the bounds'
               passes timed beside the plain loop and the byte bound;
  3. floor   - the Gauss-Seidel serial-floor probe: `python -m
               admm_lstm_torch.gs_floor` at its defaults (T 2047, H 16,
               B 64) with the launch counts zeroed just before and read
               just after; floor_sweep against its plain version at
               FLOOR_SHAPES with floor_plan's plan and the registers and
               spills of the kernel instance it takes, and at the first
               FLOOR_TIMED of them its time (L2 flushed and warm), bound,
               plain time, time a step, interior_sweep's times and time a
               step at the same shape (the chain share, the floor's step
               over the sweep's: how far a Gauss-Seidel step is from the
               bare recurrence's), where H <= 32 the recurrence on
               interior_sweep's tile plan (the floor's other route) held
               to the plain version and timed, and cuDNN's LSTM on the
               same function, held to the kernel before it is timed;
  4. train   - the paths, each through `admm_lstm_torch.api`, with the
               kernels' launch counts zeroed just before each run and read
               just after:
               * slice 1: GoogleStock, H=10, default ADMMConfig, 30 epochs
                 from the reference's seed-0 weights, held to the
                 reference's loss trajectory;
               * Path A, the turbo/auto leg on GoogleStock: auto() at
                 'highest' held to the JAX package's trajectory and rho,
                 auto() and turbo() at their own 'default' held to the
                 JAX package's 30-epoch validation loss, preset='best'
                 choosing auto;
               * Path B, the wide exact solve: the JAX bench's HAR-shaped
                 turbo run (B=2048, T=10, I=561, H=128, O=6, synthetic
                 data), 5 epochs, and one epoch with the kernels against
                 the same epoch with the plain versions; then three rows
                 of the HAR rho grid x 2 epochs at 'highest' through
                 search_rho as one batched program, each held to its run
                 alone at 1e-5, with one chol_solve and 9 chol_inverse
                 launches an epoch for the three;
               * datasets: the default config at H=10 on YahooFinance and
                 DNA1, 30 epochs from the reference's seed-0 weights, held
                 to its trajectories, one interior_sweep launch an epoch;
                 SMSSpam (I=95, O=2) and GEFCOM2012Wind, 5 epochs from
                 numpy-seeded weights, held to the JAX package's losses;
  5. tune    - search_rho on GoogleStock over the default 27-point grid, 30
               epochs a candidate, as one batched program: the JAX
               package's best rho, every candidate's validation loss, 30
               interior_sweep launches (one an epoch for the grid), the
               search's host syncs, busy ms and idle share under the
               profiler, and its wall seconds beside the 27 candidates'
               runs alone (api.train, timed in the same call), candidate 0
               and the best candidate held to their runs alone at rtol
               1e-4; the same grid under auto() (the Jacobi sweep and the
               exact weight solve on the candidate axis), one batched
               program at auto()'s 'default' and at 'highest': 30
               jacobi_sweep launches with the axis and 60 chol_solve, no
               interior_sweep, no out-of-memory halving; at 'default' the
               winner within 1.05x of the JAX package's best, each
               candidate's gap to it logged; at 'highest' the JAX
               package's best rho and validation losses, every candidate
               held to its run alone at rtol 1e-4 with its final rho
               equal, the wall seconds of both and the search's syncs,
               busy ms and idle share; the CLI's --auto --tune_rho 1 (125
               candidates in one batched program), its groups, launches
               and wall seconds;
  6. resume  - YahooFinance 10 epochs straight against 5 checkpointed
               (async) and resumed from the directory to 10: losses,
               weights and the whole final state equal bit for bit;
  7. stacked - the stacked N-layer variant on GoogleStock at the JAX
               bench's width (hiddens (8, 8), ParameterSet 'Stacked'),
               from the JAX package's seed-0 initial weights
               (tests/golden/torch_stacked_init_*.npz): train_stacked at
               (8, 8) for 30 epochs and (8, 8, 8) for 10, held to the JAX
               package's trajectories, two chol_solve launches, one
               stacked_sweep and one chol_inverse a layer below the top
               an epoch;
               search_rho_stacked over refine_rho_stacked's first 27-point
               grid at (8, 8), 30 epochs, as one batched program (60
               chol_solve launches, 30 stacked_sweep and 30 chol_inverse,
               no other kernel, no halving): each
               candidate held to its train_stacked run alone at rtol
               1e-5, JAX's losses and winner, its wall seconds twice
               around the 27 runs alone, its syncs, busy ms and idle share
               under the profiler, and once more with a rho_z per
               candidate, STACKED_Z_ALONE held to their runs alone;
               train_best_stacked (60 epochs, 30-epoch probes, one search
               round of 27 candidates) making the JAX package's choice
               with its tuned rho, with 300 chol_solve launches, 150
               stacked_sweep, 150 chol_inverse and no other kernel; one
               (8, 8)
               epoch with the kernels against the same epoch with the
               plain versions (chol_solve's and the stacked sweep's); a
               save_model/load_model round trip of the
               result, bit-equal;
  8. legacy  - ADMM-LSTM-L, ADMM-LSTM-S, the gradient baselines and the
               comparison harness on GoogleStock at the CLI's width (H 10,
               seed 0), none of which launches a kernel but the harness's
               Fast run: admm_l_demo for 30 epochs on the JAX package's
               trajectory and on the admm_l_small golden; admm_s_demo for
               5 epochs on its golden; train_best for both (60 epochs,
               15-epoch probes) making JAX's choice; SGD, Adam and Adagrad
               for 100 epochs from the reference's seed-0 weights on the
               JAX package's losses; run_comparison for 30 epochs, its six
               curves equal to the runs alone and 30 interior_sweep
               launches; one epoch of each ADMM variant on the card
               against the CPU; and each variant's and baseline's ms per
               epoch, host syncs and device operations per epoch.
  9. sharded - data-parallel consensus ADMM (api.train_sharded and the
               sharded epoch function) on GoogleStock at H 10 from the
               reference's seed-0 weights, each rank a process of its own
               (parallel/launch.spawn, a timeout on the rendezvous, every
               collective and the join): two gloo ranks on the one card,
               default config, 30 epochs, on slice 1's trajectory within
               rtol 1e-4 and the reference's val30, the ranks' weights
               bit-equal, 30 interior_sweep launches on each rank; the
               same two ranks under auto() at 'highest' for 30 epochs,
               rho equal to the single-process run after every epoch, val
               within rtol 1e-4, at least 30 jacobi_sweep and 60
               chol_solve launches on each rank; one NCCL rank, 5 epochs,
               bit-equal to api.train.  It logs each run's ms per epoch
               (two ranks on one card share it: not a scaling figure) and
               the all-reduces and bytes all-reduced per epoch per rank.
 10. scenarios - api.train_scenarios on the CLI's --scenarios 4 config
               (YahooFinance in 4 folds of 340, fast, H 10, wy_lipschitz)
               for 30 epochs from the JAX package's seed-split inits
               (tests/golden/torch_scenarios_init_s4.npz), in one batched
               program, held to the JAX package's losses (SCEN_RTOL says
               how), 30 interior_sweep launches (one an epoch for the
               four), and a TF32 run of the same batched program that
               the hold must refuse; the
               JAX bench's yahoo_scenarios_loose (no_dual_y,
               200 epochs a fold) timed in scenario-epochs/s beside the
               figure of the scenarios one after another, with the
               profiler's busy ms, idle share and host syncs of a scenario
               epoch with and without the Lipschitz step and of one
               batched epoch of the four; the same four folds under
               turbo(no_dual_y, wy_lipschitz, 'highest') for 10 epochs in
               one batched program (one jacobi_sweep launch with the axis
               and two chol_solve an epoch), each scenario held to its run
               alone at 1e-4; the
               CLI (--scenarios 4 -e 5 --save --record_matlab_data) and
               visualize over its models, in a temporary directory, the
               models' predictions on the card held to the CPU's; a
               profile_trace of one scenario epoch naming the kernel and
               the span() region.
 11. seqpar  - the time-sharded Jacobi layout (parallel/sharding.py,
               shard_time=True) at the JAX long-T bench's shape (B 256, T
               512, H 16, Jacobi, prox-linear weights): two gloo ranks on
               the card hold time blocks of 257 and 256 rows, 10 epochs
               held to one process on the card (losses at rtol 1e-4, each
               weight leaf within 1e-4 of its scale, the ranks' weights
               bit-equal), one jacobi_sweep launch an epoch on each rank;
               ms per epoch per rank and the collectives per epoch per
               axis (halos and broadcasts too);
 12. tp      - hidden-axis tensor parallelism on a (1, 2) (data, model)
               mesh: Path B's shape under turbo at 'highest', 5 epochs, held
               to one process as above, with jacobi_sweep 5, chol_solve 5
               and chol_inverse 45 launches on each rank; and slice 1's
               GoogleStock default config (H 10, 5 a rank) for 30 epochs on
               slice 1's trajectory at rtol 1e-4 and the reference's val30,
               30 interior_sweep launches a rank on the gathered slabs.
Then it prints the card's name and power limit, one JSON line describing
every kernel, and as the last line {"ok": true, "device": {...}}.
It exits non-zero, printing no result line, without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'googlestock_fast.npz')
EPOCHS = 30
REF_VAL_30 = 0.346877           # the reference's 30-epoch validation loss
# f32: summation order and transcendental ulps between a sweep kernel and
# its plain version.
KERNEL_ATOL = 1e-5
# f32, gate (i): the Cholesky kernels (blocked, with FMA) and their plain
# versions (unblocked, every product rounded) round differently; on the
# SPD inputs M M^T + D I (condition numbers below 5, solutions and inverses
# of magnitude below 1) that differs by ~1e-7, so 1e-5 absolute catches a
# wrong index, not a rounding order.
CHOL_ATOL = 1e-5
# Gate (ii), the rounding order: on Gram-like inputs of condition number
# kappa (gram_inputs), the kernel's error against a float64 reference may
# be at most ILL_REL times the plain version's plus ILL_ABS times the
# reference's max |x|.
ILL_KAPPAS = (1e5, 1e6)
ILL_REL = 2.0
ILL_ABS = 1e-7
# H100 SXM published peaks (NVIDIA data sheet): HBM rate and FP32 (non
# tensor-core) rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
SPIN_CYCLES = 1_000_000        # ~0.5 ms at the H100's ~2 GHz SM clock

# Shapes, each kernel's main-path shape first.  Sweeps: (steps, H, B);
# Cholesky: (N systems, D).
SWEEP_SHAPES = [(9, 10, 4224), (13, 5, 1000), (31, 130, 512),
                (9, 100, 4224), (127, 16, 512),
                # YahooFinance, DNA1, SMSSpam, GEFCOM2012Wind at H = 10
                (59, 10, 1360), (56, 10, 85), (24, 10, 487), (23, 10, 10522),
                # a YahooFinance scenario (4 folds of 340)
                (59, 10, 340)]
# interior_sweep with the candidate axis (S, steps, H, B): the GoogleStock
# rho grid (27 candidates) and the YahooFinance scenario batch (4 folds).
CANDIDATE_SHAPES = [(27, 9, 10, 4224), (4, 59, 10, 340)]
JACOBI_SHAPES = [(9, 10, 4224), (9, 128, 2048), (13, 5, 1000),
                 (5, 7, 1001),     # H * B odd: the V = 1 instance
                 # the seqpar phase's two time blocks and the tp phase's H
                 # block of Path B
                 (256, 16, 256), (255, 16, 256), (9, 64, 2048)]
# jacobi_sweep with the candidate axis (S, steps, H, B): the GoogleStock
# rho grid under auto() (27 candidates) and the scenario batch under
# turbo() (4 folds).
JACOBI_CANDIDATE_SHAPES = [(27, 9, 10, 4224), (4, 59, 10, 340)]
# floor_sweep (steps, H, B): the gs_floor probe's default first, then the
# Gauss-Seidel rows' (127, 16, 512), GoogleStock's and (31, 130, 512) (the
# recurrence on interior_sweep's plan, wh streamed), timed beside
# interior_sweep and cuDNN; the two routes' edge (H 32 and 33), a ragged
# batch edge, small ones.
# The theta tests ([S,] T, 4H, B): GoogleStock's weight stage (the
# training runs) and its 27-candidate rho grid, a full block of 8 thetas.
THETA_SHAPES = [(10, 40, 4224), (27, 10, 40, 4224)]
THETA_K = 8
# f32 sums of ~0.4 M squares a gate and candidate, in another order than
# the plain loop's.
THETA_RTOL = 1e-6
# Operations per element and theta: divide, add, scale, tanh, scale,
# shift, subtract, square, add.
THETA_OPS = 9
# The stacked sweep (S or None, T, hiddens..., B): the stacked cell's
# batched epoch (27 candidates of (40, 40) on GoogleStock's B 4224) and
# the stacked phase's (8, 8) without the candidate axis.
STACKED_SWEEP_SHAPES = [(27, 10, 40, 40, 4224), (None, 10, 8, 8, 4224)]
# Sums of a few hundred products in another order than cuBLAS's: each new
# slab within this share of its scale (max |x|; a dual's plus its largest
# rho times its primal's), as tests/test_torch_gpu.py holds it.
STACKED_SWEEP_RTOL = 1e-5
# The exact stage's Gram kernel (S or None, T, K, D, B, shared design):
# the stacked cell's layer-0 h side (27 candidates, K 160, D 40, each its
# own design) and x side (D 1, one design for all), then the one-layer
# auto() stage's h and x sides (K 40, D 10 and 1, no candidate axis).
EXACT_GRAM_SHAPES = [(27, 10, 160, 40, 4224, False),
                     (27, 10, 160, 1, 4224, True),
                     (None, 10, 40, 10, 4224, False),
                     (None, 10, 40, 1, 4224, True)]
# Each Gram within this share of its scale (max |G_k|), each first-order
# term of its sum of magnitudes, of the float64 sums (FP32 sums of T * B
# products: 1.5e-6 at the stacked h side), as tests/test_torch_gpu.py
# holds them; and of the plain version's, whose cuBLAS FP32 sums are
# themselves 2.2e-5 from float64 there (PERF.md, section 6).
EXACT_GRAM_RTOL = 1e-5
EXACT_GRAM_PLAIN_RTOL = 5e-5
FLOOR_SHAPES = [(2047, 16, 64), (127, 16, 512), (9, 10, 4224),
                (31, 130, 512), (511, 32, 96), (511, 33, 96), (13, 5, 1000),
                (4, 7, 37), (1, 3, 1)]
FLOOR_TIMED = 4
# The floor's operations per element and step beside its 8H-long product:
# the 4 projection adds, five activations and the c and h updates.
FLOOR_OPS = 25
SOLVE_SHAPES = [(40, 10), (40, 1), (512, 128), (37, 100),
                # the stacked (8, 8) layer-0 solves: wx (D = I) and wh
                (32, 1), (32, 8),
                # the tp phase's h-stage: a 'model' rank's 4H/2 columns
                (256, 128)]
INVERSE_SHAPES = [(512, 64), (16, 128), (7, 33),
                  (256, 64)]      # the tp phase's x-stage blocks
# The Cholesky kernels at the candidate axis's batched N, (S, N a
# candidate, D): the auto() rho grid's two exact stages (27 x 40 systems
# of D 10 and of D 1) and Path B's three candidates (3 x 512 diagonal
# blocks of 64), each held bit-equal to S calls alone and timed beside
# them.
BATCHED_SOLVE_SHAPES = [(27, 40, 10), (27, 40, 1), (27, 32, 8), (27, 32, 1)]
BATCHED_INVERSE_SHAPES = [(3, 512, 64)]
# Gate (ii) at the shapes of Path A and Path B.
ILL_SOLVE_SHAPES = [(40, 10), (40, 1), (512, 128)]
ILL_INVERSE_SHAPES = [(512, 64)]

# The JAX package's ADMMConfig.auto(epochs=30, hidden_size=10,
# matmul_precision='highest') run on GoogleStock from the golden seed-0
# weights `w0_*`, on the CPU (tests/test_torch_chip_reference.py
# recomputes these with the JAX package and holds them equal).
AUTO_TRAIN = [
    0.05240365490317345, 0.052403680980205536, 0.05055248737335205,
    0.047350089997053146, 0.042380549013614655, 0.03576134145259857,
    0.028378261253237724, 0.02139207534492016, 0.016792142763733864,
    0.014757433906197548, 0.013811700977385044, 0.013374772854149342,
    0.013181203044950962, 0.012992314994335175, 0.012790260836482048,
    0.012577584944665432, 0.012362509034574032, 0.012152327224612236,
    0.011950729414820671, 0.011757789179682732, 0.011571304872632027,
    0.011388520710170269, 0.011207420378923416, 0.011027233675122261,
    0.010848266072571278, 0.010671372525393963, 0.01049739494919777,
    0.010326826944947243, 0.010159728117287159, 0.009995860047638416,
    0.009834851138293743]
AUTO_VAL = [
    0.552921712398529, 0.5529218912124634, 0.5345888137817383,
    0.5028265118598938, 0.4534035325050354, 0.38726887106895447,
    0.3129580020904541, 0.24187077581882477, 0.19441454112529755,
    0.17317330837249756, 0.16325180232524872, 0.15868358314037323,
    0.15669085085391998, 0.15474927425384521, 0.15264159440994263,
    0.15039676427841187, 0.14811119437217712, 0.14587359130382538,
    0.143731027841568, 0.14168693125247955, 0.1397164911031723,
    0.13778679072856903, 0.1358727216720581, 0.13396380841732025,
    0.132062628865242, 0.13017895817756653, 0.12832306325435638,
    0.12650145590305328, 0.12471569329500198, 0.12296359241008759,
    0.12124120444059372]
# rho after each epoch (entry 0: the GoogleStock parameter set's) as the
# power of tau = 2 it was multiplied by; i, f, g, o stay put.
AUTO_RHO_DOUBLINGS = {
    'c': [0, 1, 2, 3, 4, 5, 6, 6, 6, 6, 6] + [6] * 20,
    'h': [0, 1, 2, 3, 4, 5, 6, 7, 7, 7, 8] + [8] * 20,
    'y': [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10] + [10] * 20,
}
# The same package's 30-epoch validation losses at each preset's own
# matmul precision, and preset='best' on the default config.
AUTO_VAL_30 = 0.12124120444059372
TURBO_VAL_30 = 0.3402582108974457
BEST_CHOICE = 'auto'
BEST_PROBE_VAL = {'shipped': 0.43839141726493835, 'auto': 0.15039676427841187}

# Path B, the JAX bench's HAR-shaped exact-solve configuration
# (bench.py:276-287): synthetic stand-in data, ParameterSet 'HAR'.
HAR_SHAPE = dict(batch=2048, seq_len=10, input_size=561, output_size=6,
                 val_batch=128)
HAR_HIDDEN = 128
HAR_EPOCHS = 5
# f32: one epoch, kernels against plain versions at 'highest'; the
# Cholesky kernels and the Jacobi kernel differ from their plain versions
# by FMA contraction and summation order (the Cholesky kernels' roundings
# reach the D = 561 blocked solve, amplified by the Gram's conditioning),
# the Jacobi kernel also by transcendental ulps.  Each leaf is held
# to HAR_RTOL times its own scale: max |x| for weights and gates; for a
# dual, max |lambda_k| + rho_k max |gate_k|, because lambda_k + rho_k
# (gate_k - target) sums terms of the gate's size that nearly cancel in
# the first epochs (the duals are ~1e-7 after one), so its rounding
# error scales with rho_k |gate_k|, not with lambda_k.
HAR_RTOL = 1e-5

# The bundled datasets at the CLI's --hidden 10 from the reference's
# recorded seed-0 weights: the default config, 30 epochs, held to the
# reference trajectories as tests/test_golden_parity.py does on the CPU.
GOLDEN_DATASETS = {'YahooFinance': 'yahoofinance_fast.npz',
                   'DNA1': 'dna1_fast.npz'}
# SMSSpam and GEFCOM2012Wind: no recorded trajectory; the default config,
# DATASET_EPOCHS epochs from numpy_weights(I, 10, O, seed 0), held to the
# JAX package's losses on the CPU (pinned by
# tests/test_torch_chip_reference.py).
DATASET_EPOCHS = 5
DATASET_REF = {
    'SMSSpam': {
        'train': [0.5106704235076904, 0.5106703639030457, 0.5106588006019592,
                  0.5106475353240967, 0.510636568069458, 0.5106250643730164],
        'val': [0.5117548108100891, 0.5117547512054443, 0.5117449760437012,
                0.5117356777191162, 0.5117266774177551, 0.5117172002792358]},
    'GEFCOM2012Wind': {
        'train': [0.06161622703075409, 0.06161627918481827,
                  0.054962750524282455, 0.04914909601211548,
                  0.04407046362757683, 0.039639558643102646],
        'val': [0.08647491782903671, 0.08647499978542328,
                0.07697774469852448, 0.0686643049120903,
                0.06138790398836136, 0.055027078837156296]},
}
# search_rho on GoogleStock: the default 27-point grid (candidate_grid,
# multipliers 0.2/1/5 on c, h, y), ADMMConfig(hidden_size=10), 30 epochs
# from the golden seed-0 weights; the JAX package's validation loss of
# each candidate in grid order and its best rho.
TUNE_VAL = [
    0.4976523518562317, 0.3444494605064392, 0.11874193698167801,
    0.49760112166404724, 0.3443931043148041, 0.11845565587282181,
    0.4975305199623108, 0.34414198994636536, 0.11719442158937454,
    0.4978333115577698, 0.34727662801742554, 0.14318852126598358,
    0.4978214204311371, 0.3468780219554901, 0.1420157253742218,
    0.49777063727378845, 0.3441072106361389, 0.134624645113945,
    0.49904343485832214, 0.34859123826026917, 0.16435106098651886,
    0.4989416301250458, 0.3480836749076843, 0.16086992621421814,
    0.49854615330696106, 0.34616103768348694, 0.13619090616703033,
]
TUNE_BEST_RHO = {'i': 1.0, 'f': 1.0, 'g': 1.0, 'o': 1.0,
                 'c': 0.001600000075995922, 'h': 0.0022499999031424522,
                 'y': 0.0002809999859891832}
# A batched candidate's final losses against its run alone (api.train):
# the same f32 math, each candidate's sums taken on its own, over 30
# epochs.
TUNE_ALONE_RTOL = 1e-4
# search_rho on GoogleStock under ADMMConfig.auto(hidden_size=10) (the
# Jacobi sweep, the exact weight solve, adaptive rho), the same 27-point
# grid, 30 epochs from the golden seed-0 weights: the JAX package's
# validation loss of each candidate in grid order and its best rho, on the
# CPU (tests/test_torch_chip_reference.py recomputes them), from
#   admm_lstm_tpu.tune.search_rho(tx, ty, vx, vy, ps,
#       config=ADMMConfig.auto(hidden_size=10), epochs=30,
#       params=params_from_dict(weights))
# The JAX package gives the same numbers at matmul_precision='highest':
# on the CPU its 'default' rounds none of this search's products.
AUTO_TUNE_VAL = [
    0.04735095798969269, 0.1228584423661232, 0.15686146914958954,
    0.047054924070835114, 0.12196779996156693, 0.15705639123916626,
    0.04700392484664917, 0.12112602591514587, 0.16531431674957275,
    0.04722283035516739, 0.12238738685846329, 0.1568385362625122,
    0.046954866498708725, 0.12124113738536835, 0.1658669114112854,
    0.04692425951361656, 0.12049438059329987, 0.1560508906841278,
    0.047269247472286224, 0.12229488790035248, 0.1566346287727356,
    0.046952612698078156, 0.12114463001489639, 0.15649932622909546,
    0.04692353680729866, 0.12029732018709183, 0.13875065743923187,
]
AUTO_TUNE_BEST_RHO = {'i': 1.0, 'f': 1.0, 'g': 1.0, 'o': 1.0,
                      'c': 0.04000000283122063, 'h': 0.0022499999031424522,
                      'y': 1.1240000276302453e-05}
# The CLI's rho search under --auto: one round of refine_rho, 125
# candidates, as one batched program.
CLI_TUNE_ARGS = ['-y', '-d', 'GoogleStock', '-e', '30', '--hidden', '10',
                 '--auto', '--tune_rho', '1', '--no-plot']
# Path B on the candidate axis: three rows of the HAR rho grid
# (tune.candidate_grid(parameter_set('HAR')), rows 0, 13 and 26) through
# search_rho at 'highest', PATH_B_CANDIDATE_EPOCHS epochs, each held to
# its api.train run alone at HAR_RTOL.
PATH_B_CANDIDATE_ROWS = [0, 13, 26]
PATH_B_CANDIDATE_EPOCHS = 2
# The resume phase: YahooFinance, the default config, RESUME_EPOCHS
# epochs straight through against RESUME_AT epochs checkpointed and the
# rest resumed; equal bit for bit.
RESUME_EPOCHS = 10
RESUME_AT = 5

# The stacked phase: GoogleStock, ParameterSet 'Stacked', the default
# ADMMConfig, from the JAX package's init_stacked(PRNGKey(0), 1, hiddens,
# 1) written by its save_model.  The JAX package's train_stacked losses
# on the CPU (tests/test_torch_chip_reference.py recomputes them).
STACKED_RUNS = {(8, 8): 30, (8, 8, 8): 10}
STACKED_REF = {
    (8, 8): {
        'train': [
            0.10706058144569397, 0.1070604994893074, 0.10015132278203964,
            0.09359440207481384, 0.08748684823513031, 0.08179011195898056,
            0.07648826390504837, 0.07155147194862366, 0.0669587254524231,
            0.06268303841352463, 0.058696918189525604, 0.05497422441840172,
            0.0514916367828846, 0.04822932183742523, 0.045170705765485764,
            0.04230232164263725, 0.03961293399333954, 0.0370929129421711,
            0.03473351150751114, 0.032526347786188126, 0.030463147908449173,
            0.028535518795251846, 0.02673514187335968, 0.02505369670689106,
            0.023483116179704666, 0.022015679627656937, 0.020644158124923706,
            0.0193618293851614, 0.01816256158053875, 0.017040742561221123,
            0.015991242602467537],
        'val': [
            0.9721859693527222, 0.9721853733062744, 0.9202564358711243,
            0.8706773519515991, 0.8241967558860779, 0.7805615067481995,
            0.7396746277809143, 0.7013418674468994, 0.6654263138771057,
            0.6317467093467712, 0.6001145243644714, 0.5703485012054443,
            0.5422863364219666, 0.5157903432846069, 0.4907470941543579,
            0.4670657813549042, 0.4446724057197571, 0.4235052168369293,
            0.40350836515426636, 0.3846287429332733, 0.3668125569820404,
            0.3500048518180847, 0.33414947986602783, 0.31918978691101074,
            0.30506980419158936, 0.29173552989959717, 0.27913621068000793,
            0.26722440123558044, 0.25595682859420776, 0.24529391527175903,
            0.23519982397556305]},
    (8, 8, 8): {
        'train': [
            0.08657856285572052, 0.08657851815223694, 0.08324644714593887,
            0.08001305907964706, 0.07690317183732986, 0.07391607761383057,
            0.0710688978433609, 0.0683407261967659, 0.06572727113962173,
            0.06322450190782547, 0.06082547828555107],
        'val': [
            0.8336588740348816, 0.8336585164070129, 0.8077966570854187,
            0.7825925946235657, 0.7582501769065857, 0.7347723245620728,
            0.7123061418533325, 0.6906901001930237, 0.669895350933075,
            0.6498956084251404, 0.6306410431861877]},
}
# train_best_stacked at (8, 8): epochs, probe_epochs, search_rounds; the
# JAX package's choice, tuned rho (z re-attached), probe losses and the
# committed run's best validation loss.
STACKED_BEST_ARGS = dict(epochs=60, probe_epochs=30, search_rounds=1)
STACKED_BEST_CHOICE = 'tuned'
STACKED_BEST_RHO = {'i': 1.0, 'f': 1.0, 'g': 1.0, 'o': 1.0, 'c': 1.0,
                    'h': 20.0, 'y': 0.30000001192092896, 'z': 1.0}
STACKED_BEST_PROBE_VAL = {'shipped': 0.23519982397556305,
                          'tuned': 0.23450247943401337}
STACKED_BEST_VAL = 0.08602779358625412
# One (8, 8) epoch with the Cholesky kernel against its plain version,
# each leaf within STACKED_RTOL of its scale (as Path B's).
STACKED_RTOL = 1e-5
# The stacked search on the candidate axis: the first round of
# refine_rho_stacked inside train_best_stacked at (8, 8) (the 27 points
# of the 'Stacked' tuning's c, h, y times 1/STACKED_SEARCH_SPAN, 1 and
# STACKED_SEARCH_SPAN, STACKED_BEST_ARGS['probe_epochs'] epochs each) as
# one batched program; the JAX package's validation losses of those 27
# candidates in grid order (tests/test_torch_chip_reference.py recomputes
# them from the search its train_best_stacked runs).
STACKED_SEARCH_SPAN = 10.0
STACKED_SEARCH_VAL = [
    0.23869138956069946, 0.2458040863275528, 0.4784441292285919,
    0.2385474443435669, 0.23530346155166626, 0.24950094521045685,
    0.23851503431797028, 0.23453059792518616, 0.23543818295001984,
    0.2388378381729126, 0.24084797501564026, 0.31704288721084595,
    0.23855043947696686, 0.23519983887672424, 0.24162614345550537,
    0.23851488530635834, 0.2345220446586609, 0.23524640500545502,
    0.23874567449092865, 0.23890259861946106, 0.2852528989315033,
    0.23853909969329834, 0.23499101400375366, 0.23983517289161682,
    0.2385137975215912, 0.23450253903865814, 0.23505695164203644]
# Each candidate of the batched search against its train_stacked run
# alone on the card, relative: the same f32 math with batched products.
STACKED_ALONE_RTOL = 1e-5
# rho_z of each candidate in the search's second run (z_candidates),
# and the candidates of that run held to their runs alone: each rho_z and
# the winner (the whole grid alone is timed once, in the first run).
STACKED_SEARCH_Z = (0.5, 1.0, 2.0)
STACKED_Z_ALONE = (0, 1, 2, 25)

# The legacy phase: ADMM-LSTM-L and -S, the gradient baselines and the
# comparison harness on GoogleStock at the CLI's width (H 10, seed 0).
# The JAX package's numbers on the CPU (admm_l_demo's LEGACY_EPOCHS-epoch
# losses, train_best's choice and probe losses with LEGACY_BEST_ARGS, the
# baselines' GRAD_EPOCHS-epoch losses from the golden seed-0 weights) are
# in LEGACY_REF, which tests/test_torch_chip_reference_legacy.py
# recomputes with the JAX package and holds equal.
LEGACY_REF = os.path.join(ROOT, 'tests', 'golden',
                          'torch_legacy_reference.npz')
LEGACY_EPOCHS = 30
LEGACY_BEST_ARGS = dict(epochs=60, probe_epochs=15)
GRAD_EPOCHS = 100
ADMM_L_GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'admm_l_small.npz')
ADMM_S_GOLDEN = os.path.join(ROOT, 'tests', 'golden',
                             'admm_s_googlestock.npz')
# run_comparison's curves against the same runs alone, relative.
COMPARISON_RTOL = 1e-6
# One legacy epoch on the card against the same epoch on the CPU: each
# leaf within LEGACY_RTOL of its scale (as Path B's).
LEGACY_RTOL = 1e-5
# The sharded phase: each rank a process; its runs are held to one
# process's at this relative tolerance (the order of the all-reduced sums
# differs), and every rendezvous, collective and join is bounded.
SHARDED_RTOL = 1e-4
SHARDED_TIMEOUT = 300

# The seqpar phase: the JAX package's long-T bench shape
# (benchmarks/bench_longseq.py:54, B 256, T 512, H 16), Jacobi with the
# prox-linear weight stage, time-sharded over two gloo ranks on the one
# card (257 and 256 of the 513 rows).  The tp phase: Path B's shape at
# 'highest' on a (1, 2) mesh, H over 'model', and slice 1's GoogleStock
# default config (Gauss-Seidel, H 10: 5 a rank) on the same mesh.  Each
# is held to one process on the card: losses at LAYOUT_RTOL relative,
# each weight leaf within LAYOUT_RTOL of its largest |value|.
SEQPAR_SHAPE = dict(batch=256, seq_len=512, input_size=2, output_size=1,
                    val_batch=32)
SEQPAR_HIDDEN = 16
SEQPAR_EPOCHS = 10
TP_EPOCHS = 5
LAYOUT_RTOL = 1e-4

# The scenarios phase: the CLI's --scenarios 4 config on YahooFinance
# (load_scenarios(4, seed=0): 4 x 340 train, 4 x 85 val windows, T 60),
# fast, H 10, wy_lipschitz, from the JAX package's seed-split inits
# (tests/golden/torch_scenarios_init_s4.npz, jax.vmap(init_lstm_params)
# over jax.random.split(PRNGKey(0), 4)).  SCEN_TRAIN and SCEN_VAL are the
# JAX package's train_scenarios losses on the CPU, which
# tests/test_torch_scenarios.py recomputes and holds equal.
SCEN_INIT = os.path.join(ROOT, 'tests', 'golden',
                         'torch_scenarios_init_s4.npz')
SCEN_COUNT = 4
SCEN_EPOCHS = 30
SCEN_TRAIN = [
    [0.196306616, 0.196306661, 0.0805211514, 0.033461526, 0.0142689748,
     0.0064078914, 0.00317116594, 0.0018308193, 0.00127229188, 0.00103793759,
     0.000939529738, 0.000897268765, 0.000878218794, 0.000868317496,
     0.000861498702, 0.000855261285, 0.000848847209, 0.000842487905,
     0.000837092404, 0.000834175968, 0.000835969986, 0.000845763483,
     0.000868576404, 0.000912349322, 0.00138103031, 0.00144296105,
     0.00135697168, 0.00124020362, 0.00109819847, 0.000940299826,
     0.000780815142],
    [0.0867725313, 0.0867725313, 0.0619360209, 0.0453863628, 0.0341552198,
     0.0263796113, 0.0208114255, 0.0166282337, 0.0133051537, 0.0105372649,
     0.0081714429, 0.00614568871, 0.00444202917, 0.00305553083,
     0.00197729794, 0.00118738937, 0.000653940486, 0.000335824618,
     0.000186933365, 0.000160695839, 0.000213958308, 0.000309725467,
     0.000418648531, 0.000519395864, 0.000598171493, 0.000647704641,
     0.000665971718, 0.000654878328, 0.000619020429, 0.000564598187,
     0.000498503738],
    [0.254044533, 0.254044533, 0.13373515, 0.0716121718, 0.039200861,
     0.0221489109, 0.0130227963, 0.00799376797, 0.00510757742, 0.00337615609,
     0.00230042613, 0.00162276474, 0.00120174175, 0.000950320857,
     0.000808207958, 0.000730128551, 0.000682997168, 0.000646928384,
     0.000617399754, 0.000606660906, 0.000643186679, 0.00076854619,
     0.00103158131, 0.00148031593, 0.00215268461, 0.00306794886,
     0.00422133133, 0.942177892, 0.553848624, 0.216870636, 0.268112421],
    [0.342788756, 0.342788756, 0.142918304, 0.0600814223, 0.0255444143,
     0.0110664573, 0.00495523447, 0.00235020183, 0.00122434238,
     0.000730005268, 0.000510563492, 0.000413719885, 0.000372584211,
     0.00035631904, 0.000352495816, 0.000353524869, 0.000355582277,
     0.000356873556, 0.000356796663, 0.000355457771, 0.000353336742,
     0.000351028604, 0.000350051792, 0.000349727459, 0.000350133429,
     0.000351371185, 0.000353383628, 0.000356323639, 0.000360535836,
     0.000366545835, 0.000374986208],
]
SCEN_VAL = [
    [0.218268707, 0.218268722, 0.0906208232, 0.038417425, 0.0169225316,
     0.0079882713, 0.00422654208, 0.0026153822, 0.00190939626, 0.00159046834,
     0.0014416246, 0.00136799924, 0.00132901326, 0.00130650343,
     0.00129214243, 0.00128214061, 0.00127498177, 0.00127043191,
     0.00126911898, 0.00127242215, 0.00128257868, 0.00130306429,
     0.00133933104, 0.00140011974, 0.00199196348, 0.00206194702,
     0.00194499537, 0.00178958953, 0.00160224969, 0.00139404356,
     0.00118155626],
    [0.0841195658, 0.0841195658, 0.0600960478, 0.0440807305, 0.033206936,
     0.0256751776, 0.0202789512, 0.0162228085, 0.0129987625, 0.0103115086,
     0.00801264308, 0.0060420502, 0.00438235234, 0.00302890618,
     0.00197332911, 0.00119661109, 0.000668241002, 0.000348743313,
     0.000193800079, 0.000158599345, 0.000201576346, 0.000287058792,
     0.000386708067, 0.000479883107, 0.000553184829, 0.000599486055,
     0.000616710924, 0.000606563233, 0.000573341444, 0.00052289298,
     0.000461732125],
    [0.260691494, 0.260691494, 0.13714917, 0.0733709335, 0.0401057079,
     0.0226110015, 0.0132524511, 0.00809859205, 0.00514324615, 0.00337240915,
     0.00227408763, 0.00158407004, 0.00115730357, 0.00090446457,
     0.000763572869, 0.000687961234, 0.000643367413, 0.000608947244,
     0.000579463376, 0.000566678238, 0.000598739542, 0.000716938346,
     0.000969798188, 0.00140499603, 0.00206026924, 0.00295513426,
     0.00408576149, 0.960106552, 0.527527034, 0.233650982, 0.285014898],
    [0.363435149, 0.363435119, 0.151115268, 0.0632290989, 0.0266564433,
     0.0113696046, 0.00494549051, 0.0022255145, 0.00106205838,
     0.000559368753, 0.000341982697, 0.000250348792, 0.000214820684,
     0.000203711941, 0.000204192722, 0.000208547062, 0.00021293707,
     0.000215626336, 0.000216117434, 0.000214656538, 0.000211885752,
     0.000208569807, 0.000206581375, 0.000205277553, 0.000204792537,
     0.000205094155, 0.000206294702, 0.000208553989, 0.000212203275,
     0.000217734501, 0.000225717973],
]
# How the card's trajectories are held to SCEN_*.  These runs amplify f32
# rounding: on the CPU the port and the JAX package agree within 2.7e-6
# (val) over one epoch from the same state, yet their 30-epoch runs part by
# up to 9.0e-4 relative before a jump (scenario 0; on the card 1.74e-3),
# and the JAX package's own vmapped and one-scenario programs
# part by 2.6% after scenario 2's jump.  So epochs 0..SCEN_STRICT_EPOCHS
# are held at SCEN_RTOL and every epoch before a jump at SCEN_HELD_RTOL
# (no absolute term: the late losses are 1e-4..1e-3); a scenario whose JAX
# validation loss jumps above SCEN_JUMP at an epoch >= SCEN_JUMP_FROM
# (scenario 2, at 27) must jump there too, its values after the jump not
# held.  The same batched run with TF32 matmuls (matmul_precision='high')
# must fail the hold.  SCEN_STRICT_EPOCHS sits between the two: at full
# precision the first epoch past SCEN_RTOL is 17 or later on the H100 and
# 20 or later on the CPU, with TF32 it is 11 for scenario 2 on the H100.
SCEN_RTOL = 1e-4
SCEN_STRICT_EPOCHS = 13
SCEN_HELD_RTOL = 1e-2
SCEN_JUMP = 0.1
SCEN_JUMP_FROM = 27
# The JAX bench's yahoo_scenarios_loose (bench.py:316-370): 4 unshuffled
# folds of the YahooFinance training windows (340 each), no_dual_y,
# wy_lipschitz, 200 epochs.
SCEN_SPEED_EPOCHS = 200
# The same run's scenario-epochs/s with the scenarios one after another
# (before the candidate axis), the lowest and highest of the chip runs in
# PERF.md on H100 80GB HBM3 at 700 W, for the line beside the batched
# program's.
SCEN_SPEED_BEFORE = (24.2, 40.0)
# The scenario batch under turbo(): the four yahoo_scenarios_loose folds
# under ADMMConfig.turbo(variant='no_dual_y', matmul_precision='highest')
# with that bench's wy_lipschitz (without it no_dual_y's fixed readout
# step diverges there within four epochs), H 10, SCEN_TURBO_EPOCHS epochs
# from api.scenario_inits(0), one jacobi_sweep launch an epoch; each
# scenario's losses finite and held to its api.train run alone at
# SCEN_TURBO_RTOL relative.  Ten epochs stay inside the window where the
# scenario runs are rounding-stable (SCEN_STRICT_EPOCHS).
SCEN_TURBO_EPOCHS = 10
SCEN_TURBO_RTOL = 1e-4


def log(msg):
    print(msg, flush=True)


def numpy_weights(input_size, hidden, output_size, seed):
    """Xavier-normal weights from numpy's default_rng(seed), as the
    {'x2i', ..., 'h2o', 'wy'} arrays `params_from_dict` takes; both
    packages start from the same numbers."""
    rng = np.random.default_rng(seed)

    def xavier(fan_in, fan_out):
        std = (2.0 / (fan_in + fan_out)) ** 0.5
        return (std * rng.standard_normal((fan_in, fan_out))).astype(
            np.float32)

    w = {f'x2{g}': xavier(input_size, hidden) for g in 'ifgo'}
    w.update({f'h2{g}': xavier(hidden, hidden) for g in 'ifgo'})
    w['wy'] = xavier(hidden, output_size)
    return w


def cuda_ms(fn, reps, flush):
    """Median device ms of `fn` over `reps` runs, each timed with CUDA
    events after overwriting a buffer larger than the 50 MB L2 cache
    (`flush`; None times it warm, after the same call).  A
    spin of ~0.5 ms on the device before the start event lets the host
    enqueue `fn`'s launches before the clock starts, so a kernel's time
    excludes its Python wrapper; a plain version that launches many small
    kernels still pays its host time between them."""
    times = []
    for _ in range(reps):
        if flush is None:
            fn()
        else:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the FP32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def sweep_bound(steps, hidden, batch):
    """One interior sweep.  Bytes: the inputs the sweep reads (4 xproj
    gates, old f, g, c, h, 6 duals; old i and o do not enter the math), wh
    and rho once, the 11 outputs once.  Operations: 8H per element and
    step for the four recurrent dot products plus 105 for the closed
    forms, activations and duals (a transcendental counts as one)."""
    elems = steps * hidden * batch
    return bound(4 * (elems * (14 + 11) + 4 * hidden * hidden + 6),
                 elems * (8 * hidden + 105))


def floor_bound(steps, hidden, batch):
    """One floor sweep.  Bytes: the 4 xproj gates read once, h written
    once, wh once.  Operations: 8H per element and step for the recurrent
    product plus FLOOR_OPS."""
    elems = steps * hidden * batch
    return bound(4 * (elems * 5 + 4 * hidden * hidden),
                 elems * (8 * hidden + FLOOR_OPS))


def jacobi_bytes(steps, hidden, batch, cands=1):
    """The bytes `cands` Jacobi sweeps must move: 15 input slabs each (4
    pre gates, old f, g, c, h, 6 duals, c_prev; h_prev is already inside
    pre and old i and o do not enter the math), rho, 11 output slabs."""
    return 4 * cands * (steps * hidden * batch * (15 + 11) + 6)


def jacobi_bound(steps, hidden, batch, cands=1):
    """`cands` Jacobi sweeps: `jacobi_bytes`, and 105 operations per
    element."""
    return bound(jacobi_bytes(steps, hidden, batch, cands),
                 cands * steps * hidden * batch * 105)


def theta_bound(shape, k=THETA_K):
    """One block of k theta tests over slabs `shape` ([S,] T, 4H, B).
    Bytes: pre, grad_proj and the targets read once (the thetas and the
    table are a few hundred bytes).  Operations: THETA_OPS per element
    and theta."""
    elems = int(np.prod(shape))
    return bound(4 * 3 * elems, elems * k * THETA_OPS)


def stacked_sweep_bound(cands, steps, hiddens, batch):
    """One stacked sweep launch and its bounds' passes.  Bytes, per t,
    candidate and column: layer 0 reads 10 rows of H_0 (old f, g, c, h, 6
    duals), an upper layer 20 of H_k (old i, f, g, o, c, h, 6 duals, 4 z,
    4 z duals) and its bounds' pass 12 (i, f, g, o, their duals, 4 z);
    for t = 0..T layer 0 writes 11 rows (6 gates, 5 duals) and an upper
    layer 19 (and 4 z, 4 z duals).  Operations: the products' 2 x
    multiply-adds per column and step (x wx_0, wh_k h, wx_k h below, the
    solve's wx_{k+1} tgt and M_k^-1 rhs); the closed forms left out."""
    upper = sum(hiddens[1:])
    rows = (steps * (10 * hiddens[0] + 32 * upper)
            + (steps + 1) * (11 * hiddens[0] + 19 * upper))
    macs = 4 * hiddens[0] * (1 + hiddens[0])
    for k in range(1, len(hiddens)):
        macs += 4 * hiddens[k] * (hiddens[k - 1] + hiddens[k])
        macs += 4 * hiddens[k] * hiddens[k - 1] + hiddens[k - 1] ** 2
    return bound(4 * (cands or 1) * batch * rows,
                 2 * (cands or 1) * batch * steps * macs)


def solve_bound(n, dim):
    """N SPD solves.  Bytes: the lower triangle of a (all the function
    reads of it), b and x once.  Operations: D^3/3 for the factorization
    and D^2 for each substitution, per system."""
    return bound(4 * n * (dim * (dim + 1) // 2 + 2 * dim),
                 n * (dim ** 3 / 3 + 2 * dim * dim))


def inverse_bound(n, dim):
    """N factorizations and triangular inverses.  Bytes: the lower
    triangle of a once and all of L^-1 (zeros above the diagonal
    included) once.  Operations: c^3/3 for the factorization and c^3/3
    for L X = I."""
    return bound(4 * n * (dim * (dim + 1) // 2 + dim * dim),
                 n * 2 * dim ** 3 / 3)


def _rand(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).cuda()


def sweep_inputs(steps, hidden, batch, seed, jacobi=False):
    gen = torch.Generator().manual_seed(seed)
    proj = _rand(gen, steps, 4, hidden, batch, scale=0.3)
    wh = _rand(gen, 4, hidden, hidden,
               scale=0.3 / max(1.0, (hidden / 10) ** 0.5))
    gates = tuple(_rand(gen, steps, hidden, batch, scale=0.2)
                  for _ in range(6))
    duals = tuple(_rand(gen, steps, hidden, batch, scale=s)
                  for s in (0.01,) * 5 + (1e-4,))
    rho = torch.tensor([1., 1., 1., 1., 0.008, 0.00045], device='cuda')
    if jacobi:
        h_prev, c_prev = (_rand(gen, steps, hidden, batch, scale=0.2)
                          for _ in range(2))
        return proj, gates, duals, h_prev, c_prev, rho
    return proj, wh, gates, duals, rho


def floor_inputs(steps, hidden, batch, seed):
    """xproj and wh of floor_sweep, at sweep_inputs' scales."""
    gen = torch.Generator().manual_seed(seed)
    return (_rand(gen, steps, 4, hidden, batch, scale=0.3),
            _rand(gen, 4, hidden, hidden,
                  scale=0.3 / max(1.0, (hidden / 10) ** 0.5)))


def spd_inputs(n, dim, seed):
    """M M^T + D I from a seeded generator, as the JAX package's tests make
    them, and a right-hand side."""
    gen = torch.Generator().manual_seed(seed)
    m = torch.randn((n, dim, dim), generator=gen)
    a = m @ m.transpose(1, 2) + dim * torch.eye(dim)
    return a.cuda(), torch.randn((n, dim), generator=gen).cuda()


def gram_inputs(n, dim, kappa, seed):
    """Gram-like SPD systems X^T X + lambda I with condition number kappa
    (1 at D = 1), as float32 CPU tensors, and a right-hand side.  X = Q1
    diag(s) Q2^T with random orthogonal Q1, Q2 and s^2 log-spaced from 1
    down to 1/kappa, lambda = 1e-3 / kappa; formed in float64, symmetrized,
    then rounded to float32."""
    gen = torch.Generator().manual_seed(seed)
    q1, _ = torch.linalg.qr(torch.randn((n, dim, dim), generator=gen,
                                        dtype=torch.float64))
    q2, _ = torch.linalg.qr(torch.randn((n, dim, dim), generator=gen,
                                        dtype=torch.float64))
    s2 = torch.logspace(0.0, -np.log10(kappa), dim, dtype=torch.float64)
    x = q1 * s2.sqrt() @ q2.transpose(1, 2)
    a = x.transpose(1, 2) @ x + 1e-3 / kappa * torch.eye(dim,
                                                         dtype=torch.float64)
    a = (a + a.transpose(1, 2)) / 2
    return (a.float().contiguous(),
            torch.randn((n, dim), generator=gen).contiguous())


def reference_f64(a, b=None):
    """a^-1 b (b given) or L^-1 with a = L L^T, in float64 from float32
    a, b, as a float64 tensor."""
    low = torch.linalg.cholesky(a.double())
    if b is not None:
        return torch.cholesky_solve(b.double()[..., None], low)[..., 0]
    eye = torch.eye(a.shape[-1], dtype=torch.float64,
                    device=a.device).expand_as(low)
    return torch.linalg.solve_triangular(low, eye, upper=False)


def _flat(out):
    return out[0] + out[1] if isinstance(out, tuple) else (out,)


def kernel_row(name, shape, kernel, plain, library, tol, bound_ms_by, flush,
               extra_check=None, two_call=None, info=None):
    """Runs one comparison and the timings (`two_call`: a yardstick of two
    PyTorch calls); raises on disagreement."""
    got, want = _flat(kernel()), _flat(plain())
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ms = cuda_ms(kernel, 50, flush)
    plain_ms = cuda_ms(plain, 5, flush)
    library_ms = cuda_ms(library, 20, flush) if library else None
    row = dict(shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1],
               library_ms=library_ms)
    if two_call is not None:
        row['two_call_ms'] = cuda_ms(two_call, 20, flush)
        row['warm_ms'] = cuda_ms(kernel, 50, None)
    if info is not None:
        row.update(info)
    log(f'[kernels] {name} {row}')
    if not finite or not err <= tol:
        raise AssertionError(f'{name} disagrees with its plain version at '
                             f'{list(shape)}: max abs err {err} (atol {tol}),'
                             f' finite {finite}')
    if extra_check is not None:
        extra_check(got)
    return row


KERNEL_NAMES = ('warp_chol_kernel', 'blocked_solve_kernel',
                'blocked_inverse_kernel', 'interior_sweep_kernel',
                'jacobi_sweep_kernel', 'floor_sweep_kernel',
                'floor_warp_kernel', 'theta_tests_kernel',
                'stacked_sweep_kernel', 'stacked_resmax_kernel',
                'exact_gram_kernel', 'exact_gram_reduce_kernel')


def ptxas_summary(out):
    """{kernel<template args>: {regs, spill_stores, spill_loads}} from an
    nvcc -Xptxas -v log."""
    summary, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search('(' + '|'.join(KERNEL_NAMES) + r')(I\w*?E)?E',
                          m.group(1))
            name = m.group(1) if k is None else k.group(1) + (
                '<' + ','.join(re.findall(r'L[ib](\d+)E', k.group(2) or ''))
                + '>' if k.group(2) else '')
            summary[name] = {}
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name:
            summary[name].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            summary[name]['regs'] = int(m.group(1))
    return summary


def phase_build():
    """Builds every source and returns every kernel's registers and spills
    ({} for a library built before this run)."""
    from admm_lstm_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all(['gate_sweep', 'cholesky', 'theta_tests',
                     'stacked_sweep', 'exact_gram'])
    log(f'[build] gate_sweep.cu, cholesky.cu, theta_tests.cu, '
        f'stacked_sweep.cu and exact_gram.cu built in '
        f'{time.perf_counter() - t0:.2f} s')
    summary = {}
    for name, out in build.build_logs.items():
        for line in out.strip().splitlines():
            log(f'[build] {name}: {line}')
        summary.update(ptxas_summary(out))
        log(f'[build] {name} registers and spills per kernel: '
            f'{json.dumps(ptxas_summary(out))}')
    return summary


def chol_kernel_info(dim, solve):
    """Registers per thread, local (spill) bytes per thread and systems
    resident per SM of the Cholesky kernel that takes width dim, from the
    CUDA runtime."""
    from admm_lstm_torch.kernels.build import load_library
    fn = load_library('cholesky').cholesky_kernel_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    regs, local, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(dim, int(solve), ctypes.byref(regs), ctypes.byref(local),
             ctypes.byref(per_sm))
    if err:
        raise RuntimeError(f'cholesky_kernel_info: CUDA error {err}')
    return dict(regs=regs.value, local_bytes=local.value,
                systems_per_sm=per_sm.value)


def ill_row(name, shape, kappa, seed, kernel, plain):
    """Gate (ii): kernel and plain version against float64 on Gram-like
    inputs of condition number kappa; raises if the kernel's error exceeds
    ILL_REL times the plain version's plus ILL_ABS max |reference|."""
    a, b = gram_inputs(*shape, kappa, seed)
    args = (a, b) if name == 'chol_solve' else (a,)
    ref = reference_f64(*args).cuda()
    args = tuple(t.cuda() for t in args)
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    dims = tuple(range(1, ref.dim()))
    errs = (got.double() - ref).abs().amax(dims)
    plain_errs = (want.double() - ref).abs().amax(dims)
    err, plain_err = float(errs.max()), float(plain_errs.max())
    limit = ILL_REL * plain_err + ILL_ABS * float(ref.abs().max())
    row = dict(shape=list(shape), kappa=kappa, err=err, plain_err=plain_err,
               limit=limit, ratio=err / plain_err if plain_err else None,
               median_system_ratio=float((errs / plain_errs).median())
               if bool((plain_errs > 0).all()) else None)
    log(f'[kernels] {name} ill-conditioned {row}')
    if not err <= limit:
        raise AssertionError(f'{name} at {list(shape)}, kappa {kappa}: error '
                             f'{err} against float64 above {limit} (plain '
                             f'version {plain_err})')
    return row


def jacobi_row(shape, seed, flush, ptxas):
    """The Jacobi kernel at one shape: against its plain version, timed L2
    flushed and warm (`warm_ms`, the L2-resident time an epoch at
    GoogleStock sees), beside `copy_ms` (one device copy of 13 slabs into
    13 others: the same bytes, a yardstick of the rate the card reaches,
    not the same function); its plan, achieved GB/s, and the registers and
    spills of the instance the plan takes.  Where the plan takes float4s,
    the V = 1 instance on the same inputs must give identical bits
    (`vec1_ms`: its time)."""
    from admm_lstm_torch.kernels import gate_sweep as gs
    args = sweep_inputs(*shape, seed=seed, jacobi=True)
    pre, gates, duals, _, c_prev, _ = args
    plan = gs.tensor_jacobi_plan(pre, gates, duals, c_prev)
    instance = gs.jacobi_occupancy(torch.device('cuda'), plan.vec)
    instance.update(ptxas.get(f'jacobi_sweep_kernel<{plan.vec}>', {}))
    row = kernel_row('jacobi_sweep', shape, lambda: gs.jacobi_sweep(*args),
                     lambda: gs.jacobi_sweep_plain(*args), None, KERNEL_ATOL,
                     jacobi_bound(*shape), flush,
                     info=dict(plan=plan._asdict(), **instance))
    src = torch.empty(13 * int(np.prod(shape)), device='cuda')
    dst = torch.empty_like(src)
    row['warm_ms'] = cuda_ms(lambda: gs.jacobi_sweep(*args), 50, None)
    row['copy_ms'] = cuda_ms(lambda: dst.copy_(src), 50, flush)
    row['gb_per_s'] = jacobi_bytes(*shape) / row['ms'] / 1e6
    if plan.vec == 4:
        one = gs.card_jacobi_plan(torch.device('cuda'), *shape, False)
        got = _flat(gs.jacobi_sweep(*args, plan=one))
        want = _flat(gs.jacobi_sweep(*args))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f'jacobi_sweep at {list(shape)}: the V = 1 '
                                 f'instance differs from V = 4')
        row['vec1_plan'] = one._asdict()
        row['vec1_ms'] = cuda_ms(lambda: gs.jacobi_sweep(*args, plan=one),
                                 50, flush)
    log(f'[kernels] jacobi_sweep {list(shape)} plan {row["plan"]}, regs '
        f'{row["regs"]}, local bytes {row["local_bytes"]}, ms {row["ms"]}, '
        f'warm_ms {row["warm_ms"]}, copy_ms {row["copy_ms"]}, '
        f'{row["gb_per_s"]:.0f} GB/s (bound {row["bound_ms"]} ms), vec1_ms '
        f'{row.get("vec1_ms")}')
    return row


def candidate_inputs(cands, steps, hidden, batch, seed):
    """S candidates' sweep inputs at sweep_inputs' scales, rho differing
    per candidate; the 12 slabs are rows 1..steps of (S, steps + 2, H, B)
    tensors and xproj the first steps rows of an (S, steps + 1, 4, H, B)
    one, as the epoch slices them."""
    per = [sweep_inputs(steps, hidden, batch, seed + s) for s in range(cands)]

    def in_state(k):
        full = torch.zeros((cands, steps + 2, hidden, batch), device='cuda')
        full[:, 1:-1] = torch.stack([(p[2] + p[3])[k] for p in per])
        return full[:, 1:-1]

    slabs = [in_state(k) for k in range(12)]
    rho = torch.stack([p[4] * (1.0 + 0.25 * s) for s, p in enumerate(per)])
    xfull = torch.zeros((cands, steps + 1, 4, hidden, batch), device='cuda')
    xfull[:, :-1] = torch.stack([p[0] for p in per])
    return (xfull[:, :-1],
            torch.stack([p[1] for p in per]), tuple(slabs[:6]),
            tuple(slabs[6:]), rho)


def candidate_row(shape, seed, flush, ptxas):
    """interior_sweep with the candidate axis at (S, steps, H, B): held to
    its plain version, and to S launches without the axis (bit-equal where
    the plan's tiles, rows and wh split are those of one candidate, else
    at KERNEL_ATOL); timed L2 flushed beside its bound (S times one
    sweep's), the plain version and the S launches alone (`alone_ms`);
    its plan and the registers and spills of the instance it takes."""
    from admm_lstm_torch.kernels import gate_sweep as gs
    cands, steps, hidden, batch = shape
    args = candidate_inputs(*shape, seed)
    plan = gs.card_sweep_plan(torch.device('cuda'), hidden, batch, cands)
    one = gs.card_sweep_plan(torch.device('cuda'), hidden, batch)
    instance = (f'interior_sweep_kernel<{plan.rows},'
                f'{int(plan.resident < hidden)}>')
    bound_ms, bound_by = sweep_bound(steps, hidden, batch)
    xproj, wh, gates, duals, rho = args
    alone_args = [(xproj[s].contiguous(), wh[s],
                   tuple(g[s].contiguous() for g in gates),
                   tuple(d[s].contiguous() for d in duals), rho[s])
                  for s in range(cands)]

    def alone():
        return [gs.interior_sweep(*a) for a in alone_args]

    row = kernel_row('interior_sweep[candidates]', shape,
                     lambda: gs.interior_sweep(*args),
                     lambda: gs.interior_sweep_plain(*args), None,
                     KERNEL_ATOL, (cands * bound_ms, bound_by), flush,
                     info=dict(plan=plan._asdict(), alone_plan=one._asdict(),
                               instance=instance, **ptxas.get(instance, {})))
    got = _flat(gs.interior_sweep(*args))
    same = plan._replace(grid=0) == one._replace(grid=0)
    err = 0.0
    for s, want in enumerate(alone()):
        for a, b in zip(got, _flat(want)):
            if same and not torch.equal(a[s], b):
                raise AssertionError(f'interior_sweep[candidates] at {shape}:'
                                     f' candidate {s} differs from its launch'
                                     f' alone on the same plan')
            err = max(err, float((a[s] - b).abs().max()))
    if not err <= KERNEL_ATOL:
        raise AssertionError(f'interior_sweep[candidates] at {shape}: '
                             f'{err} from the launches alone')
    row['alone_max_abs_err'] = err
    row['alone_bit_equal'] = same
    row['alone_ms'] = cuda_ms(alone, 20, flush)
    log(f'[kernels] interior_sweep[candidates] {list(shape)} plan '
        f'{row["plan"]} (alone {row["alone_plan"]}), {instance} '
        f'{ptxas.get(instance)}, ms {row["ms"]}, {cands} launches alone '
        f'{row["alone_ms"]}, bound {row["bound_ms"]}, against the launches '
        f'alone {"bit-equal" if same else err}')
    return row


def jacobi_candidate_inputs(cands, steps, hidden, batch, seed):
    """S candidates' Jacobi sweep inputs at sweep_inputs' scales, rho
    differing per candidate, placed as the epoch places them: pre a
    contiguous (S, steps, 4, H, B); the 12 slabs rows 1..steps and h_prev,
    c_prev rows 0..steps-1 of (S, steps + 2, H, B) tensors (one candidate
    stride, as slices of the state's (S, T+1, H, B) slabs)."""
    per = [sweep_inputs(steps, hidden, batch, seed + s, jacobi=True)
           for s in range(cands)]

    def in_state(tensors, first):
        full = torch.zeros((cands, steps + 2, hidden, batch), device='cuda')
        full[:, first:first + steps] = torch.stack(tensors)
        return full[:, first:first + steps]

    gates = tuple(in_state([p[1][k] for p in per], 1) for k in range(6))
    duals = tuple(in_state([p[2][k] for p in per], 1) for k in range(6))
    rho = torch.stack([p[5] * (1.0 + 0.25 * s) for s, p in enumerate(per)])
    return (torch.stack([p[0] for p in per]), gates, duals,
            in_state([p[3] for p in per], 0),
            in_state([p[4] for p in per], 0), rho)


def jacobi_candidate_row(shape, seed, flush, ptxas):
    """jacobi_sweep with the candidate axis at (S, steps, H, B), one
    launch for all S: held to its plain version, and to S launches
    without the axis (bit-equal where the batched plan's float width is
    the one a candidate alone takes; the observed equality is logged
    either way); timed L2 flushed beside its byte bound (S sweeps' bytes),
    the plain version, the S launches alone (`alone_ms`) and a device copy
    of its bytes (`copy_ms`); its plan and the registers and spills of the
    instance it takes."""
    from admm_lstm_torch.kernels import gate_sweep as gs
    cands, steps, hidden, batch = shape
    args = jacobi_candidate_inputs(*shape, seed)
    pre, gates, duals, h_prev, c_prev, rho = args
    plan = gs.tensor_jacobi_plan(pre, gates, duals, c_prev)
    alone_args = [(pre[s], tuple(g[s].contiguous() for g in gates),
                   tuple(d[s].contiguous() for d in duals),
                   h_prev[s].contiguous(), c_prev[s].contiguous(), rho[s])
                  for s in range(cands)]
    first = alone_args[0]
    one = gs.tensor_jacobi_plan(first[0], first[1], first[2], first[4])
    instance = f'jacobi_sweep_kernel<{plan.vec}>'

    def alone():
        return [gs.jacobi_sweep(*a) for a in alone_args]

    row = kernel_row('jacobi_sweep[candidates]', shape,
                     lambda: gs.jacobi_sweep(*args),
                     lambda: gs.jacobi_sweep_plain(*args), None,
                     KERNEL_ATOL, jacobi_bound(steps, hidden, batch, cands),
                     flush, info=dict(plan=plan._asdict(),
                                      alone_plan=one._asdict(),
                                      instance=instance,
                                      **ptxas.get(instance, {})))
    got = _flat(gs.jacobi_sweep(*args))
    same_width = plan.vec == one.vec
    err, equal = 0.0, True
    for s, want in enumerate(alone()):
        for a, b in zip(got, _flat(want)):
            equal = equal and torch.equal(a[s], b)
            err = max(err, float((a[s] - b).abs().max()))
    if (same_width and not equal) or not err <= KERNEL_ATOL:
        raise AssertionError(f'jacobi_sweep[candidates] at {shape}: '
                             f'{err} from the launches alone (float width '
                             f'{plan.vec}, alone {one.vec})')
    src = torch.empty(13 * cands * steps * hidden * batch, device='cuda')
    dst = torch.empty_like(src)
    row.update(alone_max_abs_err=err, alone_bit_equal=equal,
               alone_ms=cuda_ms(alone, 20, flush),
               copy_ms=cuda_ms(lambda: dst.copy_(src), 50, flush),
               warm_ms=cuda_ms(lambda: gs.jacobi_sweep(*args), 50, None))
    row['gb_per_s'] = jacobi_bytes(steps, hidden, batch, cands) / row['ms'] \
        / 1e6
    log(f'[kernels] jacobi_sweep[candidates] {list(shape)} plan '
        f'{row["plan"]} (alone {row["alone_plan"]}), {instance} '
        f'{ptxas.get(instance)}, ms {row["ms"]}, warm_ms {row["warm_ms"]}, '
        f'{cands} launches alone {row["alone_ms"]}, copy_ms '
        f'{row["copy_ms"]}, {row["gb_per_s"]:.0f} GB/s, bound '
        f'{row["bound_ms"]} ms; against the launches alone '
        f'{"bit-equal" if equal else err}')
    return row


def batched_chol_row(name, shape, seed, flush):
    """chol_solve or chol_inverse at the candidate axis's batched N, one
    call on S x N systems of width D (as the exact stage folds the
    candidates' systems into N): held to its plain version, bit-equal to
    S calls alone on each candidate's N systems (each system is one warp
    or one block of its own, so its arithmetic does not depend on N),
    timed L2 flushed beside those S calls (`alone_ms`), the library call,
    the two-call yardstick and the bound."""
    from admm_lstm_torch.kernels import cholesky as ch
    cands, n, dim = shape
    a, b = spd_inputs(cands * n, dim, seed)
    solve = name == 'chol_solve'
    parts = [(a[s * n:(s + 1) * n], b[s * n:(s + 1) * n])
             for s in range(cands)]
    if solve:
        kernel, plain = (lambda: ch.chol_solve(a, b),
                         lambda: ch.chol_solve_plain(a, b))
        alone = lambda: [ch.chol_solve(pa, pb) for pa, pb in parts]
        library = lambda: torch.linalg.solve(a, b)
        two_call = lambda: torch.cholesky_solve(b[..., None],
                                                torch.linalg.cholesky(a))
        bound_ms_by = solve_bound(cands * n, dim)
    else:
        eye = torch.eye(dim, device='cuda').expand_as(a)
        kernel, plain = (lambda: ch.chol_inverse(a),
                         lambda: ch.chol_inverse_plain(a))
        alone = lambda: [ch.chol_inverse(pa) for pa, _ in parts]
        library = None
        two_call = lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky(a), eye, upper=False)
        bound_ms_by = inverse_bound(cands * n, dim)
    row = kernel_row(name, (cands * n, dim), kernel, plain, library,
                     CHOL_ATOL, bound_ms_by, flush, two_call=two_call,
                     info=dict(candidates=cands, per_candidate=n,
                               **chol_kernel_info(dim, solve)))
    if not torch.equal(kernel(), torch.cat(alone())):
        raise AssertionError(f'{name} at {cands} x {n} systems of D {dim}: '
                             f'the batched call differs from {cands} '
                             f'calls alone')
    row.update(alone_bit_equal=True, alone_ms=cuda_ms(alone, 20, flush))
    log(f'[kernels] {name} batched {cands} x {n} systems of D {dim}: ms '
        f'{row["ms"]}, {cands} calls alone {row["alone_ms"]}, library '
        f'{row["library_ms"]}, two-call {row["two_call_ms"]}, bound '
        f'{row["bound_ms"]} ({row["bound_by"]}), bit-equal to the calls '
        f'alone')
    return row


def theta_inputs(shape, seed, k=THETA_K):
    """Seeded slabs of one block of theta tests at `shape` ([S,] T, 4H,
    B): pre, grad_proj, targets near sigmoid(pre), k thetas 1, 2, 4, ...
    (the doubling search's first block) and the tanh mask."""
    from admm_lstm_torch.core.step import gate_is_tanh
    gen = torch.Generator().manual_seed(seed)
    pre = _rand(gen, *shape)
    grad_proj = _rand(gen, *shape, scale=3.0)
    target = torch.sigmoid(pre) + _rand(gen, *shape, scale=0.05)
    cands = (2.0 ** torch.arange(k, dtype=torch.float32)).view(
        (-1,) + (1,) * (len(shape) - 2)).expand(
        (k,) + tuple(shape[:-3]) + (4,)).contiguous().cuda()
    return (pre, grad_proj, target, cands,
            gate_is_tanh(shape[-2], shape[-2] // 4, 'cuda'))


def theta_row(shape, seed, flush, ptxas):
    """The theta-test kernel at `shape`: its table held to the plain loop
    at THETA_RTOL and bit-equal on a second launch, timed L2 flushed
    beside its bound and the plain loop; its plan and the registers and
    spills of its instance."""
    from admm_lstm_torch.kernels import theta_tests as tt
    args = theta_inputs(shape, seed)
    got, again = tt.theta_tests(*args), tt.theta_tests(*args)
    want = tt.theta_tests_plain(*args)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs()).max())
    plan = tt.card_tests_plan(*args[:3])
    instance = f'theta_tests_kernel<{plan.vec}>'
    occ = tt.occupancy(torch.device('cuda'), plan.vec)
    bound_ms, bound_by = theta_bound(shape)
    row = dict(shape=list(shape), max_abs_err=float((got - want).abs().max()),
               max_rel_err=rel, bit_equal_relaunch=torch.equal(got, again),
               ms=cuda_ms(lambda: tt.theta_tests(*args), 50, flush),
               warm_ms=cuda_ms(lambda: tt.theta_tests(*args), 50, None),
               plain_ms=cuda_ms(lambda: tt.theta_tests_plain(*args), 5,
                                flush),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               plan=plan._asdict(), instance=instance,
               blocks_per_sm=occ['blocks_per_sm'], regs=occ['regs'],
               local_bytes=occ['local_bytes'])
    row.update((k, v) for k, v in ptxas.get(instance, {}).items()
               if k != 'regs')
    log(f'[kernels] theta_tests {row}')
    if not (rel <= THETA_RTOL and row['bit_equal_relaunch']):
        raise AssertionError(f'theta_tests at {list(shape)}: relative error '
                             f'{rel} (rtol {THETA_RTOL}), bit-equal '
                             f'relaunch {row["bit_equal_relaunch"]}')
    return row


def stacked_sweep_inputs(shape, seed):
    """The stacked sweep's arguments at `shape` (S or None, T, hiddens...,
    B): a state of seeded data one epoch past its seeded init (every dual
    and z dual nonzero), S candidates of penalties spread over 0.5-2 and
    rho_z over 0.5-2, that state's weights and their M^-1."""
    from admm_lstm_torch.core.state import Penalties
    from admm_lstm_torch.core.step import _per_candidate, rules_for
    from admm_lstm_torch.data.synthetic import load as synth
    from admm_lstm_torch.params import parameter_set
    from admm_lstm_torch.utils.config import ADMMConfig
    from admm_lstm_torch.variants import stacked
    cands, steps, hiddens, batch = shape[0], shape[1], shape[2:-1], shape[-1]
    tx, ty, _, _ = synth(batch=batch, seq_len=steps, input_size=1,
                         val_batch=4, seed=seed)
    x, y = torch.from_numpy(tx).cuda(), torch.from_numpy(ty).cuda()
    params = stacked.init_stacked(torch.Generator().manual_seed(seed), 1,
                                  hiddens, 1, device='cuda')
    cfg = ADMMConfig()
    rules = rules_for(cfg)
    st = stacked.init_stacked_state(params, x, parameter_set('Stacked'), cfg)
    if cands is not None:
        spread = torch.linspace(0.5, 2.0, cands, device='cuda')
        st = stacked.broadcast_stacked_state(
            st, cands, rho=Penalties(*(r * spread for r in st.rho)),
            rho_z=np.linspace(0.5, 2.0, cands))
    x_im, y_im = x.permute(1, 2, 0).contiguous(), y.T.contiguous()
    st = stacked.stacked_admm_step_im(st, x_im, y_im, rules)
    layers = st.params.layers
    m_invs = stacked._sweep_inverses(layers, _per_candidate(st.rho, 2).h,
                                     stacked._view(st.rho_z, 2), 'auto')
    return (x_im, st.gates, st.duals, st.zs, st.zduals, layers, m_invs,
            st.rho, st.rho_z, rules.stacked_dual_decay)


def _sweep_slabs(out):
    """The sweep's new slabs in one list: per layer 6 gates and 5 duals,
    then the z and z-dual slabs."""
    gates, duals, zs, zduals = out
    return [t for g, d in zip(gates, duals) for t in list(g) + list(d)] + \
        list(zs) + list(zduals)


def _sweep_scales(out, rho, rho_z):
    """Each new slab's scale (as _sweep_slabs orders them): a gate's or
    z's largest magnitude; a dual's plus its largest rho times its
    primal's."""
    gates, duals, zs, zduals = out
    amax = lambda t: float(t.abs().max())
    rmax = lambda r: float(torch.as_tensor(r).abs().max())
    rhos = (rho.i, rho.f, rho.g, rho.o, rho.c)
    scales = []
    for g, d in zip(gates, duals):
        scales += [amax(t) for t in g]
        scales += [amax(t) + rmax(r) * amax(p) for t, r, p in zip(d, rhos, g)]
    scales += [amax(z) for z in zs]
    scales += [amax(zd) + rmax(rho_z) * amax(z) for zd, z in zip(zduals, zs)]
    return scales


def stacked_sweep_row(shape, seed, flush, ptxas):
    """The stacked sweep kernel at `shape` (S or None, T, hiddens..., B):
    every new slab held to stacked_sweep_plain's at STACKED_SWEEP_RTOL of
    its scale and bit-equal on a second launch; the path (packing, the
    bounds' passes and the sweep) and the bounds' passes alone timed L2
    flushed beside the bound and the plain loop; the plan and the
    registers and spills of its instance."""
    from admm_lstm_torch.kernels import stacked_sweep as ks
    from admm_lstm_torch.variants import stacked
    args = stacked_sweep_inputs(shape, seed)
    hiddens = shape[2:-1]
    got, again = ks.stacked_sweep(*args), ks.stacked_sweep(*args)
    want = stacked.stacked_sweep_plain(*args)
    torch.cuda.synchronize()
    pairs = list(zip(_sweep_slabs(got), _sweep_slabs(want),
                     _sweep_scales(want, args[7], args[8])))
    err = max(float((g - w).abs().max()) for g, w, _ in pairs)
    rel = max(float((g - w).abs().max()) / scale for g, w, scale in pairs)
    finite = all(bool(torch.isfinite(g).all()) for g, _, _ in pairs)
    same = all(torch.equal(a, b) for a, b in zip(_sweep_slabs(got),
                                                 _sweep_slabs(again)))
    del got, again, want
    x_im, gates, duals, zs = args[:4]
    rhos = ks.rho_pack(args[7], args[8])
    cands = shape[0] or 1

    def bounds():
        out = torch.zeros((len(zs), cands, shape[1] + 1), dtype=torch.int32,
                          device='cuda')
        for k in range(1, len(hiddens)):
            ks.stacked_resmax(zs[k - 1], [gates[k][m] for m in range(4)],
                              [duals[k][m] for m in range(4)], rhos,
                              out[k - 1])

    plan = ks.stacked_sweep_plan(hiddens, x_im.shape[1])
    instance = f'stacked_sweep_kernel<{plan.rows},{len(hiddens)}>'
    bound_ms, bound_by = stacked_sweep_bound(shape[0], shape[1], hiddens,
                                             shape[-1])
    row = dict(shape=list(shape), max_abs_err=err, max_rel_err=rel,
               bit_equal_relaunch=same,
               ms=cuda_ms(lambda: ks.stacked_sweep(*args), 20, flush),
               resmax_ms=cuda_ms(bounds, 20, flush),
               plain_ms=cuda_ms(lambda: stacked.stacked_sweep_plain(*args),
                                5, flush),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               plan=plan._asdict(), instance=instance)
    row.update((k, v) for k, v in ptxas.get(instance, {}).items())
    log(f'[kernels] stacked_sweep {row}')
    if not (finite and rel <= STACKED_SWEEP_RTOL and same):
        raise AssertionError(f'stacked_sweep at {list(shape)}: largest '
                             f'error {rel} of its scale (rtol '
                             f'{STACKED_SWEEP_RTOL}), finite {finite}, '
                             f'bit-equal relaunch {same}')
    return row


def exact_gram_inputs(shape, seed):
    """The Gram kernel's arguments at `shape` (S or None, T, K, D, B,
    shared): m_inputs (a time-sliced view of a (T+1, D, B) slab, as the h
    side's history; (T, D, B) when shared), pre, targets near act(pre)
    and the tanh mask of K = 4H columns."""
    from admm_lstm_torch.core.step import gate_is_tanh
    cands, steps, cols, dim, batch, shared = shape
    lead = () if cands is None else (cands,)
    gen = torch.Generator().manual_seed(seed)
    m_lead = () if shared else lead
    m_inputs = _rand(gen, *m_lead, steps + 1, dim, batch,
                     scale=0.5)[..., :-1, :, :]
    pre = _rand(gen, *lead, steps, cols, batch)
    tanh_cols = gate_is_tanh(cols, cols // 4, 'cuda')
    act = torch.where(tanh_cols[:, None], torch.tanh(pre),
                      torch.sigmoid(pre))
    target = act + _rand(gen, *lead, steps, cols, batch, scale=0.05)
    return m_inputs, pre, target, tanh_cols


def exact_gram_bound(shape):
    """The Gram kernel's bound.  Bytes: pre and the targets, the design
    once, the Gram stack and first-order term written once.  Operations:
    the symmetric half and bvec, D (D + 1) / 2 + D multiply-adds per
    column and row."""
    cands, steps, cols, dim, batch, shared = shape
    s = cands or 1
    rows = steps * batch
    return bound(4 * (2 * s * cols * rows + (1 if shared else s) * dim * rows
                      + s * cols * (dim * dim + dim)),
                 2 * s * cols * rows * (dim * (dim + 1) // 2 + dim))


def exact_gram_errors(got, want, m_inputs, pre, target, tanh_cols):
    """(largest Gram error of its scale max |G_k|, largest first-order
    error of its sum of magnitudes sum |act' r| |m|)."""
    from admm_lstm_torch.kernels.exact_gram import activation_terms
    gram_err = ((got[0] - want[0]).abs().amax((-2, -1))
                / want[0].abs().amax((-2, -1)))
    _, wres = activation_terms(pre, target, tanh_cols)
    mag = torch.einsum('...tkb,...tdb->...kd', wres.abs(), m_inputs.abs())
    bvec_err = (got[1] - want[1]).abs() / mag
    return float(gram_err.max()), float(bvec_err.max())


def exact_gram_truth(m_inputs, pre, target, tanh_cols):
    """The Gram stack and first-order term summed in float64 ('wide' or
    einsum, as the shape picks), as float32."""
    from admm_lstm_torch.kernels.exact_gram import exact_gram_plain
    out = exact_gram_plain(m_inputs.double(), pre.double(), target.double(),
                           tanh_cols)
    return tuple(t.float() for t in out)


def exact_gram_row(shape, seed, flush, ptxas):
    """The Gram kernel at `shape`: held to the float64 sums at
    EXACT_GRAM_RTOL of each Gram's scale, to the plain version
    ('highest') at EXACT_GRAM_PLAIN_RTOL, and bit-equal on a second
    launch; with the candidate axis each candidate's launch alone
    bit-equal to its slice of the batch; timed L2 flushed beside its
    bound, the plain version and the Gram route alone on the plain
    version's slabs (the yardstick: what the stage ran before)."""
    from admm_lstm_torch.kernels import exact_gram as eg
    from admm_lstm_torch.solvers import normal_eq as ne
    args = exact_gram_inputs(shape, seed)
    m_inputs, pre, target, tanh_cols = args
    got, again = eg.exact_gram(*args), eg.exact_gram(*args)
    gram_rel, bvec_rel = exact_gram_errors(got, exact_gram_truth(*args),
                                           *args)
    plain_rel = max(exact_gram_errors(got, eg.exact_gram_plain(*args),
                                      *args))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    alone = True
    if shape[0] is not None:
        for s in range(shape[0]):
            one = eg.exact_gram(m_inputs if shape[-1] else m_inputs[s],
                                pre[s], target[s], tanh_cols)
            alone &= all(torch.equal(a, b[s]) for a, b in zip(one, got))
    del got, again
    s2, wres = eg.activation_terms(pre, target, tanh_cols)
    cands, steps, cols, dim, batch, _ = shape
    strategy = ne._gram_strategy(cols, dim, steps * batch)
    plan = eg.gram_plan(cols, dim, steps, batch)
    bound_ms, bound_by = exact_gram_bound(shape)
    row = dict(shape=list(shape), max_rel_err=gram_rel,
               bvec_max_rel_err=bvec_rel, plain_max_rel_err=plain_rel,
               max_abs_err=None,
               bit_equal_relaunch=same, alone_bit_equal=alone,
               ms=cuda_ms(lambda: eg.exact_gram(*args), 10, flush),
               plain_ms=cuda_ms(lambda: eg.exact_gram_plain(*args), 3, flush),
               route=strategy,
               library_ms=cuda_ms(lambda: ne._gram_bvec(
                   s2, wres, m_inputs, 'highest', strategy=strategy), 3,
                   flush),
               bound_ms=bound_ms, bound_by=bound_by, plan=plan._asdict(),
               instance='exact_gram_kernel')
    row.update(ptxas.get('exact_gram_kernel', {}))
    del s2, wres
    log(f'[kernels] exact_gram {row}')
    if not (gram_rel <= EXACT_GRAM_RTOL and bvec_rel <= EXACT_GRAM_RTOL
            and plain_rel <= EXACT_GRAM_PLAIN_RTOL and same and alone):
        raise AssertionError(f'exact_gram at {list(shape)}: Gram error '
                             f'{gram_rel}, bvec error {bvec_rel} of their '
                             f'scales from float64 (rtol {EXACT_GRAM_RTOL}), '
                             f'{plain_rel} from the plain version (rtol '
                             f'{EXACT_GRAM_PLAIN_RTOL}), bit-equal relaunch '
                             f'{same}, alone {alone}')
    return row


def phase_kernels(flush, ptxas):
    from admm_lstm_torch.kernels import cholesky as ch
    from admm_lstm_torch.kernels import gate_sweep as gs
    rows = {k: [] for k in ('interior_sweep', 'interior_sweep[candidates]',
                            'jacobi_sweep', 'jacobi_sweep[candidates]',
                            'chol_solve', 'chol_inverse', 'theta_tests',
                            'stacked_sweep', 'exact_gram')}
    for k, shape in enumerate(THETA_SHAPES):
        rows['theta_tests'].append(theta_row(shape, 110 + k, flush, ptxas))
    for k, shape in enumerate(STACKED_SWEEP_SHAPES):
        rows['stacked_sweep'].append(stacked_sweep_row(shape, 120 + k, flush,
                                                       ptxas))
    for k, shape in enumerate(EXACT_GRAM_SHAPES):
        rows['exact_gram'].append(exact_gram_row(shape, 130 + k, flush,
                                                 ptxas))
    for k, shape in enumerate(SWEEP_SHAPES):
        steps, hidden, batch = shape
        args = sweep_inputs(*shape, seed=k)
        one = sweep_inputs(1, hidden, batch, seed=k)
        one_ms = cuda_ms(lambda: gs.interior_sweep(*one), 50, flush)
        plan = gs.card_sweep_plan(torch.device('cuda'), hidden, batch)
        row = kernel_row(
            'interior_sweep', shape, lambda: gs.interior_sweep(*args),
            lambda: gs.interior_sweep_plain(*args), None, KERNEL_ATOL,
            sweep_bound(*shape), flush,
            info=dict(plan=plan._asdict(),
                      wh='resident' if plan.resident == hidden else
                      f'{plan.resident} of {hidden} k-rows resident, '
                      f'the rest streamed', one_step_ms=one_ms))
        # The serial cost of a step: the time past the first step.
        row['ms_per_step'] = (row['ms'] - one_ms) / (steps - 1)
        log(f'[kernels] interior_sweep {list(shape)} plan {row["plan"]} '
            f'(wh {row["wh"]}), ms_per_step {row["ms_per_step"]}')
        rows['interior_sweep'].append(row)
    for k, shape in enumerate(CANDIDATE_SHAPES):
        rows['interior_sweep[candidates]'].append(
            candidate_row(shape, 60 + 100 * k, flush, ptxas))
    for k, shape in enumerate(JACOBI_SHAPES):
        rows['jacobi_sweep'].append(jacobi_row(shape, 10 + k, flush, ptxas))
    for k, shape in enumerate(JACOBI_CANDIDATE_SHAPES):
        rows['jacobi_sweep[candidates]'].append(
            jacobi_candidate_row(shape, 70 + 100 * k, flush, ptxas))
    for k, shape in enumerate(SOLVE_SHAPES):
        a, b = spd_inputs(*shape, seed=20 + k)
        rows['chol_solve'].append(kernel_row(
            'chol_solve', shape, lambda: ch.chol_solve(a, b),
            lambda: ch.chol_solve_plain(a, b),
            lambda: torch.linalg.solve(a, b), CHOL_ATOL,
            solve_bound(*shape), flush,
            two_call=lambda: torch.cholesky_solve(b[..., None],
                                                  torch.linalg.cholesky(a)),
            info=chol_kernel_info(shape[1], True)))

    def upper_is_zero(got):
        if float(torch.triu(got[0], diagonal=1).abs().max()) != 0.0:
            raise AssertionError('chol_inverse wrote nonzeros above the '
                                 'diagonal')

    for k, shape in enumerate(INVERSE_SHAPES):
        a, _ = spd_inputs(*shape, seed=30 + k)
        eye = torch.eye(shape[1], device='cuda').expand_as(a)
        rows['chol_inverse'].append(kernel_row(
            'chol_inverse', shape, lambda: ch.chol_inverse(a),
            lambda: ch.chol_inverse_plain(a), None, CHOL_ATOL,
            inverse_bound(*shape), flush, extra_check=upper_is_zero,
            two_call=lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky(a), eye, upper=False),
            info=chol_kernel_info(shape[1], False)))

    for k, shape in enumerate(BATCHED_SOLVE_SHAPES):
        rows['chol_solve'].append(batched_chol_row('chol_solve', shape,
                                                   80 + k, flush))
    for k, shape in enumerate(BATCHED_INVERSE_SHAPES):
        rows['chol_inverse'].append(batched_chol_row('chol_inverse', shape,
                                                     90 + k, flush))

    ill = {'chol_solve': [], 'chol_inverse': []}
    for kappa in ILL_KAPPAS:
        for k, shape in enumerate(ILL_SOLVE_SHAPES):
            ill['chol_solve'].append(ill_row(
                'chol_solve', shape, kappa, 40 + k, ch.chol_solve,
                ch.chol_solve_plain))
        for k, shape in enumerate(ILL_INVERSE_SHAPES):
            ill['chol_inverse'].append(ill_row(
                'chol_inverse', shape, kappa, 50 + k, ch.chol_inverse,
                ch.chol_inverse_plain))
    return rows, ill


def cudnn_lstm(xproj, wh):
    """torch.nn.LSTM(4H, H) on cuDNN set to compute floor_sweep(xproj, wh):
    weight_ih the identity, biases zero, weight_hh[g H + j, k] =
    wh[g][k][j] (PyTorch's gate order is i, f, g, o too), its input xproj
    as (steps, B, 4H), TF32 off.  Returns a call that gives h as (steps,
    B, H); it also runs the identity GEMM of the input projection, which
    the kernel does not."""
    if torch.backends.cudnn.allow_tf32:
        raise AssertionError('the LSTM yardstick runs with TF32 off '
                             '(set_matmul_precision("highest"))')
    steps, _, hidden, batch = xproj.shape
    lstm = torch.nn.LSTM(4 * hidden, hidden).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * hidden))
        lstm.weight_hh_l0.copy_(wh.permute(0, 2, 1).reshape(4 * hidden,
                                                            hidden))
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    inp = xproj.permute(0, 3, 1, 2).reshape(steps, batch, 4 * hidden)
    inp = inp.contiguous()

    def call():
        with torch.no_grad():
            return lstm(inp)[0]
    return call


def floor_instance(plan, hidden, ptxas):
    """The name, registers and spills of the floor kernel instance that
    `plan` launches."""
    name = (f'floor_warp_kernel<{plan.lanes}>' if plan.route == 'warp' else
            f'floor_sweep_kernel<{plan.sweep.rows},'
            f'{int(plan.sweep.resident < hidden)}>')
    return dict(instance=name, **ptxas.get(name, {}))


def _floor_err(got, want, shape, what):
    err = float((got - want).abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= KERNEL_ATOL):
        raise AssertionError(f'{what} disagrees with the plain version at '
                             f'{list(shape)}: max abs err {err}')
    return err


def phase_floor(flush, ptxas):
    """The floor probe as a user runs it, with the launch counts zeroed
    just before and read just after; then floor_sweep against its plain
    version at FLOOR_SHAPES, the first FLOOR_TIMED rows timed beside
    interior_sweep at the same shape, beside the floor's recurrence on
    interior_sweep's tile plan (H <= 32, held to the plain version first)
    and beside cuDNN's LSTM (held to the kernel at KERNEL_ATOL first).
    Returns the rows and the probe's launch counts."""
    from admm_lstm_torch import gs_floor
    from admm_lstm_torch.kernels import gate_sweep as gs
    if not torch.backends.cudnn.is_available():
        raise AssertionError('cuDNN is not available for the LSTM yardstick')
    kernels = _zero_launches()
    if gs_floor.main([]) != 0:
        raise AssertionError('gs_floor exited non-zero')
    launches = _read_launches(kernels)
    log(f'[floor] gs_floor at its defaults: launches {launches}')
    need(launches, 'floor_sweep', gs_floor.CHAIN * (gs_floor.REPEATS + 1),
         'floor')
    cuda = torch.device('cuda')
    rows = []
    for k, shape in enumerate(FLOOR_SHAPES):
        steps, hidden, batch = shape
        xproj, wh = floor_inputs(*shape, seed=60 + k)
        plan = gs.card_floor_plan(cuda, hidden, batch)
        info = dict(plan=dict(plan._asdict(),
                              sweep=plan.sweep and plan.sweep._asdict()),
                    **floor_instance(plan, hidden, ptxas))
        kernel = lambda: gs.floor_sweep(xproj, wh)
        plain = lambda: gs.floor_sweep_plain(xproj, wh)
        if k >= FLOOR_TIMED:
            row = dict(shape=list(shape), max_abs_err=_floor_err(
                kernel(), plain(), shape, 'floor_sweep'), **info)
            log(f'[floor] floor_sweep {row}')
            rows.append(row)
            continue
        library = cudnn_lstm(xproj, wh)
        lib_err = float((library().permute(0, 2, 1) - kernel()).abs().max())
        if not lib_err <= KERNEL_ATOL:
            raise AssertionError(f'cuDNN LSTM disagrees with floor_sweep at '
                                 f'{list(shape)}: max abs err {lib_err}')
        one = floor_inputs(1, hidden, batch, seed=60 + k)
        args = sweep_inputs(*shape, seed=60 + k)
        args1 = sweep_inputs(1, hidden, batch, seed=60 + k)
        row = kernel_row(
            'floor_sweep', shape, kernel, plain, library, KERNEL_ATOL,
            floor_bound(*shape), flush,
            info=dict(info, cudnn_max_abs_err=lib_err,
                      cudnn_version=torch.backends.cudnn.version(),
                      one_step_ms=cuda_ms(lambda: gs.floor_sweep(*one), 50,
                                          flush),
                      interior_ms=cuda_ms(lambda: gs.interior_sweep(*args),
                                          50, flush),
                      interior_one_step_ms=cuda_ms(
                          lambda: gs.interior_sweep(*args1), 50, flush),
                      # L2-resident, right after the same call: what the
                      # loads' latency from HBM costs the chain.
                      warm_ms=cuda_ms(kernel, 50, None),
                      interior_warm_ms=cuda_ms(
                          lambda: gs.interior_sweep(*args), 50, None)))
        # A step's time past the first step, as the interior_sweep rows.
        row['ms_per_step'] = (row['ms'] - row['one_step_ms']) / (steps - 1)
        row['interior_ms_per_step'] = (
            row['interior_ms'] - row['interior_one_step_ms']) / (steps - 1)
        row['chain_share'] = row['ms_per_step'] / row['interior_ms_per_step']
        if plan.route == 'warp':
            # The other route at the same shape: the recurrence on
            # interior_sweep's tile plan.
            onplan = gs.floor_sweep_plan(gs.card_sweep_plan(cuda, hidden,
                                                            batch))
            row['onplan_max_abs_err'] = _floor_err(
                gs.floor_sweep(xproj, wh, plan=onplan), plain(), shape,
                'floor_sweep on interior_sweep\'s plan')
            row['onplan_ms'] = cuda_ms(
                lambda: gs.floor_sweep(xproj, wh, plan=onplan), 50, flush)
            row['onplan_ms_per_step'] = (row['onplan_ms'] - cuda_ms(
                lambda: gs.floor_sweep(*one, plan=onplan), 50, flush)) / (
                    steps - 1)
        log(f'[floor] floor_sweep {list(shape)} plan {row["plan"]} '
            f'({row["instance"]}, regs {row.get("regs")}, spill stores '
            f'{row.get("spill_stores")}): {row["ms"]} ms, '
            f'{row["ms_per_step"] * 1e3} us a step; on interior_sweep\'s '
            f'plan {row.get("onplan_ms")} ms; interior_sweep '
            f'{row["interior_ms"]} ms, {row["interior_ms_per_step"] * 1e3} '
            f'us a step; chain share {row["chain_share"]}; warm (L2) '
            f'{row["warm_ms"]} and {row["interior_warm_ms"]} ms; cuDNN LSTM '
            f'{row["library_ms"]} ms; bound {row["bound_ms"]} ms '
            f'({row["bound_by"]})')
        rows.append(row)
    return rows, launches


def _kernels():
    from admm_lstm_torch.kernels.cholesky import chol_inverse, chol_solve
    from admm_lstm_torch.kernels.exact_gram import exact_gram
    from admm_lstm_torch.kernels.gate_sweep import (floor_sweep,
                                                    interior_sweep,
                                                    jacobi_sweep)
    from admm_lstm_torch.kernels.stacked_sweep import stacked_sweep
    from admm_lstm_torch.kernels.theta_tests import theta_tests
    return dict(interior_sweep=interior_sweep, jacobi_sweep=jacobi_sweep,
                chol_solve=chol_solve, chol_inverse=chol_inverse,
                floor_sweep=floor_sweep, theta_tests=theta_tests,
                stacked_sweep=stacked_sweep, exact_gram=exact_gram)


# The sweep kernels whose launches with the candidate axis are counted
# apart, under '<name>[candidates]'.
CANDIDATE_KERNELS = ('interior_sweep', 'jacobi_sweep')


def _zero_launches():
    """Every kernel's wrapper, with its launch counts set to 0."""
    kernels = _kernels()
    for k in kernels.values():
        k.launches = 0
    for name in CANDIDATE_KERNELS:
        kernels[name].candidate_launches = 0
    return kernels


def _read_launches(kernels):
    """Each wrapper's launches since _zero_launches, and under
    '<name>[candidates]' those of the sweep kernels with the candidate
    axis (counted in the kernel's own too)."""
    counts = {name: k.launches for name, k in kernels.items()}
    for name in CANDIDATE_KERNELS:
        counts[f'{name}[candidates]'] = kernels[name].candidate_launches
    return counts


def run_counted(label, fn, epochs):
    """Zeroes every kernel's launch count, runs `fn` (an api.train call),
    reads the counts, and logs the run."""
    kernels = _zero_launches()
    res = fn()
    launches = _read_launches(kernels)
    train_l, val_l = np.asarray(res['train_loss']), np.asarray(res['val_loss'])
    log(f'[train] {label}: {res["seconds"] * 1e3 / epochs:.3f} ms/epoch '
        f'(host clock, synchronized), final train {train_l[-1]:.6f} val '
        f'{val_l[-1]:.6f}, launches {launches}')
    if not (np.all(np.isfinite(train_l)) and np.all(np.isfinite(val_l))):
        raise AssertionError(f'{label}: non-finite losses')
    return res, train_l, val_l, launches


def need(launches, name, at_least, label):
    if launches[name] < at_least:
        raise AssertionError(f'{label}: {name} launched {launches[name]} '
                             f'times, expected at least {at_least}')


def phase_slice1(tx, ty, vx, vy, ps, weights):
    from admm_lstm_torch import api
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.utils.config import ADMMConfig
    g = np.load(GOLDEN)
    cfg = ADMMConfig(epochs=EPOCHS, hidden_size=10)
    run = lambda: api.train(tx, ty, vx, vy, ps, cfg,
                            params=params_from_dict(weights), log_every=0,
                            device='cuda')
    _, train_l, val_l, launches = run_counted(
        f'slice 1: GoogleStock H=10 default config, {EPOCHS} epochs', run,
        EPOCHS)
    log('[train] slice 1 val trajectory '
        + json.dumps([float(v) for v in val_l]))
    np.testing.assert_allclose(train_l, g['train_loss'][:EPOCHS + 1],
                               rtol=0.05, atol=1e-4)
    np.testing.assert_allclose(val_l, g['val_loss'][:EPOCHS + 1],
                               rtol=0.05, atol=1e-4)
    if not val_l[-1] <= REF_VAL_30 * 1.05:
        raise AssertionError(f'final val {val_l[-1]} above the reference '
                             f'{REF_VAL_30} x 1.05')
    need(launches, 'interior_sweep', EPOCHS, 'slice 1')
    need(launches, 'theta_tests', 2 * EPOCHS, 'slice 1')
    # A second, warm run of the same work for the epoch time.
    res2 = run()
    log(f'[train] slice 1 warm rerun: '
        f'{res2["seconds"] * 1e3 / EPOCHS:.3f} ms/epoch')
    return launches, train_l, val_l


def _auto_rho_run(tx, ty, ps, weights, cfg):
    """auto() at 'highest' stepped through ADMMBasedOptimizer, checking
    rho after every epoch; on a mismatch it prints the epoch, the family
    and each family's primal/dual residual ratio of that epoch first."""
    from admm_lstm_torch import api
    from admm_lstm_torch.core.residuals import admm_residuals, dual_residuals
    from admm_lstm_torch.models.lstm import params_from_dict
    opt = api.ADMMBasedOptimizer(params_from_dict(weights), (tx, ty), ps,
                                 cfg, device='cuda')
    bad = []
    for epoch in range(1, EPOCHS + 1):
        prev = opt.state
        opt.step()
        got = {k: float(getattr(opt.state.rho, k)) for k in 'cfghioy'}
        for k in got:
            n = AUTO_RHO_DOUBLINGS.get(k, [0] * (EPOCHS + 1))[epoch]
            want = float(np.float32(ps.rho[k]) * np.float32(2.0) ** n)
            if abs(got[k] - want) > 1e-6 * want:
                primal = admm_residuals(opt.state, opt.train_x)
                dual = dual_residuals(opt.state._replace(rho=prev.rho),
                                      prev.gates)
                ratios = {f: float(primal[f'r_{f}'] / dual[f's_{f}'])
                          for f in 'cfghioy'}
                log(f'[train] auto rho mismatch at epoch {epoch}, family '
                    f'{k}: got {got[k]}, JAX {want}; primal/dual residual '
                    f'ratios (mu = {cfg.adapt_mu}) {ratios}')
                bad.append((epoch, k))
    if bad:
        raise AssertionError(f'auto() rho differs from the JAX package at '
                             f'(epoch, family) {bad}')
    return opt.state.rho


def phase_path_a(tx, ty, vx, vy, ps, weights):
    from admm_lstm_torch import api
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.utils.config import ADMMConfig
    run = lambda cfg, **kw: (lambda: api.train(
        tx, ty, vx, vy, ps, cfg, params=params_from_dict(weights),
        log_every=0, device='cuda', **kw))

    cfg = ADMMConfig.auto(epochs=EPOCHS, hidden_size=10,
                          matmul_precision='highest')
    res, train_l, val_l, launches = run_counted(
        "Path A: auto() at 'highest'", run(cfg), EPOCHS)
    need(launches, 'exact_gram', 2 * EPOCHS, "Path A auto() at 'highest'")
    log('[train] auto highest val trajectory '
        + json.dumps([float(v) for v in val_l]))
    np.testing.assert_allclose(train_l, AUTO_TRAIN, rtol=0.05, atol=1e-4)
    np.testing.assert_allclose(val_l, AUTO_VAL, rtol=0.05, atol=1e-4)
    rho = _auto_rho_run(tx, ty, ps, weights, cfg)
    for k in 'cfghioy':
        if float(getattr(rho, k)) != float(getattr(res['state'].rho, k)):
            raise AssertionError(f'train and ADMMBasedOptimizer end at '
                                 f'different rho_{k}')
    log('[train] auto highest: rho equal to the JAX package after every '
        'epoch')

    _, _, val_l, launches = run_counted(
        "Path A: auto() at 'default'",
        run(ADMMConfig.auto(epochs=EPOCHS, hidden_size=10)), EPOCHS)
    if launches['exact_gram']:
        raise AssertionError(f"Path A auto() at 'default' launched the Gram "
                             f"kernel {launches['exact_gram']} times (its "
                             f"bf16 Gram takes the plain routes)")
    if not val_l[-1] <= AUTO_VAL_30 * 1.05:
        raise AssertionError(f'auto() val30 {val_l[-1]} above the JAX '
                             f'package {AUTO_VAL_30} x 1.05')

    _, _, val_l, launches = run_counted(
        "Path A: turbo() at 'default'",
        run(ADMMConfig.turbo(epochs=EPOCHS, hidden_size=10)), EPOCHS)
    if not val_l[-1] <= TURBO_VAL_30 * 1.05:
        raise AssertionError(f'turbo() val30 {val_l[-1]} above the JAX '
                             f'package {TURBO_VAL_30} x 1.05')
    need(launches, 'jacobi_sweep', EPOCHS, 'Path A turbo')
    need(launches, 'chol_solve', 2 * EPOCHS, 'Path A turbo')

    res, _, val_l, _ = run_counted(
        "Path A: preset='best'",
        run(ADMMConfig(epochs=EPOCHS, hidden_size=10), preset='best'), EPOCHS)
    log(f"[train] preset='best' chose {res['preset_choice']}, probe "
        f"{res['probe_val']} (JAX package: {BEST_CHOICE}, {BEST_PROBE_VAL})")
    if res['preset_choice'] != BEST_CHOICE:
        raise AssertionError(f"preset='best' chose {res['preset_choice']}")
    return launches


def phase_path_b():
    from admm_lstm_torch import api
    from admm_lstm_torch.core.init import init_admm_state
    from admm_lstm_torch.core.step import make_admm_step
    from admm_lstm_torch.data.synthetic import load as synth_load
    from admm_lstm_torch.models.lstm import init_lstm_params
    from admm_lstm_torch.params import parameter_set
    from admm_lstm_torch.utils.config import ADMMConfig
    from admm_lstm_torch.utils.device import matmul_precision

    tx, ty, vx, vy = synth_load(seed=0, **HAR_SHAPE)
    ps = parameter_set('HAR')
    params = init_lstm_params(torch.Generator().manual_seed(0),
                              HAR_SHAPE['input_size'], HAR_HIDDEN,
                              HAR_SHAPE['output_size'], device='cuda')
    cfg = ADMMConfig.turbo(hidden_size=HAR_HIDDEN, exact_solve_max_dim=1024,
                           epochs=HAR_EPOCHS)
    label = (f'Path B: HAR-shaped turbo (B {HAR_SHAPE["batch"]}, T '
             f'{HAR_SHAPE["seq_len"]}, I {HAR_SHAPE["input_size"]}, H '
             f'{HAR_HIDDEN}), {HAR_EPOCHS} epochs')
    _, train_l, _, launches = run_counted(
        label, lambda: api.train(tx, ty, vx, vy, ps, cfg, params=params,
                                 log_every=0, device='cuda'), HAR_EPOCHS)
    log(f'[train] Path B train trajectory '
        f'{json.dumps([float(v) for v in train_l])}')
    if not train_l[-1] < train_l[0]:
        raise AssertionError(f'{label}: train loss did not fall: {train_l}')
    need(launches, 'chol_inverse', 9 * HAR_EPOCHS, 'Path B')
    need(launches, 'chol_solve', HAR_EPOCHS, 'Path B')
    need(launches, 'jacobi_sweep', HAR_EPOCHS, 'Path B')

    # One epoch with the kernels and with the plain versions, at 'highest'.
    x, y = torch.from_numpy(tx).cuda(), torch.from_numpy(ty).cuda()
    states = {}
    for flag in (True, False):
        c = cfg.replace(matmul_precision='highest', use_pallas_chol=flag,
                        use_pallas_sweep=flag)
        with matmul_precision('highest'):
            st = init_admm_state(params, x, ps, c)
            t0 = time.perf_counter()
            states[flag] = make_admm_step(c)(st, x, y)
            torch.cuda.synchronize()
        log(f'[train] Path B one epoch at highest, kernels {flag}: '
            f'{(time.perf_counter() - t0) * 1e3:.3f} ms')
    got, ref = states[True], states[False]
    amax = lambda t: float(t.abs().max())
    leaves = [(f'param {f}', getattr(got.params, f), getattr(ref.params, f),
               amax(getattr(ref.params, f))) for f in ('wx', 'wh', 'wy')]
    leaves += [(f'gate {k}', getattr(got.gates, k), getattr(ref.gates, k),
                amax(getattr(ref.gates, k))) for k in 'ifgocha']
    leaves += [(f'dual {k}', getattr(got.duals, k), getattr(ref.duals, k),
                amax(getattr(ref.duals, k)) + float(getattr(ref.rho, k))
                * amax(getattr(ref.gates, k))) for k in 'ifgoch']
    errs = {name: (float((a - b).abs().max()), HAR_RTOL * scale)
            for name, a, b, scale in leaves}
    log(f'[train] Path B kernels vs plain, one epoch, (max abs diff, '
        f'tolerance) per leaf: {errs}')
    bad = {name: e for name, e in errs.items() if not e[0] <= e[1]}
    if bad:
        raise AssertionError(f'Path B: the kernel epoch differs from the '
                             f'plain epoch beyond tolerance at {bad}')
    return launches, _path_b_candidates(tx, ty, vx, vy, ps, params, cfg)


def _path_b_candidates(tx, ty, vx, vy, ps, params, cfg):
    """Path B on the candidate axis: PATH_B_CANDIDATE_ROWS of the HAR grid
    through search_rho at 'highest' (one batched program: one
    chol_solve and 9 chol_inverse launches an epoch for the three, not
    three times as many), each candidate held to its api.train run alone
    at HAR_RTOL; returns the search's launches."""
    from admm_lstm_torch import api, tune
    from admm_lstm_torch.utils.config import RHO_KEYS
    epochs = PATH_B_CANDIDATE_EPOCHS
    table = tune.candidate_grid(ps)[PATH_B_CANDIDATE_ROWS]
    high = cfg.replace(matmul_precision='highest', epochs=epochs)
    kernels = _zero_launches()
    t0 = time.perf_counter()
    res = tune.search_rho(tx, ty, vx, vy, ps, high, candidates=table,
                          epochs=epochs, params=params, device='cuda')
    seconds = time.perf_counter() - t0
    launches = _read_launches(kernels)
    alone, t0 = [], time.perf_counter()
    for cand in table:
        pset = type(ps)(rho=dict(zip(RHO_KEYS, map(float, cand))),
                        beta=dict(ps.beta))
        run = api.train(tx, ty, vx, vy, pset, high, params=params,
                        log_every=0, device='cuda')
        alone.append((run['train_loss'][-1], run['val_loss'][-1]))
    alone_seconds = time.perf_counter() - t0
    got = np.stack([res['train_losses'], res['val_losses']], axis=1)
    gap = float(np.max(np.abs(got - alone) / np.abs(alone)))
    log(f'[train] Path B on the candidate axis: {len(table)} candidates x '
        f'{epochs} epochs at highest in one batched program, {seconds:.3f} s'
        f' wall against {alone_seconds:.3f} s for the runs alone; largest '
        f'relative gap of the final losses to the runs alone {gap:.3g} '
        f'(held at {HAR_RTOL}); launches {launches}')
    want = {'chol_inverse': 9 * epochs, 'chol_solve': epochs,
            'jacobi_sweep': epochs, 'jacobi_sweep[candidates]': epochs}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f'Path B on the candidate axis: launches '
                             f'{launches}, expected {want}')
    np.testing.assert_allclose(got, alone, rtol=HAR_RTOL,
                               err_msg='Path B candidates against their runs'
                                       ' alone')
    return launches


def _hold_to(label, train_l, val_l, ref_train, ref_val):
    np.testing.assert_allclose(train_l, ref_train, rtol=0.05, atol=1e-4,
                               err_msg=f'{label} train loss')
    np.testing.assert_allclose(val_l, ref_val, rtol=0.05, atol=1e-4,
                               err_msg=f'{label} val loss')


def phase_datasets():
    """Every bundled dataset but GoogleStock at full width, the default
    config: YahooFinance and DNA1 against the reference's trajectories,
    SMSSpam and GEFCOM2012Wind against the JAX package's."""
    from admm_lstm_torch import api
    from admm_lstm_torch.data import load_dataset
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.utils.config import ADMMConfig
    launches = {}
    for name, golden in GOLDEN_DATASETS.items():
        g = np.load(os.path.join(ROOT, 'tests', 'golden', golden))
        (tx, ty, vx, vy), ps, _ = load_dataset(name)
        weights = {k[3:]: g[k] for k in g.files if k.startswith('w0_')}
        cfg = ADMMConfig(epochs=EPOCHS, hidden_size=int(g['hidden']))
        label = (f'{name} {list(tx.shape)} -> {ty.shape[1]}, H '
                 f'{cfg.hidden_size}, default config, {EPOCHS} epochs')
        _, train_l, val_l, counts = run_counted(label, lambda: api.train(
            tx, ty, vx, vy, ps, cfg, params=params_from_dict(weights),
            log_every=0, device='cuda'), EPOCHS)
        log(f'[train] {name} val trajectory '
            + json.dumps([float(v) for v in val_l]))
        _hold_to(name, train_l, val_l, g['train_loss'], g['val_loss'])
        if not train_l[-1] <= g['train_loss'][-1] * 1.05:
            raise AssertionError(f'{name}: final train loss {train_l[-1]} '
                                 f'above the reference '
                                 f'{g["train_loss"][-1]} x 1.05')
        if counts['interior_sweep'] != EPOCHS:
            raise AssertionError(f'{name}: interior_sweep launched '
                                 f'{counts["interior_sweep"]} times in '
                                 f'{EPOCHS} epochs')
        launches[name] = counts
    for name, ref in DATASET_REF.items():
        (tx, ty, vx, vy), ps, _ = load_dataset(name)
        weights = numpy_weights(tx.shape[2], 10, ty.shape[1], 0)
        cfg = ADMMConfig(epochs=DATASET_EPOCHS, hidden_size=10)
        label = (f'{name} {list(tx.shape)} -> {ty.shape[1]}, H 10, default '
                 f'config, {DATASET_EPOCHS} epochs')
        _, train_l, val_l, counts = run_counted(label, lambda: api.train(
            tx, ty, vx, vy, ps, cfg, params=params_from_dict(weights),
            log_every=0, device='cuda'), DATASET_EPOCHS)
        log(f'[train] {name} train/val trajectories '
            + json.dumps([[float(v) for v in train_l],
                          [float(v) for v in val_l]]))
        _hold_to(name, train_l, val_l, ref['train'], ref['val'])
        # The drop itself at the same rtol: SMSSpam's 5-epoch drop (~5e-5)
        # lies below the trajectory's atol.
        drop, ref_drop = (train_l[0] - train_l[-1],
                          ref['train'][0] - ref['train'][-1])
        if not abs(drop - ref_drop) <= 0.05 * abs(ref_drop):
            raise AssertionError(f'{name}: train loss fell by {drop}, the JAX '
                                 f'package\'s by {ref_drop}')
        need(counts, 'interior_sweep', DATASET_EPOCHS, name)
        launches[name] = counts
    return launches


def phase_tune(tx, ty, vx, vy, ps, weights, card):
    """search_rho on GoogleStock over the default 27-point grid as one
    batched program: the JAX package's best rho and each candidate's
    validation loss, EPOCHS interior_sweep launches (one an epoch for the
    grid), its host syncs, busy ms and idle share (a second run under the
    profiler), and its wall seconds beside the 27 candidates' runs alone
    (api.train each, timed here); candidate 0's and the best candidate's
    batched losses held to their runs alone at TUNE_ALONE_RTOL."""
    from admm_lstm_torch import api, tune
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.profile_epoch import device_profile
    from admm_lstm_torch.utils.config import RHO_KEYS, ADMMConfig
    cfg = ADMMConfig(hidden_size=10)
    search = lambda: tune.search_rho(tx, ty, vx, vy, ps, cfg, epochs=EPOCHS,
                                     params=params_from_dict(weights),
                                     device='cuda')
    kernels = _zero_launches()
    t0 = time.perf_counter()
    res = search()
    seconds = time.perf_counter() - t0
    launches = _read_launches(kernels)
    n = len(res['val_losses'])
    log(f'[tune] search_rho GoogleStock, {n} candidates x {EPOCHS} epochs in '
        f'one batched program on {card}: {seconds:.3f} s wall (host clock), '
        f'best rho {res["best_rho"]} val {res["best_val_loss"]:.6f} (JAX '
        f'package: {TUNE_BEST_RHO}), launches {launches}')
    log('[tune] val losses in grid order '
        + json.dumps([float(v) for v in res['val_losses']]))
    got, want = np.asarray(res['val_losses']), np.asarray(TUNE_VAL)
    finite = np.isfinite(want)
    if not np.array_equal(np.isfinite(got), finite):
        raise AssertionError(f'search_rho: non-finite candidates '
                             f'{np.nonzero(~np.isfinite(got))[0]} against '
                             f'the JAX package\'s {np.nonzero(~finite)[0]}')
    np.testing.assert_allclose(got[finite], want[finite], rtol=0.05,
                               atol=1e-4, err_msg='search_rho val losses')
    if res['best_rho'] != TUNE_BEST_RHO:
        raise AssertionError(f'search_rho chose {res["best_rho"]}, the JAX '
                             f'package {TUNE_BEST_RHO}')
    if (launches['interior_sweep'] != EPOCHS
            or launches['interior_sweep[candidates]'] != EPOCHS):
        raise AssertionError(f'search_rho: launches {launches}, expected '
                             f'{EPOCHS} of interior_sweep, each with the '
                             f'candidate axis (one an epoch for the grid)')
    prof = device_profile(search)
    prof.pop('kernels_ms')
    prof['idle_share'] = max(0.0, 1.0 - prof['busy_ms'] / prof['wall_ms'])
    log(f'[tune] the search under torch.profiler: {json.dumps(prof)}; per '
        f'epoch: {prof["host_syncs"] / EPOCHS} syncs, '
        f'{prof["device_ops"] / EPOCHS} operations, '
        f'{prof["busy_ms"] / EPOCHS:.4f} ms busy')

    # The 27 runs alone, as the search ran them before the candidate axis.
    alone, t0 = [], time.perf_counter()
    for cand in res['candidates']:
        pset = type(ps)(rho=dict(zip(RHO_KEYS, map(float, cand))),
                        beta=dict(ps.beta))
        run = api.train(tx, ty, vx, vy, pset, cfg.replace(epochs=EPOCHS),
                        params=params_from_dict(weights), log_every=0,
                        device='cuda')
        alone.append((run['train_loss'][-1], run['val_loss'][-1]))
    alone_seconds = time.perf_counter() - t0
    held = sorted({0, int(res['order'][0])})
    for k in held:
        np.testing.assert_allclose(
            [res['train_losses'][k], res['val_losses'][k]], alone[k],
            rtol=TUNE_ALONE_RTOL,
            err_msg=f'search_rho candidate {k} against its run alone')
    gaps = [float(np.max(np.abs(np.asarray(a) - (t, v)) / np.abs(a)))
            for a, t, v in zip(alone, res['train_losses'],
                               res['val_losses'])]
    log(f'[tune] {n} runs alone (api.train, {EPOCHS} epochs each): '
        f'{alone_seconds:.3f} s wall against {seconds:.3f} s batched '
        f'({alone_seconds / seconds:.2f}x); candidates {held} held to their '
        f'runs alone at rtol {TUNE_ALONE_RTOL}; every candidate\'s largest '
        f'relative gap to its run alone {max(gaps):.3g}')
    return launches, dict(seconds=seconds, alone_seconds=alone_seconds,
                          profile=prof, largest_alone_gap=max(gaps))


def _counting_groups(tune):
    """Wraps tune._run_in_groups (its halving recurses through the module
    name) so that every group it runs is recorded; returns the list and
    a function that restores it."""
    real, groups = tune._run_in_groups, []

    def counting(name, candidates, train_group, lo, hi):
        groups.append((lo, hi))
        return real(name, candidates, train_group, lo, hi)

    tune._run_in_groups = counting
    return groups, lambda: setattr(tune, '_run_in_groups', real)


def _tune_launch_gate(label, launches, epochs, groups, n, grams):
    """The auto() search's launches: one jacobi_sweep an epoch, all with
    the axis, two chol_solve (the exact x and h stages), `grams`
    exact_gram (the same stages at 'highest'), no Gauss-Seidel sweep, one
    group of all n candidates (no out-of-memory halving)."""
    want = {'jacobi_sweep': epochs, 'jacobi_sweep[candidates]': epochs,
            'chol_solve': 2 * epochs, 'interior_sweep': 0,
            'chol_inverse': 0, 'exact_gram': grams}
    got = {k: launches[k] for k in want}
    if got != want or groups != [(0, n)]:
        raise AssertionError(f'{label}: launches {got} (expected {want}), '
                             f'groups {groups} (expected one of {n})')


def phase_tune_auto(tx, ty, vx, vy, ps, weights, card):
    """search_rho on GoogleStock over the 27-point grid under auto() as one
    batched program (the Jacobi sweep and the exact weight solve on the
    candidate axis), twice.  At auto()'s 'default' (TF32): 30 jacobi_sweep
    launches all with the axis, 60 chol_solve (the two exact stages an
    epoch), no interior_sweep, one group (no out-of-memory halving), every
    candidate finite and the winner within 1.05x of the JAX package's best
    (as auto() at 'default' in Path A), each candidate's gap to the JAX
    package logged.  At 'highest': the same launches and group, the JAX
    package's best rho and each candidate's validation loss (rtol 0.05,
    atol 1e-4), each candidate held to its api.train run alone at
    TUNE_ALONE_RTOL with its final rho equal, the wall seconds of both,
    and the search's syncs, busy ms and idle share under the profiler.
    Then the CLI's --auto --tune_rho 1: 125 candidates in one batched
    program, its groups, launches and wall seconds (a halving is
    logged)."""
    from admm_lstm_torch import api, cli, tune
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.profile_epoch import device_profile
    from admm_lstm_torch.utils.config import RHO_KEYS, ADMMConfig
    cfg = ADMMConfig.auto(hidden_size=10)
    search = lambda c: tune.search_rho(tx, ty, vx, vy, ps, c, epochs=EPOCHS,
                                       params=params_from_dict(weights),
                                       device='cuda')
    groups, restore = _counting_groups(tune)
    try:
        kernels = _zero_launches()
        t0 = time.perf_counter()
        res = search(cfg)
        seconds = time.perf_counter() - t0
        launches = _read_launches(kernels)
        n = len(res['val_losses'])
        ref = np.asarray(AUTO_TUNE_VAL)
        got = np.asarray(res['val_losses'])
        log(f'[tune] auto() search_rho GoogleStock at \'default\' (TF32), '
            f'{n} candidates x {EPOCHS} epochs in one batched program on '
            f'{card}: {seconds:.3f} s wall (host clock), best rho '
            f'{res["best_rho"]} (candidate {int(res["order"][0])}) val '
            f'{res["best_val_loss"]:.8f} (JAX package: candidate '
            f'{int(np.argmin(ref))}, val {ref.min():.8f}), groups {groups}, '
            f'launches {launches}; relative gap of each candidate\'s val '
            f'loss to the JAX package\'s (f32) '
            + json.dumps([float(v) for v in np.abs(got - ref) / ref])
            + '; val losses in grid order '
            + json.dumps([float(v) for v in got]))
        _tune_launch_gate('auto() search_rho', launches, EPOCHS, groups, n,
                          0)
        # TF32 moves adaptive rho's discrete choices, so the JAX package's
        # numbers hold at 'highest' below; here, as for auto() at
        # 'default' in Path A, every candidate is finite and the winner
        # within 1.05x of the JAX package's best.
        if not (np.all(np.isfinite(got))
                and res['best_val_loss'] <= 1.05 * ref.min()):
            raise AssertionError(f'auto() search_rho at default: val losses '
                                 f'{got.tolist()}, best above the JAX '
                                 f'package\'s {ref.min()} x 1.05')

        # At 'highest', beside the runs alone, with each candidate's final
        # state recorded from the batched program's last epoch.
        high = cfg.replace(matmul_precision='highest')
        final, real_step = {}, tune.admm_step_im

        def recording(*a):
            final['state'] = real_step(*a)
            return final['state']

        tune.admm_step_im = recording
        try:
            groups.clear()
            kernels = _zero_launches()
            t0 = time.perf_counter()
            res_h = search(high)
            high_seconds = time.perf_counter() - t0
            high_launches = _read_launches(kernels)
        finally:
            tune.admm_step_im = real_step
        _tune_launch_gate('auto() search_rho at highest', high_launches,
                          EPOCHS, groups, n, 2 * EPOCHS)
        jax_gap = float(np.max(np.abs(res_h['val_losses'] - ref) / ref))
        log(f'[tune] auto() search_rho at \'highest\': best rho '
            f'{res_h["best_rho"]} (JAX package: {AUTO_TUNE_BEST_RHO}); '
            f'largest relative gap of a val loss to the JAX package\'s '
            f'{jax_gap:.3g}; val losses in grid order '
            + json.dumps([float(v) for v in res_h['val_losses']]))
        np.testing.assert_allclose(res_h['val_losses'], ref, rtol=0.05,
                                   atol=1e-4, err_msg='auto() search_rho at '
                                                      'highest val losses')
        if res_h['best_rho'] != AUTO_TUNE_BEST_RHO:
            raise AssertionError(f'auto() search_rho at highest chose '
                                 f'{res_h["best_rho"]}, the JAX package '
                                 f'{AUTO_TUNE_BEST_RHO}')
        prof = device_profile(lambda: search(high))
    finally:
        restore()
    prof.pop('kernels_ms')
    prof['idle_share'] = max(0.0, 1.0 - prof['busy_ms'] / prof['wall_ms'])
    alone, t0 = [], time.perf_counter()
    for cand in res_h['candidates']:
        pset = type(ps)(rho=dict(zip(RHO_KEYS, map(float, cand))),
                        beta=dict(ps.beta))
        run = api.train(tx, ty, vx, vy, pset, high.replace(epochs=EPOCHS),
                        params=params_from_dict(weights), log_every=0,
                        device='cuda')
        alone.append(run)
    alone_seconds = time.perf_counter() - t0
    gaps, rho_diff = [], []
    for k, run in enumerate(alone):
        want = (run['train_loss'][-1], run['val_loss'][-1])
        got = (res_h['train_losses'][k], res_h['val_losses'][k])
        gaps.append(float(np.max(np.abs(np.subtract(got, want))
                                 / np.abs(want))))
        for f in RHO_KEYS:
            a = float(getattr(final['state'].rho, f)[k])
            b = float(getattr(run['state'].rho, f))
            if a != b:
                rho_diff.append((k, f, a, b))
    log(f'[tune] auto() search_rho at \'highest\': {high_seconds:.3f} s wall '
        f'batched against {alone_seconds:.3f} s for the {n} api.train runs '
        f'alone ({alone_seconds / high_seconds:.2f}x), on {card}; launches '
        f'{high_launches}; under torch.profiler {json.dumps(prof)}; per '
        f'epoch {prof["host_syncs"] / EPOCHS} syncs, '
        f'{prof["device_ops"] / EPOCHS} operations, '
        f'{prof["busy_ms"] / EPOCHS:.4f} ms busy; every candidate\'s '
        f'largest relative gap to its run alone {max(gaps):.3g} (held at '
        f'{TUNE_ALONE_RTOL}); final rho differing from the run alone: '
        f'{rho_diff}')
    if max(gaps) > TUNE_ALONE_RTOL or rho_diff:
        raise AssertionError(f'auto() search_rho at highest: candidates '
                             f'part from their runs alone (largest gap '
                             f'{max(gaps)}, rho {rho_diff})')

    # The CLI's --auto --tune_rho 1: 125 candidates, one batched program.
    groups, restore = _counting_groups(tune)
    try:
        kernels = _zero_launches()
        t0 = time.perf_counter()
        rc = cli.main(CLI_TUNE_ARGS)
        cli_seconds = time.perf_counter() - t0
        cli_launches = _read_launches(kernels)
    finally:
        restore()
    log(f'[tune] CLI {" ".join(CLI_TUNE_ARGS)}: exit {rc} in '
        f'{cli_seconds:.3f} s wall (the 125-candidate round and the final '
        f'30-epoch run) on {card}; groups {groups}'
        + (' (halved: the card ran out of memory)' if len(groups) > 1
           else ' (one batched program, no halving)')
        + f'; launches {cli_launches}')
    if rc != 0 or cli_launches['interior_sweep'] != 0 or \
            cli_launches['jacobi_sweep[candidates]'] < EPOCHS:
        raise AssertionError(f'CLI --auto --tune_rho 1: exit {rc}, '
                             f'launches {cli_launches}')
    return launches, dict(seconds=seconds, highest_seconds=high_seconds,
                          alone_seconds=alone_seconds, profile=prof,
                          largest_alone_gap=max(gaps),
                          cli_seconds=cli_seconds, cli_groups=groups)


def phase_resume():
    """YahooFinance straight through against checkpointed (async) and
    resumed from the directory: the losses, the weights and the whole
    final state equal bit for bit."""
    import shutil
    import tempfile

    from admm_lstm_torch import api
    from admm_lstm_torch.data import load_dataset
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.utils.config import ADMMConfig
    g = np.load(os.path.join(ROOT, 'tests', 'golden',
                             GOLDEN_DATASETS['YahooFinance']))
    weights = {k[3:]: g[k] for k in g.files if k.startswith('w0_')}
    (tx, ty, vx, vy), ps, _ = load_dataset('YahooFinance')
    cfg = ADMMConfig(epochs=RESUME_EPOCHS, hidden_size=10)
    run = lambda epochs, **kw: api.train(
        tx, ty, vx, vy, ps, cfg.replace(epochs=epochs),
        params=params_from_dict(weights), log_every=0, device='cuda', **kw)
    ckpt = tempfile.mkdtemp(prefix='.chip_smoke_ckpt_', dir=ROOT)
    try:
        full = run(RESUME_EPOCHS)
        first = run(RESUME_AT, checkpoint_dir=ckpt, checkpoint_every=RESUME_AT,
                    async_checkpoint=True)
        saved = sorted(os.listdir(ckpt))
        resumed = run(RESUME_EPOCHS, resume_from=ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f'[resume] YahooFinance {RESUME_EPOCHS} epochs straight: val '
        f'{full["val_loss"][-1]!r}; {RESUME_AT} checkpointed (files '
        f'{saved}) then resumed to {RESUME_EPOCHS}: val '
        f'{resumed["val_loss"][-1]!r}')
    diffs = []
    for key in ('train_loss', 'val_loss'):
        if first[key] != full[key][:RESUME_AT + 1]:
            diffs.append(f'{key} of the checkpointed run')
        if resumed[key] != full[key][RESUME_AT:]:
            diffs.append(f'{key} of the resumed run')
    if resumed['state'].epoch != RESUME_EPOCHS:
        diffs.append(f'epoch {resumed["state"].epoch}')
    for group in ('params', 'gates', 'duals', 'rho', 'beta'):
        for field, a in getattr(resumed['state'], group)._asdict().items():
            b = getattr(getattr(full['state'], group), field)
            if not torch.equal(a, b):
                diffs.append(f'{group}.{field} (max abs diff '
                             f'{float((a - b).abs().max())})')
    if diffs:
        raise AssertionError(f'resume: not bit-equal to the straight run: '
                             f'{diffs}')
    log('[resume] losses, weights and the whole final state equal bit for '
        'bit')


def _stacked_epoch_vs_plain(tx, ty, ps, params):
    """One (8, 8) epoch with the kernels (use_pallas_chol True, the
    stacked sweep and Gram kernels) against one with their plain versions
    (use_pallas_chol False, the epoch's choices of the sweep and of the
    Gram patched to the loop and the plain routes) at 'highest': each
    leaf within STACKED_RTOL of its scale (max |x|; for a dual, max
    |lambda| + rho max |its primal|)."""
    from admm_lstm_torch.solvers import normal_eq
    from admm_lstm_torch.utils.config import ADMMConfig
    from admm_lstm_torch.utils.device import matmul_precision
    from admm_lstm_torch.variants import stacked
    x, y = torch.from_numpy(tx).cuda(), torch.from_numpy(ty).cuda()
    states = {}
    use_kernel = stacked.use_stacked_kernel
    use_gram = normal_eq.use_gram_kernel
    for flag in (True, False):
        cfg = ADMMConfig(hidden_size=8, use_pallas_chol=flag)
        stacked.use_stacked_kernel = use_kernel if flag else (
            lambda *a: False)
        normal_eq.use_gram_kernel = use_gram if flag else (lambda *a: False)
        try:
            with matmul_precision('highest'):
                st = stacked.init_stacked_state(params, x, ps, cfg)
                states[flag] = stacked.make_stacked_step(cfg)(st, x, y)
                torch.cuda.synchronize()
        finally:
            stacked.use_stacked_kernel = use_kernel
            normal_eq.use_gram_kernel = use_gram
    got, ref = states[True], states[False]
    amax = lambda t: float(t.abs().max())
    leaves = [('head wy', got.params.wy, ref.params.wy, amax(ref.params.wy))]
    for k in range(len(ref.gates)):
        leaves += [(f'layer {k} {f}', getattr(got.params.layers[k], f),
                    getattr(ref.params.layers[k], f),
                    amax(getattr(ref.params.layers[k], f)))
                   for f in ('wx', 'wh')]
        leaves += [(f'layer {k} gate {f}', getattr(got.gates[k], f),
                    getattr(ref.gates[k], f), amax(getattr(ref.gates[k], f)))
                   for f in 'ifgocha']
        leaves += [(f'layer {k} dual {f}', getattr(got.duals[k], f),
                    getattr(ref.duals[k], f),
                    amax(getattr(ref.duals[k], f)) + float(getattr(
                        ref.rho, f)) * amax(getattr(ref.gates[k], f)))
                   for f in 'ifgoch']
    for k in range(len(ref.zs)):
        leaves += [(f'z {k + 1}', got.zs[k], ref.zs[k], amax(ref.zs[k])),
                   (f'z dual {k + 1}', got.zduals[k], ref.zduals[k],
                    amax(ref.zduals[k])
                    + float(ref.rho_z) * amax(ref.zs[k]))]
    errs = {name: (float((a - b).abs().max()), STACKED_RTOL * scale)
            for name, a, b, scale in leaves}
    worst = max(e[0] / e[1] for e in errs.values() if e[1] > 0)
    log(f'[stacked] one (8, 8) epoch, kernels vs plain: largest error '
        f'{worst:.3g} of its tolerance; (max abs diff, tolerance) per leaf '
        f'{errs}')
    bad = {name: e for name, e in errs.items() if not e[0] <= e[1]}
    if bad:
        raise AssertionError(f'stacked: the kernel epoch differs from the '
                             f'plain epoch beyond tolerance at {bad}')


def _stacked_launches(label, launches, epochs, layers=2):
    """A stacked run's launches: two exact_gram and two chol_solve a
    stacked epoch (layer 0's exact x and h sides; with the candidate axis
    each one call for every candidate's), one stacked_sweep (the sweep
    over t and the layers, every candidate in one launch) with one
    chol_inverse before it for each layer below the top (the coupled h
    solve's M^-1) and no other kernel."""
    want = {'exact_gram': 2 * epochs, 'chol_solve': 2 * epochs,
            'stacked_sweep': epochs, 'chol_inverse': (layers - 1) * epochs}
    got = {k: v for k, v in launches.items() if k in want or v}
    if got != want:
        raise AssertionError(f'{label}: launches {got}, expected {want}')


def _stacked_alone(tx, ty, vx, vy, ps, params, res, epochs, zs, rows):
    """Candidates `rows` of a stacked search trained alone by
    train_stacked (rho_z from `zs`, or the tuning's), timed on the host
    clock; each one's batched final train and validation losses held to
    its run alone at STACKED_ALONE_RTOL.  Returns the wall seconds and the
    largest relative gap."""
    from admm_lstm_torch.utils.config import RHO_KEYS, ADMMConfig
    from admm_lstm_torch.variants.stacked import train_stacked
    alone, t0 = [], time.perf_counter()
    for k in rows:
        rho = dict(zip(RHO_KEYS, map(float, res['candidates'][k])),
                   z=float(zs[k]) if zs is not None else ps.rho['z'])
        run = train_stacked(tx, ty, vx, vy,
                            type(ps)(rho=rho, beta=dict(ps.beta)),
                            ADMMConfig(epochs=epochs, hidden_size=8),
                            params=params, log_every=0, device='cuda')
        alone.append((run['train_loss'][-1], run['val_loss'][-1]))
    seconds = time.perf_counter() - t0
    alone = np.asarray(alone)
    batched = np.stack([res['train_losses'], res['val_losses']],
                       axis=-1)[list(rows)]
    np.testing.assert_allclose(batched, alone, rtol=STACKED_ALONE_RTOL,
                               err_msg='search_rho_stacked: candidates '
                               'against their runs alone')
    return seconds, float(np.max(np.abs(batched - alone) / np.abs(alone)))


def stacked_search(tx, ty, vx, vy, ps, params, card):
    """search_rho_stacked at (8, 8) over refine_rho_stacked's first grid
    as one batched program, twice around the 27 train_stacked runs alone
    (paired on the host clock), held to the runs alone and to the JAX
    package's losses and winner; once under the profiler; then once more
    with a rho_z per candidate, STACKED_Z_ALONE held to their runs alone.
    Returns the search's launches and its times."""
    from admm_lstm_torch import tune
    from admm_lstm_torch.profile_epoch import device_profile
    from admm_lstm_torch.utils.config import ADMMConfig
    epochs = STACKED_BEST_ARGS['probe_epochs']
    span = STACKED_SEARCH_SPAN
    grid = tune.candidate_grid(ps, multipliers=(1.0 / span, 1.0, span))
    n = len(grid)

    def search(zs=None):
        return tune.search_rho_stacked(
            tx, ty, vx, vy, ps, (8, 8), ADMMConfig(hidden_size=8),
            candidates=grid, epochs=epochs, z_candidates=zs, params=params,
            device='cuda')

    groups, restore = _counting_groups(tune)
    try:
        kernels = _zero_launches()
        t0 = time.perf_counter()
        res = search()
        seconds = [time.perf_counter() - t0]
        launches = _read_launches(kernels)
    finally:
        restore()
    label = f'search_rho_stacked (8, 8), {n} candidates x {epochs} epochs'
    _stacked_launches(label, launches, epochs)
    if groups != [(0, n)]:
        raise AssertionError(f'{label}: groups {groups}, expected one')
    alone_seconds, gap = _stacked_alone(tx, ty, vx, vy, ps, params, res,
                                        epochs, None, range(n))
    t0 = time.perf_counter()
    again = search()
    seconds.append(time.perf_counter() - t0)
    if not np.array_equal(again['val_losses'], res['val_losses']):
        raise AssertionError(f'{label}: a second run gave other losses')
    best_rho = {**res['best_rho'], 'z': ps.rho['z']}
    log(f'[stacked] {label} in one batched program on {card}: wall seconds '
        f'{seconds} (host clock; before and after the runs alone) against '
        f'{alone_seconds:.3f} s for the {n} train_stacked runs alone '
        f'({alone_seconds / min(seconds):.2f}x); every candidate within '
        f'{gap:.3g} of its run alone (rtol {STACKED_ALONE_RTOL}); best rho '
        f'{best_rho} (JAX package: {STACKED_BEST_RHO}); launches '
        f'{launches}; val losses in grid order '
        + json.dumps([float(v) for v in res['val_losses']]))
    np.testing.assert_allclose(res['val_losses'], STACKED_SEARCH_VAL,
                               rtol=0.05, atol=1e-4,
                               err_msg=f'{label} val losses')
    if best_rho != STACKED_BEST_RHO:
        raise AssertionError(f'{label} chose {best_rho}, the JAX package '
                             f'{STACKED_BEST_RHO}')
    prof = device_profile(search)
    prof.pop('kernels_ms')
    prof['idle_share'] = max(0.0, 1.0 - prof['busy_ms'] / prof['wall_ms'])
    log(f'[stacked] the search under torch.profiler: {json.dumps(prof)}; '
        f'per batched epoch: {prof["host_syncs"] / epochs} syncs, '
        f'{prof["device_ops"] / epochs} operations, '
        f'{prof["busy_ms"] / epochs:.4f} ms busy')

    zs = np.resize(np.asarray(STACKED_SEARCH_Z, np.float32), n)
    kernels = _zero_launches()
    t0 = time.perf_counter()
    res_z = search(zs)
    z_seconds = time.perf_counter() - t0
    z_launches = _read_launches(kernels)
    _stacked_launches(f'{label} with z_candidates', z_launches, epochs)
    z_alone_seconds, z_gap = _stacked_alone(tx, ty, vx, vy, ps, params,
                                            res_z, epochs, zs,
                                            STACKED_Z_ALONE)
    log(f'[stacked] the same search with z_candidates '
        f'{[float(z) for z in zs]}: {z_seconds:.3f} s wall; candidates '
        f'{list(STACKED_Z_ALONE)} within {z_gap:.3g} of their runs alone '
        f'({z_alone_seconds:.3f} s); best rho {res_z["best_rho"]}')
    return launches, dict(seconds=seconds, alone_seconds=alone_seconds,
                          largest_alone_gap=gap, profile=prof,
                          z_seconds=z_seconds,
                          z_alone_seconds=z_alone_seconds,
                          z_largest_alone_gap=z_gap)


def phase_stacked(card):
    """The stacked variant through admm_lstm_torch's public functions at
    the JAX bench's GoogleStock width, from the JAX package's seed-0
    weights, held to its numbers.  Returns the (8, 8) run's launches,
    the preset's, the search's, and the preset's and the search's wall
    seconds."""
    import shutil
    import tempfile

    from admm_lstm_torch import api
    from admm_lstm_torch.ckpt.checkpoint import load_model, save_model
    from admm_lstm_torch.data import load_dataset
    from admm_lstm_torch.params import parameter_set
    from admm_lstm_torch.utils.config import ADMMConfig
    from admm_lstm_torch.variants.stacked import train_stacked
    (tx, ty, vx, vy), _, _ = load_dataset('GoogleStock')
    ps = parameter_set('Stacked')
    init = {h: load_model(os.path.join(
        ROOT, 'tests', 'golden',
        f'torch_stacked_init_{"x".join(map(str, h))}.npz'), device='cuda')
        for h in STACKED_RUNS}
    launches = None
    for hiddens, epochs in STACKED_RUNS.items():
        label = f'stacked {hiddens} GoogleStock, {epochs} epochs'
        _, train_l, val_l, counts = run_counted(label, lambda: train_stacked(
            tx, ty, vx, vy, ps, ADMMConfig(epochs=epochs, hidden_size=8),
            params=init[hiddens], log_every=0, device='cuda'), epochs)
        ref = STACKED_REF[hiddens]
        gap = max(float(np.max(np.abs(got - np.asarray(want))
                               / np.abs(want)))
                  for got, want in ((train_l, ref['train']),
                                    (val_l, ref['val'])))
        log(f'[stacked] {hiddens} train/val trajectories '
            + json.dumps([[float(v) for v in train_l],
                          [float(v) for v in val_l]])
            + f'; largest relative gap to the JAX package {gap:.3g}')
        _hold_to(label, train_l, val_l, ref['train'], ref['val'])
        _stacked_launches(label, counts, epochs, len(hiddens))
        if hiddens == (8, 8):
            launches = counts

    search_launches, search_times = stacked_search(
        tx, ty, vx, vy, ps, init[(8, 8)], card)

    kernels = _zero_launches()
    t0 = time.perf_counter()
    best = api.train_best_stacked(
        tx, ty, vx, vy, ps, ADMMConfig(epochs=STACKED_BEST_ARGS['epochs'],
                                       hidden_size=8),
        probe_epochs=STACKED_BEST_ARGS['probe_epochs'],
        search_rounds=STACKED_BEST_ARGS['search_rounds'], log_every=0,
        params=init[(8, 8)], device='cuda')
    seconds = time.perf_counter() - t0
    best_launches = _read_launches(kernels)
    best_val = float(np.nanmin(best['val_loss']))
    log(f'[stacked] train_best_stacked (8, 8) {STACKED_BEST_ARGS}: '
        f'{seconds:.3f} s wall (host clock), chose {best["preset_choice"]} '
        f'(JAX package: {STACKED_BEST_CHOICE}), probe {best["probe_val"]} '
        f'(JAX: {STACKED_BEST_PROBE_VAL}), tuned rho '
        f'{best["candidate_rho"].get("tuned")} (JAX: {STACKED_BEST_RHO}), '
        f'best val {best_val!r} at epoch {best["best_epoch"]} (JAX: '
        f'{STACKED_BEST_VAL!r}), launches {best_launches}')
    if best['preset_choice'] != STACKED_BEST_CHOICE:
        raise AssertionError(f'train_best_stacked chose '
                             f'{best["preset_choice"]}')
    # The search (one batched program for all 27 candidates), the two
    # probes and the committed run: 150 stacked epochs, 300 chol_solve
    # launches, 150 stacked_sweep and 150 chol_inverse.
    _stacked_launches('train_best_stacked', best_launches,
                      3 * STACKED_BEST_ARGS['probe_epochs']
                      + STACKED_BEST_ARGS['epochs'])
    if best['candidate_rho'].get('tuned') != STACKED_BEST_RHO:
        raise AssertionError(f'train_best_stacked tuned rho '
                             f'{best["candidate_rho"].get("tuned")}')
    for name, want in STACKED_BEST_PROBE_VAL.items():
        np.testing.assert_allclose(best['probe_val'][name], want, rtol=0.05,
                                   atol=1e-4, err_msg=f'probe_val {name}')
    np.testing.assert_allclose(best_val, STACKED_BEST_VAL, rtol=0.05,
                               atol=1e-4, err_msg='train_best_stacked val')

    _stacked_epoch_vs_plain(tx, ty, ps, init[(8, 8)])

    out = tempfile.mkdtemp(prefix='.chip_smoke_ckpt_', dir=ROOT)
    try:
        loaded = load_model(save_model('stacked', best['params'],
                                       save_dir=out), device='cuda')
    finally:
        shutil.rmtree(out, ignore_errors=True)
    same = [torch.equal(a, b) for a, b in zip(loaded.tensors(),
                                              best['params'].tensors())]
    if not (all(same) and len(same) == len(best['params'].tensors())):
        raise AssertionError('stacked save_model/load_model: not bit-equal')
    log('[stacked] save_model/load_model of the committed (8, 8) result: '
        'bit-equal')
    return (launches, best_launches, search_launches,
            dict(search_times, best_seconds=seconds))


def _no_launches(label, fn):
    """Runs `fn` with the launch counts zeroed; raises if any kernel
    launched (the legacy variants and the baselines use none)."""
    kernels = _zero_launches()
    t0 = time.perf_counter()
    res = fn()
    seconds = time.perf_counter() - t0
    launched = {name: n for name, n in _read_launches(kernels).items() if n}
    if launched:
        raise AssertionError(f'{label}: unexpected kernel launches '
                             f'{launched}')
    train_l, val_l = np.asarray(res['train_loss']), np.asarray(res['val_loss'])
    if not (np.all(np.isfinite(train_l)) and np.all(np.isfinite(val_l))):
        raise AssertionError(f'{label}: non-finite losses')
    log(f'[legacy] {label}: {seconds:.3f} s wall (host clock), final train '
        f'{train_l[-1]:.6f} val {val_l[-1]:.6f}, no kernel launches')
    return res, train_l, val_l


def _gap(got, want):
    """Largest relative gap of a trajectory to its reference."""
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got) - want) / np.abs(want)))


def _legacy_epoch_vs_cpu(tx, ty):
    """One ADMM-L and one ADMM-S epoch on the card against the same epoch
    on the CPU, from the state two card epochs reach: each leaf within
    LEGACY_RTOL of its scale (max |x|; for a dual, max |lambda| + rho max
    |its primal|, the primal at T-1 for ADMM-S from a forward pass with
    the new weights)."""
    from admm_lstm_torch.variants import admm_l, admm_s
    x, y = torch.from_numpy(tx), torch.from_numpy(ty)
    x_tm = x.transpose(0, 1).contiguous()
    amax = lambda t: float(t.abs().max())
    worst = 0.0
    for name, mod, rules, demo, step, duals in (
            ('ADMM-L', admm_l, admm_l.ADMMLRules(), admm_l.admm_l_demo,
             admm_l.admm_l_step,
             {'lam_z': ('z', 'rho_singular'), 'lam_g': ('gate', 'rho_plural'),
              'lam9': ('c', 'rho9'), 'lam10': ('h', 'rho10'),
              'lam11': ('a', 'rho11')}),
            ('ADMM-S', admm_s, admm_s.ADMMSRules(), admm_s.admm_s_demo,
             admm_s.admm_s_step,
             {'lam_z': ('z', 'rho_z'), 'lam_g': ('gate', 'rho_g'),
              'lam9': ('c', 'rho9'), 'lam10': ('h', 'rho10'),
              'lam11': ('y', 'rho11')})):
        start = demo(2, 10, tx, ty, tx[:8], ty[:8], log_every=0,
                     device='cuda')['state']
        host = start._replace(**{f: getattr(start, f).cpu() for f in
                                 start._fields if f != 'epoch'})
        with torch.no_grad():
            got = step(start, x_tm.cuda(), y.cuda(), rules)
            ref = step(host, x_tm, y, rules)
        torch.cuda.synchronize()
        primal = ref._asdict()
        if mod is admm_s:
            z, gate, c, h, yp = admm_s._forward(ref, x_tm)
            primal = {'z': z[:, -1], 'gate': gate[:, -1], 'c': c[-1],
                      'h': h[-1], 'y': yp}
        errs = {}
        for f in ref._fields:
            if f == 'epoch':
                continue
            scale = amax(getattr(ref, f))
            if f in duals:
                p, rho = duals[f]
                scale += getattr(rules, rho) * amax(primal[p])
            errs[f] = (amax(getattr(got, f).cpu() - getattr(ref, f)),
                       LEGACY_RTOL * scale)
        ratio = max(e[0] / e[1] for e in errs.values() if e[1] > 0)
        worst = max(worst, ratio)
        log(f'[legacy] {name} one epoch, card vs CPU: largest error '
            f'{ratio:.3g} of its tolerance; (max abs diff, tolerance) per '
            f'leaf {errs}')
        bad = {f: e for f, e in errs.items() if not e[0] <= e[1]}
        if bad:
            raise AssertionError(f'{name}: the card epoch differs from the '
                                 f'CPU epoch beyond tolerance at {bad}')
    return worst


def _legacy_speed(tx, ty, vx, vy, epochs=10):
    """ms per epoch (host clock, synchronized after every epoch, the
    median of the epochs after the first), and from torch.profiler the
    host syncs, device operations and device-busy ms per epoch, of each
    legacy variant and baseline (profile_epoch.legacy_epoch: the epoch
    and its two losses)."""
    from admm_lstm_torch.profile_epoch import legacy_epoch, profile_epochs
    f = lambda a: torch.from_numpy(a).cuda()
    out = {}
    for variant in ('admm_l', 'admm_s', 'sgd', 'adam', 'adagrad'):
        epoch, state = legacy_epoch(variant, 10, f(tx), f(ty), f(vx), f(vy))
        times = []
        for _ in range(epochs):
            t0 = time.perf_counter()
            state = epoch(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof = profile_epochs(epoch, state, 3)
        out[variant] = dict(
            ms_per_epoch=float(np.median(times[1:])),
            host_syncs_per_epoch=prof['host_syncs_per_epoch'],
            device_ops_per_epoch=prof['device_ops_per_epoch'],
            device_busy_ms_per_epoch=prof['device_busy_ms_per_epoch'],
            device_idle_share=prof['device_idle_share'])
        log(f'[legacy] speed {variant} GoogleStock H=10: '
            f'{json.dumps(out[variant])}')
    return out


def phase_legacy(tx, ty, vx, vy, ps, weights):
    """ADMM-LSTM-L and -S, the gradient baselines and the comparison
    harness on GoogleStock at the CLI's width, through their public entry
    points, held to the JAX package's numbers and the goldens.  Returns
    the comparison run's launches."""
    from admm_lstm_torch import api
    from admm_lstm_torch.comparison import run_comparison
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.utils.config import ADMMConfig
    from admm_lstm_torch.variants.admm_l import ADMMLRules, admm_l_demo
    from admm_lstm_torch.variants.admm_s import admm_s_demo
    from admm_lstm_torch.variants.grad_based import train_grad_based
    ref = np.load(LEGACY_REF)
    n = LEGACY_EPOCHS

    # 1. ADMM-L on the JAX trajectory; the golden small problem with the
    # reference's 4224 divisor.
    admm_l_res, train_l, val_l = _no_launches(
        f'admm_l_demo GoogleStock H=10, {n} epochs', lambda: admm_l_demo(
            n, 10, tx, ty, vx, vy, seed=0, log_every=0, device='cuda'))
    log(f'[legacy] admm_l val trajectory {json.dumps(val_l.tolist())}; '
        f'largest relative gap to the JAX package '
        f'{max(_gap(train_l, ref["admm_l_train"]), _gap(val_l, ref["admm_l_val"])):.3g}')
    _hold_to('admm_l_demo', train_l, val_l, ref['admm_l_train'],
             ref['admm_l_val'])
    g = np.load(ADMM_L_GOLDEN)
    _, train_l, val_l = _no_launches(
        'admm_l_demo admm_l_small golden (a_batch_scale 4224)',
        lambda: admm_l_demo(len(g['train_loss']) - 1, 4, g['x'], g['y'],
                            g['test_x'], g['test_y'], seed=0,
                            rules=ADMMLRules(a_batch_scale=4224),
                            log_every=0, device='cuda'))
    np.testing.assert_allclose(train_l, g['train_loss'], rtol=1e-4,
                               atol=1e-7, err_msg='admm_l_small train')
    np.testing.assert_allclose(val_l, g['val_loss'], rtol=1e-4, atol=1e-7,
                               err_msg='admm_l_small val')

    # 2. ADMM-S on its golden.
    g = np.load(ADMM_S_GOLDEN)
    _, train_l, val_l = _no_launches(
        f'admm_s_demo GoogleStock H=10, {int(g["epochs"])} epochs',
        lambda: admm_s_demo(int(g['epochs']), 10, tx, ty, vx, vy, seed=0,
                            log_every=0, device='cuda'))
    log(f'[legacy] admm_s val trajectory {json.dumps(val_l.tolist())}')
    np.testing.assert_allclose(train_l, g['train_loss'], rtol=2e-4,
                               atol=1e-6, err_msg='admm_s golden train')
    np.testing.assert_allclose(val_l, g['val_loss'], rtol=2e-4, atol=1e-6,
                               err_msg='admm_s golden val')

    # 3. The legacy preset.  Its choice must be JAX's.  ADMM-L's probes
    # are held to JAX's at the trajectory tolerance; so is ADMM-S's
    # 'reference' probe, but its r_h 25 and 10 probes are not: those
    # trajectories are unstable (the port on the CPU and the JAX package
    # part by 17% and 115% at epoch 15 though one epoch agrees at 1e-5),
    # so they are held only to rank below 'reference' as JAX's do.
    args = LEGACY_BEST_ARGS
    for variant in ('admm_l', 'admm_s'):
        t0 = time.perf_counter()
        best, _, _ = _no_launches(
            f'train_best {variant} {args}', lambda: api.train_best(
                tx, ty, vx, vy, ps, ADMMConfig(variant=variant, hidden_size=10,
                                               epochs=args['epochs']),
                probe_epochs=args['probe_epochs'], log_every=0,
                device='cuda'))
        seconds = time.perf_counter() - t0
        names = ref[f'best_{variant}_probe_names'].tolist()
        want = dict(zip(names, ref[f'best_{variant}_probe_val'].tolist()))
        choice = str(ref[f'best_{variant}_choice'])
        log(f'[legacy] train_best {variant}: {seconds:.3f} s wall, chose '
            f'{best["preset_choice"]} (JAX package: {choice}), probe '
            f'{best["probe_val"]} (JAX: {want})')
        if best['preset_choice'] != choice:
            raise AssertionError(f'train_best {variant} chose '
                                 f'{best["preset_choice"]}, JAX {choice}')
        for name, v in want.items():
            got = best['probe_val'][name]
            if variant == 'admm_l' or name == 'reference':
                np.testing.assert_allclose(got, v, rtol=0.05, atol=1e-4,
                                           err_msg=f'{variant} probe {name}')
            elif not got < best['probe_val']['reference']:
                raise AssertionError(f'train_best admm_s: probe {name} '
                                     f'{got} not below reference')

    # 4. The baselines from the reference's seed-0 weights.
    grad = {}
    for method in ('sgd', 'adam', 'adagrad'):
        res, train_l, val_l = _no_launches(
            f'{method} {GRAD_EPOCHS} epochs', lambda: train_grad_based(
                method, tx, ty, vx, vy, GRAD_EPOCHS,
                params=params_from_dict(weights), device='cuda'))
        gap = max(_gap(train_l, ref[f'{method}_train']),
                  _gap(val_l, ref[f'{method}_val']))
        log(f'[legacy] {method} final train {float(train_l[-1])!r} val '
            f'{float(val_l[-1])!r} (JAX {float(ref[f"{method}_val"][-1])!r});'
            f' largest relative gap to the JAX package {gap:.3g}')
        _hold_to(method, train_l, val_l, ref[f'{method}_train'],
                 ref[f'{method}_val'])
        grad[res['name']] = res

    # 5. The comparison harness: six curves, each its method's run alone
    # (the baselines' first n + 1 epochs of their runs above); the Fast
    # run's interior_sweep once an epoch, its theta tests at least once a
    # weight stage, and no other launch.
    alone = {'Fast ADMM-LSTM': api.train(
        tx, ty, vx, vy, ps, ADMMConfig(epochs=n, hidden_size=10),
        params=params_from_dict(weights), log_every=0, device='cuda'),
        'ADMM-LSTM-L': admm_l_res,
        'ADMM-LSTM-S': admm_s_demo(n, 10, tx, ty, vx, vy, seed=0,
                                   log_every=0, device='cuda'), **grad}
    kernels = _zero_launches()
    t0 = time.perf_counter()
    results = run_comparison(n, 10, tx, ty, vx, vy, ps, include_admm_l=True,
                             include_admm_s=True,
                             params=params_from_dict(weights), device='cuda')
    seconds = time.perf_counter() - t0
    launches = _read_launches(kernels)
    names = [r['name'] for r in results]
    log(f'[legacy] run_comparison {n} epochs: {seconds:.3f} s wall, '
        f'{names}, launches {launches}')
    if names != ['Fast ADMM-LSTM', 'ADMM-LSTM-L', 'ADMM-LSTM-S', 'SGD',
                 'Adam', 'Adagrad']:
        raise AssertionError(f'run_comparison returned {names}')
    for r in results:
        for key in ('train_loss', 'val_loss'):
            np.testing.assert_allclose(
                r[key], alone[r['name']][key][:n + 1], rtol=COMPARISON_RTOL,
                err_msg=f'run_comparison {r["name"]} {key}')
    if launches != {'interior_sweep': n, 'jacobi_sweep': 0, 'chol_solve': 0,
                    'chol_inverse': 0, 'floor_sweep': 0,
                    'theta_tests': max(launches['theta_tests'], 2 * n),
                    'stacked_sweep': 0, 'interior_sweep[candidates]': 0,
                    'jacobi_sweep[candidates]': 0, 'exact_gram': 0}:
        raise AssertionError(f'run_comparison launches {launches}')

    # 6. One epoch of each variant on the card against the CPU.
    _legacy_epoch_vs_cpu(tx, ty)
    _legacy_speed(tx, ty, vx, vy)
    return launches


def _scenario_inits():
    """The golden seed-split inits as LSTMParams with a leading scenario
    axis, on the card."""
    from admm_lstm_torch.models.lstm import params_from_numpy
    g = np.load(SCEN_INIT)
    gates = lambda side: np.stack([g[f'w0_{side}2{q}'] for q in 'ifgo'], 1)
    return params_from_numpy(gates('x'), gates('h'), g['w0_wy'],
                             device='cuda')


def _scenario_report(train, val):
    """Each scenario's largest relative gap to SCEN_* (over all epochs and
    before a jump), first epoch past SCEN_RTOL (None if none), and whether
    JAX's validation loss jumps."""
    report = []
    for s in range(SCEN_COUNT):
        ref_t, ref_v = np.asarray(SCEN_TRAIN[s]), np.asarray(SCEN_VAL[s])
        gap = np.maximum(np.abs(train[s] - ref_t) / np.abs(ref_t),
                         np.abs(val[s] - ref_v) / np.abs(ref_v))
        past = np.nonzero(gap > SCEN_RTOL)[0]
        jump = bool(np.any(ref_v[SCEN_JUMP_FROM:] > SCEN_JUMP))
        held = SCEN_JUMP_FROM if jump else SCEN_EPOCHS + 1
        report.append(dict(scenario=s, largest_gap=float(gap.max()),
                           largest_gap_held=float(gap[:held].max()),
                           first_epoch_past_rtol=int(past[0])
                           if len(past) else None,
                           jax_jump=jump))
    return report


def _hold_scenarios(train, val):
    """SCEN_TRAIN/SCEN_VAL gates (see SCEN_RTOL); returns
    _scenario_report."""
    report = _scenario_report(train, val)
    for s, r in enumerate(report):
        ref_t, ref_v = np.asarray(SCEN_TRAIN[s]), np.asarray(SCEN_VAL[s])
        held = SCEN_JUMP_FROM if r['jax_jump'] else SCEN_EPOCHS + 1
        k = SCEN_STRICT_EPOCHS + 1
        np.testing.assert_allclose(train[s][:k], ref_t[:k], rtol=SCEN_RTOL,
                                   err_msg=f'scenario {s} train, strict')
        np.testing.assert_allclose(val[s][:k], ref_v[:k], rtol=SCEN_RTOL,
                                   err_msg=f'scenario {s} val, strict')
        np.testing.assert_allclose(train[s][:held], ref_t[:held],
                                   rtol=SCEN_HELD_RTOL,
                                   err_msg=f'scenario {s} train')
        np.testing.assert_allclose(val[s][:held], ref_v[:held],
                                   rtol=SCEN_HELD_RTOL,
                                   err_msg=f'scenario {s} val')
        if r['jax_jump'] and not np.any(val[s][SCEN_JUMP_FROM:] > SCEN_JUMP):
            raise AssertionError(
                f'scenario {s}: the JAX package\'s validation loss jumps '
                f'above {SCEN_JUMP} from epoch {SCEN_JUMP_FROM}, the card\'s '
                f'does not: {val[s][SCEN_JUMP_FROM:].tolist()}')
    return report


def _wy_safeguard(states, theta):
    """Per final state: rho_y * lambda_max(h_T h_T^T), the Lipschitz
    bound of the readout step, and whether it exceeds the variant's fixed
    theta (the safeguard binds)."""
    out = []
    for st in states:
        h = st.gates.h[-1]
        lip = float(st.rho.y * torch.linalg.eigvalsh(h @ h.T)[-1])
        out.append(dict(lip=lip, binds=lip > theta))
    return out


def _loose_folds():
    """The JAX bench's yahoo_scenarios_loose data: SCEN_COUNT unshuffled
    folds of the YahooFinance training and validation windows, and the
    YahooFinance parameter set."""
    from admm_lstm_torch.data import load_dataset
    (tx, ty, vx, vy), ps, _ = load_dataset('YahooFinance')
    fold, vfold = len(tx) // SCEN_COUNT, len(vx) // SCEN_COUNT
    folds = lambda a, n: np.stack([a[i * n:(i + 1) * n]
                                   for i in range(SCEN_COUNT)])
    return (folds(tx, fold), folds(ty, fold), folds(vx, vfold),
            folds(vy, vfold)), ps


def _scenario_turbo(card):
    """train_scenarios on the yahoo_scenarios_loose folds under turbo()
    (no_dual_y, wy_lipschitz, 'highest'), SCEN_TURBO_EPOCHS epochs, one
    batched program: one jacobi_sweep launch and two exact_gram and two
    chol_solve an epoch for the four, each scenario's losses finite and
    within SCEN_TURBO_RTOL of its api.train run alone.  Returns the
    batched run's launches."""
    from admm_lstm_torch import api
    from admm_lstm_torch.models.lstm import LSTMParams
    from admm_lstm_torch.utils.config import ADMMConfig
    data, ps = _loose_folds()
    epochs = SCEN_TURBO_EPOCHS
    cfg = ADMMConfig.turbo(variant='no_dual_y', matmul_precision='highest',
                           wy_lipschitz=True, hidden_size=10, epochs=epochs)
    params = api.scenario_inits(cfg.seed, SCEN_COUNT, data[0].shape[3], 10,
                                data[1].shape[2], 'cuda')
    kernels = _zero_launches()
    res = api.train_scenarios(*data, ps, cfg, params=params, device='cuda')
    launches = _read_launches(kernels)
    if not (np.all(np.isfinite(res['train_loss']))
            and np.all(np.isfinite(res['val_loss']))):
        raise AssertionError(f'turbo() scenarios: non-finite losses '
                             f'{res["val_loss"].tolist()}')
    gaps = []
    for s in range(SCEN_COUNT):
        run = api.train(*(d[s] for d in data), ps, cfg,
                        params=LSTMParams(*(w[s] for w in params)),
                        log_every=0, device='cuda')
        for key in ('train_loss', 'val_loss'):
            want = np.asarray(run[key])
            gaps.append(float(np.max(np.abs(res[key][s] - want)
                                     / np.abs(want))))
            np.testing.assert_allclose(
                res[key][s], want, rtol=SCEN_TURBO_RTOL,
                err_msg=f'turbo() scenario {s} {key} against its run alone')
    log(f'[scenarios] train_scenarios {SCEN_COUNT} x {epochs} epochs under '
        f'turbo(no_dual_y, wy_lipschitz, highest) in one batched program on '
        f'{card}: {res["seconds"]:.3f} s; largest relative gap to the runs '
        f'alone {max(gaps):.3g} (held at {SCEN_TURBO_RTOL}); launches '
        f'{launches}')
    want = {'jacobi_sweep': epochs, 'jacobi_sweep[candidates]': epochs,
            'chol_solve': 2 * epochs, 'exact_gram': 2 * epochs,
            'interior_sweep': 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f'turbo() scenarios: launches {launches}, '
                             f'expected {want}')
    return launches


def _scenario_speed(card):
    """The JAX bench's yahoo_scenarios_loose through train_scenarios on
    the card (one batched program, one interior_sweep launch an epoch),
    beside the scenario-epochs/s of the scenarios one after another
    (SCEN_SPEED_BEFORE); torch.profiler's view of one scenario epoch
    (epoch_step: the epoch and its losses) with and without the Lipschitz
    step, and of one batched epoch of the SCEN_COUNT scenarios under the
    CLI's config (profile_epoch --candidates SCEN_COUNT --scenarios)."""
    from admm_lstm_torch import api
    from admm_lstm_torch.core.init import init_admm_state
    from admm_lstm_torch.core.step import epoch_step, rules_for
    from admm_lstm_torch.models.lstm import init_lstm_params
    from admm_lstm_torch.profile_epoch import profile_epochs, scenario_batch
    from admm_lstm_torch.utils.config import ADMMConfig
    data, ps = _loose_folds()
    fold = data[0].shape[1]
    cfg = ADMMConfig(variant='no_dual_y', hidden_size=10,
                     epochs=SCEN_SPEED_EPOCHS, wy_lipschitz=True)
    kernels = _zero_launches()
    res = api.train_scenarios(*data, ps, cfg, device='cuda')
    launches = _read_launches(kernels)
    n = SCEN_COUNT * SCEN_SPEED_EPOCHS
    if not np.all(np.isfinite(res['train_loss'])):
        raise AssertionError('scenario speed run: non-finite losses')
    if (launches['interior_sweep'] != SCEN_SPEED_EPOCHS
            or launches['interior_sweep[candidates]'] != SCEN_SPEED_EPOCHS):
        raise AssertionError(f'scenario speed run: launches {launches}')
    speed = dict(fold_batch=fold, epochs=SCEN_SPEED_EPOCHS,
                 seconds=res['seconds'],
                 scenario_epochs_per_s=n / res['seconds'],
                 one_after_another_scenario_epochs_per_s=SCEN_SPEED_BEFORE,
                 ms_per_scenario_epoch=res['seconds'] * 1e3 / n,
                 final_train_loss=res['train_loss'][:, -1].tolist(),
                 wy_safeguard=_wy_safeguard(res['state'],
                                            rules_for(cfg).wy_theta))
    f = lambda a: torch.from_numpy(a[0]).cuda()
    x, y, vx0, vy0 = map(f, data)
    x_im, y_im, xall_im, vy_im = api.batch_minor(x, y, vx0, vy0)
    for name, c in (('no_dual_y', cfg),
                    ('fast', cfg.replace(variant='fast')),
                    ('fast_no_lipschitz', cfg.replace(variant='fast',
                                                      wy_lipschitz=False))):
        rules = rules_for(c)
        state = init_admm_state(init_lstm_params(
            torch.Generator().manual_seed(0), 1, 10, 1, device='cuda'), x,
            ps, c)
        prof = profile_epochs(
            lambda st: epoch_step(st, x_im, y_im, xall_im, vy_im, rules)[0],
            state, 10)
        speed[f'profile_{name}'] = {k: v for k, v in prof.items()
                                    if k != 'top_kernels_ms_per_epoch'}
    c, (x_im, y_im, xall_im, vy_im), state = scenario_batch(
        SCEN_COUNT, 10, torch.device('cuda'))
    rules = rules_for(c)
    prof = profile_epochs(
        lambda st: epoch_step(st, x_im, y_im, xall_im, vy_im, rules)[0],
        state, 10)
    speed['profile_batched_fast'] = {k: v for k, v in prof.items()
                                     if k != 'top_kernels_ms_per_epoch'}
    log(f'[scenarios] speed (yahoo_scenarios_loose, {SCEN_COUNT} folds of '
        f'{fold}, {SCEN_SPEED_EPOCHS} epochs, no_dual_y + wy_lipschitz) on '
        f'{card}: {json.dumps(speed)}; launches {launches}')
    return launches


def _scenario_cli_and_visualize():
    """The CLI (--scenarios 4 --save --record_matlab_data) and then
    visualize over its SAVED_MODELS/, each a process of its own in a
    temporary directory; the saved models' predictions on the card held
    to the CPU's.  visualize runs with --no-plot, and plots too where
    matplotlib is installed (else it must exit 1 naming matplotlib)."""
    import importlib.util
    import scipy.io as sio
    import tempfile
    from admm_lstm_torch import visualize
    from admm_lstm_torch.data import load_dataset
    env = dict(os.environ, PYTHONPATH=ROOT, ADMM_TORCH_NO_FILELOG='1')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_cli_') as tmp:
        def run(*args, want=0):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, '-m', *args], cwd=tmp,
                                  env=env, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != want:
                raise AssertionError(f'{args}: exit {proc.returncode}\n'
                                     f'{proc.stdout[-3000:]}'
                                     f'{proc.stderr[-3000:]}')
            return time.perf_counter() - t0, proc.stdout
        t_cli, _ = run('admm_lstm_torch.cli', '-y', '-d', 'YahooFinance',
                       '--scenarios', str(SCEN_COUNT), '-e', '5', '--save',
                       '--record_matlab_data', '--no-plot')
        save_dir = os.path.join(tmp, 'SAVED_MODELS')
        saved = sorted(os.listdir(save_dir))
        if len(saved) != SCEN_COUNT or not all(
                n.endswith('.npz') for n in saved):
            raise AssertionError(f'--save wrote {saved}')
        mat = sio.loadmat(os.path.join(tmp, 'ADMM_Val.mat'))
        loss = mat['loss'].ravel()
        if loss.shape != (6,) or not np.all(np.isfinite(loss)):
            raise AssertionError(f'ADMM_Val.mat loss {loss}')
        t_vis, out = run('admm_lstm_torch.visualize', '-d', 'YahooFinance',
                         '--save_dir', save_dir, '--no-plot')
        if out.count('test MSE') != SCEN_COUNT:
            raise AssertionError(f'visualize --no-plot logged\n{out}')
        (_, _, test_x, _), _, _ = load_dataset('YahooFinance')
        card = visualize.predict_all(visualize.load_models(save_dir), test_x)
        cpu = visualize.predict_all(
            visualize.load_models(save_dir, device='cpu'), test_x)
        pred_err = max(float(np.abs(card[k] - cpu[k]).max()) for k in cpu)
        if sorted(card) != sorted(n[:-4] for n in saved) or pred_err > 1e-5:
            raise AssertionError(f'visualize on the card: models '
                                 f'{sorted(card)}, error {pred_err}')
        png = os.path.join(tmp, 'plots', 'Predictions.png')
        if importlib.util.find_spec('matplotlib') is not None:
            run('admm_lstm_torch.visualize', '-d', 'YahooFinance',
                '--save_dir', save_dir)
            plotted = f'{os.path.getsize(png)} bytes'
        else:
            _, out = run('admm_lstm_torch.visualize', '-d', 'YahooFinance',
                         '--save_dir', save_dir, want=1)
            if 'matplotlib' not in out or os.path.exists(png):
                raise AssertionError(f'visualize without matplotlib:\n{out}')
            plotted = 'exit 1 naming matplotlib (not installed)'
        log(f'[scenarios] CLI --scenarios {SCEN_COUNT} -e 5 --save '
            f'--record_matlab_data: exit 0 in {t_cli:.2f} s, {saved}, '
            f'ADMM_Val.mat loss {loss.tolist()}; visualize --no-plot: exit '
            f'0 in {t_vis:.2f} s, {SCEN_COUNT} test MSEs; predictions on '
            f'the card within {pred_err:.3g} of the CPU\'s; '
            f'plots/Predictions.png: {plotted}')


def _scenario_trace(xs, ys, vxs, vys, ps, cfg, params):
    """profile_trace around one scenario epoch under
    span('scenario-epoch'); the trace must name the kernel and the
    region."""
    import tempfile
    from admm_lstm_torch import api
    from admm_lstm_torch.models.lstm import LSTMParams
    from admm_lstm_torch.utils.observe import profile_trace, span
    with tempfile.TemporaryDirectory(prefix='chip_smoke_trace_') as tmp:
        with profile_trace(tmp):
            with span('scenario-epoch'):
                api.train_scenarios(
                    xs[:1], ys[:1], vxs[:1], vys[:1], ps,
                    cfg.replace(epochs=1),
                    params=LSTMParams(*(w[:1] for w in params)),
                    device='cuda')
            torch.cuda.synchronize()
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as fh:
            text = fh.read()
    found = {k: k in text for k in ('interior_sweep_kernel',
                                    'scenario-epoch')}
    log(f'[scenarios] profile_trace of one scenario epoch: {len(text)} '
        f'bytes, names {found}')
    if not all(found.values()):
        raise AssertionError(f'the trace lacks {found}')


def phase_scenarios(card):
    """api.train_scenarios on the CLI's --scenarios 4 config, held to the
    JAX package's losses from its seed-split inits, in one batched program
    (one interior_sweep launch an epoch for all the scenarios), its TF32
    run refused by the same hold; the JAX bench's scenario config timed;
    the CLI and visualize; a profile_trace.  Returns the launches of the
    parity run and of the speed run."""
    from admm_lstm_torch import api
    from admm_lstm_torch.core.step import rules_for
    from admm_lstm_torch.data.yahoo_finance import load_scenarios
    from admm_lstm_torch.params import parameter_set
    from admm_lstm_torch.utils.config import ADMMConfig
    xs, ys, vxs, vys = load_scenarios(num_scenarios=SCEN_COUNT, seed=0)
    ps = parameter_set('YahooFinance')
    cfg = ADMMConfig(variant='fast', hidden_size=10, epochs=SCEN_EPOCHS,
                     seed=0, wy_lipschitz=True)
    params = _scenario_inits()
    kernels = _zero_launches()
    res = api.train_scenarios(xs, ys, vxs, vys, ps, cfg, params=params,
                              device='cuda')
    launches = _read_launches(kernels)
    train, val = res['train_loss'], res['val_loss']
    log(f'[scenarios] train_scenarios {SCEN_COUNT} x {SCEN_EPOCHS} epochs '
        f'in one batched program (fast, H 10, wy_lipschitz) on {card}: '
        f'{res["seconds"]:.3f} s, launches {launches}; val trajectories '
        f'{json.dumps(val.tolist())}')
    if not (np.all(np.isfinite(train)) and np.all(np.isfinite(val))):
        raise AssertionError('scenarios: non-finite losses')
    if launches != {'interior_sweep': SCEN_EPOCHS, 'jacobi_sweep': 0,
                    'chol_solve': 0, 'chol_inverse': 0, 'floor_sweep': 0,
                    'theta_tests': max(launches['theta_tests'],
                                       2 * SCEN_EPOCHS),
                    'stacked_sweep': 0,
                    'interior_sweep[candidates]': SCEN_EPOCHS,
                    'jacobi_sweep[candidates]': 0, 'exact_gram': 0}:
        raise AssertionError(f'scenarios: launches {launches}')
    report = _hold_scenarios(train, val)
    # The control: the same batched program with TF32 matmuls allowed must
    # fail the hold.
    control = api.train_scenarios(xs, ys, vxs, vys, ps,
                                  cfg.replace(matmul_precision='high'),
                                  params=params, device='cuda')
    try:
        _hold_scenarios(control['train_loss'], control['val_loss'])
    except AssertionError as e:
        refused = ' / '.join(line.strip() for line in
                             str(e).strip().splitlines()[:2])
    else:
        raise AssertionError('scenarios: the TF32 control run passes the '
                             'hold')
    gaps = [(r['largest_gap_held'], r['first_epoch_past_rtol'])
            for r in _scenario_report(control['train_loss'],
                                      control['val_loss'])]
    theta = rules_for(cfg).wy_theta
    log(f'[scenarios] against the JAX package: {json.dumps(report)}; '
        f'the TF32 control (the same batched program) refused ({refused}), '
        f'its (largest gap before a jump, first epoch past SCEN_RTOL) '
        f'{gaps}; readout safeguard at the final states (theta {theta}): '
        f'{json.dumps(_wy_safeguard(res["state"], theta))}')
    speed_launches = _scenario_speed(card)
    turbo_launches = _scenario_turbo(card)
    _scenario_cli_and_visualize()
    _scenario_trace(xs, ys, vxs, vys, ps, cfg, params)
    return launches, speed_launches, turbo_launches


def _sharded_rank(rank, world, job):
    """One rank of the `sharded` phase (parallel/launch.spawn runs it in a
    process of its own): `job['kind']` 'train' drives api.train_sharded
    twice, the first run paying the new process's first-use costs (the
    cuBLAS handle, the kernels' modules) and the second measured, then
    times one all-reduce; 'epochs' drives the sharded epoch function one
    epoch at a time, reading rho after each.  The launch counts are
    zeroed just before the measured run and read just after, in this
    process."""
    from admm_lstm_torch import api
    from admm_lstm_torch.core.init import init_admm_state
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.parallel import (make_mesh, make_sharded_epoch_fn,
                                          pad_batch, shard_batch)
    from admm_lstm_torch.utils.device import matmul_precision
    from admm_lstm_torch.utils.logging import set_console_enabled
    set_console_enabled(False)
    tx, ty, vx, vy = job['data']
    cfg, ps = job['config'], job['ps']
    params = params_from_dict(job['weights'])
    if job['kind'] == 'train':
        run = lambda: api.train_sharded(tx, ty, vx, vy, ps, cfg,
                                        params=params, log_every=0,
                                        device='cuda')
        cold = run()
        kernels = _zero_launches()
        res = run()
        res['launches'] = _read_launches(kernels)
        res['cold_seconds'] = cold['seconds']
        res['all_reduce_ms'] = _all_reduce_ms()
        return res
    mesh = make_mesh(cfg.mesh_shape, device='cuda')
    x, y = shard_batch(*pad_batch(tx, ty, world), mesh)
    vx_t, vy_t = (torch.from_numpy(a).to(mesh.device) for a in (vx, vy))
    epoch = make_sharded_epoch_fn(cfg, mesh)
    rho, val = [], []
    with matmul_precision(cfg.matmul_precision):
        state = init_admm_state(params.to(mesh.device), x, ps, cfg)
        kernels = _zero_launches()
        torch.cuda.synchronize()
        ends = [time.perf_counter()]
        for _ in range(cfg.epochs):
            state, metrics = epoch(state, x, y, vx_t, vy_t)
            rho.append([float(getattr(state.rho, k)) for k in 'cfghioy'])
            val.append(float(metrics['val_loss']))
            ends.append(time.perf_counter())      # the reads synchronize
    return {'rho': rho, 'val_loss': val, 'params': state.params,
            'epoch_ms': float(np.median(np.diff(ends)[1:]) * 1e3),
            'mesh': mesh.describe(),
            'launches': _read_launches(kernels)}


def _all_reduce_ms(reps=200):
    """Host-clock ms of one all-reduce of a 16-float CUDA tensor (an
    epoch's typical size) over the process group, warm; None at world
    1."""
    import torch.distributed as dist
    if dist.get_world_size() == 1:
        return None
    t = torch.zeros(16, device='cuda')
    for _ in range(10):
        dist.all_reduce(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(t)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _per_epoch(mesh, epochs, first=1):
    """All-reduces and bytes all-reduced per epoch on one rank, without
    the `first` reductions made before the epochs (the initial losses)."""
    calls = (mesh['all_reduces'] - first) / epochs
    return calls, mesh['bytes_all_reduced'] / epochs


def phase_sharded(tx, ty, vx, vy, ps, weights, slice1_train, slice1_val,
                  card):
    from admm_lstm_torch import api
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.parallel.launch import spawn
    from admm_lstm_torch.utils.config import ADMMConfig
    data = (tx, ty, vx, vy)
    job = lambda kind, cfg: dict(kind=kind, data=data, config=cfg, ps=ps,
                                 weights=weights)
    run = lambda world, backend, one_job: spawn(
        _sharded_rank, world, args=(one_job,), backend=backend,
        timeout=SHARDED_TIMEOUT)

    # Two gloo ranks on the one card, the default config.
    cfg = ADMMConfig(epochs=EPOCHS, hidden_size=10, mesh_shape=(2,))
    ranks = run(2, 'gloo', job('train', cfg))
    r0 = ranks[0]
    train_l, val_l = np.asarray(r0['train_loss']), np.asarray(r0['val_loss'])
    np.testing.assert_allclose(train_l, slice1_train, rtol=SHARDED_RTOL)
    np.testing.assert_allclose(val_l, slice1_val, rtol=SHARDED_RTOL)
    if not val_l[-1] <= REF_VAL_30 * 1.05:
        raise AssertionError(f'sharded val30 {val_l[-1]} above the '
                             f'reference {REF_VAL_30} x 1.05')
    for a, b in zip(r0['params'], ranks[1]['params']):
        if not torch.equal(a, b):
            raise AssertionError('sharded: the ranks\' weights differ')
    for rank, r in enumerate(ranks):
        if r['launches']['interior_sweep'] != EPOCHS:
            raise AssertionError(f'sharded rank {rank}: interior_sweep '
                                 f'launched {r["launches"]}')
    calls, nbytes = _per_epoch(r0['mesh'], EPOCHS)
    log(f'[sharded] 2 gloo ranks on one card, default config: val30 '
        f'{val_l[-1]:.6f}, largest gap to slice 1 '
        f'{_gap(val_l, slice1_val):.3g}, weights bit-equal, launches per '
        f'rank {[r["launches"] for r in ranks]}; '
        f'{[r["seconds"] * 1e3 / EPOCHS for r in ranks]} ms/epoch per rank '
        f'warm ({[r["cold_seconds"] * 1e3 / EPOCHS for r in ranks]} in '
        f'the first run of the process; host clock, synchronized; two '
        f'ranks share one card, not a scaling figure) on {card}; '
        f'{calls!r} all-reduces and {nbytes!r} bytes all-reduced per epoch '
        f'per rank; one all-reduce of 16 floats '
        f'{[r["all_reduce_ms"] for r in ranks]} ms')
    out = {'sharded': r0['launches']}

    # The same two ranks under auto() at 'highest', rho after every epoch.
    cfg = ADMMConfig.auto(epochs=EPOCHS, hidden_size=10,
                          matmul_precision='highest', mesh_shape=(2,))
    single = api.ADMMBasedOptimizer(params_from_dict(weights), (tx, ty), ps,
                                    cfg.replace(mesh_shape=None),
                                    device='cuda')
    want_rho = []
    for _ in range(EPOCHS):
        single.step()
        want_rho.append([float(getattr(single.state.rho, k))
                         for k in 'cfghioy'])
    want_val = api.train(tx, ty, vx, vy, ps, cfg.replace(mesh_shape=None),
                         params=params_from_dict(weights), log_every=0,
                         device='cuda')['val_loss'][1:]
    ranks = run(2, 'gloo', job('epochs', cfg))
    for rank, r in enumerate(ranks):
        if r['rho'] != want_rho:
            bad = [e + 1 for e in range(EPOCHS) if r['rho'][e] != want_rho[e]]
            raise AssertionError(f'sharded auto rank {rank}: rho differs '
                                 f'from the single-process run after '
                                 f'epochs {bad}')
        need(r['launches'], 'jacobi_sweep', EPOCHS, f'sharded auto {rank}')
        need(r['launches'], 'chol_solve', 2 * EPOCHS, f'sharded auto {rank}')
    np.testing.assert_allclose(ranks[0]['val_loss'], want_val,
                               rtol=SHARDED_RTOL)
    for a, b in zip(ranks[0]['params'], ranks[1]['params']):
        if not torch.equal(a, b):
            raise AssertionError('sharded auto: the ranks\' weights differ')
    calls, nbytes = _per_epoch(ranks[0]['mesh'], EPOCHS, first=0)
    log(f'[sharded] 2 gloo ranks on one card, auto() at highest: rho equal '
        f'to the single-process run after every epoch, val30 '
        f'{ranks[0]["val_loss"][-1]:.6f} (single process '
        f'{want_val[-1]:.6f}), launches per rank '
        f'{[r["launches"] for r in ranks]}; '
        f'{[r["epoch_ms"] for r in ranks]} ms/epoch per rank (the median '
        f'epoch after the first, host clock, a rho read an epoch; one card '
        f'shared) on {card}; '
        f'{calls!r} all-reduces and {nbytes!r} bytes all-reduced per epoch '
        f'per rank')
    out['sharded_auto'] = ranks[0]['launches']

    # One NCCL rank: an all-reduce over one rank changes no sum.
    cfg = ADMMConfig(epochs=5, hidden_size=10)
    want = api.train(tx, ty, vx, vy, ps, cfg, params=params_from_dict(weights),
                     log_every=0, device='cuda')
    (got,) = run(1, 'nccl', job('train', cfg.replace(mesh_shape=(1,))))
    if got['mesh']['backend'] != 'nccl':
        raise AssertionError(f'NCCL rank ran on {got["mesh"]["backend"]}')
    if (got['train_loss'] != want['train_loss']
            or got['val_loss'] != want['val_loss']):
        raise AssertionError('NCCL world 1 differs from api.train: '
                             f'{got["val_loss"]} vs {want["val_loss"]}')
    for a, b in zip(got['params'], want['params']):
        if not torch.equal(a, b.cpu()):
            raise AssertionError('NCCL world 1 weights differ from '
                                 'api.train')
    log(f'[sharded] 1 NCCL rank, 5 epochs: bit-equal to api.train; '
        f'{got["seconds"] * 1e3 / 5!r} ms/epoch warm '
        f'({got["cold_seconds"] * 1e3 / 5!r} in the first run of the '
        f'process; api.train here {want["seconds"] * 1e3 / 5!r}) on '
        f'{card}')
    return out


def _layout_rank(rank, world, cases):
    """One rank of the seqpar and tp phases (parallel/launch.spawn runs it
    in a process of its own): each case is parallel/launch.run_layout's
    keywords, run in order in the one process group.  The kernels' launch
    counts are zeroed just before each run and read just after, in this
    process."""
    from admm_lstm_torch.parallel.launch import run_layout
    from admm_lstm_torch.utils.logging import set_console_enabled
    set_console_enabled(False)
    out = []
    for case in cases:
        kernels = _zero_launches()
        res = run_layout(**case)
        res['launches'] = _read_launches(kernels)
        out.append(res)
    return out


def _run_layouts(cases):
    """[[rank 0's result, rank 1's] for each case]: two gloo ranks on the
    one card."""
    from admm_lstm_torch.parallel.launch import spawn
    ranks = spawn(_layout_rank, 2, args=(cases,), backend='gloo',
                  timeout=SHARDED_TIMEOUT)
    return [list(r) for r in zip(*ranks)]


def _hold_layout(label, ranks, ref_train, ref_val, ref_params=None):
    """Rank 0's losses after every epoch within LAYOUT_RTOL relative of
    one process's, each gathered weight leaf within LAYOUT_RTOL of the
    reference leaf's largest |value|, and every rank's gathered weights
    bit-equal.  Returns the largest relative gaps."""
    r0 = ranks[0]
    for key, ref in (('train_loss', ref_train), ('val_loss', ref_val)):
        got = np.asarray(r0[key])
        if not (np.all(np.isfinite(got)) and got.shape == np.shape(ref)):
            raise AssertionError(f'{label}: {key} {got.tolist()}')
        np.testing.assert_allclose(got, ref, rtol=LAYOUT_RTOL,
                                   err_msg=f'{label} {key}')
    gaps = {'val_loss': _gap(np.asarray(r0['val_loss']), np.asarray(ref_val)),
            'train_loss': _gap(np.asarray(r0['train_loss']),
                               np.asarray(ref_train))}
    for k in ('wx', 'wh', 'wy') if ref_params is not None else ():
        got = getattr(r0['state'].params, k)
        want = getattr(ref_params, k).detach().cpu()
        scale = float(want.abs().max())
        gaps[k] = float((got - want).abs().max()) / scale
        if not gaps[k] <= LAYOUT_RTOL:
            raise AssertionError(f'{label}: {k} differs from one process '
                                 f'by {gaps[k]} of its scale')
    for r in ranks[1:]:
        for a, b in zip(r['state'].params, r0['state'].params):
            if not torch.equal(a, b):
                raise AssertionError(f'{label}: the ranks\' weights differ')
    return gaps


def _per_epoch_axes(mesh, epochs):
    """{axis: {collective: [calls, bytes]} per epoch} of one rank, for
    the collectives that the run made."""
    return {axis: {kind: [c['calls'] / epochs, c['bytes'] / epochs]
                   for kind, c in counts.items() if c['calls']}
            for axis, counts in mesh['collectives'].items()}


def _launch_gate(label, ranks, want):
    for rank, r in enumerate(ranks):
        got = {k: r['launches'][k] for k in want}
        if got != want:
            raise AssertionError(f'{label} rank {rank}: launches '
                                 f'{r["launches"]}, expected {want}')


def phase_seqpar(card):
    """The time-sharded Jacobi layout at the JAX long-T bench's shape on
    two gloo ranks sharing the card, against one process."""
    from admm_lstm_torch import api
    from admm_lstm_torch.data.synthetic import load as synth_load
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.params import parameter_set
    from admm_lstm_torch.utils.config import ADMMConfig
    data = synth_load(seed=0, **SEQPAR_SHAPE)
    ps = parameter_set('Synthetic')
    weights = numpy_weights(SEQPAR_SHAPE['input_size'], SEQPAR_HIDDEN,
                            SEQPAR_SHAPE['output_size'], seed=0)
    cfg = ADMMConfig(sweep_mode='jacobi', hidden_size=SEQPAR_HIDDEN,
                     epochs=SEQPAR_EPOCHS)
    ref = api.train(*data, ps, cfg, params=params_from_dict(weights),
                    log_every=0, device='cuda')
    (ranks,) = _run_layouts([dict(
        mesh_shape=(2,), shard_time=True, config=cfg, parameter_set=ps,
        params=params_from_dict(weights), data=data, epochs=SEQPAR_EPOCHS,
        device='cuda')])
    gaps = _hold_layout('seqpar', ranks, ref['train_loss'][1:],
                        ref['val_loss'][1:], ref['params'])
    _launch_gate('seqpar', ranks, {'jacobi_sweep': SEQPAR_EPOCHS,
                                   'interior_sweep': 0})
    from admm_lstm_torch.core.consensus import time_block
    blocks = [r['block'] for r in ranks]
    want = [(hi - lo, SEQPAR_HIDDEN, SEQPAR_SHAPE['batch']) for lo, hi in
            (time_block(SEQPAR_SHAPE['seq_len'] + 1, k, 2) for k in (0, 1))]
    if blocks != want:
        raise AssertionError(f'seqpar: time blocks {blocks}, not {want}')
    log(f'[seqpar] B 256, T 512, H 16, Jacobi, 2 gloo ranks on one card, '
        f'time blocks {blocks}: {SEQPAR_EPOCHS} epochs, largest relative '
        f'gaps to one process {gaps}, weights bit-equal across ranks, '
        f'round trip bit-equal {[r["round_trip"] for r in ranks]}; '
        f'launches per rank {[r["launches"] for r in ranks]}; ms/epoch per '
        f'rank (median after the first, host clock, each epoch read back) '
        f'{[float(np.median(r["epoch_ms"][1:])) for r in ranks]}, one '
        f'process {ref["seconds"] * 1e3 / SEQPAR_EPOCHS!r} (train loop, '
        f'synchronized) on {card}; collectives [calls, bytes] per epoch per '
        f'axis per rank {[_per_epoch_axes(r["mesh"], SEQPAR_EPOCHS) for r in ranks]}')
    return ranks[0]['launches']


def phase_tp(tx, ty, vx, vy, ps, weights, slice1_train, slice1_val, card):
    """Hidden-axis tensor parallelism on a (1, 2) mesh, two gloo ranks
    sharing the card: Path B's shape at 'highest' (the Jacobi kernel and
    both Cholesky kernels on each rank's columns) against one process,
    and slice 1's GoogleStock default config (the Gauss-Seidel kernel on
    the slabs gathered to the whole H) against slice 1's trajectory."""
    from admm_lstm_torch import api
    from admm_lstm_torch.data.synthetic import load as synth_load
    from admm_lstm_torch.models.lstm import init_lstm_params, params_from_dict
    from admm_lstm_torch.params import parameter_set
    from admm_lstm_torch.utils.config import ADMMConfig
    har = synth_load(seed=0, **HAR_SHAPE)
    har_ps = parameter_set('HAR')
    har_params = init_lstm_params(torch.Generator().manual_seed(0),
                                  HAR_SHAPE['input_size'], HAR_HIDDEN,
                                  HAR_SHAPE['output_size'])
    har_cfg = ADMMConfig.turbo(hidden_size=HAR_HIDDEN,
                               exact_solve_max_dim=1024,
                               matmul_precision='highest', epochs=TP_EPOCHS)
    ref = api.train(*har, har_ps, har_cfg, params=har_params, log_every=0,
                    device='cuda')
    gs_cfg = ADMMConfig(epochs=EPOCHS, hidden_size=10)
    mesh = dict(mesh_shape=(1, 2), axis_names=('data', 'model'),
                model_axis='model', device='cuda')
    har_ranks, gs_ranks = _run_layouts([
        dict(mesh, config=har_cfg, parameter_set=har_ps, params=har_params,
             data=har, epochs=TP_EPOCHS),
        dict(mesh, config=gs_cfg, parameter_set=ps,
             params=params_from_dict(weights), data=(tx, ty, vx, vy),
             epochs=EPOCHS)])

    gaps = _hold_layout('tp Path B', har_ranks, ref['train_loss'][1:],
                        ref['val_loss'][1:], ref['params'])
    _launch_gate('tp Path B', har_ranks,
                 {'jacobi_sweep': TP_EPOCHS, 'chol_solve': TP_EPOCHS,
                  'chol_inverse': 9 * TP_EPOCHS, 'interior_sweep': 0})
    log(f'[tp] Path B (B 2048, T 10, I 561, H 128: 64 a rank), turbo at '
        f'highest, mesh (1, 2), 2 gloo ranks on one card: {TP_EPOCHS} '
        f'epochs, largest relative gaps to one process {gaps}, weights '
        f'bit-equal across ranks; launches per rank '
        f'{[r["launches"] for r in har_ranks]}; ms/epoch per rank (median '
        f'after the first, host clock, each epoch read back) '
        f'{[float(np.median(r["epoch_ms"][1:])) for r in har_ranks]}, one '
        f'process {ref["seconds"] * 1e3 / TP_EPOCHS!r} on {card}; '
        f'collectives [calls, bytes] per epoch per axis per rank '
        f'{[_per_epoch_axes(r["mesh"], TP_EPOCHS) for r in har_ranks]}')

    gaps = _hold_layout('tp GoogleStock', gs_ranks, slice1_train[1:],
                        slice1_val[1:])
    val30 = gs_ranks[0]['val_loss'][-1]
    if not val30 <= REF_VAL_30 * 1.05:
        raise AssertionError(f'tp GoogleStock val30 {val30} above the '
                             f'reference {REF_VAL_30} x 1.05')
    _launch_gate('tp GoogleStock', gs_ranks, {'interior_sweep': EPOCHS,
                                              'jacobi_sweep': 0})
    log(f'[tp] GoogleStock H 10 (5 a rank), default config, mesh (1, 2): '
        f'{EPOCHS} epochs, val30 {val30:.6f}, largest relative gaps to '
        f'slice 1 {gaps}; launches per rank '
        f'{[r["launches"] for r in gs_ranks]} (Gauss-Seidel on the slabs '
        f'gathered to the whole H); ms/epoch per rank '
        f'{[float(np.median(r["epoch_ms"][1:])) for r in gs_ranks]} on '
        f'{card}; collectives per epoch per axis per rank '
        f'{[_per_epoch_axes(r["mesh"], EPOCHS) for r in gs_ranks]}')
    return har_ranks[0]['launches'], gs_ranks[0]['launches']


def card_name_and_power():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')
    from admm_lstm_torch.data import load_dataset
    from admm_lstm_torch.utils.device import set_matmul_precision
    from admm_lstm_torch.utils.logging import set_console_enabled
    set_console_enabled(False)
    set_matmul_precision('highest')
    torch.cuda.set_device(0)

    ptxas = phase_build()
    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device='cuda')
    rows, ill = phase_kernels(flush, ptxas)
    launches = {}
    rows['floor_sweep'], launches['floor'] = phase_floor(flush, ptxas)
    del flush

    g = np.load(GOLDEN)
    weights = {k[3:]: g[k] for k in g.files if k.startswith('w0_')}
    (tx, ty, vx, vy), ps, _ = load_dataset('GoogleStock')
    # Each kernel's launch count comes from the run of its own path.
    launches['slice1'], slice1_train, slice1_val = phase_slice1(
        tx, ty, vx, vy, ps, weights)
    launches['path_a'] = phase_path_a(tx, ty, vx, vy, ps, weights)
    launches['path_b'], launches['path_b_candidates'] = phase_path_b()
    launches.update(phase_datasets())
    card = card_name_and_power()
    launches['tune'], tune_times = phase_tune(tx, ty, vx, vy, ps, weights,
                                              card)
    launches['tune_auto'], auto_times = phase_tune_auto(tx, ty, vx, vy, ps,
                                                        weights, card)
    phase_resume()
    (launches['stacked'], launches['stacked_best'],
     launches['stacked_search'], stacked_times) = phase_stacked(card)
    launches['legacy'] = phase_legacy(tx, ty, vx, vy, ps, weights)
    (launches['scenarios'], launches['scenarios_speed'],
     launches['scenarios_turbo']) = phase_scenarios(card)
    launches.update(phase_sharded(tx, ty, vx, vy, ps, weights, slice1_train,
                                  slice1_val, card))
    launches['seqpar'] = phase_seqpar(card)
    launches['tp_path_b'], launches['tp_googlestock'] = phase_tp(
        tx, ty, vx, vy, ps, weights, slice1_train, slice1_val, card)

    log(f'[card] {card}')
    meta = {
        'interior_sweep': ('admm_lstm_torch/csrc/gate_sweep.cu',
                           'admm_lstm_tpu/kernels/gate_sweep.py:184',
                           launches['slice1']),
        'jacobi_sweep': ('admm_lstm_torch/csrc/gate_sweep.cu',
                         'admm_lstm_tpu/kernels/gate_sweep.py:260',
                         launches['path_a']),
        'chol_solve': ('admm_lstm_torch/csrc/cholesky.cu',
                       'admm_lstm_tpu/kernels/cholesky.py:168',
                       launches['path_a']),
        'chol_inverse': ('admm_lstm_torch/csrc/cholesky.cu',
                         'admm_lstm_tpu/kernels/cholesky.py:338',
                         launches['path_b']),
        'floor_sweep': ('admm_lstm_torch/csrc/gate_sweep.cu',
                        'benchmarks/bench_gs_floor.py:77',
                        launches['floor']),
        # The same kernel with the candidate axis: the TPU kernel under the
        # JAX package's vmap; its launches on the rho search's path (the
        # launches with the axis, counted in interior_sweep's too).
        'interior_sweep[candidates]': ('admm_lstm_torch/csrc/gate_sweep.cu',
                                       'admm_lstm_tpu/kernels/gate_sweep.py'
                                       ':184', launches['tune']),
        # The Jacobi kernel with the candidate axis, on the auto() rho
        # search's path.
        'jacobi_sweep[candidates]': ('admm_lstm_torch/csrc/gate_sweep.cu',
                                     'admm_lstm_tpu/kernels/gate_sweep.py'
                                     ':260', launches['tune_auto']),
        # Replaces no TPU kernel: the prox-linear weight stages' theta
        # tests, which XLA fuses inside the JAX package's while_loop.
        'theta_tests': ('admm_lstm_torch/csrc/theta_tests.cu', None,
                        launches['slice1']),
        # Replaces no TPU kernel: the stacked sweep over t and the layers,
        # a lax.scan in the JAX package; its launches on the (8, 8) run's
        # path (one an epoch, the bounds' passes inside the same call).
        'stacked_sweep': ('admm_lstm_torch/csrc/stacked_sweep.cu', None,
                          launches['stacked']),
        # Replaces no TPU kernel: the exact stage's Gram stack and
        # first-order term, XLA's dot_general in the JAX package; its
        # launches on the stacked 27 x 30 search's path (two an epoch).
        'exact_gram': ('admm_lstm_torch/csrc/exact_gram.cu', None,
                       launches['stacked_search']),
    }
    kernels = []
    for name, (source, replaces, counts) in meta.items():
        main_row = rows[name][0]
        kernels.append(dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=counts[name], max_abs_err=main_row['max_abs_err'],
            ms=main_row['ms'], plain_ms=main_row['plain_ms'],
            bound_ms=main_row['bound_ms'], bound_by=main_row['bound_by'],
            library_ms=main_row['library_ms'], shape=main_row['shape'],
            other_shapes=rows[name][1:]))
        for key in ('two_call_ms', 'regs', 'local_bytes', 'systems_per_sm',
                    'plan', 'ms_per_step', 'warm_ms', 'copy_ms', 'gb_per_s',
                    'blocks_per_sm', 'spill_stores', 'spill_loads',
                    'vec1_ms', 'interior_ms', 'interior_ms_per_step',
                    'chain_share', 'interior_warm_ms', 'cudnn_max_abs_err',
                    'onplan_ms', 'onplan_ms_per_step', 'instance',
                    'alone_ms', 'alone_max_abs_err', 'alone_bit_equal',
                    'alone_plan', 'max_rel_err', 'bit_equal_relaunch',
                    'resmax_ms', 'bvec_max_rel_err', 'plain_max_rel_err',
                    'route'):
            if key in main_row:
                kernels[-1][key] = main_row[key]
        if name in ill:
            kernels[-1]['ill_conditioned'] = ill[name]
        kernels[-1]['launches_by_path'] = (
            {'floor': counts[name]} if name == 'floor_sweep' else
            {path: counts[name] for path, counts in launches.items()})
    log(f'[tune] search_rho wall seconds {tune_times["seconds"]!r} batched, '
        f'{tune_times["alone_seconds"]!r} for the runs alone, on {card}')
    log(f'[tune] auto() search_rho wall seconds {auto_times["seconds"]!r} '
        f'batched at default, {auto_times["highest_seconds"]!r} at highest, '
        f'{auto_times["alone_seconds"]!r} for the runs alone at highest; '
        f'CLI --auto --tune_rho 1 {auto_times["cli_seconds"]!r} '
        f'(groups {auto_times["cli_groups"]}), on {card}')
    log(f'[stacked] train_best_stacked wall seconds '
        f'{stacked_times["best_seconds"]!r}; search_rho_stacked wall seconds '
        f'{stacked_times["seconds"]!r} batched, '
        f'{stacked_times["alone_seconds"]!r} for the runs alone; with '
        f'z_candidates {stacked_times["z_seconds"]!r} batched; on {card}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
