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
               per step past the first (ms_per_step);
               for the Jacobi sweep also its plan, registers and spills,
               GB/s, its L2-resident time (warm_ms), a device copy of the
               same bytes (copy_ms), and, where it takes float4s, the
               one-float instance's time (vec1_ms) and identical bits;
               for the Cholesky kernels also a two-call yardstick, their
               registers and systems per SM, and gate (ii): the error
               against float64 on ill-conditioned Gram-like inputs, held
               to the plain version's;
  3. train   - the paths, each through `admm_lstm_torch.api`, with the
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
                 the same epoch with the plain versions;
               * datasets: the default config at H=10 on YahooFinance and
                 DNA1, 30 epochs from the reference's seed-0 weights, held
                 to its trajectories, one interior_sweep launch an epoch;
                 SMSSpam (I=95, O=2) and GEFCOM2012Wind, 5 epochs from
                 numpy-seeded weights, held to the JAX package's losses;
  4. tune    - search_rho on GoogleStock over the default 27-point grid, 30
               epochs a candidate: the JAX package's best rho, every
               candidate's validation loss, 810 interior_sweep launches,
               and the search's wall seconds;
  5. resume  - YahooFinance 10 epochs straight against 5 checkpointed
               (async) and resumed from the directory to 10: losses,
               weights and the whole final state equal bit for bit.
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
                (59, 10, 1360), (56, 10, 85), (24, 10, 487), (23, 10, 10522)]
JACOBI_SHAPES = [(9, 10, 4224), (9, 128, 2048), (13, 5, 1000),
                 (5, 7, 1001)]     # H * B odd: the V = 1 instance
SOLVE_SHAPES = [(40, 10), (40, 1), (512, 128), (37, 100)]
INVERSE_SHAPES = [(512, 64), (16, 128), (7, 33)]
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
# The resume phase: YahooFinance, the default config, RESUME_EPOCHS
# epochs straight through against RESUME_AT epochs checkpointed and the
# rest resumed; equal bit for bit.
RESUME_EPOCHS = 10
RESUME_AT = 5


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


def jacobi_bytes(steps, hidden, batch):
    """The bytes one Jacobi sweep must move: 15 input slabs (4 pre gates,
    old f, g, c, h, 6 duals, c_prev; h_prev is already inside pre and old
    i and o do not enter the math), rho, 11 output slabs."""
    return 4 * (steps * hidden * batch * (15 + 11) + 6)


def jacobi_bound(steps, hidden, batch):
    """One Jacobi sweep: `jacobi_bytes`, and 105 operations per
    element."""
    return bound(jacobi_bytes(steps, hidden, batch),
                 steps * hidden * batch * 105)


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
                'jacobi_sweep_kernel')


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
    """Builds both sources and returns every kernel's registers and spills
    ({} for a library built before this run)."""
    from admm_lstm_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all(['gate_sweep', 'cholesky'])
    log(f'[build] gate_sweep.cu and cholesky.cu built in '
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


def phase_kernels(flush, ptxas):
    from admm_lstm_torch.kernels import cholesky as ch
    from admm_lstm_torch.kernels import gate_sweep as gs
    rows = {k: [] for k in ('interior_sweep', 'jacobi_sweep', 'chol_solve',
                            'chol_inverse')}
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
    for k, shape in enumerate(JACOBI_SHAPES):
        rows['jacobi_sweep'].append(jacobi_row(shape, 10 + k, flush, ptxas))
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


def _kernels():
    from admm_lstm_torch.kernels.cholesky import chol_inverse, chol_solve
    from admm_lstm_torch.kernels.gate_sweep import (interior_sweep,
                                                    jacobi_sweep)
    return dict(interior_sweep=interior_sweep, jacobi_sweep=jacobi_sweep,
                chol_solve=chol_solve, chol_inverse=chol_inverse)


def run_counted(label, fn, epochs):
    """Zeroes every kernel's launch count, runs `fn` (an api.train call),
    reads the counts, and logs the run."""
    kernels = _kernels()
    for k in kernels.values():
        k.launches = 0
    res = fn()
    launches = {name: k.launches for name, k in kernels.items()}
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
    # A second, warm run of the same work for the epoch time.
    res2 = run()
    log(f'[train] slice 1 warm rerun: '
        f'{res2["seconds"] * 1e3 / EPOCHS:.3f} ms/epoch')
    return launches


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
    res, train_l, val_l, _ = run_counted(
        "Path A: auto() at 'highest'", run(cfg), EPOCHS)
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

    _, _, val_l, _ = run_counted("Path A: auto() at 'default'",
                                 run(ADMMConfig.auto(epochs=EPOCHS,
                                                     hidden_size=10)), EPOCHS)
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


def phase_tune(tx, ty, vx, vy, ps, weights):
    """search_rho on GoogleStock over the default 27-point grid, against
    the JAX package's best rho and each candidate's validation loss."""
    from admm_lstm_torch import tune
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.utils.config import ADMMConfig
    kernels = _kernels()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = tune.search_rho(tx, ty, vx, vy, ps, ADMMConfig(hidden_size=10),
                          epochs=EPOCHS, params=params_from_dict(weights),
                          device='cuda')
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    n = len(res['val_losses'])
    log(f'[tune] search_rho GoogleStock, {n} candidates x {EPOCHS} epochs: '
        f'{seconds:.3f} s wall (host clock), best rho {res["best_rho"]} '
        f'val {res["best_val_loss"]:.6f} (JAX package: {TUNE_BEST_RHO}), '
        f'launches {launches}')
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
    if launches['interior_sweep'] != n * EPOCHS:
        raise AssertionError(f'search_rho: interior_sweep launched '
                             f'{launches["interior_sweep"]} times, expected '
                             f'{n * EPOCHS}')
    return launches, seconds


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
    del flush

    g = np.load(GOLDEN)
    weights = {k[3:]: g[k] for k in g.files if k.startswith('w0_')}
    (tx, ty, vx, vy), ps, _ = load_dataset('GoogleStock')
    # Each kernel's launch count comes from the run of its own path.
    launches = {'slice1': phase_slice1(tx, ty, vx, vy, ps, weights),
                'path_a': phase_path_a(tx, ty, vx, vy, ps, weights),
                'path_b': phase_path_b()}
    launches.update(phase_datasets())
    launches['tune'], tune_seconds = phase_tune(tx, ty, vx, vy, ps, weights)
    phase_resume()

    card = card_name_and_power()
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
                    'vec1_ms'):
            if key in main_row:
                kernels[-1][key] = main_row[key]
        if name in ill:
            kernels[-1]['ill_conditioned'] = ill[name]
        kernels[-1]['launches_by_path'] = {
            path: counts[name] for path, counts in launches.items()}
    log(f'[tune] search_rho wall seconds {tune_seconds!r} on {card}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
