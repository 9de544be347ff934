"""The floor's warp-synchronous kernel against the designs it was chosen
over, and where its step's time goes, on one CUDA card.

    python -m admm_lstm_torch.floor_ab [--reps 20]

Each variant is csrc/gate_sweep.cu with one change (`VARIANTS`), built by
nvcc into admm_lstm_torch/_build/floor_ab/ (all at once) and launched
through its own `gate_sweep_floor_warp` with `kernels/gate_sweep.
floor_plan`'s plan (the shared memory of the variant's stage and wh
placement).
At each shape every variant is held to the plain version at 1e-5 and
timed in turns, the variants in order and then reversed, with CUDA
events around one launch after the L2 is flushed (64 MB written) and a
~0.5 ms device spin; its time a step is the time past a one-step launch
over the steps after it.  The `stamps` variant reads clock64 around each
phase of a step in lane 0 of the first warp (each stamp waits for the
value the phase made): the product (shuffles and FMAs), the cell (the
activations and the c and h updates) and the rest (the store, the
stage's copies and wait, the loop); it reports cycles a step per phase,
and its own time, which the stamps slow.  Prints a line per row and,
last, one JSON object with every row, each variant's registers and
spills, and the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import numpy as np
import torch

from admm_lstm_torch.kernels import build
from admm_lstm_torch.kernels.gate_sweep import (FLOOR_MAX_WARPS,
                                                floor_plan, floor_smem,
                                                floor_sweep_plain)

SHAPES = [(2047, 16, 64), (127, 16, 512), (9, 10, 4224), (511, 32, 96)]
SPIN_CYCLES = 1_000_000
FLUSH_FLOATS = 64 * 2 ** 20 // 4

_PRODUCT_LOOP = ('  for (int k = 0; k < W; ++k) {\n'
                 '    const float hk = __shfl_sync(0xffffffffu, h, base + k);'
                 '\n')
_PRODUCT_SIG = 'float acc[4][2]) {\n'
_PRODUCT_CALL = 'floor_product<W>(w, h, base, acc);\n'
_PRODUCT_FN = ('template <int W>\n__device__ __forceinline__ void '
               'floor_product(')
_SIGMOID = '  return fmaf(0.5f, tanhf(0.5f * x), 0.5f);\n'
_KERNEL = 'template <int W>\n__global__ void __launch_bounds__'
_WEIGHTS = ('  float w[4][W];\n#pragma unroll\n'
            '  for (int g = 0; g < 4; ++g)\n#pragma unroll\n'
            '    for (int k = 0; k < W; ++k)\n'
            '      w[g][k] = k < H ? __ldg(a.wh + (g * H + k) * H + j) : 0.0f;'
            '\n')
_CARRY = '  float c = 0.0f, h = 0.0f;\n'
_PRE_O = '    const float pre_o = acc[3][0] + acc[3][1];\n'
_H = '    h = floor_sigmoid(pre_o) * tanhf(c);\n'
_STORE = '    if (ok) out[(size_t)s * slab] = h;\n'
_LOOP_END = '    wr = wr + 1 == FLOOR_SLOTS ? 0 : wr + 1;\n  }\n'
_COPY = ('#pragma unroll\n    for (int g = 0; g < 4; ++g)\n'
         '      cp_async4_or_zero(stage + (wr * 4 + g) * nthreads,\n'
         '                        x + (4 * (size_t)min(s2, last) + g) * '
         'slab,\n                        s2 <= last);\n')
_SMEM_CHECK = 'if (smem != 16 * FLOOR_SLOTS * 32 * warps)'
_STAGE_START = "  // The stage: step s's 4 xproj values"
_KERNEL_END = '// ---- Jacobi sweep'

# The first design's loads: a ring of FLOOR_AHEAD steps of xproj in
# registers, the time loop unrolled by FLOOR_AHEAD so every ring index is
# static, each slot refilled by __ldg as it frees.
_REGISTER_RING = r"""  const size_t slab = (size_t)H * B;
  const float* const x =
      a.xproj + (size_t)j * B + min(b, B - 1);          // (0, 0, j, b)
  float* const out = a.h + (size_t)j * B + b;               // (0, j, b)
  const int last = a.steps - 1;
  float ring[FLOOR_AHEAD][4];
#pragma unroll
  for (int d = 0; d < FLOOR_AHEAD; ++d)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      ring[d][g] = __ldg(x + (4 * (size_t)min(d, last) + g) * slab);

  float c = 0.0f, h = 0.0f;
  for (int s0 = 0; s0 < a.steps; s0 += FLOOR_AHEAD) {
#pragma unroll
    for (int d = 0; d < FLOOR_AHEAD; ++d) {
      const int s = s0 + d;
      if (s >= a.steps) break;
      float acc[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[g][0] = ring[d][g];
        acc[g][1] = 0.0f;
      }
      const size_t s2 = min(s + FLOOR_AHEAD, last);
#pragma unroll
      for (int g = 0; g < 4; ++g) ring[d][g] = __ldg(x + (4 * s2 + g) * slab);
      floor_product<W>(w, h, base, acc);
      c = floor_sigmoid(acc[1][0] + acc[1][1]) * c
          + floor_sigmoid(acc[0][0] + acc[0][1])
          * tanhf(acc[2][0] + acc[2][1]);
      h = floor_sigmoid(acc[3][0] + acc[3][1]) * tanhf(c);
      if (ok) out[(size_t)s * slab] = h;
    }
  }
}

"""

# wh in shared memory behind the stage, one float4 (the four gates) per
# (k, j), read conflict-free, instead of 4W registers a lane.
_SHARED_PRODUCT = r"""template <int W>
__device__ __forceinline__ void floor_product(const float4* ws, int j,
                                              float h, int base,
                                              float acc[4][2]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float hk = __shfl_sync(0xffffffffu, h, base + k);
    const float4 v = ws[k * 32 + j];
    acc[0][k & 1] = fmaf(v.x, hk, acc[0][k & 1]);
    acc[1][k & 1] = fmaf(v.y, hk, acc[1][k & 1]);
    acc[2][k & 1] = fmaf(v.z, hk, acc[2][k & 1]);
    acc[3][k & 1] = fmaf(v.w, hk, acc[3][k & 1]);
  }
}

"""
_SHARED_WEIGHTS = r"""  float4* const ws =
      reinterpret_cast<float4*>(stage_all + FLOOR_SLOTS * 4 * blockDim.x);
  for (int e = threadIdx.x; e < W * 32; e += blockDim.x) {
    const int k = e >> 5, jj = e & 31;
    ws[e] = jj < H && k < H ? make_float4(a.wh[(0 * H + k) * H + jj],
                                          a.wh[(1 * H + k) * H + jj],
                                          a.wh[(2 * H + k) * H + jj],
                                          a.wh[(3 * H + k) * H + jj])
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
"""

_STAMP_FN = r"""
// A clock64 stamp taken once v is ready (an add waits for it); sink keeps
// the adds alive.
__device__ __forceinline__ long long floor_stamp(float v, float& sink) {
  float t;
  asm volatile("add.f32 %0, %1, %2;" : "=f"(t) : "f"(v), "f"(sink));
  sink = t;
  return clock64();
}

"""[1:]
_STAMPS = [
    (_KERNEL, _STAMP_FN + _KERNEL),
    (_CARRY, _CARRY + '  float sink = 0.0f;\n  long long t_prod = 0, '
     't_cell = 0, t_rest = 0, mark = floor_stamp(h, sink), t;\n'),
    (_PRODUCT_CALL, 't = floor_stamp(h, sink);\n    t_rest += t - mark;\n'
     '    mark = t;\n    ' + _PRODUCT_CALL),
    (_PRE_O, _PRE_O + '    t = floor_stamp(pre_i + pre_f + pre_g + pre_o, '
     'sink);\n    t_prod += t - mark;\n    mark = t;\n'),
    (_H, _H + '    t = floor_stamp(h, sink);\n    t_cell += t - mark;\n'
     '    mark = t;\n'),
    (_LOOP_END, _LOOP_END + '  __syncwarp();\n'
     '  if (threadIdx.x == 0 && blockIdx.x == 0) {\n'
     '    float* const st = a.h + (size_t)(a.steps - 1) * slab;\n'
     '    st[0] = (float)t_prod;\n    st[B] = (float)t_cell;\n'
     '    st[2 * B] = (float)t_rest;\n    st[3 * B] = sink;\n  }\n'),
]


def _patched(src, pairs):
    for old, new in pairs:
        if src.count(old) != 1:
            raise ValueError(f'variant patch does not apply: {old[:60]!r}')
        src = src.replace(old, new)
    return src


def _sub(old, new):
    return lambda s: _patched(s, [(old, new)])


def _register_ring(src):
    body = src[src.index(_STAGE_START):src.index(_KERNEL_END)]
    return _patched(src, [(body, _REGISTER_RING)])


def _wh_shared(src):
    product = src[src.index(_PRODUCT_FN):src.index(_KERNEL)]
    return _patched(src, [
        (product, _SHARED_PRODUCT), (_WEIGHTS, _SHARED_WEIGHTS),
        (_PRODUCT_CALL, 'floor_product<W>(ws, j, h, base, acc);\n'),
        (_SMEM_CHECK, _SMEM_CHECK.replace(')', ' + 16 * 32 * lanes)'))])


_COLUMNS = (
    '  const int H = a.H, B = a.B, cols = 32 / H, lane = threadIdx.x & 31;\n'
    '  const int col = lane / H, j = lane - col * H, base = col * H;\n')
_POW2_COLUMNS = (
    '  const int H = a.H, B = a.B, cols = 32 / W, lane = threadIdx.x & 31;\n'
    '  const int col = lane / W, j0 = lane - col * W, base = col * W;\n'
    '  const int j = min(j0, H - 1);\n')
_OK = '  const bool ok = col < cols && b < B;\n'
_PER_BLOCK = '(long long)warps * (32 / hidden)'


def _pow2_columns(src):
    return _patched(src, [(_COLUMNS, _POW2_COLUMNS),
                          (_OK, '  const bool ok = j0 < H && b < B;\n'),
                          (_PER_BLOCK, _PER_BLOCK.replace('hidden',
                                                          'lanes'))])


_BRANCH_COPY = ('    if (s2 <= last) {\n#pragma unroll\n'
                '      for (int g = 0; g < 4; ++g)\n'
                '        cp_async4(stage + (wr * 4 + g) * nthreads,\n'
                '                  x + (4 * (size_t)s2 + g) * slab);\n'
                '    }\n')

# name -> (what it changes, csrc/gate_sweep.cu -> its source, the steps
# staged ahead, wh in shared memory, a column on H rounded up to a power of
# two lanes)
VARIANTS = {
    'design': ('csrc/gate_sweep.cu as it is', lambda s: s, 4, False, False),
    'register_ring': ('xproj 4 steps ahead in registers (__ldg), the time '
                      'loop unrolled by 4', _register_ring, 4, False, False),
    'branch_copies': ('no copy past the last step, by a branch around the '
                      'copies', _sub(_COPY, _BRANCH_COPY), 4, False, False),
    'clamped_copies': ('copies past the last step read the last step',
                       _sub(_COPY, _COPY.replace('s2 <= last', 'true')), 4,
                       False, False),
    'ahead2': ('xproj staged 2 steps ahead', _sub('FLOOR_AHEAD = 4;',
                                                  'FLOOR_AHEAD = 2;'), 2,
               False, False),
    'ahead8': ('xproj staged 8 steps ahead', _sub('FLOOR_AHEAD = 4;',
                                                  'FLOOR_AHEAD = 8;'), 8,
               False, False),
    'pow2_columns': ('a column on H rounded up to a power of two lanes, '
                     'not H', _pow2_columns, 4, False, True),
    'k_break': ('the product stops at k = H (a branch per k)',
                lambda s: _patched(s, [
                    (_PRODUCT_LOOP, _PRODUCT_LOOP.replace(
                        '{\n', '{\n    if (k >= H) break;\n')),
                    (_PRODUCT_SIG, 'int H, ' + _PRODUCT_SIG),
                    (_PRODUCT_CALL, _PRODUCT_CALL.replace('base, acc',
                                                          'base, H, acc'))]),
                4, False, False),
    'ieee_sigmoid': ('sigmoid as 1 / (1 + expf(-x)), an IEEE division',
                     _sub(_SIGMOID, '  return sigmoidf_(x);\n'), 4, False,
                     False),
    'wh_shared': ('wh in shared memory, one float4 per (k, j)', _wh_shared,
                  4, True, False),
    'stamps': ('clock64 stamps per phase (h not kept)',
               lambda s: _patched(s, _STAMPS), 4, False, False),
    'store_last': ('h stored at the last step only (h not kept)',
                   _sub(_STORE, _STORE.replace(
                       'if (ok)', 'if (ok && s == a.steps - 1)')), 4, False,
                   False),
    'no_reload': ('xproj copied for the first FLOOR_AHEAD steps only (h not '
                  'kept)', _sub(_COPY, ''), 4, False, False),
}
# Variants whose h is not the recurrence's: timed, not held.
UNCHECKED = ('stamps', 'store_last', 'no_reload')


def _build_all(sources):
    """{name: (library, {kernel<lanes>: regs and spills})}, one nvcc
    each, all started together."""
    out_dir = os.path.join(build.BUILD_DIR, 'floor_ab')
    os.makedirs(out_dir, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(out_dir, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, '-o',
             os.path.join(out_dir, f'{name}.so'), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f'{name}: nvcc exit '
                                         f'{proc.returncode}:\n{log}')
        regs, kernel = {}, None
        for line in log.splitlines():
            if 'Compiling entry function' in line:
                m = re.search(r'floor_warp_kernelILi(\d+)E', line)
                kernel = f'floor_warp_kernel<{m.group(1)}>' if m else None
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                          line)
            if m and kernel:
                regs.setdefault(kernel, {}).update(
                    spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r'Used (\d+) registers', line)
            if m and kernel:
                regs.setdefault(kernel, {})['regs'] = int(m.group(1))
        libs[name] = (ctypes.CDLL(os.path.join(out_dir, f'{name}.so')), regs)
    return libs


def _inputs(steps, hidden, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    return ((torch.randn((steps, 4, hidden, batch), generator=gen) * 0.3)
            .cuda(),
            (torch.randn((4, hidden, hidden), generator=gen)
             * (0.3 / max(1.0, (hidden / 10) ** 0.5))).cuda())


def _launcher(lib, xproj, wh, ahead, wh_shared, pow2):
    """A call that launches `lib`'s warp kernel on (xproj, wh) with
    floor_plan's plan (its grid for 32 // lanes columns a warp if `pow2`)
    and the shared memory of the variant's stage and wh placement, and its
    output."""
    steps, _, hidden, batch = xproj.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = floor_plan(hidden, batch, sms, 2 ** 30)
    if pow2:
        warps = -(-batch // (32 // plan.lanes))
        per_block = min(FLOOR_MAX_WARPS, -(-warps // sms))
        plan = plan._replace(warps=per_block, grid=-(-warps // per_block))
    smem = floor_smem(plan.warps, ahead) + (16 * 32 * plan.lanes
                                            if wh_shared else 0)
    h = torch.empty((steps, hidden, batch), device='cuda')
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.gate_sweep_floor_warp
    fn.argtypes = [vp] * 3 + [ci] * 7 + [vp]
    fn.restype = ci

    def call():
        err = fn(xproj.data_ptr(), wh.data_ptr(), h.data_ptr(), steps,
                 hidden, batch, plan.lanes, plan.warps, plan.grid, smem,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'gate_sweep_floor_warp: CUDA error {err}, '
                               f'plan {plan}')
    return call, h


def _ms(fn, flush):
    """CUDA-event ms of one `fn` after the L2 is flushed."""
    flush.zero_()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--reps', type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('floor_ab needs a CUDA card')
    torch.cuda.set_device(0)
    with open(os.path.join(build.CSRC, 'gate_sweep.cu')) as f:
        src = f.read()
    libs = _build_all({name: make(src)
                       for name, (_, make, *_) in VARIANTS.items()})
    flush = torch.empty(FLUSH_FLOATS, device='cuda')
    rows = []
    for seed, shape in enumerate(SHAPES):
        steps, hidden, batch = shape
        xproj, wh = _inputs(*shape, seed=70 + seed)
        one = _inputs(1, hidden, batch, seed=70 + seed)
        want = floor_sweep_plain(xproj, wh)
        cases = []
        for name, (lib, _) in libs.items():
            call, h = _launcher(lib, xproj, wh, *VARIANTS[name][2:])
            call()
            torch.cuda.synchronize()
            case = dict(variant=name, shape=list(shape), call=call,
                        one=_launcher(lib, *one, *VARIANTS[name][2:])[0])
            if name == 'stamps':
                st = h[-1, :4, 0].tolist()
                case['cycles_per_step'] = dict(
                    product=st[0] / steps, cell=st[1] / steps,
                    rest=st[2] / steps)
            elif name not in UNCHECKED:
                case['max_abs_err'] = float((h - want).abs().max())
                if not case['max_abs_err'] <= 1e-5:
                    raise AssertionError(f'{name} at {shape}: max abs err '
                                         f'{case["max_abs_err"]}')
            cases.append(case)
        for order in (cases, cases[::-1]):
            for case in order:
                for _ in range(args.reps):
                    case.setdefault('ms_all', []).append(
                        _ms(case['call'], flush))
                    case.setdefault('one_all', []).append(
                        _ms(case['one'], flush))
        for case in cases:
            del case['call'], case['one']
            case['ms'] = float(np.median(case.pop('ms_all')))
            one_ms = float(np.median(case.pop('one_all')))
            case['us_per_step'] = ((case['ms'] - one_ms) / max(1, steps - 1)
                                   * 1e3)
            rows.append(case)
            print(f'[floor_ab] {case}', flush=True)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        card=card, rows=rows,
        variants={name: dict(change=VARIANTS[name][0], kernels=regs)
                  for name, (_, regs) in libs.items()})))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
