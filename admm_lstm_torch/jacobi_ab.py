"""The Jacobi sweep kernel against the designs it was chosen over, on one
CUDA card.

    python -m admm_lstm_torch.jacobi_ab [--reps 30]

Each variant is csrc/gate_sweep.cu with one change (`VARIANTS`), built by
nvcc into admm_lstm_torch/_build/ab/ (all at once) and launched through
its own `gate_sweep_jacobi` with the plan rule of
`kernels/gate_sweep.jacobi_plan` (one whole wave of the blocks an SM
holds, from the variant's own occupancy).  At each shape every variant
is held to the plain version (`no_math`, which drops the math, only
reports its error) and timed in turns, the variants in order and then
reversed, with CUDA events around one launch after a ~0.5 ms device
spin, three ways: `flush` (L2 flushed by writing 64 MB, as chip_smoke.py
does, which leaves the L2 full of dirty lines for the kernel to write
back), `clean` (L2 flushed by reading 64 MB) and `warm` (right after the
same call).  Beside them, `copy`: one device copy of 13 slabs into 13
others, the kernel's bytes.  Where H * B % 4 == 0 the design is timed
with both vector widths, the one `jacobi_plan` takes marked `chosen`.
Prints a line per row and, last, one JSON object with every row, the
registers and spills of each variant's kernels, and the card's name and
power limit.  Needs a card.
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
from admm_lstm_torch.kernels.gate_sweep import (JACOBI_THREADS, jacobi_plan,
                                                jacobi_sweep_plain)

SHAPES = [(9, 10, 4224), (9, 128, 2048), (13, 5, 1000), (5, 7, 1001)]
SPIN_CYCLES = 1_000_000
FLUSH_FLOATS = 64 * 2 ** 20 // 4

_KERNEL_START = ('template <int V>\n__global__ void __launch_bounds__'
                 '(JACOBI_THREADS)\njacobi_sweep_kernel')
_KERNEL_END = 'constexpr int MAX_DEVICES'
_MATH = '      timestep_math(pre, old, lane(cur[14], l), rho, r);\n'
_STORE = ('    for (int k = 0; k < 11; ++k) reinterpret_cast<T*>(a.out[k])[e]'
          ' = res[k];\n')
_LOADS = ('  for (int g = 0; g < 4; ++g) v[g] = __ldg(pre + g * n);\n',
          '    v[4 + k] = __ldg(reinterpret_cast<const T*>(src[k]) + e);\n')
_THREADS = 'constexpr int JACOBI_THREADS = 128;'

# The body of the kernel after its walk is set up, without prefetch: each
# item's 15 loads, then its math and stores.
_NO_PREFETCH = r'''  while (s < a.steps) {
    T cur[15];
    jacobi_load<V>(a, 0, (size_t)s * n, o, cur);
    T res[11];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      const float pre[4] = {lane(cur[0], l), lane(cur[1], l),
                            lane(cur[2], l), lane(cur[3], l)};
      float old[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) old[k] = lane(cur[4 + k], l);
      float r[11];
      timestep_math(pre, old, lane(cur[14], l), rho, r);
#pragma unroll
      for (int k = 0; k < 11; ++k) set_lane(res[k], l, r[k]);
    }
    const size_t e = (size_t)s * n + o;
#pragma unroll
    for (int k = 0; k < 11; ++k) reinterpret_cast<T*>(a.out[k])[e] = res[k];
    s += ds;
    o += dof;
    if (o >= n) {
      o -= n;
      ++s;
    }
  }
}

'''

# The inputs through a ring of 3 items in shared memory: each thread
# copies its own next items' 15 inputs into its own slots with cp.async
# (16 bytes, or 4 at V = 1), 2 items ahead, and reads them back when they
# have landed; no thread reads another's slots, so there is no barrier.
_RING = r'''template <int V>
__device__ __forceinline__ void cp_async_v(void* dst, const void* src) {
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src));
}

constexpr int JACOBI_STAGES = 3;
constexpr size_t jacobi_smem(int v) {
  return (size_t)JACOBI_STAGES * 15 * JACOBI_THREADS * v * sizeof(float);
}

template <int V>
__device__ __forceinline__ void jacobi_copy(const JacobiArgs& a, size_t sn,
                                            int o,
                                            typename Vec<V>::T* dst) {
  using T = typename Vec<V>::T;
  const size_t e = sn + o, n = a.n;
  const T* pre = reinterpret_cast<const T*>(a.pre) + 4 * sn + o;
  const float* const src[11] = {a.in[1], a.in[2], a.in[4], a.in[5],
                                a.in[6], a.in[7], a.in[8], a.in[9],
                                a.in[10], a.in[11], a.c_prev};
#pragma unroll
  for (int g = 0; g < 4; ++g)
    cp_async_v<V>(dst + g * JACOBI_THREADS, pre + g * n);
#pragma unroll
  for (int k = 0; k < 11; ++k)
    cp_async_v<V>(dst + (4 + k) * JACOBI_THREADS,
                  reinterpret_cast<const T*>(src[k]) + e);
}

__device__ __forceinline__ void jacobi_next(int& s, int& o, int ds, int dof,
                                            int n) {
  s += ds;
  o += dof;
  if (o >= n) {
    o -= n;
    ++s;
  }
}

template <int V>
__global__ void __launch_bounds__(JACOBI_THREADS)
jacobi_sweep_kernel(const JacobiArgs a) {
  using T = typename Vec<V>::T;
  extern __shared__ float4 jsmem[];
  T* const slots = reinterpret_cast<T*>(jsmem) + threadIdx.x;
  const int n = a.n;
  const int first = blockIdx.x * JACOBI_THREADS + threadIdx.x;
  const int stride = gridDim.x * JACOBI_THREADS;
  int s = first / n, o = first - s * n;
  const int ds = stride / n, dof = stride - ds * n;
  if (s >= a.steps) return;
  const Rho rho = load_rho(a.rho);
  int sp = s, op = o;
#pragma unroll
  for (int i = 0; i < JACOBI_STAGES - 1; ++i) {
    if (sp < a.steps) {
      jacobi_copy<V>(a, (size_t)sp * n, op, slots + i * 15 * JACOBI_THREADS);
      jacobi_next(sp, op, ds, dof, n);
    }
    cp_async_commit();
  }
  for (int st = 0; s < a.steps; st = st + 1 == JACOBI_STAGES ? 0 : st + 1) {
    const int ahead = st == 0 ? JACOBI_STAGES - 1 : st - 1;
    if (sp < a.steps) {
      jacobi_copy<V>(a, (size_t)sp * n, op,
                     slots + ahead * 15 * JACOBI_THREADS);
      jacobi_next(sp, op, ds, dof, n);
    }
    cp_async_commit();
    cp_async_wait<JACOBI_STAGES - 1>();
    T cur[15];
#pragma unroll
    for (int k = 0; k < 15; ++k)
      cur[k] = slots[(st * 15 + k) * JACOBI_THREADS];
    T res[11];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      const float pre[4] = {lane(cur[0], l), lane(cur[1], l),
                            lane(cur[2], l), lane(cur[3], l)};
      float old[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) old[k] = lane(cur[4 + k], l);
      float r[11];
      timestep_math(pre, old, lane(cur[14], l), rho, r);
#pragma unroll
      for (int k = 0; k < 11; ++k) set_lane(res[k], l, r[k]);
    }
    const size_t e = (size_t)s * n + o;
#pragma unroll
    for (int k = 0; k < 11; ++k) reinterpret_cast<T*>(a.out[k])[e] = res[k];
    jacobi_next(s, o, ds, dof, n);
  }
}

template <int V>
cudaError_t jacobi_ready() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(jacobi_sweep_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)jacobi_smem(V));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

'''

_RING_ENTRY = [
    ('''  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);''',
     '''  cudaError_t err = vec == 4 ? jacobi_ready<4>() : jacobi_ready<1>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);'''),
    ('JACOBI_THREADS, 0);', 'JACOBI_THREADS, jacobi_smem(vec));'),
    ('''  if (vec == 4)
    jacobi_sweep_kernel<4><<<grid, JACOBI_THREADS, 0, st>>>(a);
  else
    jacobi_sweep_kernel<1><<<grid, JACOBI_THREADS, 0, st>>>(a);''',
     '''  cudaError_t err = vec == 4 ? jacobi_ready<4>() : jacobi_ready<1>();
  if (err != cudaSuccess) return err;
  if (vec == 4)
    jacobi_sweep_kernel<4><<<grid, JACOBI_THREADS, jacobi_smem(4), st>>>(a);
  else
    jacobi_sweep_kernel<1><<<grid, JACOBI_THREADS, jacobi_smem(1), st>>>(a);'''),
]


def _patched(src, pairs):
    for old, new in pairs:
        if src.count(old) != 1:
            raise ValueError(f'variant patch does not apply: {old[:60]!r}')
        src = src.replace(old, new)
    return src


def _kernel(src):
    return src[src.index(_KERNEL_START):src.index(_KERNEL_END)]


def _walk_body(src):
    kernel = _kernel(src)
    return kernel[kernel.index('  T cur[15], nxt[15];'):]


# name -> (what it changes, csrc/gate_sweep.cu -> its source, threads)
VARIANTS = {
    'design': ('csrc/gate_sweep.cu as it is', lambda s: s, JACOBI_THREADS),
    'no_prefetch': ('each item loaded, computed and stored in turn',
                    lambda s: _patched(s, [(_walk_body(s), _NO_PREFETCH)]),
                    JACOBI_THREADS),
    'ring3': ('inputs through a 3-item cp.async ring in shared memory',
              lambda s: _patched(s, [(_kernel(s), _RING)] + _RING_ENTRY),
              JACOBI_THREADS),
    'ldcs': ('evict-first loads (__ldcs) instead of __ldg',
             lambda s: _patched(s, [(x, x.replace('__ldg', '__ldcs'))
                                    for x in _LOADS]), JACOBI_THREADS),
    'stcs': ('evict-first stores (__stcs)',
             lambda s: _patched(s, [(_STORE, _STORE.replace(
                 'reinterpret_cast<T*>(a.out[k])[e] = res[k]',
                 '__stcs(reinterpret_cast<T*>(a.out[k]) + e, res[k])'))]),
             JACOBI_THREADS),
    'threads256': ('256 threads a block',
                   lambda s: _patched(s, [(_THREADS, _THREADS.replace(
                       '128', '256'))]), 256),
    'no_math': ('the math replaced by copies: the access pattern alone',
                lambda s: _patched(s, [(_MATH, (
                    '      for (int k = 0; k < 10; ++k) r[k] = old[k];\n'
                    '      r[10] = pre[0] + pre[1] + pre[2] + pre[3] + '
                    'lane(cur[14], l) + rho.c;\n'))]), JACOBI_THREADS),
}


def _build_all(sources):
    """{name: (library, {kernel<vec>: regs and spills})}, one nvcc each,
    all started together."""
    out_dir = os.path.join(build.BUILD_DIR, 'ab')
    os.makedirs(out_dir, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(out_dir, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, '-o',
             os.path.join(out_dir, f'{name}.so'), cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f'{name}: nvcc exit '
                                         f'{proc.returncode}:\n{log}')
        regs, kernel = {}, None
        for line in log.splitlines():
            m = re.search(r'jacobi_sweep_kernelILi(\d)E', line)
            if 'Compiling entry function' in line:
                kernel = f'jacobi_sweep_kernel<{m.group(1)}>' if m else None
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


def _blocks_per_sm(lib, vec):
    fn = lib.gate_sweep_jacobi_occupancy
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    blocks, regs, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(vec, ctypes.byref(blocks), ctypes.byref(regs),
             ctypes.byref(local))
    if err:
        raise RuntimeError(f'gate_sweep_jacobi_occupancy: CUDA error {err}')
    return blocks.value


def _inputs(steps, hidden, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    rand = lambda *s, scale: (torch.randn(s, generator=gen) * scale).cuda()
    pre = rand(steps, 4, hidden, batch, scale=0.3)
    gates = tuple(rand(steps, hidden, batch, scale=0.2) for _ in range(6))
    duals = tuple(rand(steps, hidden, batch, scale=s)
                  for s in (0.01,) * 5 + (1e-4,))
    h_prev, c_prev = (rand(steps, hidden, batch, scale=0.2) for _ in range(2))
    rho = torch.tensor([1., 1., 1., 1., 0.008, 0.00045], device='cuda')
    return pre, gates, duals, h_prev, c_prev, rho


def _launcher(lib, args, plan):
    """A call that launches `lib`'s kernel with `plan`, and its outputs."""
    pre, gates, duals, _, c_prev, rho = args
    steps, _, hidden, batch = pre.shape
    outs = [torch.empty((steps, hidden, batch), device='cuda')
            for _ in range(11)]
    vp = ctypes.c_void_p
    ins = (vp * 12)(*(t.data_ptr() for t in (*gates, *duals)))
    outs_arr = (vp * 11)(*(o.data_ptr() for o in outs))
    fn = lib.gate_sweep_jacobi
    fn.argtypes = [vp] * 3 + [ctypes.POINTER(vp)] * 2 + [ctypes.c_int] * 8 \
        + [ctypes.c_longlong] * 2 + [vp]
    fn.restype = ctypes.c_int

    def call():
        err = fn(pre.data_ptr(), c_prev.data_ptr(), rho.data_ptr(), ins,
                 outs_arr, steps, hidden, batch, *plan, 1, 0, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'gate_sweep_jacobi: CUDA error {err}, plan '
                               f'{plan}')
    return call, outs


def _ms(fn, mode, flush, sink, reps):
    """Median CUDA-event ms of one `fn` after the L2 is set up by `mode`."""
    times = []
    for _ in range(reps):
        if mode == 'flush':
            flush.zero_()
        elif mode == 'clean':
            torch.sum(flush, dim=0, out=sink)
        else:
            fn()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--reps', type=int, default=30)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('jacobi_ab needs a CUDA card')
    torch.cuda.set_device(0)
    with open(os.path.join(build.CSRC, 'gate_sweep.cu')) as f:
        src = f.read()
    libs = _build_all({name: make(src)
                       for name, (_, make, _) in VARIANTS.items()})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = {(name, vec): _blocks_per_sm(lib, vec)
              for name, (lib, _) in libs.items() for vec in (4, 1)}
    flush = torch.empty(FLUSH_FLOATS, device='cuda')
    sink = torch.empty((), device='cuda')
    rows = []
    for seed, shape in enumerate(SHAPES):
        data = _inputs(*shape, seed=10 + seed)
        want = jacobi_sweep_plain(*data)
        want = want[0] + want[1]
        chosen = jacobi_plan(*shape, sms, {v: blocks['design', v]
                                           for v in (4, 1)}, True).vec
        both = shape[1] * shape[2] % 4 == 0
        cases = []
        for name, (lib, _) in libs.items():
            threads = VARIANTS[name][2]
            for vec in ((4, 1) if name == 'design' and both else (chosen,)):
                items = int(np.prod(shape)) // vec
                grid = min(-(-items // threads), sms * blocks[name, vec])
                plan = (vec, -(-items // (grid * threads)), threads, grid)
                call, outs = _launcher(lib, data, plan)
                call()
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max())
                          for a, b in zip(outs, want))
                if name != 'no_math' and not err <= 1e-5:
                    raise AssertionError(f'{name} at {shape}, vec {vec}: max '
                                         f'abs err {err}')
                cases.append(dict(variant=name, vec=vec, plan=plan,
                                  chosen=vec == chosen, max_abs_err=err,
                                  call=call))
        src_t = torch.empty(13 * int(np.prod(shape)), device='cuda')
        dst_t = torch.empty_like(src_t)
        cases.append(dict(variant='copy', vec=None, plan=None, chosen=None,
                          max_abs_err=None, call=lambda: dst_t.copy_(src_t)))
        for mode in ('flush', 'clean', 'warm'):
            for order in (cases, cases[::-1]):
                for case in order:
                    case.setdefault(mode, []).append(
                        _ms(case['call'], mode, flush, sink, args.reps))
        for case in cases:
            del case['call']
            case['shape'] = list(shape)
            rows.append(case)
            print(f'[jacobi_ab] {shape} {case["variant"]} vec {case["vec"]} '
                  f'plan {case["plan"]} flush {case["flush"]} clean '
                  f'{case["clean"]} warm {case["warm"]}', flush=True)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        card=card, rows=rows,
        variants={name: dict(change=VARIANTS[name][0], kernels=regs,
                             blocks_per_sm={v: blocks[name, v]
                                            for v in (4, 1)})
                  for name, (_, regs) in libs.items()})))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
