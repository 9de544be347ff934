// The weight stage's theta tests, for Hopper: one pass over a stage's
// slabs computes the whole table of candidate objective sums of one block
// of the prox-linear line search (solvers/prox_linear.py,
// weight_stage_update_wide's `fails`).
//
// theta_tests_kernel replaces no TPU kernel.  The JAX package runs this
// test inside a lax.while_loop that XLA fuses on the TPU
// (admm_lstm_tpu/solvers/prox_linear.py); PyTorch runs eagerly, where the
// plain version (kernels/theta_tests.py::theta_tests_plain) is a Python
// loop over the K thetas of a block, each about 11 elementwise operations
// and two reductions over the whole slabs.  It was added because those
// operations took 93-95% of the device time of the batched rho search
// (PERF.md, section 6).
//
// For each candidate theta k of the block, each instance s (the candidate
// axis; one without it) and each gate g, with x the element's
// pre-activation (s, t, g*H + h, b):
//   x'  = pre + grad_proj / theta[k, s, g]
//   r   = a_g + b_g * tanhf(c_g * x') - target
//   out[k, s, g] = sum over t, h, b of r * r
// where the tanh gate has a = 0, b = c = 1 and the sigmoid gates are
// 0.5 + 0.5 * tanh(0.5 x), as the plain version writes them.  Every
// product and sum of an element is rounded as PyTorch rounds its separate
// elementwise operations (__fmul_rn, __fadd_rn: no contraction into an
// FMA), tanhf is the accurate one (no fast math), and the division is
// IEEE; where a block's K thetas of one (s, g) are all powers of two whose
// reciprocal is a float, the division is a multiplication by that
// reciprocal, which rounds the same exact quotient to the same float.
// The doubling search tests only such thetas (1, 2, 4, ... 2^59).
//
// Layout: pre, grad_proj and target each (S, T, 4H, B) float32, with
// (4H, B) contiguous (batch-minor) and the S and T strides the caller
// gives; theta (K, S, 4) with any strides; tanh_cols the (4H,) bool mask
// of tanh columns, read at each gate's first column (the activation is a
// gate's); out (K, S, 4) contiguous.
//
// What bounds it on an H100.  A launch must read the three slabs once:
// 547 MB at the GoogleStock rho grid (S 27, T 10, 4H 40, B 4224), 0.163 ms
// at 3.35 TB/s.  Each element then takes K = 8 divisions (or products),
// tanhf and ~8 more operations per theta, ~40 instructions with tanhf's
// two SFU operations, ~320 an element: at 45.6 M elements that is ~0.45
// ms of the SMs' instruction slots at ~1.9 GHz, so operations, not bytes,
// bound it (0.36 ms on an H100 at 700 W); loads are 16-byte and
// coalesced, so the bytes hide under the math.
//
// Design.  The element space is S*4 groups (s, g), each T segments of the
// H*B contiguous floats of rows g*H .. g*H+H-1 at one t, in units of V
// floats (V = 4: float4 loads where every slab is 16-byte aligned and
// H*B and the strides are multiples of 4; else V = 1).  The grid is one
// wave of resident blocks (kernels/theta_tests.py::tests_plan), at least
// one block a group, and block b takes the contiguous range of units
// [b*U/grid, (b+1)*U/grid): every block does the same work to a unit, at
// any S, and its range touches at most two groups.  A block walks its
// range segment by segment (block-uniform control flow); its threads
// stride over a segment's units, each keeping K register sums for the
// group's thetas, held in registers too.  At a group's end the block
// reduces its K sums (warp shuffles, then the warps in order) into its
// slot of the partials (grid, 2, MAX_K).  The last block to finish (an
// integer ticket; no float atomics) adds every group's partials in block
// order into out and resets the ticket.  So a launch is deterministic:
// the same inputs give the same bits.  NaN reaches the sums unchanged.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Threads per block and the most thetas a launch tests
// (kernels/theta_tests.py::THREADS and MAX_K hold the same numbers).
constexpr int THETA_THREADS = 256;
constexpr int MAX_K = 8;
constexpr int WARPS = THETA_THREADS / 32;

struct TestArgs {
  const float* pre;
  const float* grad_proj;
  const float* target;
  const float* theta;              // (K, S, 4), strides below
  const unsigned char* tanh_cols;  // (4H,)
  float* out;                      // (K, S, 4) contiguous
  float* part;                     // (grid, 2, MAX_K)
  unsigned int* ticket;            // 0 between launches
  int K, S, T, H;
  long long seg;                   // units of V floats in a segment, H*B/V
  long long units;                 // S * 4 * T * seg
  // Strides in floats: each slab's s and t, theta's k, s and g.
  long long pre_s, pre_t, grad_s, grad_t, tgt_s, tgt_t;
  long long th_k, th_s, th_g;
};

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ float lane(const float4& v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane(float v, int) { return v; }

// r of one element and theta: d is the theta (DIV) or its reciprocal.
template <bool DIV>
__device__ __forceinline__ float resid(float p, float q, float y, float d,
                                       float a, float b, float c) {
  const float step = DIV ? __fdiv_rn(q, d) : __fmul_rn(q, d);
  const float x = __fadd_rn(p, step);
  const float u = tanhf(__fmul_rn(c, x));
  return __fsub_rn(__fadd_rn(a, __fmul_rn(b, u)), y);
}

// Adds the squared residuals of units [first, end) of one segment to acc,
// the threads striding over them.
template <int V, bool DIV>
__device__ __forceinline__ void segment(const float* pre, const float* grad,
                                        const float* tgt, long long first,
                                        long long end, int K,
                                        const float d[MAX_K], float a,
                                        float b, float c, float acc[MAX_K]) {
  using T = typename Vec<V>::T;
  const T* p4 = reinterpret_cast<const T*>(pre);
  const T* q4 = reinterpret_cast<const T*>(grad);
  const T* y4 = reinterpret_cast<const T*>(tgt);
  for (long long j = first + threadIdx.x; j < end; j += THETA_THREADS) {
    const T p = __ldg(p4 + j), q = __ldg(q4 + j), y = __ldg(y4 + j);
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k < K) {
        float sq[V];
#pragma unroll
        for (int l = 0; l < V; ++l) {
          const float r = resid<DIV>(lane(p, l), lane(q, l), lane(y, l),
                                     d[k], a, b, c);
          sq[l] = r * r;
        }
        if constexpr (V == 4)
          acc[k] += (sq[0] + sq[1]) + (sq[2] + sq[3]);
        else
          acc[k] += sq[0];
      }
    }
  }
}

// The block's K sums, in a fixed order: each warp's by shuffles, then the
// warps in order.  Thread k < K returns sum k; every thread must call it.
__device__ __forceinline__ void block_sums(float acc[MAX_K], int K,
                                           float (*smem)[MAX_K],
                                           float* res) {
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane_id == 0) smem[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float v = smem[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += smem[w][threadIdx.x];
    *res = v;
  }
  __syncthreads();
}

// The block holding unit u of a launch of `units` units over `grid`
// blocks, block b taking [b*units/grid, (b+1)*units/grid).
__device__ __forceinline__ long long block_of(long long u, long long units,
                                              long long grid) {
  return ((u + 1) * grid - 1) / units;
}

template <int V>
__global__ void __launch_bounds__(THETA_THREADS)
theta_tests_kernel(const TestArgs a) {
  __shared__ float smem[WARPS][MAX_K];
  __shared__ bool last;
  const long long grid = gridDim.x, b = blockIdx.x;
  const long long lo = b * a.units / grid, hi = (b + 1) * a.units / grid;
  const long long gseg = a.T * a.seg;       // units in a group
  const long long first_group = lo / gseg;
  const int K = a.K;
  const long long hb = a.seg * V;           // floats in a segment

  float acc[MAX_K], d[MAX_K];
  float ca = 0.0f, cb = 0.0f, cc = 0.0f;
  bool div = true;
  long long group = -1;
  long long u = lo;
  while (u < hi) {
    const long long gi = u / gseg, rem = u - gi * gseg;
    const long long t = rem / a.seg, j0 = rem - t * a.seg;
    const long long end = hi - u < a.seg - j0 ? j0 + (hi - u) : a.seg;
    if (gi != group) {
      if (group >= 0) {
        float v;
        block_sums(acc, K, smem, &v);
        if (threadIdx.x < K)
          a.part[(b * 2 + (group - first_group)) * MAX_K + threadIdx.x] = v;
      }
      group = gi;
      const long long s = gi >> 2, g = gi & 3;
      const bool is_tanh = a.tanh_cols[g * a.H] != 0;
      ca = is_tanh ? 0.0f : 0.5f;
      cb = cc = is_tanh ? 1.0f : 0.5f;
      div = false;
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) {
        acc[k] = 0.0f;
        const float th =
            k < K ? a.theta[k * a.th_k + s * a.th_s + g * a.th_g] : 1.0f;
        int e;
        // A power of two 2^(e-1) whose reciprocal 2^(1-e) is a float.
        div = div || !(frexpf(th, &e) == 0.5f && e >= -126);
        d[k] = th;
      }
      if (!div) {
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) d[k] = __fdiv_rn(1.0f, d[k]);
      }
    }
    const long long s = gi >> 2, g = gi & 3;
    const float* pre = a.pre + s * a.pre_s + t * a.pre_t + g * hb;
    const float* grad = a.grad_proj + s * a.grad_s + t * a.grad_t + g * hb;
    const float* tgt = a.target + s * a.tgt_s + t * a.tgt_t + g * hb;
    if (div)
      segment<V, true>(pre, grad, tgt, j0, end, K, d, ca, cb, cc, acc);
    else
      segment<V, false>(pre, grad, tgt, j0, end, K, d, ca, cb, cc, acc);
    u += end - j0;
  }
  {
    float v;
    block_sums(acc, K, smem, &v);
    if (threadIdx.x < K) {
      a.part[(b * 2 + (group - first_group)) * MAX_K + threadIdx.x] = v;
      __threadfence();
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == grid - 1;
  __syncthreads();
  if (!last) return;

  // The last block: every group's partials, in block order, FOLD loads
  // in flight at a time.  Every block after the group's first starts in
  // the group (slot 0); the first holds the group in slot 1 if it
  // started in the group before.
  __threadfence();
  constexpr int FOLD = 8;
  const long long groups = 4LL * a.S;
  for (long long i = threadIdx.x; i < groups * K; i += THETA_THREADS) {
    const long long k = i / groups, gi = i - k * groups;
    const long long b_lo = block_of(gi * gseg, a.units, grid);
    const long long b_hi = block_of((gi + 1) * gseg - 1, a.units, grid);
    const long long lo_slot = b_lo * a.units / grid < gi * gseg ? 1 : 0;
    float sum = 0.0f;
    for (long long b0 = b_lo; b0 <= b_hi; b0 += FOLD) {
      float v[FOLD];
#pragma unroll
      for (int q = 0; q < FOLD; ++q) {
        const long long bb = b0 + q;
        const long long slot = bb == b_lo ? lo_slot : 0;
        v[q] = bb <= b_hi ? __ldcg(a.part + (bb * 2 + slot) * MAX_K + k)
                          : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < FOLD; ++q)
        if (b0 + q <= b_hi) sum = b0 + q == b_lo ? v[q] : sum + v[q];
    }
    a.out[k * groups + gi] = sum;
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

}  // namespace

extern "C" {

// The current device's SM count, and the resident blocks per SM, registers
// and local (spill) bytes per thread of theta_tests_kernel<vec>, for
// kernels/theta_tests.py::tests_plan.  Returns a CUDA error code.
int theta_tests_occupancy(int vec, int* sms, int* blocks_per_sm, int* regs,
                          int* local_bytes) {
  if (vec != 1 && vec != 4) return cudaErrorInvalidValue;
  const void* fn = vec == 4 ? (const void*)theta_tests_kernel<4>
                            : (const void*)theta_tests_kernel<1>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       THETA_THREADS, 0);
}

// Launches the theta tests of one block of K (1..MAX_K) thetas on
// `stream`: slabs pre, grad_proj and target of S instances (1 without the
// candidate axis, the s strides then unused), each (T, 4H, B) with (4H, B)
// contiguous from the instance's and step's offsets pre_s * s + pre_t * t
// (and likewise); theta (K, S, 4) at strides th_k, th_s, th_g; tanh_cols
// (4H,) bytes; out (K, S, 4) contiguous; `part` MAX_K * 2 * grid floats of
// scratch; `ticket` one unsigned int, 0 before the launch and after it
// (launches that share one must not overlap).  `vec` floats per access
// (4: every slab pointer 16-byte aligned, H*B and the six slab strides
// multiples of 4) and `grid` blocks (at least 4 * S, at most the units).
// Strides are in floats and not negative.  Returns cudaErrorInvalidValue
// for what the kernel does not take, else cudaGetLastError() after the
// launch (0 = launched).
int theta_tests(const void* pre, const void* grad_proj, const void* target,
                const void* theta, const void* tanh_cols, void* out,
                void* part, void* ticket, int K, int S, int T, int H, int B,
                int vec, int grid, long long pre_s, long long pre_t,
                long long grad_s, long long grad_t, long long tgt_s,
                long long tgt_t, long long th_k, long long th_s,
                long long th_g, void* stream) {
  if (K < 1 || K > MAX_K || S < 1 || T < 1 || H < 1 || B < 1)
    return cudaErrorInvalidValue;
  if (pre_s < 0 || pre_t < 0 || grad_s < 0 || grad_t < 0 || tgt_s < 0 ||
      tgt_t < 0 || th_k < 0 || th_s < 0 || th_g < 0)
    return cudaErrorInvalidValue;
  const long long hb = (long long)H * B;
  if (vec != 1 && vec != 4) return cudaErrorInvalidValue;
  if (vec == 4) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(pre) |
                           reinterpret_cast<uintptr_t>(grad_proj) |
                           reinterpret_cast<uintptr_t>(target);
    if (bits % 16 != 0 || hb % 4 != 0 ||
        (pre_s | pre_t | grad_s | grad_t | tgt_s | tgt_t) % 4 != 0)
      return cudaErrorInvalidValue;
  }
  TestArgs a;
  a.seg = hb / vec;
  a.units = 4LL * S * T * a.seg;
  if (grid < 4LL * S || grid > a.units || grid > (1 << 30))
    return cudaErrorInvalidValue;
  a.pre = static_cast<const float*>(pre);
  a.grad_proj = static_cast<const float*>(grad_proj);
  a.target = static_cast<const float*>(target);
  a.theta = static_cast<const float*>(theta);
  a.tanh_cols = static_cast<const unsigned char*>(tanh_cols);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.ticket = static_cast<unsigned int*>(ticket);
  a.K = K;
  a.S = S;
  a.T = T;
  a.H = H;
  a.pre_s = pre_s;
  a.pre_t = pre_t;
  a.grad_s = grad_s;
  a.grad_t = grad_t;
  a.tgt_s = tgt_s;
  a.tgt_t = tgt_t;
  a.th_k = th_k;
  a.th_s = th_s;
  a.th_g = th_g;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    theta_tests_kernel<4><<<grid, THETA_THREADS, 0, st>>>(a);
  else
    theta_tests_kernel<1><<<grid, THETA_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
