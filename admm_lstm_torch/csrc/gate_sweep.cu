// Fused interior timestep sweeps of the fast ADMM-LSTM epoch, for Hopper:
// the Gauss-Seidel sweep and the Jacobi sweep.
//
// interior_sweep_kernel replaces
// admm_lstm_tpu/kernels/gate_sweep.py::pallas_interior_sweep.  For
// t = 1..T-1 (here s = 0..steps-1), serially in time and independently per
// batch column b, it computes
//   pre_g = xproj[s, g] + wh[g]^T h_{s-1}                 (g = i, f, g, o)
//   the closed forms for i, f, g, o, the c prox-linear step (theta = 1/2),
//   the interior h, and the five dual ascents i, f, g, o, c,
// in the operation order of `_timestep_math` (gate_sweep.py:53-78), which
// is the reference's Gauss-Seidel order.  h_0 = c_0 = 0.
//
// jacobi_sweep_kernel replaces
// admm_lstm_tpu/kernels/gate_sweep.py::pallas_jacobi_sweep: the same
// per-timestep math, but every timestep reads the previous sweep's
// c_{s-1} (c_prev) and a pre-activation whose recurrent product was
// hoisted out (one matmul over all timesteps, in PyTorch), so there is no
// carry and every (s, j, b) element is independent.  h_prev is part of the
// contract but does not enter the math once the product is hoisted.
//
// Both kernels call one __device__ function, timestep_math, so the math
// exists once.
//
// Layout: every slab is (steps, H, B) row-major, batch-minor; xproj and
// pre are (steps, 4, H, B); wh is (4, H, H) with wh[g][k][j] the weight
// from h_{s-1}[k] to gate g's row j.  All f32.
//
// What bounds them on an H100: bytes.  The Gauss-Seidel sweep reads 14
// slab-sized inputs (the 4 xproj gates, old f, g, c, h and 6 duals; old i
// and o do not enter the math) and writes 11; at GoogleStock (steps 9,
// H 10, B 4224) that is about 38 MB, about 11 us at 3.35 TB/s, while the
// arithmetic (8H + ~105 operations per element and step) is far below the
// FP32 peak.  Its second floor is the serial chain of `steps` dependent
// timesteps, each a small matrix-vector product plus a block barrier.  The
// Jacobi sweep reads 15 slabs (c_prev instead of the carry) and writes 11,
// with ~105 operations per element: 39.5 MB at GoogleStock, 12 us.
//
// Gauss-Seidel design: one block owns a tile of TB = 32 batch columns
// (narrowed only when H > ~600 would overflow shared memory) and loops over
// time inside the block (this replaces the TPU's sequential time grid and
// its carry reset at t == 0; blocks share nothing).  Thread (tx, ty) owns
// column tx of the tile and hidden rows ty, ty + HY, ...; a warp spans
// the 32 columns of one row, so every slab load and store is one
// contiguous 128-byte row segment.  h_{s-1} for the tile lives in shared
// memory, double-buffered, with one __syncthreads() per step; c_{s-1} is
// only read elementwise and stays in shared memory without a second
// buffer.  wh sits in shared memory when it fits beside the tile
// (16*H^2 bytes; H <= ~100) and is otherwise read through L1/L2.  The
// ragged batch edge is masked in the kernel.
//
// Jacobi design: one thread per (s, j, b) element, consecutive threads on
// consecutive b, so every one of the 26 slab accesses of a warp is one
// contiguous 128-byte segment; a grid-stride loop covers any size and the
// ragged edge needs no padding.  No shared memory, no barrier.
//
// Numerics of both: FP32 FMA, no TF32, IEEE division, full-precision
// expf/tanhf (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;         // batch columns per block (one warp wide)
constexpr int MAX_THREADS = 512;
constexpr int JACOBI_THREADS = 256;

struct SweepArgs {
  const float* xproj;        // (steps, 4, H, B)
  const float* wh;           // (4, H, H)
  const float* rho;          // (6,) i, f, g, o, c, h
  const float* in[12];       // gates i,f,g,o,c,h then duals i,f,g,o,c,h
  float* out[11];            // gates i,f,g,o,c,h then duals i,f,g,o,c
  int steps, H, B;
};

struct JacobiArgs {
  const float* pre;          // (steps, 4, H, B)
  const float* c_prev;       // (steps, H, B) previous sweep's c_{s-1}
  const float* rho;          // (6,) i, f, g, o, c, h
  const float* in[12];       // gates i,f,g,o,c,h then duals i,f,g,o,c,h
  float* out[11];            // gates i,f,g,o,c,h then duals i,f,g,o,c
  int steps, H, B;
};

struct Rho {
  float i, f, g, o, c, h;
};

__device__ __forceinline__ Rho load_rho(const float* rho) {
  return Rho{rho[0], rho[1], rho[2], rho[3], rho[4], rho[5]};
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One interior timestep of element e: the four pre-activations, the old
// f, g, c, h and the six duals at e (from `in`), and c_{s-1} -> the new
// i, f, g, o, c, h and the new duals i, f, g, o, c, in that order, in res.
__device__ __forceinline__ void timestep_math(const float pre[4],
                                              const float* const* in,
                                              size_t e, float cp,
                                              const Rho& r, float res[11]) {
  const float act_i = sigmoidf_(pre[0]);
  const float act_f = sigmoidf_(pre[1]);
  const float act_g = tanhf(pre[2]);
  const float act_o = sigmoidf_(pre[3]);

  const float f_o = in[1][e], g_o = in[2][e], c_o = in[4][e], h_o = in[5][e];
  const float li = in[6][e], lf = in[7][e], lg = in[8][e], lo = in[9][e],
              lc = in[10][e], lh = in[11][e];

  // Gauss-Seidel closed forms (admm.py:353-386).  The old i and o gates
  // do not enter their own updates.
  const float i_n = -(li - r.i * act_i + (r.c * (f_o * cp - c_o) - lc) * g_o)
                    / (r.i + r.c * g_o * g_o);
  const float f_n = -(lf - r.f * act_f + (r.c * (g_o * i_n - c_o) - lc) * cp)
                    / (r.f + r.c * cp * cp);
  const float g_n = -(lg - r.g * act_g + (r.c * (f_n * cp - c_o) - lc) * i_n)
                    / (r.g + r.c * i_n * i_n);
  const float tc_o = tanhf(c_o);
  const float o_n = -(lo - r.o * act_o + (r.h * (0.0f - h_o) - lh) * tc_o)
                    / (r.o + r.h * tc_o * tc_o);

  // c prox-linear with constant theta = 1/2 (admm.py:388-436).
  const float z = h_o + lh / r.h;
  const float grad_c = (tc_o * o_n - z) * o_n * (1.0f - tc_o * tc_o);
  const float a_term = lc / r.c - f_n * cp - i_n * g_n;
  const float c_n = (0.5f * c_o - grad_c - r.c * a_term) / (r.c + 0.5f);

  // Interior h closed form (admm.py:456).
  const float h_n = (r.h * o_n * tanhf(c_n) - lh) / r.h;

  res[0] = i_n;
  res[1] = f_n;
  res[2] = g_n;
  res[3] = o_n;
  res[4] = c_n;
  res[5] = h_n;
  // Dual ascent i, f, g, o, c (admm.py:512-530).
  res[6] = li + r.i * (i_n - act_i);
  res[7] = lf + r.f * (f_n - act_f);
  res[8] = lg + r.g * (g_n - act_g);
  res[9] = lo + r.o * (o_n - act_o);
  res[10] = lc + r.c * (c_n - (f_n * cp + i_n * g_n));
}

template <bool WH_SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
interior_sweep_kernel(const SweepArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, B = a.B;
  const int HH = H * H;
  float* wh_s = smem;                                  // 4*H*H if WH_SMEM
  const int tb = blockDim.x;                           // batch columns
  float* hbuf = smem + (WH_SMEM ? 4 * HH : 0);         // [2][H][tb]
  float* cbuf = hbuf + 2 * H * tb;                     // [H][tb]

  const int tx = threadIdx.x, ty = threadIdx.y, HY = blockDim.y;
  const int nthreads = tb * HY, tid = ty * tb + tx;
  const int b = blockIdx.x * tb + tx;
  const bool valid = b < B;

  if (WH_SMEM) {
    for (int e = tid; e < 4 * HH; e += nthreads) wh_s[e] = a.wh[e];
  }
  for (int e = tid; e < H * tb; e += nthreads) {
    hbuf[e] = 0.0f;
    cbuf[e] = 0.0f;
  }
  const float* wh = WH_SMEM ? wh_s : a.wh;
  const Rho rho = load_rho(a.rho);
  __syncthreads();

  const size_t slab = (size_t)H * B;                   // one time row
  for (int s = 0; s < a.steps; ++s) {
    const float* hp = hbuf + (s & 1) * H * tb;
    float* hn = hbuf + ((s + 1) & 1) * H * tb;
    if (valid) {
      for (int j = ty; j < H; j += HY) {
        // Recurrent projection for row j of all four gates.
        float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
        for (int k = 0; k < H; ++k) {
          const float hk = hp[k * tb + tx];
          const int w = k * H + j;
          acc0 = fmaf(wh[w], hk, acc0);
          acc1 = fmaf(wh[HH + w], hk, acc1);
          acc2 = fmaf(wh[2 * HH + w], hk, acc2);
          acc3 = fmaf(wh[3 * HH + w], hk, acc3);
        }
        const size_t e = (size_t)s * slab + (size_t)j * B + b;
        const size_t xe = (size_t)s * 4 * slab + (size_t)j * B + b;
        const float pre[4] = {a.xproj[xe] + acc0, a.xproj[xe + slab] + acc1,
                              a.xproj[xe + 2 * slab] + acc2,
                              a.xproj[xe + 3 * slab] + acc3};
        const float cp = cbuf[j * tb + tx];
        float res[11];
        timestep_math(pre, a.in, e, cp, rho, res);
        for (int k = 0; k < 11; ++k) a.out[k][e] = res[k];
        hn[j * tb + tx] = res[5];
        cbuf[j * tb + tx] = res[4];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(JACOBI_THREADS)
jacobi_sweep_kernel(const JacobiArgs a) {
  const Rho rho = load_rho(a.rho);
  const size_t slab = (size_t)a.H * a.B;
  const size_t total = slab * a.steps;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const size_t s = e / slab;
    const size_t xe = e + 3 * s * slab;     // (s, gate 0, j, b) in pre
    const float pre[4] = {a.pre[xe], a.pre[xe + slab], a.pre[xe + 2 * slab],
                          a.pre[xe + 3 * slab]};
    float res[11];
    timestep_math(pre, a.in, e, a.c_prev[e], rho, res);
    for (int k = 0; k < 11; ++k) a.out[k][e] = res[k];
  }
}

constexpr size_t MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr int JACOBI_MAX_BLOCKS = 132 * 16;  // a grid-stride loop covers the rest

constexpr int MAX_DEVICES = 64;
bool sweep_ready[2][MAX_DEVICES];    // [WH_SMEM] per device

// Raises interior_sweep_kernel<WH_SMEM>'s dynamic shared memory limit to
// MAX_SMEM once per device and remembers it, so a launch does not pay a
// cudaFuncSetAttribute.  Two threads racing here both set the same value.
template <bool WH_SMEM>
cudaError_t prepare_sweep() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  bool* done = sweep_ready[WH_SMEM];
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(interior_sweep_kernel<WH_SMEM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)MAX_SMEM);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// Launches the sweep on `stream`.  `ins` holds 12 device pointers (gates
// i,f,g,o,c,h, duals i,f,g,o,c,h), `outs` 11 (gates i..h, duals i..c).
// Returns cudaGetLastError() after the launch (0 = launched).
int gate_sweep_interior(const void* xproj, const void* wh, const void* rho,
                        const void* const* ins, void* const* outs,
                        int steps, int hidden, int batch, void* stream) {
  SweepArgs a;
  a.xproj = static_cast<const float*>(xproj);
  a.wh = static_cast<const float*>(wh);
  a.rho = static_cast<const float*>(rho);
  for (int k = 0; k < 12; ++k) a.in[k] = static_cast<const float*>(ins[k]);
  for (int k = 0; k < 11; ++k) a.out[k] = static_cast<float*>(outs[k]);
  a.steps = steps;
  a.H = hidden;
  a.B = batch;

  if (steps < 1 || hidden < 1 || batch < 1) return cudaErrorInvalidValue;
  // A warp-wide tile of 32 columns, narrowed only when the tile's h and c
  // (3 * H * tb floats) would not fit in shared memory (H > ~600).
  int tb = TB;
  while (tb > 1 && 3 * (size_t)hidden * tb * sizeof(float) > MAX_SMEM) tb /= 2;
  const size_t tile_bytes = 3 * (size_t)hidden * tb * sizeof(float);
  const size_t wh_bytes = 4 * (size_t)hidden * hidden * sizeof(float);
  const bool wh_smem = tile_bytes + wh_bytes <= MAX_SMEM;
  const size_t smem = tile_bytes + (wh_smem ? wh_bytes : 0);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;

  const int max_hy = MAX_THREADS / tb;
  const dim3 block(tb, hidden < max_hy ? hidden : max_hy);
  const dim3 grid((batch + tb - 1) / tb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (wh_smem) {
    err = prepare_sweep<true>();
    if (err != cudaSuccess) return err;
    interior_sweep_kernel<true><<<grid, block, smem, st>>>(a);
  } else {
    err = prepare_sweep<false>();
    if (err != cudaSuccess) return err;
    interior_sweep_kernel<false><<<grid, block, smem, st>>>(a);
  }
  return cudaGetLastError();
}

// Launches the Jacobi sweep on `stream`.  `ins` and `outs` as above; pre
// is (steps, 4, H, B) and c_prev (steps, H, B).  Returns
// cudaGetLastError() after the launch (0 = launched).
int gate_sweep_jacobi(const void* pre, const void* c_prev, const void* rho,
                      const void* const* ins, void* const* outs, int steps,
                      int hidden, int batch, void* stream) {
  if (steps < 1 || hidden < 1 || batch < 1) return cudaErrorInvalidValue;
  JacobiArgs a;
  a.pre = static_cast<const float*>(pre);
  a.c_prev = static_cast<const float*>(c_prev);
  a.rho = static_cast<const float*>(rho);
  for (int k = 0; k < 12; ++k) a.in[k] = static_cast<const float*>(ins[k]);
  for (int k = 0; k < 11; ++k) a.out[k] = static_cast<float*>(outs[k]);
  a.steps = steps;
  a.H = hidden;
  a.B = batch;
  const size_t total = (size_t)steps * hidden * batch;
  size_t blocks = (total + JACOBI_THREADS - 1) / JACOBI_THREADS;
  if (blocks > JACOBI_MAX_BLOCKS) blocks = JACOBI_MAX_BLOCKS;
  jacobi_sweep_kernel<<<(unsigned)blocks, JACOBI_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
