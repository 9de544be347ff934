// Fused Gauss-Seidel interior sweep of the fast ADMM-LSTM epoch, for Hopper.
//
// Replaces admm_lstm_tpu/kernels/gate_sweep.py::pallas_interior_sweep.
// For t = 1..T-1 (here s = 0..steps-1), serially in time and
// independently per batch column b, it computes
//   pre_g = xproj[s, g] + wh[g]^T h_{s-1}                 (g = i, f, g, o)
//   the closed forms for i, f, g, o, the c prox-linear step (theta = 1/2),
//   the interior h, and the five dual ascents i, f, g, o, c,
// in the operation order of `_timestep_math` (gate_sweep.py:53-78), which
// is the reference's Gauss-Seidel order.  h_0 = c_0 = 0.
//
// Layout: every slab is (steps, H, B) row-major, batch-minor; xproj is
// (steps, 4, H, B); wh is (4, H, H) with wh[g][k][j] the weight from
// h_{s-1}[k] to gate g's row j.  All f32.
//
// What bounds it on an H100: bytes.  Each call reads 14 slab-sized inputs
// (the 4 xproj gates, old f, g, c, h and 6 duals; old i and o do not enter
// the math) and writes 11; at GoogleStock (steps 9, H 10, B 4224) that is
// about 38 MB, about 11 us at 3.35 TB/s, while the arithmetic (8H + ~105
// operations per element and step) is far below the FP32 peak.  The second
// floor is the serial chain of `steps` dependent timesteps, each a small
// matrix-vector product plus a block barrier.
//
// Design: one block owns a tile of TB = 32 batch columns (narrowed only
// when H > ~600 would overflow shared memory) and loops over
// time inside the block (this replaces the TPU's sequential time grid and
// its carry reset at t == 0; blocks share nothing).  Thread (tx, ty) owns
// column tx of the tile and hidden rows ty, ty + HY, ...; a warp spans
// the 32 columns of one row, so every slab load and store is one
// contiguous 128-byte row segment.  h_{s-1} for the tile lives in shared
// memory, double-buffered, with one __syncthreads() per step; c_{s-1} is
// only read elementwise and stays in shared memory without a second
// buffer.  wh sits in shared memory when it fits beside the tile
// (16*H^2 bytes; H <= ~100) and is otherwise read through L1/L2.  The
// ragged batch edge is masked in the kernel.  Numerics: FP32 FMA, no
// TF32, IEEE division, full-precision expf/tanhf (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;         // batch columns per block (one warp wide)
constexpr int MAX_THREADS = 512;

struct SweepArgs {
  const float* xproj;        // (steps, 4, H, B)
  const float* wh;           // (4, H, H)
  const float* rho;          // (6,) i, f, g, o, c, h
  const float* in[12];       // gates i,f,g,o,c,h then duals i,f,g,o,c,h
  float* out[11];            // gates i,f,g,o,c,h then duals i,f,g,o,c
  int steps, H, B;
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
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
  const float ri = a.rho[0], rf = a.rho[1], rg = a.rho[2], ro = a.rho[3],
              rc = a.rho[4], rh = a.rho[5];
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
        const float act_i = sigmoidf_(a.xproj[xe] + acc0);
        const float act_f = sigmoidf_(a.xproj[xe + slab] + acc1);
        const float act_g = tanhf(a.xproj[xe + 2 * slab] + acc2);
        const float act_o = sigmoidf_(a.xproj[xe + 3 * slab] + acc3);

        const float f_o = a.in[1][e], g_o = a.in[2][e], c_o = a.in[4][e],
                    h_o = a.in[5][e];
        const float li = a.in[6][e], lf = a.in[7][e], lg = a.in[8][e],
                    lo = a.in[9][e], lc = a.in[10][e], lh = a.in[11][e];
        const float cp = cbuf[j * tb + tx];

        // Gauss-Seidel closed forms (admm.py:353-386).  The old i and o
        // gates do not enter their own updates.
        const float i_n = -(li - ri * act_i + (rc * (f_o * cp - c_o) - lc) * g_o)
                          / (ri + rc * g_o * g_o);
        const float f_n = -(lf - rf * act_f + (rc * (g_o * i_n - c_o) - lc) * cp)
                          / (rf + rc * cp * cp);
        const float g_n = -(lg - rg * act_g + (rc * (f_n * cp - c_o) - lc) * i_n)
                          / (rg + rc * i_n * i_n);
        const float tc_o = tanhf(c_o);
        const float o_n = -(lo - ro * act_o + (rh * (0.0f - h_o) - lh) * tc_o)
                          / (ro + rh * tc_o * tc_o);

        // c prox-linear with constant theta = 1/2 (admm.py:388-436).
        const float z = h_o + lh / rh;
        const float grad_c = (tc_o * o_n - z) * o_n * (1.0f - tc_o * tc_o);
        const float a_term = lc / rc - f_n * cp - i_n * g_n;
        const float c_n = (0.5f * c_o - grad_c - rc * a_term) / (rc + 0.5f);

        // Interior h closed form (admm.py:456).
        const float h_n = (rh * o_n * tanhf(c_n) - lh) / rh;

        a.out[0][e] = i_n;
        a.out[1][e] = f_n;
        a.out[2][e] = g_n;
        a.out[3][e] = o_n;
        a.out[4][e] = c_n;
        a.out[5][e] = h_n;
        // Dual ascent i, f, g, o, c (admm.py:512-530).
        a.out[6][e] = li + ri * (i_n - act_i);
        a.out[7][e] = lf + rf * (f_n - act_f);
        a.out[8][e] = lg + rg * (g_n - act_g);
        a.out[9][e] = lo + ro * (o_n - act_o);
        a.out[10][e] = lc + rc * (c_n - (f_n * cp + i_n * g_n));

        hn[j * tb + tx] = h_n;
        cbuf[j * tb + tx] = c_n;
      }
    }
    __syncthreads();
  }
}

constexpr size_t MAX_SMEM = 232448;  // bytes a block may use on sm_90

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
    err = cudaFuncSetAttribute(interior_sweep_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    interior_sweep_kernel<true><<<grid, block, smem, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(interior_sweep_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    interior_sweep_kernel<false><<<grid, block, smem, st>>>(a);
  }
  return cudaGetLastError();
}

}  // extern "C"
