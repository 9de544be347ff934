// The stacked variant's sweep over t and the layers, for Hopper: one
// launch computes every interior row of an epoch's new slabs for every
// candidate, and a second kernel, before it, the z step's curvature bounds.
//
// stacked_sweep_kernel replaces no TPU kernel.  The JAX package runs this
// sweep as a lax.scan (admm_lstm_tpu/variants/stacked.py) that XLA fuses;
// PyTorch runs eagerly, where the plain version
// (variants/stacked.py::stacked_sweep_plain) is a Python loop over t and
// the layers of about 135 operations a (t, layer) pair, each streaming a
// whole (S, H, B) or (S, 4, H, B) row through HBM, and a dozen full passes
// before the loop for the z step's targets and bounds.
//
// What it computes.  Per candidate s and batch column b, for t = 1..T and
// the layers k = 0..N-1 bottom-up, in the plain version's operation order
// (sums over a product's inner axis excepted, which run in another order
// than cuBLAS's):
//  * layer 0: pre = x_t wx_0 + wh_0^T h_{0,t-1}, then the closed forms of
//    i, f, g, o, the c prox-linear step (theta = 1/2) and the five dual
//    ascents i, f, g, o, c (solvers/closed_form.py; core/step.py::
//    _timestep_primal_duals);
//  * an upper layer k: lin = wx_k^T h_{k-1,t} + wh_k^T h_{k,t-1}, the
//    majorized prox-linear z step against the gate targets u = gate +
//    dual / rho_g with the curvature bound resmax[k][s][t], act(z) in
//    place of act(pre) in the same closed forms and duals, and the z dual
//    lam_z + rho_z (z - lin);
//  * h of a layer k below the top: the ridge solve against the z above,
//    h = M_k^-1 (rho_h o tanh(c) - lam_h + rho_z wx_{k+1} tgt) with
//    tgt = z_{k+1,t} + lam_z / rho_z - wh_{k+1}^T h_{k+1,t-1}, the last
//    product computed once for the solve and the layer above's lin;
//  * h of the top layer for t < T: (rho_h o tanh(c) - lam_h) / rho_h.
// Every dual ascent is multiplied by `decay` (StepRules.
// stacked_dual_decay).  It writes every row of the new slabs, row 0's
// zeros and the top layer's h at T (zero; sweep.final writes it) included.
//
// stacked_resmax_kernel computes, for each upper layer, candidate and
// t = 1..T, resmax = max over (g, j, b) of |act(z) - (gate + dual / rho_g)|
// on the previous epoch's slabs: one pass, the block maxima combined by an
// atomic max on the float's bits, which order the non-negative floats (and
// put NaN above them) as the floats do, so the result equals torch.amax
// bit for bit.
//
// Layout: slabs (S, T+1, H, B) and z slabs (S, T+1, 4, H, B), each with
// (H, B) contiguous and the candidate and time strides the caller gives;
// the outputs contiguous.  x is (T, I, B) contiguous, shared by the
// candidates.  Each candidate's weights are one packed row
// (kernels/stacked_sweep.py::pack_weights): per layer wh_k as [d][j][g],
// then wx_k as [d][j][g] (wx_0: d < I), then each M_k^-1 as [j][d], so
// the four gates of one (d, j) are one float4.  All f32.
//
// What bounds it on an H100.  Per t, candidate, column and hidden row the
// two layers of the stacked cell (S 27, T 10, H 40 and 40, B 4224) read 30
// values (layer 0: old f, g, c, h and 6 duals; layer 1: old i, f, g, o, c,
// h, 6 duals, 4 z and 4 z duals) and write 30 (6 gates and 5 duals a
// layer, 4 z and 4 z duals; row 0's zeros too), and the bounds' pass
// reads 12 (layer 1's i, f, g, o, their duals, z): 4 * 27 * 40 * 4224 *
// (60 * 10 + 30 + 12 * 10) B = 13.7 GB, 4.09 ms at 3.35 TB/s
// (portbench's stacked_sweep_roofline counts the same).  The products
// are ~27K multiply-adds per column and step, 62 GFLOP, 0.9 ms at 67
// TFLOP/s FP32: bytes bound it.  The instructions come close: ~4,900 a
// thread and step, 3.8 ms of the SMs' issue slots.  Measured at the cell
// (H100, 700 W): 8.3 ms for the sweep and 0.71 ms for the bounds' pass,
// 45% of the bound together by CUDA events with the L2 flushed
// (chip_smoke.py), 48% by the benchmark's traced kernel times, against
// 74 ms for the plain loop.
//
// Design.  A block takes one candidate and a tile of tb batch columns
// (grid: column tiles x candidates) and carries every layer's h and c
// through t inside the block, so nothing but the slabs crosses HBM: no
// xproj_0 slab (x_t wx_0 is formed in the kernel), no u slabs, no slab
// of products.  The candidate's weights sit in dynamic shared memory for
// the whole launch (84 KB at (40, 40)).  Thread (tx, ty) owns column tx
// and hidden rows ty*R .. ty*R+R-1 of every layer; a warp spans 32 / tb
// row groups, so each weight load is a broadcast to the columns of a row
// group, and each product step is R float4 weight loads and one h load
// for 4R multiply-adds.  h of every layer lives in shared memory ([H][tb]
// a layer, updated in place: every read of h_{k,t-1} precedes, behind a
// barrier, the write of h_{k,t}), c in registers (only its own thread
// reads it), tgt and the solve's right-hand side in two more buffers.  A
// phase issues its rows' slab loads first, so they are in flight during
// its product.  Two blocks share an SM (96 registers a thread).
// kernels/stacked_sweep.py::stacked_sweep_plan picks tb and R and refuses
// a stack whose weights and buffers do not fit a block's shared memory.
// Columns past B run on column B-1's inputs and store nothing; rows past
// a layer's H run on a valid row's weights and store nothing.
//
// Numerics: FP32 FMA, no TF32, IEEE division, full-precision expf and
// tanhf (no fast math); sigmoid is 1 / (1 + expf(-x)), as PyTorch's.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// The most layers a launch takes (2 or 3: each count is a template
// instance, and nvcc took 30 s for 1 to 4 layers against 16 s for 2 and
// 3) and threads a block may have (kernels/stacked_sweep.py::MIN_LAYERS,
// MAX_LAYERS and MAX_THREADS hold the same numbers).
constexpr int MIN_LAYERS = 2;
constexpr int MAX_LAYERS = 3;
constexpr int MAX_THREADS = 320;
constexpr int RESMAX_THREADS = 256;

struct Layer {
  const float* gate[6];      // previous epoch's i, f, g, o, c, h
  const float* dual[6];      // and its duals i, f, g, o, c, h
  const float* z;            // k >= 1: (S, T+1, 4, H, B)
  const float* zdual;
  long long gate_s[6], gate_t[6], dual_s[6], dual_t[6];
  long long z_s, z_t, zdual_s, zdual_t;
  float* out_gate[6];        // new i, f, g, o, c, h, contiguous
  float* out_dual[5];        // new duals i, f, g, o, c
  float* out_z;              // k >= 1: new z and z dual
  float* out_zdual;
  const unsigned* resmax;    // k >= 1: (S, T+1) float bits
  int H;
  int rec;                   // offsets in the packed weights (floats)
  int inp;
  int minv;                  // -1 for the top layer
  int hbuf;                  // offset of the [H][tb] h buffer in smem
};

struct SweepArgs {
  Layer layer[MAX_LAYERS];
  const float* x;            // (T, I, B)
  const float* weights;      // (S, w_stride) packed rows
  const float* rho;          // (7,) i, f, g, o, c, h, z; a candidate's row
  long long w_stride, rho_stride;
  int layers, T, I, B;
  int tb;                    // columns a block
  int w_floats;              // packed weights a candidate (a multiple of 4)
  int tgt, rhs;              // offsets of the tgt and rhs buffers in smem
  float decay;
};

struct ResmaxArgs {
  const float* gate[4];      // i, f, g, o
  const float* dual[4];
  const float* z;
  long long gate_s[4], gate_t[4], dual_s[4], dual_t[4], z_s, z_t;
  const float* rho;
  long long rho_stride;
  unsigned* out;             // (S, T+1), zero before the launch
  int T, H, B;
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The closed forms shared by every layer: from the activations act[4]
// (of pre for layer 0, of the new z above it), the old f, g, c, h, the six
// duals and c_{t-1} -> new i, f, g, o, c and the duals i, f, g, o, c.
// solvers/closed_form.py's operation order.
__device__ __forceinline__ void gate_math(const float act[4], float f_o,
                                          float g_o, float c_o, float h_o,
                                          const float lam[6], float cp,
                                          float ri, float rf, float rg,
                                          float ro, float rc, float rh,
                                          float res[10]) {
  const float li = lam[0], lf = lam[1], lg = lam[2], lo = lam[3],
              lc = lam[4], lh = lam[5];
  const float i_n = -(li - ri * act[0] + (rc * (f_o * cp - c_o) - lc) * g_o)
                    / (ri + rc * g_o * g_o);
  const float f_n = -(lf - rf * act[1] + (rc * (g_o * i_n - c_o) - lc) * cp)
                    / (rf + rc * cp * cp);
  const float g_n = -(lg - rg * act[2] + (rc * (f_n * cp - c_o) - lc) * i_n)
                    / (rg + rc * i_n * i_n);
  const float tc_o = tanhf(c_o);
  const float o_n = -(lo - ro * act[3] + (rh * (0.0f - h_o) - lh) * tc_o)
                    / (ro + rh * tc_o * tc_o);
  const float zc = h_o + lh / rh;
  const float grad_c = (tc_o * o_n - zc) * o_n * (1.0f - tc_o * tc_o);
  const float a_term = lc / rc - f_n * cp - i_n * g_n;
  const float c_n = (0.5f * c_o - grad_c - rc * a_term) / (rc + 0.5f);
  res[0] = i_n;
  res[1] = f_n;
  res[2] = g_n;
  res[3] = o_n;
  res[4] = c_n;
  res[5] = li + ri * (i_n - act[0]);
  res[6] = lf + rf * (f_n - act[1]);
  res[7] = lg + rg * (g_n - act[2]);
  res[8] = lo + ro * (o_n - act[3]);
  res[9] = lc + rc * (c_n - (f_n * cp + i_n * g_n));
}

// acc[g][q] += sum over d < n of w[(d * H + j_q) * 4 + g] * v[d * tb + tx],
// d ascending: the four gates of rows j_q of a [d][j][g] block times a
// column of the [n][tb] buffer v.
template <int R>
__device__ __forceinline__ void gate_product(const float* w, const float* v,
                                             int n, int H, const int j[R],
                                             int tb, int tx,
                                             float acc[4][R]) {
#pragma unroll 4
  for (int d = 0; d < n; ++d) {
    const float vd = v[d * tb + tx];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float4 wv =
          *reinterpret_cast<const float4*>(w + ((size_t)d * H + j[q]) * 4);
      acc[0][q] = fmaf(wv.x, vd, acc[0][q]);
      acc[1][q] = fmaf(wv.y, vd, acc[1][q]);
      acc[2][q] = fmaf(wv.z, vd, acc[2][q]);
      acc[3][q] = fmaf(wv.w, vd, acc[3][q]);
    }
  }
}

// N layers (compile-time, so that every a.layer[k] is a fixed parameter
// offset after the layer loops unroll), R rows a thread.  Two blocks an SM
// (at most 96 registers a thread at 320 threads): at (40, 40) one block of
// 104 registers an SM took 1.3-1.5x as long.
template <int R, int N>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    stacked_sweep_kernel(const SweepArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tb = a.tb, nthreads = blockDim.x, tid = threadIdx.x;
  const int tx = tid % tb, ty = tid / tb;
  const int s = blockIdx.y;
  const int b = blockIdx.x * tb + tx;
  const bool col = b < a.B;
  const int bb = col ? b : a.B - 1;
  const int T = a.T, B = a.B;
  constexpr int top = N - 1;

  // The candidate's weights, once.
  {
    const float4* src =
        reinterpret_cast<const float4*>(a.weights + s * a.w_stride);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int v = tid; v < a.w_floats / 4; v += nthreads)
      dst[v] = __ldg(src + v);
  }
  const float* rp = a.rho + s * a.rho_stride;
  const float ri = rp[0], rf = rp[1], rg = rp[2], ro = rp[3], rc = rp[4],
              rh = rp[5], rz = rp[6];
  const float rgate[4] = {ri, rf, rg, ro};
  const float decay = a.decay;
  float* const tgt = smem + a.tgt;
  float* const rhs = smem + a.rhs;

  // h_0 and c_0 from row 0 of the old slabs; row 0 of every output is 0.
  // c of every layer stays in registers: only its own thread reads it.
  float cst[N][R];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const Layer& L = a.layer[k];
    const size_t HB = (size_t)L.H * B;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = ty * R + q;
      cst[k][q] = 0.0f;
      if (j >= L.H) continue;
      const size_t e = (size_t)j * B + bb;
      smem[L.hbuf + j * tb + tx] = __ldg(L.gate[5] + s * L.gate_s[5] + e);
      cst[k][q] = __ldg(L.gate[4] + s * L.gate_s[4] + e);
      if (!col) continue;
      const size_t o = (size_t)s * (T + 1) * HB + (size_t)j * B + b;
#pragma unroll
      for (int m = 0; m < 6; ++m) L.out_gate[m][o] = 0.0f;
#pragma unroll
      for (int m = 0; m < 5; ++m) L.out_dual[m][o] = 0.0f;
      if (k > 0)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const size_t oz = (size_t)s * (T + 1) * 4 * HB + g * HB +
                            (size_t)j * B + b;
          L.out_z[oz] = 0.0f;
          L.out_zdual[oz] = 0.0f;
        }
    }
  }
  __syncthreads();

  // Carried from phase k to phase k+1 (rows of layer k+1): the fixed
  // product wh_{k+1}^T h_{k+1,t-1} and z, lam_z at row t.
  float fx[4][R], zt[4][R], zdt[4][R];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int g = 0; g < 4; ++g) fx[g][q] = zt[g][q] = zdt[g][q] = 0.0f;

  for (int t = 1; t <= T; ++t) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const Layer& L = a.layer[k];
      const int H = L.H;
      const size_t HB = (size_t)H * B;
      int j[R];
      bool ok[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        j[q] = min(ty * R + q, H - 1);
        ok[q] = ty * R + q < H;
      }
      // The rows' old gates and duals at t, in flight during the product.
      float og[R][6], od[R][6];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const size_t e = (size_t)j[q] * B + bb;
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          og[q][m] = (k > 0 || (m != 0 && m != 3))
                         ? __ldg(L.gate[m] + s * L.gate_s[m] +
                                 t * L.gate_t[m] + e)
                         : 0.0f;
          od[q][m] =
              __ldg(L.dual[m] + s * L.dual_s[m] + t * L.dual_t[m] + e);
        }
      }
      float acc[4][R];
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][q] = 0.0f;
      float act[R][4];
      if (k == 0) {
        gate_product<R>(smem + L.rec, smem + L.hbuf, H, H, j, tb, tx, acc);
        const float* wx = smem + L.inp;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          float xp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int d = 0; d < a.I; ++d) {
            const float xv =
                __ldg(a.x + ((size_t)(t - 1) * a.I + d) * B + bb);
            const float4 wv = *reinterpret_cast<const float4*>(
                wx + ((size_t)d * H + j[q]) * 4);
            if (d == 0) {
              xp[0] = xv * wv.x; xp[1] = xv * wv.y;
              xp[2] = xv * wv.z; xp[3] = xv * wv.w;
            } else {
              xp[0] = fmaf(xv, wv.x, xp[0]); xp[1] = fmaf(xv, wv.y, xp[1]);
              xp[2] = fmaf(xv, wv.z, xp[2]); xp[3] = fmaf(xv, wv.w, xp[3]);
            }
          }
          act[q][0] = sigmoidf_(xp[0] + acc[0][q]);
          act[q][1] = sigmoidf_(xp[1] + acc[1][q]);
          act[q][2] = tanhf(xp[2] + acc[2][q]);
          act[q][3] = sigmoidf_(xp[3] + acc[3][q]);
        }
      } else {
        const Layer& D = a.layer[k > 0 ? k - 1 : 0];
        gate_product<R>(smem + L.inp, smem + D.hbuf, D.H, H, j, tb, tx, acc);
        const float rmax = __uint_as_float(L.resmax[s * (T + 1) + t]);
        const size_t oz0 = ((size_t)s * (T + 1) + t) * 4 * HB;
#pragma unroll
        for (int q = 0; q < R; ++q) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            // The majorized prox-linear z step (variants/stacked.py::
            // _z_prox_update).
            const float lin = acc[g][q] + fx[g][q];
            const float v = lin - zdt[g][q] / rz;
            const float u = og[q][g] + od[q][g] / rgate[g];
            const float zo = zt[g][q];
            float a_o, d_act, theta;
            if (g == 2) {
              a_o = tanhf(zo);
              d_act = 1.0f - a_o * a_o;
              theta = rgate[g] * (1.0f + 0.8f * rmax);
            } else {
              a_o = sigmoidf_(zo);
              d_act = a_o * (1.0f - a_o);
              theta = rgate[g] * (0.0625f + 0.1f * rmax);
            }
            const float grad = rgate[g] * (a_o - u) * d_act;
            const float zn = (theta * zo - grad + rz * v) / (theta + rz);
            act[q][g] = g == 2 ? tanhf(zn) : sigmoidf_(zn);
            if (col && ok[q]) {
              const size_t oz = oz0 + g * HB + (size_t)j[q] * B + b;
              L.out_z[oz] = zn;
              L.out_zdual[oz] = decay * (zdt[g][q] + rz * (zn - lin));
            }
          }
        }
      }

      // The closed forms and duals; o, c and lam_h stay for h.
      float o_n[R], c_n[R];
      const size_t o0 = ((size_t)s * (T + 1) + t) * HB;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float res[10];
        gate_math(act[q], og[q][1], og[q][2], og[q][4], og[q][5], od[q],
                  cst[k][q], ri, rf, rg, ro, rc, rh, res);
        o_n[q] = res[3];
        c_n[q] = res[4];
        cst[k][q] = res[4];
        if (col && ok[q]) {
          const size_t o = o0 + (size_t)j[q] * B + b;
#pragma unroll
          for (int m = 0; m < 5; ++m) L.out_gate[m][o] = res[m];
#pragma unroll
          for (int m = 0; m < 5; ++m) L.out_dual[m][o] = decay * res[5 + m];
        }
      }

      if (k < top) {
        // The coupled h solve against layer k+1's z.
        const Layer& U = a.layer[k < top ? k + 1 : k];
        const int H1 = U.H;
        const size_t HB1 = (size_t)H1 * B;
        int j1[R];
        bool ok1[R];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          j1[q] = min(ty * R + q, H1 - 1);
          ok1[q] = ty * R + q < H1;
          const size_t e = (size_t)j1[q] * B + bb;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            zt[g][q] = __ldg(U.z + s * U.z_s + t * U.z_t + g * HB1 + e);
            zdt[g][q] = __ldg(U.zdual + s * U.zdual_s + t * U.zdual_t +
                              g * HB1 + e);
            fx[g][q] = 0.0f;
          }
        }
        gate_product<R>(smem + U.rec, smem + U.hbuf, H1, H1, j1, tb, tx, fx);
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (ok1[q])
            reinterpret_cast<float4*>(tgt)[j1[q] * tb + tx] = make_float4(
                zt[0][q] + zdt[0][q] / rz - fx[0][q],
                zt[1][q] + zdt[1][q] / rz - fx[1][q],
                zt[2][q] + zdt[2][q] / rz - fx[2][q],
                zt[3][q] + zdt[3][q] / rz - fx[3][q]);
        __syncthreads();
        // rhs_j = rho_h o tanh(c) - lam_h + rho_z sum_{g,i} wx_{k+1}[g][j][i]
        // tgt[g][i]; wx_{k+1} is layer k+1's [d][j][g] block, d = this j.
        const float4* wu = reinterpret_cast<const float4*>(smem + U.inp);
        const float4* tg = reinterpret_cast<const float4*>(tgt) + tx;
        float p[R];
#pragma unroll
        for (int q = 0; q < R; ++q) p[q] = 0.0f;
#pragma unroll 4
        for (int i = 0; i < H1; ++i) {
          const float4 tv = tg[i * tb];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const float4 wv = wu[(size_t)j[q] * H1 + i];
            p[q] = fmaf(wv.x, tv.x, p[q]);
            p[q] = fmaf(wv.y, tv.y, p[q]);
            p[q] = fmaf(wv.z, tv.z, p[q]);
            p[q] = fmaf(wv.w, tv.w, p[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (ok[q])
            rhs[j[q] * tb + tx] =
                rh * o_n[q] * tanhf(c_n[q]) - od[q][5] + rz * p[q];
        __syncthreads();
        const float* mi = smem + L.minv;
        float hn[R];
#pragma unroll
        for (int q = 0; q < R; ++q) hn[q] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < H; ++d) {
          const float rd = rhs[d * tb + tx];
#pragma unroll
          for (int q = 0; q < R; ++q)
            hn[q] = fmaf(mi[(size_t)j[q] * H + d], rd, hn[q]);
        }
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (ok[q]) {
            smem[L.hbuf + j[q] * tb + tx] = hn[q];
            if (col) L.out_gate[5][o0 + (size_t)j[q] * B + b] = hn[q];
          }
        __syncthreads();
      } else {
        // The top layer's interior h; at t = T sweep.final writes it.
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float hn = t < T
              ? (rh * o_n[q] * tanhf(c_n[q]) - od[q][5]) / rh : 0.0f;
          if (ok[q]) {
            smem[L.hbuf + j[q] * tb + tx] = hn;
            if (col) L.out_gate[5][o0 + (size_t)j[q] * B + b] = hn;
          }
        }
      }
    }
    __syncthreads();
  }
}

// V floats an access: 4 where every slab pointer and stride and H * B are
// multiples of 4 (float4 loads), else 1.
template <int V>
__global__ void __launch_bounds__(RESMAX_THREADS)
    stacked_resmax_kernel(const ResmaxArgs a) {
  // blockIdx.x = s * T + (t - 1); the block's share (blockIdx.y of
  // gridDim.y) of the 4 (H, B) rows.
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int s = blockIdx.x / a.T, t = blockIdx.x % a.T + 1;
  const int n = a.H * a.B / V;
  const float* rp = a.rho + s * a.rho_stride;
  unsigned m = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const Vec* gp = reinterpret_cast<const Vec*>(a.gate[g] + s * a.gate_s[g] +
                                                 t * a.gate_t[g]);
    const Vec* dp = reinterpret_cast<const Vec*>(a.dual[g] + s * a.dual_s[g] +
                                                 t * a.dual_t[g]);
    const Vec* zp = reinterpret_cast<const Vec*>(
        a.z + s * a.z_s + t * a.z_t + (size_t)g * a.H * a.B);
    const float r = rp[g];
    for (int e = blockIdx.y * RESMAX_THREADS + threadIdx.x; e < n;
         e += gridDim.y * RESMAX_THREADS) {
      const Vec zv = __ldg(zp + e), gv = __ldg(gp + e), dv = __ldg(dp + e);
      const float* zf = reinterpret_cast<const float*>(&zv);
      const float* gf = reinterpret_cast<const float*>(&gv);
      const float* df = reinterpret_cast<const float*>(&dv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float act = g == 2 ? tanhf(zf[i]) : sigmoidf_(zf[i]);
        const float u = gf[i] + df[i] / r;
        m = max(m, __float_as_uint(fabsf(act - u)));
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned warp_max[RESMAX_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < RESMAX_THREADS / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(a.out + s * (a.T + 1) + t, m);
  }
}

template <int N>
const void* sweep_instance(int rows) {
  switch (rows) {
    case 1: return reinterpret_cast<const void*>(stacked_sweep_kernel<1, N>);
    case 2: return reinterpret_cast<const void*>(stacked_sweep_kernel<2, N>);
    case 4: return reinterpret_cast<const void*>(stacked_sweep_kernel<4, N>);
    default: return nullptr;
  }
}

// The instance for `rows` rows a thread and `layers` layers, or null.
const void* sweep_fn(int rows, int layers) {
  switch (layers) {
    case 2: return sweep_instance<2>(rows);
    case 3: return sweep_instance<3>(rows);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches stacked_sweep_kernel<rows, layers> on `stream` over a grid of
// (ceil(B / tb), S) blocks of `threads` threads and `smem` bytes.  `p`
// holds, in this order (every pointer as an integer):
//   layers, T, I, B, tb, w_floats, tgt, rhs, x, weights, w_stride, rho,
//   rho_stride,
// then per layer (layers of them):
//   H, rec, inp, minv, hbuf, gate[6], gate_s[6], gate_t[6], dual[6],
//   dual_s[6], dual_t[6], z, z_s, z_t, zdual, zdual_s, zdual_t,
//   out_gate[6], out_dual[5], out_z, out_zdual, resmax
// (z, zdual, out_z, out_zdual and resmax 0 for layer 0).  Returns
// cudaErrorInvalidValue for what the kernel does not take, else
// cudaGetLastError() after the launch (0 = launched).
int stacked_sweep(const long long* p, int n, float decay, int rows,
                  int threads, int smem, int S, void* stream) {
  constexpr int HEAD = 13, PER_LAYER = 5 + 6 * 6 + 6 + 6 + 5 + 3;
  SweepArgs a{};
  a.layers = (int)p[0];
  if (a.layers < MIN_LAYERS || a.layers > MAX_LAYERS ||
      n != HEAD + a.layers * PER_LAYER)
    return cudaErrorInvalidValue;
  a.T = (int)p[1];
  a.I = (int)p[2];
  a.B = (int)p[3];
  a.tb = (int)p[4];
  a.w_floats = (int)p[5];
  a.tgt = (int)p[6];
  a.rhs = (int)p[7];
  a.x = reinterpret_cast<const float*>(p[8]);
  a.weights = reinterpret_cast<const float*>(p[9]);
  a.w_stride = p[10];
  a.rho = reinterpret_cast<const float*>(p[11]);
  a.rho_stride = p[12];
  a.decay = decay;
  for (int k = 0; k < a.layers; ++k) {
    const long long* q = p + HEAD + k * PER_LAYER;
    Layer& L = a.layer[k];
    L.H = (int)q[0];
    L.rec = (int)q[1];
    L.inp = (int)q[2];
    L.minv = (int)q[3];
    L.hbuf = (int)q[4];
    q += 5;
    for (int m = 0; m < 6; ++m) {
      L.gate[m] = reinterpret_cast<const float*>(q[m]);
      L.gate_s[m] = q[6 + m];
      L.gate_t[m] = q[12 + m];
      L.dual[m] = reinterpret_cast<const float*>(q[18 + m]);
      L.dual_s[m] = q[24 + m];
      L.dual_t[m] = q[30 + m];
    }
    q += 36;
    L.z = reinterpret_cast<const float*>(q[0]);
    L.z_s = q[1];
    L.z_t = q[2];
    L.zdual = reinterpret_cast<const float*>(q[3]);
    L.zdual_s = q[4];
    L.zdual_t = q[5];
    q += 6;
    for (int m = 0; m < 6; ++m) L.out_gate[m] = reinterpret_cast<float*>(q[m]);
    for (int m = 0; m < 5; ++m)
      L.out_dual[m] = reinterpret_cast<float*>(q[6 + m]);
    L.out_z = reinterpret_cast<float*>(q[11]);
    L.out_zdual = reinterpret_cast<float*>(q[12]);
    L.resmax = reinterpret_cast<const unsigned*>(q[13]);
    if (L.H < 1 || (k > 0 && (L.z == nullptr || L.resmax == nullptr)) ||
        (k < a.layers - 1 && L.minv < 0))
      return cudaErrorInvalidValue;
  }
  const void* fn = sweep_fn(rows, a.layers);
  if (fn == nullptr || a.T < 1 || a.B < 1 || a.I < 1 || a.tb < 1 || S < 1 ||
      threads < a.tb || threads % a.tb || threads > MAX_THREADS ||
      a.w_floats % 4 || a.w_stride % 4)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + a.tb - 1) / a.tb, S);
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, grid, dim3(threads), args, (size_t)smem,
                         static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Launches stacked_resmax_kernel for one upper layer on `stream`: `p`
// holds gate[4], gate_s[4], gate_t[4], dual[4], dual_s[4], dual_t[4], z,
// z_s, z_t, rho, rho_stride, out, T, H, B (pointers as integers); out is
// (S, T+1) unsigned, zero before the launch.  `blocks` blocks per (s, t),
// at most 65535; float4 loads where every slab allows them.
// Returns as stacked_sweep does.
int stacked_resmax(const long long* p, int n, int S, int blocks,
                   void* stream) {
  if (n != 33 || S < 1 || blocks < 1) return cudaErrorInvalidValue;
  ResmaxArgs a{};
  for (int g = 0; g < 4; ++g) {
    a.gate[g] = reinterpret_cast<const float*>(p[g]);
    a.gate_s[g] = p[4 + g];
    a.gate_t[g] = p[8 + g];
    a.dual[g] = reinterpret_cast<const float*>(p[12 + g]);
    a.dual_s[g] = p[16 + g];
    a.dual_t[g] = p[20 + g];
  }
  a.z = reinterpret_cast<const float*>(p[24]);
  a.z_s = p[25];
  a.z_t = p[26];
  a.rho = reinterpret_cast<const float*>(p[27]);
  a.rho_stride = p[28];
  a.out = reinterpret_cast<unsigned*>(p[29]);
  a.T = (int)p[30];
  a.H = (int)p[31];
  a.B = (int)p[32];
  if (a.T < 1 || a.H < 1 || a.B < 1 || (long long)a.H * a.B * 4 > INT32_MAX)
    return cudaErrorInvalidValue;
  bool vec4 = (a.H * a.B) % 4 == 0 &&
              reinterpret_cast<uintptr_t>(a.z) % 16 == 0 && a.z_s % 4 == 0 &&
              a.z_t % 4 == 0;
  for (int g = 0; g < 4; ++g)
    vec4 = vec4 && reinterpret_cast<uintptr_t>(a.gate[g]) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(a.dual[g]) % 16 == 0 &&
           a.gate_s[g] % 4 == 0 && a.gate_t[g] % 4 == 0 &&
           a.dual_s[g] % 4 == 0 && a.dual_t[g] % 4 == 0;
  const dim3 grid((unsigned)S * a.T, blocks);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec4)
    stacked_resmax_kernel<4><<<grid, RESMAX_THREADS, 0, st>>>(a);
  else
    stacked_resmax_kernel<1><<<grid, RESMAX_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
