// Fused interior timestep sweeps of the fast ADMM-LSTM epoch, for Hopper:
// the Gauss-Seidel sweep and the Jacobi sweep, and the Gauss-Seidel
// sweep's serial-floor probe.
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
// contract but does not enter the math once the product is hoisted.  It
// takes the same optional leading candidate axis as interior_sweep_kernel.
//
// Both kernels call one __device__ function, timestep_math, so the math
// exists once.
//
// The floor kernels replace benchmarks/bench_gs_floor.py::floor_sweep, a
// probe of the Gauss-Seidel sweep's serial floor: the bare LSTM recurrence
// from the same xproj and wh, c_s = sig(pre_f) c_{s-1} + sig(pre_i)
// tanh(pre_g), h_s = sig(pre_o) tanh(c_s), h_0 = c_0 = 0, with h (steps,
// H, B) its one output.  They move 5 slabs (7.6 MB at GoogleStock, 2.3 us
// at 3.35 TB/s); at long T the chain of dependent steps, a product, 3 expf
// and 2 tanhf deep, sets the time.  kernels/gate_sweep.py::floor_plan
// picks the kernel by H:
//  * H <= 32: floor_warp_kernel<W>, written for the recurrence itself
//    (design below): its step, under half of cuDNN's LSTM step on an H100,
//    is the floor that a Gauss-Seidel step is measured against.
//  * H > 32: floor_sweep_kernel<R, STREAM>, the Gauss-Seidel kernel's loop
//    (one __device__ body, `sweep`, runs both) with another step policy:
//    per row and step it loads 4 projections, not 14, and stores 1 value,
//    not 11, on the same tile plan, recurrent product and carries.  There
//    each FMA takes its weight from shared memory or L2, and that traffic,
//    which interior_sweep's tile plan already answers, sets a step.
//
// Layout: every slab is (steps, H, B) row-major, batch-minor; xproj and
// pre are (steps, 4, H, B); wh is (4, H, H) with wh[g][k][j] the weight
// from h_{s-1}[k] to gate g's row j.  All f32.
//
// What bounds them on an H100.  The Gauss-Seidel sweep reads 14 slab-sized
// inputs (the 4 xproj gates, old f, g, c, h and 6 duals; old i and o do
// not enter the math) and writes 11: at GoogleStock (steps 9, H 10,
// B 4224) about 38 MB, 11.3 us at 3.35 TB/s; at (9, 100, 4224) 380 MB,
// 113 us.  Its recurrent product is 8H operations per element and step
// (3 GFLOP at (9, 100, 4224), 45 us at 67 TFLOP/s FP32), the rest ~105.
// Its second floor is the serial chain of `steps` dependent timesteps,
// each a product, 3 expf, 3 tanhf and 11 IEEE divisions deep, plus a block
// barrier: at T = 128 that chain, not the bytes, sets the time.  In
// between, on an H100 (clock64 stamps per phase), a step of two rows a
// thread at (31, 130, 512) spent ~7K cycles streaming wh chunks from L2,
// ~4.5K on the resident rows' product and ~8.5K on the math with the slab
// stores and the next step's loads, which every block issues at once (the
// math alone is ~2K).  Every FMA takes its wh operand from shared memory,
// and a warp's shared load costs about one cycle per 4-byte lane even when
// the lanes share the address.  The Jacobi sweep reads
// 15 slabs (c_prev instead of the carry) and writes 11, with ~105
// operations per element (~250 instructions: 8 IEEE divisions, 3 expf,
// 3 tanhf): 39.5 MB at GoogleStock, 12 us; 245 MB at (9, 128, 2048),
// 73 us.  It is a stream: bytes bound it, and what keeps it from its bound
// is how many of its loads are in flight and how evenly the SMs share them.
//
// Gauss-Seidel design.  A block owns a tile of tb batch columns and loops
// over time inside the block (this replaces the TPU's sequential time grid
// and its carry reset at t == 0; blocks share nothing).  Thread (tx, ty)
// owns column tx and the R consecutive hidden rows ty*R .. ty*R+R-1 for
// all four gates (R = 1, 2 or 4; rows past H run on zeros and store
// nothing).  kernels/gate_sweep.py::sweep_plan picks tb and R from the
// card (at least min(SMs, ceil(B / 8)) blocks, the fewest waves, the last
// wave as full as it can be; one row a thread below H = 32, where the
// math's chain is the step, the fewest rows from 2 up that fit the tile
// above) and how much of wh stays in shared memory; this entry point
// checks the plan and launches it.
//  * Prefetch: a step's 14 carry-free inputs per row do not depend on the
//    carry, so right after a thread finishes row q of step s it issues
//    row q's 14 loads for step s+1 into the same registers; they are in
//    flight through the rest of step s, the barrier and step s+1's
//    product.  c_{s-1} stays in registers (only its own thread reads it);
//    h_{s-1} is in shared memory, double-buffered, one barrier per step.
//  * Deferred stores: with R <= 2 a step's 11 results per row stay in
//    registers and are stored at the start of the next step's resident
//    product, where they overlap it, not in the math phase, where every
//    block issues its traffic at once (at R = 4 the 44 registers spill).
//  * Product: per k, one shared load of h[k][tx] and R float4 loads, the
//    four gates of wh[.][k][j] for j = j0 .. j0+R-1, feed 4R FMAs into 4R
//    register accumulators.  wh sits in shared memory as
//    [k][hp][4], the four gates of one (k, j) side by side and rows padded
//    with zeros to hp = R * blockDim.y.
//  * wh resident or partly streamed: where all of wh fits beside h (H up
//    to 116 at tb 16, 119 at tb 4) it is loaded once per launch.  Above
//    that a ring of 2 chunks of up to 8 k-rows takes what space it needs
//    and the first `resident` k-rows fill the rest; the other k-rows stream
//    every step through the ring by 16-byte cp.async, one chunk ahead, one
//    barrier per chunk, streamed chunks first and the resident rows last,
//    with no barrier in between, so the warps drift apart.  More slots
//    (more lead, fewer resident rows) were slower: every block reads the
//    streamed rows from L2 every step, and the rows kept resident count
//    for more than the lead.  The product code is the same.  The copies
//    read the (H, hp, 4) padded layout, which the wrapper makes where a
//    thread takes more than one row; the one-row plans gather from
//    (4, H, H) once.  The k-sum runs over the streamed rows, then the
//    resident ones, each ascending.
// The ragged batch edge and the padded rows are masked in the kernel.
//
// The candidate axis.  The JAX package vmaps its epoch over S independent
// ADMM instances (the rho search's grid, the scenario batch), and under
// vmap the Pallas sweep takes a leading grid axis.  Here the grid's second
// axis is the candidate: block (x, y) sweeps batch tile x of candidate y,
// so a block never straddles two candidates and each candidate's ragged
// batch edge is masked as above.  Candidate y's xproj, output slabs, wh,
// padded wh and rho row start y strides past candidate 0's: the strides of
// the contiguous (S, steps, H, B) outputs, (S, 4, H, H), (S, H, hp, 4) and
// (S, 6) tensors, and for xproj and the 12 input slabs the strides the
// caller gives (slices of the epoch's (S, T, 4, H, B) projection and of
// its (S, T+1, H, B) state slabs, each contiguous within a candidate).  The tile plan is picked for S * B
// columns (sweep_plan's `candidates`).  Without the axis (S = 1) the
// kernel and its plan are the ones above, with every offset 0.
//
// Floor design (H <= 32).  H lanes own a batch column, 32 / H columns a
// warp (the lanes past the last whole column run as a column that stores
// nothing); lane j holds row j's c and h in registers.  Where the
// Gauss-Seidel kernel's step ends in a block barrier and reads h_{s-1} and
// wh from shared memory once per k, here (times on an H100 from
// admm_lstm_torch/floor_ab.py, which builds each alternative below):
//  * Carry by shuffles: the product takes h_{s-1}[k] from the column's lane
//    k by __shfl_sync, so the carry never leaves registers and nothing on
//    the chain waits on shared memory or a barrier.  The product runs over
//    W = H rounded up to a power of two k-rows, a compile-time count with
//    zero weights past H, so its W shuffles issue back to back; stopping
//    at k = H, a branch per k, took 2.6-3.3x as long a step.
//  * wh in registers: lane j's 4W weights stay in registers at every W
//    (128 floats at W 32, no spill); from shared memory (one float4 per
//    (k, j)) a step took ~1.4x as long at H 16 and 1.6x at H 32.
//  * A shallow FMA chain: the k-sum runs in two partial sums per gate, even
//    and odd k, each ascending, the even one starting from xproj, added
//    last: 8 independent chains W/2 deep.  The plain version sums over k
//    in one order and then adds xproj.
//  * sigmoid(x) = (1 + tanh(x / 2)) / 2 with full-precision tanhf: 1 / (1
//    + expf(-x)), an expf and an IEEE division, took 1.4-1.7x as long a
//    step (both agree with the plain version within 1.2e-7).
//  * xproj staged ahead: a step's 4 values a lane needs do not depend on
//    the carry.  They wait in shared memory, copied there by cp.async
//    FLOOR_AHEAD steps ahead, one commit group a step, so the step waits
//    on its own group alone (cp.async.wait_group).  A register ring of 4
//    steps refilled by __ldg took 2.6-2.8x as long a step at H 16, as if
//    every step waited for a load.  2 steps ahead was slower at long T, 8
//    no faster than 4.  h goes straight to its slab, a store that no step
//    waits on (storing only the last step would save 0-8% of a step).
//  * The plan (floor_plan) spreads the warps: one a block while there are
//    no more warps than SMs, else up to FLOOR_MAX_WARPS a block, one on
//    each of an SM's four schedulers.
//  * Numerics: FP32 FMA, no TF32, full-precision tanhf, no division.
// Columns past B run on column B-1's inputs: their h stays finite, and
// nothing of them is stored.
//
// Jacobi design.  A slab is a flat run of H * B floats, so the kernel
// walks items: one step s and V consecutive floats at vector offset o of
// the slab (V = 4, one float4 per slab and item, where H * B % 4 == 0,
// every pointer is 16-byte aligned and the items fill a wave; else V = 1,
// the same code as another template instance, whose threads each run a
// quarter of the math chain).  Consecutive threads take consecutive
// offsets, so a warp's access to a slab is one contiguous 512-byte
// (V = 4) or 128-byte run.  kernels/gate_sweep.py::jacobi_plan sizes the
// grid from the card: one whole wave of the blocks the SMs hold at once
// (the CUDA runtime's occupancy: 3 blocks of 128 at V = 4's 164
// registers, 8 at V = 1's 64, on an H100), or every item's block at once
// where there are fewer; each thread then takes every
// (grid * threads)-th item, at most `per_thread` of them.
//  * The candidate axis (the TPU kernel under the JAX package's vmap: S
//    independent sweeps, the rho search's or the scenario batch's): one
//    launch walks the rows (candidate, step) of all S, candidate-major, so
//    the plan covers S times the items; each item reads its candidate's
//    rho (reloaded when a thread's walk crosses into the next candidate).
//    A candidate's pre and input slabs start one caller-given stride
//    after the previous one's (slices of the state's (S, T+1, H, B)
//    slabs), and float4 holds while every stride is a multiple of 4.
//  * No division per item: a thread divides once, for its first (s, o)
//    and for the grid's stride in (s, o); after that it adds, and an
//    offset is the step's base plus a 32-bit offset.
//  * Loads in flight: the inputs are read through the read-only path
//    (ld.global.nc) and a thread issues its next item's 15 loads before
//    it computes and stores the current one, so 15 16-byte loads a
//    thread are always in flight (~90 KB an SM at 3 blocks of 128).
// On an H100 it runs a few percent behind a device copy of the same bytes
// and behind the same walk without the math (PERF.md); more loads in
// flight (a cp.async ring in shared memory), no prefetch, 256-thread
// blocks and evict-first loads or stores were each slower or no faster
// (admm_lstm_torch/jacobi_ab.py times them).
// No shared memory, no barrier.
//
// Numerics of the Gauss-Seidel, Jacobi and on-plan floor kernels: FP32
// FMA, no TF32, IEEE division, full-precision expf/tanhf (no fast math).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Threads per block of jacobi_sweep_kernel (kernels/gate_sweep.py::
// JACOBI_THREADS holds the same number).
constexpr int JACOBI_THREADS = 128;
constexpr int WH_BUFS = 2;     // ring of streamed wh chunks
constexpr int AHEAD = WH_BUFS - 1;   // chunks in flight ahead of the one in use

// Threads per block interior_sweep_kernel<R, .> is compiled for: a thread
// holds 14 prefetched inputs and 4 accumulators per row, so with R = 2 or
// 4 it may use 128 registers, with R = 1 64.  kernels/gate_sweep.py::
// _MAX_THREADS holds the same numbers.
constexpr int sweep_max_threads(int rows) { return rows == 1 ? 1024 : 512; }

// The Gauss-Seidel and floor kernels' arguments; the floor kernel reads no
// rho and no `in` and writes h to out[0].
struct SweepArgs {
  const float* xproj;        // (steps, 4, H, B)
  const float* wh;           // (4, H, H)
  const float* whp;          // (H, hp, 4): wh[g][k][j] at [k][j][g], 0 for j >= H
  const float* rho;          // (6,) i, f, g, o, c, h
  const float* in[12];       // gates i,f,g,o,c,h then duals i,f,g,o,c,h
  float* out[11];            // gates i,f,g,o,c,h then duals i,f,g,o,c
  int steps, H, B;
  int hp;                    // wh's padded row length, R * blockDim.y
  int resident;              // k-rows 0 .. resident-1 of wh stay in shared memory
  int chunk;                 // the rest streams in chunks of this many k-rows
  // Candidate strides in floats (gridDim.y candidates; all 0 without the
  // candidate axis): xproj, the 12 input slabs, the 11 outputs, wh, whp,
  // rho.
  size_t cand_x, cand_in, cand_out, cand_wh, cand_whp, cand_rho;
};

// Where this block's candidate starts in the slabs: xproj, the inputs and
// the outputs.
struct CandOffsets {
  size_t x, in, out;
};

struct JacobiArgs {
  const float* pre;          // (steps, 4, H, B)
  const float* c_prev;       // (steps, H, B) previous sweep's c_{s-1}
  const float* rho;          // (6,) i, f, g, o, c, h; (cands, 6)
  const float* in[12];       // gates i,f,g,o,c,h then duals i,f,g,o,c,h
  float* out[11];            // gates i,f,g,o,c,h then duals i,f,g,o,c
  int steps;
  int n;                     // vectors of V floats in a slab, H * B / V
  int cands;                 // candidates (1 without the candidate axis)
  // Candidate strides in vectors of V floats (0 without the axis): pre,
  // the 12 input slabs and c_prev, the outputs.
  size_t cand_pre, cand_in, cand_out;
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

// One interior timestep of one element: the four pre-activations, the old
// f, g, c, h and the six duals (`old`, in that order), and c_{s-1} -> the
// new i, f, g, o, c, h and the new duals i, f, g, o, c, in that order, in
// res.
__device__ __forceinline__ void timestep_math(const float pre[4],
                                              const float old[10], float cp,
                                              const Rho& r, float res[11]) {
  const float act_i = sigmoidf_(pre[0]);
  const float act_f = sigmoidf_(pre[1]);
  const float act_g = tanhf(pre[2]);
  const float act_o = sigmoidf_(pre[3]);

  const float f_o = old[0], g_o = old[1], c_o = old[2], h_o = old[3];
  const float li = old[4], lf = old[5], lg = old[6], lo = old[7],
              lc = old[8], lh = old[9];

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

// What `sweep` does per element and step: LOADS carry-free inputs (the 4
// xproj gates first), `math` from the pre-activations, those inputs and
// c_{s-1} to OUTS results, of which the first STORES go to out[0 ..
// STORES-1]; c_s and h_s are results C_AT and H_AT.
struct FullStep {        // the Gauss-Seidel sweep: timestep_math
  static constexpr int LOADS = 14, OUTS = 11, STORES = 11, C_AT = 4, H_AT = 5;
  __device__ static void math(const float pre[4], const float v[LOADS],
                              float cp, const Rho& r, float res[OUTS]) {
    timestep_math(pre, v + 4, cp, r, res);
  }
};

struct FloorStep {       // the bare recurrence: h, then c (not stored)
  static constexpr int LOADS = 4, OUTS = 2, STORES = 1, C_AT = 1, H_AT = 0;
  __device__ static void math(const float pre[4], const float*, float cp,
                              const Rho&, float res[OUTS]) {
    const float c = sigmoidf_(pre[1]) * cp + sigmoidf_(pre[0]) * tanhf(pre[2]);
    res[0] = sigmoidf_(pre[3]) * tanhf(c);
    res[1] = c;
  }
};

// ---- Gauss-Seidel sweep ----------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING));
}

// Copies k-rows k0 .. k0+rows-1 of the padded wh into dst.  Global and
// shared memory share the [k][hp][4] layout, so that is one contiguous
// range, 16 bytes per cp.async.
__device__ __forceinline__ void stream_wh(float* dst, const float* whp,
                                          int k0, int rows, int hp, int tid,
                                          int nthreads) {
  const float4* src =
      reinterpret_cast<const float4*>(whp + (size_t)k0 * 4 * hp);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int v = tid; v < rows * hp; v += nthreads) cp_async16(d + v, src + v);
}

// acc[g][q] += sum over kk < rows of w[kk][q][g] * h[kk * tb], kk ascending.
// w points at wh row k0, column j0 of the shared [k][hp][4] layout (the
// four gates of one (k, j) are one float4); h at h_{s-1}[k0][tx].
template <int R>
__device__ __forceinline__ void recurrent_product(const float* w,
                                                  const float* h, int rows,
                                                  int tb, int hp,
                                                  float acc[4][R]) {
#pragma unroll 4
  for (int kk = 0; kk < rows; ++kk) {
    const float hk = h[kk * tb];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(w + (kk * hp + q) * 4);
      acc[0][q] = fmaf(v.x, hk, acc[0][q]);
      acc[1][q] = fmaf(v.y, hk, acc[1][q]);
      acc[2][q] = fmaf(v.z, hk, acc[2][q]);
      acc[3][q] = fmaf(v.w, hk, acc[3][q]);
    }
  }
}

// The carry-free inputs of element (s, j, b) of the block's candidate
// (offsets `c`): xproj i, f, g, o, then (the full step) the old f, g, c, h
// and the six duals (timestep_math's `old`); zeros outside the slabs (!ok),
// so the math of a padded row or column stays finite.
template <class Step>
__device__ __forceinline__ void load_step(const SweepArgs& a,
                                          const CandOffsets& c, int s, int j,
                                          int b, bool ok,
                                          float v[Step::LOADS]) {
  const size_t slab = (size_t)a.H * a.B;
  const size_t e = (size_t)s * slab + (size_t)j * a.B + b;
  const float* const x =
      a.xproj + c.x + e + 3 * (size_t)s * slab;               // (s, 0, j, b)
#pragma unroll
  for (int g = 0; g < 4; ++g) v[g] = ok ? __ldg(x + g * slab) : 0.0f;
  if constexpr (Step::LOADS > 4) {
    const size_t ei = c.in + e;
    const float* src[10] = {a.in[1] + ei, a.in[2] + ei, a.in[4] + ei,
                            a.in[5] + ei, a.in[6] + ei, a.in[7] + ei,
                            a.in[8] + ei, a.in[9] + ei, a.in[10] + ei,
                            a.in[11] + ei};
#pragma unroll
    for (int k = 0; k < 10; ++k) v[4 + k] = ok ? __ldg(src[k]) : 0.0f;
  }
}

// Stores the results of rows j0 .. j0+R-1 of column b at step s to out[0 ..
// STORES-1] (the full step: new gates i..h, then duals i..c; the floor: h),
// masked by ok.
template <int R, class Step>
__device__ __forceinline__ void store_step(const SweepArgs& a,
                                           const CandOffsets& c, int s,
                                           int j0, int b, const bool ok[R],
                                           const float res[R][Step::STORES]) {
  const size_t slab = (size_t)a.H * a.B;
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (ok[q]) {
      const size_t e = c.out + (size_t)s * slab + (size_t)(j0 + q) * a.B + b;
#pragma unroll
      for (int k = 0; k < Step::STORES; ++k) a.out[k][e] = res[q][k];
    }
}

// The Gauss-Seidel loop over time of one block, with Step's loads, math
// and stores; smem is the block's dynamic shared memory.
template <int R, bool STREAM, class Step>
__device__ __forceinline__ void sweep(const SweepArgs& a, float* const smem) {
  // smem: [resident][4][hp] resident wh rows, then the ring, then h.
  const int H = a.H, B = a.B, hp = a.hp, tb = blockDim.x;
  const int kres = STREAM ? a.resident : H, kc = a.chunk;
  const int chunk_floats = kc * 4 * hp;
  float* const ring = smem + kres * 4 * hp;            // [WH_BUFS][kc][4][hp]
  float* const hbuf = ring + (STREAM ? WH_BUFS * chunk_floats : 0);  // [2][H][tb]

  const int tx = threadIdx.x, j0 = threadIdx.y * R;
  const int nthreads = tb * blockDim.y, tid = threadIdx.y * tb + tx;
  const int b = blockIdx.x * tb + tx;
  // The block's candidate, blockIdx.y, and where its operands start.
  const size_t cand = blockIdx.y;
  const CandOffsets co{cand * a.cand_x, cand * a.cand_in, cand * a.cand_out};
  const float* const wh = a.wh + cand * a.cand_wh;
  const float* const whp =
      a.whp == nullptr ? nullptr : a.whp + cand * a.cand_whp;

  // The streamed k-rows kres .. H-1 cycle through the ring in nck chunks
  // per step; the first two are put in flight first.
  const int nck = STREAM ? (H - kres + kc - 1) / kc : 0;
  const int total_chunks = a.steps * nck;
  if constexpr (STREAM) {
    for (int i = 0; i < AHEAD; ++i) {
      if (i < total_chunks) {
        const int k1 = kres + (i % nck) * kc;
        stream_wh(ring + i * chunk_floats, whp, k1, min(kc, H - k1), hp,
                  tid, nthreads);
      }
      cp_async_commit();
    }
  }
  // The resident rows, once: from the padded layout where there is one,
  // else gathered from wh (4, H, H), zero past H.
  if (whp != nullptr) {
    stream_wh(smem, whp, 0, kres, hp, tid, nthreads);
  } else {
    for (int e = tid; e < kres * 4 * hp; e += nthreads) {
      const int kj = e >> 2, k = kj / hp, j = kj - k * hp, g = e & 3;
      if (j < H)
        cp_async4(smem + e, wh + ((size_t)g * H + k) * H + j);
      else
        smem[e] = 0.0f;
    }
  }
  cp_async_commit();
  for (int e = tid; e < H * tb; e += nthreads) hbuf[e] = 0.0f;   // h_0 = 0

  Rho rho{};
  if constexpr (Step::LOADS > 4) rho = load_rho(a.rho + cand * a.cand_rho);
  float pf[R][Step::LOADS];   // this thread's prefetched inputs, row by row
  float cst[R];      // c_{s-1}, c_0 = 0
  bool ok[R];        // row j0 + q and column b lie in the slabs
#pragma unroll
  for (int q = 0; q < R; ++q) {
    cst[q] = 0.0f;
    ok[q] = j0 + q < H && b < B;
    load_step<Step>(a, co, 0, j0 + q, b, ok[q], pf[q]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // A step's results: stored during the next step where their STORES * R
  // registers fit (up to 22: the full step at R <= 2; at R = 4 they spill),
  // else at once.
  constexpr bool DEFER = Step::STORES * R <= 22;
  float pend[R][Step::STORES];
  int buf = 0;       // ring slot of the next chunk (STREAM)
  int n = 0;         // index of the next chunk in the stream (STREAM)
  for (int s = 0; s < a.steps; ++s) {
    const float* hp_s = hbuf + (s & 1) * H * tb;          // h_{s-1}
    float* hn = hbuf + ((s + 1) & 1) * H * tb;            // h_s

    float acc[4][R];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < R; ++q) acc[g][q] = 0.0f;
    if constexpr (STREAM) {
      for (int c = 0; c < nck; ++c, ++n) {
        if (c > 0) {          // for c = 0, at the end of the last step
          cp_async_wait<AHEAD - 1>();   // chunk n has landed
          __syncthreads();    // ... for every thread; chunk n-1 is done
        }
        if (n + AHEAD < total_chunks) {
          const int k2 = kres + ((c + AHEAD) % nck) * kc;
          stream_wh(ring + ((buf + AHEAD) % WH_BUFS) * chunk_floats, whp, k2,
                    min(kc, H - k2), hp, tid, nthreads);
        }
        cp_async_commit();
        const int k0 = kres + c * kc;
        recurrent_product<R>(ring + buf * chunk_floats + j0 * 4,
                             hp_s + k0 * tb + tx, min(kc, H - k0), tb, hp,
                             acc);
        buf = buf + 1 == WH_BUFS ? 0 : buf + 1;
      }
    }
    // Step s-1's results go out first (DEFER), so the slab stores overlap
    // the resident product instead of the math.  The resident rows last:
    // no barrier from here to the end of the step, so the warps drift apart
    // and one warp's math and memory traffic overlap another's product.
    if constexpr (DEFER) {
      if (s > 0) store_step<R, Step>(a, co, s - 1, j0, b, ok, pend);
    }
    recurrent_product<R>(smem + j0 * 4, hp_s + tx, kres, tb, hp, acc);

    // Every row runs the math (padded ones on zeros), with no branch, so
    // the R rows' chains can interleave; only the memory accesses are
    // masked.
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = j0 + q;
      const float pre[4] = {pf[q][0] + acc[0][q], pf[q][1] + acc[1][q],
                            pf[q][2] + acc[2][q], pf[q][3] + acc[3][q]};
      float res[Step::OUTS];
      Step::math(pre, pf[q], cst[q], rho, res);
      if constexpr (DEFER) {
#pragma unroll
        for (int k = 0; k < Step::STORES; ++k) pend[q][k] = res[k];
      } else if (ok[q]) {
        const size_t e = co.out + (size_t)s * H * B + (size_t)j * B + b;
#pragma unroll
        for (int k = 0; k < Step::STORES; ++k) a.out[k][e] = res[k];
      }
      if (j < H) hn[j * tb + tx] = res[Step::H_AT];
      cst[q] = res[Step::C_AT];
      if (s + 1 < a.steps) load_step<Step>(a, co, s + 1, j, b, ok[q], pf[q]);
    }
    if constexpr (STREAM) cp_async_wait<AHEAD - 1>();   // next step's chunk 0
    __syncthreads();
  }
  if constexpr (DEFER) store_step<R, Step>(a, co, a.steps - 1, j0, b, ok, pend);
}

template <int R, bool STREAM>
__global__ void __launch_bounds__(sweep_max_threads(R))
interior_sweep_kernel(const SweepArgs a) {
  extern __shared__ float4 smem4[];
  sweep<R, STREAM, FullStep>(a, reinterpret_cast<float*>(smem4));
}

template <int R, bool STREAM>
__global__ void __launch_bounds__(sweep_max_threads(R))
floor_sweep_kernel(const SweepArgs a) {
  extern __shared__ float4 smem4[];
  sweep<R, STREAM, FloorStep>(a, reinterpret_cast<float*>(smem4));
}

// ---- The floor at H <= 32: a warp-synchronous recurrence ------------------

// Warps per block of floor_warp_kernel, and steps of xproj in flight ahead
// of the one in use (the stage holds one slot more: the slot a step fills
// is not the one it reads); kernels/gate_sweep.py holds the same numbers.
constexpr int FLOOR_MAX_WARPS = 4;
constexpr int FLOOR_AHEAD = 4;
constexpr int FLOOR_SLOTS = FLOOR_AHEAD + 1;

struct FloorArgs {
  const float* xproj;        // (steps, 4, H, B)
  const float* wh;           // (4, H, H)
  float* h;                  // (steps, H, B)
  int steps, H, B;
};

// Copies 4 bytes from src to dst by cp.async, or, if !valid, writes 0 to
// dst and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async4_or_zero(void* dst, const void* src,
                                                  bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// sigmoid(x) = (1 + tanh(x / 2)) / 2: one tanhf, where 1 / (1 + expf(-x))
// is an expf and an IEEE division.
__device__ __forceinline__ float floor_sigmoid(float x) {
  return fmaf(0.5f, tanhf(0.5f * x), 0.5f);
}

// acc[g][k & 1] += w[g][k] * h_{s-1}[k] for k = 0 .. W-1, ascending, with
// h_{s-1}[k] from lane base + k, this column's lane k (w[g][k] = 0 for
// k >= H).  No branch inside: the W shuffles issue back to back.
template <int W>
__device__ __forceinline__ void floor_product(const float (&w)[4][W],
                                              float h, int base,
                                              float acc[4][2]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float hk = __shfl_sync(0xffffffffu, h, base + k);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      acc[g][k & 1] = fmaf(w[g][k], hk, acc[g][k & 1]);
  }
}

template <int W>
__global__ void __launch_bounds__(FLOOR_MAX_WARPS * 32)
floor_warp_kernel(const FloorArgs a) {
  extern __shared__ float stage_all[];   // [FLOOR_SLOTS][4][blockDim.x]
  // Lanes base .. base+H-1 own column b, lane base + j its row j; the
  // lanes past the warp's last whole column run as a column of their own
  // that stores nothing.
  const int H = a.H, B = a.B, cols = 32 / H, lane = threadIdx.x & 31;
  const int col = lane / H, j = lane - col * H, base = col * H;
  const int b = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * cols +
                col;
  const bool ok = col < cols && b < B;

  // Lane j's weights, zero past H, so a k past H adds nothing.
  float w[4][W];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int k = 0; k < W; ++k)
      w[g][k] = k < H ? __ldg(a.wh + (g * H + k) * H + j) : 0.0f;

  // The stage: step s's 4 xproj values of this lane wait in slot s %
  // FLOOR_SLOTS of shared memory, copied there by cp.async FLOOR_AHEAD
  // steps ahead, one commit group a step (zeros past the last step), each
  // lane reading back only its own.  No copy is masked by a branch: those
  // of a column past B read column B-1 (its h stays finite and is not
  // stored).
  const size_t slab = (size_t)H * B;
  const float* const x =
      a.xproj + (size_t)j * B + min(b, B - 1);          // (0, 0, j, b)
  float* const out = a.h + (size_t)j * B + b;               // (0, j, b)
  const int last = a.steps - 1, nthreads = blockDim.x;
  float* const stage = stage_all + threadIdx.x;
  for (int s2 = 0; s2 < FLOOR_AHEAD; ++s2) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      cp_async4_or_zero(stage + (s2 * 4 + g) * nthreads,
                        x + (4 * (size_t)min(s2, last) + g) * slab,
                        s2 <= last);
    cp_async_commit();
  }

  float c = 0.0f, h = 0.0f;
  int rd = 0, wr = FLOOR_AHEAD;    // the slots of steps s and s + FLOOR_AHEAD
  for (int s = 0; s < a.steps; ++s) {
    const int s2 = s + FLOOR_AHEAD;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      cp_async4_or_zero(stage + (wr * 4 + g) * nthreads,
                        x + (4 * (size_t)min(s2, last) + g) * slab,
                        s2 <= last);
    cp_async_commit();
    cp_async_wait<FLOOR_AHEAD>();    // step s's group has landed
    float acc[4][2];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      acc[g][0] = stage[(rd * 4 + g) * nthreads];
      acc[g][1] = 0.0f;
    }
    floor_product<W>(w, h, base, acc);
    const float pre_i = acc[0][0] + acc[0][1];
    const float pre_f = acc[1][0] + acc[1][1];
    const float pre_g = acc[2][0] + acc[2][1];
    const float pre_o = acc[3][0] + acc[3][1];
    c = floor_sigmoid(pre_f) * c + floor_sigmoid(pre_i) * tanhf(pre_g);
    h = floor_sigmoid(pre_o) * tanhf(c);
    if (ok) out[(size_t)s * slab] = h;
    rd = rd + 1 == FLOOR_SLOTS ? 0 : rd + 1;
    wr = wr + 1 == FLOOR_SLOTS ? 0 : wr + 1;
  }
}

// ---- Jacobi sweep ----------------------------------------------------------

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ float lane(float4 v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane(float v, int) { return v; }
__device__ __forceinline__ void set_lane(float4& v, int l, float x) {
  if (l == 0) v.x = x; else if (l == 1) v.y = x; else if (l == 2) v.z = x;
  else v.w = x;
}
__device__ __forceinline__ void set_lane(float& v, int, float x) { v = x; }

// The 15 inputs of item (s, o) of candidate c, sn = s * n: pre i, f, g,
// o, then the old f, g, c, h and the six duals (timestep_math's `old`),
// then c_prev; through the read-only path.
template <int V>
__device__ __forceinline__ void jacobi_load(const JacobiArgs& a, int c,
                                            size_t sn, int o,
                                            typename Vec<V>::T v[15]) {
  using T = typename Vec<V>::T;
  const size_t e = c * a.cand_in + sn + o, n = a.n;
  const T* pre = reinterpret_cast<const T*>(a.pre) + c * a.cand_pre
                 + 4 * sn + o;
  const float* const src[11] = {a.in[1], a.in[2], a.in[4], a.in[5],
                                a.in[6], a.in[7], a.in[8], a.in[9],
                                a.in[10], a.in[11], a.c_prev};
#pragma unroll
  for (int g = 0; g < 4; ++g) v[g] = __ldg(pre + g * n);
#pragma unroll
  for (int k = 0; k < 11; ++k)
    v[4 + k] = __ldg(reinterpret_cast<const T*>(src[k]) + e);
}

// Items walk the rows (c, s) of every candidate's slabs, candidate-major,
// and the vector offsets o within a row.
template <int V>
__global__ void __launch_bounds__(JACOBI_THREADS)
jacobi_sweep_kernel(const JacobiArgs a) {
  using T = typename Vec<V>::T;
  const int n = a.n, steps = a.steps;
  // This thread's first item and the grid's stride, both in (c, s, o):
  // the only divisions.
  const int first = blockIdx.x * JACOBI_THREADS + threadIdx.x;
  const int stride = gridDim.x * JACOBI_THREADS;
  const int row = first / n, drow = stride / n;
  int o = first - row * n;
  const int dof = stride - drow * n;
  int c = row / steps, s = row - c * steps;
  const int dc = drow / steps, ds = drow - dc * steps;
  if (c >= a.cands) return;
  int rho_c = c;
  Rho rho = load_rho(a.rho + 6 * c);

  T cur[15], nxt[15];
  jacobi_load<V>(a, c, (size_t)s * n, o, cur);
  while (true) {
    int c2 = c + dc, s2 = s + ds, o2 = o + dof;
    if (o2 >= n) {
      o2 -= n;
      ++s2;
    }
    if (s2 >= steps) {      // ds < steps, so one wrap at most
      s2 -= steps;
      ++c2;
    }
    const bool more = c2 < a.cands;
    if (more) jacobi_load<V>(a, c2, (size_t)s2 * n, o2, nxt);
    if (c != rho_c) {
      rho_c = c;
      rho = load_rho(a.rho + 6 * c);
    }

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
    const size_t e = c * a.cand_out + (size_t)s * n + o;
#pragma unroll
    for (int k = 0; k < 11; ++k) reinterpret_cast<T*>(a.out[k])[e] = res[k];

    if (!more) break;
    c = c2;
    s = s2;
    o = o2;
#pragma unroll
    for (int k = 0; k < 15; ++k) cur[k] = nxt[k];
  }
}

constexpr int MAX_DEVICES = 64;

// Raises the dynamic shared-memory limit of interior_sweep_kernel<R,
// STREAM> (floor_sweep_kernel<R, STREAM> if FLOOR) to the device's opt-in
// maximum once per device and remembers it, so a launch does not pay a
// cudaFuncSetAttribute (two threads racing here both set the same value),
// then launches it.
template <int R, bool STREAM, bool FLOOR>
cudaError_t launch_sweep(const SweepArgs& a, dim3 grid, dim3 block,
                         size_t smem, cudaStream_t st) {
  static bool ready[MAX_DEVICES];
  const auto kernel = FLOOR ? floor_sweep_kernel<R, STREAM>
                            : interior_sweep_kernel<R, STREAM>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(dev < MAX_DEVICES && ready[dev])) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) ready[dev] = true;
  }
  kernel<<<grid, block, smem, st>>>(a);
  return cudaGetLastError();
}

// Checks the tile plan of kernels/gate_sweep.py::sweep_plan that `a`
// (steps, H, B, hp, resident, chunk, whp), `tb`, `rows` and `smem` carry
// and launches it over `cands` candidates (a's strides): the floor kernel
// if FLOOR, else the Gauss-Seidel kernel.  Returns cudaErrorInvalidValue
// for a plan the kernels do not take, else cudaGetLastError() after the
// launch (0 = launched).
template <bool FLOOR>
cudaError_t launch_plan(const SweepArgs& a, int tb, int rows, int smem,
                        int cands, cudaStream_t st) {
  const int hidden = a.H, hp = a.hp, resident = a.resident, chunk = a.chunk;
  if (a.steps < 1 || hidden < 1 || a.B < 1) return cudaErrorInvalidValue;
  if (cands < 1 || cands > 65535) return cudaErrorInvalidValue;
  if (tb < 1 || tb > 32 || (32 % tb) != 0) return cudaErrorInvalidValue;
  if (rows != 1 && rows != 2 && rows != 4) return cudaErrorInvalidValue;
  const int groups = (hidden + rows - 1) / rows;
  if (tb * groups > sweep_max_threads(rows)) return cudaErrorInvalidValue;
  if (hp < groups * rows) return cudaErrorInvalidValue;
  const bool streamed = resident < hidden;
  if (resident < 0 || resident > hidden || (streamed && chunk < 1) ||
      (streamed && a.whp == nullptr) ||
      reinterpret_cast<uintptr_t>(a.whp) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t wh_floats =
      ((size_t)resident + (streamed ? WH_BUFS * (size_t)chunk : 0)) * 4 * hp;
  const size_t need = (wh_floats + 2 * (size_t)hidden * tb) * sizeof(float);
  if ((size_t)smem != need) return cudaErrorInvalidValue;

  const dim3 block(tb, groups);
  const dim3 grid((a.B + tb - 1) / tb, cands);
  switch (rows * 2 + streamed) {
    case 2: return launch_sweep<1, false, FLOOR>(a, grid, block, need, st);
    case 3: return launch_sweep<1, true, FLOOR>(a, grid, block, need, st);
    case 4: return launch_sweep<2, false, FLOOR>(a, grid, block, need, st);
    case 5: return launch_sweep<2, true, FLOOR>(a, grid, block, need, st);
    case 8: return launch_sweep<4, false, FLOOR>(a, grid, block, need, st);
    default: return launch_sweep<4, true, FLOOR>(a, grid, block, need, st);
  }
}

// SweepArgs of a launch, the per-kernel pointers left null.
SweepArgs sweep_args(const void* xproj, const void* wh, const void* whp,
                     int steps, int hidden, int batch, int hp, int resident,
                     int chunk) {
  SweepArgs a{};
  a.xproj = static_cast<const float*>(xproj);
  a.wh = static_cast<const float*>(wh);
  a.whp = static_cast<const float*>(whp);
  a.steps = steps;
  a.H = hidden;
  a.B = batch;
  a.hp = hp;
  a.resident = resident;
  a.chunk = chunk;
  return a;
}

}  // namespace

extern "C" {

// The current device's SM count and the shared memory a block may opt in
// to, for kernels/gate_sweep.py::sweep_plan.  Returns a CUDA error code.
int gate_sweep_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// Launches the Gauss-Seidel sweep on `stream` with the tile plan of
// kernels/gate_sweep.py::sweep_plan: `tb` batch columns per block and
// `rows` hidden rows per thread; wh rows padded to `hp` floats in shared
// memory, k-rows 0 .. resident-1 kept there and the rest streamed in
// chunks of `chunk` k-rows from `whp`, the (H, hp, 4) padded layout of
// the (4, H, H) weights `wh` (wh[g][k][j] at [k][j][g], zero for j >= H,
// 16-byte aligned; null if the plan gathers from wh); `smem` bytes of dynamic
// shared memory.  `ins` holds 12 device pointers (gates i,f,g,o,c,h, duals
// i,f,g,o,c,h), `outs` 11 (gates i..h, duals i..c).  Returns
// cudaErrorInvalidValue for a plan this kernel does not take, else
// cudaGetLastError() after the launch (0 = launched).
//
// With the candidate axis, `cands` candidates: wh (cands, 4, H, H), whp
// (cands, H, hp, 4), rho (cands, 6) and the outputs (cands, steps, H, B),
// each contiguous; candidate c's xproj starts at xproj + c * cand_x floats
// and its input slab k at ins[k] + c * cand_in, contiguous (steps, 4, H,
// B) and (steps, H, B) from there.  cands = 1 is the sweep without the
// axis (the strides unused).
int gate_sweep_interior(const void* xproj, const void* wh, const void* whp,
                        const void* rho, const void* const* ins,
                        void* const* outs, int steps, int hidden, int batch,
                        int tb, int rows, int hp, int resident, int chunk,
                        int smem, int cands, long long cand_x,
                        long long cand_in, void* stream) {
  if (cand_x < 0 || cand_in < 0) return cudaErrorInvalidValue;
  SweepArgs a = sweep_args(xproj, wh, whp, steps, hidden, batch, hp,
                           resident, chunk);
  a.rho = static_cast<const float*>(rho);
  for (int k = 0; k < 12; ++k) a.in[k] = static_cast<const float*>(ins[k]);
  for (int k = 0; k < 11; ++k) a.out[k] = static_cast<float*>(outs[k]);
  a.cand_x = (size_t)cand_x;
  a.cand_in = (size_t)cand_in;
  a.cand_out = (size_t)steps * hidden * batch;
  a.cand_wh = 4 * (size_t)hidden * hidden;
  a.cand_whp = (size_t)hidden * hp * 4;
  a.cand_rho = 6;
  return launch_plan<false>(a, tb, rows, smem, cands,
                            static_cast<cudaStream_t>(stream));
}

// Launches the floor kernel, the bare recurrence from xproj (steps, 4, H,
// B) and wh into h (steps, H, B), on `stream` with the same tile plan and
// arguments as gate_sweep_interior.  Returns cudaErrorInvalidValue for a
// plan it does not take, else cudaGetLastError() after the launch.
int gate_sweep_floor(const void* xproj, const void* wh, const void* whp,
                     void* h, int steps, int hidden, int batch, int tb,
                     int rows, int hp, int resident, int chunk, int smem,
                     void* stream) {
  SweepArgs a = sweep_args(xproj, wh, whp, steps, hidden, batch, hp,
                           resident, chunk);
  a.out[0] = static_cast<float*>(h);
  return launch_plan<true>(a, tb, rows, smem, 1,
                           static_cast<cudaStream_t>(stream));
}

// Launches floor_warp_kernel<lanes> on `stream` with the plan of
// kernels/gate_sweep.py::floor_plan at H <= 32: `lanes` the product's
// length (H rounded up to a power of two), `warps` warps a block of 32 / H
// columns each, `grid` blocks covering B, `smem` bytes of dynamic shared
// memory, the stage of xproj (16 * FLOOR_SLOTS * 32 * warps).  xproj
// (steps, 4, H, B), wh (4, H, H), h (steps, H, B).
// Returns cudaErrorInvalidValue for a plan this kernel does not take, else
// cudaGetLastError() after the launch (0 = launched).
int gate_sweep_floor_warp(const void* xproj, const void* wh, void* h,
                          int steps, int hidden, int batch, int lanes,
                          int warps, int grid, int smem, void* stream) {
  if (steps < 1 || hidden < 1 || hidden > 32 || batch < 1)
    return cudaErrorInvalidValue;
  int want = 1;
  while (want < hidden) want *= 2;
  if (lanes != want || warps < 1 || warps > FLOOR_MAX_WARPS || grid < 1)
    return cudaErrorInvalidValue;
  const long long per_block = (long long)warps * (32 / hidden);
  if (per_block * grid < batch || per_block * (grid - 1) >= batch)
    return cudaErrorInvalidValue;
  if (smem != 16 * FLOOR_SLOTS * 32 * warps) return cudaErrorInvalidValue;

  FloorArgs a;
  a.xproj = static_cast<const float*>(xproj);
  a.wh = static_cast<const float*>(wh);
  a.h = static_cast<float*>(h);
  a.steps = steps;
  a.H = hidden;
  a.B = batch;
  const dim3 block(32 * warps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: floor_warp_kernel<1><<<grid, block, smem, st>>>(a); break;
    case 2: floor_warp_kernel<2><<<grid, block, smem, st>>>(a); break;
    case 4: floor_warp_kernel<4><<<grid, block, smem, st>>>(a); break;
    case 8: floor_warp_kernel<8><<<grid, block, smem, st>>>(a); break;
    case 16: floor_warp_kernel<16><<<grid, block, smem, st>>>(a); break;
    default: floor_warp_kernel<32><<<grid, block, smem, st>>>(a); break;
  }
  return cudaGetLastError();
}

// Resident blocks per SM of jacobi_sweep_kernel<vec> at JACOBI_THREADS
// threads, for kernels/gate_sweep.py::jacobi_plan, and the kernel's
// registers and local (spill) bytes per thread.  Returns a CUDA error code.
int gate_sweep_jacobi_occupancy(int vec, int* blocks_per_sm, int* regs,
                                int* local_bytes) {
  if (vec != 1 && vec != 4) return cudaErrorInvalidValue;
  const void* fn = vec == 4 ? (const void*)jacobi_sweep_kernel<4>
                            : (const void*)jacobi_sweep_kernel<1>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       JACOBI_THREADS, 0);
}

// Launches the Jacobi sweep on `stream` with the plan of
// kernels/gate_sweep.py::jacobi_plan: `vec` floats per access (4: every
// slab and output pointer 16-byte aligned, H * B % 4 == 0 and every
// candidate stride a multiple of 4), `per_thread`, the most items a thread
// takes (ceil(cands * steps * H * B / vec / (grid * threads))), `threads`
// per block (JACOBI_THREADS) and `grid` blocks.
// `ins` and `outs` as above; pre is (steps, 4, H, B) and c_prev
// (steps, H, B) for each of `cands` candidates (1 without the candidate
// axis), whose pre starts `cand_pre` floats after the previous
// candidate's, its 12 input slabs and c_prev `cand_in` floats (both 0
// without the axis); the outputs are contiguous, (cands, steps, H, B), and
// rho is (cands, 6).  Returns
// cudaErrorInvalidValue for a plan this kernel does not take, else
// cudaGetLastError() after the launch (0 = launched).
int gate_sweep_jacobi(const void* pre, const void* c_prev, const void* rho,
                      const void* const* ins, void* const* outs, int steps,
                      int hidden, int batch, int vec, int per_thread,
                      int threads, int grid, int cands, long long cand_pre,
                      long long cand_in, void* stream) {
  if (steps < 1 || hidden < 1 || batch < 1 || cands < 1 ||
      (long long)steps * cands >= (1LL << 30))
    return cudaErrorInvalidValue;
  const long long slab = (long long)hidden * batch;
  if ((vec != 1 && vec != 4) || slab % vec != 0 || slab / vec >= (1LL << 30))
    return cudaErrorInvalidValue;
  if (cand_pre < 0 || cand_in < 0 || cand_pre % vec || cand_in % vec)
    return cudaErrorInvalidValue;
  const long long n = slab / vec, items = n * steps * cands;
  const long long lanes = (long long)grid * threads;
  if (threads != JACOBI_THREADS || grid < 1 || lanes >= (1LL << 30) ||
      (lanes - threads) >= items || per_thread != (items + lanes - 1) / lanes)
    return cudaErrorInvalidValue;
  if (vec == 4) {
    uintptr_t bits = reinterpret_cast<uintptr_t>(pre) |
                     reinterpret_cast<uintptr_t>(c_prev);
    for (int k = 0; k < 12; ++k) bits |= reinterpret_cast<uintptr_t>(ins[k]);
    for (int k = 0; k < 11; ++k) bits |= reinterpret_cast<uintptr_t>(outs[k]);
    if (bits % 16 != 0) return cudaErrorInvalidValue;
  }

  JacobiArgs a;
  a.pre = static_cast<const float*>(pre);
  a.c_prev = static_cast<const float*>(c_prev);
  a.rho = static_cast<const float*>(rho);
  for (int k = 0; k < 12; ++k) a.in[k] = static_cast<const float*>(ins[k]);
  for (int k = 0; k < 11; ++k) a.out[k] = static_cast<float*>(outs[k]);
  a.steps = steps;
  a.n = (int)n;
  a.cands = cands;
  a.cand_pre = (size_t)(cand_pre / vec);
  a.cand_in = (size_t)(cand_in / vec);
  a.cand_out = (size_t)(n * steps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    jacobi_sweep_kernel<4><<<grid, JACOBI_THREADS, 0, st>>>(a);
  else
    jacobi_sweep_kernel<1><<<grid, JACOBI_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
