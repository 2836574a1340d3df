// Fused dual-relation round of the GENIE product-graph trunk, for Hopper
// (sm_90a). Built by genie_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface and called through ctypes from
// genie_tpu_torch/ops/fused_round.py.
//
// Replaces the TPU kernel genie_tpu/ops/pallas_fused.py::fused_dual_round
// (body _round_kernel, pallas_call at :63). For every product row r (one
// source node of one window) and station i:
//
//   agg[r,i]  = sum_k w[i,k] * PReLU(z[r, nbr[i,k]], a_sta)      (station mean)
//   h1        = [x[r,i] | agg[r,i]     | e_sta[i] | mask[r,i]] @ W1 + b1
//   h2        = [x[r,i] | agg_src[r,i] | e_src[s] | mask[r,i]] @ W2 + b2
//   out[r,i]  = PReLU([h1 | h2], a_out)
//
// z is x in round 1 of DataAggregation and the output of the preceding
// Dense in the other three rounds; agg_src (the source-axis mean) arrives
// precomputed, as in the TPU kernel.
//
// Edge form (the updated model definition, genie_tpu/models/layers.py:
// 105-132, 296-321, which the JAX package computes in plain XLA): E = 4
// channels of mean relative-position embedding, a per-station table e_sta
// (n_sta, E) and a per-source table e_src (n_src, E) with s = r mod n_src,
// shared by every window. E is a template parameter; E = 0 (run6, no
// tables) compiles the code path without them. The tables are a few KB and
// stay in L1/L2, so the edge form adds E multiply-adds per output column
// and no per-cell bytes.
//
// What bounds it on this card: bytes, narrowly. At the sweep shape (16
// windows x 500 sources = 8000 rows, 374 stations, C = H = 30) one round-1
// launch must read x and agg_src (~359 MB each) and mask (~48 MB) and write
// out (~718 MB): ~1.5 GB against ~24 GFLOP of f32 multiply-adds, about 16
// FLOP/byte, just below the f32 FFMA ridge (67 TFLOP/s / 3.35 TB/s = 20).
// So the kernel has to stream at close to the memory rate and keep the FFMA
// pipes busy at the same time; neither side has slack to give away.
//
// Why CUDA cores in f32: the gate against the plain twin is 1e-4 absolute.
// Single-pass TF32 (10-bit mantissa, K = 64, weights ~0.2) errs by ~1e-3,
// and the products sit at the ridge, so tensor cores pay only once the
// kernel is close to its byte bound (split-TF32 mma is later work).
//
// Design (one persistent block of 256 threads per SM):
//  1. Persistent grid. gridDim.x = min(rows, resident blocks); each block
//     walks rows r = blockIdx.x, r += gridDim.x. W1, W2, b1, b2 are staged
//     into shared memory once per block, interleaved as one (K, 2*HP)
//     matrix (HP = H rounded up to 8/16/32, zero-padded) so that one
//     16-byte load feeds 4 multiply-adds and a warp's weight load is one
//     contiguous 128 B line. The (nbr, w) table is staged once per block
//     too, where it fits, two slots to a 16-byte load.
//  2. The station mean is taken after the product, not before it:
//     agg @ W1a = sum_k w[i,k] * Y[nbr[i,k]] with Y = PReLU(z[r]) @ W1a
//     (W1a the station-mean rows of W1). Each row first streams z through
//     the ring and computes Y (n_sta x HP, the only row-sized buffer; the
//     z row itself is never held whole), then every station's h1 gathers
//     its k rows of Y inside the product loop, each lane reading exactly
//     the 4 columns it owns. The gather is the same count of multiply-adds
//     as averaging z first, but it needs no station-mean pass between
//     barriers (a pass that, measured, cost a quarter of the kernel: it is
//     all shared-memory latency) and no mean tile. k is arbitrary and w = 0
//     slots add nothing.
//  3. Chunks of S = 192 stations (128 for H <= 8) -- the z slab, or the x,
//     agg_src and mask slabs, each one contiguous run in device memory --
//     are streamed into a double-buffered shared ring with cp.async:
//     16-byte .cg copies for the aligned body of each run, 4-byte copies
//     for its ragged ends, the run placed at the same offset within a
//     16-byte line as in device memory. The copy of the next chunk is in
//     flight while the current one is computed. A shape whose weights and
//     two buffers do not fit in shared memory is refused.
//  2b. Large networks: where Y (n_sta x HP floats) does not fit in shared
//     memory beside the weights and the ring (over about 900 stations at
//     H = 30), each block keeps its Y in its own slice of a scratch buffer
//     in device memory that the caller allocates (grid x n_sta x HP
//     floats: 17 MB at 1,000 stations on 132 blocks, which stays in L2).
//     Phase 0 writes the slice and phase 1 gathers from it with plain
//     (coherent) loads, the same barriers ordering them as in shared
//     memory. YG, a template parameter, picks the buffer; a shape whose Y
//     fits keeps the shared-memory layout and code path unchanged.
//  4. Register-blocked f32 products. Each thread owns TS = S*HP/(4*NT)
//     stations (6 at H = 30, 3 at H = 15) x (4 columns of h1 + the same 4
//     of h2); all lanes of a station group read the same station (a
//     broadcast; a warp's stations fall in distinct banks), inputs as
//     float4/float2 as the row width allows, weights as float4: per input
//     channel two 16-byte weight loads feed 8*TS fmaf.
//  5. Staged, coalesced output: once a chunk's inputs are consumed its
//     ring buffer takes the (S, 2H) output tile, which is stored as one
//     contiguous run (float4 where aligned).
//
// What holds it back now (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the
// CUDA cores, not the bytes -- shared-memory loads and barriers between
// the phases keep FFMA issue near half of its peak inside the product
// loops, and streaming alone runs well under the kernel's time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr long long MAX_SMEM = 232448;  // per-block limit on sm_90

__host__ __device__ __forceinline__ int pad4(long long v) {
  return (int)((v + 3) & ~3LL);
}

__host__ __device__ __forceinline__ int hpad(int h) {
  return h <= 8 ? 8 : (h <= 16 ? 16 : 32);
}

// Stations per chunk, a multiple of the NT / (hp / 4) station groups; each
// thread owns TS = S / (NT / (hp / 4)) of them. 192 splits 374 stations
// into two chunks with 2.7 % padding.
__host__ __device__ constexpr int chunk_of(int hp) {
  return hp == 8 ? 128 : 192;
}

// Widest vector (4, 2 or 1 floats) in which every row of width w starting
// at `base` is aligned.
int vec_of(const void* base, int w) {
  const uintptr_t f = reinterpret_cast<uintptr_t>(base) >> 2;
  if (w % 4 == 0 && f % 4 == 0) return 4;
  if (w % 2 == 0 && f % 2 == 0) return 2;
  return 1;
}

// Shared-memory layout of one launch, in floats from the start.
struct Plan {
  int tab;              // neighbour table staged in shared memory or not
  int ygl;              // Y in the device-memory scratch (1) or shared (0)
  int vx, va, vm, vz;   // vector widths of the x/agg_src/mask/z rows
  int b, t, y, ring, sa, sm, buf, total;
};

Plan make_plan(int n_sta, int cx, int cz, int e, int m, int k, int h) {
  Plan p = {};
  const int hp = hpad(h);
  const int S = chunk_of(hp);
  p.b = (cx + cz + e + m) * 2 * hp;  // weights first, at offset 0
  p.t = p.b + 2 * hp;
  // ring buffer: [x run | agg_src run | mask run], or the z run, each run
  // up to 3 floats into its 16-byte line; once a chunk's products are done
  // its buffer holds the (S, 2h) output tile
  p.sa = pad4((long long)S * cx + 4);
  p.sm = p.sa + pad4((long long)S * cz + 4);
  p.buf = p.sm + pad4((long long)S * m + 4);
  if (p.buf < pad4((long long)S * cz + 4)) p.buf = pad4((long long)S * cz + 4);
  if (p.buf < pad4((long long)S * 2 * h)) p.buf = pad4((long long)S * 2 * h);
  // Y in shared memory where it fits, else in device memory; then the
  // neighbour table where it fits, else read from device memory. In order:
  // (Y, table) shared, Y shared only, table shared only, neither.
  for (p.ygl = 0; p.ygl <= 1; ++p.ygl) {
    for (p.tab = 1; p.tab >= 0; --p.tab) {
      p.y = p.t + (p.tab ? pad4(2LL * n_sta * ((k + 1) & ~1)) : 0);
      p.ring = p.y + (p.ygl ? 0 : n_sta * hp);
      p.total = p.ring + 2 * p.buf;
      if ((long long)p.total * 4 <= MAX_SMEM) return p;
    }
  }
  p.ygl = 1;
  p.tab = 0;
  p.y = p.ring = p.t;
  p.total = p.ring + 2 * p.buf;
  return p;  // over the limit; the wrapper refuses it
}

__device__ __forceinline__ float prelu(float v, float a) {
  return fmaxf(v, 0.0f) + a * fminf(v, 0.0f);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four consecutive floats from shared memory, in loads of V floats.
template <int V>
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  if (V == 4) {
    const float4 t = ld4(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    const float2 b = *reinterpret_cast<const float2*>(p + 2);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = p[0]; v[1] = p[1]; v[2] = p[2]; v[3] = p[3];
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Float offset of p within its 16-byte line.
__device__ __forceinline__ int line_offset(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Copy the run src[0, n) to dst + line_offset(src) (dst 16-byte aligned),
// all threads of the block together.
__device__ __forceinline__ void copy_run(float* dst, const float* src, int n) {
  const int sh = line_offset(src);
  float* d = dst + sh;
  const int head = min((4 - sh) & 3, n);
  if ((int)threadIdx.x < head) copy4(d + threadIdx.x, src + threadIdx.x);
  const int nq = (n - head) >> 2;
  for (int e = threadIdx.x; e < nq; e += NT)
    copy16(d + head + 4 * e, src + head + 4 * e);
  for (int e = head + 4 * nq + threadIdx.x; e < n; e += NT)
    copy4(d + e, src + e);
}

// One input segment of the products over `len` channels. H1: acc1 += in
// @ w[:, 0:HP); H2: acc2 += in @ w[:, HP:2HP). V is the vector width the
// input rows allow; w points at the segment's first weight row, offset to
// the thread's columns.
template <int HP, int TS, int V, bool H1, bool H2>
__device__ __forceinline__ void segment(float (&acc1)[TS][4],
                                        float (&acc2)[TS][4],
                                        const float* (&in)[TS],
                                        const float* w, int len) {
  int c = 0;
  for (; c + 4 <= len; c += 4) {
    float a[TS][4];
#pragma unroll
    for (int i = 0; i < TS; ++i) load4<V>(in[i] + c, a[i]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 wa, wb;
      if (H1) wa = ld4(w + (c + q) * 2 * HP);
      if (H2) wb = ld4(w + (c + q) * 2 * HP + HP);
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        if (H1) fma4(acc1[i], a[i][q], wa);
        if (H2) fma4(acc2[i], a[i][q], wb);
      }
    }
  }
  for (; c < len; ++c) {
    float4 wa, wb;
    if (H1) wa = ld4(w + c * 2 * HP);
    if (H2) wb = ld4(w + c * 2 * HP + HP);
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      if (H1) fma4(acc1[i], in[i][c], wa);
      if (H2) fma4(acc2[i], in[i][c], wb);
    }
  }
}

// segment<> with the vector width picked at run time
template <int HP, int TS, bool H1, bool H2>
__device__ __forceinline__ void segment_v(int v, float (&acc1)[TS][4],
                                          float (&acc2)[TS][4],
                                          const float* (&in)[TS],
                                          const float* w, int len) {
  if (v == 4)
    segment<HP, TS, 4, H1, H2>(acc1, acc2, in, w, len);
  else if (v == 2)
    segment<HP, TS, 2, H1, H2>(acc1, acc2, in, w, len);
  else
    segment<HP, TS, 1, H1, H2>(acc1, acc2, in, w, len);
}

template <int HP, int E, bool YG>
__global__ void __launch_bounds__(NT, 1)
fused_round_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ agg_src,
                   const float* __restrict__ mask, const int* __restrict__ nbr,
                   const float* __restrict__ wts,
                   const float* __restrict__ e_sta,
                   const float* __restrict__ e_src,
                   const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2,
                   const float* __restrict__ slopes, float* __restrict__ out,
                   float* y_scratch, int rows, int n_sta, int n_src, int cx,
                   int cz, int m, int k, int h, Plan p) {
  constexpr int S = chunk_of(HP);
  constexpr int NG = HP / 4;    // column groups (4 of h1 + the same 4 of h2)
  constexpr int NSG = NT / NG;  // station groups
  constexpr int TS = S / NSG;   // stations per thread
  static_assert(TS * NSG == S, "a chunk must tile the block");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Wsh = smem;            // (d, 2*HP): W1 in [0, HP), W2 in [HP, 2HP)
  float* Bsh = smem + p.b;      // (2*HP)
  int2* tab = p.tab ? reinterpret_cast<int2*>(smem + p.t) : nullptr;
  // (n_sta, HP): PReLU(z[r]) @ W1a, in shared memory or in this block's
  // slice of the scratch (written and read by this block only)
  float* Ysh = YG ? y_scratch + (long long)blockIdx.x * n_sta * HP : smem + p.y;
  float* ring = smem + p.ring;  // 2 x buf

  const int tid = threadIdx.x;
  const float a_sta = __ldg(slopes);
  const float a_out = __ldg(slopes + 1);
  const int d = cx + cz + E + m;

  // Zero everything once, so that pad columns and the idle lanes of a
  // partial chunk compute on finite values.
  for (int e = tid; e < p.total / 4; e += NT)
    smem4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int e = tid; e < d * 2 * HP; e += NT) {
    const int row = e / (2 * HP);
    const int col = e % (2 * HP);
    const int j = col % HP;
    if (j < h) Wsh[e] = __ldg((col < HP ? w1 : w2) + row * h + j);
  }
  for (int j = tid; j < h; j += NT) {
    Bsh[j] = __ldg(b1 + j);
    Bsh[HP + j] = __ldg(b2 + j);
  }
  if (tab) {  // (Y row offset, w), k rounded up to even; a padded slot
              // (w = 0) points at row 0
    const int kp = (k + 1) & ~1;
    for (int e = tid; e < n_sta * kp; e += NT) {
      const int i = e / kp;
      const int kk = e - i * kp;
      const float wk = kk < k ? __ldg(wts + i * k + kk) : 0.0f;
      tab[e] = make_int2(wk != 0.0f ? __ldg(nbr + i * k + kk) * HP : 0,
                         __float_as_int(wk));
    }
  }

  // Work items: per row, nch chunks of z (phase 0: Y) and then nch chunks
  // of x/agg_src/mask (phase 1: the products).
  const int nch = (n_sta + S - 1) / S;
  auto load_item = [&](long long r, int ph, int j, float* buf) {
    const long long g0 = r * n_sta + (long long)j * S;
    const int ns = min(S, n_sta - j * S);
    if (ph == 0) {
      copy_run(buf, z + g0 * cz, ns * cz);
    } else {
      copy_run(buf, x + g0 * cx, ns * cx);
      copy_run(buf + p.sa, agg_src + g0 * cz, ns * cz);
      copy_run(buf + p.sm, mask + g0 * m, ns * m);
    }
  };

  const int g = tid % NG;
  const int sg = tid / NG;
  long long r = blockIdx.x;
  int ph = 0, j = 0, buf = 0;
  load_item(r, ph, j, ring);
  commit();

  for (;;) {
    long long rn = r;
    int phn = ph, jn = j + 1;
    if (jn == nch) {
      jn = 0;
      phn = ph ^ 1;
      if (phn == 0) rn = r + gridDim.x;
    }
    const bool has_next = rn < rows;
    float* cur = ring + buf * p.buf;
    float* nxt = ring + (buf ^ 1) * p.buf;
    const int s0 = j * S;
    const int ns = min(S, n_sta - s0);
    const long long g0 = r * n_sta + s0;

    wait_all();
    __syncthreads();
    if (has_next) {
      // into the buffer the last item used
      load_item(rn, phn, jn, nxt);
      commit();
    }

    if (ph == 0) {
      // Y[s0 + s] = PReLU(z[r, s0 + s]) @ W1a
      float* zb = cur + line_offset(z + g0 * cz);
      for (int e = tid; e < ns * cz; e += NT) zb[e] = prelu(zb[e], a_sta);
      __syncthreads();
      float acc[TS][4];
#pragma unroll
      for (int i = 0; i < TS; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
      const float* in[TS];
#pragma unroll
      for (int i = 0; i < TS; ++i) in[i] = zb + (sg + NSG * i) * cz;
      segment_v<HP, TS, true, false>(p.vz, acc, acc, in,
                                     Wsh + cx * 2 * HP + 4 * g, cz);
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const int s = sg + NSG * i;
        if (s < ns)
          *reinterpret_cast<float4*>(Ysh + (s0 + s) * HP + 4 * g) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    } else {
      float acc1[TS][4], acc2[TS][4];
#pragma unroll
      for (int i = 0; i < TS; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc1[i][q] = Bsh[4 * g + q];
          acc2[i][q] = Bsh[HP + 4 * g + q];
        }
      }
      const float* wg = Wsh + 4 * g;
      const float* xb = cur + line_offset(x + g0 * cx);
      const float* ab = cur + p.sa + line_offset(agg_src + g0 * cz);
      const float* mb = cur + p.sm + line_offset(mask + g0 * m);
      const float* in[TS];
#pragma unroll
      for (int i = 0; i < TS; ++i) in[i] = xb + (sg + NSG * i) * cx;
      segment_v<HP, TS, true, true>(p.vx, acc1, acc2, in, wg, cx);
#pragma unroll
      for (int i = 0; i < TS; ++i) in[i] = ab + (sg + NSG * i) * cz;
      segment_v<HP, TS, false, true>(p.va, acc1, acc2, in,
                                     wg + cx * 2 * HP, cz);
#pragma unroll
      for (int i = 0; i < TS; ++i) in[i] = mb + (sg + NSG * i) * m;
      segment_v<HP, TS, true, true>(p.vm, acc1, acc2, in,
                                    wg + (cx + cz + E) * 2 * HP, m);
      // h1 += sum_k w * Y[nbr]: each lane gathers its own 4 columns
      int st[TS];
#pragma unroll
      for (int i = 0; i < TS; ++i) st[i] = min(s0 + sg + NSG * i, n_sta - 1);
      if constexpr (E > 0) {
        // h1 += e_sta[station] @ W1e; h2 += e_src[source] @ W2e (one source
        // per row, so its E values are the same for every station)
        const float* we = wg + (cx + cz) * 2 * HP;
        const float* es = e_src + (int)(r % n_src) * E;
#pragma unroll
        for (int c = 0; c < E; ++c) {
          const float4 wa = ld4(we + c * 2 * HP);
          const float4 wb = ld4(we + c * 2 * HP + HP);
          const float ec = __ldg(es + c);
#pragma unroll
          for (int i = 0; i < TS; ++i) {
            fma4(acc1[i], __ldg(e_sta + st[i] * E + c), wa);
            fma4(acc2[i], ec, wb);
          }
        }
      }
      const float* yg = Ysh + 4 * g;
      if (tab) {  // two slots per 16-byte table load
        const int kp = (k + 1) & ~1;
        for (int kk = 0; kk < kp; kk += 2) {
#pragma unroll
          for (int i = 0; i < TS; ++i) {
            const int4 t = *reinterpret_cast<const int4*>(tab + st[i] * kp + kk);
            fma4(acc1[i], __int_as_float(t.y), ld4(yg + t.x));
            fma4(acc1[i], __int_as_float(t.w), ld4(yg + t.z));
          }
        }
      } else {
        for (int kk = 0; kk < k; ++kk) {
#pragma unroll
          for (int i = 0; i < TS; ++i) {
            const float wk = __ldg(wts + st[i] * k + kk);
            const int off = wk != 0.0f ? __ldg(nbr + st[i] * k + kk) * HP : 0;
            fma4(acc1[i], wk, ld4(yg + off));
          }
        }
      }
      __syncthreads();  // the chunk's inputs are consumed: its buffer
      float* stg = cur;  // now holds the (S, 2h) output tile
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const int s = sg + NSG * i;
        if (s >= ns) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 4 * g + q;
          if (c < h) {
            stg[s * 2 * h + c] = prelu(acc1[i][q], a_out);
            stg[s * 2 * h + h + c] = prelu(acc2[i][q], a_out);
          }
        }
      }
      __syncthreads();
      // the chunk's output rows are one contiguous run of `out`
      float* o = out + g0 * 2 * h;
      const int n = ns * 2 * h;
      if (line_offset(o) == 0) {
        float4* o4 = reinterpret_cast<float4*>(o);
        const float4* s4 = reinterpret_cast<const float4*>(stg);
        for (int e = tid; e < n / 4; e += NT) o4[e] = s4[e];
        for (int e = (n & ~3) + tid; e < n; e += NT) o[e] = stg[e];
      } else {
        for (int e = tid; e < n; e += NT) o[e] = stg[e];
      }
    }

    if (!has_next) break;
    r = rn;
    ph = phn;
    j = jn;
    buf ^= 1;
  }
}

// Blocks of fused_round_kernel<HP, E, YG> that the current device holds at
// once with `smem` bytes of shared memory each. The SM count and the
// occupancy are fixed per (device, smem), so they are queried once and kept;
// the shared-memory attribute is raised only when a launch needs more than
// any before it on that device.
template <int HP, int E, bool YG>
cudaError_t resident_blocks(size_t smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> known;
  static std::map<int, size_t> attr;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find({dev, smem});
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  auto kern = fused_round_kernel<HP, E, YG>;
  size_t& raised = attr[dev];
  if (smem > raised) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    raised = smem;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = known[{dev, smem}] = per_sm * sms;
  return cudaSuccess;
}

// The arguments of one launch.
struct Args {
  const float *x, *z, *agg_src, *mask;
  const int* nbr;
  const float *wts, *e_sta, *e_src, *w1, *b1, *w2, *b2, *slopes;
  float *out, *y_scratch;
  long long scratch_bytes;
  int rows, n_sta, n_src, cx, cz, e, m, k, h;
  cudaStream_t stream;
};

// Launch fused_round_kernel<HP, E, YG> on plan p; with `need` set, only
// report the scratch bytes the launch would need (0 with Y in shared memory).
template <int HP, int E, bool YG>
cudaError_t launch(const Args& a, const Plan& p, long long* need) {
  const size_t smem = (size_t)p.total * sizeof(float);
  int resident = 0;
  const cudaError_t err = resident_blocks<HP, E, YG>(smem, &resident);
  if (err != cudaSuccess) return err;
  const int grid = a.rows < resident ? a.rows : resident;
  const long long bytes =
      YG ? (long long)grid * a.n_sta * HP * (long long)sizeof(float) : 0;
  if (need) {
    *need = bytes;
    return cudaSuccess;
  }
  if (YG && (a.y_scratch == nullptr || a.scratch_bytes < bytes))
    return cudaErrorInvalidValue;
  fused_round_kernel<HP, E, YG><<<grid, NT, smem, a.stream>>>(
      a.x, a.z, a.agg_src, a.mask, a.nbr, a.wts, a.e_sta, a.e_src, a.w1, a.b1,
      a.w2, a.b2, a.slopes, a.out, a.y_scratch, a.rows, a.n_sta, a.n_src, a.cx,
      a.cz, a.m, a.k, a.h, p);
  return cudaGetLastError();
}

// launch<HP, E, YG> for the run-time H, edge width (0, or 4 for the edge
// form) and plan
cudaError_t dispatch(const Args& a, long long* need) {
  Plan p = make_plan(a.n_sta, a.cx, a.cz, a.e, a.m, a.k, a.h);
  if ((long long)p.total * 4 > MAX_SMEM) return cudaErrorInvalidConfiguration;
  p.vx = vec_of(a.x, a.cx);
  p.va = vec_of(a.agg_src, a.cz);
  p.vm = vec_of(a.mask, a.m);
  p.vz = vec_of(a.z, a.cz);
#define FR_LAUNCH(HP)                                                 \
  if (a.e == 0)                                                       \
    return p.ygl ? launch<HP, 0, true>(a, p, need)                    \
                 : launch<HP, 0, false>(a, p, need);                  \
  if (a.e == 4)                                                       \
    return p.ygl ? launch<HP, 4, true>(a, p, need)                    \
                 : launch<HP, 4, false>(a, p, need);                  \
  return cudaErrorInvalidValue;
  if (a.h <= 8) { FR_LAUNCH(8) }
  if (a.h <= 16) { FR_LAUNCH(16) }
  if (a.h <= 32) { FR_LAUNCH(32) }
#undef FR_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Least shared memory a launch needs, in bytes (the wrapper checks it
// against the card's per-block limit before launching): the weights and the
// ring, with Y and the neighbour table in device memory.
long long fused_round_smem_bytes(int n_sta, int cx, int cz, int e, int m,
                                 int h) {
  const Plan p = make_plan(n_sta, cx, cz, e, m, 0, h);
  return (p.t + 2LL * p.buf) * (long long)sizeof(float);
}

// The plan of a launch: bit 0 set if the neighbour table is staged in shared
// memory, bit 1 set if Y lives in the device-memory scratch.
int fused_round_plan(int n_sta, int cx, int cz, int e, int m, int k, int h) {
  const Plan p = make_plan(n_sta, cx, cz, e, m, k, h);
  return p.tab | (p.ygl << 1);
}

// Bytes of Y scratch a launch on the current device needs (0 when Y fits in
// shared memory), or -(CUDA error) if the device cannot be queried.
long long fused_round_scratch_bytes(int rows, int n_sta, int cx, int cz, int e,
                                    int m, int k, int h) {
  if (rows <= 0 || n_sta <= 0) return 0;
  Args a = {};
  a.rows = rows; a.n_sta = n_sta; a.cx = cx; a.cz = cz; a.e = e; a.m = m;
  a.k = k; a.h = h;
  long long need = 0;
  const cudaError_t err = dispatch(a, &need);
  return err == cudaSuccess ? need : -(long long)err;
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// Weights are row-major (cx + cz + e + m, h); slopes = {a_sta, a_out}.
// e = 0 (e_sta, e_src unused, may be null) or 4: e_sta (n_sta, e), e_src
// (n_src, e), row r reading source r mod n_src. y_scratch holds
// scratch_bytes (at least fused_round_scratch_bytes; may be null when that
// is 0).
int fused_round_launch(const float* x, const float* z, const float* agg_src,
                       const float* mask, const int* nbr, const float* wts,
                       const float* e_sta, const float* e_src,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, const float* slopes, float* out,
                       float* y_scratch, int rows, int n_sta, int n_src, int cx,
                       int cz, int e, int m, int k, int h,
                       long long scratch_bytes, void* stream) {
  if (rows <= 0 || n_sta <= 0) return (int)cudaSuccess;
  if (e != 0 && n_src <= 0) return (int)cudaErrorInvalidValue;
  const Args a = {x, z, agg_src, mask, nbr, wts, e_sta, e_src, w1, b1, w2, b2,
                  slopes, out, y_scratch, scratch_bytes, rows, n_sta, n_src,
                  cx, cz, e, m, k, h, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, nullptr);
}

const char* fused_round_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
