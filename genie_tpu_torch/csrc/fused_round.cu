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
//   h1        = [x[r,i] | agg[r,i]     | mask[r,i]] @ W1 + b1
//   h2        = [x[r,i] | agg_src[r,i] | mask[r,i]] @ W2 + b2
//   out[r,i]  = PReLU([h1 | h2], a_out)
//
// z is x in round 1 of DataAggregation and the output of the preceding
// Dense in the other three rounds; agg_src (the source-axis mean) arrives
// precomputed, as in the TPU kernel.
//
// What bounds it on this card: bytes. At the sweep shape (16 windows x 500
// sources = 8000 rows, 374 stations, C = H = 30) one round-1 launch must
// read x and agg_src (~359 MB each) and mask (~48 MB) and write out
// (~718 MB): ~1.5 GB against ~23 GFLOP of f32 multiply-adds, i.e. about
// 15 FLOP/byte, below the f32 ridge (67 TFLOP/s / 3.35 TB/s = 20).
//
// What the design does about it: every intermediate (PReLU(z), the station
// mean, h1, h2) stays on chip, so device memory sees each input once and
// the output once. The Pallas kernel keeps the dense (n_sta, n_sta) A_sta
// resident (560 KB at 374 stations, more than the 227 KB a Hopper block may
// use); this kernel gathers over the k = 8 station-neighbour lists instead,
// which is also ~47x fewer multiply-adds than A_sta @ x. One block handles
// one row: it stages PReLU(z[r]) (374 x 30 f32 = 45 KB), both weight
// matrices and biases in dynamic shared memory, then one thread per station
// gathers its k neighbours and runs both small products in f32 registers.
// Row strides in shared memory are odd so that the per-thread rows fall in
// different banks. wgmma/TMA and fusing the preceding Dense are later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float prelu(float v, float a) {
  return fmaxf(v, 0.0f) + a * fminf(v, 0.0f);
}

template <int HMAX>
__global__ void __launch_bounds__(512)
fused_round_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ agg_src,
                   const float* __restrict__ mask, const int* __restrict__ nbr,
                   const float* __restrict__ wts, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2,
                   const float* __restrict__ slopes, float* __restrict__ out,
                   int n_sta, int cx, int cz, int m, int k, int h,
                   int zstride) {
  extern __shared__ float smem[];
  const int d = cx + cz + m;
  float* zsh = smem;                          // n_sta * zstride
  float* agg = zsh + (size_t)n_sta * zstride;  // n_sta * zstride
  float* W1 = agg + (size_t)n_sta * zstride;   // d * h
  float* W2 = W1 + d * h;                      // d * h
  float* B1 = W2 + d * h;                      // h
  float* B2 = B1 + h;                          // h

  const size_t r = blockIdx.x;
  const float a_sta = slopes[0];
  const float a_out = slopes[1];

  // stage PReLU(z[r]) (coalesced: row r is contiguous) and the weights
  const float* zr = z + r * n_sta * cz;
  for (int idx = threadIdx.x; idx < n_sta * cz; idx += blockDim.x) {
    const int i = idx / cz;
    const int c = idx - i * cz;
    zsh[i * zstride + c] = prelu(zr[idx], a_sta);
  }
  for (int idx = threadIdx.x; idx < d * h; idx += blockDim.x) {
    W1[idx] = w1[idx];
    W2[idx] = w2[idx];
  }
  for (int idx = threadIdx.x; idx < h; idx += blockDim.x) {
    B1[idx] = b1[idx];
    B2[idx] = b2[idx];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_sta; i += blockDim.x) {
    // station-axis weighted mean over the k neighbour list
    float* ag = agg + i * zstride;
    for (int c = 0; c < cz; ++c) ag[c] = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      const float wk = wts[i * k + kk];
      if (wk == 0.0f) continue;  // padded slot
      const float* zj = zsh + nbr[i * k + kk] * zstride;
      for (int c = 0; c < cz; ++c) ag[c] = fmaf(wk, zj[c], ag[c]);
    }

    float h1[HMAX], h2[HMAX];
#pragma unroll
    for (int j = 0; j < HMAX; ++j) {
      h1[j] = j < h ? B1[j] : 0.0f;
      h2[j] = j < h ? B2[j] : 0.0f;
    }
    const size_t ri = r * n_sta + i;
    const float* xr = x + ri * cx;
    for (int c = 0; c < cx; ++c) {
      const float v = xr[c];
      const float* w1r = W1 + c * h;
      const float* w2r = W2 + c * h;
#pragma unroll
      for (int j = 0; j < HMAX; ++j) {
        if (j < h) {
          h1[j] = fmaf(v, w1r[j], h1[j]);
          h2[j] = fmaf(v, w2r[j], h2[j]);
        }
      }
    }
    const float* sr = agg_src + ri * cz;
    for (int c = 0; c < cz; ++c) {
      const float va = ag[c];
      const float vs = sr[c];
      const float* w1r = W1 + (cx + c) * h;
      const float* w2r = W2 + (cx + c) * h;
#pragma unroll
      for (int j = 0; j < HMAX; ++j) {
        if (j < h) {
          h1[j] = fmaf(va, w1r[j], h1[j]);
          h2[j] = fmaf(vs, w2r[j], h2[j]);
        }
      }
    }
    const float* mr = mask + ri * m;
    for (int c = 0; c < m; ++c) {
      const float v = mr[c];
      const float* w1r = W1 + (cx + cz + c) * h;
      const float* w2r = W2 + (cx + cz + c) * h;
#pragma unroll
      for (int j = 0; j < HMAX; ++j) {
        if (j < h) {
          h1[j] = fmaf(v, w1r[j], h1[j]);
          h2[j] = fmaf(v, w2r[j], h2[j]);
        }
      }
    }
    float* o = out + ri * 2 * h;
#pragma unroll
    for (int j = 0; j < HMAX; ++j) {
      if (j < h) {
        o[j] = prelu(h1[j], a_out);
        o[h + j] = prelu(h2[j], a_out);
      }
    }
  }
}

template <int HMAX>
cudaError_t launch(const float* x, const float* z, const float* agg_src,
                   const float* mask, const int* nbr, const float* wts,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* slopes, float* out, int rows,
                   int n_sta, int cx, int cz, int m, int k, int h,
                   cudaStream_t stream) {
  const int zstride = cz | 1;
  const size_t smem = sizeof(float) *
      (2 * (size_t)n_sta * zstride + 2 * (size_t)(cx + cz + m) * h + 2 * h);
  cudaError_t err = cudaFuncSetAttribute(
      fused_round_kernel<HMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int threads = ((n_sta + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  fused_round_kernel<HMAX><<<rows, threads, smem, stream>>>(
      x, z, agg_src, mask, nbr, wts, w1, b1, w2, b2, slopes, out, n_sta, cx,
      cz, m, k, h, zstride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the launch needs, in bytes (the wrapper checks it against
// the card's per-block limit before launching).
long long fused_round_smem_bytes(int n_sta, int cx, int cz, int m, int h) {
  const int zstride = cz | 1;
  return (long long)sizeof(float) *
      (2LL * n_sta * zstride + 2LL * (cx + cz + m) * h + 2LL * h);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// Weights are row-major (cx + cz + m, h); slopes = {a_sta, a_out}.
int fused_round_launch(const float* x, const float* z, const float* agg_src,
                       const float* mask, const int* nbr, const float* wts,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, const float* slopes, float* out,
                       int rows, int n_sta, int cx, int cz, int m, int k,
                       int h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n_sta <= 0) return (int)cudaSuccess;
  if (h <= 16)
    return (int)launch<16>(x, z, agg_src, mask, nbr, wts, w1, b1, w2, b2,
                           slopes, out, rows, n_sta, cx, cz, m, k, h, s);
  if (h <= 32)
    return (int)launch<32>(x, z, agg_src, mask, nbr, wts, w1, b1, w2, b2,
                           slopes, out, rows, n_sta, cx, cz, m, k, h, s);
  return (int)cudaErrorInvalidValue;
}

const char* fused_round_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
