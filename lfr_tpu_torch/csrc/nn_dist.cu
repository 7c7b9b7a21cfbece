// Nearest-neighbour squared distances by brute force, for the ETH3D
// evaluation (lfr_tpu_torch/eval/eth3d.py through ops/nn_dist.py).
//
//   out[i] = min_j (qx_i - cx_j)^2 + (qy_i - cy_j)^2 + (qz_i - cz_j)^2
//
// in f32, in the direct squared-difference form, as fma(dz, dz, fma(dy,
// dy, dx * dx)): the fused form XLA gives the JAX package's
// `jnp.sum((q - c) ** 2, axis=-1)` on the CPU, so each distance equals the
// reference's bit for bit.  The |q|^2 + |c|^2 - 2 q.c identity, and with it
// the tensor cores, is ruled out: its cancellation loses about
// sqrt(eps) * |coordinate| of absolute precision, fatal at the 1 cm
// tolerance.
//
// Replaces no TPU kernel: on the TPU this was XLA-fused jnp
// (lfr_tpu/eval/eth3d.py:234-249 `_all_min_impl` and :283-305
// `_count_within_impl`), where the (Q, C) distance tile never reached HBM.
// PyTorch does not fuse it: a chunked broadcast moves about 40 bytes a
// pair, and torch.cdist writes the whole (Q, C) matrix.
//
// What bounds it: FP32 instruction issue.  A pair needs 7 instructions
// (3 subtractions, a product, 2 fused multiply-adds, a minimum), plus a
// shared-memory load per corpus point shared by a thread's queries.  Bytes
// are negligible: each input is read once from device memory, and each
// corpus point is used by every query of a block from shared memory.
//
// Design.  The two directions of the evaluation have opposite shapes:
// accuracy is a few thousand reconstruction points against tens of
// millions of scan samples, completeness millions of visible samples
// against a few thousand points.  A grid over queries alone leaves most of
// the SMs idle in the first.  So the grid is (query tiles) x (corpus
// chunks): each block holds QPT queries per thread in registers, walks its
// chunk of the corpus through a shared-memory tile, and combines its
// partial minima into the output with atomicMin on the bit pattern of the
// non-negative f32 (the order of such minima cannot change the result, so
// the output is deterministic).  Rows past nq and nc are never read: the
// bounds checks stand in for the JAX package's padding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // corpus points per shared-memory tile (16 KB)

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float4 c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

template <int QPT>
__global__ void __launch_bounds__(kThreads)
nn_min_sq_kernel(const float* __restrict__ q, const float* __restrict__ c, long long nq,
                 long long nc, long long chunk, unsigned int* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const long long q0 = (long long)blockIdx.x * (kThreads * QPT) + threadIdx.x;
  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const long long i = q0 + (long long)j * kThreads;
    const bool ok = i < nq;
    qx[j] = ok ? q[3 * i] : 0.f;
    qy[j] = ok ? q[3 * i + 1] : 0.f;
    qz[j] = ok ? q[3 * i + 2] : 0.f;
    best[j] = INFINITY;
  }
  const long long c_begin = (long long)blockIdx.y * chunk;
  const long long c_end = min(nc, c_begin + chunk);
  for (long long t0 = c_begin; t0 < c_end; t0 += kTile) {
    const int n = (int)min((long long)kTile, c_end - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const float* p = c + 3 * (t0 + k);
      tile[k] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    if (n == kTile) {
#pragma unroll 8
      for (int k = 0; k < kTile; ++k) {
        const float4 p = tile[k];
#pragma unroll
        for (int j = 0; j < QPT; ++j) best[j] = fminf(best[j], sq_dist(qx[j], qy[j], qz[j], p));
      }
    } else {
      for (int k = 0; k < n; ++k) {
        const float4 p = tile[k];
#pragma unroll
        for (int j = 0; j < QPT; ++j) best[j] = fminf(best[j], sq_dist(qx[j], qy[j], qz[j], p));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const long long i = q0 + (long long)j * kThreads;
    if (i < nq) atomicMin(out + i, __float_as_uint(best[j]));
  }
}

}  // namespace

extern "C" {

// q: (nq, 3) f32, c: (nc, 3) f32, both contiguous on the device; out: (nq,)
// f32 bit patterns, filled with +inf by the caller.  qpt (1 or 4) queries a
// thread; chunk: corpus points per block, a multiple of the tile (the grid's
// second dimension is ceil(nc / chunk), at most 65535).  Returns the CUDA
// error of the launch (0 on success).
int lfr_nn_min_sq(const float* q, const float* c, long long nq, long long nc, unsigned int* out,
                  int qpt, long long chunk, cudaStream_t stream) {
  if (nq <= 0 || nc <= 0) return 0;
  if ((qpt != 1 && qpt != 4) || chunk <= 0 || chunk % kTile) return (int)cudaErrorInvalidValue;
  const long long qblocks = (nq + (long long)kThreads * qpt - 1) / ((long long)kThreads * qpt);
  const long long splits = (nc + chunk - 1) / chunk;
  if (qblocks > 0x7fffffffLL || splits > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)qblocks, (unsigned)splits);
  if (qpt == 4) {
    nn_min_sq_kernel<4><<<grid, kThreads, 0, stream>>>(q, c, nq, nc, chunk, out);
  } else {
    nn_min_sq_kernel<1><<<grid, kThreads, 0, stream>>>(q, c, nq, nc, chunk, out);
  }
  return (int)cudaGetLastError();
}

const char* lfr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
