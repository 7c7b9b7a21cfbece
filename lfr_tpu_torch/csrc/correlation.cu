// Fused correlation volume of the flow CNN (PANet), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of lfr_tpu/ops/correlation.py:
//   _kernel_asym (:102)  c12 = rownorm(relu(fr @ ft^T))
//   _kernel_sym  (:93)   c12 as above, plus c21 = rownorm(relu(ft @ fr^T))
// with rownorm(c) = c * rsqrt(max(sum(c^2), 1e-24)) over the full 289-wide
// row, and the two variants that scripts/bench_corr_variants.py launches
// through make_pallas (:74-87) to split the asym kernel's cost:
//   kernel_nonorm      (:59)  relu(fr @ ft^T)
//   kernel_matmul_only (:64)  fr @ ft^T
// (its kernel_norm (:73) is _kernel_asym's body, launched here as
// lfr_corr_asym).  Inputs are per-position L2-normalised bf16 feature maps,
// (B, 289, 128) contiguous; outputs are bf16 (B, 289, 289), row index =
// reference position.  One template, corr_kernel<kRelu, kNorm>, serves all
// four: <true, true> for asym and sym, <true, false> for nonorm and
// <false, false> for matmul.
//
// What bounds it: the bytes.  At the main path's B = 4096 (asym) the kernel
// must read 606 MB and write 684 MB, 0.385 ms at 3.35 TB/s, while its
// 87.6 GFLOP take 0.089 ms at the bf16 tensor-core rate.  The design keeps
// the f32 volume out of device memory: one block per (pair, view, tile of 64
// rows) stages all 289 rows of the target map and its 64 reference rows in
// shared memory (cp.async), multiplies them on the tensor cores (WMMA, bf16
// in, f32 accumulate), keeps the ReLU'd f32 rows in shared memory until the
// row norm over all 289 columns is known, and writes each output element once
// as bf16.  Without the norm nothing waits for a whole row: each warp stores
// its 16x16 accumulator tile through a 1 KB shared-memory scratch of its own
// straight to bf16, so the 78 KB of staged rows are not allocated.  Blocks are numbered tile-fastest, so the five blocks that read one
// pair's target map (and, in the sym launch, both views) run together and
// read it from L2 rather than from device memory.
//
// Built by nvcc into a plain-C shared library and called through ctypes
// (lfr_tpu_torch/ops/cuda_build.py); each entry point launches on the current
// device and the given stream, never synchronises, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kPos = 289;                            // 17 x 17 positions
constexpr int kCh = 128;                             // feature channels
constexpr int kPosPad = 304;                         // 19 WMMA tiles of 16
constexpr int kLdIn = kCh + 8;                       // bf16 pitch in shared memory
constexpr int kRows = 64;                            // output rows per block
constexpr int kTiles = (kPos + kRows - 1) / kRows;   // 5 row tiles per pair
constexpr int kLdOut = kPosPad + 4;                  // f32 pitch of staged rows
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStrips = kRows / 16;                  // 16-row strips per block
constexpr int kChunks = kCh * 2 / 16;                // 16-byte chunks per row

constexpr size_t kSmemTgt = size_t(kPosPad) * kLdIn * 2;
constexpr size_t kSmemRef = size_t(kRows) * kLdIn * 2;
constexpr size_t kSmemOut = size_t(kRows) * kLdOut * 4;
constexpr size_t kSmemInv = size_t(kRows) * 4;
constexpr size_t kSmemTile = size_t(kWarps) * 16 * 16 * 4;  // per-warp tile scratch

// Dynamic shared memory of one block: with the row norm, the staged rows and
// their inverse norms; without it, one f32 tile per warp.
template <bool kNorm>
constexpr size_t smem_bytes() {
  return kSmemTgt + kSmemRef + (kNorm ? kSmemOut + kSmemInv : kSmemTile);
}

static_assert(kThreads == 4 * kRows, "the row-norm pass uses 4 threads per row");
static_assert(kWarps % kStrips == 0, "warps split evenly over the strips");
static_assert(kSmemTgt % 32 == 0 && kSmemRef % 32 == 0 && kSmemOut % 32 == 0,
              "WMMA pointers need 32-byte alignment");
static_assert(smem_bytes<true>() <= 232448, "the block's shared memory exceeds the SM's");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Copies `valid` rows of kCh bf16 (global pitch kCh) into shared memory
// (pitch kLdIn) and zeroes rows valid..rows-1.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int valid, int rows) {
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    __nv_bfloat16* d = dst + r * kLdIn + c * 8;
    if (r < valid) {
      cp_async16(d, src + static_cast<size_t>(i) * 8);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <bool kRelu, bool kNorm>
__global__ void __launch_bounds__(kThreads, 1)
    corr_kernel(const __nv_bfloat16* __restrict__ fa, const __nv_bfloat16* __restrict__ fb,
                __nv_bfloat16* __restrict__ out_ab, __nv_bfloat16* __restrict__ out_ba,
                int views) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_tgt = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_ref = reinterpret_cast<__nv_bfloat16*>(smem + kSmemTgt);
  // The staged rows with the norm; the warps' tile scratch without it.
  float* s_out = reinterpret_cast<float*>(smem + kSmemTgt + kSmemRef);
  float* s_inv = reinterpret_cast<float*>(smem + kSmemTgt + kSmemRef + kSmemOut);

  // Block -> (pair, view, row tile), row tile fastest.
  const long long blk = blockIdx.x;
  const int tile = static_cast<int>(blk % kTiles);
  const long long pv = blk / kTiles;
  const int view = static_cast<int>(pv % views);
  const long long pair = pv / views;
  const size_t in_off = static_cast<size_t>(pair) * kPos * kCh;
  // View 1 swaps the roles of the two maps: c21 = rownorm(relu(ft @ fr^T)).
  const __nv_bfloat16* ref = (view == 0 ? fa : fb) + in_off;
  const __nv_bfloat16* tgt = (view == 0 ? fb : fa) + in_off;
  __nv_bfloat16* out = (view == 0 ? out_ab : out_ba) + static_cast<size_t>(pair) * kPos * kPos;
  const int row0 = tile * kRows;
  const int rows = min(kRows, kPos - row0);

  stage_rows(s_tgt, tgt, kPos, kPosPad);
  stage_rows(s_ref, ref + static_cast<size_t>(row0) * kCh, rows, kRows);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // Each warp owns one 16-row strip and every (kWarps/kStrips)-th column tile.
  const int warp = threadIdx.x / 32;
  const int strip = warp % kStrips;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a_frag[kCh / 16];
#pragma unroll
  for (int k = 0; k < kCh / 16; ++k) {
    wmma::load_matrix_sync(a_frag[k], s_ref + strip * 16 * kLdIn + k * 16, kLdIn);
  }
  for (int n = warp / kStrips; n < kPosPad / 16; n += kWarps / kStrips) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k = 0; k < kCh / 16; ++k) {
      // B(k, n) = tgt[n][k]: the target rows, read column-major.
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b_frag;
      wmma::load_matrix_sync(b_frag, s_tgt + n * 16 * kLdIn + k * 16, kLdIn);
      wmma::mma_sync(acc, a_frag[k], b_frag, acc);
    }
    if constexpr (kRelu) {
#pragma unroll
      for (int i = 0; i < acc.num_elements; ++i) acc.x[i] = fmaxf(acc.x[i], 0.0f);
    }
    if constexpr (kNorm) {
      wmma::store_matrix_sync(s_out + strip * 16 * kLdOut + n * 16, acc, kLdOut,
                              wmma::mem_row_major);
    } else {
      // The tile goes through this warp's scratch to bf16 in device memory;
      // rows and columns past 289 are padding and are not written.
      float* scratch = s_out + warp * 256;
      wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = threadIdx.x % 32; e < 256; e += 32) {
        const int r = row0 + strip * 16 + e / 16;
        const int c = n * 16 + e % 16;
        if (r < kPos && c < kPos) out[r * kPos + c] = __float2bfloat16(scratch[e]);
      }
      __syncwarp();
    }
  }
  if constexpr (!kNorm) return;
  __syncthreads();

  // Row sum of squares over the 289 real columns, four threads per row.
  {
    const int r = threadIdx.x / 4;
    const int part = threadIdx.x % 4;
    float s = 0.0f;
    for (int c = part; c < kPos; c += 4) {
      const float v = s_out[r * kLdOut + c];
      s = fmaf(v, v, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) s_inv[r] = rsqrtf(fmaxf(s, 1e-24f));
  }
  __syncthreads();

  // The block's rows are one contiguous span of the output: write it linearly.
  __nv_bfloat16* dst = out + static_cast<size_t>(row0) * kPos;
  for (int i = threadIdx.x; i < rows * kPos; i += kThreads) {
    const int r = i / kPos;
    const int c = i - r * kPos;
    dst[i] = __float2bfloat16(s_out[r * kLdOut + c] * s_inv[r]);
  }
}

template <bool kRelu, bool kNorm>
int launch(const void* fa, const void* fb, void* out_ab, void* out_ba, int views, int batch,
           void* stream) {
  if (batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(batch) * views * kTiles;
  corr_kernel<kRelu, kNorm><<<static_cast<unsigned>(blocks), kThreads, smem_bytes<kNorm>(),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(fa), static_cast<const __nv_bfloat16*>(fb),
      static_cast<__nv_bfloat16*>(out_ab), static_cast<__nv_bfloat16*>(out_ba), views);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Opts every instantiation of corr_kernel in to its dynamic shared memory on
// the current device.  Call once per device before the first launch there.
int lfr_corr_init() {
  cudaError_t err = cudaFuncSetAttribute(corr_kernel<true, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<true>()));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(corr_kernel<true, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<false>()));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(corr_kernel<false, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<false>()));
  }
  return static_cast<int>(err);
}

// c12 = rownorm(relu(fr @ ft^T)); fr, ft: (batch, 289, 128) bf16; c12: (batch, 289, 289) bf16.
// Launches on the current device.
int lfr_corr_asym(const void* fr, const void* ft, void* c12, int batch, void* stream) {
  return launch<true, true>(fr, ft, c12, nullptr, 1, batch, stream);
}

// c12 as above and c21 = rownorm(relu(ft @ fr^T)), both in one launch.
int lfr_corr_sym(const void* fr, const void* ft, void* c12, void* c21, int batch,
                 void* stream) {
  return launch<true, true>(fr, ft, c12, c21, 2, batch, stream);
}

// out = relu(fr @ ft^T), shapes as lfr_corr_asym.
int lfr_corr_nonorm(const void* fr, const void* ft, void* out, int batch, void* stream) {
  return launch<true, false>(fr, ft, out, nullptr, 1, batch, stream);
}

// out = fr @ ft^T, shapes as lfr_corr_asym.
int lfr_corr_matmul(const void* fr, const void* ft, void* out, int batch, void* stream) {
  return launch<false, false>(fr, ft, out, nullptr, 1, batch, stream);
}

const char* lfr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
