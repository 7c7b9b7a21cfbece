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
// 87.6 GFLOP take 0.089 ms at the bf16 tensor-core rate; sym at B = 2048
// moves 0.295 ms worth.  So the design keeps loads, products and stores of
// different tiles in flight together:
//
// * Persistent blocks, one per SM (grid = min(B, SMs)).  Block b walks the
//   pairs b, b + grid, ...; for each pair it computes the pair's views in
//   turn (sym: view 0 with fr as reference and ft as target, then view 1
//   with the roles swapped), each view in 5 tiles of 64 reference rows.
// * One producer warp issues TMA loads (3-D tensor maps over (B, 289, 128),
//   boxes of 64 channels, 128-byte swizzle, rows past 289 zero-filled by the
//   hardware) into a ring in shared memory, completing on mbarriers: the
//   target map of a view in 2 slots (the next view's map is in flight while
//   this one multiplies) and the 64-row reference tiles in 2 slots.
// * Two consumer warpgroups multiply each tile with wgmma m64n152k16
//   (bf16 -> f32, both operands K-major straight from the swizzled ring):
//   warpgroup 0 the output columns 0..151, warpgroup 1 the columns
//   152..303 (those past 288 multiply the zero rows).  The accumulators
//   stay in registers (76 f32 a thread).  ReLU, the row sum of squares
//   (quad shuffles, then the two warpgroups' partial sums exchanged through
//   shared memory), rsqrt and the bf16 conversion all happen in registers.
//   The target rows past 289 are zero, so their products are zero and the
//   sum of squares covers the 289 real columns.
// * The warpgroups write the bf16 tile into a staging buffer with stmatrix
//   (8x8 blocks; a row pitch of 624 B puts the 8 rows of a block on
//   distinct banks).  The tile's 64 output rows are one contiguous span of
//   the output (36,992 B; the last tile 33 rows, 19,074 B), which starts at
//   byte 167,042 p + 36,992 t, 2p mod 16.  The 256 threads write the span's
//   16-byte-aligned chunks with 16-byte stores, consecutive threads on
//   consecutive chunks, each chunk read from the staging buffer as two
//   aligned 16-byte loads and shifted by its offset there (a chunk that runs
//   into the next staged row is read element by element); the at most 7
//   elements before the first chunk and after the last go out as 2-byte
//   stores.  (A TMA store cannot take the output: its row stride, 578 B, is
//   no multiple of 16.  A 1-D bulk store of each span needs a byte-exact
//   staging copy, and the 2-byte writes into it conflicted on the banks and
//   cost more than the kernel's products.)
// * Per tile: wait for its products, stage it (which frees the
//   accumulators and the reference slot), start the next tile's products,
//   then write the staged tile out while they run.  (A second accumulator
//   set, to overlap the staging too, spilled: ptxas holds a wgmma kernel of
//   288 threads to 168 registers, setmaxnreg notwithstanding, and then
//   serialised the products.)
//
// Shared memory of a block (all at one block per SM):
//   target map  2 slots x 2 halves x 304 rows x 128 B   155,648
//   ref tiles   2 slots x 2 halves x  64 rows x 128 B    32,768
//   staging     64 rows x 624 B                          39,936
//   row sums    64 rows x 2 warpgroups x 4 B                512
//   barriers    8 x 8 B                                      64
//   alignment of the swizzled slots to 1024 B             1,024
//   total                                               229,952 of 232,448
// The target is loaded as two 152-row boxes per 64-channel half (rows
// 289..303 zero), 77,824 B per view; a reference tile as one 64-row box per
// half, 16,384 B.  The sym kernel reads each map twice (as reference tiles
// and as the other view's target), the second time from L2: device memory
// sees each input once per pair.
//
// Built by nvcc into a plain-C shared library and called through ctypes
// (lfr_tpu_torch/ops/cuda_build.py); each entry point encodes the tensor
// maps on the host (cuTensorMapEncodeTiled, taken from the driver through
// cudaGetDriverEntryPoint, so nothing more is linked), launches on the
// current device and the given stream, never synchronises, and returns a
// CUDA error code (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPos = 289;                            // 17 x 17 positions
constexpr int kCh = 128;                             // feature channels
constexpr int kRows = 64;                            // reference rows per tile (wgmma M)
constexpr int kTiles = (kPos + kRows - 1) / kRows;   // 5 tiles per view
constexpr int kTgtBox = 152;                         // target rows per TMA box
constexpr int kTgtRows = 2 * kTgtBox;                // 304: both warpgroups' columns
constexpr int kN = 152;                              // wgmma N of each warpgroup
constexpr int kNBlk = kN / 8;                        // its n8 blocks
constexpr int kAcc = kN / 2;                         // f32 accumulators a thread
constexpr int kConsumers = 256;                      // two warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;            // + one producer warp
constexpr int kRefSlots = 2;
constexpr int kHalfBytes = 64 * 2;                   // one swizzled row: 64 channels

constexpr uint32_t kTgtHalf = kTgtRows * kHalfBytes;  // 38,912
constexpr uint32_t kTgtSlot = 2 * kTgtHalf;           // 77,824
constexpr uint32_t kRefHalf = kRows * kHalfBytes;     // 8,192
constexpr uint32_t kRefSlot = 2 * kRefHalf;           // 16,384
constexpr int kStagePitch = 312;                     // staged row: 304 columns + 8 (no bank conflicts)
constexpr uint32_t kStage = kRows * kStagePitch * 2;  // 39,936
constexpr uint32_t kOffRef = 2 * kTgtSlot;
constexpr uint32_t kOffStage = kOffRef + kRefSlots * kRefSlot;
constexpr uint32_t kOffSums = kOffStage + kStage;
constexpr uint32_t kOffBars = kOffSums + kRows * 2 * 4;
constexpr uint32_t kSmemBytes = kOffBars + (4 + 2 * kRefSlots) * 8 + 1024;  // + 1024-B alignment

static_assert(kTgtHalf % 1024 == 0 && kRefHalf % 1024 == 0 && (kTgtBox * kHalfBytes) % 1024 == 0,
              "128-byte-swizzled boxes need 1024-byte-aligned destinations");
static_assert(2 * kN == kTgtRows && (kN * kHalfBytes) % 1024 == 0 && 2 * kN >= kPos,
              "warpgroup 1's operand starts on a swizzle atom; the two cover the 289 columns");
static_assert(kStagePitch % 8 == 0 && (kStagePitch / 2) % 32 == 28 && kStagePitch >= 2 * kN,
              "stmatrix rows: 16-byte aligned, 8 rows on 8 distinct bank quads, 304 columns");
static_assert(kStage % 16 == 0 && kOffStage % 16 == 0 && kOffSums % 16 == 0 && kOffBars % 8 == 0,
              "staging, sums and barrier alignment");
static_assert(kSmemBytes <= 232448, "the block's shared memory exceeds the SM's");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.  A wait
// of more than 4 s can only be a fault of the pipeline: it traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 4000000000ull) {
      __trap();
    }
  }
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ void stmatrix_x2(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(addr), "r"(r0),
               "r"(r1)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma matrix descriptor of a K-major operand in 128-byte-swizzled
// shared memory: 8-row atoms of 128 B, 1024 B apart (stride byte offset),
// the leading byte offset unused; a k16 step inside the atom adds 32 B.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// d (+)= A (64 x 16) * B (152 x 16)^T from shared memory, asynchronously.
__device__ __forceinline__ void wgmma_152(float (&d)[kAcc], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %78, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75"
      "}, %76, %77, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Barriers at `bars`: tgt_full[2], tgt_empty[2], ref_full[kRefSlots],
// ref_empty[kRefSlots].
__device__ __forceinline__ uint32_t tgt_full(uint32_t bars, int s) { return bars + 8u * s; }
__device__ __forceinline__ uint32_t tgt_empty(uint32_t bars, int s) { return bars + 16u + 8u * s; }
__device__ __forceinline__ uint32_t ref_full(uint32_t bars, int s) { return bars + 32u + 8u * s; }
__device__ __forceinline__ uint32_t ref_empty(uint32_t bars, int s) {
  return bars + 32u + 8u * kRefSlots + 8u * s;
}

// The bf16 pair of n8 block j's row r0 (h = 0) or r0 + 8 (h = 1), scaled.
__device__ __forceinline__ uint32_t scaled_pair(const float (&acc)[kAcc], int j, int h,
                                                const float (&inv)[2]) {
  return pack_bf16(acc[4 * j + 2 * h] * inv[h], acc[4 * j + 2 * h + 1] * inv[h]);
}

// A consumer thread: warpgroup wg holds output columns col0 .. col0 + 151
// (those past 288 multiply zero rows); warp wq of it rows 16 wq .. 16 wq + 15
// of the tile, as mma.sync's m16n8 fragments per n8 block: rows r0 =
// 16 wq + lane / 4 and r0 + 8, columns col0 + 8 j + 2 tq and + 1.  Its
// methods are inlined, so that the accumulator sets stay in registers.
template <bool kRelu, bool kNorm>
struct Consumer {
  uint32_t bars, s_tgt, s_ref, stage_s;
  const unsigned char* stage;
  float* sums;
  __nv_bfloat16* out_ab;
  __nv_bfloat16* out_ba;
  int views, lane, wg, col0, wq, tq, r0;

  // Starts tile n's products into acc.
  __device__ __forceinline__ void issue(int n, float (&acc)[kAcc]) const {
    const int i = n / kTiles;
    const int rs = n % kRefSlots;
    if (n % kTiles == 0) mbar_wait(tgt_full(bars, i & 1), (i >> 1) & 1);
    mbar_wait(ref_full(bars, rs), (n / kRefSlots) & 1);
    const uint32_t tgt = s_tgt + (i & 1) * kTgtSlot + col0 * kHalfBytes;
    const uint32_t ref = s_ref + rs * kRefSlot;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_152(acc, gmma_desc(ref + h * kRefHalf + 32 * k),
                  gmma_desc(tgt + h * kTgtHalf + 32 * k), h + k);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
  }

  // Stages tile n from acc, whose products have completed, as bf16 in the
  // staging buffer; acc is free again when it returns.
  __device__ __forceinline__ void stage_tile(int n, float (&acc)[kAcc]) const {
    fence_acc(acc);
    const int i = n / kTiles;
    const int t = n % kTiles;
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(ref_empty(bars, n % kRefSlots));
      if (t == kTiles - 1) mbar_arrive(tgt_empty(bars, i & 1));
    }
    if constexpr (kRelu) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] = fmaxf(acc[e], 0.0f);
    }
    // Rows r0 (h = 0) and r0 + 8 (h = 1).
    float inv[2] = {1.0f, 1.0f};
    if constexpr (kNorm) {
      float ss[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kNBlk; ++j) {
        ss[0] = fmaf(acc[4 * j], acc[4 * j], fmaf(acc[4 * j + 1], acc[4 * j + 1], ss[0]));
        ss[1] = fmaf(acc[4 * j + 2], acc[4 * j + 2], fmaf(acc[4 * j + 3], acc[4 * j + 3], ss[1]));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
        if (tq == 0) sums[(r0 + 8 * h) * 2 + wg] = ss[h];
      }
    }
    // The previous tile has been read out of the staging buffer.
    consumer_sync();
    if constexpr (kNorm) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 s2 = *reinterpret_cast<const float2*>(&sums[(r0 + 8 * h) * 2]);
        inv[h] = rsqrtf(fmaxf(s2.x + s2.y, 1e-24f));
      }
    }
    // The bf16 tile into the staging buffer, 8x8 blocks with stmatrix:
    // matrix i of lane group i = lane / 8 is rows 16 wq + 8 (i & 1) .. + 7
    // of n8 block j + (i >> 1).
    {
      const int i4 = lane / 8;
      const uint32_t row_addr = stage_s + (16 * wq + 8 * (i4 & 1) + lane % 8) * (kStagePitch * 2) +
                                (col0 / 8 + (i4 >> 1)) * 16;
#pragma unroll
      for (int j = 0; j + 1 < kNBlk; j += 2) {
        stmatrix_x4(row_addr + j * 16, scaled_pair(acc, j, 0, inv), scaled_pair(acc, j, 1, inv),
                    scaled_pair(acc, j + 1, 0, inv), scaled_pair(acc, j + 1, 1, inv));
      }
      stmatrix_x2(row_addr + (kNBlk - 1) * 16, scaled_pair(acc, kNBlk - 1, 0, inv),
                  scaled_pair(acc, kNBlk - 1, 1, inv));
    }
    consumer_sync();
  }

  // Writes tile n from the staging buffer to the output.
  __device__ __forceinline__ void store_tile(int n) const {
    const int i = n / kTiles;
    const int t = n % kTiles;
    const int pair = blockIdx.x + (i / views) * gridDim.x;
    __nv_bfloat16* const out = (i % views == 0 ? out_ab : out_ba) +
                               static_cast<size_t>(pair) * kPos * kPos;
    // The tile's rows are one contiguous span of the output: write its
    // 16-byte-aligned chunks with 16-byte stores, consecutive threads on
    // consecutive chunks, and the at most 7 elements before the first and
    // after the last one as 2-byte stores.
    const int tid = threadIdx.x;  // 0..255: the consumers
    const int row0 = t * kRows;
    const int n_el = min(kRows, kPos - row0) * kPos;
    __nv_bfloat16* const dst = out + static_cast<size_t>(row0) * kPos;
    const int head = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) / 2);
    const int n_chunks = (n_el - head) / 8;
    const int tail0 = head + 8 * n_chunks;
    const __nv_bfloat16* const st = reinterpret_cast<const __nv_bfloat16*>(stage);
    if (tid < head) {
      dst[tid] = st[tid];  // row 0
    } else if (tid >= 8 && tid < 16 && tid - 8 < n_el - tail0) {
      const int e = tail0 + tid - 8;
      dst[e] = st[(e / kPos) * kStagePitch + e % kPos];
    }
    for (int c = tid; c < n_chunks; c += kConsumers) {
      const int e0 = head + 8 * c;
      const int row = e0 / kPos;
      const int col = e0 - row * kPos;
      uint32_t o[4];
      if (col + 8 <= kPos) {
        // Staged bytes [sb, sb + 16) of one row: two aligned 16-byte
        // loads, then a shift by sb mod 16 (even).
        const uint32_t sb = row * (kStagePitch * 2) + 2 * col;
        const uint4 w0 = *reinterpret_cast<const uint4*>(stage + (sb & ~15u));
        const uint4 w1 = *reinterpret_cast<const uint4*>(stage + (sb & ~15u) + 16);
        const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const int q4 = (sb & 15u) / 4;
        const uint32_t shift = (sb & 2u) * 8;
        uint32_t v[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          v[k] = q4 == 0 ? w[k] : q4 == 1 ? w[k + 1] : q4 == 2 ? w[k + 2] : w[k + 3];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = __funnelshift_r(v[k], v[k + 1], shift);
      } else {
        // The chunk runs into the next row.
        uint16_t hw[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int ck = col + k;
          const int r = ck < kPos ? row : row + 1;
          const int cc = ck < kPos ? ck : ck - kPos;
          hw[k] = *reinterpret_cast<const uint16_t*>(st + r * kStagePitch + cc);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = hw[2 * k] | (static_cast<uint32_t>(hw[2 * k + 1]) << 16);
      }
      *reinterpret_cast<uint4*>(dst + e0) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
};

template <bool kRelu, bool kNorm>
__global__ void __launch_bounds__(kThreads, 1)
    corr_kernel(__grid_constant__ const CUtensorMap tgt_a, __grid_constant__ const CUtensorMap tgt_b,
                __grid_constant__ const CUtensorMap ref_a, __grid_constant__ const CUtensorMap ref_b,
                __nv_bfloat16* __restrict__ out_ab, __nv_bfloat16* __restrict__ out_ba,
                int views, int batch) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const uint32_t s_tgt = base;
  const uint32_t s_ref = base + kOffRef;
  const uint32_t bars = base + kOffBars;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(tgt_full(bars, s), 1);
      mbar_init(tgt_empty(bars, s), kConsumerWarps);
    }
    for (int s = 0; s < kRefSlots; ++s) {
      mbar_init(ref_full(bars, s), 1);
      mbar_init(ref_empty(bars, s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block's views in order: pair blockIdx.x + i * gridDim.x, view i % views.
  const int my_pairs = (batch - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  const int n_views = my_pairs * views;

  if (warp >= kConsumerWarps) {
    // Producer: target of view 0, then for each view its reference tiles,
    // with the next view's target issued right after the first tile.
    if (warp == kConsumerWarps && lane == 0) {
      auto load_target = [&](int i) {
        const int pair = blockIdx.x + (i / views) * gridDim.x;
        const CUtensorMap* map = (i % views == 0) ? &tgt_b : &tgt_a;
        const int s = i & 1;
        mbar_wait(tgt_empty(bars, s), ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(tgt_full(bars, s), kTgtSlot);
        for (int h = 0; h < 2; ++h) {
          for (int r = 0; r < 2; ++r) {
            tma_load(s_tgt + s * kTgtSlot + h * kTgtHalf + r * kTgtBox * kHalfBytes, map,
                     tgt_full(bars, s), h * 64, r * kTgtBox, pair);
          }
        }
      };
      if (n_views > 0) load_target(0);
      int n = 0;
      for (int i = 0; i < n_views; ++i) {
        const int pair = blockIdx.x + (i / views) * gridDim.x;
        const CUtensorMap* map = (i % views == 0) ? &ref_a : &ref_b;
        for (int t = 0; t < kTiles; ++t, ++n) {
          const int s = n % kRefSlots;
          mbar_wait(ref_empty(bars, s), ((n / kRefSlots) & 1) ^ 1);
          mbar_expect_tx(ref_full(bars, s), kRefSlot);
          for (int h = 0; h < 2; ++h) {
            tma_load(s_ref + s * kRefSlot + h * kRefHalf, map, ref_full(bars, s), h * 64,
                     t * kRows, pair);
          }
          if (t == 0 && i + 1 < n_views) load_target(i + 1);
        }
      }
    }
  } else {
    const int wg = warp / 4;
    const Consumer<kRelu, kNorm> c{bars, s_tgt, s_ref, base + kOffStage, smem + kOffStage,
                                   reinterpret_cast<float*>(smem + kOffSums), out_ab, out_ba,
                                   views, lane, wg, kN * wg, warp % 4, lane % 4,
                                   16 * (warp % 4) + lane / 4};
    // Tile n + 1 multiplies while tile n is written out.
    const int n_tiles = n_views * kTiles;
    float acc[kAcc];
    c.issue(0, acc);
    for (int n = 0; n + 1 < n_tiles; ++n) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      c.stage_tile(n, acc);
      c.issue(n + 1, acc);
      c.store_tile(n);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    c.stage_tile(n_tiles - 1, acc);
    c.store_tile(n_tiles - 1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D map over (batch, 289, 128) bf16 with boxes of (1, rows, 64).
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {kCh, kPos, static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {kCh * 2, static_cast<cuuint64_t>(kPos) * kCh * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <bool kRelu, bool kNorm>
int launch(const void* fa, const void* fb, void* out_ab, void* out_ba, int views, int batch,
           void* stream) {
  if (batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tgt_a, tgt_b, ref_a, ref_b;
  if (!encode_map(&tgt_a, fa, batch, kTgtBox) || !encode_map(&tgt_b, fb, batch, kTgtBox) ||
      !encode_map(&ref_a, fa, batch, kRows) || !encode_map(&ref_b, fb, batch, kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = batch < sms ? batch : sms;
  corr_kernel<kRelu, kNorm><<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tgt_a, tgt_b, ref_a, ref_b, static_cast<__nv_bfloat16*>(out_ab),
      static_cast<__nv_bfloat16*>(out_ba), views, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Opts every instantiation of corr_kernel in to its dynamic shared memory on
// the current device.  Call once per device before the first launch there.
int lfr_corr_init() {
  cudaError_t err = cudaFuncSetAttribute(corr_kernel<true, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(corr_kernel<true, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(corr_kernel<false, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  return static_cast<int>(err);
}

// c12 = rownorm(relu(fr @ ft^T)); fr, ft: (batch, 289, 128) bf16, 16-byte
// aligned; c12: (batch, 289, 289) bf16.  Launches on the current device.
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
