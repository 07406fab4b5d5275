// Fused int8 mask branch for Hopper (sm_90a).
//
// Replaces the TPU kernel mask_yolo_tpu/ops/pallas_mask.py::fused_mask_branch
// (body _mask_kernel). Its plain PyTorch version is
// mask_yolo_tpu_torch/ops/mask_fused.py::fused_mask_branch_reference; the
// wrapper is ops/mask_fused.py::fused_mask_branch.
//
//   fmap    [B, H, W, Cf]  bf16        boxes [B*K, 4] f32   classes [B*K] int32
//   w1      [co, 9*Cf]     int8        w2..w4 [co, 9*co] int8: K-contiguous rows,
//                                      k in (di, dj, ci) order, 128-byte swizzled
//   wd      [4*co, co]     int8        deconv as a 1x1 conv, rows (di, dj, o), swizzled
//   wout    [co, nc]       bf16        the class conv (block 0 of the TPU kernel's wo)
//   wsc     [5, ld], bias [6, ld] f32  per-channel dequantize factors (weight scale
//                                      x input scale) and biases
//   asc     [7, lda]       f32         per-channel activation scales: rows 0-5 the
//                                      inverse input scale of the four convs, the
//                                      deconv and the class conv, row 6 the class
//                                      conv's input scale itself (a per-tensor
//                                      graph repeats one value along each row)
//   out     [B*K, 2P, 2P]  f32         each ROI's class mask (bf16 values)
//
// The swizzle (ops/mask_fused.py::swizzle_nk): within each 128-byte block of
// a weight row n, the 16-byte chunk c is stored at chunk c ^ (n & 7). A
// shared-memory tile row of 128 bytes holds its chunks in the same order, so
// a B tile is a straight 16-byte copy, and the tiles have the layout that
// wgmma's 128-byte-swizzle descriptors read (8-row atoms of 1,024 bytes).
//
// The TPU kernel kept 2.7 MB of weights and a block of ROIs resident in
// ~5 MB of VMEM and ran one image per grid step. A Hopper block has 227 KB,
// and a block per ROI would re-read the weights for every ROI. So each layer
// here is an implicit-GEMM int8 kernel over all M = B*K*P*P crop pixels:
// every weight tile is reused across the ROIs of a 128-row block. What
// bounds it is the int8 MAC count, 0.52 G per ROI at 224² (four 3x3
// 256->256 convs over 14x14 and the 256->1024 deconv); the intermediates
// (M x 256 int8, 64 MB at B = 128) go through wrapper-allocated scratch once
// per layer.
//
// Six launches on the caller's stream, one C entry point:
//   1. crop_quant: bilinear crop of each ROI (both contractions rounded to
//      bf16 exactly like the plain version's two bf16 matmuls, since each
//      has two non-zero taps) and int8 by asc row 0 -> x0 [M, Cf];
//   2-5. conv3x3: implicit GEMM over each ROI's zero-padded P x P tile;
//   6. deconv + class conv: the 1x1 GEMM to 4*co with its epilogue fused
//      with the int8 requantize by asc row 5, the bf16 class conv of the ROI's
//      own class only (bf16(y_q)*bf16(asc row 6) times bf16 wout, f32 sums), the
//      sigmoid, the bf16 rounding and the depth-to-space store.
//
// The GEMM (launches 2-6): a block is BM = 128 rows x BN = 256 columns (all
// of co, so each A tile is read once), two warpgroups of 64 rows x 256
// columns, whose products are wgmma.mma_async m64n256k32 s8 x s8 -> s32
// with both operands read from shared memory through descriptors (128
// accumulator registers a thread). A k-step is BK = 128 bytes, one 3x3 tap
// x 128 channels. A 4-stage ring of (A, B) tiles in shared memory (48 KB a
// stage) is filled by cp.async.cg 16-byte copies: A rows gathered from each
// row's shifted pixel (its (roi, y, x) computed once per block), zero-filled
// at the ROI tile's edge; B rows straight from the packed weights. The
// copies run two k-steps ahead of the products, and one k-step's products
// stay in flight while the next is issued (wgmma.wait_group 1). Each
// thread fences its copies into the async proxy before the barrier that
// hands a stage to the tensor cores. The conv epilogue stages the int8
// tile in shared memory and stores 16-byte rows. What bounds it at the
// moment is less the tensor cores than the L2: every block reads 48 KB a
// k-step (A and B) for 4.2 M MACs.
// Every f32 multiply-add of the int8 epilogues uses _rn intrinsics (no FMA
// contraction) and __float2int_rn (half to even), as the plain version. The
// scale rows stay in global memory behind __ldg: the ring takes all the
// shared memory, and every block reads the same few KB.
// Needs Cf % 128 == 0 and co == 256 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;                  // two warpgroups, 64 rows each
constexpr int BM = 128, BN = 256, BK = 128;   // BK in bytes: one tap x 128 channels
constexpr int STAGES = 4;
constexpr int A_TILE = BM * BK;               // 16 KB
constexpr int STAGE_BYTES = A_TILE + BN * BK; // 48 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + room to align to 1024
constexpr int C_STRIDE = BN + 16;             // epilogue staging row, bytes

// 16 bytes global -> shared; zero-filled when !valid (src must still be a
// valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int8_t requant(float y, float inv) {
  const int q = __float2int_rn(__fmul_rn(y, inv));
  return static_cast<int8_t>(q < -127 ? -127 : (q > 127 ? 127 : q));
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- 1. crop + quantize ------------------------------------------------------

struct Taps {
  int i0, i1;
  float w0, w1;
  bool valid;
};

// Sample i of P along an axis of in_size pixels for the span [lo, hi], as
// ops/roi_align.interp_matrix computes it in f32 (see crop_rois.cu).
__device__ __forceinline__ Taps sample(float lo, float hi, int in_size, int i, int P) {
  const float n = static_cast<float>(in_size - 1);
  float c;
  if (P > 1) {
    const float step = __fdiv_rn(static_cast<float>(i), static_cast<float>(P - 1));
    c = __fadd_rn(__fmul_rn(lo, n), __fmul_rn(step, __fmul_rn(__fsub_rn(hi, lo), n)));
  } else {
    c = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(lo, hi)), n);
  }
  Taps t;
  t.valid = (c >= 0.f) && (c <= n);
  if (!t.valid) {
    t.i0 = t.i1 = 0;
    t.w0 = t.w1 = 0.f;
    return t;
  }
  const float g0 = floorf(c);
  t.i0 = static_cast<int>(g0);
  t.i1 = t.i0 + 1;
  t.w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(c, g0))));
  t.w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(c, __fadd_rn(g0, 1.f)))));
  if (t.i1 > in_size - 1) {
    t.i1 = t.i0;
    t.w1 = 0.f;
  }
  // the plain version's interpolation matrices are bf16
  t.w0 = bf16r(t.w0);
  t.w1 = bf16r(t.w1);
  return t;
}

// One block per (ROI, output row py); threadIdx.x walks 8-channel vectors,
// threadIdx.y walks px.
__global__ void crop_quant_kernel(const __nv_bfloat16* __restrict__ fmap,
                                  const float* __restrict__ boxes, int8_t* __restrict__ x0,
                                  int H, int W, int C, int K, int P,
                                  const float* __restrict__ inv0) {
  const int py = blockIdx.x % P;
  const int roi = blockIdx.x / P;
  const int b = roi / K;
  const float bx1 = boxes[4 * roi + 0], by1 = boxes[4 * roi + 1];
  const float bx2 = boxes[4 * roi + 2], by2 = boxes[4 * roi + 3];
  const Taps ty = sample(by1, by2, H, py, P);
  const __nv_bfloat16* img = fmap + static_cast<size_t>(b) * H * W * C;
  for (int px = threadIdx.y; px < P; px += blockDim.y) {
    const Taps tx = sample(bx1, bx2, W, px, P);
    const bool valid = ty.valid && tx.valid;
    int8_t* dst = x0 + ((static_cast<size_t>(roi) * P + py) * P + px) * C;
    for (int c0 = threadIdx.x * 8; c0 < C; c0 += blockDim.x * 8) {
      int2 packed = make_int2(0, 0);
      int8_t* q = reinterpret_cast<int8_t*>(&packed);
      if (valid) {
        const float4 ia = __ldg(reinterpret_cast<const float4*>(inv0 + c0));
        const float4 ib = __ldg(reinterpret_cast<const float4*>(inv0 + c0 + 4));
        const float inv[8] = {ia.x, ia.y, ia.z, ia.w, ib.x, ib.y, ib.z, ib.w};
        const int4 v00 = *reinterpret_cast<const int4*>(img + (static_cast<size_t>(ty.i0) * W + tx.i0) * C + c0);
        const int4 v10 = *reinterpret_cast<const int4*>(img + (static_cast<size_t>(ty.i1) * W + tx.i0) * C + c0);
        const int4 v01 = *reinterpret_cast<const int4*>(img + (static_cast<size_t>(ty.i0) * W + tx.i1) * C + c0);
        const int4 v11 = *reinterpret_cast<const int4*>(img + (static_cast<size_t>(ty.i1) * W + tx.i1) * C + c0);
        const __nv_bfloat16* f00 = reinterpret_cast<const __nv_bfloat16*>(&v00);
        const __nv_bfloat16* f10 = reinterpret_cast<const __nv_bfloat16*>(&v10);
        const __nv_bfloat16* f01 = reinterpret_cast<const __nv_bfloat16*>(&v01);
        const __nv_bfloat16* f11 = reinterpret_cast<const __nv_bfloat16*>(&v11);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // y contraction (rounded to bf16) at columns x0 and x1, then x
          const float t0 = bf16r(__fadd_rn(__fmul_rn(ty.w0, __bfloat162float(f00[j])),
                                           __fmul_rn(ty.w1, __bfloat162float(f10[j]))));
          const float t1 = bf16r(__fadd_rn(__fmul_rn(ty.w0, __bfloat162float(f01[j])),
                                           __fmul_rn(ty.w1, __bfloat162float(f11[j]))));
          const float v = bf16r(__fadd_rn(__fmul_rn(tx.w0, t0), __fmul_rn(tx.w1, t1)));
          q[j] = requant(v, inv[j]);
        }
      }  // off the map the crop is 0, which is int8 0 at any scale
      *reinterpret_cast<int2*>(dst + c0) = packed;
    }
  }
}

// ---- 2-6. implicit-GEMM int8 layers --------------------------------------

struct GemmArgs {
  const int8_t* a;      // [M, Cin] int8 activations (ROI tiles of P x P rows)
  const int8_t* w;      // [N, KS*KS*Cin] int8, swizzled
  const float* wsc;     // [N] dequantize factors
  const float* bias;    // [N]
  const float* inv_out; // [N] inverse scales of the output's int8
  const float* asc_out; // [N] class-select mode: the scales themselves
  int M, N, Cin, P;
  int8_t* out;          // requantize mode: [M, N] int8
  // class-select mode (the deconv):
  const int* classes;           // [M / P^2]
  const __nv_bfloat16* wout;    // [N / 4, nc]
  const float* bias_out;        // [nc]
  int nc;
  float* masks;                 // [M / P^2, 2P, 2P]
};

// Shared-memory descriptor of a K-major operand tile whose rows are 128
// bytes, stored in 8-row groups of 1024 bytes with the 128-byte swizzle
// (16-byte chunk c of row r at chunk c ^ (r & 7)); `addr` must sit on a
// 1024-byte boundary, plus the k offset inside the row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// D[64 x 256] (+)= A[64 x 32] * B[256 x 32]^T, s8 x s8 -> s32, both operands
// K-major in shared memory (128-byte swizzle), given by their descriptors.
// Thread (warp w, lane) of the warpgroup holds
// d[4 j + 2 h + e] = D[16 w + lane / 4 + 8 h][8 j + 2 (lane % 4) + e].
__device__ __forceinline__ void wgmma_s8_64x256x32(int (&d)[128], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]),
        "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// KS = 3: a 3x3 SAME conv over each ROI's tile; KS = 1: a 1x1 conv.
// SELECT: the deconv epilogue (blockIdx.y is the (di, dj) block of 256
// columns).
template <int KS, bool SELECT>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(128) int8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  int8_t* smem = smem_raw + (sbase - raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int PP = g.P * g.P;
  const int kdim = KS * KS * g.Cin;
  const int nk = kdim / BK;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wi = warp % 4;  // warpgroup: rows 64 wg .. 64 wg + 63
  const int gq = lane >> 2, t4 = lane & 3;

  // Copies: thread tid moves 16-byte chunk tid & 7 of rows (tid >> 3) + 32 j
  // (4 rows of A, 8 of B); all its rows share row & 7, hence the swizzle.
  const int chunk = tid & 7, row0 = tid >> 3;
  const int sw = (chunk ^ (row0 & 7)) << 4;
  int a_base[4], a_y[4], a_x[4];  // roi * P^2 (3x3) or the row (1x1); -1 past M
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + row0 + 32 * j;
    a_base[j] = -1;
    a_y[j] = a_x[j] = 0;
    if (m < g.M) {
      if (KS == 1) {
        a_base[j] = m;
      } else {
        const int roi = m / PP, pix = m - roi * PP;
        a_base[j] = roi * PP;
        a_y[j] = pix / g.P;
        a_x[j] = pix - a_y[j] * g.P;
      }
    }
  }

  auto load_stage = [&](int stage, int ks) {
    const int k0 = ks * BK;
    const int tap = k0 / g.Cin, ci = k0 - tap * g.Cin;
    const int di = tap / KS - KS / 2, dj = tap % KS - KS / 2;
    const uint32_t as = sbase + stage * STAGE_BYTES, bs = as + A_TILE;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int pix = a_base[j];
      bool ok = pix >= 0;
      if (KS == 3) {
        const int yy = a_y[j] + di, xx = a_x[j] + dj;
        ok = ok && yy >= 0 && yy < g.P && xx >= 0 && xx < g.P;
        pix += yy * g.P + xx;
      }
      const int8_t* src = ok ? g.a + static_cast<long long>(pix) * g.Cin + ci + chunk * 16 : g.a;
      cp_async16(as + (row0 + 32 * j) * BK + sw, src, ok);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = row0 + 32 * j;
      cp_async16(bs + n * BK + chunk * 16,
                 g.w + static_cast<long long>(n0 + n) * kdim + k0 + chunk * 16, true);
    }
  };

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  // Loads run two k-steps ahead; the products of one k-step stay in flight
  // while the next is issued, so a stage is refilled only two k-steps after
  // its products were issued, once every warpgroup has waited for them.
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 3>();
    // this thread's copies of stage ks are visible to the tensor cores' reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage ks has landed; the products of k-step ks - 2 are done
    {
      const int nxt = ks + STAGES - 2;
      if (nxt < nk) load_stage(nxt % STAGES, nxt);
      cp_async_commit();
    }
    const uint32_t st = sbase + (ks % STAGES) * STAGE_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8_64x256x32(acc, smem_desc(st + wg * 64 * BK + 32 * kk),
                         smem_desc(st + A_TILE + 32 * kk), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(acc[i])::"memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(acc[i])::"memory");
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue reuses it

  if (!SELECT) {
    int8_t* cs = smem;  // [BM][C_STRIDE]
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * j + t4 * 2;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(g.wsc + n0 + c));
      const float2 bi = __ldg(reinterpret_cast<const float2*>(g.bias + n0 + c));
      const float2 iv = __ldg(reinterpret_cast<const float2*>(g.inv_out + n0 + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + wi * 16 + gq + 8 * h;
        char2 q;
        q.x = requant(fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sc.x),
                                      bi.x), 0.f), iv.x);
        q.y = requant(fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sc.y),
                                      bi.y), 0.f), iv.y);
        *reinterpret_cast<char2*>(cs + r * C_STRIDE + c) = q;
      }
    }
    __syncthreads();
    for (int i = tid; i < BM * (BN / 16); i += THREADS) {
      const int r = i / (BN / 16), c16 = (i % (BN / 16)) * 16;
      const int m = m0 + r;
      if (m < g.M)
        *reinterpret_cast<int4*>(g.out + static_cast<long long>(m) * g.N + n0 + c16) =
            *reinterpret_cast<const int4*>(cs + r * C_STRIDE + c16);
    }
    return;
  }

  // deconv epilogue: requantize by asc row 5, then the class conv of each row's
  // ROI class over this block's 256 columns, reduced in a fixed order: each
  // thread over its columns in ascending order, then across the four
  // threads of the row (xor 1, then xor 2)
  // (columns outside, the thread's two rows inside: a column's four scale
  // values are loaded once for both rows)
  int mrow[2];
  const __nv_bfloat16* wcol[2];
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mrow[h] = m0 + wg * 64 + wi * 16 + gq + 8 * h;
    wcol[h] = g.wout + __ldg(g.classes + (mrow[h] < g.M ? mrow[h] / PP : 0));
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + t4 * 2;
    const float2 sc = __ldg(reinterpret_cast<const float2*>(g.wsc + n0 + c));
    const float2 bi = __ldg(reinterpret_cast<const float2*>(g.bias + n0 + c));
    const float2 iv = __ldg(reinterpret_cast<const float2*>(g.inv_out + n0 + c));
    const float2 as = __ldg(reinterpret_cast<const float2*>(g.asc_out + n0 + c));
    const float a5[2] = {bf16r(as.x), bf16r(as.y)};
    const float scs[2] = {sc.x, sc.y}, bis[2] = {bi.x, bi.y}, ivs[2] = {iv.x, iv.y};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), scs[e]),
                                  bis[e]);
        const float q = static_cast<float>(requant(fmaxf(y, 0.f), ivs[e]));
        const float yb = bf16r(__fmul_rn(q, a5[e]));
        part[h] = __fadd_rn(part[h],
                            __fmul_rn(yb, __bfloat162float(wcol[h][(c + e) * g.nc])));
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mrow[h];
    float p = __fadd_rn(part[h], __shfl_xor_sync(0xffffffffu, part[h], 1));
    p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
    if (t4 == 0 && m < g.M) {
      const int roi = m / PP, pix = m % PP;
      const int py = pix / g.P, px = pix % g.P;
      const float logit = __fadd_rn(p, __ldg(g.bias_out + __ldg(g.classes + roi)));
      const float prob = bf16r(1.f / (1.f + expf(-logit)));
      const int di = blockIdx.y >> 1, dj = blockIdx.y & 1;
      const int side = 2 * g.P;
      g.masks[static_cast<long long>(roi) * side * side + (2 * py + di) * side + 2 * px + dj] = prob;
    }
  }
}

}  // namespace

// Plain C interface for ctypes: the six launches on `stream`. Returns the
// first launch error (cudaGetLastError) or 0.
extern "C" int fused_mask_branch(const void* fmap, const void* boxes, const void* classes,
                                 const void* w1, const void* w2, const void* w3, const void* w4,
                                 const void* wd, const void* wout, const void* wsc,
                                 const void* bias, const void* asc, void* x0, void* xa, void* xb,
                                 void* masks, int B, int H, int W, int Cf, int K, int P, int co,
                                 int nc, int ld, int lda, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * K * P * P;
  const float* ascf = static_cast<const float*>(asc);
  const float* wscf = static_cast<const float*>(wsc);
  const float* biasf = static_cast<const float*>(bias);

  cudaError_t attr = cudaFuncSetAttribute(gemm_kernel<3, false>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(gemm_kernel<1, true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);

  {
    dim3 block(Cf / 8 < 32 ? Cf / 8 : 32, 8);
    crop_quant_kernel<<<B * K * P, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(fmap), static_cast<const float*>(boxes),
        static_cast<int8_t*>(x0), H, W, Cf, K, P, ascf);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }

  const void* wts[4] = {w1, w2, w3, w4};
  const int8_t* src = static_cast<const int8_t*>(x0);
  int8_t* bufs[2] = {static_cast<int8_t*>(xa), static_cast<int8_t*>(xb)};
  const unsigned mblocks = static_cast<unsigned>((M + BM - 1) / BM);
  for (int l = 0; l < 4; ++l) {
    GemmArgs g = {};
    g.a = src;
    g.w = static_cast<const int8_t*>(wts[l]);
    g.wsc = wscf + l * ld;
    g.bias = biasf + l * ld;
    g.M = M;
    g.N = co;
    g.Cin = l == 0 ? Cf : co;
    g.P = P;
    g.inv_out = ascf + (l + 1) * lda;
    g.out = bufs[l % 2];
    gemm_kernel<3, false><<<dim3(mblocks, co / BN), THREADS, SMEM_BYTES, s>>>(g);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    src = bufs[l % 2];
  }

  GemmArgs g = {};
  g.a = src;
  g.w = static_cast<const int8_t*>(wd);
  g.wsc = wscf + 4 * ld;
  g.bias = biasf + 4 * ld;
  g.M = M;
  g.N = 4 * co;
  g.Cin = co;
  g.P = P;
  g.inv_out = ascf + 5 * lda;
  g.asc_out = ascf + 6 * lda;
  g.classes = static_cast<const int*>(classes);
  g.wout = static_cast<const __nv_bfloat16*>(wout);
  g.bias_out = biasf + 5 * ld;
  g.nc = nc;
  g.masks = static_cast<float*>(masks);
  gemm_kernel<1, true><<<dim3(mblocks, 4), THREADS, SMEM_BYTES, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}
