// Fused int8 depthwise-separable block for Hopper (sm_90a).
//
// Replaces the TPU kernel mask_yolo_tpu/ops/pallas_ds.py::fused_ds_block
// (body _ds_kernel). Its plain PyTorch version is
// mask_yolo_tpu_torch/ops/ds_block.py::fused_ds_block_reference; the wrapper
// is ops/ds_block.py::fused_ds_block.
//
//   x_q  [B, H, W, C] int8     input at the depthwise layer's scale
//   kdw  [9, C]       int8     depthwise taps, row (di, dj) = 3*di + dj
//   dwsb [2, C]       f32      (w_scale * s_in, bias) of the depthwise layer
//   wpw  [C, O]       int8     pointwise weights
//   pwsb [2, O]       f32      (w_scale * a_pw, bias) of the pointwise layer
//   out  [B, H, W, O] int8 at s_out (inv_s_out > 0) or f32 (inv_s_out == 0)
//
// What bounds it: at the 224² trunk's shapes the pointwise GEMM is
// 0.5-1 GMAC per image-block and the depthwise tensor, were it written out,
// would be as large as the input. The point of the fusion is that the
// depthwise result never reaches device memory: it lives in shared memory
// as the GEMM's A operand.
//
// Design (simple and right first):
//   * one block per BM = 64 consecutive pixels of the flattened (b, h, w)
//     index, so odd widths (7, 13, 26) and ragged ends need no halo logic;
//   * phase 1: each thread computes 16 channels of one pixel's depthwise
//     conv, reading its nine taps from global memory (L1/L2 serve the
//     reuse), applies the f32 epilogue and writes int8 into shared memory
//     A[BM][C] (rows padded by 16 bytes to spread the banks);
//   * phase 2: for each chunk of BN = 128 output channels, an int8 GEMM
//     over C in steps of 32 with mma.sync m16n8k32 (s8 x s8 -> s32); the
//     weight tile is transposed into shared memory as B[n][k] so each
//     fragment is one 32-bit load; 8 warps as 2 (M) x 4 (N), warp tile
//     32 x 32; then the f32 epilogue and the store.
// The epilogue arithmetic is the chained int8 path's bit for bit: the
// explicit _rn intrinsics keep nvcc from contracting multiply-adds into
// FMAs, and __float2int_rn rounds half to even like torch.round.
// Shared memory: 64 * (C + 16) + 128 * 48 bytes, 72.7 KB at C = 1024, set
// with cudaFuncSetAttribute above the 48 KB default. Needs C % 32 == 0 and
// O % 16 == 0 (the wrapper checks).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;        // pixels per block
constexpr int BN = 128;       // output channels per GEMM pass
constexpr int BK = 32;        // GEMM k step: one m16n8k32
constexpr int THREADS = 256;  // 8 warps: 2 (M) x 4 (N)
constexpr int PAD = 16;       // bytes added to each shared-memory row
constexpr int B_STRIDE = BK + PAD;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int8_t requant(float y, float inv) {
  int q = __float2int_rn(__fmul_rn(y, inv));
  return static_cast<int8_t>(q < -127 ? -127 : (q > 127 ? 127 : q));
}

__device__ __forceinline__ float relu6(float y) { return fminf(fmaxf(y, 0.f), 6.f); }

__global__ void __launch_bounds__(THREADS)
    fused_ds_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ kdw,
                    const float* __restrict__ dwsb, const int8_t* __restrict__ wpw,
                    const float* __restrict__ pwsb, void* __restrict__ out, int B, int H,
                    int W, int C, int O, float inv_a_pw, float inv_s_out) {
  extern __shared__ __align__(16) int8_t smem[];
  const int sa = C + PAD;                 // A row stride, bytes
  int8_t* As = smem;                      // [BM][C + PAD]
  int8_t* Bs = smem + BM * sa;            // [BN][BK + PAD]
  const int tid = threadIdx.x;
  const long long npix = static_cast<long long>(B) * H * W;
  const long long p0 = static_cast<long long>(blockIdx.x) * BM;

  // ---- phase 1: depthwise 3x3 + epilogue into shared memory --------------
  const int cv = C / 16;
  for (int item = tid; item < BM * cv; item += THREADS) {
    const int r = item / cv;
    const int c0 = (item % cv) * 16;
    const long long p = p0 + r;
    int4 packed = make_int4(0, 0, 0, 0);
    if (p < npix) {
      const int xw = static_cast<int>(p % W);
      const int yh = static_cast<int>((p / W) % H);
      const long long img = p / (static_cast<long long>(H) * W);
      int acc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = 0;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int yy = yh + t / 3 - 1, xx = xw + t % 3 - 1;
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
        const int4 xv = __ldg(reinterpret_cast<const int4*>(
            x + ((img * H + yy) * W + xx) * C + c0));
        const int4 kv = __ldg(reinterpret_cast<const int4*>(kdw + t * C + c0));
        const int8_t* xs = reinterpret_cast<const int8_t*>(&xv);
        const int8_t* ks = reinterpret_cast<const int8_t*>(&kv);
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] += static_cast<int>(xs[j]) * static_cast<int>(ks[j]);
      }
      int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int ch = c0 + j;
        const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[j]), __ldg(dwsb + ch)),
                                  __ldg(dwsb + C + ch));
        q[j] = requant(relu6(y), inv_a_pw);
      }
    }
    *reinterpret_cast<int4*>(As + r * sa + c0) = packed;
  }
  __syncthreads();

  // ---- phase 2: pointwise int8 GEMM + epilogue --------------------------
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile rows wm*32, cols wn*32
  const int g = lane >> 2, t4 = lane & 3;
  for (int n0 = 0; n0 < O; n0 += BN) {
    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

    for (int k0 = 0; k0 < C; k0 += BK) {
      {  // B tile: wpw[k0 .. k0+31][n0 .. n0+127] -> Bs[n][k]
        const int kr = tid / 8, nc = (tid % 8) * 16;
        int4 v = make_int4(0, 0, 0, 0);
        if (n0 + nc < O)
          v = __ldg(reinterpret_cast<const int4*>(wpw + static_cast<long long>(k0 + kr) * O + n0 + nc));
        const int8_t* bv = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j) Bs[(nc + j) * B_STRIDE + kr] = bv[j];
      }
      __syncthreads();
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* base = As + (wm * 32 + mt * 16 + g) * sa + k0 + t4 * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * sa);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * sa + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* base = Bs + (wn * 32 + nt * 8 + g) * B_STRIDE + t4 * 4;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(base);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
      __syncthreads();
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const long long p = p0 + wm * 32 + mt * 16 + g + (v >= 2 ? 8 : 0);
          const int n = n0 + wn * 32 + nt * 8 + t4 * 2 + (v & 1);
          if (p >= npix || n >= O) continue;
          const float y = relu6(__fadd_rn(
              __fmul_rn(__int2float_rn(acc[mt][nt][v]), __ldg(pwsb + n)), __ldg(pwsb + O + n)));
          if (inv_s_out > 0.f)
            static_cast<int8_t*>(out)[p * O + n] = requant(y, inv_s_out);
          else
            static_cast<float*>(out)[p * O + n] = y;
        }
  }
}

}  // namespace

// Plain C interface for ctypes. Returns cudaGetLastError() after the launch.
extern "C" int fused_ds_block(const void* x_q, const void* kdw, const void* dwsb,
                              const void* wpw, const void* pwsb, void* out, int B, int H, int W,
                              int C, int O, float inv_a_pw, float inv_s_out, void* stream) {
  const size_t smem = static_cast<size_t>(BM) * (C + PAD) + static_cast<size_t>(BN) * B_STRIDE;
  cudaError_t err = cudaFuncSetAttribute(fused_ds_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long npix = static_cast<long long>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((npix + BM - 1) / BM));
  fused_ds_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(kdw),
      static_cast<const float*>(dwsb), static_cast<const int8_t*>(wpw),
      static_cast<const float*>(pwsb), out, B, H, W, C, O, inv_a_pw, inv_s_out);
  return static_cast<int>(cudaGetLastError());
}
