// Fused int8 mask branch for Hopper (sm_90a).
//
// Replaces the TPU kernel mask_yolo_tpu/ops/pallas_mask.py::fused_mask_branch
// (body _mask_kernel). Its plain PyTorch version is
// mask_yolo_tpu_torch/ops/mask_fused.py::fused_mask_branch_reference; the
// wrapper is ops/mask_fused.py::fused_mask_branch.
//
//   fmap    [B, H, W, Cf]  bf16        boxes [B*K, 4] f32   classes [B*K] int32
//   w1      [9*Cf, co]     int8        w2..w4 [9*co, co] int8 (rows (di, dj, ci))
//   wd      [co, 4*co]     int8        deconv as a 1x1 conv, columns (di, dj, o)
//   wout    [co, nc]       bf16        the class conv (block 0 of the TPU kernel's wo)
//   wsc     [5, ld], bias [6, ld] f32  per-channel weight scales and biases
//   asc0..5                f32         activation scales
//   out     [B*K, 2P, 2P]  f32         each ROI's class mask (bf16 values)
//
// The TPU kernel kept 2.7 MB of weights and a block of ROIs resident in
// ~5 MB of VMEM and ran one image per grid step. A Hopper block has 227 KB,
// and a block per ROI would re-read the weights for every ROI (~3.4 GB of
// L2 reads for a batch of 128 at K = 10). So each layer here is an
// implicit-GEMM int8 kernel over all M = B*K*P*P crop pixels: every weight
// tile is reused across the ROIs of a 128-row block. What bounds it is
// the int8 MAC count, 0.52 G per ROI at 224² (four 3x3 256->256 convs
// over 14x14 and the 256->1024 deconv); the intermediates (M x 256 int8,
// 64 MB at B = 128) go through wrapper-allocated scratch once per layer.
//
// Six launches on the caller's stream, one C entry point:
//   1. crop_quant: bilinear crop of each ROI (both contractions rounded to
//      bf16 exactly like the plain version's two bf16 matmuls, since each
//      has two non-zero taps) and int8 at asc0 -> x0 [M, Cf];
//   2-5. conv3x3: implicit GEMM, im2col gathered from each ROI's
//      zero-padded P x P tile; mma.sync m16n8k32 s8 with int32 accumulation;
//      epilogue acc*(wsc*asc_in) + bias, relu, int8 at asc_out;
//   6. deconv + class conv: the 1x1 GEMM to 4*co with its epilogue fused
//      with the int8 requantize at asc5, the bf16 class conv of the ROI's
//      own class only (bf16(y_q)*bf16(asc5) times bf16 wout, f32 sums), the
//      sigmoid, the bf16 rounding and the depth-to-space store. One block
//      covers 64 rows and one (di, dj) block of 256 columns, so the class
//      dot product reduces inside the block, in a fixed order.
// Every f32 multiply-add of the int8 epilogues uses _rn intrinsics (no FMA
// contraction) and __float2int_rn (half to even), as the plain version.
// Needs Cf % 32 == 0 and co == 256 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // 8 warps, each a 32 x 64 tile
constexpr int BK = 32;
constexpr int STRIDE = BK + 16;  // shared-memory row, bytes (bank spread)

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
                                  int H, int W, int C, int K, int P, float inv0) {
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
          q[j] = requant(v, inv0);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) q[j] = requant(0.f, inv0);
      }
      *reinterpret_cast<int2*>(dst + c0) = packed;
    }
  }
}

// ---- 2-6. implicit-GEMM int8 layers --------------------------------------

struct GemmArgs {
  const int8_t* a;      // [M, Cin] int8 activations (ROI tiles of P x P rows)
  const int8_t* w;      // [KS*KS*Cin, N] int8
  const float* wsc;     // [N]
  const float* bias;    // [N]
  int M, N, Cin, P;
  float asc_in, inv_out, asc_out;
  int8_t* out;          // requantize mode: [M, N] int8
  // class-select mode (the deconv):
  const int* classes;           // [M / P^2]
  const __nv_bfloat16* wout;    // [N / 4, nc]
  const float* bias_out;        // [nc]
  int nc;
  float* masks;                 // [M / P^2, 2P, 2P]
};

// WM x WN warps, each a 32 x 64 tile: BM = 32*WM rows, BN = 64*WN columns.
// KS = 3: a 3x3 SAME conv over each ROI's tile; KS = 1: a 1x1 conv.
// SELECT: the deconv epilogue (BN must be the deconv's co, blockIdx.y the
// (di, dj) block).
template <int KS, int WM, int WN, bool SELECT>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs g) {
  constexpr int BM = 32 * WM, BN = 64 * WN;
  __shared__ __align__(16) int8_t As[BM * STRIDE];
  __shared__ __align__(16) int8_t Bs[BN * STRIDE];
  __shared__ float red[SELECT ? WN * BM : 1];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int PP = g.P * g.P;
  const int kdim = KS * KS * g.Cin;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int gq = lane >> 2, t4 = lane & 3;

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  for (int k0 = 0; k0 < kdim; k0 += BK) {
    const int tap = k0 / g.Cin, ci0 = k0 % g.Cin;
    const int di = tap / KS - KS / 2, dj = tap % KS - KS / 2;
    for (int i = tid; i < BM * 2; i += THREADS) {  // A: 32 bytes per row
      const int r = i >> 1, half = i & 1;
      const int m = m0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < g.M) {
        long long src = -1;
        if (KS == 1) {
          src = static_cast<long long>(m) * g.Cin;
        } else {
          const int roi = m / PP, pix = m % PP;
          const int yy = pix / g.P + di, xx = pix % g.P + dj;
          if (yy >= 0 && yy < g.P && xx >= 0 && xx < g.P)
            src = (static_cast<long long>(roi) * PP + yy * g.P + xx) * g.Cin;
        }
        if (src >= 0) v = __ldg(reinterpret_cast<const int4*>(g.a + src + ci0 + half * 16));
      }
      *reinterpret_cast<int4*>(As + r * STRIDE + half * 16) = v;
    }
    for (int i = tid; i < BK * (BN / 16); i += THREADS) {  // B: transpose to [n][k]
      const int kr = i / (BN / 16), nc = (i % (BN / 16)) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (n0 + nc < g.N)
        v = __ldg(reinterpret_cast<const int4*>(g.w + static_cast<long long>(k0 + kr) * g.N + n0 + nc));
      const int8_t* bv = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[(nc + j) * STRIDE + kr] = bv[j];
    }
    __syncthreads();
    uint32_t a[2][4], b[8][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* base = As + (wm * 32 + mt * 16 + gq) * STRIDE + t4 * 4;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * STRIDE);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * STRIDE + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int8_t* base = Bs + (wn * 64 + nt * 8 + gq) * STRIDE + t4 * 4;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(base);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(base + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    __syncthreads();
  }

  if (!SELECT) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + gq + 8 * h;
        if (m >= g.M) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = n0 + wn * 64 + nt * 8 + t4 * 2;
          if (n >= g.N) continue;
          char2 q;
          float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h]),
                                        __fmul_rn(__ldg(g.wsc + n), g.asc_in)), __ldg(g.bias + n));
          q.x = requant(fmaxf(y, 0.f), g.inv_out);
          y = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]),
                                  __fmul_rn(__ldg(g.wsc + n + 1), g.asc_in)), __ldg(g.bias + n + 1));
          q.y = requant(fmaxf(y, 0.f), g.inv_out);
          *reinterpret_cast<char2*>(g.out + static_cast<long long>(m) * g.N + n) = q;
        }
      }
    return;
  }

  // deconv epilogue: requantize at asc5, then the class conv of each row's
  // ROI class over this block's 256 columns, reduced in a fixed order
  const float a5 = bf16r(g.asc_out);
  float part[2][2];
  const __nv_bfloat16* wcol[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mt * 16 + gq + 8 * h;
      wcol[mt][h] = g.wout + __ldg(g.classes + (m < g.M ? m / PP : 0));
      part[mt][h] = 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int h = v >> 1;
        const int c = wn * 64 + nt * 8 + t4 * 2 + (v & 1);
        const int n = n0 + c;
        const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][v]),
                                            __fmul_rn(__ldg(g.wsc + n), g.asc_in)),
                                  __ldg(g.bias + n));
        const float q = static_cast<float>(requant(fmaxf(y, 0.f), g.inv_out));
        const float yb = bf16r(__fmul_rn(q, a5));
        part[mt][h] = __fadd_rn(part[mt][h],
                                __fmul_rn(yb, __bfloat162float(wcol[mt][h][c * g.nc])));
      }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p = part[mt][h];
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 1));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
      if (t4 == 0) red[wn * BM + wm * 32 + mt * 16 + gq + 8 * h] = p;
    }
  __syncthreads();
  if (tid < BM) {
    const int m = m0 + tid;
    if (m < g.M) {
      const int roi = m / PP, pix = m % PP;
      const int py = pix / g.P, px = pix % g.P;
      float logit = 0.f;
#pragma unroll
      for (int w = 0; w < WN; ++w) logit = __fadd_rn(logit, red[w * BM + tid]);
      logit = __fadd_rn(logit, __ldg(g.bias_out + __ldg(g.classes + roi)));
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
                                 const void* bias, void* x0, void* xa, void* xb, void* masks,
                                 int B, int H, int W, int Cf, int K, int P, int co, int nc, int ld,
                                 float asc0, float asc1, float asc2, float asc3, float asc4,
                                 float asc5, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * K * P * P;
  const float asc[6] = {asc0, asc1, asc2, asc3, asc4, asc5};
  const float* wscf = static_cast<const float*>(wsc);
  const float* biasf = static_cast<const float*>(bias);

  {
    dim3 block(Cf / 8 < 32 ? Cf / 8 : 32, 8);
    crop_quant_kernel<<<B * K * P, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(fmap), static_cast<const float*>(boxes),
        static_cast<int8_t*>(x0), H, W, Cf, K, P, 1.0f / asc0);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }

  const void* wts[4] = {w1, w2, w3, w4};
  const int8_t* src = static_cast<const int8_t*>(x0);
  int8_t* bufs[2] = {static_cast<int8_t*>(xa), static_cast<int8_t*>(xb)};
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
    g.asc_in = asc[l];
    g.inv_out = 1.0f / asc[l + 1];
    g.out = bufs[l % 2];
    const dim3 grid((M + 127) / 128, co / 128);
    gemm_kernel<3, 4, 2, false><<<grid, THREADS, 0, s>>>(g);
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
  g.asc_in = asc4;
  g.inv_out = 1.0f / asc5;
  g.asc_out = asc5;
  g.classes = static_cast<const int*>(classes);
  g.wout = static_cast<const __nv_bfloat16*>(wout);
  g.bias_out = biasf + 5 * ld;
  g.nc = nc;
  g.masks = static_cast<float*>(masks);
  const dim3 grid((M + 63) / 64, 4);
  gemm_kernel<1, 2, 4, true><<<grid, THREADS, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}
