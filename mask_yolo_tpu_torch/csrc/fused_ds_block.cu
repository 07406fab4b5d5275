// Fused int8 depthwise-separable block for Hopper (sm_90a).
//
// Replaces the TPU kernel mask_yolo_tpu/ops/pallas_ds.py::fused_ds_block
// (body _ds_kernel). Its plain PyTorch version is
// mask_yolo_tpu_torch/ops/ds_block.py::fused_ds_block_reference; the wrapper
// is ops/ds_block.py::fused_ds_block.
//
//   x_q  [B, H, W, C] int8     input at the depthwise layer's scale
//   kdw  [9, C]       int8     depthwise taps, row (di, dj) = 3*di + dj
//   dwsb [3, C]       f32      (w_scale * s_in, bias) of the depthwise layer and
//                              the inverse of the pointwise layer's input scale
//   wpw  [O, C]       int8     pointwise weights, K-contiguous (packed by
//                              ops/ds_block.py::pack_ds_pair)
//   pwsb [3, O]       f32      (w_scale * a_pw, bias) of the pointwise layer and
//                              the inverse of the output's scale
//   out  [B, H, W, O] int8 (out_int8) or f32
// Row 2 of dwsb and pwsb holds one inverse scale a channel: a per-channel
// graph's vector, or a per-tensor graph's scalar repeated, so one body runs
// both. The host computes each inverse once, as f32(1) / f32(scale).
//
// What bounds it: at the trunk's shapes the block moves 3-26 MB at batch 16
// and its GEMM is small, so the bound is memory, and at the narrow late
// shapes (7x7, 14x14) latency: 784 or 3,136 pixels must still spread over
// 132 SMs. The depthwise result never reaches device memory: it lives in
// shared memory as the GEMM's A operand.
//
// Design: a 2-D grid of BM = 64 pixels (of the flattened (b, h, w) index,
// so odd widths and ragged ends need no halo logic) x column groups; a
// group walks its BN = 64-wide output-channel tiles one after another. The
// launch splits the columns into just enough groups to give each SM about
// three blocks (208 blocks at 7x7x1024 -> 1024 and 392 at 14x14x512 -> 512
// at batch 16; one group where the pixel tiles alone fill the card). The
// groups of one pixel tile form a thread-block cluster (up to 8 blocks), and
// the depthwise conv is split over the cluster instead of recomputed by
// each group: block `rank` computes its 1/CL share of the channels and
// stores it into the A tile of every block of the cluster (distributed
// shared memory). Each block
//   * starts a 3-stage cp.async ring of B tiles [BN][BK] (BK = 128 bytes,
//     or C when C < 128) from the packed weights, one ring over all its
//     (column tile, k-step) pairs, so the first copies fly while
//   * every thread computes the depthwise conv of 8 channels of one pixel
//     at a time (each row's (image, y, x) computed once), reading its nine
//     taps from global memory; a 4 x 4 byte transpose (__byte_perm) turns
//     the tap words into words of 4 taps a channel, so __dp4a does 4 MACs
//     (the pass is bound by instructions, not bytes); it applies the f32
//     epilogue and writes int8 into the cluster's A tiles [BM][C];
//   * runs the pointwise GEMM, 8 warps as 2 (M) x 4 (N) of 32 x 16, with
//     ldmatrix.x4 fragments and mma.sync m16n8k32 (s8 x s8 -> s32);
//   * stages each column tile's int8 or f32 epilogue in shared memory and
//     stores it as 16-byte row pieces.
// Shared-memory rows are padded by 16 bytes, so eight ldmatrix rows fall on
// eight different bank groups.
// The epilogue arithmetic is the chained int8 path's bit for bit: the
// explicit _rn intrinsics keep nvcc from contracting multiply-adds into
// FMAs, the requantize multiplies by the host's inverse (no reciprocal
// here), and __float2int_rn rounds half to even like torch.round.
// Shared memory: 64 (C + 16) + 3 BN (BK + 16) + 64 (BN esz + 16) bytes (esz:
// 1 or 4 bytes an output), 97 KB at C = 1024. Needs C % 32 == 0 and
// O % 16 == 0 (the wrapper checks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;        // pixels per block
constexpr int BN = 64;        // output channels per column tile
constexpr int THREADS = 256;  // 8 warps: 2 (M) x 4 (N), warp tile 32 x 16
constexpr int STAGES = 3;
constexpr int PAD = 16;       // bytes added to each shared-memory row
constexpr int MAX_CLUSTER = 8;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes global -> shared; zero-filled when !valid
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
  int q = __float2int_rn(__fmul_rn(y, inv));
  return static_cast<int8_t>(q < -127 ? -127 : (q > 127 ? 127 : q));
}

__device__ __forceinline__ float relu6(float y) { return fminf(fmaxf(y, 0.f), 6.f); }

__host__ __device__ constexpr int b_stride(int bk) { return bk + PAD; }

// w[0..3]: byte c of w[t] is channel c at tap t -> out[c]: byte t is tap t of
// channel c (a 4 x 4 byte transpose)
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// 8 bytes into the shared memory of block `rank` of this cluster, at the
// offset that `addr` has in this block's
__device__ __forceinline__ void st_cluster8(uint32_t addr, uint32_t rank, int2 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(remote), "r"(v.x), "r"(v.y)
               : "memory");
}

// CLUSTER: launched in clusters of column groups that share the depthwise
// conv; otherwise one block computes all of it and no cluster is formed.
// The launch aims at three blocks an SM; saying so to ptxas (at most 85
// registers) keeps the epilogue's rows of scales in registers: left to its
// own choice it took 64 in the 128-wide clustered variant and spilled, and
// the C >= 256 shapes ran 5-12 % slower on an H100.
template <int BK, bool CLUSTER>
__global__ void __launch_bounds__(THREADS, 3)
    fused_ds_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ kdw,
                    const float* __restrict__ dwsb, const int8_t* __restrict__ wpw,
                    const float* __restrict__ pwsb, void* __restrict__ out, int B, int H,
                    int W, int C, int O, int tiles_per_block, int out_int8) {
  constexpr int SB = b_stride(BK);
  constexpr int B_TILE = BN * SB;
  const int rank = CLUSTER ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int cl = CLUSTER ? static_cast<int>(cg::this_cluster().num_blocks()) : 1;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int row_pix[BM], row_y[BM], row_x[BM];  // image's first pixel, y, x
  const bool q8 = out_int8 != 0;
  const int esz = q8 ? 1 : 4;
  const int so = BN * esz + PAD;          // out tile row stride, bytes
  const int sa = C + PAD;                 // A row stride, bytes
  int8_t* As = smem;                      // [BM][C + PAD], the same offset in every block
  int8_t* Bs = smem + BM * sa;            // STAGES x [BN][BK + PAD]
  int8_t* Cs = Bs + STAGES * B_TILE;      // [BM][BN esz + PAD], the out tile
  const uint32_t as_addr = static_cast<uint32_t>(__cvta_generic_to_shared(As));
  const uint32_t bs_addr = static_cast<uint32_t>(__cvta_generic_to_shared(Bs));
  const int tid = threadIdx.x;
  const int npix = B * H * W;
  const int p0 = blockIdx.x * BM;
  const int n_tiles = (O + BN - 1) / BN;
  const int t0 = blockIdx.y * tiles_per_block;
  const int t1 = min(n_tiles, t0 + tiles_per_block);
  const int nk = C / BK;
  const int steps = (t1 - t0) * nk;  // (column tile, k-step) pairs, in order

  auto load_b = [&](int stage, int step) {
    const int n0 = (t0 + step / nk) * BN, k0 = (step % nk) * BK;
    for (int i = tid; i < BN * (BK / 16); i += THREADS) {
      const int n = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const bool ok = n0 + n < O;
      const int8_t* src = ok ? wpw + static_cast<long long>(n0 + n) * C + k0 + c : wpw;
      cp_async16(bs_addr + stage * B_TILE + n * SB + c, src, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_b(s, s);
    cp_async_commit();
  }

  // ---- phase 1: this rank's channels of the depthwise 3x3, into the A tile
  // of every block of the cluster -------------------------------------------
  if (tid < BM) {
    const int p = p0 + tid;
    const int xw = p % W, yh = (p / W) % H;
    row_pix[tid] = p < npix ? p - yh * W - xw : -1;
    row_y[tid] = yh;
    row_x[tid] = xw;
  }
  // the row table is visible, and every block of the cluster has started,
  // so its shared memory may be written
  if (CLUSTER)
    cg::this_cluster().sync();
  else
    __syncthreads();
  const int cv = C / 8;
  const int lo = rank * cv / cl, nch = (rank + 1) * cv / cl - lo;
  // Items of 8 channels of one pixel. The nine taps load without branches
  // (an off-map tap reads a zero), so the unrolled loop keeps the loads of
  // several items in flight.
#pragma unroll 4
  for (int item = tid; item < BM * nch; item += THREADS) {
    const int r = item / nch;
    const int c0 = (lo + item - r * nch) * 8;
    const bool valid = row_pix[r] >= 0;
    const int yh = row_y[r], xw = row_x[r];
    const int8_t* img = x + static_cast<long long>(valid ? row_pix[r] : 0) * C + c0;
    int2 xv[9], kv[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int yy = yh + t / 3 - 1, xx = xw + t % 3 - 1;
      const bool in = valid && yy >= 0 && yy < H && xx >= 0 && xx < W;
      xv[t] = in ? __ldg(reinterpret_cast<const int2*>(
                       img + static_cast<long long>(yy * W + xx) * C))
                 : make_int2(0, 0);
      kv[t] = __ldg(reinterpret_cast<const int2*>(kdw + t * C + c0));
    }
    // Per 4 channels: the words of taps 0-3 and 4-7 (a channel a byte) are
    // transposed into words of 4 taps a channel, so one dp4a sums 4 taps;
    // tap 8 takes one more dp4a with the other channels masked out. Exact
    // int32 sums, so the order does not matter.
    int acc[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t x[9], k[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        x[t] = static_cast<uint32_t>(h ? xv[t].y : xv[t].x);
        k[t] = static_cast<uint32_t>(h ? kv[t].y : kv[t].x);
      }
      uint32_t xa[4], xb[4], ka[4], kb[4];
      transpose4(x, xa);
      transpose4(x + 4, xb);
      transpose4(k, ka);
      transpose4(k + 4, kb);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        int s = __dp4a(static_cast<int>(xa[ch]), static_cast<int>(ka[ch]), 0);
        s = __dp4a(static_cast<int>(xb[ch]), static_cast<int>(kb[ch]), s);
        acc[4 * h + ch] = __dp4a(static_cast<int>(x[8] & (0xFFu << (8 * ch))),
                                 static_cast<int>(k[8]), s);
      }
    }
    int2 packed = make_int2(0, 0);
    if (valid) {
      const float4 sc0 = __ldg(reinterpret_cast<const float4*>(dwsb + c0));
      const float4 sc1 = __ldg(reinterpret_cast<const float4*>(dwsb + c0 + 4));
      const float4 bi0 = __ldg(reinterpret_cast<const float4*>(dwsb + C + c0));
      const float4 bi1 = __ldg(reinterpret_cast<const float4*>(dwsb + C + c0 + 4));
      const float4 iv0 = __ldg(reinterpret_cast<const float4*>(dwsb + 2 * C + c0));
      const float4 iv1 = __ldg(reinterpret_cast<const float4*>(dwsb + 2 * C + c0 + 4));
      const float sc[8] = {sc0.x, sc0.y, sc0.z, sc0.w, sc1.x, sc1.y, sc1.z, sc1.w};
      const float bi[8] = {bi0.x, bi0.y, bi0.z, bi0.w, bi1.x, bi1.y, bi1.z, bi1.w};
      const float iv[8] = {iv0.x, iv0.y, iv0.z, iv0.w, iv1.x, iv1.y, iv1.z, iv1.w};
      int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        q[j] = requant(relu6(__fadd_rn(__fmul_rn(__int2float_rn(acc[j]), sc[j]), bi[j])),
                       iv[j]);
    }
    if (CLUSTER) {
      for (int b = 0; b < cl; ++b) st_cluster8(as_addr + r * sa + c0, b, packed);
    } else {
      *reinterpret_cast<int2*>(As + r * sa + c0) = packed;
    }
  }
  // every share has landed in every block; after this no block touches
  // another's shared memory, so none has to wait for the others to finish
  if (CLUSTER) cg::this_cluster().sync();

  // ---- phase 2: pointwise int8 GEMM, one 64-column tile after another ----
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int gq = lane >> 2, t4 = lane & 3;
  const int lr = lane & 7;
  const int a_row = wm * 32 + lr + ((lane >> 3) & 1) * 8, a_hi = (lane >> 4) * 16;
  const int b_row = wn * 16 + lr + (lane >> 4) * 8, b_hi = ((lane >> 3) & 1) * 16;
  int8_t* dst = static_cast<int8_t*>(out);
  int acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    // B of this step has landed; at step 0 A is written; the out tile of
    // the previous column tile has been stored
    __syncthreads();
    {
      const int nxt = step + STAGES - 1;
      if (nxt < steps) load_b(nxt % STAGES, nxt);
      cp_async_commit();
    }
    const int ks = step % nk;
    const uint32_t bs = bs_addr + (step % STAGES) * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const int k = ks * BK + kk * 32;
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], as_addr + (a_row + mt * 16) * sa + k + a_hi);
      ldmatrix_x4(b, bs + b_row * SB + kk * 32 + b_hi);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_s8(acc[mt][0], a[mt], b[0], b[1]);
        mma_s8(acc[mt][1], a[mt], b[2], b[3]);
      }
    }
    if (ks != nk - 1) continue;

    // ---- epilogue of this column tile, through shared memory -------------
    const int n0 = (t0 + step / nk) * BN;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wn * 16 + nt * 8 + t4 * 2 + e;
        const int n = n0 + c;
        if (n >= O) continue;
        const float sc = __ldg(pwsb + n), bi = __ldg(pwsb + O + n);
        const float iv = q8 ? __ldg(pwsb + 2 * O + n) : 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mt * 16 + gq + 8 * h;
            const float y =
                relu6(__fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]), sc), bi));
            if (q8)
              Cs[r * so + c] = requant(y, iv);
            else
              *reinterpret_cast<float*>(Cs + r * so + 4 * c) = y;
          }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;
    __syncthreads();
    const int pieces = (O - n0 < BN ? O - n0 : BN) * esz / 16;  // O % 16 == 0
    for (int i = tid; i < BM * pieces; i += THREADS) {
      const int r = i / pieces, c = (i - r * pieces) * 16;
      const long long p = p0 + r;
      if (p < npix)
        *reinterpret_cast<int4*>(dst + (p * O + n0) * esz + c) =
            *reinterpret_cast<const int4*>(Cs + r * so + c);
    }
  }
  cp_async_wait<0>();
}

template <int BK>
int launch(const void* x_q, const void* kdw, const void* dwsb, const void* wpw,
           const void* pwsb, void* out, int B, int H, int W, int C, int O, int out_int8,
           cudaStream_t stream) {
  const int esz = out_int8 ? 1 : 4;
  const size_t smem = static_cast<size_t>(BM) * (C + PAD) + STAGES * BN * b_stride(BK) +
                      BM * (BN * esz + PAD);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Split the output channels into just enough groups to give every SM
  // about three blocks; the groups of a pixel tile share its depthwise conv
  // in a cluster of the largest divisor of their count up to 8 (the grid's
  // y must be a multiple of the cluster's).
  const int pixel_tiles = static_cast<int>((static_cast<long long>(B) * H * W + BM - 1) / BM);
  const int n_tiles = (O + BN - 1) / BN;
  const int want = (3 * sms + pixel_tiles - 1) / pixel_tiles;
  const int groups_wanted = want < 1 ? 1 : (want > n_tiles ? n_tiles : want);
  const int tiles_per_block = (n_tiles + groups_wanted - 1) / groups_wanted;
  const int groups = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  int cl = MAX_CLUSTER;
  while (groups % cl) --cl;
  const dim3 grid(pixel_tiles, groups, 1);
  const auto x = static_cast<const int8_t*>(x_q);
  const auto k = static_cast<const int8_t*>(kdw);
  const auto d = static_cast<const float*>(dwsb);
  const auto w = static_cast<const int8_t*>(wpw);
  const auto p = static_cast<const float*>(pwsb);
  if (cl == 1) {
    err = cudaFuncSetAttribute(fused_ds_kernel<BK, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_ds_kernel<BK, false><<<grid, THREADS, smem, stream>>>(
        x, k, d, w, p, out, B, H, W, C, O, tiles_per_block, out_int8);
    return static_cast<int>(cudaGetLastError());
  }
  err = cudaFuncSetAttribute(fused_ds_kernel<BK, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cl;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_ds_kernel<BK, true>, x, k, d, w, p, out, B, H, W, C, O,
                           tiles_per_block, out_int8);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Returns the launch's error, or
// cudaGetLastError() after it.
extern "C" int fused_ds_block(const void* x_q, const void* kdw, const void* dwsb,
                              const void* wpw, const void* pwsb, void* out, int B, int H, int W,
                              int C, int O, int out_int8, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 128 == 0)
    return launch<128>(x_q, kdw, dwsb, wpw, pwsb, out, B, H, W, C, O, out_int8, s);
  if (C % 64 == 0)
    return launch<64>(x_q, kdw, dwsb, wpw, pwsb, out, B, H, W, C, O, out_int8, s);
  return launch<32>(x_q, kdw, dwsb, wpw, pwsb, out, B, H, W, C, O, out_int8, s);
}
