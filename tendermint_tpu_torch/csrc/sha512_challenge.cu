// SHA-512 challenge hash on Hopper (sm_90a): K4.
//
// What it replaces: tendermint_tpu/ops/hash512.py _challenge_kernel (an XLA
// graph: _sha512_blocks, then _reduce_mod_l_bytes), which computes the
// verifier's challenge k = SHA-512(R || A || M) mod L on the device. The
// host packs each lane's message into pre-padded SHA-512 blocks, one
// (n, B * 128) uint8 row a lane (tendermint_tpu_torch/ops/hash512._pack).
//
//   sha512_challenge_kernel: rows -> (m, 32) uint8 k, little-endian; rows
//                            n..m-1 copy the pad row (the chunk's pad
//                            lanes), so k of a padded chunk stays on the
//                            device in one launch.
//
// Design: two threads a lane, in two warps of a 32-lane block, on native
// uint64_t words. The TPU kernel held a word as a (hi, lo) pair of uint32
// vectors; here a 64-bit rotation is two funnel shifts and a three-input
// XOR one LOP3 a half. The first version ran one thread a lane in
// 128-thread blocks: a 4,096-lane chunk was 32 blocks, one warp on each
// scheduler of 32 SMs, each thread's serial chain of 160 rounds behind
// strided 8-byte loads (each touching 32 sectors) and its own message
// schedule; it took 0.0150 ms, and 0.0156 ms at 16,384 lanes
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W). Now:
//
//   warp 1, the schedule warp, copies the block's 32 rows into shared
//          memory with cp.async (16-byte pieces, eight threads on each
//          row's 128 contiguous bytes of a message block), then computes
//          W[t] + K[t] one hand-over of 16 rounds at a time, from a ring
//          of the last 16 words in registers, into a ring of kRing = 4
//          hand-over buffers;
//   warp 0, the round warp, runs the 80 rounds of each message block,
//          reading W[t] + K[t] from shared memory (one load a round, 32
//          lanes on 32 consecutive words), then reduces the digest mod L.
//
// Buffer i is handed over by bar.arrive / bar.sync on named barrier
// kFullBarrier + i and handed back on kEmptyBarrier + i, so the schedule
// warp runs up to four hand-overs ahead and neither warp waits on the
// other in the steady state; a __syncthreads() lockstep a hand-over cost
// 0.0103 against 0.0099 ms (scripts/kernel_variants.py, NVIDIA H100 80GB
// HBM3, 700.00 W). Two message blocks are staged at a time: for B <= 2
// (the main path's challenges) every copy is issued before round 0, and a
// longer row refills a stage as soon as its words are in registers. One
// thread a lane doing both (scripts/kernel_alternatives.py, single) ran
// 0.0132 ms.
//
// Launch. 32 lanes a block, so 4,096 lanes are 128 blocks on 128 SMs, not
// 32; 64 threads and 24 KB of static shared memory a block. Rows n..m-1
// copy the pad row.
//
// Shared memory, 24,576 bytes a block:
//   stage [2][32 rows][8] uint4: a message block of each row; row r's
//         16-byte piece p sits at piece p ^ (r & 7), so the eight rows that
//         a quarter-warp's 16-byte reads cover fall in 32 distinct banks;
//         8 KB.
//   wk    [4][16 rounds][32 lanes] uint64: W + K; 16 KB.
//
// Reduction mod L. k mod L is unique, so any exact reduction gives the
// reference's bytes. The digest, read little-endian, is x < 2^512, eight
// 64-bit limbs (limb j = byte-swapped state word j). Barrett with b = 2^64
// and L < b^4 (Menezes, van Oorschot, Vanstone, Handbook of Applied
// Cryptography, algorithm 14.42): q = ((x >> 192) * mu) >> 320 with
// mu = floor(2^512 / L), r = (x - q L) mod 2^320, then at most two
// subtractions of L. Products are 64 x 64 -> 128-bit (mul and __umul64hi).
// The round warp runs it after its last round.
//
// Bound. Counted from this source, in 32-bit integer instructions a
// 128-byte block, taking the fewest the card needs: a round is three
// rotations each of the two big sigmas (6 funnel shifts each), their XORs
// (2 LOP3 each), Ch and Maj (2 LOP3 each), T1 as a five-term 64-bit sum
// (4 IADD3), T2, e and a (2 each): 30; a schedule step (t >= 16) is two
// small sigmas (two rotations and a shift, 6 shifts, 2 LOP3: 8 each) and a
// four-term sum (4): 20; the feed-forward is 8 64-bit adds (16). So a
// block is 80 x 30 + 64 x 20 + 16 = 3,696. An H100 SM issues 64 32-bit
// integer add, logic or shift instructions a clock (CUDA programming
// guide, compute capability 9.0), so the card needs lanes x B x 3,696 /
// (132 x 64 x clock): 0.00181 ms at 4,096 lanes x 2 blocks; the reduction
// and the loads are left out, so this stays a lower bound. Bytes: 128 a
// block in, 32 out. A lane's 160 rounds are one serial chain, and at 4,096
// lanes each SM holds one round warp, so the chain and the launch, not the
// SM's issue rate, set the time.
//
// The launcher returns cudaGetLastError() and never synchronizes.

#include <cstdint>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kLanes = kWarp;                // lanes per block
constexpr int kThreads = 2 * kWarp;          // the round warp, then the schedule warp
constexpr int kBlockBytes = 128;
constexpr int kChunk = 16;                   // rounds a hand-over
constexpr int kChunks = 80 / kChunk;         // hand-overs a 128-byte block
constexpr int kStages = 2;                   // message blocks staged at a time
constexpr int kRing = 4;                     // W + K buffers between the two warps
constexpr int kFullBarrier = 1;              // named barriers kFullBarrier + buffer
constexpr int kEmptyBarrier = kFullBarrier + kRing;

__constant__ uint64_t kRound[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full, 0xe9b5dba58189dbbcull,
    0x3956c25bf348b538ull, 0x59f111f1b605d019ull, 0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull,
    0xd807aa98a3030242ull, 0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull, 0xc19bf174cf692694ull,
    0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull, 0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull,
    0x2de92c6f592b0275ull, 0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full, 0xbf597fc7beef0ee4ull,
    0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull, 0x06ca6351e003826full, 0x142929670a0e6e70ull,
    0x27b70a8546d22ffcull, 0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull, 0x92722c851482353bull,
    0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull, 0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull,
    0xd192e819d6ef5218ull, 0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull, 0x34b0bcb5e19b48a8ull,
    0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull, 0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull,
    0x748f82ee5defb2fcull, 0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull, 0xc67178f2e372532bull,
    0xca273eceea26619cull, 0xd186b8c721c0c207ull, 0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull,
    0x06f067aa72176fbaull, 0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull, 0x431d67c49c100d4cull,
    0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull, 0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
};

__constant__ uint64_t kInit[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull,
    0x510e527fade682d1ull, 0x9b05688c2b3e6c1full, 0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull,
};

// L = 2^252 + 27742317777372353535851937790883648493, and mu = floor(2^512 / L),
// as little-endian 64-bit limbs.
__constant__ uint64_t kL[4] = {
    0x5812631a5cf5d3edull, 0x14def9dea2f79cd6ull, 0x0000000000000000ull, 0x1000000000000000ull,
};
__constant__ uint64_t kMu[5] = {
    0xed9ce5a30a2c131bull, 0x2106215d086329a7ull, 0xffffffffffffffebull, 0xffffffffffffffffull,
    0x000000000000000full,
};

__device__ __forceinline__ uint64_t rotr(uint64_t x, int r) { return (x >> r) | (x << (64 - r)); }

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  return (uint64_t(bswap32(static_cast<uint32_t>(x))) << 32) | bswap32(static_cast<uint32_t>(x >> 32));
}

// The big-endian word of bytes (lo, hi) as they lie in memory.
__device__ __forceinline__ uint64_t be64(uint32_t lo, uint32_t hi) {
  return (uint64_t(bswap32(lo)) << 32) | bswap32(hi);
}

__device__ __forceinline__ uint64_t big_sigma0(uint64_t a) {
  return rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
}
__device__ __forceinline__ uint64_t big_sigma1(uint64_t e) {
  return rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
}
__device__ __forceinline__ uint64_t small_sigma0(uint64_t w) {
  return rotr(w, 1) ^ rotr(w, 8) ^ (w >> 7);
}
__device__ __forceinline__ uint64_t small_sigma1(uint64_t w) {
  return rotr(w, 19) ^ rotr(w, 61) ^ (w >> 6);
}

struct Shared {
  // Message blocks of the block's 32 rows, row r's 16-byte chunk p at
  // chunk p ^ (r & 7) of its 128 bytes: eight rows' reads of one chunk
  // fall in 32 distinct banks.
  uint4 stage[kStages][kLanes][kBlockBytes / 16];
  uint64_t wk[kRing][kChunk][kLanes];  // W[t] + K[t], [hand-over % kRing][round][lane]
};

// Named barriers of the two warps (64 threads): the producer arrives, the
// consumer waits, and the memory written before the arrival is visible
// after the wait.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(kThreads) : "memory");
}

// The schedule warp copies message block `blk` of its rows into stage
// `blk % kStages`: 256 16-byte chunks, 8 a thread, eight threads a row, so
// every 128-byte row segment is read whole. Rows past n are not read.
__device__ __forceinline__ void stage_block(Shared& sh, const uint8_t* __restrict__ blocks,
                                            int nblocks, int row0, int n, int blk, int t) {
  if (blk < nblocks) {
#pragma unroll
    for (int i = 0; i < kLanes * kBlockBytes / 16 / kWarp; ++i) {
      const int idx = i * kWarp + t;
      const int r = idx / 8, p = idx % 8;
      if (row0 + r < n) {
        const uint8_t* src =
            blocks + (size_t(row0 + r) * nblocks + blk) * kBlockBytes + 16 * p;
        __pipeline_memcpy_async(&sh.stage[blk % kStages][r][p ^ (r & 7)], src, 16);
      }
    }
  }
  __pipeline_commit();  // an empty group past the last block keeps the count
}

// Hand-over g of the schedule: W[t] + K[t] for t = 16 (g % 5) + i, i < 16,
// of message block g / 5, into wk[i * stride]. w is the thread's ring of
// the last 16 words (w[t & 15] holds W[t - 16] until it is replaced).
__device__ __forceinline__ void schedule(Shared& sh, const uint8_t* __restrict__ blocks,
                                         int nblocks, int row0, int n, int g, int t,
                                         uint64_t w[16], uint64_t* wk, int stride) {
  const int blk = g / kChunks, j = g % kChunks;
  if (j == 0) {
    __pipeline_wait_prior(kStages - 1);  // block blk's copies are done
    __syncwarp();
    const uint4* row = sh.stage[blk % kStages][t];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const uint4 v = row[p ^ (t & 7)];
      w[2 * p] = be64(v.x, v.y);
      w[2 * p + 1] = be64(v.z, v.w);
    }
    __syncwarp();  // every row read before the stage is refilled
    stage_block(sh, blocks, nblocks, row0, n, blk + kStages, t);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) wk[i * stride] = w[i] + kRound[i];
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      w[i] += small_sigma0(w[(i + 1) & 15]) + small_sigma1(w[(i + 14) & 15]) + w[(i + 9) & 15];
      wk[i * stride] = w[i] + kRound[kChunk * j + i];
    }
  }
}

// Hand-over g of the rounds: 16 rounds on s (a..h) with W + K read from
// wk[i * stride]; the state st takes the feed-forward after a block's
// last hand-over.
__device__ __forceinline__ void rounds(const uint64_t* wk, int stride, int g, uint64_t s[8],
                                       uint64_t st[8]) {
  if (g % kChunks == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = st[i];
  }
  uint64_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], gg = s[6], h = s[7];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const uint64_t t1 = h + big_sigma1(e) + ((e & f) ^ (~e & gg)) + wk[i * stride];
    const uint64_t t2 = big_sigma0(a) + ((a & b) ^ (a & c) ^ (b & c));
    h = gg;
    gg = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  s[0] = a, s[1] = b, s[2] = c, s[3] = d, s[4] = e, s[5] = f, s[6] = gg, s[7] = h;
  if (g % kChunks == kChunks - 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] += s[i];
  }
}

// r[0 .. NA + NB) = a * b, schoolbook with 128-bit partial products. Each
// step adds a full product, the old column and the carry: at most
// (2^64 - 1)^2 + 2 (2^64 - 1) = 2^128 - 1, so the high word never wraps.
template <int NA, int NB>
__device__ __forceinline__ void mul_wide(const uint64_t* a, const uint64_t* b, uint64_t* r) {
#pragma unroll
  for (int i = 0; i < NA + NB; ++i) r[i] = 0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint64_t lo = a[i] * b[j];
      uint64_t hi = __umul64hi(a[i], b[j]);
      const uint64_t old = r[i + j];
      lo += old;
      hi += lo < old;
      lo += carry;
      hi += lo < carry;
      r[i + j] = lo;
      carry = hi;
    }
    r[i + NB] = carry;
  }
}

// r <- r - L over 5 limbs when r >= L.
__device__ __forceinline__ void sub_l_if_ge(uint64_t r[5]) {
  uint64_t d[5];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uint64_t li = i < 4 ? kL[i] : 0;
    const uint64_t t = r[i] - li;
    const uint64_t b1 = r[i] < li;
    d[i] = t - borrow;
    borrow = b1 | (t < borrow);
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) r[i] = borrow ? r[i] : d[i];
}

// x (8 little-endian limbs, < 2^512) mod L -> r[0..4).
__device__ __forceinline__ void reduce_mod_l(const uint64_t x[8], uint64_t out[4]) {
  uint64_t mu[5], l4[4];
#pragma unroll
  for (int i = 0; i < 5; ++i) mu[i] = kMu[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) l4[i] = kL[i];
  uint64_t q2[10];
  mul_wide<5, 5>(x + 3, mu, q2);          // (x >> 192) * mu
  uint64_t ql[9];
  mul_wide<5, 4>(q2 + 5, l4, ql);         // q = q2 >> 320; q * L
  uint64_t r[5];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {           // (x - q L) mod 2^320
    const uint64_t t = x[i] - ql[i];
    const uint64_t b1 = x[i] < ql[i];
    r[i] = t - borrow;
    borrow = b1 | (t < borrow);
  }
  sub_l_if_ge(r);
  sub_l_if_ge(r);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = r[i];
}

// Block = 32 lanes: warp 0 runs the rounds, warp 1 stages the rows and
// computes the message schedule up to kRing hand-overs (16 rounds each)
// ahead; buffer i is handed over by named barrier kFullBarrier + i and
// handed back by kEmptyBarrier + i. Lanes past n (and below m) copy the
// pad row; the others hash their row and reduce the digest mod L.
__global__ void __launch_bounds__(kThreads) sha512_challenge_kernel(
    const uint8_t* __restrict__ blocks, int nblocks, int n, const uint8_t* __restrict__ pad_row,
    uint8_t* __restrict__ out, int m) {
  __shared__ Shared sh;
  const int t = threadIdx.x & (kWarp - 1);
  const int row0 = blockIdx.x * kLanes;
  const int hand_overs = kChunks * nblocks;
  if (threadIdx.x >= kWarp) {
    uint64_t w[16];
#pragma unroll
    for (int blk = 0; blk < kStages; ++blk) stage_block(sh, blocks, nblocks, row0, n, blk, t);
#pragma unroll 1
    for (int g = 0; g < hand_overs; ++g) {
      const int i = g % kRing;
      if (g >= kRing) bar_sync(kEmptyBarrier + i);
      schedule(sh, blocks, nblocks, row0, n, g, t, w, &sh.wk[i][0][t], kLanes);
      bar_arrive(kFullBarrier + i);
    }
    return;
  }
  uint64_t s[8], st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = kInit[i];
#pragma unroll 1
  for (int g = 0; g < hand_overs; ++g) {
    const int i = g % kRing;
    bar_sync(kFullBarrier + i);
    rounds(&sh.wk[i][0][t], kLanes, g, s, st);
    if (g + kRing < hand_overs) bar_arrive(kEmptyBarrier + i);
  }
  const int lane = row0 + t;
  if (lane >= m) return;
  if (lane >= n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) out[32 * size_t(lane) + i] = pad_row[i];
    return;
  }
  // Limb j of the little-endian digest value is state word j byte-swapped
  // (stored little-endian, it is the word's big-endian bytes).
  uint64_t x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = bswap64(st[i]);
  uint64_t k[4];
  reduce_mod_l(x, k);
  uint64_t* o = reinterpret_cast<uint64_t*>(out + 32 * size_t(lane));
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = k[i];
}

inline int grid(int lanes) { return (lanes + kLanes - 1) / kLanes; }

}  // namespace

// blocks: (n, nblocks * 128) uint8, 16-byte aligned; out: (m, 32) uint8,
// m >= n; pad_row: 32 bytes (read only when m > n).
extern "C" int sha512_challenge_launch(const void* blocks, int nblocks, int n, const void* pad_row,
                                       void* out, int m, void* stream) {
  if (m <= 0) return 0;
  sha512_challenge_kernel<<<grid(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), nblocks, n, static_cast<const uint8_t*>(pad_row),
      static_cast<uint8_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

// Launch facts of the challenge kernel on the current device, in the
// order of ed25519_kernel_attributes: registers a thread, local (stack)
// bytes a thread, static shared bytes a block, threads a block, lanes a
// block, blocks resident on an SM.
extern "C" int sha512_challenge_attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, sha512_challenge_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, sha512_challenge_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = kThreads;
  out[4] = kLanes;
  out[5] = resident;
  return 0;
}
