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
// Design: one thread a lane, on native uint64_t words. The TPU kernel held
// a word as a (hi, lo) pair of uint32 vectors; here a 64-bit rotation is
// two funnel shifts and a three-input XOR one LOP3 a half. The 80 round
// constants sit in __constant__ memory: every thread of a warp reads the
// same one in each round, which the constant cache broadcasts. The
// message schedule is a ring of 16 words in registers (w[t & 15]), the 80
// rounds are unrolled so every ring index is a constant, and the block
// loop runs over B, an argument. Words load as 8-byte big-endian reads
// (rows are 8-byte aligned: the wrapper checks).
//
// Reduction mod L. k mod L is unique, so any exact reduction gives the
// reference's bytes. The digest, read little-endian, is x < 2^512, eight
// 64-bit limbs (limb j = byte-swapped state word j). Barrett with b = 2^64
// and L < b^4 (Menezes, van Oorschot, Vanstone, Handbook of Applied
// Cryptography, algorithm 14.42): q = ((x >> 192) * mu) >> 320 with
// mu = floor(2^512 / L), r = (x - q L) mod 2^320, then at most two
// subtractions of L. Products are 64 x 64 -> 128-bit (mul and __umul64hi).
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
// (132 x 64 x clock); the reduction (45 wide products) and the loads are
// left out, so this stays a lower bound. Bytes: 128 a block in, 32 out.
// A 4,096-lane chunk is 128 warps in 32 blocks of 128 threads, one warp
// on each scheduler of 32 SMs, so each thread's serial chain of rounds
// sets the time, far above the bound.
//
// The launcher returns cudaGetLastError() and never synchronizes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockBytes = 128;

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

// The big-endian word at p (8-byte aligned).
__device__ __forceinline__ uint64_t load_be64(const uint8_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return (uint64_t(bswap32(v.x)) << 32) | bswap32(v.y);
}

__device__ __forceinline__ void compress(uint64_t st[8], const uint8_t* __restrict__ blk) {
  uint64_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = load_be64(blk + 8 * i);
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    if (t >= 16) {  // w[t & 15] holds w[t - 16]
      const uint64_t w15 = w[(t - 15) & 15];
      const uint64_t w2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr(w15, 1) ^ rotr(w15, 8) ^ (w15 >> 7);
      const uint64_t s1 = rotr(w2, 19) ^ rotr(w2, 61) ^ (w2 >> 6);
      w[t & 15] += s0 + s1 + w[(t - 7) & 15];
    }
    const uint64_t t1 = h + (rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41)) + ((e & f) ^ (~e & g)) +
                        kRound[t] + w[t & 15];
    const uint64_t t2 = (rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39)) + ((a & b) ^ (a & c) ^ (b & c));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
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

// Lanes past n (and below m) copy the pad row; the others hash their row
// and reduce the digest mod L.
__global__ void __launch_bounds__(kThreads) sha512_challenge_kernel(
    const uint8_t* __restrict__ blocks, int nblocks, int n, const uint8_t* __restrict__ pad_row,
    uint8_t* __restrict__ out, int m) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= m) return;
  if (lane >= n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) out[32 * size_t(lane) + i] = pad_row[i];
    return;
  }
  uint64_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = kInit[i];
  const uint8_t* row = blocks + size_t(lane) * nblocks * kBlockBytes;
#pragma unroll 1
  for (int blk = 0; blk < nblocks; ++blk) compress(st, row + kBlockBytes * blk);
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

inline int grid(int lanes) { return (lanes + kThreads - 1) / kThreads; }

}  // namespace

// blocks: (n, nblocks * 128) uint8; out: (m, 32) uint8, m >= n; pad_row:
// 32 bytes (read only when m > n).
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
  out[4] = kThreads;
  out[5] = resident;
  return 0;
}
