// Batched Ed25519 ZIP-215 verification on Hopper (sm_90a): two kernels.
//
// What each entry point replaces (tendermint_tpu/ops/pallas_verify.py):
//   ed25519_verify_kernel        <- _verify_kernel (via verify_fn /
//                                   compiled_verify): decompress A and R,
//                                   build the [1..8](-A) lane table, run
//                                   the Straus loop, finish.
//   ed25519_verify_tables_kernel <- _verify_tables_kernel (via
//                                   verify_tables_fn / compiled_verify_tables):
//                                   the lane table arrives as canonical
//                                   (8, 4, 32, N) uint8 limbs; only R is
//                                   decompressed.
// Both compute, per lane, [8]([s]B - R - [k]A) == identity with liberal
// decompression (y >= p accepted, x == 0 with sign 1 rejected), exactly as
// tendermint_tpu_torch/ops/ed25519_batch.verify_kernel{,_tables} do; the
// host ANDs in s < L. s and k must be < 2^253 for the signed recode.
//
// Design. One thread per lane; nothing is shared between lanes except the
// constant tables. The TPU kernel used f32 radix-2^8 limbs because its VPU
// has no wide integer multiply; here a field element is 10 int32 limbs of
// 26/25 bits (the ref10 layout, value = sum v[i] * 2^ceil(25.5 i)) and a
// product is 100 32x32->64-bit multiply-adds into int64 columns. All
// limbs stay non-negative: subtraction adds 2p, and every add, sub and mul
// ends in one carry pass, so "loose" limbs are < 2^26 (even) and
// <= 2^25 + 2^14 (odd). Products of loose limbs with the x2 (odd*odd) and
// x19 (wrap) factors stay < 2^56.3, so a column of 10 is < 2^60.
//
// Memory. The inputs are raw bytes: the kernel strips sign bit 255 of A
// and R and recodes s and k into 64 signed 4-bit digits itself, so the
// host uploads only (N, 32) uint8 rows (and, for K2, the table and a_ok).
// The [1..8]B Niels table and d, sqrt(-1), 2d are decoded once per block
// into shared memory (lanes index the table by different digits, so
// __constant__ would serialize). The lane's [1..8](-A) cached table
// (8 x 4 x 10 int32 = 1280 B) and the two digit strings (128 B) are
// indexed by data, so they live in local memory, cached by L1: in
// shared memory they would cap a block at a few dozen lanes for no gain
// in a kernel whose time is multiplies. K2 reads its lane's table column
// once, coalesced (adjacent threads read adjacent bytes), and converts the
// canonical radix-2^8 limbs to this representation.
//
// Bound. Per lane, in field squarings S and multiplies M: a decompression
// is 255 S + 19 M (pow22523 251 S + 11 M), K1's table build 64 M, each of
// the 64 windows 4 doublings (4 S + 4 M each), a madd (7 M) and a lane-table
// add: 8 M in K1, 7 M in K2, whose host-built entries have Z = 1 so the add
// is a mixed one; the finish is 12 S + 21 M. So K1 needs 1,546 S + 2,107 M
// and K2 1,291 S + 1,960 M (the multiply by sqrt(-1) that some
// decompressions take is left out). A multiply is 100 wide 32x32->64-bit
// products and a squaring 55, each wide product two 32-bit multiplies, and
// an H100 SM retires 64 32-bit integer multiplies per clock (CUDA
// programming guide, compute capability 9.0), so the card is bound by its
// integer multiply rate: at 132 SMs and 1.98 GHz, 4,096 lanes need at
// least 0.145 ms (K1) and 0.131 ms (K2). Bytes are negligible (129 B per
// K1 lane, 8 x 4 x 32 + 1 + 3 x 32 + 1 = 1,122 B per K2 lane). With one
// thread per lane a 4,096-lane chunk fills 128 warps, one per SM, so the
// kernel runs far from that bound; splitting a lane over several threads
// is the next step.
//
// Each launcher returns cudaGetLastError() and never synchronizes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NL = 10;
constexpr int kThreads = 32;
constexpr int kNumConsts = 27;  // 8 x 3 Niels limbs of [1..8]B, then d, sqrt(-1), 2d
constexpr int kConstD = 24;
constexpr int kConstSqrtM1 = 25;
constexpr int kConstD2 = 26;

struct fe { int32_t v[NL]; };
struct ge { fe X, Y, Z, T; };                 // extended coordinates
struct ge_cached { fe YpX, YmX, Z, T2d; };    // (Y+X, Y-X, Z, 2dT)
struct ge_niels { fe YpX, YmX, T2d; };        // affine, Z = 1

__device__ __forceinline__ int width(int i) { return (i & 1) ? 25 : 26; }

// 2p in this radix: every limb >= the largest loose limb of the same
// parity, so a + 2p - b is limb-wise non-negative.
__device__ __forceinline__ int32_t two_p(int i) {
  return i == 0 ? 0x7FFFFDA : ((i & 1) ? 0x3FFFFFE : 0x7FFFFFE);
}

// One carry pass over non-negative 32-bit limbs below 2^29.
__device__ __forceinline__ fe carry32(int32_t h[NL]) {
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) {
    const int32_t c = h[i] >> width(i);
    h[i] &= (1 << width(i)) - 1;
    h[i + 1] += c;
  }
  int32_t c = h[9] >> 25;
  h[9] &= (1 << 25) - 1;
  h[0] += 19 * c;
  c = h[0] >> 26;
  h[0] &= (1 << 26) - 1;
  h[1] += c;
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = h[i];
  return r;
}

// One carry pass over non-negative 64-bit columns below 2^62.
__device__ __forceinline__ fe carry64(int64_t h[NL]) {
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) {
    const int64_t c = h[i] >> width(i);
    h[i] &= (int64_t(1) << width(i)) - 1;
    h[i + 1] += c;
  }
  int64_t c = h[9] >> 25;
  h[9] &= (int64_t(1) << 25) - 1;
  h[0] += 19 * c;
  c = h[0] >> 26;
  h[0] &= (int64_t(1) << 26) - 1;
  h[1] += c;
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = static_cast<int32_t>(h[i]);
  return r;
}

__device__ __forceinline__ fe fe_const(int32_t x) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = 0;
  r.v[0] = x;
  return r;
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  int32_t h[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) h[i] = a.v[i] + b.v[i];
  return carry32(h);
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  int32_t h[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) h[i] = a.v[i] + two_p(i) - b.v[i];
  return carry32(h);
}

__device__ __forceinline__ fe fe_neg(const fe& a) {
  int32_t h[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) h[i] = two_p(i) - a.v[i];
  return carry32(h);
}

// Limb i * limb j lands in column i + j with weight x2 when both are odd
// (2^ceil(25.5 i) * 2^ceil(25.5 j) = 2 * 2^ceil(25.5 (i + j))) and x19
// when i + j >= 10 (2^255 = 19 mod p).
__device__ __forceinline__ fe fe_mul(const fe& f, const fe& g) {
  int32_t g19[NL], f2[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    g19[i] = 19 * g.v[i];
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  }
  int64_t h[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int32_t fi = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      const int32_t gj = (i + j >= NL) ? g19[j] : g.v[j];
      h[(i + j) % NL] += static_cast<int64_t>(fi) * gj;
    }
  }
  return carry64(h);
}

// fe_mul(f, f) with each off-diagonal product taken once and doubled: 55
// wide products instead of 100. The columns equal fe_mul's, so its bounds
// hold; a scaled limb is at most 4 * (2^25 + 2^14) and fits in int32.
__device__ __forceinline__ fe fe_sq(const fe& f) {
  int32_t f19[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) f19[i] = 19 * f.v[i];
  int64_t h[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = i; j < NL; ++j) {
      const int scale = (j == i ? 1 : 2) * (((i & 1) && (j & 1)) ? 2 : 1);
      const int32_t fi = scale * f.v[i];
      const int32_t fj = (i + j >= NL) ? f19[j] : f.v[j];
      h[(i + j) % NL] += static_cast<int64_t>(fi) * fj;
    }
  }
  return carry64(h);
}

__device__ fe fe_sqn(fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = fe_sq(a);
  return a;
}

// Canonical limbs of a loose element: value in [0, p), every limb exact.
__device__ void fe_canon(const fe& a, int32_t t[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = a.v[i];
  // Two ripple passes: value < 2^255, limbs exact (after the second
  // fold the residue is tiny, so limb 0 stays below 2^26).
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < NL - 1; ++i) {
      t[i + 1] += t[i] >> width(i);
      t[i] &= (1 << width(i)) - 1;
    }
    const int32_t c = t[9] >> 25;
    t[9] &= (1 << 25) - 1;
    t[0] += 19 * c;
  }
  // q = 1 iff value + 19 >= 2^255 iff value >= p; then subtract q * p.
  int32_t q = (t[0] + 19) >> 26;
#pragma unroll
  for (int i = 1; i < NL; ++i) q = (t[i] + q) >> width(i);
  t[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) {
    t[i + 1] += t[i] >> width(i);
    t[i] &= (1 << width(i)) - 1;
  }
  t[9] &= (1 << 25) - 1;
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  int32_t t[NL];
  fe_canon(a, t);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= t[i];
  return acc == 0;
}

// 32 little-endian bytes -> limbs, bit 255 dropped (a value < 2^255, so
// the limbs are exact and y >= p stays accepted).
__device__ __forceinline__ fe fe_frombytes(const uint8_t b[32]) {
  fe r;
  int off = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int by = off >> 3;
    const uint32_t w = uint32_t(b[by]) | (uint32_t(b[by + 1]) << 8) |
                       (uint32_t(b[by + 2]) << 16) | (uint32_t(b[by + 3]) << 24);
    r.v[i] = static_cast<int32_t>((w >> (off & 7)) & ((1u << width(i)) - 1));
    off += width(i);
  }
  return r;
}

__device__ fe fe_pow22523(const fe& z) {
  fe t0 = fe_sq(z);                   // z^2
  fe t1 = fe_mul(z, fe_sqn(t0, 2));   // z^9
  t0 = fe_mul(t0, t1);                // z^11
  t0 = fe_sq(t0);                     // z^22
  t0 = fe_mul(t1, t0);                // z^(2^5 - 1)
  t1 = fe_sqn(t0, 5);
  t0 = fe_mul(t1, t0);                // z^(2^10 - 1)
  t1 = fe_sqn(t0, 10);
  t1 = fe_mul(t1, t0);                // z^(2^20 - 1)
  fe t2 = fe_sqn(t1, 20);
  t1 = fe_mul(t2, t1);                // z^(2^40 - 1)
  t1 = fe_sqn(t1, 10);
  t0 = fe_mul(t1, t0);                // z^(2^50 - 1)
  t1 = fe_sqn(t0, 50);
  t1 = fe_mul(t1, t0);                // z^(2^100 - 1)
  t2 = fe_sqn(t1, 100);
  t1 = fe_mul(t2, t1);                // z^(2^200 - 1)
  t1 = fe_sqn(t1, 50);
  t0 = fe_mul(t1, t0);                // z^(2^250 - 1)
  t0 = fe_sqn(t0, 2);                 // z^(2^252 - 4)
  return fe_mul(t0, z);               // z^(2^252 - 3)
}

// --- curve ------------------------------------------------------------------

__device__ __forceinline__ ge ge_identity() {
  return ge{fe_const(0), fe_const(1), fe_const(1), fe_const(0)};
}

__device__ __forceinline__ ge ge_neg(const ge& p) {
  return ge{fe_neg(p.X), p.Y, p.Z, fe_neg(p.T)};
}

__device__ __forceinline__ ge_cached ge_to_cached(const ge& p, const fe& d2) {
  return ge_cached{fe_add(p.Y, p.X), fe_sub(p.Y, p.X), p.Z, fe_mul(p.T, d2)};
}

// E, F, G, H -> (EF, GH, FG, EH).
__device__ __forceinline__ ge ge_finish(const fe& a, const fe& b, const fe& c, const fe& d2) {
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(d2, c);
  const fe g = fe_add(d2, c);
  const fe h = fe_add(b, a);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// Unified a=-1 addition against a cached operand (add-2008-hwcd-3).
__device__ ge ge_add_cached(const ge& p, const ge_cached& q) {
  const fe a = fe_mul(fe_sub(p.Y, p.X), q.YmX);
  const fe b = fe_mul(fe_add(p.Y, p.X), q.YpX);
  const fe c = fe_mul(p.T, q.T2d);
  const fe d = fe_mul(p.Z, q.Z);
  return ge_finish(a, b, c, fe_add(d, d));
}

// Mixed addition with an affine Niels operand (Z2 = 1).
__device__ ge ge_madd(const ge& p, const ge_niels& q) {
  const fe a = fe_mul(fe_sub(p.Y, p.X), q.YmX);
  const fe b = fe_mul(fe_add(p.Y, p.X), q.YpX);
  const fe c = fe_mul(p.T, q.T2d);
  return ge_finish(a, b, c, fe_add(p.Z, p.Z));
}

// dbl-2008-hwcd, valid for all inputs.
__device__ ge ge_double(const ge& p) {
  const fe a = fe_sq(p.X);
  const fe b = fe_sq(p.Y);
  const fe zz = fe_sq(p.Z);
  const fe sxy = fe_sq(fe_add(p.X, p.Y));
  const fe c = fe_add(zz, zz);
  const fe h = fe_add(a, b);
  const fe e = fe_sub(h, sxy);
  const fe g = fe_sub(a, b);
  const fe f = fe_add(c, g);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

__device__ bool ge_is_identity(const ge& p) {
  return fe_is_zero(p.X) && fe_is_zero(fe_sub(p.Y, p.Z));
}

// Liberal (ZIP-215) decompression of a 32-byte encoding; an invalid lane
// gets the identity and false.
__device__ bool ge_decompress(const uint8_t b[32], const fe& d, const fe& sqrtm1, ge* out) {
  const int sign = b[31] >> 7;
  const fe y = fe_frombytes(b);
  const fe one = fe_const(1);
  const fe y2 = fe_sq(y);
  const fe u = fe_sub(y2, one);
  const fe v = fe_add(fe_mul(y2, d), one);
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
  const fe vx2 = fe_mul(v, fe_sq(x));
  const bool root1 = fe_is_zero(fe_sub(vx2, u));
  const bool root2 = fe_is_zero(fe_add(vx2, u));
  if (root2) x = fe_mul(x, sqrtm1);
  int32_t xt[NL];
  fe_canon(x, xt);
  int32_t xz = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) xz |= xt[i];
  const bool valid = (root1 || root2) && !(xz == 0 && sign == 1);
  if ((xt[0] & 1) != sign) x = fe_neg(x);
  *out = valid ? ge{x, y, one, fe_mul(x, y)} : ge_identity();
  return valid;
}

// Signed radix-16 recode of a little-endian scalar < 2^253: z = x + 0x88..88
// with the carry-out dropped, digit i (most significant first) = nibble - 8.
__device__ void recode(const uint8_t* x, int8_t dig[64]) {
  int carry = 0;
#pragma unroll 1
  for (int i = 0; i < 32; ++i) {
    const int t = x[i] + 0x88 + carry;
    carry = t >> 8;
    dig[63 - 2 * i] = static_cast<int8_t>((t & 15) - 8);
    dig[62 - 2 * i] = static_cast<int8_t>(((t >> 4) & 15) - 8);
  }
}

__device__ __forceinline__ ge_niels select_b(const fe* sc, int digit) {
  if (digit == 0) return ge_niels{fe_const(1), fe_const(1), fe_const(0)};
  const int row = 3 * ((digit < 0 ? -digit : digit) - 1);
  ge_niels r{sc[row], sc[row + 1], sc[row + 2]};
  if (digit < 0) r = ge_niels{r.YmX, r.YpX, fe_neg(r.T2d)};
  return r;
}

__device__ __forceinline__ ge_cached select_lane(const ge_cached* tab, int digit) {
  if (digit == 0) return ge_cached{fe_const(1), fe_const(1), fe_const(1), fe_const(0)};
  ge_cached r = tab[(digit < 0 ? -digit : digit) - 1];
  if (digit < 0) r = ge_cached{r.YmX, r.YpX, r.Z, fe_neg(r.T2d)};
  return r;
}

// [s]B - [k]A: 64 windows of 4 doublings, + d_s * B, + d_k * (-A). With
// kAffine every lane-table entry has Z = 1, and its add is a mixed one.
template <bool kAffine>
__device__ ge straus(const ge_cached* tab, const int8_t* sd, const int8_t* kd, const fe* sc) {
  ge acc = ge_identity();
#pragma unroll 1
  for (int i = 0; i < 64; ++i) {
#pragma unroll 1
    for (int j = 0; j < 4; ++j) acc = ge_double(acc);
    acc = ge_madd(acc, select_b(sc, sd[i]));
    const ge_cached q = select_lane(tab, kd[i]);
    acc = kAffine ? ge_madd(acc, ge_niels{q.YpX, q.YmX, q.T2d}) : ge_add_cached(acc, q);
  }
  return acc;
}

// Subtract R, multiply by the cofactor, test for the identity.
__device__ bool finish(ge acc, const ge& r, const fe& d2) {
  acc = ge_add_cached(acc, ge_to_cached(ge_neg(r), d2));
#pragma unroll 1
  for (int j = 0; j < 3; ++j) acc = ge_double(acc);
  return ge_is_identity(acc);
}

__device__ __forceinline__ void load_consts(const uint8_t* __restrict__ consts, fe* sc) {
  for (int i = threadIdx.x; i < kNumConsts; i += blockDim.x) sc[i] = fe_frombytes(consts + 32 * i);
  __syncthreads();
}

__device__ __forceinline__ void load_row(const uint8_t* __restrict__ src, uint8_t dst[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads) ed25519_verify_kernel(
    const uint8_t* __restrict__ pk, const uint8_t* __restrict__ r,
    const uint8_t* __restrict__ s, const uint8_t* __restrict__ k,
    const uint8_t* __restrict__ consts, uint8_t* __restrict__ out, int n) {
  __shared__ fe sc[kNumConsts];
  load_consts(consts, sc);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  uint8_t row[32];
  ge a, rp;
  load_row(pk + 32 * size_t(lane), row);
  const bool a_ok = ge_decompress(row, sc[kConstD], sc[kConstSqrtM1], &a);
  load_row(r + 32 * size_t(lane), row);
  const bool r_ok = ge_decompress(row, sc[kConstD], sc[kConstSqrtM1], &rp);

  // Lane table: entry t is (t + 1)(-A) in cached form.
  ge_cached tab[8];
  const ge neg_a = ge_neg(a);
  tab[0] = ge_to_cached(neg_a, sc[kConstD2]);
  ge acc = neg_a;
#pragma unroll 1
  for (int t = 1; t < 8; ++t) {
    acc = ge_add_cached(acc, tab[0]);
    tab[t] = ge_to_cached(acc, sc[kConstD2]);
  }

  int8_t sd[64], kd[64];
  recode(s + 32 * size_t(lane), sd);
  recode(k + 32 * size_t(lane), kd);
  acc = straus<false>(tab, sd, kd, sc);
  out[lane] = (finish(acc, rp, sc[kConstD2]) && a_ok && r_ok) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads) ed25519_verify_tables_kernel(
    const uint8_t* __restrict__ tab_in, const uint8_t* __restrict__ a_ok,
    const uint8_t* __restrict__ r, const uint8_t* __restrict__ s,
    const uint8_t* __restrict__ k, const uint8_t* __restrict__ consts,
    uint8_t* __restrict__ out, int n) {
  __shared__ fe sc[kNumConsts];
  load_consts(consts, sc);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  // Column `lane` of the (8, 4, 32, N) table: byte (t, c, l) sits at
  // ((t * 4 + c) * 32 + l) * N + lane, so a warp reads 32 adjacent bytes.
  // zdiff stays 0 iff every entry's Z is the bytes of 1 (host-built tables).
  ge_cached tab[8];
  uint8_t row[32];
  uint32_t zdiff = 0;
#pragma unroll 1
  for (int t = 0; t < 8; ++t) {
    fe comp[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint8_t* col = tab_in + size_t((t * 4 + c) * 32) * n + lane;
#pragma unroll
      for (int l = 0; l < 32; ++l) row[l] = col[size_t(l) * n];
      if (c == 2) {
#pragma unroll
        for (int l = 0; l < 32; ++l) zdiff |= row[l] ^ (l == 0 ? 1u : 0u);
      }
      comp[c] = fe_frombytes(row);
    }
    tab[t] = ge_cached{comp[0], comp[1], comp[2], comp[3]};
  }

  ge rp;
  load_row(r + 32 * size_t(lane), row);
  const bool r_ok = ge_decompress(row, sc[kConstD], sc[kConstSqrtM1], &rp);
  int8_t sd[64], kd[64];
  recode(s + 32 * size_t(lane), sd);
  recode(k + 32 * size_t(lane), kd);
  const ge acc = zdiff == 0 ? straus<true>(tab, sd, kd, sc) : straus<false>(tab, sd, kd, sc);
  out[lane] = (finish(acc, rp, sc[kConstD2]) && a_ok[lane] != 0 && r_ok) ? 1 : 0;
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int ed25519_verify_launch(const void* pk, const void* r, const void* s,
                                     const void* k, const void* consts, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  ed25519_verify_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pk), static_cast<const uint8_t*>(r),
      static_cast<const uint8_t*>(s), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(consts), static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ed25519_verify_tables_launch(const void* tab, const void* a_ok, const void* r,
                                            const void* s, const void* k, const void* consts,
                                            void* out, int n, void* stream) {
  if (n <= 0) return 0;
  ed25519_verify_tables_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tab), static_cast<const uint8_t*>(a_ok),
      static_cast<const uint8_t*>(r), static_cast<const uint8_t*>(s),
      static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(consts),
      static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
