// Batched Ed25519 ZIP-215 and sr25519 verification on Hopper (sm_90a): four
// kernels.
//
// What each entry point replaces:
//   ed25519_verify_kernel          <- tendermint_tpu/ops/pallas_verify.py
//                                     _verify_kernel (via verify_fn /
//                                     compiled_verify): decompress A and R,
//                                     build the [1..8](-A) lane table, run
//                                     the Straus loop, finish.
//   ed25519_verify_tables_kernel   <- pallas_verify.py _verify_tables_kernel
//                                     (via verify_tables_fn /
//                                     compiled_verify_tables): the lane table
//                                     arrives as canonical (8, 4, 32, N)
//                                     uint8 limbs; only R is decompressed.
//   ed25519_verify_resident_kernel <- tendermint_tpu/ops/ed25519_batch.py
//                                     verify_kernel_resident (an XLA graph,
//                                     jnp.take then the table kernel): K2
//                                     with each lane's table read from
//                                     column idx[lane] of the resident
//                                     (8, 4, 32, K) store, the gather folded
//                                     into K2's table loads.
//   sr25519_verify_kernel (K5)     <- tendermint_tpu/ops/sr25519_batch.py
//                                     verify_kernel_sr (an XLA graph):
//                                     K1's body with ristretto255 DECODE in
//                                     place of ed25519 decompression and the
//                                     identity-coset test in place of the
//                                     cofactored finish (see K5 below).
// K1-K3 compute, per lane, [8]([s]B - R - [k]A) == identity with liberal
// decompression (y >= p accepted, x == 0 with sign 1 rejected), exactly as
// tendermint_tpu_torch/ops/ed25519_batch.verify_kernel{,_tables,_resident}
// do; the host ANDs in s < L. s and k must be < 2^253 for the signed recode.
//
// Field. The TPU kernel used f32 radix-2^8 limbs because its VPU has no
// wide integer multiply; here a field element is 10 int32 limbs of 26/25
// bits (the ref10 layout, value = sum v[i] * 2^ceil(25.5 i)) and a product
// is 100 32x32->64-bit multiply-adds into int64 columns. All limbs stay
// non-negative: subtraction adds 2p, and every add, sub and mul ends in one
// carry pass, so "loose" limbs are < 2^26 (even) and < 2^25 + 2^15 (odd),
// at most 2p's limbs. One operand skips its carry pass: the left factor of
// round 2 (D4, A4) and of A2 (fe_lin_nc, u + w + 2p - z uncarried), whose
// limbs stay below 3 * 2^27 (even) and 3 * 2^26 + 2^18 (odd), the right
// factor being loose. Then every int32 factor (x2 for odd * odd, x19 for a
// wrapped column) is below 2^31, a column below 2^61.6 (2^59 for two loose
// factors), under the 2^62 that carry64 takes, and the fold leaves at most
// 2^14.8 for limb 1. (Worst cases computed limb by limb; the terms
// subtracted, z, are never the doubled p2, so 2p - z >= 0.)
//
// Bound. Per lane, in field squarings S and multiplies M: a decompression
// is 255 S + 19 M (pow22523 251 S + 11 M), K1's table build 64 M, each of
// the 64 windows 4 doublings (4 S + 4 M each), a madd (7 M) and a lane-table
// add: 8 M in K1, 7 M in K2 and K3, whose host-built entries have Z = 1 so
// the add is a mixed one; the finish is 12 S + 21 M. So K1 needs 1,546 S +
// 2,107 M and K2 and K3 1,291 S + 1,960 M (the multiply by sqrt(-1) that some
// decompressions take is left out). A multiply is 100 wide 32x32->64-bit
// products and a squaring 55, each wide product two 32-bit multiplies, and
// an H100 SM retires 64 32-bit integer multiplies per clock (CUDA
// programming guide, compute capability 9.0), so the card is bound by its
// integer multiply rate: at 132 SMs and 1.98 GHz, 4,096 lanes need at
// least 0.145 ms (K1) and 0.131 ms (K2, K3). The comb below does a little
// more than the Straus half it replaces: each B warp's 4 doublings (3 x
// (16 S + 16 M) a lane) and the quads' three adds of its parts (3 x 8 M +
// 3 M of conversion), about 1.5% of the count, which the bound leaves out
// so that it compares across designs. Bytes are negligible (129 B per K1
// lane, 8 x 4 x 32 + 1 + 3 x 32 + 1 = 1,122 B per K2 lane, and 4 more for
// K3's index). K3's loads coalesce as K2's when a chunk's indices run
// consecutively (a commit's store columns follow the set's order) and
// scatter when they do not; a 10,001-column store is 10 MB and sits in the
// 50 MB L2.
//
// Design: warps with one job each. A block carries 32 lanes:
//
//   warps 0-3  the quads: four threads a lane run [k](-A), 64 windows of 4
//              doublings and a lane-table add, then add [s]B and finish;
//   warp 4     (K2, K3) the R warp: one thread a lane decompresses R;
//   the rest   kBWarps = 3 B warps: one thread a lane sums a third of the
//              fixed-base comb for [s]B.
//
// The TPU kernel's loop, and this file's first Hopper version, computed
// [s]B - [k]A in one Straus chain of 64 windows, each 4 doublings, a madd
// of [1..8]B and a lane-table add: 384 quad operations of two dependent
// rounds a lane. At a 4,096-lane chunk each SM holds one block, one quad
// warp on each scheduler, and that chain sets the time. [s]B needs nothing
// from the lane (s is known at launch, B is fixed), so the B warps compute
// it beside the chain, in ref10's ge_scalarmult_base order over a table of
// (e + 1) 256^j B (j < 32, e < 8), and the quads' chain falls from 768 to
// 646 rounds. The comb's multiplies are as many as the Straus madds', and
// each scheduler's wide multiplies are what runs short: one B warp for all
// of the comb put its whole load on one scheduler and its quad warp fell
// behind (K3 0.384 against the Straus loop's 0.387 ms in one call;
// scripts/kernel_variants.py, NVIDIA H100 80GB HBM3, 700.00 W). Three B
// warps, each over comb rows j = b mod 3 with its own 4 doublings, sit on
// the three schedulers that do not hold the R warp, and the quads add the
// three parts. Measured against the Straus-loop version in one call, two
// rounds each (scripts/kernel_variants.py, NVIDIA H100 80GB HBM3, 700.00
// W): at 4,096 lanes K3 0.312-0.322 ms against 0.380-0.383 (41% of the
// bound), K2 0.313-0.317 against 0.380-0.382, K1 0.405-0.413 against
// 0.450-0.458; at 16,384 lanes K3 1.044-1.062 against 1.083.
//
// The quads. A quad of four adjacent threads carries a lane, one thread
// per extended coordinate, with the parallel formulas of Hisil, Wong,
// Carter and Dawson ("Twisted Edwards Curves Revisited", 2008, a = -1,
// extended coordinates):
//
//   thread c (= threadIdx.x & 3) holds coordinate c of the accumulator
//   (X, Y, Z, T), and slot c of an added operand in cached order
//   (Y+X, Y-X, Z, 2dT); a Niels operand has slot 2 = 1.
//
// A doubling is one round of four squarings and one round of four products;
// an addition two rounds of four products (thread 2 skips its product in a
// mixed add). K3 is K2 with another table address (see verify_tables_body),
// so the warp roles and the mixed flag below hold for it too.
// Operands move between the quad's threads by __shfl_sync(width = 4): every
// thread copies one register of a named thread of its quad. The step
// tables, which tests/test_torch_quad_schedule.py runs step for step on the
// CPU against the plain curve ops:
//
//   step kind  thread 0       thread 1       thread 2       thread 3
//   q_double (dbl-2008-hwcd); in: v
//   D1   xchg  x <- v@0, y <- v@1
//   D2   S     v^2 (X^2)      v^2 (Y^2)      v^2 (Z^2)      (x + y)^2       -> r
//   D3   -     publish p = r  p = r          p = 2r         p = r
//   D4   xchg  L = lu + lw - lz and R = ru + rw - rz, the terms read from p
//              of the threads kDoubleRoute names (or 0), then L*R:
//        M     E*F            G*H            F*G            E*H             -> v
//              E = p0 + p1 - p3, F = p0 + p2 - p1, G = p0 - p1, H = p0 + p1
//   q_add (add-2008-hwcd-3); in: v, q = slot c of the operand, neg, mixed
//   A1   xchg  u <- v@1         u <- v@1       u = v          u = v; x <- v@0
//   A2   M     (u + x) q      (u - x) q      u q            u q             -> r
//              neg: threads 0 and 1 swap u + x and u - x; mixed: thread 2 r = u
//   A3   -     publish p = r  p = r          p = 2r         p = r (neg: 2p - r)
//   A4   xchg  as D4, by kAddRoute, with B = p0 and A = p1 (neg: B = p1, A = p0):
//        M     E*F            G*H            F*G            E*H             -> v
//              E = B - A, F = p2 - p3, G = p2 + p3, H = B + A
//   q_cached; in: v
//   C1   xchg  x <- v@0, y <- v@1
//   C2   -     y + x          y - x          v              2d v            -> q
//   K1 set-up; in: thread c holds all of P = (c odd ? R : A), decompressed
//   X1   -     own = A[c] (even c) or cached(R)[c] (odd c); send = the same at c ^ 1
//   X2   xchg  got <- send@(c ^ 1); v = A[c] and rq = cached(R)[c]
//   K1 table; in: v = (-A)[c]
//   T1   q_cached(v) = q1: entry 0
//   T2   7 x { v = q_add(v, q1); entry t = q_cached(v) }
//   finish; in: v = ([k](-A))[c], rq, after the block's barrier
//   F0   3 x q_add(v, slot c of B warp b's part of [s]B)
//   F1   q_add(v, rq, neg, mixed): R has Z = 1
//   F2   3 x q_double
//   F3   xchg  x, y, z <- v@0..2; the lane passes iff X == 0 and Y == Z
//
// Negation needs no exchange: adding -Q = (Y-X, Y+X, Z, -2dT) is adding Q
// with threads 0 and 1 multiplying the other sum, B and A trading places
// and C negated in A3. So thread c only ever reads slot c of a table entry.
// Round 2 forms only the two factors each thread needs: a shuffle whose
// source differs by thread does the selecting, so no thread computes all
// of E, F, G, H. An operation exchanges 8 field elements (80 shuffles)
// against 2 multiplies a thread.
//
// Digit selection is branchless: entry |d| - 1 is read at a clamped index
// and the identity substituted for d = 0, in the quads and in the B warps.
// K2's mixed flag is the quad's own (quads of a warp may differ) and only
// predicates thread 2's product in A2, so every shuffle runs with all 32
// threads converged. A padded lane (past n) computes on lane n - 1 and
// skips the store: no thread returns before the barrier.
//
// Launch. A 4,096-lane chunk is 128 blocks, at most one on each of the 132
// SMs. K1's block has 224 threads (quads and B warps; its quads decompress
// A and R themselves), K2's and K3's 256. __launch_bounds__ asks for two
// blocks an SM, which holds a thread to 128 registers; ptxas then spills
// into a 56-byte stack frame. With one block an SM it spills nothing (153
// registers, 230 in K1) and ran as fast at 4,096 lanes, but a 16,384-lane
// launch then takes four waves of one block an SM and ran 17-20% slower
// (scripts/kernel_variants.py, NVIDIA H100 80GB HBM3, 700.00 W).
//
// Shared memory, 95,128 bytes a block, dynamic (the launchers allow it with
// cudaFuncSetAttribute and return its error):
//   tab   [8 entries][10 limbs][128 threads] int32: the lane table, each
//         thread's slot in its own column. A warp reads 32 consecutive
//         words for any digits, so no bank conflicts; 40,960 B.
//   comb  [32 rows][3 components][10 limbs][8 entries] int32: decoded once
//         a block from rows 27.. of the constants. All threads of a B warp
//         read one row at a step, and its 8 entries of a limb fall in 8
//         banks; 30,720 B. Reading the rows through L1 (__ldg) from the
//         constants instead ran as fast (scripts/kernel_alternatives.py,
//         l1), so the table stays in shared memory, beside everything else
//         the block reads.
//   k     d, sqrt(-1), 2d; 120 B.
//   sdig  [3 B warps][32 window pairs][32 lanes] uint8: each B warp's
//         recode of s, two 4-bit digits a byte; 3,072 B.
//   kdig  [32 window pairs][32 lanes] uint8: k, written by thread 0 of the
//         quad; 1,024 B.
//   sb    [3][4 slots][32 lanes] fe: the B warps' parts of [s]B, cached
//         (Y+X, Y-X, Z, 2dT); 15,360 B.
//   rc, r_ok  [3][32 lanes] fe and [32] uint8: K2's and K3's R in cached
//         form (Y+X, Y-X, 2dT; Z = 1) and its verdict; 3,872 B.
// Nothing is indexed by data in registers, so no table or digit string
// sits on the stack.
//
// Decompression cannot be split: pow22523 is a serial chain of 251
// squarings. In K1 threads 0 and 2 decompress A while threads 1 and 3
// decompress R (the same instructions, so the quad does not diverge), and
// the table needs A before the Straus loop. K2 and K3 need R only at the
// finish: the R warp decompresses the block's 32 R points, one a thread,
// into shared memory while the quads run their loop.
//
// K5, sr25519. Per lane [s]B - [k]A - R lies in the ristretto identity coset
// (X == 0 or Y == 0), with A and R decoded by RFC 9496 4.3.1 DECODE, exactly
// as tendermint_tpu_torch/ops/sr25519_batch.verify_kernel_sr; the engine ANDs
// in its host checks (the marker bit, s < L, A and R canonical and even).
// ristretto255 is a quotient of this curve, so K5 is K1 with two steps
// replaced (verify_body<true>): step X1 decodes with ristretto_decode, which
// needs only d and sqrt(-1) of the constants, and the finish drops F2 and
// tests X == 0 or Y == 0 (projective, so no inversion) in F3. K1's lane
// table holds (t + 1)(-A), which is what the schnorr equation needs, and
// the B warps' comb gives [s]B as in K1. An encoding is read as its value
// mod p (bit 255 folded in as 19), as the plain version reads it; the host
// rejects every encoding >= p anyway. s is masked to 255 bits and checked
// < L on the host and k < L, so the signed recode is exact. Bound, counted
// as for K1: a DECODE is 257 S + 23 M (pow22523 and six squarings, twelve
// multiplies; the multiply by sqrt(-1) some lanes take is left out), so K5
// needs 1,538 S + 2,103 M a lane, at 4,096 lanes at least 0.144 ms of the
// card's integer multiply rate; its bytes are K1's 129 a lane. Measured
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 0.415 ms at 4,096 lanes
// (35% of the bound, K1 0.410 in the same run), 1.311 ms at 16,384; 128
// registers and 216 B of stack, the decode's live values spilling where
// K1's decompression takes 56 B.
//
// Each launcher returns cudaGetLastError() and never synchronizes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NL = 10;
constexpr int kQuad = 4;                     // threads per lane on the k chain
constexpr int kWarp = 32;
constexpr int kQuadThreads = 128;            // the quad warps: 4 threads a lane
constexpr int kLanes = kQuadThreads / kQuad; // lanes per block
constexpr int kBWarps = 3;                   // the comb's warps, a third of its rows each
constexpr int kThreadsK1 = kQuadThreads + kBWarps * kWarp;        // quads, B warps
constexpr int kThreadsK2 = kQuadThreads + (1 + kBWarps) * kWarp;  // quads, R warp, B warps
constexpr int kMinBlocks = 2;                // blocks per SM the registers must allow
constexpr int kEntries = 8;                  // [1..8] tables
constexpr int kWindows = 64;
constexpr int kCombRows = 32;                // comb row j holds [1..8] 256^j B
constexpr unsigned kFull = 0xffffffffu;
// The constants buffer, canonical 32-byte rows: [1..8]B in Niels form
// (rows 0..23, entry-major; no kernel of this file reads them), d,
// sqrt(-1), 2d (rows 24..26), then the comb: row kCombConst + (j * 8 + e)
// * 3 + comp is component comp (Y+X, Y-X, 2dT) of (e + 1) 256^j B.
constexpr int kConstK = 24;
constexpr int kCombConst = 27;
constexpr int kNumConsts = kCombConst + kCombRows * kEntries * 3;
constexpr int kConstD = 0;
constexpr int kConstSqrtM1 = 1;
constexpr int kConstD2 = 2;

struct fe { int32_t v[NL]; };
struct ge { fe X, Y, Z, T; };                 // extended coordinates

struct Shared {
  int32_t tab[kEntries * NL * kQuadThreads];  // [entry][limb][thread]
  int32_t comb[kCombRows * 3 * NL * kEntries];  // [row][component][limb][entry]
  fe k[3];                                    // d, sqrt(-1), 2d
  uint8_t sdig[kBWarps][kWindows / 2 * kLanes];  // [B warp][window pair][lane], a digit a nibble
  uint8_t kdig[kWindows / 2 * kLanes];
  fe sb[kBWarps][4][kLanes];                  // B warp b's part of [s]B, cached, slot c
  fe rc[3][kLanes];                           // K2, K3: Y+X, Y-X, 2dT of R
  uint8_t r_ok[kLanes];                       // K2, K3: R decompressed
};
// Dynamic shared memory (cudaFuncSetAttribute in the launchers).
static_assert(sizeof(Shared) <= 227 * 1024, "shared memory of one block");

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

__device__ __forceinline__ fe fe_sel(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = c ? a.v[i] : b.v[i];
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

// u + w - z with one carry pass. For limbs u, w < 2^27 and z no
// larger than 2p's, the sum u + w + 2p - z is non-negative and below 2^29.
__device__ __forceinline__ fe fe_lin(const fe& u, const fe& w, const fe& z) {
  int32_t h[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) h[i] = u.v[i] + w.v[i] + (two_p(i) - z.v[i]);
  return carry32(h);
}

// u + w - z without the carry pass: limbs below 3 * 2^27 (even) and
// 3 * 2^26 + 2^18 (odd), for a left factor of fe_mul only (see Field).
__device__ __forceinline__ fe fe_lin_nc(const fe& u, const fe& w, const fe& z) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = u.v[i] + w.v[i] + (two_p(i) - z.v[i]);
  return r;
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

__device__ __forceinline__ fe fe_sqn(fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = fe_sq(a);
  return a;
}

// Canonical limbs of a loose element: value in [0, p), every limb exact.
__device__ __forceinline__ void fe_canon(const fe& a, int32_t t[NL]) {
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

// --- one lane per thread: the comb's point operations ------------------------

// ref10's ge_madd: h + (neg ? -q : q) for q = (Y+X, Y-X, 2dT) with Z = 1,
// in 7 M. -q is (Y-X, Y+X, -2dT): the sums swap and F and G trade places.
__device__ __forceinline__ ge ge_madd(const ge& h, const fe& ypx, const fe& ymx, const fe& t2d,
                                      bool neg) {
  const fe a = fe_mul(fe_sub(h.Y, h.X), fe_sel(neg, ypx, ymx));
  const fe b = fe_mul(fe_add(h.Y, h.X), fe_sel(neg, ymx, ypx));
  const fe c = fe_mul(h.T, t2d);
  const fe d = fe_add(h.Z, h.Z);
  const fe e = fe_sub(b, a);
  const fe hh = fe_add(b, a);
  const fe dpc = fe_add(d, c);
  const fe dmc = fe_sub(d, c);
  const fe f = fe_sel(neg, dpc, dmc);
  const fe g = fe_sel(neg, dmc, dpc);
  return ge{fe_mul(e, f), fe_mul(g, hh), fe_mul(f, g), fe_mul(e, hh)};
}

// dbl-2008-hwcd (a = -1), as ops/curve.pt_double: 4 S + 4 M.
__device__ __forceinline__ ge ge_dbl(const ge& p) {
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

__device__ __forceinline__ fe fe_pow22523(const fe& z) {
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

// --- one lane per thread: decompression ----------------------------------------

// Liberal (ZIP-215) decompression of a 32-byte encoding; an invalid lane
// gets the identity and false.
__device__ __forceinline__ bool ge_decompress(const uint8_t b[32], const fe& d, const fe& sqrtm1,
                                              ge* out) {
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
  *out = valid ? ge{x, y, one, fe_mul(x, y)} : ge{fe_const(0), one, one, fe_const(0)};
  return valid;
}

__device__ __forceinline__ bool fe_is_negative(const fe& a) {
  int32_t t[NL];
  fe_canon(a, t);
  return (t[0] & 1) != 0;
}

// |a|: the non-negative (even) one of a and -a.
__device__ __forceinline__ fe fe_abs(const fe& a) { return fe_sel(fe_is_negative(a), fe_neg(a), a); }

// RFC 9496 4.3.1 DECODE of a ristretto255 encoding, as
// ops/sr25519_batch.ristretto_decompress: the square-root ratio through
// pow22523 of w^7 with the -1 and -sqrt(-1) fix-ups, then x = |2 s den_x|,
// y = u1 den_y, t = x y. Valid when the ratio was a square, t is
// non-negative and y != 0; an invalid lane gets the identity and false.
// Bit 255 of the encoding is folded in as 19 (the value mod p).
__device__ __forceinline__ bool ristretto_decode(const uint8_t b[32], const fe& d, const fe& sqrtm1,
                                                 ge* out) {
  const fe one = fe_const(1);
  const fe s = fe_add(fe_frombytes(b), fe_const(19 * (b[31] >> 7)));
  const fe ss = fe_sq(s);
  const fe u1 = fe_sub(one, ss);
  const fe u2 = fe_add(one, ss);
  const fe u2s = fe_sq(u2);
  const fe v = fe_sub(fe_neg(fe_mul(fe_sq(u1), d)), u2s);     // -d u1^2 - u2^2
  const fe w = fe_mul(v, u2s);
  const fe w3 = fe_mul(fe_sq(w), w);
  const fe w7 = fe_mul(fe_sq(w3), w);
  fe r = fe_mul(w3, fe_pow22523(w7));
  const fe check = fe_mul(w, fe_sq(r));
  const bool correct = fe_is_zero(fe_sub(check, one));
  const bool flipped = fe_is_zero(fe_add(check, one));       // check == -1
  const bool flipped_i = fe_is_zero(fe_add(check, sqrtm1));  // check == -sqrt(-1)
  if (flipped || flipped_i) r = fe_mul(r, sqrtm1);
  r = fe_abs(r);
  const fe den_x = fe_mul(r, u2);
  const fe den_y = fe_mul(fe_mul(r, den_x), v);
  const fe x = fe_abs(fe_mul(fe_add(s, s), den_x));
  const fe y = fe_mul(u1, den_y);
  const fe t = fe_mul(x, y);
  const bool valid = (correct || flipped) && !fe_is_negative(t) && !fe_is_zero(y);
  *out = valid ? ge{x, y, one, t} : ge{fe_const(0), one, one, fe_const(0)};
  return valid;
}

// Signed radix-16 recode of a little-endian scalar < 2^253: z = x + 0x88..88
// with the carry-out dropped, digit w (most significant first) = nibble - 8.
// Digits w = 2m and 2m + 1 share byte dig[m * kLanes] (the lane's column of
// sdig or kdig), as 4-bit two's complement: nibble - 8 = nibble ^ 8 mod 16;
// the odd digit in the high half.
__device__ __forceinline__ void recode(const uint8_t* x, uint8_t* dig) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int t = x[i] + 0x88 + carry;
    carry = t >> 8;
    dig[(31 - i) * kLanes] = static_cast<uint8_t>((((t & 15) ^ 8) << 4) | (((t >> 4) & 15) ^ 8));
  }
}

__device__ __forceinline__ int digit(const uint8_t* dig, int w) {
  return (((dig[(w >> 1) * kLanes] >> (4 * (w & 1))) & 15) ^ 8) - 8;
}

// --- four threads per lane: the quad schedule ----------------------------------

// a where keep, else 0.
__device__ __forceinline__ fe fe_and(const fe& a, bool keep) {
  const int32_t m = keep ? -1 : 0;
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] & m;
  return r;
}

__device__ __forceinline__ fe pick4(const fe& a, const fe& b, const fe& c, const fe& d, int k) {
  return fe_sel(k == 0, a, fe_sel(k == 1, b, fe_sel(k == 2, c, d)));
}

// Every thread copies `a` of thread `src` of its quad.
__device__ __forceinline__ fe shfl(const fe& a, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = __shfl_sync(kFull, a.v[i], src, kQuad);
  return r;
}

// Thread c copies `a` of thread c ^ mask.
__device__ __forceinline__ fe shfl_xor(const fe& a, int mask) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = __shfl_xor_sync(kFull, a.v[i], mask, kQuad);
  return r;
}

// Round 2 (D4 / A4). Thread c multiplies its pair of (E, F, G, H) (X = EF,
// Y = GH, Z = FG, T = EH), and forms each factor as u + w - z from values
// the quad's threads published, in one carry pass: a shuffle with a
// per-thread source does the selecting, and a keep mask zeroes an unused
// term. A route packs the six terms (lu, lw, lz, ru, rw, rz of L = lu + lw
// - lz and R = ru + rw - rz): term k's source for thread c in bits 8k + 2c,
// and the keep bits of lw, lz, rw, rz in bits 48 + 4j + c. Sources 0 and 1
// name B and A of the addition and swap when it subtracts.
constexpr uint64_t quad_src(int t0, int t1, int t2, int t3) {
  return uint64_t(t0 | (t1 << 2) | (t2 << 4) | (t3 << 6));
}

constexpr uint64_t quad_keep(int t0, int t1, int t2, int t3) {
  return uint64_t(t0 | (t1 << 1) | (t2 << 2) | (t3 << 3));
}

constexpr uint64_t route(uint64_t lu, uint64_t lw, uint64_t lz, uint64_t ru, uint64_t rw,
                         uint64_t rz, uint64_t keep_lw, uint64_t keep_lz, uint64_t keep_rw,
                         uint64_t keep_rz) {
  return lu | (lw << 8) | (lz << 16) | (ru << 24) | (rw << 32) | (rz << 40) |
         (keep_lw << 48) | (keep_lz << 52) | (keep_rw << 56) | (keep_rz << 60);
}

// Doubling; published p0 = X^2, p1 = Y^2, p2 = 2 Z^2, p3 = (X + Y)^2:
// E = p0 + p1 - p3, F = p0 + p2 - p1, G = p0 - p1, H = p0 + p1.
constexpr uint64_t kDoubleRoute = route(
    quad_src(0, 0, 0, 0), quad_src(1, 0, 2, 1), quad_src(3, 1, 1, 3),   // L: E G F E
    quad_src(0, 0, 0, 0), quad_src(2, 1, 0, 1), quad_src(1, 0, 1, 0),   // R: F H G H
    quad_keep(1, 0, 1, 1), quad_keep(1, 1, 1, 1), quad_keep(1, 1, 0, 1), quad_keep(1, 0, 1, 0));

// Addition; published p0 = B, p1 = A (swapped when neg), p2 = D = 2 Z1 Z2,
// p3 = C (2p - C when neg): E = B - A, F = D - C, G = D + C, H = B + A.
constexpr uint64_t kAddRoute = route(
    quad_src(0, 2, 2, 0), quad_src(0, 3, 0, 0), quad_src(1, 0, 3, 1),   // L: E G F E
    quad_src(2, 0, 2, 0), quad_src(0, 1, 3, 1), quad_src(3, 0, 0, 0),   // R: F H G H
    quad_keep(0, 1, 0, 0), quad_keep(1, 0, 1, 1), quad_keep(0, 1, 1, 1), quad_keep(1, 0, 0, 0));

// Term k (0..5) of thread c: p of the routed source, zeroed unless kept.
__device__ __forceinline__ fe route_term(const fe& pub, uint64_t rt, int k, int c, int neg) {
  int src = static_cast<int>(rt >> (8 * k + 2 * c)) & 3;
  if (src < 2) src ^= neg;
  const fe t = shfl(pub, src);
  if (k == 0 || k == 3) return t;
  const int j = k < 3 ? k - 1 : k - 2;
  return fe_and(t, (rt >> (48 + 4 * j + c)) & 1);
}

// What thread c publishes of its round-1 result r: thread 2 doubles it
// (2 Z^2, D = 2 Z1 Z2) and thread 3 negates it as 2p - r when neg (-C).
// The limbs stay non-negative and below 2^27, uncarried.
__device__ __forceinline__ fe publish(const fe& r, int c, bool neg) {
  fe p;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int32_t x = c == 2 ? r.v[i] + r.v[i] : r.v[i];
    p.v[i] = (c == 3 && neg) ? two_p(i) - x : x;
  }
  return p;
}

__device__ __forceinline__ fe round2(const fe& pub, uint64_t rt, int c, int neg) {
  const fe lhs = fe_lin_nc(route_term(pub, rt, 0, c, neg), route_term(pub, rt, 1, c, neg),
                        route_term(pub, rt, 2, c, neg));
  const fe rhs = fe_lin(route_term(pub, rt, 3, c, neg), route_term(pub, rt, 4, c, neg),
                        route_term(pub, rt, 5, c, neg));
  return fe_mul(lhs, rhs);
}

__device__ __forceinline__ fe q_double(const fe& v, int c) {
  const fe x = shfl(v, 0);                                   // D1
  const fe y = shfl(v, 1);
  const fe r = fe_sq(fe_sel(c == 3, fe_add(x, y), v));       // D2
  return round2(publish(r, c, false), kDoubleRoute, c, 0);   // D3, D4
}

__device__ __forceinline__ fe q_add(const fe& v, const fe& q, int c, bool neg, bool mixed) {
  // A1: threads 0 and 1 read y (threads 2 and 3 themselves) and x; thread
  // 0 forms y + x and thread 1 y - x, the other way round when neg.
  const fe u = shfl(v, c < 2 ? 1 : c);
  const fe x = shfl(v, 0);
  const bool plus = (c == 0) != neg;
  const fe lhs = fe_lin_nc(u, fe_and(x, c < 2 && plus), fe_and(x, c < 2 && !plus));
  fe r = u;                                                // A2
  if (!(mixed && c == 2)) r = fe_mul(lhs, q);
  return round2(publish(r, c, neg), kAddRoute, c, neg);      // A3, A4
}

__device__ __forceinline__ fe q_cached(const fe& v, int c, const fe& d2) {
  const fe x = shfl(v, 0);                                   // C1
  const fe y = shfl(v, 1);
  return pick4(fe_add(y, x), fe_sub(y, x), v, fe_mul(v, d2), c);  // C2
}

// Slot c of the cached identity (1, 1, 1, 0).
__device__ __forceinline__ fe ident_slot(int c) { return fe_const(c == 3 ? 0 : 1); }

__device__ __forceinline__ int entry_of(int digit) {
  const int m = digit < 0 ? -digit : digit;
  return m == 0 ? 0 : m - 1;
}

// `tab` points at the thread's column of Shared::tab.
__device__ __forceinline__ fe load_lane(const int32_t* tab, int c, int digit) {
  const int e = entry_of(digit);
  fe q;
#pragma unroll
  for (int l = 0; l < NL; ++l) q.v[l] = tab[(e * NL + l) * kQuadThreads];
  return fe_sel(digit == 0, ident_slot(c), q);
}

__device__ __forceinline__ void store_lane(int32_t* tab, int t, const fe& q) {
#pragma unroll
  for (int l = 0; l < NL; ++l) tab[(t * NL + l) * kQuadThreads] = q.v[l];
}

// [k](-A): 64 windows of 4 doublings and + d_k * (-A). With `mixed`
// every lane-table entry has Z = 1, and its add is a mixed one.
__device__ __forceinline__ fe straus(const Shared& sh, int tid, bool mixed) {
  const int c = tid & (kQuad - 1);
  const int ln = tid / kQuad;
  fe v = fe_const(c == 1 || c == 2 ? 1 : 0);  // the identity (0, 1, 1, 0)
#pragma unroll 1
  for (int i = 0; i < kWindows; ++i) {
#pragma unroll 1
    for (int j = 0; j < 4; ++j) v = q_double(v, c);
    const int dk = digit(sh.kdig + ln, i);
    v = q_add(v, load_lane(sh.tab + tid, c, dk), c, dk < 0, mixed);
  }
  return v;
}

// After the block's barrier: add the B warps' parts of [s]B (slot c of
// their cached forms, Z != 1), subtract R (rq = slot c of cached R, whose
// Z is 1), multiply by the cofactor, test for the identity. K5 (kSr) skips
// the cofactor and tests for the ristretto identity coset, X == 0 or Y == 0.
template <bool kSr = false>
__device__ __forceinline__ bool finish(const Shared& sh, fe v, const fe& rq, int c, int ln) {
#pragma unroll 1
  for (int b = 0; b < kBWarps; ++b) v = q_add(v, sh.sb[b][c][ln], c, false, false);  // F0
  v = q_add(v, rq, c, true, true);                           // F1
  if (kSr) {
    const fe x = shfl(v, 0);                                 // F3 of K5
    const fe y = shfl(v, 1);
    return fe_is_zero(x) || fe_is_zero(y);
  }
#pragma unroll 1
  for (int j = 0; j < 3; ++j) v = q_double(v, c);            // F2
  const fe x = shfl(v, 0);                                   // F3
  const fe y = shfl(v, 1);
  const fe z = shfl(v, 2);
  return fe_is_zero(x) && fe_is_zero(fe_sub(y, z));
}

// Decode d, sqrt(-1), 2d and the comb into shared memory.
__device__ __forceinline__ void load_consts(const uint8_t* __restrict__ consts, Shared& sh) {
  for (int i = threadIdx.x; i < kNumConsts - kConstK; i += blockDim.x) {
    const fe v = fe_frombytes(consts + 32 * (kConstK + i));
    const int row = i - (kCombConst - kConstK);
    if (row < 0) {
      sh.k[i] = v;
    } else {
      const int comp = row % 3, e = row / 3 % kEntries, j = row / (3 * kEntries);
#pragma unroll
      for (int l = 0; l < NL; ++l) sh.comb[((j * 3 + comp) * NL + l) * kEntries + e] = v.v[l];
    }
  }
  __syncthreads();
}

// Niels entry |d| of comb row j, the identity (1, 1, 0) for d = 0. A warp
// reads one row (all its threads are at the same step) and at most 8
// entries, which lie in 8 banks: no conflicts.
__device__ __forceinline__ void load_comb(const Shared& sh, int j, int d, fe& ypx, fe& ymx,
                                          fe& t2d) {
  const int32_t* row = sh.comb + j * 3 * NL * kEntries + entry_of(d);
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    ypx.v[l] = row[l * kEntries];
    ymx.v[l] = row[(NL + l) * kEntries];
    t2d.v[l] = row[(2 * NL + l) * kEntries];
  }
  ypx = fe_sel(d == 0, fe_const(1), ypx);
  ymx = fe_sel(d == 0, fe_const(1), ymx);
  t2d = fe_and(t2d, d != 0);
}

// B warp b, one lane a thread: its part of [s]B by the fixed-base comb,
// in ref10's ge_scalarmult_base order, over comb rows j = b mod kBWarps.
// Digit w of the recode (most significant first) weighs 16^(63 - w), so
// byte 31 - j of the lane's digit column holds the digit of 16 * 256^j
// (low nibble) and that of 256^j (high nibble): sum the first kind over
// the warp's rows, multiply by 16, then sum the second kind. 22 or 21
// mixed adds and 4 doublings; the part goes to shared memory in cached
// form, and the quads add the kBWarps parts.
__device__ __forceinline__ void comb_sb(Shared& sh, const uint8_t* __restrict__ s, int ln, int b) {
  uint8_t* dig = sh.sdig[b] + ln;
  recode(s, dig);
  ge h{fe_const(0), fe_const(1), fe_const(1), fe_const(0)};
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
#pragma unroll 1
    for (int j = 0; j < 4 * half; ++j) h = ge_dbl(h);
#pragma unroll 1
    for (int j = b; j < kCombRows; j += kBWarps) {
      const int d = digit(dig, 2 * (kCombRows - 1 - j) + half);
      fe ypx, ymx, t2d;
      load_comb(sh, j, d, ypx, ymx, t2d);
      h = ge_madd(h, ypx, ymx, t2d, d < 0);
    }
  }
  sh.sb[b][0][ln] = fe_add(h.Y, h.X);
  sh.sb[b][1][ln] = fe_sub(h.Y, h.X);
  sh.sb[b][2][ln] = h.Z;
  sh.sb[b][3][ln] = fe_mul(h.T, sh.k[kConstD2]);
}

__device__ __forceinline__ void load_row(const uint8_t* __restrict__ src, uint8_t dst[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dst[i] = src[i];
}

// Thread 0 of the quad recodes k into the lane's digit column.
__device__ __forceinline__ void recode_k(Shared& sh, const uint8_t* k, size_t lane, int c, int ln) {
  if (c == 0) recode(k + 32 * lane, sh.kdig + ln);
  __syncwarp();
}

// Lane (in the block) of thread tid: a quad thread's, or a helper warp's
// thread's own.
__device__ __forceinline__ int block_lane(int tid) {
  return tid < kQuadThreads ? tid / kQuad : (tid - kQuadThreads) & (kWarp - 1);
}

__device__ __forceinline__ Shared& shared() {
  extern __shared__ __align__(16) uint8_t smem[];
  return *reinterpret_cast<Shared*>(smem);
}

// K1 and K5 share this body; K5 (kSr) decodes A and R by ristretto255
// DECODE and finishes with the identity-coset test.
template <bool kSr>
__device__ __forceinline__ void verify_body(
    const uint8_t* __restrict__ pk, const uint8_t* __restrict__ r,
    const uint8_t* __restrict__ s, const uint8_t* __restrict__ k,
    const uint8_t* __restrict__ consts, uint8_t* __restrict__ out, int n) {
  Shared& sh = shared();
  load_consts(consts, sh);
  const int tid = threadIdx.x;
  const int c = tid & (kQuad - 1);
  const int ln = block_lane(tid);
  const int lane_id = blockIdx.x * kLanes + ln;
  const size_t lane = lane_id < n ? lane_id : n - 1;  // padded lanes compute, never store

  fe v = fe_const(0), rq = fe_const(0);
  bool a_ok = false, r_ok = false;
  if (tid < kQuadThreads) {
    // X1: even threads decompress A, odd threads R; each prepares its own
    // slot and the one its partner (c ^ 1) needs.
    uint8_t row[32];
    load_row(((c & 1) ? r : pk) + 32 * lane, row);
    ge p;
    const bool ok = kSr ? ristretto_decode(row, sh.k[kConstD], sh.k[kConstSqrtM1], &p)
                        : ge_decompress(row, sh.k[kConstD], sh.k[kConstSqrtM1], &p);
    const bool even = (c & 1) == 0;
    const fe ypx = fe_add(p.Y, p.X);
    const fe ymx = fe_sub(p.Y, p.X);
    const fe t2d = fe_mul(p.T, sh.k[kConstD2]);
    const fe own = fe_sel(even, pick4(p.X, p.Y, p.Z, p.T, c), pick4(ypx, ymx, p.Z, t2d, c));
    const fe send =
        fe_sel(even, pick4(p.X, p.Y, p.Z, p.T, c ^ 1), pick4(ypx, ymx, p.Z, t2d, c ^ 1));
    const fe got = shfl_xor(send, 1);                        // X2
    const bool other_ok = __shfl_xor_sync(kFull, static_cast<int>(ok), 1, kQuad) != 0;
    const fe a_c = fe_sel(even, own, got);
    rq = fe_sel(even, got, own);
    a_ok = even ? ok : other_ok;
    r_ok = even ? other_ok : ok;

    // Lane table: entry t is (t + 1)(-A) in cached form.
    int32_t* tab = sh.tab + tid;
    v = fe_sel(c == 0 || c == 3, fe_neg(a_c), a_c);
    const fe q1 = q_cached(v, c, sh.k[kConstD2]);            // T1
    store_lane(tab, 0, q1);
#pragma unroll 1
    for (int t = 1; t < kEntries; ++t) {                     // T2
      v = q_add(v, q1, c, false, false);
      store_lane(tab, t, q_cached(v, c, sh.k[kConstD2]));
    }
    recode_k(sh, k, lane, c, ln);
    v = straus(sh, tid, false);
  } else {
    comb_sb(sh, s + 32 * lane, ln, (tid - kQuadThreads) / kWarp);
  }
  __syncthreads();
  if (tid >= kQuadThreads) return;
  const bool pass = finish<kSr>(sh, v, rq, c, ln) && a_ok && r_ok;
  if (c == 0 && lane_id < n) out[lane_id] = pass ? 1 : 0;
}

__global__ void __launch_bounds__(kThreadsK1, kMinBlocks) ed25519_verify_kernel(
    const uint8_t* __restrict__ pk, const uint8_t* __restrict__ r,
    const uint8_t* __restrict__ s, const uint8_t* __restrict__ k,
    const uint8_t* __restrict__ consts, uint8_t* __restrict__ out, int n) {
  verify_body<false>(pk, r, s, k, consts, out, n);
}

__global__ void __launch_bounds__(kThreadsK1, kMinBlocks) sr25519_verify_kernel(
    const uint8_t* __restrict__ pk, const uint8_t* __restrict__ r,
    const uint8_t* __restrict__ s, const uint8_t* __restrict__ k,
    const uint8_t* __restrict__ consts, uint8_t* __restrict__ out, int n) {
  verify_body<true>(pk, r, s, k, consts, out, n);
}

// K2 and K3 share this body; they differ only in where lane `lane`'s table
// column lies. The table is laid out (8, 4, 32, stride): byte (t, c, l) of
// column j at ((t * 4 + c) * 32 + l) * stride + j. K2 reads column `lane`
// of its gathered (8, 4, 32, n) input; K3 reads column idx[lane] of the
// (8, 4, 32, K) resident store, so the gather costs no pass of its own.
template <bool kResident>
__device__ __forceinline__ void verify_tables_body(
    const uint8_t* __restrict__ tab_in, const int32_t* __restrict__ idx, int stride,
    const uint8_t* __restrict__ a_ok, const uint8_t* __restrict__ r,
    const uint8_t* __restrict__ s, const uint8_t* __restrict__ k,
    const uint8_t* __restrict__ consts, uint8_t* __restrict__ out, int n) {
  Shared& sh = shared();
  load_consts(consts, sh);
  const int tid = threadIdx.x;
  const int c = tid & (kQuad - 1);
  const int ln = block_lane(tid);
  const int lane_id = blockIdx.x * kLanes + ln;
  const size_t lane = lane_id < n ? lane_id : n - 1;  // padded lanes compute, never store

  fe v = fe_const(0);
  if (tid < kQuadThreads) {
    // Thread c reads component c of every entry from the lane's column, in
    // one pass. zdiff stays 0 on thread 2 iff every entry's Z is the bytes
    // of 1 (host-built tables); the quad then adds mixed.
    const size_t col_j = kResident ? static_cast<size_t>(idx[lane]) : lane;
    int32_t* tab = sh.tab + tid;
    uint8_t row[32];
    uint32_t zdiff = 0;
#pragma unroll 1
    for (int t = 0; t < kEntries; ++t) {
      const uint8_t* col = tab_in + size_t((t * kQuad + c) * 32) * stride + col_j;
#pragma unroll
      for (int l = 0; l < 32; ++l) row[l] = col[size_t(l) * stride];
#pragma unroll
      for (int l = 0; l < 32; ++l) zdiff |= row[l] ^ (l == 0 ? 1u : 0u);
      store_lane(tab, t, fe_frombytes(row));
    }
    const bool mixed = __shfl_sync(kFull, zdiff, 2, kQuad) == 0;
    recode_k(sh, k, lane, c, ln);
    v = straus(sh, tid, mixed);
  } else if (tid < kQuadThreads + kWarp) {
    // The R warp decompresses R of the block's lanes, one a thread, while
    // the quads run the Straus loop.
    uint8_t row[32];
    load_row(r + 32 * lane, row);
    ge p;
    sh.r_ok[ln] = ge_decompress(row, sh.k[kConstD], sh.k[kConstSqrtM1], &p) ? 1 : 0;
    sh.rc[0][ln] = fe_add(p.Y, p.X);
    sh.rc[1][ln] = fe_sub(p.Y, p.X);
    sh.rc[2][ln] = fe_mul(p.T, sh.k[kConstD2]);
  } else {
    comb_sb(sh, s + 32 * lane, ln, (tid - kQuadThreads) / kWarp - 1);
  }
  __syncthreads();
  if (tid >= kQuadThreads) return;
  // Slot c of cached R: Y+X, Y-X, Z = 1, 2dT.
  const fe rq = fe_sel(c == 2, fe_const(1), sh.rc[c == 3 ? 2 : (c & 1)][ln]);
  const bool pass = finish(sh, v, rq, c, ln) && a_ok[lane] != 0 && sh.r_ok[ln] != 0;
  if (c == 0 && lane_id < n) out[lane_id] = pass ? 1 : 0;
}

__global__ void __launch_bounds__(kThreadsK2, kMinBlocks) ed25519_verify_tables_kernel(
    const uint8_t* __restrict__ tab_in, const uint8_t* __restrict__ a_ok,
    const uint8_t* __restrict__ r, const uint8_t* __restrict__ s,
    const uint8_t* __restrict__ k, const uint8_t* __restrict__ consts,
    uint8_t* __restrict__ out, int n) {
  verify_tables_body<false>(tab_in, nullptr, n, a_ok, r, s, k, consts, out, n);
}

__global__ void __launch_bounds__(kThreadsK2, kMinBlocks) ed25519_verify_resident_kernel(
    const uint8_t* __restrict__ store, const int32_t* __restrict__ idx, int store_cols,
    const uint8_t* __restrict__ a_ok, const uint8_t* __restrict__ r,
    const uint8_t* __restrict__ s, const uint8_t* __restrict__ k,
    const uint8_t* __restrict__ consts, uint8_t* __restrict__ out, int n) {
  verify_tables_body<true>(store, idx, store_cols, a_ok, r, s, k, consts, out, n);
}

inline int blocks(int n) { return (n + kLanes - 1) / kLanes; }

// A block takes sizeof(Shared) bytes of dynamic shared memory, more than
// the 48 KB a kernel may take unless it is allowed; the launchers allow it
// before every launch and return the error if that fails.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(Shared)));
}

}  // namespace

extern "C" int ed25519_verify_launch(const void* pk, const void* r, const void* s,
                                     const void* k, const void* consts, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  const cudaError_t err = allow_shared(ed25519_verify_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  ed25519_verify_kernel<<<blocks(n), kThreadsK1, sizeof(Shared),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pk), static_cast<const uint8_t*>(r),
      static_cast<const uint8_t*>(s), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(consts), static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ed25519_verify_tables_launch(const void* tab, const void* a_ok, const void* r,
                                            const void* s, const void* k, const void* consts,
                                            void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t err = allow_shared(ed25519_verify_tables_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  ed25519_verify_tables_kernel<<<blocks(n), kThreadsK2, sizeof(Shared),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tab), static_cast<const uint8_t*>(a_ok),
      static_cast<const uint8_t*>(r), static_cast<const uint8_t*>(s),
      static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(consts),
      static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// K5: the same arguments as K1.
extern "C" int sr25519_verify_launch(const void* pk, const void* r, const void* s,
                                     const void* k, const void* consts, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  const cudaError_t err = allow_shared(sr25519_verify_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  sr25519_verify_kernel<<<blocks(n), kThreadsK1, sizeof(Shared),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pk), static_cast<const uint8_t*>(r),
      static_cast<const uint8_t*>(s), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(consts), static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// K3: the store is (8, 4, 32, store_cols) uint8 and idx (n,) int32 column
// indices into it, each in [0, store_cols) (the wrapper checks).
extern "C" int ed25519_verify_resident_launch(const void* store, const void* idx, const void* a_ok,
                                              const void* r, const void* s, const void* k,
                                              const void* consts, void* out, int n, int store_cols,
                                              void* stream) {
  if (n <= 0) return 0;
  const cudaError_t err = allow_shared(ed25519_verify_resident_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  ed25519_verify_resident_kernel<<<blocks(n), kThreadsK2, sizeof(Shared),
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(store), static_cast<const int32_t*>(idx), store_cols,
      static_cast<const uint8_t*>(a_ok), static_cast<const uint8_t*>(r),
      static_cast<const uint8_t*>(s), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(consts), static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename Kernel>
int attributes(Kernel kernel, int threads, int* out) {
  cudaError_t err = allow_shared(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, sizeof(Shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes + sizeof(Shared));
  out[3] = threads;
  out[4] = kLanes;
  out[5] = resident;
  return 0;
}

}  // namespace

// Launch facts of kernel `which` (0: K1, 1: K2, 2: K3, 3: K5) on the current
// device: out = {registers a thread, local (stack) bytes a thread, shared
// bytes a block (static and dynamic), threads a block, lanes a block,
// blocks resident on an SM}.
extern "C" int ed25519_kernel_attributes(int which, int* out) {
  switch (which) {
    case 0: return attributes(ed25519_verify_kernel, kThreadsK1, out);
    case 1: return attributes(ed25519_verify_tables_kernel, kThreadsK2, out);
    case 2: return attributes(ed25519_verify_resident_kernel, kThreadsK2, out);
    case 3: return attributes(sr25519_verify_kernel, kThreadsK1, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
