#!/usr/bin/env python3
"""Write the alternative designs of K1-K3 and K4 that were measured
against the committed ones, as edited copies of the committed sources.

    python3 scripts/kernel_alternatives.py [OUT_DIR]

OUT_DIR defaults to ``build/alternatives`` (listed in ``.gitignore``).
Each file is the committed source with one design choice changed:

- ``ed25519_verify_l1.cu``: the comb table stays in the constants buffer
  and the B warp reads its rows through the L1 cache (``__ldg``), in
  place of decoding it into shared memory;
- ``ed25519_verify_interleave.cu``: every carry pass in ref10's order,
  two chains of depth 7, in place of one ripple of depth 12;
- ``ed25519_verify_lb1.cu``: ``__launch_bounds__`` asks for one block
  an SM, which lets a thread keep up to 255 registers;
- ``ed25519_verify_eager.cu``: round 2 of every quad operation and A2
  carry their left factor (``fe_lin``), where the committed kernels skip
  that carry pass (``fe_lin_nc``);
- ``sha512_challenge_lockstep.cu``: the two warps hand over W + K in
  lockstep, a ``__syncthreads()`` a hand-over, through two buffers;
- ``sha512_challenge_single.cu``: one thread a lane in 32-thread blocks,
  each thread computing a hand-over's W + K into registers before its 16
  rounds, in place of the schedule warp.

Compare them with ``scripts/kernel_variants.py``. The script fails if a
piece of the committed source it edits has changed.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tendermint_tpu_torch", "csrc")


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"kernel_alternatives: expected one match of {old[:60]!r}")
    return src.replace(old, new)


def l1(src: str) -> str:
    src = edit(src, "  int32_t comb[kCombRows * 3 * NL * kEntries];"
                    "  // [row][component][limb][entry]\n", "")
    src = edit(src, "  for (int i = threadIdx.x; i < kNumConsts - kConstK; i += blockDim.x) {",
               "  for (int i = threadIdx.x; i < kCombConst - kConstK; i += blockDim.x) {")
    src = edit(src, """      const int comp = row % 3, e = row / 3 % kEntries, j = row / (3 * kEntries);
#pragma unroll
      for (int l = 0; l < NL; ++l) sh.comb[((j * 3 + comp) * NL + l) * kEntries + e] = v.v[l];
""", "")
    start = src.index("__device__ __forceinline__ void load_comb(")
    end = src.index("// B warp b, one lane a thread")
    src = src[:start] + """__device__ __forceinline__ fe ldg_fe(const uint8_t* p) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  fe r;
  int off = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int k = off >> 5;
    const uint64_t v = w[k] | (k + 1 < 8 ? uint64_t(w[k + 1]) << 32 : 0);
    r.v[i] = static_cast<int32_t>((v >> (off & 31)) & ((1u << width(i)) - 1));
    off += width(i);
  }
  return r;
}

__device__ __forceinline__ void load_comb(const uint8_t* __restrict__ consts, int j, int d,
                                          fe& ypx, fe& ymx, fe& t2d) {
  const uint8_t* row = consts + 32 * (kCombConst + (j * kEntries + entry_of(d)) * 3);
  ypx = fe_sel(d == 0, fe_const(1), ldg_fe(row));
  ymx = fe_sel(d == 0, fe_const(1), ldg_fe(row + 32));
  t2d = fe_and(ldg_fe(row + 64), d != 0);
}

""" + src[end:]
    src = edit(src, "void comb_sb(Shared& sh, const uint8_t* __restrict__ s, int ln, int b) {",
               "void comb_sb(Shared& sh, const uint8_t* __restrict__ consts,\n"
               "                                        const uint8_t* __restrict__ s, int ln, int b) {")
    src = edit(src, "      load_comb(sh, j, d, ypx, ymx, t2d);",
               "      load_comb(consts, j, d, ypx, ymx, t2d);")
    return src.replace("comb_sb(sh, s + 32 * lane, ln,", "comb_sb(sh, consts, s + 32 * lane, ln,")


def eager(src: str) -> str:
    src = edit(src, "  const fe lhs = fe_lin_nc(route_term(pub, rt, 0, c, neg),",
               "  const fe lhs = fe_lin(route_term(pub, rt, 0, c, neg),")
    terms = "(u, fe_and(x, c < 2 && plus), fe_and(x, c < 2 && !plus));\n"
    return edit(src, f"  const fe lhs = fe_lin_nc{terms}  fe r = u;",
                f"  const fe lhs = fe_lin{terms}  fe r = lhs;")


def interleave(src: str) -> str:
    for bits, typ, one in (("32", "int32_t", "1"), ("64", "int64_t", "int64_t(1)")):
        start = src.index(f"__device__ __forceinline__ fe carry{bits}(")
        end = src.index("  fe r;", start)
        src = src[:start] + f"""__device__ __forceinline__ fe carry{bits}({typ} h[NL]) {{
  // ref10's order: two chains, limbs 0..4 and 4..9, then the fold.
#pragma unroll
  for (int i = 0; i < 4; ++i) {{
    const {typ} ca = h[i] >> width(i);
    h[i] &= ({one} << width(i)) - 1;
    h[i + 1] += ca;
    const {typ} cb = h[i + 4] >> width(i + 4);
    h[i + 4] &= ({one} << width(i + 4)) - 1;
    h[i + 5] += cb;
  }}
  {typ} c = h[4] >> 26;
  h[4] &= ({one} << 26) - 1;
  h[5] += c;
  c = h[8] >> 26;
  h[8] &= ({one} << 26) - 1;
  h[9] += c;
  c = h[9] >> 25;
  h[9] &= ({one} << 25) - 1;
  h[0] += 19 * c;
  c = h[0] >> 26;
  h[0] &= ({one} << 26) - 1;
  h[1] += c;
""" + src[end:]
    return src


def lb1(src: str) -> str:
    return edit(src, "constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")


def lockstep(src: str) -> str:
    start = src.index("  if (threadIdx.x >= kWarp) {\n    uint64_t w[16];")
    end = src.index("  const int lane = row0 + t;\n")
    return src[:start] + """  const bool round_warp = threadIdx.x < kWarp;
  uint64_t w[16], s[8], st[8];
  if (round_warp) {
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = kInit[i];
  } else {
#pragma unroll
    for (int blk = 0; blk < kStages; ++blk) stage_block(sh, blocks, nblocks, row0, n, blk, t);
    schedule(sh, blocks, nblocks, row0, n, 0, t, w, &sh.wk[0][0][t], kLanes);
  }
  __syncthreads();
#pragma unroll 1
  for (int g = 0; g < hand_overs; ++g) {
    if (round_warp) {
      rounds(&sh.wk[g & 1][0][t], kLanes, g, s, st);
    } else if (g + 1 < hand_overs) {
      schedule(sh, blocks, nblocks, row0, n, g + 1, t, w, &sh.wk[(g + 1) & 1][0][t], kLanes);
    }
    __syncthreads();
  }
  if (!round_warp) return;
""" + src[end:]


def single(src: str) -> str:
    src = edit(src, "constexpr int kThreads = 2 * kWarp;"
                    "          // the round warp, then the schedule warp",
               "constexpr int kThreads = kWarp;  // one thread a lane")
    start = src.index("  __shared__ Shared sh;\n  const int t = threadIdx.x & (kWarp - 1);")
    end = src.index("  const int lane = row0 + t;\n")
    src = src[:start] + """  __shared__ Shared sh;
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kLanes;
  const int hand_overs = kChunks * nblocks;
  uint64_t w[16], s[8], st[8], wk[kChunk];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = kInit[i];
#pragma unroll
  for (int blk = 0; blk < kStages; ++blk) stage_block(sh, blocks, nblocks, row0, n, blk, t);
#pragma unroll 1
  for (int g = 0; g < hand_overs; ++g) {
    schedule(sh, blocks, nblocks, row0, n, g, t, w, wk, 1);
    rounds(wk, 1, g, s, st);
  }
""" + src[end:]
    return src


# (source stem, name, edit) of every alternative.
ALTERNATIVES = (
    ("ed25519_verify", "l1", l1),
    ("ed25519_verify", "lb1", lb1),
    ("ed25519_verify", "eager", eager),
    ("ed25519_verify", "interleave", interleave),
    ("sha512_challenge", "lockstep", lockstep),
    ("sha512_challenge", "single", single),
)


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(REPO, "build", "alternatives")
    os.makedirs(out, exist_ok=True)
    for base, name, fn in ALTERNATIVES:
        with open(os.path.join(CSRC, base + ".cu")) as fh:
            text = fn(fh.read())
        path = os.path.join(out, f"{base}_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
