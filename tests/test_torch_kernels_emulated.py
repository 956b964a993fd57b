"""The port's CUDA kernels, compiled with g++ and run on the CPU.

``tests/cuda_emu.h`` emulates what the kernels of
``tendermint_tpu_torch/csrc`` use (threads as fibers, barriers, warp
shuffles, shared memory, ``cp.async``), so the kernel source itself (its
warp roles, shared-memory layouts, digit and comb orders and hand-overs)
runs here, at a handful of blocks, where there is no card. The launchers
are cut off; a small harness calls each kernel. Every verdict must equal
the plain PyTorch version's and the host oracle's, and every challenge
hashlib's mod L (tolerance 0); K5's verdicts the sr25519 plain version's
and host oracle's. The emulation says nothing about speed.
Without g++ the tests skip.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto.hashing import reduce_mod_l, sha512_batch
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.ops import cuda_verify, ed25519_batch as teb, hash512, precompute
from tendermint_tpu_torch.ops import sr25519_batch as tsb
from tests.test_torch_resident import _parity_lanes
from tests.test_torch_sr25519_batch import fault_lanes as sr_fault_lanes

TESTS = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(TESTS), "tendermint_tpu_torch", "csrc")
# What the emulator takes in place of the CUDA-only lines of the sources.
REPLACE = (
    ("#include <cuda_runtime.h>", ""),
    ("#include <cuda_pipeline_primitives.h>", ""),
    ("extern __shared__ __align__(16) uint8_t smem[];", "uint8_t* smem = emu_smem;"),
    ('asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(kThreads) : "memory");',
     "emu_named_sync(id, kThreads);"),
    ('asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(kThreads) : "memory");',
     "emu_named_arrive(id, kThreads);"),
)

VERIFY_MAIN = r"""
#include <string>
static std::vector<uint8_t> rd(const std::string& p) {
  std::vector<uint8_t> v;
  FILE* f = fopen(p.c_str(), "rb");
  if (!f) { perror(p.c_str()); exit(1); }
  uint8_t buf[65536];
  size_t k;
  while ((k = fread(buf, 1, sizeof buf, f)) > 0) v.insert(v.end(), buf, buf + k);
  fclose(f);
  return v;
}
int main(int argc, char** argv) {
  const int which = atoi(argv[1]), n = atoi(argv[3]);
  const std::string d = argv[2];
  auto consts = rd(d + "/consts"), r = rd(d + "/r"), s = rd(d + "/s"), k = rd(d + "/k");
  std::vector<uint8_t> out(n, 7);
  const int grid = (n + kLanes - 1) / kLanes;
  if (which == 0) {
    auto pk = rd(d + "/pk");
    emu_launch(grid, kThreadsK1, [&] {
      ed25519_verify_kernel(pk.data(), r.data(), s.data(), k.data(), consts.data(), out.data(), n);
    });
  } else if (which == 1) {
    auto tab = rd(d + "/tab"), ok = rd(d + "/ok");
    emu_launch(grid, kThreadsK2, [&] {
      ed25519_verify_tables_kernel(tab.data(), ok.data(), r.data(), s.data(), k.data(),
                                   consts.data(), out.data(), n);
    });
  } else if (which == 3) {
    auto pk = rd(d + "/pk");
    emu_launch(grid, kThreadsK1, [&] {
      sr25519_verify_kernel(pk.data(), r.data(), s.data(), k.data(), consts.data(), out.data(), n);
    });
  } else {
    auto st = rd(d + "/store"), ok = rd(d + "/ok"), idx = rd(d + "/idx");
    const int cols = atoi(argv[4]);
    emu_launch(grid, kThreadsK2, [&] {
      ed25519_verify_resident_kernel(st.data(), reinterpret_cast<const int32_t*>(idx.data()),
                                     cols, ok.data(), r.data(), s.data(), k.data(),
                                     consts.data(), out.data(), n);
    });
  }
  fwrite(out.data(), 1, n, stdout);
  return 0;
}
"""

CHALLENGE_MAIN = r"""
#include <string>
int main(int argc, char** argv) {
  if (argc == 1) {  // reduce_mod_l on 64-byte values from stdin
    uint64_t x[8], o[4];
    while (fread(x, 8, 8, stdin) == 8) { reduce_mod_l(x, o); fwrite(o, 8, 4, stdout); }
    return 0;
  }
  const int n = atoi(argv[1]), nb = atoi(argv[2]), m = atoi(argv[3]);
  std::vector<uint8_t> blocks(size_t(n) * nb * 128 + 16), pad(32), out(size_t(m) * 32, 0xEE);
  if (fread(pad.data(), 1, 32, stdin) != 32) return 1;
  if (fread(blocks.data(), 1, size_t(n) * nb * 128, stdin) != size_t(n) * nb * 128) return 1;
  emu_launch((m + kLanes - 1) / kLanes, kThreads, [&] {
    sha512_challenge_kernel(blocks.data(), nb, n, pad.data(), out.data(), m);
  });
  fwrite(out.data(), 1, out.size(), stdout);
  return 0;
}
"""


def _cxx(source: str) -> str:
    with open(os.path.join(CSRC, source)) as fh:
        text = fh.read()
    text = text[: text.index('extern "C"')]
    for old, new in REPLACE:
        text = text.replace(old, new)
    assert "asm" not in text and "__shared__ __align__" not in text, "an unemulated CUDA line"
    return text


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{"verify": binary, "challenge": binary}, built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the emulated kernels need a C++ compiler")
    d = tmp_path_factory.mktemp("cuda_emu")
    procs = {}
    for name, source, main in (("verify", "ed25519_verify.cu", VERIFY_MAIN),
                               ("challenge", "sha512_challenge.cu", CHALLENGE_MAIN)):
        cpp = d / f"{name}.cpp"
        cpp.write_text('#include "cuda_emu.h"\n' + _cxx(source) + main)
        procs[name] = (d / name, subprocess.Popen(
            [gxx, "-std=c++17", "-O1", "-w", f"-I{TESTS}", "-o", str(d / name), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (binary, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ failed on the {name} kernel:\n{log}"
        out[name] = str(binary)
    return out


# --- K4 -----------------------------------------------------------------------


def _challenge(binary, mat, pad, m):
    blocks = hash512._pack(mat)
    n, nb = len(mat), blocks.shape[1] // 128
    res = subprocess.run([binary, str(n), str(nb), str(m)], check=True, capture_output=True,
                         input=pad.tobytes() + blocks.tobytes())
    return np.frombuffer(res.stdout, dtype=np.uint8).reshape(m, 32), nb


@pytest.mark.parametrize("length,n,m", [
    (0, 40, 40), (55, 33, 64), (56, 31, 31), (111, 70, 96), (112, 5, 40), (128, 32, 32),
    (250, 45, 50), (500, 33, 33),
])
def test_challenge_kernel_matches_hashlib_mod_l(emulated, length, n, m):
    """SHA-512 padding boundaries, 1-5 message blocks (the W + K ring and
    the staged rows wrap past 2 blocks), ragged blocks and pad rows."""
    rng = np.random.default_rng(length)
    mat = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
    pad = rng.integers(0, 256, 32, dtype=np.uint8)
    got, _ = _challenge(emulated["challenge"], mat, pad, m)
    want = reduce_mod_l(sha512_batch([row.tobytes() for row in mat]))
    np.testing.assert_array_equal(got[:n], want)
    np.testing.assert_array_equal(got[n:], np.tile(pad, (m - n, 1)))


def test_challenge_reduction_on_edge_values(emulated):
    """The kernel's reduce_mod_l, alone, on values at the edges of its
    quotient estimate and its final subtractions, and on seeded ones."""
    L = ref.L
    top = (2**512 - 1) // L * L
    vals = [0, 1, L - 1, L, L + 1, 2**252, 2**256 - 1, 2**256, 2**385 - 1, 2**386,
            2**512 - 1, top, top - 1, 2**512 - 1 - top]
    vals += [k * L + d for k in (1, 2**100, 2**259) for d in (0, 1, L - 1)]
    rng = np.random.default_rng(5)
    vals += [int.from_bytes(rng.bytes(64), "little") >> int(rng.integers(0, 512)) for _ in range(4000)]
    vals += [(2**512 - 1) ^ int.from_bytes(rng.bytes(40), "little") for _ in range(1000)]
    res = subprocess.run([emulated["challenge"]], check=True, capture_output=True,
                         input=b"".join(v.to_bytes(64, "little") for v in vals))
    got = [int.from_bytes(res.stdout[32 * i:32 * i + 32], "little") for i in range(len(vals))]
    bad = [hex(v) for v, g in zip(vals, got) if g != v % L]
    assert not bad, f"{len(bad)} values reduced wrongly, e.g. {bad[:3]}"


# --- K1-K3 --------------------------------------------------------------------


@pytest.fixture(scope="module")
def lanes():
    """The parity lanes (valid, bad-entry and ZIP-215 edge variants) and
    the kernels' inputs for them, in one ragged block."""
    pks, msgs, sigs = _parity_lanes()
    n = len(pks)
    inp, host_ok = teb.prepare_batch(pks, msgs, sigs, pad_to=n)
    tabs, oks = zip(*(precompute.build_table(pk) for pk in pks))
    inp_t, _ = teb._prep_table_chunk(pks, msgs, sigs, list(tabs), list(oks), n)
    want = np.array([ref.verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)])
    return pks, tabs, inp, inp_t, host_ok, want


def _projective(tab, lam):
    out = np.empty_like(tab)
    for t in range(tab.shape[0]):
        for c in range(tab.shape[1]):
            v = int.from_bytes(tab[t, c].tobytes(), "little") * lam % ref.P
            out[t, c] = np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)
    return out


def _run_verify(binary, tmp_path, which, n, files, *extra):
    files = dict(files, consts=cuda_verify.CONSTS)
    for name, arr in files.items():
        np.ascontiguousarray(arr).tofile(tmp_path / name)
    res = subprocess.run([binary, str(which), str(tmp_path), str(n), *map(str, extra)],
                         check=True, capture_output=True)
    return np.frombuffer(res.stdout, dtype=np.uint8)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("kernel", ["k1", "k2", "k2_projective", "k3_shuffled"])
def test_verify_kernels_match_plain_and_oracle(emulated, lanes, tmp_path, kernel):
    pks, tabs, inp, inp_t, host_ok, want = lanes
    n = len(pks)
    rsk = {key: inp_t[key] for key in ("r", "s", "k")}
    if kernel == "k1":
        got = _run_verify(emulated["verify"], tmp_path, 0, n, {key: inp[key] for key in ("pk", "r", "s", "k")})
        plain = teb.verify_kernel(*_t(inp["pk"], inp["r"], inp["s"], inp["k"])).numpy()
        ok = host_ok
    elif kernel == "k3_shuffled":
        keys = list(dict.fromkeys(pks))
        order = np.random.default_rng(9).permutation(len(keys))
        col_of = {keys[j]: 1 + c for c, j in enumerate(order)}
        cols = [teb._pad_table()] + [None] * len(keys)
        for pk, tab in zip(pks, tabs):
            cols[col_of[pk]] = tab
        store = np.ascontiguousarray(np.stack(cols).transpose(1, 2, 3, 0))
        idx = np.array([col_of[pk] for pk in pks], dtype=np.int32)
        got = _run_verify(emulated["verify"], tmp_path, 2, n,
                          dict(rsk, store=store, idx=idx, ok=inp_t["ok"]), store.shape[3])
        plain = teb.verify_kernel_resident(*_t(store, idx, inp_t["ok"], *rsk.values())).numpy()
        ok = host_ok
    else:
        tab = inp_t["tab"]
        if kernel == "k2_projective":  # the same points with Z != 1: the general table add
            tab = np.stack([_projective(tab[..., i], 2 + i) for i in range(n)], axis=-1)
        got = _run_verify(emulated["verify"], tmp_path, 1, n, dict(rsk, tab=tab, ok=inp_t["ok"]))
        plain = teb.verify_kernel_tables(*_t(tab, inp_t["ok"], *rsk.values())).numpy()
        ok = host_ok
    np.testing.assert_array_equal(got.astype(bool), plain)
    np.testing.assert_array_equal(got.astype(bool) & ok, want)
    assert want.any() and not want.all()


# --- K5 -----------------------------------------------------------------------


def test_sr25519_kernel_matches_plain_and_oracle(emulated, tmp_path):
    """Two blocks, the second ragged, with every planted fault; lane 0's
    key is re-encoded as its value - 19 + 2^255 (the same value mod p),
    which the kernel and the plain version must both decode as the key."""
    pks, msgs, sigs, kinds = sr_fault_lanes(n=40, seed=6)
    n = len(pks)
    inp, host_ok = tsb.prepare_batch_sr(pks, msgs, sigs, pad_to=n)
    v = int.from_bytes(inp["pk"][0].tobytes(), "little")
    inp["pk"][0] = np.frombuffer((v - 19 + 2**255).to_bytes(32, "little"), dtype=np.uint8)
    rows = {key: inp[key] for key in ("pk", "r", "s", "k")}
    got = _run_verify(emulated["verify"], tmp_path, 3, n, rows).astype(bool)
    plain = tsb.verify_kernel_sr(*_t(*rows.values())).numpy()
    np.testing.assert_array_equal(got, plain)
    want = np.array([tsr.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)])
    np.testing.assert_array_equal(got & host_ok, want)
    assert got[0] and want.any() and not want.all() and len(set(kinds.values())) == 10
