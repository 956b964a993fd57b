// FileDB native engine: log-structured KV store, C API for ctypes.
//
// A copy of tendermint_tpu/native/filedb.cc. Shares the on-disk format
// of storage/filedb.py (both packages') byte-for-byte (magic
// "TMFDB01\n"; records crc32|len|payload, payload = op|klen|key|value,
// all little-endian). The role of the reference's C++ storage backends
// (cleveldb/rocksdb behind tm-db, config/db.go:29): an ordered
// in-memory index over an append-only log with torn-tail truncation on
// open and stop-the-world compaction.
//
// Build: g++ -O2 -shared -fPIC filedb.cc -lz -o libfiledb.so (done at
// first use by storage/cfiledb.py).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'T', 'M', 'F', 'D', 'B', '0', '1', '\n'};
constexpr uint8_t kOpDel = 0;
constexpr uint8_t kOpSet = 1;

struct Entry {
  uint64_t off;  // file offset of the value bytes
  uint32_t len;
};

struct DB {
  int fd = -1;
  std::string path;
  uint64_t tail = 0;  // append offset
  uint64_t garbage = 0;
  std::map<std::string, Entry> index;
  std::mutex mu;
};

uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/arm64)
}

void wr32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }

bool read_exact(int fd, uint64_t off, void* buf, size_t n) {
  size_t done = 0;
  while (done < n) {
    ssize_t r = pread(fd, static_cast<char*>(buf) + done, n - done, off + done);
    if (r <= 0) return false;
    done += static_cast<size_t>(r);
  }
  return true;
}

bool write_all(int fd, const void* buf, size_t n) {
  size_t done = 0;
  while (done < n) {
    ssize_t r = write(fd, static_cast<const char*>(buf) + done, n - done);
    if (r <= 0) return false;
    done += static_cast<size_t>(r);
  }
  return true;
}

// Append one serialized record to a buffer.
void put_record(std::vector<uint8_t>& out, uint8_t op, const uint8_t* key,
                uint32_t klen, const uint8_t* val, uint32_t vlen) {
  uint32_t plen = 5 + klen + vlen;
  size_t base = out.size();
  out.resize(base + 8 + plen);
  uint8_t* p = out.data() + base + 8;
  p[0] = op;
  wr32(p + 1, klen);
  std::memcpy(p + 5, key, klen);
  if (vlen) std::memcpy(p + 5 + klen, val, vlen);
  uint32_t crc = crc32(0, p, plen);
  wr32(out.data() + base, crc);
  wr32(out.data() + base + 4, plen);
}

bool replay(DB* db) {
  struct stat st;
  if (fstat(db->fd, &st) != 0) return false;
  uint64_t size = static_cast<uint64_t>(st.st_size);
  uint64_t off = sizeof(kMagic);
  std::vector<uint8_t> payload;
  while (off + 8 <= size) {
    uint8_t hdr[8];
    if (!read_exact(db->fd, off, hdr, 8)) break;
    uint32_t crc = rd32(hdr), plen = rd32(hdr + 4);
    if (off + 8 + plen > size) break;
    payload.resize(plen);
    if (plen < 5 || !read_exact(db->fd, off + 8, payload.data(), plen)) break;
    if (crc32(0, payload.data(), plen) != crc) break;
    uint8_t op = payload[0];
    uint32_t klen = rd32(payload.data() + 1);
    if (5 + klen > plen) break;
    std::string key(reinterpret_cast<char*>(payload.data() + 5), klen);
    if (op == kOpSet) {
      auto it = db->index.find(key);
      if (it != db->index.end()) db->garbage++;
      db->index[key] = Entry{off + 8 + 5 + klen, plen - 5 - klen};
    } else {
      db->index.erase(key);
    }
    off += 8 + plen;
  }
  if (off < size) {
    if (ftruncate(db->fd, static_cast<off_t>(off)) != 0) return false;
  }
  db->tail = off;
  return true;
}

}  // namespace

extern "C" {

void* filedb_open(const char* path) {
  DB* db = new DB();
  db->path = path;
  bool fresh = access(path, F_OK) != 0;
  db->fd = open(path, O_RDWR | O_CREAT, 0644);
  if (db->fd < 0) {
    delete db;
    return nullptr;
  }
  if (fresh) {
    if (!write_all(db->fd, kMagic, sizeof(kMagic)) || fsync(db->fd) != 0) {
      close(db->fd);
      delete db;
      return nullptr;
    }
  } else {
    uint8_t head[sizeof(kMagic)];
    if (!read_exact(db->fd, 0, head, sizeof(kMagic)) ||
        std::memcmp(head, kMagic, sizeof(kMagic)) != 0) {
      close(db->fd);
      delete db;
      return nullptr;
    }
  }
  if (!replay(db)) {
    close(db->fd);
    delete db;
    return nullptr;
  }
  lseek(db->fd, static_cast<off_t>(db->tail), SEEK_SET);
  return db;
}

void filedb_close(void* h) {
  DB* db = static_cast<DB*>(h);
  if (!db) return;
  fsync(db->fd);
  close(db->fd);
  delete db;
}

// Returns vlen and copies into *out (malloc'd; caller frees with
// filedb_free), or -1 if absent.
int64_t filedb_get(void* h, const uint8_t* key, uint32_t klen, uint8_t** out) {
  DB* db = static_cast<DB*>(h);
  std::lock_guard<std::mutex> g(db->mu);
  auto it = db->index.find(std::string(reinterpret_cast<const char*>(key), klen));
  if (it == db->index.end()) return -1;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(it->second.len ? it->second.len : 1));
  if (!read_exact(db->fd, it->second.off, buf, it->second.len)) {
    std::free(buf);
    return -1;
  }
  *out = buf;
  return static_cast<int64_t>(it->second.len);
}

void filedb_free(void* p) { std::free(p); }

// ops buffer: repeated { op u8 | klen u32 | vlen u32 | key | value }.
// Applied as one append + optional fsync (atomic batch).
int filedb_apply(void* h, const uint8_t* ops, uint64_t ops_len, int sync) {
  DB* db = static_cast<DB*>(h);
  std::lock_guard<std::mutex> g(db->mu);
  std::vector<uint8_t> buf;
  struct Pending {
    std::string key;
    uint8_t op;
    uint64_t voff;  // offset of value within buf
    uint32_t vlen;
  };
  std::vector<Pending> pend;
  uint64_t i = 0;
  while (i < ops_len) {
    if (i + 9 > ops_len) return -1;
    uint8_t op = ops[i];
    uint32_t klen = rd32(ops + i + 1), vlen = rd32(ops + i + 5);
    i += 9;
    if (i + klen + vlen > ops_len) return -1;
    const uint8_t* key = ops + i;
    const uint8_t* val = ops + i + klen;
    i += klen + vlen;
    uint64_t voff = buf.size() + 8 + 5 + klen;
    put_record(buf, op, key, klen, val, vlen);
    pend.push_back(Pending{std::string(reinterpret_cast<const char*>(key), klen),
                           op, voff, vlen});
  }
  if (!write_all(db->fd, buf.data(), buf.size())) return -2;
  if (sync && fsync(db->fd) != 0) return -3;
  for (const auto& p : pend) {
    if (p.op == kOpSet) {
      auto it = db->index.find(p.key);
      if (it != db->index.end()) db->garbage++;
      db->index[p.key] = Entry{db->tail + p.voff, p.vlen};
    } else {
      if (db->index.erase(p.key)) db->garbage++;
    }
  }
  db->tail += buf.size();
  return 0;
}

int filedb_sync(void* h) {
  DB* db = static_cast<DB*>(h);
  std::lock_guard<std::mutex> g(db->mu);
  return fsync(db->fd) == 0 ? 0 : -1;
}

uint64_t filedb_count(void* h) {
  DB* db = static_cast<DB*>(h);
  std::lock_guard<std::mutex> g(db->mu);
  return db->index.size();
}

uint64_t filedb_garbage(void* h) {
  DB* db = static_cast<DB*>(h);
  std::lock_guard<std::mutex> g(db->mu);
  return db->garbage;
}

// Collect keys (and optionally values) in [start, end) into one
// malloc'd buffer of { klen u32 | vlen u32 | key | value }records.
// klen_s == UINT32_MAX means unbounded start; same for end.
int64_t filedb_range(void* h, const uint8_t* start, uint32_t slen,
                     const uint8_t* end, uint32_t elen, int reverse,
                     uint8_t** out) {
  DB* db = static_cast<DB*>(h);
  std::lock_guard<std::mutex> g(db->mu);
  auto lo = (slen == UINT32_MAX)
                ? db->index.begin()
                : db->index.lower_bound(
                      std::string(reinterpret_cast<const char*>(start), slen));
  auto hi = (elen == UINT32_MAX)
                ? db->index.end()
                : db->index.lower_bound(
                      std::string(reinterpret_cast<const char*>(end), elen));
  std::vector<uint8_t> buf;
  std::vector<uint8_t> val;
  auto emit = [&](const std::string& k, const Entry& e) -> bool {
    val.resize(e.len);
    if (e.len && !read_exact(db->fd, e.off, val.data(), e.len)) return false;
    size_t base = buf.size();
    buf.resize(base + 8 + k.size() + e.len);
    wr32(buf.data() + base, static_cast<uint32_t>(k.size()));
    wr32(buf.data() + base + 4, e.len);
    std::memcpy(buf.data() + base + 8, k.data(), k.size());
    if (e.len) std::memcpy(buf.data() + base + 8 + k.size(), val.data(), e.len);
    return true;
  };
  if (reverse) {
    for (auto it = hi; it != lo;) {
      --it;
      if (!emit(it->first, it->second)) return -1;
    }
  } else {
    for (auto it = lo; it != hi; ++it) {
      if (!emit(it->first, it->second)) return -1;
    }
  }
  uint8_t* ret = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
  std::memcpy(ret, buf.data(), buf.size());
  *out = ret;
  return static_cast<int64_t>(buf.size());
}

// Rewrite live records into path.compact, fsync, rename over, reopen.
int filedb_compact(void* h) {
  DB* db = static_cast<DB*>(h);
  std::lock_guard<std::mutex> g(db->mu);
  std::string tmp = db->path + ".compact";
  int out = open(tmp.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (out < 0) return -1;
  if (!write_all(out, kMagic, sizeof(kMagic))) {
    close(out);
    return -2;
  }
  std::vector<uint8_t> buf, val;
  std::map<std::string, Entry> fresh;
  uint64_t off = sizeof(kMagic);
  for (const auto& kv : db->index) {
    val.resize(kv.second.len);
    if (kv.second.len &&
        !read_exact(db->fd, kv.second.off, val.data(), kv.second.len)) {
      close(out);
      return -3;
    }
    buf.clear();
    put_record(buf, kOpSet, reinterpret_cast<const uint8_t*>(kv.first.data()),
               static_cast<uint32_t>(kv.first.size()), val.data(), kv.second.len);
    if (!write_all(out, buf.data(), buf.size())) {
      close(out);
      return -4;
    }
    fresh[kv.first] =
        Entry{off + 8 + 5 + kv.first.size(), kv.second.len};
    off += buf.size();
  }
  if (fsync(out) != 0 || rename(tmp.c_str(), db->path.c_str()) != 0) {
    close(out);
    return -5;
  }
  close(db->fd);
  db->fd = out;
  db->index.swap(fresh);
  db->tail = off;
  db->garbage = 0;
  lseek(db->fd, static_cast<off_t>(off), SEEK_SET);
  return 0;
}

}  // extern "C"
