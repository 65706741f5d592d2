// Native volume-server data plane: epoll HTTP front for GET/POST by fid.
//
// The reference serves its object hot path from compiled Go
// (weed/server/volume_server_handlers_read.go:31
// GetOrHeadHandler, volume_server_handlers_write.go:18 PostHandler,
// hot loop volume_write.go:144 doWriteRequest); the Python asyncio
// server tops out ~1k req/s/core on the same path. This library owns
// the volume server's public port and serves the two hot verbs —
// GET/HEAD and POST of a plain needle — entirely in C++: pre-parsed
// fid routing, native needle-map lookup, pread/pwrite on the .dat,
// CRC32C, zero Python in the loop. Everything else (admin RPCs, EC
// reads, deletes, range/image requests, replicated or guarded
// writes) is transparently relayed to the Python aiohttp backend on
// a loopback port, which stays the control plane.
//
// Concurrency model: one epoll IO thread runs the parser and the
// fast paths; a small pool of proxy workers does blocking relays so
// a slow admin call (vacuum, EC generate) can never stall the data
// plane. Python threads call into the same per-volume mutexes via
// the dp_* C ABI (ctypes), so the needle map has ONE authority —
// this library — while a volume is attached; detach hands the
// files back to Python for maintenance (vacuum, EC encode, copy).
//
// ABI consumers: seaweedfs_tpu_torch/native/dataplane.py.
#include <arpa/inet.h>
#include <array>
#include <cmath>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <strings.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <ctype.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli) — hardware when available, slicing table otherwise.
// Mirrors needle.py crc32c + legacy_crc_value (needle/crc.go:26-28).
// ---------------------------------------------------------------------------
uint32_t crc32c_table[8][256];
std::once_flag crc_once;

void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
    crc32c_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      crc32c_table[t][i] =
          (crc32c_table[t - 1][i] >> 8) ^ crc32c_table[0][crc32c_table[t - 1][i] & 0xFF];
}

uint32_t crc32c(uint32_t crc, const uint8_t* p, size_t n) {
  std::call_once(crc_once, crc_init);
  crc = ~crc;
#if defined(__SSE4_2__)
  while (n >= 8) {
    crc = (uint32_t)_mm_crc32_u64(crc, *(const uint64_t*)p);
    p += 8;
    n -= 8;
  }
  while (n--) crc = _mm_crc32_u8(crc, *p++);
#else
  while (n >= 8) {
    crc ^= *(const uint32_t*)p;
    uint32_t hi = *(const uint32_t*)(p + 4);
    crc = crc32c_table[7][crc & 0xFF] ^ crc32c_table[6][(crc >> 8) & 0xFF] ^
          crc32c_table[5][(crc >> 16) & 0xFF] ^ crc32c_table[4][crc >> 24] ^
          crc32c_table[3][hi & 0xFF] ^ crc32c_table[2][(hi >> 8) & 0xFF] ^
          crc32c_table[1][(hi >> 16) & 0xFF] ^ crc32c_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = crc32c_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
#endif
  return ~crc;
}

uint32_t legacy_crc_value(uint32_t c) {
  return (((c >> 15) | (c << 17)) + 0xA282EAD8u);
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}
uint64_t be64(const uint8_t* p) {
  return (uint64_t)be32(p) << 32 | be32(p + 4);
}
void put_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
void put_be64(uint8_t* p, uint64_t v) {
  put_be32(p, v >> 32);
  put_be32(p + 4, (uint32_t)v);
}

// ---------------------------------------------------------------------------
// SHA-256 + HMAC-SHA256 — for HS256 JWT verification in the front
// (security/guard.go:41 checks write tokens from compiled code; relaying
// every guarded write to Python would forfeit the fast path under the
// production config). Standard FIPS 180-4 compression, no dependencies.
// ---------------------------------------------------------------------------
constexpr uint32_t SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

struct Sha256 {
  uint32_t h[8];
  uint64_t total = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  Sha256() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    memcpy(h, init, sizeof h);
  }

  static uint32_t rotr(uint32_t x, int n) { return x >> n | x << (32 - n); }

  void block(const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++) w[i] = be32(p + 4 * i);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + SHA_K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t n) {
    total += n;
    if (buflen) {
      size_t take = std::min(n, sizeof buf - buflen);
      memcpy(buf + buflen, p, take);
      buflen += take;
      p += take;
      n -= take;
      if (buflen == 64) {
        block(buf);
        buflen = 0;
      }
    }
    while (n >= 64) {
      block(p);
      p += 64;
      n -= 64;
    }
    if (n) {
      memcpy(buf, p, n);
      buflen = n;
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = total * 8;  // captured before padding joins the stream
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buflen != 56) update(&zero, 1);
    uint8_t lenb[8];
    put_be64(lenb, bits);
    update(lenb, 8);
    for (int i = 0; i < 8; i++) put_be32(out + 4 * i, h[i]);
  }
};

// MD5 (RFC 1321 structure) — S3 object ETags are hex md5; computing
// them here keeps the gateway hot path off the GIL. The sine-derived
// round constants are generated at startup rather than transcribed.
struct Md5 {
  uint32_t h[4] = {0x67452301, 0xefcdab89, 0x98badcfe, 0x10325476};
  uint64_t total = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  static const uint32_t* table() {
    static uint32_t t[64];
    static bool init = [] {
      for (int i = 0; i < 64; i++)
        t[i] = (uint32_t)(4294967296.0 * std::fabs(std::sin(i + 1.0)));
      return true;
    }();
    (void)init;
    return t;
  }

  static uint32_t rotl(uint32_t x, int n) { return x << n | x >> (32 - n); }

  void block(const uint8_t* p) {
    static const int S[4][4] = {
        {7, 12, 17, 22}, {5, 9, 14, 20}, {4, 11, 16, 23}, {6, 10, 15, 21}};
    const uint32_t* T = table();
    uint32_t m[16];
    for (int i = 0; i < 16; i++)
      m[i] = (uint32_t)p[4 * i] | (uint32_t)p[4 * i + 1] << 8 |
             (uint32_t)p[4 * i + 2] << 16 | (uint32_t)p[4 * i + 3] << 24;
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    for (int i = 0; i < 64; i++) {
      uint32_t f;
      int g;
      if (i < 16) {
        f = (b & c) | (~b & d);
        g = i;
      } else if (i < 32) {
        f = (d & b) | (~d & c);
        g = (5 * i + 1) & 15;
      } else if (i < 48) {
        f = b ^ c ^ d;
        g = (3 * i + 5) & 15;
      } else {
        f = c ^ (b | ~d);
        g = (7 * i) & 15;
      }
      uint32_t tmp = d;
      d = c;
      c = b;
      b += rotl(a + f + T[i] + m[g], S[i >> 4][i & 3]);
      a = tmp;
    }
    h[0] += a;
    h[1] += b;
    h[2] += c;
    h[3] += d;
  }

  void update(const uint8_t* p, size_t n) {
    total += n;
    if (buflen) {
      size_t take = std::min(n, sizeof buf - buflen);
      memcpy(buf + buflen, p, take);
      buflen += take;
      p += take;
      n -= take;
      if (buflen == 64) {
        block(buf);
        buflen = 0;
      }
    }
    while (n >= 64) {
      block(p);
      p += 64;
      n -= 64;
    }
    if (n) {
      memcpy(buf, p, n);
      buflen = n;
    }
  }

  void final(uint8_t out[16]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buflen != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (8 * i));
    update(lenb, 8);
    for (int i = 0; i < 4; i++) {
      out[4 * i] = (uint8_t)h[i];
      out[4 * i + 1] = (uint8_t)(h[i] >> 8);
      out[4 * i + 2] = (uint8_t)(h[i] >> 16);
      out[4 * i + 3] = (uint8_t)(h[i] >> 24);
    }
  }
};

void hex_encode(const uint8_t* d, size_t n, char* out) {
  static const char* H = "0123456789abcdef";
  for (size_t i = 0; i < n; i++) {
    out[2 * i] = H[d[i] >> 4];
    out[2 * i + 1] = H[d[i] & 15];
  }
}

std::string md5_hex(const uint8_t* d, size_t n) {
  Md5 m;
  m.update(d, n);
  uint8_t dig[16];
  m.final(dig);
  char hx[32];
  hex_encode(dig, 16, hx);
  return std::string(hx, 32);
}

std::string sha256_hex(const uint8_t* d, size_t n) {
  Sha256 s;
  s.update(d, n);
  uint8_t dig[32];
  s.final(dig);
  char hx[64];
  hex_encode(dig, 32, hx);
  return std::string(hx, 64);
}

void hmac_sha256(const uint8_t* key, size_t keylen, const uint8_t* msg,
                 size_t msglen, uint8_t out[32]) {
  uint8_t k[64] = {0};
  if (keylen > 64) {
    Sha256 kh;
    kh.update(key, keylen);
    kh.final(k);
  } else {
    memcpy(k, key, keylen);
  }
  uint8_t ipad[64], opad[64];
  for (int i = 0; i < 64; i++) {
    ipad[i] = k[i] ^ 0x36;
    opad[i] = k[i] ^ 0x5c;
  }
  uint8_t inner[32];
  Sha256 ih;
  ih.update(ipad, 64);
  ih.update(msg, msglen);
  ih.final(inner);
  Sha256 oh;
  oh.update(opad, 64);
  oh.update(inner, 32);
  oh.final(out);
}

// base64url decode (padding optional). Returns false on any bad symbol.
bool b64url_decode(const char* s, size_t n, std::string* out) {
  while (n && s[n - 1] == '=') n--;
  out->clear();
  out->reserve(n * 3 / 4 + 3);
  uint32_t acc = 0;
  int bits = 0;
  for (size_t i = 0; i < n; i++) {
    char c = s[i];
    int v = c >= 'A' && c <= 'Z'   ? c - 'A'
            : c >= 'a' && c <= 'z' ? c - 'a' + 26
            : c >= '0' && c <= '9' ? c - '0' + 52
            : c == '-'             ? 62
            : c == '_'             ? 63
            : c == '+'             ? 62  // tolerate standard alphabet
            : c == '/'             ? 63
                                   : -1;
    if (v < 0) return false;
    acc = acc << 6 | v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out->push_back((char)(acc >> bits & 0xFF));
    }
  }
  return true;
}

bool const_time_eq(const uint8_t* a, const uint8_t* b, size_t n) {
  uint8_t d = 0;
  for (size_t i = 0; i < n; i++) d |= a[i] ^ b[i];
  return d == 0;
}

// base64url encode, unpadded (the JWT segment alphabet).
void b64url_encode(const uint8_t* d, size_t n, std::string* out) {
  static const char T[] =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_";
  out->clear();
  out->reserve((n + 2) / 3 * 4);
  size_t i = 0;
  for (; i + 3 <= n; i += 3) {
    uint32_t v = (uint32_t)d[i] << 16 | (uint32_t)d[i + 1] << 8 | d[i + 2];
    out->push_back(T[v >> 18]);
    out->push_back(T[v >> 12 & 63]);
    out->push_back(T[v >> 6 & 63]);
    out->push_back(T[v & 63]);
  }
  if (n - i == 1) {
    uint32_t v = (uint32_t)d[i] << 16;
    out->push_back(T[v >> 18]);
    out->push_back(T[v >> 12 & 63]);
  } else if (n - i == 2) {
    uint32_t v = (uint32_t)d[i] << 16 | (uint32_t)d[i + 1] << 8;
    out->push_back(T[v >> 18]);
    out->push_back(T[v >> 12 & 63]);
    out->push_back(T[v >> 6 & 63]);
  }
}

// ---------------------------------------------------------------------------
// Needle record constants (needle.py / needle_write.go:20-110 layout)
// ---------------------------------------------------------------------------
constexpr int HEADER = 16;  // cookie(4) id(8) size(4), all big-endian
constexpr int PADDING = 8;
constexpr int CHECKSUM = 4;
constexpr int TS = 8;  // append_at_ns, version 3 only
constexpr uint8_t FLAG_IS_COMPRESSED = 0x01;
constexpr uint8_t FLAG_IS_CHUNK_MANIFEST = 0x80;
constexpr uint8_t FLAG_HAS_NAME = 0x02;
constexpr uint8_t FLAG_HAS_MIME = 0x04;
constexpr uint8_t FLAG_HAS_LAST_MODIFIED = 0x08;
constexpr uint8_t FLAG_HAS_TTL = 0x10;
constexpr uint8_t FLAG_HAS_PAIRS = 0x20;

int64_t disk_size(int64_t body, int version) {
  int64_t total = HEADER + body + CHECKSUM + (version == 3 ? TS : 0);
  return total + (PADDING - total % PADDING);  // full 8 pad when aligned
}

// ---------------------------------------------------------------------------
// Volume registry
// ---------------------------------------------------------------------------
struct MapVal {
  int64_t offset;  // byte offset in .dat
  int32_t size;    // body size; <0 = tombstone
};

struct Vol {
  std::mutex mu;
  int dat_fd = -1;
  int idx_fd = -1;
  int version = 3;
  int offset_size = 4;  // index offset width: 4 or 5 bytes
  bool read_only = false;
  bool has_replicas = false;
  int64_t tail = 0;      // .dat append offset
  int64_t idx_tail = 0;  // .idx append offset
  uint64_t last_append_ns = 0;
  // counters mirror needle_map.py NeedleMap accounting exactly
  int64_t file_count = 0, file_bytes = 0;
  int64_t deleted_count = 0, deleted_bytes = 0;
  uint64_t max_key = 0;
  // set under mu by dp_detach: an op that resolved this Vol just before
  // the detach must notice and bail instead of appending to files that
  // Python is about to vacuum/replace
  bool detached = false;
  // replica peer "host:port" list, pushed by the Python control plane
  // from master lookups (store_replicate.go:191 resolves the same way
  // from the masterClient vidMap). peers_stale is set on any fan-out
  // failure: writes then relay to Python (which re-resolves) until the
  // next peer refresh clears it.
  std::vector<std::string> peers;
  bool peers_stale = false;
  std::unordered_map<uint64_t, MapVal> map;

  ~Vol() {
    if (dat_fd >= 0) close(dat_fd);
    if (idx_fd >= 0) close(idx_fd);
  }

  // put/delete replicate NeedleMap.put/.delete counter semantics
  void put(uint64_t key, int64_t off, int32_t size) {
    auto it = map.find(key);
    if (it != map.end() && it->second.size > 0) {
      deleted_count++;
      deleted_bytes += it->second.size;
      file_count--;
      file_bytes -= it->second.size;
    }
    map[key] = {off, size};
    if (size > 0) {
      file_count++;
      file_bytes += size;
    }
    if (key > max_key) max_key = key;
  }

  int64_t del(uint64_t key) {
    auto it = map.find(key);
    if (it == map.end() || it->second.size <= 0) return 0;
    int64_t reclaimed = it->second.size;
    it->second.size = -1;
    deleted_count++;
    deleted_bytes += reclaimed;
    file_count--;
    file_bytes -= reclaimed;
    return reclaimed;
  }

  // append one .idx log entry: key(8 BE) offset-units(4|5) size-u32(4 BE)
  int write_idx(uint64_t key, int64_t byte_off, uint32_t size_u32) {
    uint8_t e[17];
    put_be64(e, key);
    uint64_t units = (uint64_t)(byte_off / PADDING);
    int n;
    if (offset_size == 4) {
      put_be32(e + 8, (uint32_t)units);
      put_be32(e + 12, size_u32);
      n = 16;
    } else {  // 5-byte: 4 BE low bytes then one high byte (offset_5bytes.go)
      put_be32(e + 8, (uint32_t)(units & 0xFFFFFFFF));
      e[12] = (uint8_t)(units >> 32);
      put_be32(e + 13, size_u32);
      n = 17;
    }
    if (pwrite(idx_fd, e, n, idx_tail) != n) return -1;
    idx_tail += n;
    return 0;
  }
};

std::shared_mutex vols_mu;
// shared_ptr: a fast-path request may still hold the Vol while a
// concurrent dp_detach removes it from the registry
std::unordered_map<uint32_t, std::shared_ptr<Vol>> vols;
std::atomic<bool> jwt_required{false};
std::shared_mutex jwt_mu;
std::string jwt_secret;  // under jwt_mu; non-empty iff jwt_required

// server roles; N_ROLES sizes the per-role fault/counter tables below
constexpr int ROLE_VOLUME = 0;
constexpr int ROLE_S3 = 1;
constexpr int ROLE_FILER = 2;
constexpr int N_ROLES = 3;

// Which role's server the current thread serves. Every native response
// is written on the owning server's IO/worker thread (channel acks
// included: chan_read runs on that server's IO thread), so a
// thread_local set once at thread start routes gate_request and
// count_resp to the right per-role slot without threading a Server*
// through every call site. Threads that never serve requests (bench
// clients) keep the volume default and never call either function.
thread_local int t_role = ROLE_VOLUME;

// fault injection (utils/faults.py subset): error probability + fixed
// delay per op class and role, set at spawn via dp_faults /
// dp_role_faults before traffic. Rates/delays are written before
// faults_on flips, so relaxed reads from the IO threads are safe; the
// seeded RNG sits under its own mutex so a fixed seed gives one
// deterministic decision sequence.
std::atomic<bool> faults_on[N_ROLES] = {{false}, {false}, {false}};
std::mutex faults_mu;
double fault_read_err[N_ROLES] = {0}, fault_write_err[N_ROLES] = {0};
double fault_read_delay[N_ROLES] = {0}, fault_write_delay[N_ROLES] = {0};
uint64_t fault_rng = 0x9E3779B97F4A7C15ull;

// splitmix64 step -> uniform double in [0, 1)
double fault_roll() {
  std::lock_guard<std::mutex> lk(faults_mu);
  uint64_t z = (fault_rng += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  z ^= z >> 31;
  return (double)(z >> 11) * 0x1.0p-53;
}

void set_role_faults(int role, double read_err, double write_err,
                     double read_delay, double write_delay,
                     uint64_t seed) {
  auto clamp01 = [](double v) { return v < 0 ? 0 : (v > 1 ? 1 : v); };
  std::lock_guard<std::mutex> lk(faults_mu);
  fault_read_err[role] = clamp01(read_err);
  fault_write_err[role] = clamp01(write_err);
  fault_read_delay[role] = read_delay < 0 ? 0 : read_delay;
  fault_write_delay[role] = write_delay < 0 ? 0 : write_delay;
  fault_rng = seed ? seed : 0x9E3779B97F4A7C15ull;
  faults_on[role].store(fault_read_err[role] > 0 ||
                        fault_write_err[role] > 0 ||
                        fault_read_delay[role] > 0 ||
                        fault_write_delay[role] > 0);
}

double wall_now() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (double)ts.tv_sec + ts.tv_nsec * 1e-9;
}

std::shared_ptr<Vol> find_vol(uint32_t vid) {
  std::shared_lock<std::shared_mutex> lk(vols_mu);
  auto it = vols.find(vid);
  return it == vols.end() ? nullptr : it->second;
}

// request counters, surfaced through dp_http_stats
std::atomic<int64_t> n_fast_get{0}, n_fast_post{0}, n_proxied{0}, n_errors{0};
std::atomic<int64_t> n_fast_delete{0}, n_repl_post{0}, n_jwt_reject{0},
    n_fanout_fail{0};

// front visibility counters, surfaced through dp_front_stats (summed
// across roles) and dp_role_front_stats (per role): responses the
// native front wrote itself, bucketed by status class, plus payload
// bytes in (uploaded bodies) / out (served bodies). The host process
// merges them into /metrics as native_front_requests_total{code} /
// native_front_bytes_total, so -dataplane native traffic shows up in
// the cluster metrics federation like any Python-served request.
struct FrontStats {
  std::atomic<int64_t> n_2xx{0}, n_3xx{0}, n_4xx{0}, n_5xx{0};
  std::atomic<int64_t> bytes_in{0}, bytes_out{0};
};
FrontStats front_stats[N_ROLES];

void count_resp(int code, int64_t bytes_out) {
  FrontStats& fs = front_stats[t_role];
  if (code < 300)
    fs.n_2xx++;
  else if (code < 400)
    fs.n_3xx++;
  else if (code < 500)
    fs.n_4xx++;
  else
    fs.n_5xx++;
  if (bytes_out > 0) fs.bytes_out += bytes_out;
}

// ---------------------------------------------------------------------------
// JWT (HS256) verification — mirrors utils/security.py verify_jwt +
// Guard.check and the reference's maybeCheckJwtAuthorization
// (volume_server_handlers.go:145-187): signature, exp, and fid claim
// with the `_N` batch-slot suffix stripped before comparison (:181).
// ---------------------------------------------------------------------------
enum class JwtRes {
  OK,      // verified (or not required)
  REJECT,  // definitively bad: missing/expired/bad signature/fid mismatch
  UNSURE,  // structurally odd token: relay to Python for the verdict
};

// Scan a flat JSON object for an integer field. Handles only the shape
// our own signers emit ({"exp": 123, "fid": "..."}); anything fancier
// returns false and the caller downgrades to UNSURE.
bool json_int_field(const std::string& js, const char* name, int64_t* out) {
  std::string pat = std::string("\"") + name + "\"";
  size_t p = js.find(pat);
  if (p == std::string::npos) return false;
  p += pat.size();
  while (p < js.size() && (js[p] == ' ' || js[p] == ':')) p++;
  if (p >= js.size() || !isdigit((unsigned char)js[p])) return false;
  int64_t v = 0;
  while (p < js.size() && isdigit((unsigned char)js[p]))
    v = v * 10 + (js[p++] - '0');
  *out = v;
  return true;
}

bool json_str_field(const std::string& js, const char* name,
                    std::string* out, bool* malformed) {
  std::string pat = std::string("\"") + name + "\"";
  size_t p = js.find(pat);
  if (p == std::string::npos) return false;
  p += pat.size();
  while (p < js.size() && (js[p] == ' ' || js[p] == ':')) p++;
  if (p >= js.size() || js[p] != '"') return false;
  p++;
  size_t e = p;
  while (e < js.size() && js[e] != '"') {
    if (js[e] == '\\') {  // escapes never appear in fid strings we mint
      *malformed = true;
      return false;
    }
    e++;
  }
  if (e >= js.size()) {
    *malformed = true;
    return false;
  }
  out->assign(js, p, e - p);
  return true;
}

// `fid`/`fid_len`: the request fid as it appears in the path (no
// leading slash, extension already excluded), INCLUDING any _N suffix —
// stripped here exactly like the reference.
JwtRes jwt_check(const char* auth, size_t auth_len, const char* fid,
                 size_t fid_len) {
  if (!jwt_required.load(std::memory_order_relaxed)) return JwtRes::OK;
  if (!auth || auth_len < 8 || strncasecmp(auth, "Bearer ", 7) != 0)
    return JwtRes::REJECT;  // Guard.check: missing jwt
  const char* tok = auth + 7;
  size_t toklen = auth_len - 7;
  const char* d1 = (const char*)memchr(tok, '.', toklen);
  if (!d1) return JwtRes::REJECT;
  const char* d2 =
      (const char*)memchr(d1 + 1, '.', tok + toklen - d1 - 1);
  if (!d2) return JwtRes::REJECT;
  std::string sig;
  if (!b64url_decode(d2 + 1, tok + toklen - d2 - 1, &sig) || sig.size() != 32)
    return JwtRes::REJECT;
  uint8_t expect[32];
  {
    std::shared_lock<std::shared_mutex> lk(jwt_mu);
    hmac_sha256((const uint8_t*)jwt_secret.data(), jwt_secret.size(),
                (const uint8_t*)tok, d2 - tok, expect);
  }
  if (!const_time_eq(expect, (const uint8_t*)sig.data(), 32))
    return JwtRes::REJECT;
  std::string payload;
  if (!b64url_decode(d1 + 1, d2 - d1 - 1, &payload)) return JwtRes::UNSURE;
  int64_t exp = 0;
  if (!json_int_field(payload, "exp", &exp)) {
    // Python treats a missing exp as 0 => expired; a non-integer exp
    // (float/exotic) is a token we didn't mint: let Python decide
    if (payload.find("\"exp\"") != std::string::npos) return JwtRes::UNSURE;
  }
  if (exp < (int64_t)time(nullptr)) return JwtRes::REJECT;
  bool malformed = false;
  std::string claim_fid;
  if (json_str_field(payload, "fid", &claim_fid, &malformed) &&
      !claim_fid.empty()) {
    const char* us = (const char*)memrchr(fid, '_', fid_len);
    size_t base_len = us ? (size_t)(us - fid) : fid_len;
    if (claim_fid.size() != base_len ||
        memcmp(claim_fid.data(), fid, base_len) != 0)
      return JwtRes::REJECT;
  } else if (malformed) {
    return JwtRes::UNSURE;
  } else {
    // missing/empty fid claim: the reference requires an exact claim match
    // (volume_server_handlers.go:183) — a fid-less signed token is not a
    // universal write token
    return JwtRes::REJECT;
  }
  return JwtRes::OK;
}

// Mint the replication-channel handshake token: HS256 over the shared
// cluster secret with the reserved claim fid ".swrp" (a name no data
// fid can take — parse_fid_path rejects it). Only secret holders can
// mint it, and it is NOT a data-write token: jwt_check never matches
// ".swrp" against a real fid. Channel auth replaces the reference's
// per-replicate JWT forwarding (security/guard.go:41) — same trust
// root, one verification per connection instead of per write.
std::string mint_swrp_token() {
  std::shared_lock<std::shared_mutex> lk(jwt_mu);
  if (jwt_secret.empty()) return "";
  // {"alg":"HS256","typ":"JWT"} pre-encoded
  std::string signing = "eyJhbGciOiJIUzI1NiIsInR5cCI6IkpXVCJ9.";
  char pl[96];
  int n = snprintf(pl, sizeof pl, "{\"exp\": %lld, \"fid\": \".swrp\"}",
                   (long long)time(nullptr) + 300);
  std::string seg;
  b64url_encode((const uint8_t*)pl, (size_t)n, &seg);
  signing += seg;
  uint8_t mac[32];
  hmac_sha256((const uint8_t*)jwt_secret.data(), jwt_secret.size(),
              (const uint8_t*)signing.data(), signing.size(), mac);
  b64url_encode(mac, 32, &seg);
  return signing + "." + seg;
}

// ---------------------------------------------------------------------------
// HTTP front
// ---------------------------------------------------------------------------
struct Request {
  // views into Conn::in — valid only until the buffer is consumed
  const char* method = nullptr;
  size_t method_len = 0;
  const char* path = nullptr;  // path only, query excluded
  size_t path_len = 0;
  const char* query = nullptr;  // bytes after '?' (before any fragment)
  size_t query_len = 0;
  bool has_query = false;
  bool is_replicate = false;  // query is exactly "type=replicate"
  size_t head_len = 0;   // request line + headers + CRLFCRLF
  int64_t content_len = 0;
  bool chunked = false;
  bool keep_alive = true;
  bool accept_gzip = false;
  bool expect_100 = false;
  bool plain_upload = true;  // content-type empty or octet-stream
  bool proxy_only = false;   // seaweed-* metadata headers present
  const char* auth = nullptr;  // Authorization header value
  size_t auth_len = 0;
  const char* range = nullptr;  // Range header value
  size_t range_len = 0;
  const char* traceparent = nullptr;  // W3C trace context, relayed as-is
  size_t traceparent_len = 0;
  double deadline = 0;  // X-Sw-Deadline: absolute epoch seconds, 0 = none
};

// epoll data.ptr discrimination: Conn and PeerConn both lead with an
// int kind so the IO loop can tell them apart (both standard-layout,
// first-member address == struct address)
constexpr int KIND_CLIENT = 1;
constexpr int KIND_PEER = 2;
constexpr int KIND_CHAN = 3;  // S3 front <-> python filer channel

struct Conn {
  int kind = KIND_CLIENT;
  int fd = -1;
  std::string in;        // buffered request bytes
  size_t in_off = 0;     // consumed prefix
  std::string out;       // pending response bytes
  size_t out_off = 0;
  bool want_close = false;
  bool in_epoll = false;
  bool sent_100 = false;  // 100-continue sent for the current request
  // async replica fan-out state: while an op is in flight the conn's
  // pump is gated (response ordering) and a client disconnect turns
  // the conn into a zombie freed when the op concludes
  bool repl_pending = false;
  bool zombie = false;
  // conn upgraded to the binary replication protocol (SWRP): the
  // buffer carries frames, not HTTP, from the upgrade on
  bool swrp = false;
  time_t last_active = 0;
  int backend_fd = -1;  // persistent backend conn for this client conn
};

struct PeerConn;
struct S3Op;

// epoll tag for the S3 entry channel (leads with kind, like Conn)
struct ChanTag {
  int kind = KIND_CHAN;
};

// Group-commit handoff (storage/commit.py's native twin): one
// enqueued append waiting for the covering batch fsync. rop != null
// gates a volume-front op (the waiter IS the fsync token counted in
// ReplOp.waiting); otherwise s3_id names a chan-gated S3/filer op in
// the owning server's s3_pending. Completions are delivered back to
// the owning server's IO thread through commit_done + eventfd, the
// same handoff worker_loop uses for returned conns.
struct Server;

// One gated client op on the volume front (defined here, ahead of the
// fan-out machinery that owns it, because both the replica fan-out and
// the group-commit fsync token count into `waiting`): the client's
// response is sent from finalize_repl when the last outstanding
// peer ack / fsync completion lands. See the fan-out block below.
struct ReplOp {
  Conn* client;  // zombie-aware: finalize checks before responding
  std::shared_ptr<Vol> v;
  bool is_delete = false;
  bool keep_alive = true;
  int64_t size = 0;  // body_len (post) / reclaimed (delete)
  uint32_t crc = 0;
  int waiting = 0;  // peer acks + fsync tokens outstanding
  bool failed = false;
  bool plain = false;  // no peer wires: group-commit-gated fast post
  std::string failed_peer;
};

struct CommitWaiter {
  Server* s = nullptr;
  ReplOp* rop = nullptr;
  uint64_t s3_id = 0;
  int64_t nbytes = 0;
};

struct Server {
  int role = ROLE_VOLUME;
  uint16_t backend_port = 0;
  int listen_fd = -1;
  int epoll_fd = -1;
  int event_fd = -1;  // wakes the IO thread for returned conns / stop
  std::atomic<bool> stop{false};
  std::thread io_thread;
  std::vector<std::thread> workers;
  // proxy handoff
  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<Conn*> proxy_q;
  std::mutex ret_mu;
  std::deque<Conn*> returned;
  // fsync completions for this server's gated writes (guarded by
  // ret_mu, drained in io_loop's eventfd branch with `returned`)
  std::deque<CommitWaiter> commit_done;
  std::unordered_map<int, Conn*> conns;
  // replica-peer keep-alive conns, IO-thread-only (async fan-out)
  std::unordered_map<std::string, PeerConn*> peer_conns;
  // peers with freshly queued wires: flushed once per epoll batch so a
  // burst of client writes rides ONE writev per peer (syscall collapse
  // on this side; one recv + one coalesced ack burst on the replica)
  std::vector<PeerConn*> dirty_peers;
  time_t last_peer_sweep = 0;
  // conn currently inside pump(): a synchronous fan-out failure must
  // not re-enter that conn's pump from finalize_repl
  Conn* pumping = nullptr;
  // S3/filer roles only: the entry channel to the in-process python
  // filer. Records out (TSV lines, see s3_handle_put), acks in
  // ("id status\n"); both batched per epoll pass like the peer wires.
  int chan_fd = -1;
  ChanTag chan_tag;
  bool chan_in_epoll = false;
  std::string chan_out;
  size_t chan_out_off = 0;
  std::string chan_in;
  size_t chan_in_off = 0;
  std::unordered_map<uint64_t, S3Op*> s3_pending;
  uint64_t next_op_id = 1;
};

Server* g_srv = nullptr;      // volume front (one per process)
Server* g_s3srv = nullptr;    // S3 front (combined-server processes)
Server* g_filersrv = nullptr; // filer front (combined-server processes)

void set_nonblock(int fd, bool nb) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, nb ? (fl | O_NONBLOCK) : (fl & ~O_NONBLOCK));
}

bool ieq(const char* a, size_t alen, const char* b) {
  size_t blen = strlen(b);
  if (alen != blen) return false;
  for (size_t i = 0; i < alen; i++)
    if (tolower((unsigned char)a[i]) != tolower((unsigned char)b[i])) return false;
  return true;
}

bool icontains(const char* s, size_t n, const char* needle) {
  size_t m = strlen(needle);
  if (m > n) return false;
  for (size_t i = 0; i + m <= n; i++) {
    size_t j = 0;
    while (j < m && tolower((unsigned char)s[i + j]) == needle[j]) j++;
    if (j == m) return true;
  }
  return false;
}

// Parse request head out of buf[off..len). Returns head length (>0), 0 if
// incomplete, -1 on malformed input.
ssize_t parse_head(const char* buf, size_t len, Request* r) {
  const char* end = (const char*)memmem(buf, len, "\r\n\r\n", 4);
  if (!end) return len > (64 << 10) ? -1 : 0;
  size_t head_len = end - buf + 4;
  const char* line_end = (const char*)memmem(buf, head_len, "\r\n", 2);
  if (!line_end) return -1;
  const char* sp1 = (const char*)memchr(buf, ' ', line_end - buf);
  if (!sp1) return -1;
  const char* sp2 = (const char*)memchr(sp1 + 1, ' ', line_end - sp1 - 1);
  if (!sp2) return -1;
  r->method = buf;
  r->method_len = sp1 - buf;
  const char* target = sp1 + 1;
  size_t target_len = sp2 - target;
  const char* q = (const char*)memchr(target, '?', target_len);
  r->path = target;
  r->path_len = q ? (size_t)(q - target) : target_len;
  r->has_query = q != nullptr;
  if (q) {
    r->query = q + 1;
    r->query_len = target + target_len - (q + 1);
    r->is_replicate =
        r->query_len == 14 && memcmp(r->query, "type=replicate", 14) == 0;
  }
  r->keep_alive = memmem(line_end - 3, 3, "1.1", 3) != nullptr;
  r->head_len = head_len;
  r->content_len = 0;
  // header scan
  const char* p = line_end + 2;
  while (p < buf + head_len - 2) {
    const char* le = (const char*)memmem(p, buf + head_len - p, "\r\n", 2);
    if (!le) break;
    const char* colon = (const char*)memchr(p, ':', le - p);
    if (colon) {
      size_t klen = colon - p;
      const char* v = colon + 1;
      while (v < le && *v == ' ') v++;
      size_t vlen = le - v;
      if (ieq(p, klen, "content-length")) {
        r->content_len = strtoll(std::string(v, vlen).c_str(), nullptr, 10);
      } else if (ieq(p, klen, "transfer-encoding")) {
        if (icontains(v, vlen, "chunked")) r->chunked = true;
      } else if (ieq(p, klen, "connection")) {
        if (icontains(v, vlen, "close")) r->keep_alive = false;
        if (icontains(v, vlen, "keep-alive")) r->keep_alive = true;
      } else if (ieq(p, klen, "accept-encoding")) {
        if (icontains(v, vlen, "gzip")) r->accept_gzip = true;
      } else if (ieq(p, klen, "expect")) {
        if (icontains(v, vlen, "100-continue")) r->expect_100 = true;
      } else if (ieq(p, klen, "content-type")) {
        r->plain_upload =
            vlen == 0 || icontains(v, vlen, "application/octet-stream");
      } else if (ieq(p, klen, "authorization")) {
        r->auth = v;
        r->auth_len = vlen;
      } else if (ieq(p, klen, "range")) {
        r->range = v;
        r->range_len = vlen;
      } else if (ieq(p, klen, "traceparent")) {
        r->traceparent = v;
        r->traceparent_len = vlen;
      } else if (ieq(p, klen, "x-sw-deadline")) {
        double d = strtod(std::string(v, vlen).c_str(), nullptr);
        if (d > 0) r->deadline = d;
      } else if (ieq(p, klen, "content-encoding")) {
        r->proxy_only = true;  // pre-compressed body: python sets the needle flag
      } else if (klen >= 8 && ieq(p, 8, "seaweed-")) {
        r->proxy_only = true;  // metadata pairs: python builds the needle
      }
    }
    p = le + 2;
  }
  return (ssize_t)head_len;
}

// How many body bytes (after the head) does this request carry, given what
// is buffered? For chunked, returns -1 until the terminating chunk is
// buffered, then the framed length. `avail` excludes the head.
int64_t body_len_buffered(const Request& r, const char* body, size_t avail,
                          bool* complete) {
  if (!r.chunked) {
    *complete = (int64_t)avail >= r.content_len;
    return r.content_len;
  }
  // walk chunk frames
  size_t pos = 0;
  while (true) {
    const char* le = (const char*)memmem(body + pos, avail - pos, "\r\n", 2);
    if (!le) {
      *complete = false;
      return -1;
    }
    long sz = strtol(std::string(body + pos, le - (body + pos)).c_str(), nullptr, 16);
    size_t next = (le - body) + 2 + sz + 2;  // chunk data + CRLF
    if (sz == 0) {
      // optional trailers until CRLFCRLF; we sent none and accept none
      *complete = next <= avail;
      return *complete ? (int64_t)next : -1;
    }
    if (next > avail) {
      *complete = false;
      return -1;
    }
    pos = next;
  }
}

// fid path: "/<vid>,<keyhex><cookie8hex>[_delta][.ext]"
// (types.py parse_file_id / needle.go ParsePath:121-141)
bool parse_fid_path(const char* p, size_t n, uint32_t* vid, uint64_t* key,
                    uint32_t* cookie) {
  if (n < 2 || p[0] != '/') return false;
  p++;
  n--;
  // strip extension
  const char* dot = (const char*)memchr(p, '.', n);
  if (dot) n = dot - p;
  const char* comma = (const char*)memchr(p, ',', n);
  if (!comma) return false;
  uint64_t v = 0;
  for (const char* c = p; c < comma; c++) {
    if (*c < '0' || *c > '9') return false;
    v = v * 10 + (*c - '0');
    if (v > 0xFFFFFFFFull) return false;
  }
  const char* rest = comma + 1;
  size_t rlen = n - (comma + 1 - p);
  uint64_t delta = 0;
  const char* us = (const char*)memrchr(rest, '_', rlen);
  if (us) {
    for (const char* c = us + 1; c < rest + rlen; c++) {
      if (*c < '0' || *c > '9') return false;
      delta = delta * 10 + (*c - '0');
    }
    rlen = us - rest;
  }
  if (rlen <= 8 || rlen > 24) return false;
  uint64_t k = 0;
  for (size_t i = 0; i < rlen - 8; i++) {
    char c = rest[i];
    int d = c >= '0' && c <= '9'   ? c - '0'
            : c >= 'a' && c <= 'f' ? c - 'a' + 10
            : c >= 'A' && c <= 'F' ? c - 'A' + 10
                                   : -1;
    if (d < 0) return false;
    k = k << 4 | d;
  }
  uint32_t ck = 0;
  for (size_t i = rlen - 8; i < rlen; i++) {
    char c = rest[i];
    int d = c >= '0' && c <= '9'   ? c - '0'
            : c >= 'a' && c <= 'f' ? c - 'a' + 10
            : c >= 'A' && c <= 'F' ? c - 'A' + 10
                                   : -1;
    if (d < 0) return false;
    ck = ck << 4 | d;
  }
  *vid = (uint32_t)v;
  *key = k + delta;
  *cookie = ck;
  return true;
}

// `extra` is a pre-formatted header block ("K: v\r\n..." or "")
void simple_response_x(Conn* c, int code, const char* text, bool keep_alive,
                       const char* extra) {
  const char* reason = code == 200   ? "OK"
                       : code == 201 ? "Created"
                       : code == 202 ? "Accepted"
                       : code == 400 ? "Bad Request"
                       : code == 401 ? "Unauthorized"
                       : code == 403 ? "Forbidden"
                       : code == 404 ? "Not Found"
                       : code == 409 ? "Conflict"
                       : code == 416 ? "Requested Range Not Satisfiable"
                       : code == 500 ? "Internal Server Error"
                       : code == 502 ? "Bad Gateway"
                       : code == 503 ? "Service Unavailable"
                       : code == 504 ? "Gateway Timeout"
                                     : "Error";
  char head[384];
  int body_len = (int)strlen(text);
  int n = snprintf(head, sizeof head,
                   "HTTP/1.1 %d %s\r\nContent-Length: %d\r\n"
                   "Content-Type: text/plain\r\n%s%s\r\n",
                   code, reason, body_len, extra,
                   keep_alive ? "" : "Connection: close\r\n");
  c->out.append(head, n);
  c->out.append(text, body_len);
  if (!keep_alive) c->want_close = true;
  count_resp(code, body_len);
}

void simple_response(Conn* c, int code, const char* text, bool keep_alive) {
  simple_response_x(c, code, text, keep_alive, "");
}

// Deadline + fault gate, run on every parsed client request before
// dispatch. Replication hops are exempt: the primary already charged
// the client-facing deadline/fault budget for this write once.
// Returns false = pass, true = answered here (caller moves to the
// next pipelined request; when the body was not fully buffered the
// conn is close-marked so the unread stream cannot desync framing).
// Injected delays run on the IO thread on purpose: a slow front stalls
// every conn it owns, which is the failure mode being modelled.
bool gate_request(Conn* c, const Request& r, size_t avail) {
  if (r.is_replicate) return false;
  int deny = 0;
  const char* extra = "";
  if (r.deadline > 0 && wall_now() >= r.deadline) {
    deny = 504;
  } else if (faults_on[t_role].load(std::memory_order_relaxed)) {
    // same carve-outs as faults.aiohttp_middleware's _SKIP_PATHS
    static const char* kSkip[] = {"/metrics", "/debug/traces",
                                  "/debug/breakers", "/status", "/healthz"};
    for (const char* sp : kSkip)
      if (r.path_len == strlen(sp) && memcmp(r.path, sp, r.path_len) == 0)
        return false;
    bool is_read = ieq(r.method, r.method_len, "GET") ||
                   ieq(r.method, r.method_len, "HEAD") ||
                   ieq(r.method, r.method_len, "OPTIONS");
    double delay, prob;
    {
      std::lock_guard<std::mutex> lk(faults_mu);
      delay = is_read ? fault_read_delay[t_role] : fault_write_delay[t_role];
      prob = is_read ? fault_read_err[t_role] : fault_write_err[t_role];
    }
    if (delay > 0) usleep((useconds_t)(delay * 1e6));
    if (prob > 0 && fault_roll() < prob) {
      deny = 503;
      // same contract as faults.aiohttp_middleware: the handler never
      // ran, so the retry layer may replay blindly
      extra = "X-Sw-Retryable: 1\r\nRetry-After: 0\r\n";
    }
  }
  if (!deny) return false;
  n_errors++;
  const char* text = deny == 504 ? "deadline exceeded" : "fault injected";
  bool complete = false;
  int64_t blen = body_len_buffered(r, c->in.data() + c->in_off + r.head_len,
                                   avail - r.head_len, &complete);
  if (complete) {
    simple_response_x(c, deny, text, r.keep_alive, extra);
    c->in_off += r.head_len + (size_t)blen;
    c->sent_100 = false;
    return true;
  }
  // body still in flight: answer-and-close, discard whatever arrives
  simple_response_x(c, deny, text, false, extra);
  c->in.clear();
  c->in_off = 0;
  return true;
}

uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
}

// ---------------------------------------------------------------------------
// Group commit (dp_set_commit): one committer thread shared by every
// front in the process coalesces appended-but-unacked writes and
// makes ONE fsync per dirty volume per batch window — the Haystack
// amortization: concurrent needles share a contiguous .dat extent.
// Modes mirror storage/commit.py: 0=buffered (ack after pwrite,
// today's semantics, no commit machinery at all — native appends are
// unbuffered pwrites), 1=batch (ack from the fsync-completion
// callback), 2=sync (inline per-write fsync oracle).
//
// Lock discipline (commit-fsync contract, lock_discipline.py): the
// committer snapshots the queue under commit_mu, RELEASES it, and
// only then fsyncs — never under commit_mu and never under v->mu.
// fd lifetime is safe lock-free: dat_fd/idx_fd close only in ~Vol
// and the dirty map holds the shared_ptr until delivery.
// ---------------------------------------------------------------------------
std::atomic<int> commit_mode{0};  // 0 buffered / 1 batch / 2 sync
std::atomic<int64_t> commit_max_delay_ns{2000000};  // -commit.maxDelay
std::atomic<int64_t> commit_max_bytes_cfg{4 << 20};  // -commit.maxBytes
// monotonic stats, surfaced via dp_commit_stats
std::atomic<int64_t> n_commit_batches{0};
std::atomic<int64_t> n_commit_fsyncs{0};  // fsync() syscalls made
std::atomic<int64_t> n_commit_writes{0};  // writes that paid a commit
std::atomic<int64_t> n_commit_bytes{0};
std::atomic<int64_t> n_commit_fsync_ns{0};

std::mutex commit_mu;
std::condition_variable commit_cv;
std::condition_variable commit_drain_cv;
std::thread commit_thread;
bool commit_thread_started = false;
bool commit_stop_flag = false;
bool commit_busy = false;  // fsync+delivery in flight (drain barrier)
std::deque<CommitWaiter> commit_q;
std::unordered_map<Vol*, std::shared_ptr<Vol>> commit_dirty;
int64_t commit_q_bytes = 0;
std::chrono::steady_clock::time_point commit_window_open;
std::atomic<int> n_active_servers{0};

const char* durability_name() {
  int m = commit_mode.load(std::memory_order_relaxed);
  return m == 1 ? "batch" : m == 2 ? "sync" : "buffered";
}

// sync-mode oracle: per-write fsync inline on the calling thread,
// covering both the .dat append and its idx entry (Volume.sync parity)
void commit_sync_inline(const std::shared_ptr<Vol>& v) {
  uint64_t t0 = now_ns();
  fsync(v->dat_fd);
  fsync(v->idx_fd);
  n_commit_fsync_ns += (int64_t)(now_ns() - t0);
  n_commit_fsyncs += 2;
  n_commit_writes += 1;
}

void committer_loop() {
  std::unique_lock<std::mutex> lk(commit_mu);
  while (true) {
    commit_cv.wait(lk, [] { return commit_stop_flag || !commit_q.empty(); });
    if (commit_stop_flag) return;
    // adaptive window: close at maxDelay after the first enqueue, once
    // maxBytes piled up, or — checked in ~250us slices — when the
    // queue has stopped growing. Quiescence means every in-flight
    // write of the wave is already queued; sleeping out the rest of
    // the window can't grow the batch, it only delays the acks (and
    // with request-response clients, the next wave's appends).
    // maxDelay stays the contract's MAXIMUM added latency; closing
    // early is always within it.
    auto deadline = commit_window_open + std::chrono::nanoseconds(
        commit_max_delay_ns.load(std::memory_order_relaxed));
    int64_t seen_bytes = commit_q_bytes;
    while (!commit_stop_flag && !commit_q.empty() &&
           commit_q_bytes <
               commit_max_bytes_cfg.load(std::memory_order_relaxed)) {
      auto slice = std::chrono::steady_clock::now() +
                   std::chrono::nanoseconds(250000);
      bool final_slice = slice >= deadline;
      if (commit_cv.wait_until(lk, final_slice ? deadline : slice) ==
          std::cv_status::timeout) {
        if (final_slice || commit_q_bytes == seen_bytes) break;
        seen_bytes = commit_q_bytes;
      }
    }
    if (commit_stop_flag) return;
    if (commit_q.empty()) continue;  // drained while we waited
    std::deque<CommitWaiter> batch;
    batch.swap(commit_q);
    std::unordered_map<Vol*, std::shared_ptr<Vol>> dirty;
    dirty.swap(commit_dirty);
    int64_t bytes = commit_q_bytes;
    commit_q_bytes = 0;
    commit_busy = true;
    lk.unlock();
    // lock released: the fsyncs happen out here (commit-fsync contract).
    // .dat only — one journal commit per dirty volume per batch. The
    // idx appends in .dat order, so a crash loses at most an idx
    // suffix that Volume.check_integrity's tail replay regains from
    // the fsynced .dat records.
    // fdatasync, not fsync: the size change is forced (needed to
    // retrieve the appended records) but the mtime journal ordering
    // is skipped — ~3x cheaper per batch on ext4
    uint64_t t0 = now_ns();
    for (auto& it : dirty) fdatasync(it.second->dat_fd);
    n_commit_fsync_ns += (int64_t)(now_ns() - t0);
    n_commit_fsyncs += (int64_t)dirty.size();
    n_commit_batches += 1;
    n_commit_bytes += bytes;
    // deliver per owning server so completions run on that server's
    // IO thread (same eventfd handoff as worker_loop's returned conns)
    std::unordered_map<Server*, std::vector<CommitWaiter>> per;
    for (auto& w : batch) per[w.s].push_back(w);
    for (auto& it : per) {
      Server* srv = it.first;
      {
        std::lock_guard<std::mutex> g(srv->ret_mu);
        for (auto& w : it.second) srv->commit_done.push_back(w);
      }
      uint64_t one = 1;
      (void)!write(srv->event_fd, &one, 8);
    }
    lk.lock();
    commit_busy = false;
    commit_drain_cv.notify_all();
  }
}

// IO-thread side: queue one appended write behind the open window.
void commit_enqueue(Server* s, const std::shared_ptr<Vol>& v,
                    int64_t nbytes, ReplOp* rop, uint64_t s3_id) {
  std::lock_guard<std::mutex> lk(commit_mu);
  if (!commit_thread_started) {
    commit_thread_started = true;
    commit_thread = std::thread(committer_loop);
  }
  bool was_empty = commit_q.empty();
  if (was_empty)
    commit_window_open = std::chrono::steady_clock::now();
  CommitWaiter w;
  w.s = s;
  w.rop = rop;
  w.s3_id = s3_id;
  w.nbytes = nbytes;
  commit_q.push_back(w);
  commit_dirty.emplace(v.get(), v);
  int64_t before = commit_q_bytes;
  commit_q_bytes += nbytes;
  n_commit_writes += 1;
  // wake the committer only at the two edges it acts on: window open
  // (it sits in the outer wait) and the maxBytes crossing (early
  // close). A notify per enqueue is a futex wake per write — on a
  // single core each one can preempt the IO loop mid-batch, and the
  // committer would just re-check its predicate and sleep again.
  int64_t cap = commit_max_bytes_cfg.load(std::memory_order_relaxed);
  if (was_empty || (before < cap && commit_q_bytes >= cap))
    commit_cv.notify_one();
}

// stop_server teardown: pull this server's queued waiters out of the
// committer (their acks will never be sent — the sweeps free the ops)
// and wait out any in-flight fsync/delivery so no Server* escapes the
// teardown. The removed waiters are parked in s->commit_done so the
// op sweep below frees exactly once, delivered or not.
void commit_drain_server(Server* s) {
  std::deque<CommitWaiter> mine;
  {
    std::unique_lock<std::mutex> lk(commit_mu);
    for (auto it = commit_q.begin(); it != commit_q.end();) {
      if (it->s == s) {
        commit_q_bytes -= it->nbytes;
        mine.push_back(*it);
        it = commit_q.erase(it);
      } else {
        ++it;
      }
    }
    commit_drain_cv.wait(lk, [] { return !commit_busy; });
  }
  std::lock_guard<std::mutex> g(s->ret_mu);
  for (auto& w : mine) s->commit_done.push_back(w);
}

// last front in the process stopped: join the committer so no thread
// outlives the library's users (clean under TSan / repeated restarts)
void commit_shutdown() {
  std::thread t;
  {
    std::lock_guard<std::mutex> lk(commit_mu);
    if (!commit_thread_started) return;
    commit_stop_flag = true;
    commit_cv.notify_all();
    t = std::move(commit_thread);
  }
  t.join();
  std::lock_guard<std::mutex> lk(commit_mu);
  commit_thread_started = false;
  commit_stop_flag = false;
  commit_dirty.clear();
}

// Flat {"Seaweed-K": "v", ...} JSON -> "Seaweed-K: v\r\n" header
// lines, Seaweed-prefixed keys only (python _read_fid:445-451).
// Returns false on anything beyond simple unescaped string:string
// members (the caller relays those to python) or on control chars
// (header-injection guard — python's header validation rejects them
// there too).
bool pairs_to_headers(const char* js, size_t n, std::string* out) {
  size_t i = 0;
  auto skip_ws = [&] {
    while (i < n && (js[i] == ' ' || js[i] == '\t' || js[i] == '\n' ||
                     js[i] == '\r'))
      i++;
  };
  auto parse_str = [&](std::string* s) -> bool {
    if (i >= n || js[i] != '"') return false;
    i++;
    s->clear();
    while (i < n && js[i] != '"') {
      unsigned char ch = js[i];
      if (ch == '\\' || ch < 0x20) return false;  // escapes/control: python
      s->push_back(js[i++]);
    }
    if (i >= n) return false;
    i++;  // closing quote
    return true;
  };
  skip_ws();
  if (i >= n || js[i] != '{') return false;
  i++;
  skip_ws();
  if (i < n && js[i] == '}') {  // empty object (+ nothing after)
    i++;
    skip_ws();
    return i == n;
  }
  while (true) {
    std::string k, v;
    skip_ws();
    if (!parse_str(&k)) return false;
    skip_ws();
    if (i >= n || js[i] != ':') return false;
    i++;
    skip_ws();
    if (!parse_str(&v)) return false;  // non-string values: python
    if (k.size() >= 8 && strncasecmp(k.c_str(), "seaweed-", 8) == 0) {
      out->append(k);
      out->append(": ");
      out->append(v);
      out->append("\r\n");
    }
    skip_ws();
    if (i < n && js[i] == ',') {
      i++;
      continue;
    }
    if (i < n && js[i] == '}') {
      i++;
      skip_ws();
      return i == n;  // trailing garbage = not valid JSON: python
    }
    return false;
  }
}

// Parse a single "bytes=..." Range spec against `size` bytes — the
// ONE range parser for the volume and S3 fast paths (python
// _read_fid:494-512 semantics: unknown units are ignored, huge
// numbers SATURATE like python's unbounded ints and then the bounds
// rules decide, a missing dash means an open end, multi-range and
// non-numeric specs are malformed). Returns 0 = serve full (no/
// ignored range), 1 = partial (start/end set), -1 = malformed,
// -2 = unsatisfiable.
int parse_byte_range(const char* range, size_t range_len, int64_t size,
                     int64_t* start, int64_t* end) {
  if (!range) return 0;
  if (range_len <= 6 || memcmp(range, "bytes=", 6) != 0)
    return 0;  // unknown unit: ignored per RFC 7233
  const char* spec = range + 6;
  size_t spec_len = range_len - 6;
  const char* dash = (const char*)memchr(spec, '-', spec_len);
  const char* s_end = dash ? dash : spec + spec_len;
  const char* e_begin = dash ? dash + 1 : spec + spec_len;
  auto parse_num = [](const char* p, const char* e, int64_t* out) {
    if (p == e) return false;
    int64_t v = 0;
    for (; p < e; p++) {
      if (*p < '0' || *p > '9') return false;  // incl. ',' multi-range
      // saturate instead of overflowing: python ints are unbounded,
      // and a wrapped-negative start once slipped past the bounds
      // checks into an out-of-bounds buffer read
      if (v > (INT64_MAX - 9) / 10)
        v = INT64_MAX;
      else
        v = v * 10 + (*p - '0');
    }
    *out = v;
    return true;
  };
  *start = 0;
  *end = size - 1;
  bool ok;
  if (s_end == spec) {  // suffix form bytes=-N: the LAST N bytes
    int64_t n_last = 0;
    ok = parse_num(e_begin, spec + spec_len, &n_last);
    if (ok) *start = std::max<int64_t>(0, size - n_last);
  } else {
    ok = parse_num(spec, s_end, start);
    if (ok && e_begin < spec + spec_len)
      ok = parse_num(e_begin, spec + spec_len, end);
  }
  if (!ok) return -1;
  *end = std::min<int64_t>(*end, size - 1);
  if (*start > *end || *start >= size) return -2;
  return 1;
}

// GET/HEAD fast path. Returns false when the request must be proxied.
bool handle_get(Conn* c, const Request& r, uint32_t vid, uint64_t key,
                uint32_t cookie, bool is_head) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return false;  // not attached (EC, remote, elsewhere): proxy
  int64_t off;
  int32_t size;
  int version;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    if (v->detached) return false;
    auto it = v->map.find(key);
    if (it == v->map.end() || it->second.size <= 0) {
      simple_response(c, 404, "", r.keep_alive);
      return true;
    }
    off = it->second.offset;
    size = it->second.size;
    version = v->version;
  }
  int64_t rec_len = disk_size(size, version);
  std::string rec;
  rec.resize(rec_len);
  ssize_t got = pread(v->dat_fd, &rec[0], rec_len, off);
  if (got != rec_len) {
    n_errors++;
    simple_response(c, 500, "short read", r.keep_alive);
    return true;
  }
  const uint8_t* p = (const uint8_t*)rec.data();
  uint32_t disk_cookie = be32(p);
  uint64_t disk_id = be64(p + 4);
  int32_t disk_size_field = (int32_t)be32(p + 12);
  if (disk_id != key || disk_size_field != size) {
    n_errors++;
    simple_response(c, 500, "needle mismatch", r.keep_alive);
    return true;
  }
  if (disk_cookie != cookie) {
    simple_response(c, 403, "cookie mismatch", r.keep_alive);
    return true;
  }
  // body: data_size(4) data flags(1) [name] [mime] [lm] [ttl] [pairs]
  uint32_t data_size = be32(p + HEADER);
  if ((int64_t)data_size + 5 > size) {
    n_errors++;
    simple_response(c, 500, "corrupt needle", r.keep_alive);
    return true;
  }
  const uint8_t* data = p + HEADER + 4;
  const uint8_t* cur = data + data_size;
  uint8_t flags = *cur++;
  bool compressed = flags & FLAG_IS_COMPRESSED;
  // python inflates; ranges address ORIGINAL bytes, so a compressed
  // needle with a Range header must inflate there too
  if (compressed && (!r.accept_gzip || r.range)) return false;
  // chunk-manifest needles reassemble server-side from sub-fids
  // (tryHandleChunkedFile) — python owns that path
  if (flags & FLAG_IS_CHUNK_MANIFEST) return false;
  const uint8_t* mime = nullptr;
  size_t mime_len = 0;
  const uint8_t* body_end = p + HEADER + size;
  if (flags & FLAG_HAS_NAME && cur < body_end) cur += 1 + *cur;
  if (flags & FLAG_HAS_MIME && cur < body_end) {
    mime_len = *cur++;
    mime = cur;
    cur += mime_len;
  }
  uint64_t last_modified = 0;
  if (flags & FLAG_HAS_LAST_MODIFIED && cur + 5 <= body_end) {
    for (int i = 0; i < 5; i++) last_modified = last_modified << 8 | cur[i];
    cur += 5;
  }
  if (flags & FLAG_HAS_TTL && cur + 2 <= body_end) cur += 2;
  // Seaweed-* metadata pairs ride the needle as flat JSON
  // (needle_parse_upload.go parsePairs); emit them as response
  // headers like the python read path. Anything beyond simple
  // string:string JSON (escapes, nesting, non-string values) relays
  // to python, which renders it exactly.
  std::string pair_headers;
  if (flags & FLAG_HAS_PAIRS) {
    if (cur + 2 > body_end) return false;
    size_t plen = (size_t)cur[0] << 8 | cur[1];
    cur += 2;
    if (cur + plen > body_end) return false;
    if (!pairs_to_headers((const char*)cur, plen, &pair_headers))
      return false;
    cur += plen;
  }
  if (cur > body_end) {
    n_errors++;
    simple_response(c, 500, "corrupt needle body", r.keep_alive);
    return true;
  }
  uint32_t stored_crc = be32(p + HEADER + size);
  uint32_t actual = data_size ? crc32c(0, data, data_size) : 0;
  if (data_size && stored_crc != actual &&
      stored_crc != legacy_crc_value(actual)) {
    n_errors++;
    simple_response(c, 500, "CRC error: data on disk corrupted", r.keep_alive);
    return true;
  }
  // single-range GET (handlers_read.go writeResponseContent): one
  // shared parser (parse_byte_range above); malformed specs RELAY so
  // the python path decides — multi-range answers as
  // multipart/byteranges there (common.go:348), and a garbage spec
  // gets python's 416 with its Content-Range: bytes */N header.
  int64_t start_i = 0, end_i = (int64_t)data_size - 1;
  bool partial = false;
  if (r.range && !is_head) {
    int rc = parse_byte_range(r.range, r.range_len, (int64_t)data_size,
                              &start_i, &end_i);
    if (rc == -1) return false;  // multi-range/junk: python path
    if (rc == -2) {
      // RFC 7233: a 416 SHOULD say the actual size — clients read
      // the total from "bytes */N" to retry with a valid range, and
      // the python paths send the same header
      char h416[160];
      int hn = snprintf(h416, sizeof h416,
                        "HTTP/1.1 416 Requested Range Not Satisfiable"
                        "\r\nContent-Length: 0\r\n"
                        "Content-Range: bytes */%lld\r\n%s\r\n",
                        (long long)data_size,
                        r.keep_alive ? "" : "Connection: close\r\n");
      c->out.append(h416, hn);
      if (!r.keep_alive) c->want_close = true;
      count_resp(416, 0);
      return true;
    }
    partial = rc == 1;
  }
  char head[512];
  int n = snprintf(head, sizeof head,
                   "HTTP/1.1 %s\r\nContent-Length: %lld\r\n"
                   "Content-Type: %.*s\r\nEtag: \"%08x\"\r\n",
                   partial ? "206 Partial Content" : "200 OK",
                   partial ? (long long)(end_i - start_i + 1)
                           : (long long)data_size,
                   mime ? (int)mime_len : 24,
                   mime ? (const char*)mime : "application/octet-stream",
                   actual);
  c->out.append(head, n);
  if (partial) {
    char crng[96];
    int cn = snprintf(crng, sizeof crng,
                      "Content-Range: bytes %lld-%lld/%u\r\n",
                      (long long)start_i, (long long)end_i, data_size);
    c->out.append(crng, cn);
  }
  if (compressed) c->out.append("Content-Encoding: gzip\r\n");
  if (last_modified) {
    char datebuf[64];
    time_t lm = (time_t)last_modified;
    struct tm tmv;
    gmtime_r(&lm, &tmv);
    strftime(datebuf, sizeof datebuf,
             "Last-Modified: %a, %d %b %Y %H:%M:%S GMT\r\n", &tmv);
    c->out.append(datebuf);
  }
  c->out.append(pair_headers);
  if (!r.keep_alive) {
    c->out.append("Connection: close\r\n");
    c->want_close = true;
  }
  c->out.append("\r\n");
  if (!is_head)
    c->out.append((const char*)data + start_i, (size_t)(end_i - start_i + 1));
  n_fast_get++;
  count_resp(partial ? 206 : 200,
             is_head ? 0 : (int64_t)(end_i - start_i + 1));
  return true;
}

// Append a plain needle record (header, data_size, data, flags=0, crc,
// ts, pad — the minimal branch of Volume.append_needle /
// volume_write.go:144 doWriteRequest). Returns an HTTP status: 201 ok,
// 409 read-only, 500 IO error, or 0 = caller must fall back to the
// python path (detached / non-v3 volume).
int append_plain(const std::shared_ptr<Vol>& v, uint64_t key, uint32_t cookie,
                 const uint8_t* body, int64_t body_len, uint32_t* out_crc) {
  int32_t size = (int32_t)(4 + body_len + 1);
  int64_t rec_len = disk_size(size, 3);
  std::string rec;
  rec.resize(rec_len, '\0');
  uint8_t* p = (uint8_t*)&rec[0];
  put_be32(p, cookie);
  put_be64(p + 4, key);
  put_be32(p + 12, (uint32_t)size);
  put_be32(p + 16, (uint32_t)body_len);
  memcpy(p + 20, body, body_len);
  p[20 + body_len] = 0;  // flags
  uint32_t crc = crc32c(0, body, body_len);
  put_be32(p + 21 + body_len, crc);
  *out_crc = crc;
  std::lock_guard<std::mutex> lk(v->mu);
  if (v->detached) return 0;
  if (v->read_only) return 409;
  if (v->version != 3) return 0;  // v2 volumes: rare, python path
  uint64_t ns = now_ns();
  if (ns <= v->last_append_ns) ns = v->last_append_ns + 1;
  v->last_append_ns = ns;
  put_be64(p + 25 + body_len, ns);
  if (pwrite(v->dat_fd, rec.data(), rec_len, v->tail) != rec_len) return 500;
  int64_t off = v->tail;
  v->tail += rec_len;
  v->put(key, off, size);
  if (v->write_idx(key, off, (uint32_t)size) != 0) return 500;
  return 201;
}

// Tombstone append (Volume.delete_needle / volume_write.go
// deleteNeedle2): empty v3 needle + 0xFFFFFFFF .idx entry. Absent
// needles write NOTHING and reclaim 0 — dp_delete semantics. Same
// status convention as append_plain (202 ok).
int delete_tomb(const std::shared_ptr<Vol>& v, uint64_t key,
                int64_t* out_reclaimed) {
  uint8_t rec[32] = {0};  // disk_size(0, v3) = 28 -> padded to 32
  put_be64(rec + 4, key);
  std::lock_guard<std::mutex> lk(v->mu);
  if (v->detached) return 0;
  if (v->read_only) return 409;
  if (v->version != 3) return 0;
  auto it = v->map.find(key);
  if (it == v->map.end() || it->second.size <= 0) {
    *out_reclaimed = 0;
    return 202;
  }
  uint64_t ns = now_ns();
  if (ns <= v->last_append_ns) ns = v->last_append_ns + 1;
  v->last_append_ns = ns;
  put_be64(rec + 20, ns);
  if (pwrite(v->dat_fd, rec, sizeof rec, v->tail) != (ssize_t)sizeof rec)
    return 500;
  v->tail += sizeof rec;
  *out_reclaimed = v->del(key);
  if (v->write_idx(key, 0, 0xFFFFFFFFu) != 0) return 500;
  return 202;
}

void respond_post_ok(Conn* c, bool keep_alive, int64_t body_len,
                     uint32_t crc) {
  char resp[256];
  char jbody[128];
  int bl = snprintf(jbody, sizeof jbody,
                    "{\"name\": \"\", \"size\": %lld, \"eTag\": \"%08x\"}",
                    (long long)body_len, crc);
  int n = snprintf(resp, sizeof resp,
                   "HTTP/1.1 201 Created\r\nContent-Length: %d\r\n"
                   "Content-Type: application/json\r\n"
                   "X-Sw-Durability: %s\r\n%s\r\n",
                   bl, durability_name(),
                   keep_alive ? "" : "Connection: close\r\n");
  c->out.append(resp, n);
  c->out.append(jbody, bl);
  if (!keep_alive) c->want_close = true;
  count_resp(201, bl);
  front_stats[t_role].bytes_in += body_len;
}

void respond_delete_ok(Conn* c, bool keep_alive, int64_t reclaimed) {
  char resp[256];
  char jbody[64];
  int bl = snprintf(jbody, sizeof jbody, "{\"size\": %lld}",
                    (long long)reclaimed);
  int n = snprintf(resp, sizeof resp,
                   "HTTP/1.1 202 Accepted\r\nContent-Length: %d\r\n"
                   "Content-Type: application/json\r\n%s\r\n",
                   bl, keep_alive ? "" : "Connection: close\r\n");
  c->out.append(resp, n);
  c->out.append(jbody, bl);
  if (!keep_alive) c->want_close = true;
  count_resp(202, bl);
}

// POST fast path: plain body, no metadata, writable local volume.
// Guarded writes verify the HS256 token right here; replicated
// PRIMARY writes decline (the worker pool owns the peer fan-out) while
// incoming ?type=replicate secondary writes append inline.
bool handle_post(Server* s, Conn* c, const Request& r, uint32_t vid,
                 uint64_t key, uint32_t cookie, const uint8_t* body,
                 int64_t body_len, const char* fid, size_t fid_len) {
  if (r.has_query && !r.is_replicate) return false;
  if (r.proxy_only || !r.plain_upload || r.chunked) return false;
  if (body_len <= 0 || body_len > (8 << 20)) return false;
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return false;
  if (v->has_replicas && !r.is_replicate) return false;  // async fan-out
  JwtRes jr = jwt_check(r.auth, r.auth_len, fid, fid_len);
  if (jr == JwtRes::UNSURE) return false;  // python gives the verdict
  if (jr == JwtRes::REJECT) {
    n_jwt_reject++;
    simple_response(c, 401, "jwt rejected", r.keep_alive);
    return true;
  }
  uint32_t crc = 0;
  int st = append_plain(v, key, cookie, body, body_len, &crc);
  if (st == 0) return false;
  if (st == 409) {
    simple_response(c, 409, "volume is read only", r.keep_alive);
    return true;
  }
  if (st == 500) {
    n_errors++;
    simple_response(c, 500, "write failed", r.keep_alive);
    return true;
  }
  int mode = commit_mode.load(std::memory_order_relaxed);
  if (mode == 2) commit_sync_inline(v);
  if (mode == 1 && !r.is_replicate) {
    // batch durability: the ack releases from the fsync-completion
    // callback, not after pwrite. Gate the conn behind a one-token
    // ReplOp (no peer wires — the commit waiter IS the token);
    // incoming ?type=replicate secondary appends keep the immediate
    // ack, the primary's client ack carries the durability contract.
    ReplOp* op = new ReplOp();
    op->client = c;
    op->v = v;
    op->keep_alive = r.keep_alive;
    op->size = body_len;
    op->crc = crc;
    op->waiting = 1;  // the fsync token
    op->plain = true;
    c->repl_pending = true;
    commit_enqueue(s, v, body_len, op, 0);
    return true;
  }
  respond_post_ok(c, r.keep_alive, body_len, crc);
  n_fast_post++;
  return true;
}

// DELETE fast path (volume_server_handlers_write.go DeleteHandler →
// python _delete_fid): tombstone + 202 {"size": reclaimed}. Replicated
// primaries decline to the worker pool like POST.
bool handle_delete(Conn* c, const Request& r, uint32_t vid, uint64_t key,
                   const char* fid, size_t fid_len) {
  if (r.has_query && !r.is_replicate) return false;
  if (r.proxy_only || r.chunked || r.content_len != 0) return false;
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return false;
  if (v->has_replicas && !r.is_replicate) return false;  // async fan-out
  JwtRes jr = jwt_check(r.auth, r.auth_len, fid, fid_len);
  if (jr == JwtRes::UNSURE) return false;
  if (jr == JwtRes::REJECT) {
    n_jwt_reject++;
    simple_response(c, 401, "jwt rejected", r.keep_alive);
    return true;
  }
  if (!r.is_replicate) {
    // chunk-manifest needles cascade their chunk deletes in python
    // (_delete_fid -> delete_chunks); tombstoning one natively would
    // orphan every chunk forever. Probe the stored flag byte — two
    // preads, and only on the client-facing delete path.
    int64_t probe_off = -1;
    int32_t probe_sz = 0;
    {
      std::lock_guard<std::mutex> lk(v->mu);
      auto it = v->map.find(key);
      if (it != v->map.end() && it->second.size > 0) {
        probe_off = it->second.offset;
        probe_sz = it->second.size;
      }
    }
    if (probe_off >= 0) {
      uint8_t hdr[20];
      if (pread(v->dat_fd, hdr, sizeof hdr, probe_off) ==
          (ssize_t)sizeof hdr) {
        uint32_t data_size = be32(hdr + 16);
        if ((int64_t)data_size + 5 <= probe_sz) {
          uint8_t flag = 0;
          if (pread(v->dat_fd, &flag, 1,
                    probe_off + 20 + (int64_t)data_size) == 1 &&
              (flag & FLAG_IS_CHUNK_MANIFEST))
            return false;  // relay: python cascades
        }
      }
    }
  }
  int64_t reclaimed = 0;
  int st = delete_tomb(v, key, &reclaimed);
  if (st == 0) return false;
  if (st == 409) {
    simple_response(c, 409, "volume is read only", r.keep_alive);
    return true;
  }
  if (st == 500) {
    n_errors++;
    simple_response(c, 500, "delete failed", r.keep_alive);
    return true;
  }
  respond_delete_ok(c, r.keep_alive, reclaimed);
  n_fast_delete++;
  return true;
}

// ---------------------------------------------------------------------------
// Proxy relay (blocking, runs on worker threads)
// ---------------------------------------------------------------------------
int connect_backend(uint16_t port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  struct sockaddr_in a = {};
  a.sin_family = AF_INET;
  a.sin_port = htons(port);
  a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (connect(fd, (struct sockaddr*)&a, sizeof a) != 0) {
    close(fd);
    return -1;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  struct timeval tv = {300, 0};  // vacuum/EC admin calls can run minutes
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  return fd;
}

bool send_all(int fd, const char* p, size_t n) {
  while (n) {
    ssize_t w = send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= w;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Replica fan-out plumbing shared with the benchmark clients. The
// fan-out itself is the ASYNC state machine further down (submit_repl
// and friends, on the IO thread).
// ---------------------------------------------------------------------------
int connect_hostport(const std::string& hostport) {
  size_t colon = hostport.rfind(':');
  if (colon == std::string::npos) return -1;
  std::string host = hostport.substr(0, colon);
  std::string port = hostport.substr(colon + 1);
  struct addrinfo hints = {}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0 || !res)
    return -1;
  int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd >= 0 && connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd >= 0) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    struct timeval tv = {30, 0};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  }
  return fd;
}

// Non-blocking variant for the IO thread: a SYN that goes unanswered
// (peer power loss / partition) must never stall epoll_wait — the
// connect completes (or fails) as an EPOLLOUT/ERR event instead.
// *in_progress reports EINPROGRESS. Numeric peer addresses resolve
// without blocking (AI_NUMERICHOST); hostname peers fall back to a
// regular lookup — same trade the reference's dialer makes.
int connect_hostport_nb(const std::string& hostport, bool* in_progress) {
  *in_progress = false;
  size_t colon = hostport.rfind(':');
  if (colon == std::string::npos) return -1;
  std::string host = hostport.substr(0, colon);
  std::string port = hostport.substr(colon + 1);
  struct addrinfo hints = {}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  hints.ai_flags = AI_NUMERICHOST;
  if (getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0) {
    hints.ai_flags = 0;  // hostname peer: blocking DNS, rare
    if (getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0)
      return -1;
  }
  if (!res) return -1;
  int fd = socket(res->ai_family,
                  res->ai_socktype | SOCK_NONBLOCK, res->ai_protocol);
  if (fd >= 0) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    if (connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
      if (errno == EINPROGRESS) {
        *in_progress = true;
      } else {
        close(fd);
        fd = -1;
      }
    }
  }
  freeaddrinfo(res);
  return fd;
}

// Read one HTTP response off `fd` (head + Content-Length body, or —
// when allow_chunked — a chunked body to its terminator). Returns the
// status code, or -1 on socket error / unframed / oversized response.
// Shared by the peer fan-out and both benchmark clients.
int read_framed_response(int fd, std::string* resp, size_t limit,
                         bool allow_chunked) {
  resp->clear();
  char buf[16 << 10];
  ssize_t head_end = -1;
  int64_t cl = -1;
  bool chunked = false;
  while (true) {
    if (head_end < 0) {
      const char* e =
          (const char*)memmem(resp->data(), resp->size(), "\r\n\r\n", 4);
      if (e) {
        head_end = e - resp->data() + 4;
        const char* clh = (const char*)memmem(resp->data(), head_end,
                                              "Content-Length:", 15);
        if (!clh)
          clh = (const char*)memmem(resp->data(), head_end,
                                    "content-length:", 15);
        if (clh) cl = strtoll(clh + 15, nullptr, 10);
        if (allow_chunked && memmem(resp->data(), head_end, "chunked", 7))
          chunked = true;
      }
    }
    if (head_end >= 0) {
      // 204/304 are body-less by status (RFC 7230 §3.3.3) and carry
      // no Content-Length — headers complete the response
      int code0 = head_end >= 12 ? atoi(resp->c_str() + 9) : 0;
      if (code0 == 204 || code0 == 304) break;
      if (chunked) {
        if (memmem(resp->data() + head_end, resp->size() - head_end,
                   "0\r\n\r\n", 5))
          break;
      } else if (cl >= 0) {
        if ((int64_t)resp->size() >= head_end + cl) break;
      } else {
        return -1;  // unframed: the conn can't be reused safely
      }
    }
    ssize_t got = recv(fd, buf, sizeof buf, 0);
    if (got <= 0) return -1;
    resp->append(buf, got);
    if (resp->size() > limit) return -1;
  }
  if (resp->size() < 12) return -1;
  return atoi(resp->c_str() + 9);
}

// Incremental chunked-transfer scanner: feed() consumes any byte
// slice and remembers mid-chunk state, so relays never re-parse a
// trimmed buffer (re-parsing from an arbitrary offset misreads chunk
// payload bytes as size lines).
struct ChunkScan {
  enum { SIZE_LINE, DATA, DATA_CRLF, TRAILER } state = SIZE_LINE;
  std::string line;      // current size/trailer line accumulator
  int64_t remaining = 0; // payload bytes left in the current chunk
  bool last = false;     // saw the 0-size chunk
  bool done = false;

  // Consumes up to n bytes; returns how many were consumed (< n only
  // when the terminator was reached mid-slice).
  size_t feed(const char* p, size_t n) {
    size_t i = 0;
    while (i < n && !done) {
      switch (state) {
        case SIZE_LINE:
          line.push_back(p[i++]);
          if (line.size() >= 2 && line[line.size() - 2] == '\r' &&
              line.back() == '\n') {
            remaining = strtoll(line.c_str(), nullptr, 16);
            last = remaining == 0;
            state = last ? TRAILER : DATA;
            line.clear();
          } else if (line.size() > 4096) {
            done = true;  // malformed; stop consuming
          }
          break;
        case DATA: {
          int64_t take = std::min<int64_t>(remaining, n - i);
          remaining -= take;
          i += take;
          if (remaining == 0) state = DATA_CRLF;
          break;
        }
        case DATA_CRLF:
          line.push_back(p[i++]);
          if (line.size() == 2) {
            line.clear();
            state = SIZE_LINE;
          }
          break;
        case TRAILER:
          line.push_back(p[i++]);
          if (line.size() >= 2 && line[line.size() - 2] == '\r' &&
              line.back() == '\n') {
            if (line.size() == 2) {
              done = true;  // empty line terminates the trailer block
            } else {
              line.clear();  // a trailer header line; keep scanning
            }
          }
          break;
      }
    }
    return i;
  }
};

// Relay one already-head-parsed request from client conn to the backend and
// its response back. Client fd is in BLOCKING mode here. Returns false if
// either connection must be dropped.
bool proxy_one(Server* s, Conn* c, const Request& r) {
  n_proxied++;
  if (c->backend_fd < 0) c->backend_fd = connect_backend(s->backend_port);
  if (c->backend_fd < 0) {
    simple_response(c, 502, "backend unavailable", false);
    return send_all(c->fd, c->out.data(), c->out.size()), false;
  }
  int bfd = c->backend_fd;
  // clip the backend read timeout to the request's remaining deadline
  // budget (the default 300s accommodates vacuum/EC admin calls); the
  // keep-alive backend conn gets the default restored for the next
  // request by the unconditional set here
  {
    double rem = 300.0;
    if (r.deadline > 0) {
      rem = r.deadline - wall_now();
      if (rem < 0.05) rem = 0.05;  // expired mid-queue: fail fast
      if (rem > 300.0) rem = 300.0;
    }
    struct timeval tv = {(time_t)rem,
                         (suseconds_t)((rem - (double)(time_t)rem) * 1e6)};
    setsockopt(bfd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  }
  // 1+2. forward head + body (buffered part first, then streamed) —
  // chunked framing is tracked by the incremental ChunkScan so a
  // body of any size relays without re-parsing from buffer offsets
  const char* req0 = c->in.data() + c->in_off;
  size_t avail = c->in.size() - c->in_off;
  char buf[64 << 10];
  if (r.chunked) {
    ChunkScan scan;
    size_t used0 = scan.feed(req0 + r.head_len, avail - r.head_len);
    if (!send_all(bfd, req0, r.head_len + used0)) return false;
    std::string leftover;
    while (!scan.done) {
      ssize_t got = recv(c->fd, buf, sizeof buf, 0);
      if (got <= 0) return false;
      size_t used = scan.feed(buf, got);
      if (!send_all(bfd, buf, used)) return false;
      if (scan.done && used < (size_t)got)
        leftover.assign(buf + used, got - used);  // pipelined bytes
    }
    c->in_off += r.head_len + used0;
    if (!leftover.empty()) {
      c->in.erase(0, c->in_off);
      c->in_off = 0;
      c->in += leftover;
    }
  } else {
    bool body_complete =
        (int64_t)(avail - r.head_len) >= r.content_len;
    size_t fwd =
        body_complete ? r.head_len + (size_t)r.content_len : avail;
    if (!send_all(bfd, req0, fwd)) return false;
    int64_t remaining = body_complete
                            ? 0
                            : r.content_len - (int64_t)(avail - r.head_len);
    while (remaining > 0) {
      // never read past the request: the next pipelined request's
      // bytes must not leak into this relay
      size_t want = (size_t)std::min<int64_t>(remaining, sizeof buf);
      ssize_t got = recv(c->fd, buf, want, 0);
      if (got <= 0) return false;
      if (!send_all(bfd, buf, got)) return false;
      remaining -= got;
    }
    c->in_off += fwd;  // streamed body came straight off the wire
  }
  // 3. read backend response head
  std::string resp;
  size_t resp_head = 0;
  int64_t resp_cl = -1;
  bool resp_chunked = false;
  bool resp_close = false;
  while (true) {
    const char* e = (const char*)memmem(resp.data(), resp.size(), "\r\n\r\n", 4);
    if (e) {
      resp_head = e - resp.data() + 4;
      break;
    }
    ssize_t got = recv(bfd, buf, sizeof buf, 0);
    if (got <= 0) return false;
    resp.append(buf, got);
    if (resp.size() > (1 << 20)) return false;
  }
  // parse response framing headers
  {
    const char* p = resp.data();
    const char* hend = p + resp_head;
    const char* le = (const char*)memmem(p, resp_head, "\r\n", 2);
    while (le && le + 2 < hend) {
      const char* ls = le + 2;
      const char* ne = (const char*)memmem(ls, hend - ls, "\r\n", 2);
      if (!ne) break;
      const char* colon = (const char*)memchr(ls, ':', ne - ls);
      if (colon) {
        size_t klen = colon - ls;
        const char* v = colon + 1;
        while (v < ne && *v == ' ') v++;
        size_t vlen = ne - v;
        if (ieq(ls, klen, "content-length"))
          resp_cl = strtoll(std::string(v, vlen).c_str(), nullptr, 10);
        else if (ieq(ls, klen, "transfer-encoding") &&
                 icontains(v, vlen, "chunked"))
          resp_chunked = true;
        else if (ieq(ls, klen, "connection") && icontains(v, vlen, "close"))
          resp_close = true;
      }
      le = ne;
    }
  }
  // 204/304 are body-less BY STATUS (RFC 7230 §3.3.3) and typically
  // carry no Content-Length — without this check the relay would wait
  // on the keep-alive backend conn for a body that never comes (the
  // S3 app answers every DELETE with 204)
  int resp_code = resp_head >= 12 ? atoi(resp.data() + 9) : 0;
  bool head_only = ieq(r.method, r.method_len, "HEAD") ||
                   resp_code == 204 || resp_code == 304;
  // 4. relay response to client
  if (!send_all(c->fd, resp.data(), resp.size())) return false;
  int64_t body_have = resp.size() - resp_head;
  if (!head_only) {
    if (resp_chunked) {
      ChunkScan scan;
      scan.feed(resp.data() + resp_head, resp.size() - resp_head);
      while (!scan.done) {
        ssize_t got = recv(bfd, buf, sizeof buf, 0);
        if (got <= 0) return false;
        size_t used = scan.feed(buf, got);
        if (!send_all(c->fd, buf, used)) return false;
        // one request in flight per backend conn: bytes past the
        // terminator would mean a broken backend — drop the conn
        if (scan.done && used < (size_t)got) resp_close = true;
      }
    } else if (resp_cl >= 0) {
      int64_t remaining2 = resp_cl - body_have;
      while (remaining2 > 0) {
        ssize_t got = recv(bfd, buf,
                           (size_t)std::min<int64_t>(remaining2, sizeof buf), 0);
        if (got <= 0) return false;
        if (!send_all(c->fd, buf, got)) return false;
        remaining2 -= got;
      }
    } else {
      // no framing: relay until backend closes, then drop the client conn
      while (true) {
        ssize_t got = recv(bfd, buf, sizeof buf, 0);
        if (got < 0) return false;
        if (got == 0) break;
        if (!send_all(c->fd, buf, got)) return false;
      }
      resp_close = true;
    }
  }
  if (resp_close) {
    close(c->backend_fd);
    c->backend_fd = -1;
  }
  return r.keep_alive;
}

// ---------------------------------------------------------------------------
// IO loop
// ---------------------------------------------------------------------------
void close_conn(Server* s, Conn* c) {
  if (c->in_epoll) epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, c->fd, nullptr);
  s->conns.erase(c->fd);
  if (c->backend_fd >= 0) close(c->backend_fd);
  close(c->fd);
  if (c->repl_pending) {
    // a replica fan-out still references this conn: defer the free
    // until the op concludes (finalize_repl deletes zombies)
    c->fd = -1;
    c->backend_fd = -1;
    c->in_epoll = false;
    c->zombie = true;
    return;
  }
  delete c;
}

void arm(Server* s, Conn* c, uint32_t events) {
  struct epoll_event ev = {};
  ev.events = events;
  ev.data.ptr = c;
  if (c->in_epoll) {
    epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, c->fd, &ev);
  } else {
    epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, c->fd, &ev);
    c->in_epoll = true;
  }
}

// Async replica fan-out entry (defined after flush_out): primary
// append + pipelined peer ship on the IO thread. Returns true when the
// request was taken (response arrives when every peer acks).
bool submit_repl(Server* s, Conn* c, const Request& r, uint32_t vid,
                 uint64_t key, uint32_t cookie, const uint8_t* body,
                 int64_t body_len, const char* fid, size_t fid_len,
                 bool is_delete);

// ---------------------------------------------------------------------------
// SWRP — the binary replication wire (native peer -> native peer).
// The reference replicates via full HTTP POSTs with a per-write JWT
// re-verified by the peer (topology/store_replicate.go:24 + guard).
// Between two native fronts that costs an HTTP parse + HMAC per write
// on the replica; SWRP replaces it with a one-time authenticated
// upgrade (POST /.swrp carrying a ".swrp"-claim token minted from the
// same shared secret) followed by fixed 21-byte frames:
//   u8 op (1=append, 2=delete) | u32 vid | u64 key | u32 cookie |
//   u32 body_len | body          (little-endian, x86 fleet)
// each answered in order by a fixed 14-byte ack:
//   u16 http-ish code | u32 crc | u64 size
// Primaries fall back to HTTP replicate when the peer answers the
// upgrade with anything but 101 (python-only peer, old build, or a
// jwt verdict the native side can't give).
// ---------------------------------------------------------------------------
constexpr size_t SWRP_HDR = 21;
constexpr size_t SWRP_ACK = 14;

int swrp_pump(Conn* c) {
  while (true) {
    size_t avail = c->in.size() - c->in_off;
    if (avail < SWRP_HDR) break;
    const uint8_t* p = (const uint8_t*)c->in.data() + c->in_off;
    uint8_t op = p[0];
    uint32_t vid, cookie, blen;
    uint64_t key;
    memcpy(&vid, p + 1, 4);
    memcpy(&key, p + 5, 8);
    memcpy(&cookie, p + 13, 4);
    memcpy(&blen, p + 17, 4);
    if ((op != 1 && op != 2) || blen > (8u << 20) || (op == 2 && blen != 0))
      return -1;  // poisoned channel: close, primary retries over HTTP
    if (avail < SWRP_HDR + blen) break;
    uint16_t code;
    uint32_t crc = 0;
    int64_t size = 0;
    std::shared_ptr<Vol> v = find_vol(vid);
    if (!v) {
      code = 404;
    } else if (op == 1) {
      int st = append_plain(v, key, cookie, p + SWRP_HDR, blen, &crc);
      code = st == 0 ? 503 : (uint16_t)st;  // 0 = python-only volume
      size = blen;
      if (st == 201) n_fast_post++;
    } else {
      int64_t reclaimed = 0;
      int st = delete_tomb(v, key, &reclaimed);
      code = st == 0 ? 503 : (uint16_t)st;
      size = reclaimed;
      if (st == 202) n_fast_delete++;
    }
    uint8_t ack[SWRP_ACK];
    memcpy(ack, &code, 2);
    memcpy(ack + 2, &crc, 4);
    memcpy(ack + 6, &size, 8);
    c->out.append((const char*)ack, SWRP_ACK);
    c->in_off += SWRP_HDR + blen;
  }
  if (c->in_off == c->in.size()) {
    c->in.clear();
    c->in_off = 0;
  }
  return 0;
}

// Relay the conn to a proxy worker: flush queued fast responses, send
// any owed 100-continue, remove from the IO thread's tables and queue
// it. Shared by the volume and S3 fronts. Always returns 1.
int proxy_handoff(Server* s, Conn* c, const Request& r, size_t avail) {
  // a proxied request with Expect: 100-continue must get the interim
  // response from US before the relay blocks waiting for its body —
  // the backend's own 100 (if any) is relayed too, which clients
  // tolerate (1xx may repeat)
  if (r.expect_100 && !c->sent_100) {
    bool body_done = false;
    body_len_buffered(r, c->in.data() + c->in_off + r.head_len,
                      avail - r.head_len, &body_done);
    if (!body_done) {
      c->out.append("HTTP/1.1 100 Continue\r\n\r\n");
      c->sent_100 = true;
    }
  }
  // proxy: hand the whole connection to a worker thread (it is
  // removed from the conns table too — the worker owns and may
  // delete it; re-registration happens via the returned queue)
  if (c->in_epoll) {
    epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, c->fd, nullptr);
    c->in_epoll = false;
  }
  s->conns.erase(c->fd);
  // flush anything already queued (fast responses for pipelined reqs)
  if (c->out.size() > c->out_off) {
    set_nonblock(c->fd, false);
    send_all(c->fd, c->out.data() + c->out_off, c->out.size() - c->out_off);
    c->out.clear();
    c->out_off = 0;
  }
  {
    std::lock_guard<std::mutex> lk(s->q_mu);
    s->proxy_q.push_back(c);
  }
  s->q_cv.notify_one();
  return 1;
}

// Try to serve buffered requests. Returns: 0 keep reading, 1 handed to
// proxy workers, -1 close.
int pump_inner(Server* s, Conn* c) {
  // a replicated op is in flight: hold further pipelined requests
  // until its response is written (HTTP responses must stay ordered)
  if (c->repl_pending) return 0;
  if (c->swrp) return swrp_pump(c);
  if (c->want_close) {  // close-marked response still flushing:
    c->in.clear();      // discard whatever else the client streams
    c->in_off = 0;
    return 0;
  }
  while (true) {
    if (c->in_off > 0 && c->in_off == c->in.size()) {
      c->in.clear();
      c->in_off = 0;
    }
    size_t avail = c->in.size() - c->in_off;
    if (avail == 0) break;
    Request r;
    ssize_t hl = parse_head(c->in.data() + c->in_off, avail, &r);
    if (hl < 0) return -1;
    if (hl == 0) break;  // need more bytes
    bool is_get = ieq(r.method, r.method_len, "GET");
    bool is_head = ieq(r.method, r.method_len, "HEAD");
    bool is_post =
        ieq(r.method, r.method_len, "POST") || ieq(r.method, r.method_len, "PUT");
    bool is_del = ieq(r.method, r.method_len, "DELETE");
    // SWRP upgrade: authenticate the replication channel once, then
    // switch this conn to binary frames (see the block above swrp_pump)
    if (is_post && r.path_len == 6 && memcmp(r.path, "/.swrp", 6) == 0 &&
        !r.chunked && r.content_len == 0) {
      JwtRes jr = jwt_check(r.auth, r.auth_len, ".swrp", 5);
      c->in_off += r.head_len;
      c->sent_100 = false;
      if (jr == JwtRes::OK) {
        c->out.append(
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: swrp\r\nConnection: Upgrade\r\n\r\n");
        c->swrp = true;
        return swrp_pump(c);
      }
      // REJECT and UNSURE both refuse the upgrade — the primary falls
      // back to HTTP replicate, where per-write tokens get the full
      // (python-assisted) verdict
      simple_response(c, jr == JwtRes::REJECT ? 401 : 400,
                      "swrp upgrade refused", r.keep_alive);
      continue;
    }
    uint32_t vid;
    uint64_t key;
    uint32_t cookie;
    bool fid_ok = parse_fid_path(r.path, r.path_len, &vid, &key, &cookie);
    // deadline/fault gate (SWRP above stays exempt). Deferred while a
    // fast-path write is still buffering its body — the pump re-parses
    // that request on every read, and the gate must fire exactly once
    // per request (seeded RNG) — but run before any dispatch otherwise
    // (proxied bodies stream without ever being fully buffered here).
    bool fast_body_waiting =
        is_post && fid_ok && (!r.has_query || r.is_replicate) &&
        !r.proxy_only && !r.chunked && r.content_len > 0 &&
        r.content_len <= (8 << 20) &&
        avail - r.head_len < (size_t)r.content_len;
    if (!fast_body_waiting && gate_request(c, r, avail)) continue;
    // fid as the JWT claim sees it: no leading slash, extension excluded
    const char* fid = r.path + 1;
    size_t fid_len = r.path_len ? r.path_len - 1 : 0;
    if (const char* dot = (const char*)memchr(fid, '.', fid_len))
      fid_len = dot - fid;
    // GET/HEAD fast path needs no body
    if ((is_get || is_head) && fid_ok && !r.has_query && !r.proxy_only &&
        !r.chunked && r.content_len == 0) {
      if (handle_get(c, r, vid, key, cookie, is_head)) {
        c->in_off += r.head_len;
        c->sent_100 = false;
        continue;
      }
      // fall through to proxy
    } else if (is_post && fid_ok && (!r.has_query || r.is_replicate) &&
               !r.proxy_only &&
               !r.chunked && r.content_len > 0 && r.content_len <= (8 << 20)) {
      if (r.expect_100 && !c->sent_100 &&
          avail - r.head_len < (size_t)r.content_len) {
        // client waits for the go-ahead before sending the body;
        // send the interim response exactly once per request
        c->out.append("HTTP/1.1 100 Continue\r\n\r\n");
        c->sent_100 = true;
      }
      if (avail - r.head_len < (size_t)r.content_len) break;  // need body
      const uint8_t* body =
          (const uint8_t*)c->in.data() + c->in_off + r.head_len;
      if (handle_post(s, c, r, vid, key, cookie, body, r.content_len, fid,
                      fid_len)) {
        c->in_off += r.head_len + r.content_len;
        c->sent_100 = false;
        if (c->repl_pending) return 0;  // batch mode: ack on fsync
        continue;
      }
      if (submit_repl(s, c, r, vid, key, cookie, body, r.content_len,
                      fid, fid_len, false)) {
        c->in_off += r.head_len + r.content_len;
        c->sent_100 = false;
        if (c->repl_pending) return 0;  // response arrives on peer ack
        continue;
      }
      // fall through to proxy
    } else if (is_del && fid_ok && (!r.has_query || r.is_replicate) &&
               !r.proxy_only && !r.chunked && r.content_len == 0) {
      if (handle_delete(c, r, vid, key, fid, fid_len)) {
        c->in_off += r.head_len;
        c->sent_100 = false;
        continue;
      }
      if (submit_repl(s, c, r, vid, key, cookie, nullptr, 0, fid,
                      fid_len, true)) {
        c->in_off += r.head_len;
        c->sent_100 = false;
        if (c->repl_pending) return 0;
        continue;
      }
      // fall through to proxy
    }
    return proxy_handoff(s, c, r, avail);
  }
  return 0;
}

int s3_pump_inner(Server* s, Conn* c);     // S3-role twin, defined below
int filer_pump_inner(Server* s, Conn* c);  // filer-role twin, below

int pump(Server* s, Conn* c) {
  Conn* prev = s->pumping;
  s->pumping = c;
  int st = s->role == ROLE_S3     ? s3_pump_inner(s, c)
           : s->role == ROLE_FILER ? filer_pump_inner(s, c)
                                   : pump_inner(s, c);
  s->pumping = prev;
  return st;
}

// Returns false when the Conn was closed AND FREED — the caller must
// not touch `c` again after a false return.
bool flush_out(Server* s, Conn* c) {
  while (c->out_off < c->out.size()) {
    ssize_t w = send(c->fd, c->out.data() + c->out_off,
                     c->out.size() - c->out_off, MSG_NOSIGNAL);
    if (w > 0) {
      c->out_off += w;
      continue;
    }
    if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      arm(s, c, EPOLLIN | EPOLLOUT);
      return true;
    }
    close_conn(s, c);
    return false;
  }
  c->out.clear();
  c->out_off = 0;
  if (c->want_close) {
    close_conn(s, c);
    return false;
  }
  arm(s, c, EPOLLIN);
  return true;
}

// ---------------------------------------------------------------------------
// Async replica fan-out (store_replicate.go:24 ReplicatedWrite +
// :171 DistributedOperation, redesigned as an IO-thread state
// machine): the primary appends locally, then ships the body to every
// peer as POST/DELETE /<fid>?type=replicate with the client's JWT
// forwarded — WITHOUT blocking a thread per round trip. Requests to
// one peer ride ONE pipelined keep-alive connection; the client's 200
// waits for every peer ack (both copies must exist, like the
// reference), but many client writes keep their replicates in flight
// concurrently, so the peer RTT amortizes instead of serializing.
// Any peer failure fails that write (500) and marks the volume's peer
// list stale so writes relay to Python (which re-resolves placement)
// until the control plane pushes a fresh list.
// ---------------------------------------------------------------------------
struct ReplWire {
  // raw op params — encoded for the peer conn's negotiated wire
  // (SWRP frame or HTTP request) at flush time, and re-encoded when a
  // reconnect renegotiates the protocol
  uint32_t vid = 0;
  uint32_t cookie = 0;
  uint64_t key = 0;
  std::string body;  // copied out of the client buffer (it advances)
  std::string auth;  // client token, forwarded on the HTTP wire
  std::string traceparent;  // trace context, forwarded on the HTTP wire
  std::string fid;   // path fid (no slash, no extension)
  std::string head;  // encoded header bytes (frame or HTTP head)
  int enc_mode = -1;  // PeerConn mode `head` was built for
  size_t sent = 0;    // bytes of head+body already on the socket
  time_t enq = 0;     // hang-sweep clock
  ReplOp* op = nullptr;
  bool is_delete = false;
};

// Peer wire protocol states: the first use of a conn sends the SWRP
// upgrade; 101 switches to binary frames, anything else falls back to
// per-request HTTP replicate on the same conn.
constexpr int PEER_HS = -1;
constexpr int PEER_HTTP = 0;
constexpr int PEER_BIN = 1;

struct PeerConn {
  int kind = KIND_PEER;
  std::string hostport;
  int fd = -1;
  bool in_epoll = false;
  int mode = PEER_HS;
  std::string hs_buf;  // upgrade request bytes
  size_t hs_off = 0;
  std::string in;  // response bytes
  size_t in_off = 0;
  std::deque<ReplWire*> sendq;  // not yet fully written
  std::deque<ReplWire*> await;  // written, awaiting response (FIFO)
  bool retried = false;     // one reconnect per failure burst
  bool dirty = false;       // queued in Server::dirty_peers this batch
  bool connecting = false;  // non-blocking connect still in flight
};

size_t wire_total(const ReplWire* w) {
  return w->head.size() + (w->is_delete ? 0 : w->body.size());
}

void encode_wire(ReplWire* w, int mode) {
  w->head.clear();
  w->sent = 0;
  w->enc_mode = mode;
  if (mode == PEER_BIN) {
    uint8_t h[21];
    h[0] = w->is_delete ? 2 : 1;
    memcpy(h + 1, &w->vid, 4);
    memcpy(h + 5, &w->key, 8);
    memcpy(h + 13, &w->cookie, 4);
    uint32_t blen = w->is_delete ? 0 : (uint32_t)w->body.size();
    memcpy(h + 17, &blen, 4);
    w->head.append((const char*)h, sizeof h);
    return;
  }
  w->head.append(w->is_delete ? "DELETE /" : "POST /");
  w->head.append(w->fid);
  w->head.append("?type=replicate HTTP/1.1\r\nHost: x\r\n"
                 "Content-Type: application/octet-stream\r\n"
                 "Content-Length: ");
  w->head.append(
      std::to_string(w->is_delete ? 0 : (long long)w->body.size()));
  w->head.append("\r\n");
  if (!w->auth.empty()) {
    // forward the client's token: same fid claim, still inside its
    // validity window (the reference forwards the jwt the same way)
    w->head.append("Authorization: ");
    w->head.append(w->auth);
    w->head.append("\r\n");
  }
  if (!w->traceparent.empty()) {
    // pass-through only: the dataplane never records spans, it just
    // keeps the python-side trace stitched across the replicate hop
    w->head.append("traceparent: ");
    w->head.append(w->traceparent);
    w->head.append("\r\n");
  }
  w->head.append("\r\n");
}

void arm_peer(Server* s, PeerConn* pc, uint32_t events) {
  struct epoll_event ev = {};
  ev.events = events;
  ev.data.ptr = pc;
  if (pc->in_epoll) {
    epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, pc->fd, &ev);
  } else {
    epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, pc->fd, &ev);
    pc->in_epoll = true;
  }
}

// Fresh conn: queue the SWRP upgrade. Op wires wait for the verdict —
// pipelining frames behind the upgrade would garble an HTTP-only peer.
void start_handshake(PeerConn* pc) {
  pc->mode = PEER_HS;
  pc->hs_off = 0;
  pc->hs_buf = "POST /.swrp HTTP/1.1\r\nHost: ";
  pc->hs_buf += pc->hostport;
  pc->hs_buf += "\r\nUpgrade: swrp\r\nConnection: Upgrade\r\n"
                "Content-Length: 0\r\n";
  std::string tok = mint_swrp_token();
  if (!tok.empty()) {
    pc->hs_buf += "Authorization: Bearer ";
    pc->hs_buf += tok;
    pc->hs_buf += "\r\n";
  }
  pc->hs_buf += "\r\n";
}

PeerConn* get_peer(Server* s, const std::string& hostport) {
  PeerConn*& pc = s->peer_conns[hostport];
  if (!pc) {
    pc = new PeerConn();
    pc->hostport = hostport;
  }
  if (pc->fd < 0) {
    bool in_progress = false;
    int fd = connect_hostport_nb(hostport, &in_progress);
    if (fd < 0) return nullptr;
    pc->fd = fd;
    pc->connecting = in_progress;
    pc->in_epoll = false;
    pc->in.clear();
    pc->in_off = 0;
    start_handshake(pc);
  }
  return pc;
}

void finalize_repl(Server* s, ReplOp* op);
void peer_fail(Server* s, PeerConn* pc);

void peer_flush(Server* s, PeerConn* pc) {
  if (pc->fd < 0) return;
  if (pc->connecting) {
    // wait for the connect verdict (EPOLLOUT / EPOLLERR)
    arm_peer(s, pc, EPOLLIN | EPOLLOUT);
    return;
  }
  if (pc->mode == PEER_HS) {
    // only the upgrade goes out until the peer picks the protocol
    while (pc->hs_off < pc->hs_buf.size()) {
      ssize_t n = send(pc->fd, pc->hs_buf.data() + pc->hs_off,
                       pc->hs_buf.size() - pc->hs_off, MSG_NOSIGNAL);
      if (n > 0) {
        pc->hs_off += n;
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
      peer_fail(s, pc);
      return;
    }
    arm_peer(s, pc,
             EPOLLIN | (pc->hs_off < pc->hs_buf.size() ? EPOLLOUT : 0));
    return;
  }
  for (ReplWire* w : pc->sendq)
    if (w->enc_mode != pc->mode) encode_wire(w, pc->mode);
  while (!pc->sendq.empty()) {
    // one writev per burst: every queued wire's remaining head+body
    struct iovec iov[64];
    int nv = 0;
    for (ReplWire* w : pc->sendq) {
      if (nv >= 62) break;
      size_t hs = w->head.size();
      if (w->sent < hs)
        iov[nv++] = {(void*)(w->head.data() + w->sent), hs - w->sent};
      if (!w->is_delete) {
        size_t boff = w->sent > hs ? w->sent - hs : 0;
        if (boff < w->body.size())
          iov[nv++] = {(void*)(w->body.data() + boff),
                       w->body.size() - boff};
      }
    }
    ssize_t n = writev(pc->fd, iov, nv);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      peer_fail(s, pc);
      return;
    }
    if (n == 0) break;
    size_t left = (size_t)n;
    while (left > 0) {
      ReplWire* w = pc->sendq.front();
      size_t total = wire_total(w);
      size_t take = std::min(left, total - w->sent);
      w->sent += take;
      left -= take;
      if (w->sent == total) {
        pc->sendq.pop_front();
        pc->await.push_back(w);
      }
    }
  }
  // EPOLLIN always: responses, or the peer closing an idle conn
  arm_peer(s, pc, EPOLLIN | (pc->sendq.empty() ? 0 : EPOLLOUT));
}

// Resume a conn whose gated async op just concluded: flush the queued
// response and pump any requests buffered while the op was in flight.
// No-op when called synchronously from inside this conn's own pump
// (the pump loop continues and its caller flushes).
void resume_gated(Server* s, Conn* c) {
  if (s->pumping == c) return;
  if (!flush_out(s, c)) return;  // conn freed on write error / close
  int st = pump(s, c);
  if (st == -1)
    close_conn(s, c);
  else if (st == 0)
    flush_out(s, c);
  // st == 1: handed to proxy workers
}

// Conclude one op: stats, stale marking, client response, resume the
// client's (gated) pipeline.
void finalize_repl(Server* s, ReplOp* op) {
  if (op->failed) {
    n_fanout_fail++;
    std::lock_guard<std::mutex> lk(op->v->mu);
    op->v->peers_stale = true;  // relay until the next peer refresh
  } else if (op->plain) {
    n_fast_post++;  // group-commit-gated fast post, no fan-out
  } else if (op->is_delete) {
    n_fast_delete++;
  } else {
    n_repl_post++;
  }
  Conn* c = op->client;
  c->repl_pending = false;
  if (c->zombie) {
    delete c;
    delete op;
    return;
  }
  if (op->failed) {
    std::string msg = (op->is_delete ? "replicate delete to "
                                     : "replicate to ") +
                      op->failed_peer + " failed";
    simple_response(c, 500, msg.c_str(), op->keep_alive);
  } else if (op->is_delete) {
    respond_delete_ok(c, op->keep_alive, op->size);
  } else {
    respond_post_ok(c, op->keep_alive, op->size, op->crc);
  }
  c->sent_100 = false;
  delete op;
  resume_gated(s, c);
}

// Peer conn died (or responded unframed): retry the unacked tail once
// on a fresh connection — a dead keep-alive conn looks identical to a
// peer error (same contract as the old blocking fan-out; the replicate
// append is same-key-same-bytes idempotent, so a duplicate delivery on
// the retry is harmless). A second death without an intervening
// response fails every queued op.
void peer_fail(Server* s, PeerConn* pc) {
  if (pc->fd >= 0) {
    if (pc->in_epoll)
      epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, pc->fd, nullptr);
    close(pc->fd);
    pc->fd = -1;
    pc->in_epoll = false;
    pc->connecting = false;
  }
  pc->in.clear();
  pc->in_off = 0;
  std::deque<ReplWire*> items;
  items.swap(pc->await);
  for (ReplWire* w : pc->sendq) items.push_back(w);
  pc->sendq.clear();
  if (items.empty()) {
    pc->retried = false;  // idle server-side close: nothing lost
    return;
  }
  if (!pc->retried) {
    pc->retried = true;
    bool in_progress = false;
    int fd = connect_hostport_nb(pc->hostport, &in_progress);
    if (fd >= 0) {
      pc->fd = fd;
      pc->connecting = in_progress;
      start_handshake(pc);  // the fresh conn renegotiates the protocol
      time_t now = time(nullptr);
      for (ReplWire* w : items) {
        w->sent = 0;
        w->enq = now;  // the retry earns a fresh hang window
        pc->sendq.push_back(w);
      }
      peer_flush(s, pc);
      return;
    }
  }
  pc->retried = false;
  for (ReplWire* w : items) {
    ReplOp* op = w->op;
    op->waiting--;
    if (!op->failed) {
      op->failed = true;
      op->failed_peer = pc->hostport;
    }
    delete w;
    if (op->waiting == 0) finalize_repl(s, op);
  }
}

void peer_read(Server* s, PeerConn* pc) {
  char buf[16 << 10];
  while (true) {
    ssize_t got = recv(pc->fd, buf, sizeof buf, 0);
    if (got > 0) {
      pc->in.append(buf, got);
      if (pc->in.size() - pc->in_off > (size_t)(16 << 20)) {
        peer_fail(s, pc);  // runaway response
        return;
      }
      continue;
    }
    if (got == 0 || (errno != EAGAIN && errno != EWOULDBLOCK)) {
      peer_fail(s, pc);
      return;
    }
    break;  // EAGAIN: parsed what we have
  }
  if (pc->mode == PEER_HS) {
    // upgrade verdict: 101 = binary frames; any other framed response
    // = HTTP fallback (python-only peer / jwt verdict refused)
    const char* base = pc->in.data() + pc->in_off;
    size_t avail = pc->in.size() - pc->in_off;
    const char* he = (const char*)memmem(base, avail, "\r\n\r\n", 4);
    if (!he) return;  // need more bytes
    size_t head_len = he - base + 4;
    int code = avail >= 12 ? atoi(base + 9) : 0;
    if (code == 101) {
      pc->in_off += head_len;
      pc->mode = PEER_BIN;
    } else {
      const char* clh =
          (const char*)memmem(base, head_len, "Content-Length:", 15);
      if (!clh)
        clh = (const char*)memmem(base, head_len, "content-length:", 15);
      if (!clh) {
        peer_fail(s, pc);  // unframed refusal: the conn can't be reused
        return;
      }
      int64_t cl = strtoll(clh + 15, nullptr, 10);
      if ((int64_t)avail < (int64_t)head_len + cl) return;  // need body
      pc->in_off += head_len + cl;
      pc->mode = PEER_HTTP;
    }
    // NOTE: the handshake verdict does NOT reset the retry budget —
    // only a completed op response does. A peer that refuses the
    // upgrade and then closes would otherwise reconnect forever
    // (refuse -> close -> retry -> refuse ...) instead of failing the
    // queued ops over to the Python relay after one retry.
    peer_flush(s, pc);  // encode + ship everything queued
    if (pc->fd < 0) return;
  }
  if (pc->mode == PEER_BIN) {
    while (!pc->await.empty() &&
           pc->in.size() - pc->in_off >= SWRP_ACK) {
      const uint8_t* a = (const uint8_t*)pc->in.data() + pc->in_off;
      uint16_t code;
      uint32_t crc;
      int64_t size;
      memcpy(&code, a, 2);
      memcpy(&crc, a + 2, 4);
      memcpy(&size, a + 6, 8);
      pc->in_off += SWRP_ACK;
      ReplWire* w = pc->await.front();
      pc->await.pop_front();
      pc->retried = false;
      ReplOp* op = w->op;
      bool ok = (code >= 200 && code < 300) ||
                (w->is_delete && code == 404);  // peer never had the copy
      delete w;
      op->waiting--;
      if (!ok && !op->failed) {
        op->failed = true;
        op->failed_peer = pc->hostport;
      }
      if (op->waiting == 0) finalize_repl(s, op);
    }
    if (pc->in_off == pc->in.size()) {
      pc->in.clear();
      pc->in_off = 0;
    }
    return;
  }
  while (!pc->await.empty()) {
    const char* base = pc->in.data() + pc->in_off;
    size_t avail = pc->in.size() - pc->in_off;
    const char* he = (const char*)memmem(base, avail, "\r\n\r\n", 4);
    if (!he) break;
    size_t head_len = he - base + 4;
    const char* clh =
        (const char*)memmem(base, head_len, "Content-Length:", 15);
    if (!clh)
      clh = (const char*)memmem(base, head_len, "content-length:", 15);
    if (!clh) {
      peer_fail(s, pc);  // unframed: the conn can't be trusted
      return;
    }
    int64_t cl = strtoll(clh + 15, nullptr, 10);
    if ((int64_t)avail < (int64_t)head_len + cl) break;
    int code = avail >= 12 ? atoi(base + 9) : 0;
    bool close_hint =
        memmem(base, head_len, "Connection: close", 17) ||
        memmem(base, head_len, "connection: close", 17);
    pc->in_off += head_len + cl;
    ReplWire* w = pc->await.front();
    pc->await.pop_front();
    pc->retried = false;  // a live response resets the retry budget
    ReplOp* op = w->op;
    bool ok = (code >= 200 && code < 300) ||
              (w->is_delete && code == 404);  // peer never had the copy
    delete w;
    op->waiting--;
    if (!ok && !op->failed) {
      op->failed = true;
      op->failed_peer = pc->hostport;
    }
    if (op->waiting == 0) finalize_repl(s, op);
    if (close_hint) {
      peer_fail(s, pc);
      return;
    }
  }
  if (pc->in_off == pc->in.size()) {
    pc->in.clear();
    pc->in_off = 0;
  }
}

void peer_event(Server* s, PeerConn* pc, uint32_t events) {
  if (events & (EPOLLHUP | EPOLLERR)) {
    peer_fail(s, pc);
    return;
  }
  if (pc->connecting && (events & EPOLLOUT)) {
    int err = 0;
    socklen_t len = sizeof err;
    getsockopt(pc->fd, SOL_SOCKET, SO_ERROR, &err, &len);
    if (err != 0) {
      peer_fail(s, pc);
      return;
    }
    pc->connecting = false;  // connected: fall through to the flush
  }
  if (events & EPOLLOUT) {
    peer_flush(s, pc);
    if (pc->fd < 0) return;  // flush hit a dead conn
  }
  if (events & EPOLLIN) peer_read(s, pc);
}

// Ops stuck past the window (peer accepted the conn but never
// responds) get the same treatment as a dead conn: one retry burst,
// then failure. 30s matches the old blocking path's SO_RCVTIMEO.
void peer_sweep(Server* s) {
  time_t now = time(nullptr);
  if (now == s->last_peer_sweep) return;
  s->last_peer_sweep = now;
  // snapshot first: peer_fail -> finalize -> pump can submit new ops
  // whose get_peer inserts into peer_conns, invalidating a live
  // iterator (PeerConn objects themselves live until dp_stop)
  std::vector<PeerConn*> snap;
  snap.reserve(s->peer_conns.size());
  for (auto& [hp, pc] : s->peer_conns) snap.push_back(pc);
  for (PeerConn* pc : snap) {
    ReplWire* oldest = !pc->await.empty() ? pc->await.front()
                       : !pc->sendq.empty() ? pc->sendq.front()
                                            : nullptr;
    if (oldest && now - oldest->enq > 30) peer_fail(s, pc);
  }
}

bool submit_repl(Server* s, Conn* c, const Request& r, uint32_t vid,
                 uint64_t key, uint32_t cookie, const uint8_t* body,
                 int64_t body_len, const char* fid, size_t fid_len,
                 bool is_delete) {
  // multipart/form and metadata uploads need Python's form decoding —
  // appending the raw envelope would corrupt the needle on every
  // replica (same guard as handle_post)
  if (!is_delete && !r.plain_upload) return false;
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return false;
  std::vector<std::string> peers;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    if (v->detached || !v->has_replicas || v->peers_stale ||
        v->peers.empty())
      return false;  // python resolves placement and fans out
    peers = v->peers;
  }
  JwtRes jr = jwt_check(r.auth, r.auth_len, fid, fid_len);
  if (jr == JwtRes::UNSURE) return false;  // python gives the verdict
  if (jr == JwtRes::REJECT) {
    n_jwt_reject++;
    simple_response(c, 401, "jwt rejected", r.keep_alive);
    return true;
  }
  uint32_t crc = 0;
  int64_t reclaimed = 0;
  int st = is_delete ? delete_tomb(v, key, &reclaimed)
                     : append_plain(v, key, cookie, body, body_len, &crc);
  if (st == 0) return false;
  if (st == 409) {
    simple_response(c, 409, "volume is read only", r.keep_alive);
    return true;
  }
  if (st == 500) {
    n_errors++;
    simple_response(c, 500, is_delete ? "delete failed" : "write failed",
                    r.keep_alive);
    return true;
  }
  ReplOp* op = new ReplOp();
  op->client = c;
  op->v = v;
  op->is_delete = is_delete;
  op->keep_alive = r.keep_alive;
  op->size = is_delete ? reclaimed : body_len;
  op->crc = crc;
  c->repl_pending = true;
  time_t now = time(nullptr);
  for (const auto& peer : peers) {
    PeerConn* pc = get_peer(s, peer);
    if (!pc) {
      if (!op->failed) {
        op->failed = true;
        op->failed_peer = peer;
      }
      continue;  // still await peers already queued
    }
    ReplWire* w = new ReplWire();
    w->op = op;
    w->is_delete = is_delete;
    w->enq = now;
    w->vid = vid;
    w->key = key;
    w->cookie = cookie;
    w->fid.assign(fid, fid_len);
    if (r.auth && r.auth_len) w->auth.assign(r.auth, r.auth_len);
    if (r.traceparent && r.traceparent_len)
      w->traceparent.assign(r.traceparent, r.traceparent_len);
    if (!is_delete && body_len > 0)
      w->body.assign((const char*)body, body_len);
    pc->sendq.push_back(w);
    op->waiting++;
    if (!pc->dirty) {  // flushed once per epoll batch (writev burst)
      pc->dirty = true;
      s->dirty_peers.push_back(pc);
    }
  }
  int mode = commit_mode.load(std::memory_order_relaxed);
  if (!is_delete) {
    if (mode == 2) commit_sync_inline(v);
    if (mode == 1) {
      // replica sends are already queued (they start from the page
      // cache); only the client ack additionally waits on the local
      // fsync — network and disk overlap instead of serializing
      op->waiting++;  // the fsync token
      commit_enqueue(s, v, body_len, op, 0);
    }
  }
  if (op->waiting == 0) finalize_repl(s, op);
  return true;
}

// End-of-batch peer flush: every client write handled in this epoll
// round queued its replicates; ship each peer's burst with one writev.
void flush_dirty_peers(Server* s) {
  for (size_t i = 0; i < s->dirty_peers.size(); i++) {
    PeerConn* pc = s->dirty_peers[i];
    pc->dirty = false;
    if (pc->fd >= 0)
      peer_flush(s, pc);
    else if (!pc->sendq.empty())
      peer_fail(s, pc);  // conn died between queue and flush: retry path
  }
  s->dirty_peers.clear();
}

// ---------------------------------------------------------------------------
// Native S3 front (role ROLE_S3) — the gateway hot path in C++.
//
// The reference serves S3 entirely in compiled Go
// (s3api_object_handlers_put.go -> filer autochunk); this build's
// python gateway measured ~1k rps against the same box's 40-60k
// native volume path. The front owns the public S3 port in the
// combined `server -s3` process: small-object PUT/GET/HEAD with
// header SigV4 are verified (auth_signature_v4.go semantics),
// appended to the LOCAL volume store from a pre-assigned fid pool,
// and the metadata insert is handed to the in-process python filer
// over a socketpair channel (the create_entry — parent dirs, old-
// chunk GC, event log — keeps its one python implementation).
// Everything else (multipart, presigned, V2, streaming-signed,
// listings, bucket ops, unknown identities) relays to the python S3
// app unchanged. The GET cache is maintained ONLY by the filer's
// serialized meta-event stream (cache_put/invalidate pushed under the
// filer mutation lock), so any mutation path — native or python —
// keeps it coherent; a miss relays and stays strongly consistent.
// ---------------------------------------------------------------------------
struct S3Ident {
  std::string secret;
  bool admin = false;
  bool write_all = false;
  bool read_all = false;
  std::unordered_set<std::string> wr, rd;  // bucket-scoped actions
};

std::shared_mutex s3_mu;  // identities + buckets + signing-key cache
std::unordered_map<std::string, S3Ident> s3_idents;
bool s3_open_mode = true;  // no identities configured = open access
std::unordered_set<std::string> s3_buckets;
std::unordered_map<std::string, std::array<uint8_t, 32>> s3_keycache;

struct S3Slot {
  uint32_t vid;
  uint64_t key;
  uint32_t cookie;
};
std::mutex s3_pool_mu;
std::unordered_map<std::string, std::deque<S3Slot>> s3_pools;

struct S3Ent {
  uint32_t vid;
  uint64_t key;
  uint32_t cookie;
  int64_t size;
  int64_t mtime;  // unix seconds
  std::string etag, mime;
  std::string meta;  // response-ready "x-amz-meta-k: v\r\n" block
};
std::shared_mutex s3_cache_mu;
std::unordered_map<std::string, S3Ent> s3_cache;  // "/bucket/key"
constexpr size_t S3_CACHE_CAP = 200000;

std::atomic<int64_t> n_s3_put{0}, n_s3_get{0}, n_s3_reject{0},
    n_s3_chan_fail{0}, n_s3_del{0}, n_s3_part{0};

// live multipart upload ids ("bucket\tupload_id"), synced by the python
// glue's meta listener from /buckets/<b>/.uploads/<id>/ marker dirs; a
// part-upload PUT whose id is absent relays to python (which answers
// NoSuchUpload itself — no XML parity burden here)
std::shared_mutex s3_upload_mu;
std::unordered_set<std::string> s3_uploads;

// ---- native filer front (role ROLE_FILER) state ----
// Entry cache keyed by the normalized full path ("/dir/file"). Like the
// S3 cache it is positive-only and maintained exclusively by the python
// glue's meta-event listener, so it inherits the zero-staleness
// contract: any mutation (either channel) emits a meta event before the
// mutating call returns, and the listener runs synchronously on it.
struct FilerEnt {
  uint32_t vid;
  uint64_t key;
  uint32_t cookie;
  int64_t size;
  int64_t mtime;  // unix seconds
  std::string etag, mime;
  std::string ext;  // response-ready "x-seaweed-ext-k: v\r\n" block
};
std::shared_mutex filer_cache_mu;
std::unordered_map<std::string, FilerEnt> filer_cache;
constexpr size_t FILER_CACHE_CAP = 200000;

// pre-assigned fid slots for native filer PUTs (default collection /
// replication — anything else relays)
std::mutex filer_pool_mu;
std::deque<S3Slot> filer_pool;

// Native writes are only sound while the python filer would apply no
// per-path policy the front can't see: the glue clears this whenever
// filer.conf rules, cipher, or save-inline limits are active.
std::atomic<bool> filer_writes_on{false};

std::atomic<int64_t> n_filer_put{0}, n_filer_get{0}, n_filer_del{0},
    n_filer_chan_fail{0};

// scan the raw request head for one header (case-insensitive name)
bool find_header(const char* head, size_t head_len, const char* name,
                 const char** val, size_t* vlen) {
  size_t nlen = strlen(name);
  const char* p = (const char*)memchr(head, '\n', head_len);
  if (!p) return false;
  p++;  // past the request line
  const char* end = head + head_len;
  while (p < end) {
    const char* le = (const char*)memchr(p, '\n', end - p);
    if (!le) break;
    const char* colon = (const char*)memchr(p, ':', le - p);
    if (colon && (size_t)(colon - p) == nlen &&
        strncasecmp(p, name, nlen) == 0) {
      const char* v = colon + 1;
      const char* ve = le > p && le[-1] == '\r' ? le - 1 : le;
      while (v < ve && (*v == ' ' || *v == '\t')) v++;
      while (ve > v && (ve[-1] == ' ' || ve[-1] == '\t')) ve--;
      *val = v;
      *vlen = ve - v;
      return true;
    }
    p = le + 1;
  }
  return false;
}

// AWS canonical form: trim + collapse inner whitespace runs to one
// space (python: " ".join(v.split()))
void collapse_ws(const char* v, size_t n, std::string* out) {
  size_t i = 0;
  while (i < n) {
    while (i < n && (v[i] == ' ' || v[i] == '\t')) i++;
    size_t j = i;
    while (j < n && v[j] != ' ' && v[j] != '\t') j++;
    if (j > i) {
      if (!out->empty()) out->push_back(' ');
      out->append(v + i, j - i);
    }
    i = j;
  }
}

bool s3_canonical_path(const char* p, size_t n) {
  for (size_t i = 0; i < n; i++) {
    char c = p[i];
    if (!(isalnum((unsigned char)c) || c == '/' || c == '-' ||
          c == '.' || c == '_' || c == '~'))
      return false;  // would need percent-encoding: relay
  }
  return true;
}

void s3_error(Conn* c, int status, const char* code, const char* msg,
              const char* path, size_t path_len, bool keep_alive) {
  char body[512];
  int bl = snprintf(body, sizeof body,
                    "<?xml version=\"1.0\" encoding=\"UTF-8\"?>\n"
                    "<Error><Code>%s</Code><Message>%s</Message>"
                    "<Resource>%.*s</Resource></Error>",
                    code, msg, (int)path_len, path);
  char head[256];
  const char* st = status == 403   ? "403 Forbidden"
                   : status == 400 ? "400 Bad Request"
                   : status == 404 ? "404 Not Found"
                                   : "500 Internal Server Error";
  int hl = snprintf(head, sizeof head,
                    "HTTP/1.1 %s\r\nContent-Type: application/xml\r\n"
                    "Content-Length: %d\r\n%s\r\n",
                    st, bl, keep_alive ? "" : "Connection: close\r\n");
  c->out.append(head, hl);
  c->out.append(body, bl);
  if (!keep_alive) c->want_close = true;
  n_s3_reject++;
  count_resp(status, bl);
}

constexpr const char* EMPTY_SHA256 =
    "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855";

// SigV4 header-auth verdict for the fast path.
enum class S3Auth { OK, REJECTED, RELAY };

// Verifies Authorization: AWS4-HMAC-SHA256 against the pushed
// identity table (auth_signature_v4.go semantics: canonical request,
// credential-scope signing key [cached per access-key+date], ±15min
// clock skew, payload-hash check). Writes the rejection response
// itself. Anything it can't judge definitively relays to python.
S3Auth s3_auth(Conn* c, const Request& r, const char* head,
               const char* method, bool need_write,
               const std::string& bucket, const uint8_t* body,
               int64_t body_len, const std::string& canon_query = "") {
  {
    std::shared_lock<std::shared_mutex> lk(s3_mu);
    if (s3_open_mode) return S3Auth::OK;
  }
  if (!r.auth || r.auth_len < 17 ||
      strncmp(r.auth, "AWS4-HMAC-SHA256 ", 17) != 0)
    return S3Auth::RELAY;  // presigned / V2 / anonymous: python's call
  // parse Credential=AK/date/region/service/aws4_request,
  // SignedHeaders=a;b;c, Signature=hex
  std::string ak, datestamp, region, service, signed_hdrs, sig;
  {
    const char* p = r.auth + 17;
    const char* end = r.auth + r.auth_len;
    while (p < end) {
      while (p < end && (*p == ' ' || *p == ',')) p++;
      const char* comma = (const char*)memchr(p, ',', end - p);
      if (!comma) comma = end;
      const char* eq = (const char*)memchr(p, '=', comma - p);
      if (eq) {
        std::string k(p, eq - p);
        std::string v(eq + 1, comma - eq - 1);
        if (k == "Credential") {
          size_t a = v.find('/'), b = v.find('/', a + 1),
                 d = v.find('/', b + 1), e = v.find('/', d + 1);
          if (e == std::string::npos) return S3Auth::RELAY;
          ak = v.substr(0, a);
          datestamp = v.substr(a + 1, b - a - 1);
          region = v.substr(b + 1, d - b - 1);
          service = v.substr(d + 1, e - d - 1);
        } else if (k == "SignedHeaders") {
          signed_hdrs = v;
        } else if (k == "Signature") {
          sig = v;
        }
      }
      p = comma + 1;
    }
  }
  if (ak.empty() || sig.empty() || signed_hdrs.empty())
    return S3Auth::RELAY;
  S3Ident ident;
  {
    std::shared_lock<std::shared_mutex> lk(s3_mu);
    auto it = s3_idents.find(ak);
    if (it == s3_idents.end())
      return S3Auth::RELAY;  // table may lag a hot reload: python decides
    ident = it->second;
  }
  // clock skew (auth_signature_v4.go:MAX_CLOCK_SKEW equivalent)
  const char* dv;
  size_t dvl;
  if (!find_header(head, r.head_len, "x-amz-date", &dv, &dvl) || dvl != 16)
    return S3Auth::RELAY;
  std::string amz_date(dv, dvl);
  struct tm tmv = {};
  if (sscanf(amz_date.c_str(), "%4d%2d%2dT%2d%2d%2dZ", &tmv.tm_year,
             &tmv.tm_mon, &tmv.tm_mday, &tmv.tm_hour, &tmv.tm_min,
             &tmv.tm_sec) != 6)
    return S3Auth::RELAY;
  tmv.tm_year -= 1900;
  tmv.tm_mon -= 1;
  time_t t = timegm(&tmv);
  time_t now = time(nullptr);
  if (t < now - 900 || t > now + 900) {
    s3_error(c, 403, "RequestTimeTooSkewed", "request time skewed",
             r.path, r.path_len, r.keep_alive);
    return S3Auth::REJECTED;
  }
  // payload hash: header must match the actual body (or be UNSIGNED)
  const char* hv;
  size_t hvl;
  if (!find_header(head, r.head_len, "x-amz-content-sha256", &hv, &hvl))
    return S3Auth::RELAY;
  std::string declared(hv, hvl);
  if (declared.compare(0, 10, "STREAMING-", 0, 10) == 0)
    return S3Auth::RELAY;  // aws-chunked framing: python decodes
  if (declared != "UNSIGNED-PAYLOAD") {
    if (declared.size() != 64) return S3Auth::RELAY;
    std::string actual =
        body_len > 0 ? sha256_hex(body, body_len) : EMPTY_SHA256;
    if (declared != actual) {
      s3_error(c, 400, "XAmzContentSHA256Mismatch",
               "payload hash does not match body", r.path, r.path_len,
               r.keep_alive);
      return S3Auth::REJECTED;
    }
  }
  // canonical request (python _canonical_request; fast path has no
  // query and a pre-canonical URI)
  std::vector<std::string> names;
  {
    size_t i = 0;
    while (i <= signed_hdrs.size()) {
      size_t j = signed_hdrs.find(';', i);
      if (j == std::string::npos) j = signed_hdrs.size();
      std::string nm = signed_hdrs.substr(i, j - i);
      for (auto& ch : nm) ch = (char)tolower((unsigned char)ch);
      if (!nm.empty()) names.push_back(nm);
      i = j + 1;
    }
  }
  std::sort(names.begin(), names.end());
  std::string creq;
  creq.reserve(256);
  creq += method;
  creq += '\n';
  creq.append(r.path, r.path_len);
  creq += '\n';
  creq += canon_query;  // "" for the query-less fast paths
  creq += '\n';
  for (const auto& nm : names) {
    creq += nm;
    creq += ':';
    const char* vv;
    size_t vvl;
    if (find_header(head, r.head_len, nm.c_str(), &vv, &vvl)) {
      std::string collapsed;
      collapse_ws(vv, vvl, &collapsed);
      creq += collapsed;
    }
    creq += '\n';
  }
  creq += '\n';
  for (size_t i = 0; i < names.size(); i++) {
    if (i) creq += ';';
    creq += names[i];
  }
  creq += '\n';
  creq += declared;
  // string to sign + cached signing key
  std::string sts = "AWS4-HMAC-SHA256\n" + amz_date + "\n" + datestamp +
                    "/" + region + "/" + service + "/aws4_request\n" +
                    sha256_hex((const uint8_t*)creq.data(), creq.size());
  std::array<uint8_t, 32> key;
  std::string ck = ak + "/" + datestamp + "/" + region + "/" + service;
  bool have = false;
  {
    std::shared_lock<std::shared_mutex> lk(s3_mu);
    auto it = s3_keycache.find(ck);
    if (it != s3_keycache.end()) {
      key = it->second;
      have = true;
    }
  }
  if (!have) {
    // kDate = HMAC("AWS4"+secret, date); kRegion = HMAC(kDate, region);
    // kService = HMAC(kRegion, service); key = HMAC(kService, terminal)
    std::string k0 = "AWS4" + ident.secret;
    uint8_t d1[32], d2[32], d3[32];
    hmac_sha256((const uint8_t*)k0.data(), k0.size(),
                (const uint8_t*)datestamp.data(), datestamp.size(), d1);
    hmac_sha256(d1, 32, (const uint8_t*)region.data(), region.size(), d2);
    hmac_sha256(d2, 32, (const uint8_t*)service.data(), service.size(),
                d3);
    hmac_sha256(d3, 32, (const uint8_t*)"aws4_request", 12, key.data());
    std::unique_lock<std::shared_mutex> lk(s3_mu);
    if (s3_keycache.size() > 4096) s3_keycache.clear();
    s3_keycache[ck] = key;
  }
  uint8_t mac[32];
  hmac_sha256(key.data(), 32, (const uint8_t*)sts.data(), sts.size(),
              mac);
  char hex[64];
  hex_encode(mac, 32, hex);
  if (sig.size() != 64 ||
      !const_time_eq((const uint8_t*)hex, (const uint8_t*)sig.data(), 64)) {
    s3_error(c, 403, "SignatureDoesNotMatch", "signature mismatch",
             r.path, r.path_len, r.keep_alive);
    return S3Auth::REJECTED;
  }
  // permission (Identity.allows: exact action or action:bucket)
  bool allowed = ident.admin ||
                 (need_write
                      ? (ident.write_all || ident.wr.count(bucket))
                      : (ident.read_all || ident.rd.count(bucket)));
  if (!allowed) {
    s3_error(c, 403, "AccessDenied", "permission denied", r.path,
             r.path_len, r.keep_alive);
    return S3Auth::REJECTED;
  }
  return S3Auth::OK;
}

// One gated channel mutation awaiting the python applier's ack. The
// response shape on success is per-kind (S3 and filer fronts share the
// channel machinery; is_delete kept as a kind alias for readability).
constexpr int OP_S3_PUT = 0;    // 200 + ETag + Content-Length: 0
constexpr int OP_S3_DEL = 1;    // 204 No Content
constexpr int OP_S3_PART = 2;   // part upload: same wire shape as PUT
constexpr int OP_FILER_PUT = 3; // 201 + {"name","size","etag"} json
constexpr int OP_FILER_DEL = 4; // 204 No Content

struct S3Op {
  Conn* client;
  bool keep_alive = true;
  bool is_delete = false;  // OP_S3_DEL / OP_FILER_DEL
  int kind = OP_S3_PUT;
  std::string etag;
  std::string name;      // OP_FILER_PUT: final path segment
  int64_t size = 0;      // OP_FILER_PUT: body size for the json reply
  // batch durability: the op finalizes only once BOTH the applier
  // verdict (chan_status) and the covering fsync have landed
  bool fsync_pending = false;
  int chan_status = -1;  // applier verdict parked while fsync pends
};

void arm_chan(Server* s, uint32_t events) {
  struct epoll_event ev = {};
  ev.events = events;
  ev.data.ptr = &s->chan_tag;
  if (s->chan_in_epoll) {
    epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, s->chan_fd, &ev);
  } else {
    epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->chan_fd, &ev);
    s->chan_in_epoll = true;
  }
}

void chan_flush(Server* s) {
  while (s->chan_out_off < s->chan_out.size()) {
    ssize_t n = send(s->chan_fd, s->chan_out.data() + s->chan_out_off,
                     s->chan_out.size() - s->chan_out_off, MSG_NOSIGNAL);
    if (n > 0) {
      s->chan_out_off += n;
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
    // applier died: pending ops fail via chan_read EOF
    (s->role == ROLE_FILER ? n_filer_chan_fail : n_s3_chan_fail)++;
    break;
  }
  if (s->chan_out_off == s->chan_out.size()) {
    s->chan_out.clear();
    s->chan_out_off = 0;
  }
  arm_chan(s, EPOLLIN | (s->chan_out.empty() ? 0 : EPOLLOUT));
}

// Conclude one gated S3 PUT with the applier's verdict.
void s3_finalize(Server* s, S3Op* op, int status) {
  Conn* c = op->client;
  c->repl_pending = false;
  if (c->zombie) {
    delete c;
    delete op;
    return;
  }
  if (status >= 200 && status < 300) {
    char head[512];
    int hl;
    if (op->is_delete) {
      // S3 DeleteObject / filer DELETE: 204 whether or not the key
      // existed (the python filer answers 204 the same way)
      hl = snprintf(head, sizeof head,
                    "HTTP/1.1 204 No Content\r\n%s\r\n",
                    op->keep_alive ? "" : "Connection: close\r\n");
      if (op->kind == OP_FILER_DEL)
        n_filer_del++;
      else
        n_s3_del++;
      count_resp(204, 0);
    } else if (op->kind == OP_FILER_PUT) {
      // byte-match the python filer's 201 json
      // (web.json_response({"name","size","etag"}))
      char jbody[384];
      int bl = snprintf(jbody, sizeof jbody,
                        "{\"name\": \"%s\", \"size\": %lld, "
                        "\"etag\": \"%s\"}",
                        op->name.c_str(), (long long)op->size,
                        op->etag.c_str());
      hl = snprintf(head, sizeof head,
                    "HTTP/1.1 201 Created\r\n"
                    "Content-Type: application/json; charset=utf-8\r\n"
                    "Content-Length: %d\r\n%s\r\n",
                    bl, op->keep_alive ? "" : "Connection: close\r\n");
      c->out.append(head, hl);
      c->out.append(jbody, bl);
      hl = 0;
      n_filer_put++;
      count_resp(201, bl);
      front_stats[t_role].bytes_in += op->size;
    } else {
      hl = snprintf(head, sizeof head,
                    "HTTP/1.1 200 OK\r\nETag: \"%s\"\r\n"
                    "Content-Length: 0\r\n%s\r\n",
                    op->etag.c_str(),
                    op->keep_alive ? "" : "Connection: close\r\n");
      if (op->kind == OP_S3_PART)
        n_s3_part++;
      else
        n_s3_put++;
      count_resp(200, 0);
      front_stats[t_role].bytes_in += op->size;
    }
    if (hl) c->out.append(head, hl);
    if (!op->keep_alive) c->want_close = true;
  } else {
    if (op->kind == OP_FILER_PUT || op->kind == OP_FILER_DEL) {
      simple_response(c, 500, "metadata mutation failed", op->keep_alive);
    } else {
      s3_error(c, 500, "InternalError", "metadata mutation failed", "", 0,
               op->keep_alive);
    }
  }
  c->sent_100 = false;
  delete op;
  resume_gated(s, c);
}

void chan_read(Server* s) {
  char buf[16 << 10];
  bool dead = false;
  while (true) {
    ssize_t got = recv(s->chan_fd, buf, sizeof buf, 0);
    if (got > 0) {
      s->chan_in.append(buf, got);
      continue;
    }
    if (got == 0 || (errno != EAGAIN && errno != EWOULDBLOCK)) dead = true;
    break;
  }
  while (true) {
    size_t off = s->chan_in_off;
    const char* base = s->chan_in.data() + off;
    size_t avail = s->chan_in.size() - off;
    const char* nl = (const char*)memchr(base, '\n', avail);
    if (!nl) break;
    uint64_t id = strtoull(base, nullptr, 10);
    const char* sp = (const char*)memchr(base, ' ', nl - base);
    int status = sp ? atoi(sp + 1) : 500;
    s->chan_in_off = nl - s->chan_in.data() + 1;
    auto it = s->s3_pending.find(id);
    if (it != s->s3_pending.end()) {
      S3Op* op = it->second;
      if (op->fsync_pending) {
        op->chan_status = status;  // finalize when the fsync lands
      } else {
        s->s3_pending.erase(it);
        s3_finalize(s, op, status);
      }
    }
  }
  if (s->chan_in_off == s->chan_in.size()) {
    s->chan_in.clear();
    s->chan_in_off = 0;
  }
  if (dead) {
    // the python applier is gone: fail every gated PUT loudly
    (s->role == ROLE_FILER ? n_filer_chan_fail : n_s3_chan_fail)++;
    std::unordered_map<uint64_t, S3Op*> pending;
    pending.swap(s->s3_pending);
    for (auto& [id, op] : pending) s3_finalize(s, op, 500);
  }
}

// One fsync completion, delivered on the owning server's IO thread
// (io_loop eventfd branch). Volume front: drop the ReplOp's fsync
// token. S3/filer fronts: the op finalizes only when the applier
// verdict has also landed (a chan-death sweep may have freed it
// already — the id missing from s3_pending is the tombstone).
void commit_complete(Server* s, const CommitWaiter& w) {
  if (w.rop) {
    ReplOp* op = w.rop;
    op->waiting--;
    if (op->waiting == 0) finalize_repl(s, op);
    return;
  }
  auto it = s->s3_pending.find(w.s3_id);
  if (it == s->s3_pending.end()) return;
  S3Op* op = it->second;
  op->fsync_pending = false;
  if (op->chan_status >= 0) {
    int st = op->chan_status;
    s->s3_pending.erase(it);
    s3_finalize(s, op, st);
  }
}

// DELETE fast path: the metadata delete rides the channel (the python
// applier's filer.delete_entry carries chunk reclamation and the meta
// event that invalidates our cache); the front only skips the HTTP
// relay. Returns 0 to relay (query/multipart abort, unknown bucket).
int s3_handle_delete(Server* s, Conn* c, const Request& r,
                     const char* head, const std::string& bucket,
                     const char* key, size_t key_len) {
  S3Auth a = s3_auth(c, r, head, "DELETE", true, bucket, nullptr, 0);
  if (a == S3Auth::RELAY) return 0;
  if (a == S3Auth::REJECTED) return 1;
  uint64_t id = s->next_op_id++;
  std::string rec;
  rec.reserve(64 + key_len);
  char nbuf[48];
  snprintf(nbuf, sizeof nbuf, "%llu\tdel\t", (unsigned long long)id);
  rec += nbuf;
  rec += bucket;
  rec += '\t';
  rec.append(key, key_len);
  rec += '\n';
  S3Op* op = new S3Op();
  op->client = c;
  op->keep_alive = r.keep_alive;
  op->is_delete = true;
  s->s3_pending[id] = op;
  c->repl_pending = true;
  s->chan_out += rec;  // flushed once per epoll batch
  return 1;
}

// Serve a GET/HEAD from the cache entry's local needle. false = relay
// (volume gone/detached, compressed needle, unusual Range forms, or
// on-disk surprises).
bool s3_serve_cached(Conn* c, const Request& r, const S3Ent& ent,
                     bool is_head) {
  std::shared_ptr<Vol> v = find_vol(ent.vid);
  if (!v) return false;
  int64_t off;
  int32_t size;
  int version;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    if (v->detached) return false;
    auto it = v->map.find(ent.key);
    if (it == v->map.end() || it->second.size <= 0)
      return false;  // cache newer than the needle map? let python look
    off = it->second.offset;
    size = it->second.size;
    version = v->version;
  }
  int64_t rec_len = disk_size(size, version);
  std::string rec;
  rec.resize(rec_len);
  if (pread(v->dat_fd, &rec[0], rec_len, off) != rec_len) return false;
  const uint8_t* p = (const uint8_t*)rec.data();
  if (be64(p + 4) != ent.key || be32(p) != ent.cookie) return false;
  uint32_t data_size = be32(p + HEADER);
  if ((int64_t)data_size + 5 > size) return false;
  const uint8_t* data = p + HEADER + 4;
  uint8_t flags = data[data_size];
  if (flags & FLAG_IS_COMPRESSED) return false;  // python inflates
  uint32_t stored_crc = be32(p + HEADER + size);
  uint32_t actual = data_size ? crc32c(0, data, data_size) : 0;
  if (data_size && stored_crc != actual &&
      stored_crc != legacy_crc_value(actual))
    return false;  // corrupt: python's read path reports it properly
  // single-range GET (S3 GetObject with Range): the shared parser
  // serves well-formed satisfiable slices; malformed or unsatisfiable
  // specs RELAY so the python path's 416 XML / ignore semantics apply
  // verbatim (HEAD with a Range never reaches here — the pump gate
  // relays it, since AWS honors Range on HeadObject)
  int64_t start = 0, end = (int64_t)data_size - 1;
  bool partial = false;
  if (r.range && !is_head) {
    int rc = parse_byte_range(r.range, r.range_len, (int64_t)data_size,
                              &start, &end);
    if (rc < 0) return false;
    partial = rc == 1;
  }
  int64_t body_len = end - start + 1;
  char lm[40] = "";
  struct tm tmv;
  time_t mt = (time_t)ent.mtime;
  gmtime_r(&mt, &tmv);
  strftime(lm, sizeof lm, "%a, %d %b %Y %H:%M:%S GMT", &tmv);
  char head[576];
  int hl;
  if (partial) {
    hl = snprintf(
        head, sizeof head,
        "HTTP/1.1 206 Partial Content\r\nContent-Type: %s\r\n"
        "Content-Length: %lld\r\n"
        "Content-Range: bytes %lld-%lld/%u\r\n"
        "ETag: \"%s\"\r\nLast-Modified: %s\r\nAccept-Ranges: bytes\r\n",
        ent.mime.empty() ? "application/octet-stream" : ent.mime.c_str(),
        (long long)body_len, (long long)start, (long long)end,
        data_size, ent.etag.c_str(), lm);
  } else {
    hl = snprintf(
        head, sizeof head,
        "HTTP/1.1 200 OK\r\nContent-Type: %s\r\nContent-Length: %u\r\n"
        "ETag: \"%s\"\r\nLast-Modified: %s\r\nAccept-Ranges: bytes\r\n",
        ent.mime.empty() ? "application/octet-stream" : ent.mime.c_str(),
        data_size, ent.etag.c_str(), lm);
  }
  if (hl >= (int)sizeof head) return false;
  c->out.append(head, hl);
  c->out.append(ent.meta);
  if (!r.keep_alive) c->out.append("Connection: close\r\n");
  c->out.append("\r\n");
  if (!is_head) c->out.append((const char*)data + start, body_len);
  if (!r.keep_alive) c->want_close = true;
  count_resp(partial ? 206 : 200, is_head ? 0 : body_len);
  return true;
}

// PUT fast path: local append + gated metadata insert through the
// channel. Returns 0 when the request must relay instead.
int s3_handle_put(Server* s, Conn* c, const Request& r, const char* head,
                  const std::string& bucket, const char* key,
                  size_t key_len, const uint8_t* body, int64_t body_len) {
  S3Auth a = s3_auth(c, r, head, "PUT", true, bucket, body, body_len);
  if (a == S3Auth::RELAY) return 0;
  if (a == S3Auth::REJECTED) return 1;
  // headers: content-type + x-amz-meta-* (printable ASCII only, like
  // the python gateway's US-ASCII gate — odd bytes relay for python's
  // verdict; control chars would also break the TSV channel framing)
  auto ascii_clean = [](const char* q, const char* qe) {
    for (; q < qe; q++) {
      unsigned char ch = (unsigned char)*q;
      if (ch < 0x20 || ch >= 0x7f) return false;
    }
    return true;
  };
  const char* ct = nullptr;
  size_t ct_len = 0;
  if (find_header(head, r.head_len, "content-type", &ct, &ct_len) &&
      !ascii_clean(ct, ct + ct_len))
    return 0;
  std::vector<std::pair<std::string, std::string>> meta;
  {
    const char* p = (const char*)memchr(head, '\n', r.head_len);
    const char* end = head + r.head_len;
    p = p ? p + 1 : end;
    while (p < end) {
      const char* le = (const char*)memchr(p, '\n', end - p);
      if (!le) break;
      const char* colon = (const char*)memchr(p, ':', le - p);
      if (colon && colon - p > 11 &&
          strncasecmp(p, "x-amz-meta-", 11) == 0) {
        std::string name(p + 11, colon - p - 11);
        for (auto& ch : name) {
          // control bytes (tab!) would break the TSV channel framing;
          // '=' is the pair separator
          if ((unsigned char)ch < 0x20 || (unsigned char)ch >= 0x7f ||
              ch == '=')
            return 0;
          ch = (char)tolower((unsigned char)ch);
        }
        const char* vv = colon + 1;
        const char* ve = le > p && le[-1] == '\r' ? le - 1 : le;
        while (vv < ve && (*vv == ' ' || *vv == '\t')) vv++;
        while (ve > vv && (ve[-1] == ' ' || ve[-1] == '\t')) ve--;
        if (!ascii_clean(vv, ve)) return 0;
        meta.emplace_back(name, std::string(vv, ve - vv));
      }
      p = le + 1;
    }
  }
  // pre-assigned fid slot for this bucket's collection. PEEK first:
  // popping before the volume checks would burn one slot per relayed
  // PUT on ineligible volumes (replicated/remote buckets), churning
  // the master with refill assigns for nothing. Single consumer (this
  // IO thread) — the front slot is stable between peek and pop.
  S3Slot slot;
  {
    std::lock_guard<std::mutex> lk(s3_pool_mu);
    auto it = s3_pools.find(bucket);
    if (it == s3_pools.end() || it->second.empty())
      return 0;  // pool dry: relay (the refill thread replenishes)
    slot = it->second.front();
  }
  std::shared_ptr<Vol> v = find_vol(slot.vid);
  if (!v) return 0;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    if (v->detached || v->read_only || v->has_replicas) return 0;
  }
  {
    std::lock_guard<std::mutex> lk(s3_pool_mu);
    s3_pools[bucket].pop_front();
  }
  uint32_t crc = 0;
  int st = append_plain(v, slot.key, slot.cookie, body, body_len, &crc);
  if (st == 0 || st == 409) return 0;  // python re-resolves placement
  if (st != 201) {
    n_errors++;
    s3_error(c, 500, "InternalError", "volume write failed", r.path,
             r.path_len, r.keep_alive);
    return 1;
  }
  std::string etag = md5_hex(body, (size_t)body_len);
  char fid[48];
  int fl = snprintf(fid, sizeof fid, "%u,%llx%08x", slot.vid,
                    (unsigned long long)slot.key, slot.cookie);
  // TSV channel record (cheap to build here, cheap to split there —
  // a json round trip measured ~5us/op of applier GIL time):
  //   id \t put \t bucket \t key \t fid \t size \t etag \t mime
  //   [\t k=v]...\n          (deletes: id \t del \t bucket \t key\n)
  // every field is gated printable-ASCII-no-tab above; keys passed
  // s3_canonical_path (unreserved bytes only)
  uint64_t id = s->next_op_id++;
  std::string rec;
  rec.reserve(160 + key_len);
  char nbuf[48];
  snprintf(nbuf, sizeof nbuf, "%llu\tput\t", (unsigned long long)id);
  rec += nbuf;
  rec += bucket;
  rec += '\t';
  rec.append(key, key_len);
  rec += '\t';
  rec.append(fid, fl);
  snprintf(nbuf, sizeof nbuf, "\t%lld\t", (long long)body_len);
  rec += nbuf;
  rec += etag;
  rec += '\t';
  if (ct) rec.append(ct, ct_len);
  for (auto& kv : meta) {
    rec += '\t';
    rec += kv.first;
    rec += '=';
    rec += kv.second;
  }
  rec += '\n';
  S3Op* op = new S3Op();
  op->client = c;
  op->keep_alive = r.keep_alive;
  op->etag = etag;
  op->size = body_len;
  s->s3_pending[id] = op;
  c->repl_pending = true;
  int mode = commit_mode.load(std::memory_order_relaxed);
  if (mode == 1) {
    // the metadata record ships to the applier now (page-cache
    // append done); only the 200 waits on the covering fsync
    op->fsync_pending = true;
    commit_enqueue(s, v, body_len, nullptr, id);
  } else if (mode == 2) {
    commit_sync_inline(v);
  }
  s->chan_out += rec;  // flushed once per epoll batch
  return 1;
}

// Recognize exactly "partNumber=N&uploadId=H" (either order, nothing
// else, unreserved bytes only — so the canonical-query form used for
// SigV4 is the literal sorted pair). Returns false = not a plain part
// upload: relay.
bool parse_part_query(const char* q, size_t qlen, std::string* upload_id,
                      long* part_num) {
  std::string pn, uid;
  size_t i = 0;
  while (i < qlen) {
    size_t amp = i;
    while (amp < qlen && q[amp] != '&') amp++;
    const char* eq = (const char*)memchr(q + i, '=', amp - i);
    if (!eq) return false;
    std::string k(q + i, eq - q - i);
    std::string v(eq + 1, q + amp - eq - 1);
    if (k == "partNumber" && pn.empty())
      pn = v;
    else if (k == "uploadId" && uid.empty())
      uid = v;
    else
      return false;  // extra/duplicate params: python's call
    i = amp + 1;
  }
  if (pn.empty() || pn.size() > 5 || uid.empty()) return false;
  for (char ch : pn)
    if (!isdigit((unsigned char)ch)) return false;
  for (char ch : uid)
    if (!(isalnum((unsigned char)ch) || ch == '-' || ch == '.' ||
          ch == '_' || ch == '~'))
      return false;  // would need percent-encoding in the canonical form
  long n = strtol(pn.c_str(), nullptr, 10);
  if (n < 1 || n > 10000) return false;  // python answers InvalidArgument
  *upload_id = uid;
  *part_num = n;
  return true;
}

// Multipart part-upload fast path (UploadPart is the highest-volume
// verb the S3 front still relayed): append the part bytes locally and
// gate the part-entry insert (/buckets/<b>/.uploads/<id>/NNNNN.part)
// through the channel. Returns 0 to relay — notably when the upload id
// is not in the live set, so python's NoSuchUpload XML applies.
int s3_handle_part(Server* s, Conn* c, const Request& r, const char* head,
                   const std::string& bucket, const std::string& upload_id,
                   long part_num, const uint8_t* body, int64_t body_len) {
  {
    std::shared_lock<std::shared_mutex> lk(s3_upload_mu);
    if (!s3_uploads.count(bucket + "\t" + upload_id)) return 0;
  }
  char cq[128];
  snprintf(cq, sizeof cq, "partNumber=%ld&uploadId=%s", part_num,
           upload_id.c_str());
  S3Auth a = s3_auth(c, r, head, "PUT", true, bucket, body, body_len, cq);
  if (a == S3Auth::RELAY) return 0;
  if (a == S3Auth::REJECTED) return 1;
  S3Slot slot;
  {
    std::lock_guard<std::mutex> lk(s3_pool_mu);
    auto it = s3_pools.find(bucket);
    if (it == s3_pools.end() || it->second.empty()) return 0;
    slot = it->second.front();
  }
  std::shared_ptr<Vol> v = find_vol(slot.vid);
  if (!v) return 0;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    if (v->detached || v->read_only || v->has_replicas) return 0;
  }
  {
    std::lock_guard<std::mutex> lk(s3_pool_mu);
    s3_pools[bucket].pop_front();
  }
  uint32_t crc = 0;
  int st = append_plain(v, slot.key, slot.cookie, body, body_len, &crc);
  if (st == 0 || st == 409) return 0;
  if (st != 201) {
    n_errors++;
    s3_error(c, 500, "InternalError", "volume write failed", r.path,
             r.path_len, r.keep_alive);
    return 1;
  }
  // etag of the PART bytes: CompleteMultipartUpload composes the final
  // "-N" etag from the parts' md5s, exactly like the python path's
  // fullmd5 POST
  std::string etag = md5_hex(body, (size_t)body_len);
  char fid[48];
  int fl = snprintf(fid, sizeof fid, "%u,%llx%08x", slot.vid,
                    (unsigned long long)slot.key, slot.cookie);
  // id \t part \t bucket \t upload_id \t part_number \t fid \t size
  //    \t etag\n
  uint64_t id = s->next_op_id++;
  std::string rec;
  rec.reserve(160);
  char nbuf[64];
  snprintf(nbuf, sizeof nbuf, "%llu\tpart\t", (unsigned long long)id);
  rec += nbuf;
  rec += bucket;
  rec += '\t';
  rec += upload_id;
  snprintf(nbuf, sizeof nbuf, "\t%ld\t", part_num);
  rec += nbuf;
  rec.append(fid, fl);
  snprintf(nbuf, sizeof nbuf, "\t%lld\t", (long long)body_len);
  rec += nbuf;
  rec += etag;
  rec += '\n';
  S3Op* op = new S3Op();
  op->client = c;
  op->keep_alive = r.keep_alive;
  op->kind = OP_S3_PART;
  op->etag = etag;
  op->size = body_len;
  s->s3_pending[id] = op;
  c->repl_pending = true;
  int mode = commit_mode.load(std::memory_order_relaxed);
  if (mode == 1) {
    op->fsync_pending = true;
    commit_enqueue(s, v, body_len, nullptr, id);
  } else if (mode == 2) {
    commit_sync_inline(v);
  }
  s->chan_out += rec;  // flushed once per epoll batch
  return 1;
}

// S3-role pump: the fast paths, with relay for everything else.
int s3_pump_inner(Server* s, Conn* c) {
  if (c->repl_pending) return 0;  // gated PUT in flight
  if (c->want_close) {  // close-marked response still flushing
    c->in.clear();
    c->in_off = 0;
    return 0;
  }
  while (true) {
    if (c->in_off > 0 && c->in_off == c->in.size()) {
      c->in.clear();
      c->in_off = 0;
    }
    size_t avail = c->in.size() - c->in_off;
    if (avail == 0) break;
    Request r;
    const char* head = c->in.data() + c->in_off;
    ssize_t hl = parse_head(head, avail, &r);
    if (hl < 0) return -1;
    if (hl == 0) break;
    bool is_get = ieq(r.method, r.method_len, "GET");
    bool is_head = ieq(r.method, r.method_len, "HEAD");
    bool is_put = ieq(r.method, r.method_len, "PUT");
    // bucket/key split: fast path needs a non-empty key and a
    // pre-canonical path (no percent-encoding required)
    std::string bucket;
    const char* key = nullptr;
    size_t key_len = 0;
    if (r.path_len > 1 && r.path[0] == '/' &&
        s3_canonical_path(r.path, r.path_len)) {
      const char* slash =
          (const char*)memchr(r.path + 1, '/', r.path_len - 1);
      if (slash && (size_t)(slash - r.path) + 1 < r.path_len) {
        bucket.assign(r.path + 1, slash - r.path - 1);
        key = slash + 1;
        key_len = r.path + r.path_len - key;
      }
    }
    bool bucket_known = false;
    if (!bucket.empty()) {
      std::shared_lock<std::shared_mutex> lk(s3_mu);
      bucket_known = s3_buckets.count(bucket) > 0;
    }
    // part-upload query recognized once per parse (PUT only)
    std::string upload_id;
    long part_num = 0;
    bool is_part =
        is_put && r.has_query && key_len &&
        parse_part_query(r.query, r.query_len, &upload_id, &part_num);
    // deadline/fault gate — deferred while a fast-path PUT is still
    // buffering its body so it fires exactly once per request
    // parts get a wider body gate: S3's own floor makes every
    // non-final part >= 5MB, so a 1MB cap would relay all of them
    int64_t put_max = is_part ? (16 << 20) : (1 << 20);
    bool fast_put_waiting =
        is_put && bucket_known && key_len && (!r.has_query || is_part) &&
        !r.proxy_only && !r.chunked && r.content_len > 0 &&
        r.content_len <= put_max &&
        avail - r.head_len < (size_t)r.content_len;
    if (!fast_put_waiting && gate_request(c, r, avail)) continue;
    if ((is_get || is_head) && bucket_known && !r.has_query &&
        !r.proxy_only && r.content_len == 0 && !r.chunked &&
        !(is_head && r.range)) {  // AWS honors Range on HEAD: relay
      S3Auth a = s3_auth(c, r, head, is_head ? "HEAD" : "GET", false,
                         bucket, nullptr, 0);
      if (a == S3Auth::REJECTED) {
        c->in_off += r.head_len;
        c->sent_100 = false;
        continue;
      }
      if (a == S3Auth::OK) {
        S3Ent ent;
        bool hit = false;
        {
          std::shared_lock<std::shared_mutex> lk(s3_cache_mu);
          auto it = s3_cache.find(std::string(r.path, r.path_len));
          if (it != s3_cache.end()) {
            ent = it->second;
            hit = true;
          }
        }
        if (hit && s3_serve_cached(c, r, ent, is_head)) {
          c->in_off += r.head_len;
          c->sent_100 = false;
          n_s3_get++;
          continue;
        }
      }
      // miss / unsure: relay below
    } else if (is_put && bucket_known && key_len &&
               (!r.has_query || is_part) && !r.proxy_only && !r.chunked &&
               r.content_len > 0 && r.content_len <= put_max) {
      if (r.expect_100 && !c->sent_100 &&
          avail - r.head_len < (size_t)r.content_len) {
        c->out.append("HTTP/1.1 100 Continue\r\n\r\n");
        c->sent_100 = true;
      }
      if (avail - r.head_len < (size_t)r.content_len) break;
      const uint8_t* body = (const uint8_t*)head + r.head_len;
      int took =
          is_part ? s3_handle_part(s, c, r, head, bucket, upload_id,
                                   part_num, body, r.content_len)
                  : s3_handle_put(s, c, r, head, bucket, key, key_len,
                                  body, r.content_len);
      if (took) {
        c->in_off += r.head_len + r.content_len;
        c->sent_100 = false;
        if (c->repl_pending) return 0;  // awaiting the applier's ack
        continue;
      }
      // fall through to relay
    } else if (ieq(r.method, r.method_len, "DELETE") && bucket_known &&
               key_len && !r.has_query && !r.proxy_only && !r.chunked &&
               r.content_len == 0) {
      int took = s3_handle_delete(s, c, r, head, bucket, key, key_len);
      if (took) {
        c->in_off += r.head_len;
        c->sent_100 = false;
        if (c->repl_pending) return 0;  // awaiting the applier's ack
        continue;
      }
      // fall through to relay
    }
    return proxy_handoff(s, c, r, avail);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Native filer front (role ROLE_FILER) — the filer HTTP gateway's hot
// verbs (GET/PUT/HEAD/DELETE of plain files) in C++, byte-matching the
// python handlers; everything else (listings, renames, WebDAV, tagging,
// query verbs, conditional policy) relays to the python filer app.
// Mutations ride the same TSV applier channel shape as the S3 front, so
// the zero-staleness cache contract holds across both fronts.
// ---------------------------------------------------------------------------

// Reserved route prefixes the python app handles itself (the catch-all
// file routes sit behind these in its route table).
bool filer_reserved_path(const char* p, size_t n) {
  static const char* kFirst[] = {"status", "metrics", "debug",
                                 "ws", "dlm", "kv", "healthz"};
  const char* seg = p + 1;
  const char* slash = (const char*)memchr(seg, '/', n - 1);
  size_t seg_len = slash ? (size_t)(slash - seg) : n - 1;
  for (const char* f : kFirst)
    if (seg_len == strlen(f) && memcmp(seg, f, seg_len) == 0) return true;
  return false;
}

// A path the fast paths may serve: already in norm_path() form (no
// empty or "." segments, no trailing slash) and restricted to bytes
// that need no percent-decoding, no json escaping in the 201 body, and
// no TSV escaping on the channel. Anything else relays so the python
// normalization/unicode semantics apply verbatim.
bool filer_path_ok(const char* p, size_t n) {
  if (n < 2 || p[0] != '/' || p[n - 1] == '/') return false;
  for (size_t i = 0; i < n; i++) {
    char c = p[i];
    if (!(isalnum((unsigned char)c) || c == '/' || c == '-' ||
          c == '.' || c == '_' || c == '~'))
      return false;
  }
  for (size_t i = 0; i + 1 < n; i++) {
    if (p[i] != '/') continue;
    if (p[i + 1] == '/') return false;                        // "//"
    if (p[i + 1] == '.' && (i + 2 == n || p[i + 2] == '/'))
      return false;                                           // "/./"
  }
  return !filer_reserved_path(p, n);
}

// Serve a filer GET/HEAD from the cache entry's local needle,
// byte-matching handle_get's plain-file path: ETag/If-None-Match,
// Last-Modified, Accept-Ranges, X-Seaweed-Entry and armored s3_* ext
// headers, single-range 206 (on HEAD too — the python filer honors
// Range on HEAD), and the bare 416. false = relay.
bool filer_serve_cached(Conn* c, const Request& r, const char* head,
                        const FilerEnt& ent, bool is_head) {
  std::shared_ptr<Vol> v = find_vol(ent.vid);
  if (!v) return false;
  int64_t off;
  int32_t size;
  int version;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    if (v->detached) return false;
    auto it = v->map.find(ent.key);
    if (it == v->map.end() || it->second.size <= 0) return false;
    off = it->second.offset;
    size = it->second.size;
    version = v->version;
  }
  int64_t rec_len = disk_size(size, version);
  std::string rec;
  rec.resize(rec_len);
  if (pread(v->dat_fd, &rec[0], rec_len, off) != rec_len) return false;
  const uint8_t* p = (const uint8_t*)rec.data();
  if (be64(p + 4) != ent.key || be32(p) != ent.cookie) return false;
  uint32_t data_size = be32(p + HEADER);
  if ((int64_t)data_size + 5 > size) return false;
  const uint8_t* data = p + HEADER + 4;
  uint8_t flags = data[data_size];
  if (flags & FLAG_IS_COMPRESSED) return false;  // python inflates
  uint32_t stored_crc = be32(p + HEADER + size);
  uint32_t actual = data_size ? crc32c(0, data, data_size) : 0;
  if (data_size && stored_crc != actual &&
      stored_crc != legacy_crc_value(actual))
    return false;  // corrupt: python's read path reports it properly
  const char* mime = ent.mime.empty() ? "application/octet-stream"
                                      : ent.mime.c_str();
  char lm[40] = "";
  struct tm tmv;
  time_t mt = (time_t)ent.mtime;
  gmtime_r(&mt, &tmv);
  strftime(lm, sizeof lm, "%a, %d %b %Y %H:%M:%S GMT", &tmv);
  // shared trailer: ETag .. ext block, same fields handle_get builds
  char common[256];
  int cl = snprintf(common, sizeof common,
                    "ETag: \"%s\"\r\nLast-Modified: %s\r\n"
                    "Accept-Ranges: bytes\r\nX-Seaweed-Entry: file\r\n",
                    ent.etag.c_str(), lm);
  if (cl >= (int)sizeof common) return false;
  // If-None-Match precedes the Range logic, exactly like handle_get
  const char* inm;
  size_t inm_len;
  if (find_header(head, r.head_len, "if-none-match", &inm, &inm_len) &&
      inm_len == ent.etag.size() + 2 && inm[0] == '"' &&
      inm[inm_len - 1] == '"' &&
      memcmp(inm + 1, ent.etag.data(), ent.etag.size()) == 0) {
    // no Content-Length: a 304 never carries a body (RFC 7232) and the
    // python stack (aiohttp) omits it — parity is byte-level
    c->out.append("HTTP/1.1 304 Not Modified\r\n");
    c->out.append(common, cl);
    c->out.append(ent.ext);
    if (!r.keep_alive) c->out.append("Connection: close\r\n");
    c->out.append("\r\n");
    if (!r.keep_alive) c->want_close = true;
    count_resp(304, 0);
    return true;
  }
  int64_t start = 0, end = (int64_t)data_size - 1;
  bool partial = false;
  if (r.range) {
    int rc = parse_byte_range(r.range, r.range_len, (int64_t)data_size,
                              &start, &end);
    if (rc == -2) {
      // handle_get's bare 416: only Content-Range advertised (the
      // python stack omits Content-Length on HEAD — parity is
      // byte-level)
      char h416[160];
      int hn = snprintf(h416, sizeof h416,
                        "HTTP/1.1 416 Range Not Satisfiable\r\n"
                        "%s"
                        "Content-Range: bytes */%u\r\n%s\r\n",
                        is_head ? "" : "Content-Length: 0\r\n",
                        data_size,
                        r.keep_alive ? "" : "Connection: close\r\n");
      c->out.append(h416, hn);
      if (!r.keep_alive) c->want_close = true;
      count_resp(416, 0);
      return true;
    }
    if (rc < 0) return false;  // malformed/multi-range: python decides
    partial = rc == 1;
  }
  int64_t body_len = end - start + 1;
  // HEAD advertises the would-be body length (range-aware, like the
  // python handler) and sends no body
  char h[640];
  int hl = snprintf(h, sizeof h,
                    "HTTP/1.1 %s\r\nContent-Type: %s\r\n"
                    "Content-Length: %lld\r\n",
                    partial ? "206 Partial Content" : "200 OK", mime,
                    (long long)body_len);
  if (hl >= (int)sizeof h) return false;
  c->out.append(h, hl);
  if (partial) {
    char crng[96];
    int cn = snprintf(crng, sizeof crng,
                      "Content-Range: bytes %lld-%lld/%u\r\n",
                      (long long)start, (long long)end, data_size);
    c->out.append(crng, cn);
  }
  c->out.append(common, cl);
  c->out.append(ent.ext);
  if (!r.keep_alive) c->out.append("Connection: close\r\n");
  c->out.append("\r\n");
  if (!is_head) c->out.append((const char*)data + start, body_len);
  if (!r.keep_alive) c->want_close = true;
  count_resp(partial ? 206 : 200, is_head ? 0 : body_len);
  return true;
}

// Filer PUT/POST fast path: local append + gated entry insert through
// the channel (the applier runs Filer.create_entry with the server's
// default collection/replication — the writes gate guarantees no
// filer.conf rule would have said otherwise). Returns 0 to relay.
int filer_handle_put(Server* s, Conn* c, const Request& r,
                     const char* head, const uint8_t* body,
                     int64_t body_len) {
  auto ascii_clean = [](const char* q, const char* qe) {
    for (; q < qe; q++) {
      unsigned char ch = (unsigned char)*q;
      if (ch < 0x20 || ch >= 0x7f) return false;
    }
    return true;
  };
  // headers that change python's write semantics relay: Content-MD5
  // (pre-validated + whole-stream md5), x-seaweed-ext-* (extended
  // attrs), multipart/form-data (form decode)
  const char* ct = nullptr;
  size_t ct_len = 0;
  if (find_header(head, r.head_len, "content-type", &ct, &ct_len)) {
    if (!ascii_clean(ct, ct + ct_len)) return 0;
    if (ct_len >= 19 && strncasecmp(ct, "multipart/form-data", 19) == 0)
      return 0;
  }
  {
    const char* q;
    size_t ql;
    if (find_header(head, r.head_len, "content-md5", &q, &ql)) return 0;
    const char* hp = (const char*)memchr(head, '\n', r.head_len);
    const char* end = head + r.head_len;
    hp = hp ? hp + 1 : end;
    while (hp < end) {
      const char* le = (const char*)memchr(hp, '\n', end - hp);
      if (!le) break;
      const char* colon = (const char*)memchr(hp, ':', le - hp);
      if (colon && colon - hp > 14 &&
          strncasecmp(hp, "x-seaweed-ext-", 14) == 0)
        return 0;
      hp = le + 1;
    }
  }
  S3Slot slot;
  {
    std::lock_guard<std::mutex> lk(filer_pool_mu);
    if (filer_pool.empty()) return 0;  // dry: relay, refill replenishes
    slot = filer_pool.front();
  }
  std::shared_ptr<Vol> v = find_vol(slot.vid);
  if (!v) return 0;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    if (v->detached || v->read_only || v->has_replicas) return 0;
  }
  {
    std::lock_guard<std::mutex> lk(filer_pool_mu);
    filer_pool.pop_front();
  }
  uint32_t crc = 0;
  int st = append_plain(v, slot.key, slot.cookie, body, body_len, &crc);
  if (st == 0 || st == 409) return 0;  // python re-resolves placement
  if (st != 201) {
    n_errors++;
    simple_response(c, 500, "volume write failed", r.keep_alive);
    return 1;
  }
  // the chunk md5 IS the file md5 for a single-chunk entry, so this is
  // both the 201 body's etag and the entry's md5 (handle_put parity)
  std::string etag = md5_hex(body, (size_t)body_len);
  char fid[48];
  int fl = snprintf(fid, sizeof fid, "%u,%llx%08x", slot.vid,
                    (unsigned long long)slot.key, slot.cookie);
  // id \t put \t path \t fid \t size \t etag \t mime\n
  // (deletes: id \t del \t path\n) — path passed filer_path_ok
  // (unreserved bytes), mime gated printable-ASCII above
  uint64_t id = s->next_op_id++;
  std::string rec;
  rec.reserve(160 + r.path_len);
  char nbuf[48];
  snprintf(nbuf, sizeof nbuf, "%llu\tput\t", (unsigned long long)id);
  rec += nbuf;
  rec.append(r.path, r.path_len);
  rec += '\t';
  rec.append(fid, fl);
  snprintf(nbuf, sizeof nbuf, "\t%lld\t", (long long)body_len);
  rec += nbuf;
  rec += etag;
  rec += '\t';
  if (ct) rec.append(ct, ct_len);
  rec += '\n';
  const char* base = (const char*)memrchr(r.path, '/', r.path_len);
  S3Op* op = new S3Op();
  op->client = c;
  op->keep_alive = r.keep_alive;
  op->kind = OP_FILER_PUT;
  op->etag = etag;
  op->size = body_len;
  op->name.assign(base + 1, r.path + r.path_len - base - 1);
  s->s3_pending[id] = op;
  c->repl_pending = true;
  int mode = commit_mode.load(std::memory_order_relaxed);
  if (mode == 1) {
    op->fsync_pending = true;
    commit_enqueue(s, v, body_len, nullptr, id);
  } else if (mode == 2) {
    commit_sync_inline(v);
  }
  s->chan_out += rec;  // flushed once per epoll batch
  return 1;
}

// Filer DELETE fast path — only for paths the cache proves are plain
// files (directories keep python's recursive/conflict semantics). The
// metadata delete rides the channel so chunk reclamation and the
// invalidating meta event happen exactly as in the python path.
int filer_handle_delete(Server* s, Conn* c, const Request& r) {
  uint64_t id = s->next_op_id++;
  std::string rec;
  rec.reserve(32 + r.path_len);
  char nbuf[48];
  snprintf(nbuf, sizeof nbuf, "%llu\tdel\t", (unsigned long long)id);
  rec += nbuf;
  rec.append(r.path, r.path_len);
  rec += '\n';
  S3Op* op = new S3Op();
  op->client = c;
  op->keep_alive = r.keep_alive;
  op->is_delete = true;
  op->kind = OP_FILER_DEL;
  s->s3_pending[id] = op;
  c->repl_pending = true;
  s->chan_out += rec;
  return 1;
}

// Filer-role pump: hot plain-file verbs, relay for everything else.
int filer_pump_inner(Server* s, Conn* c) {
  if (c->repl_pending) return 0;  // gated mutation in flight
  if (c->want_close) {
    c->in.clear();
    c->in_off = 0;
    return 0;
  }
  while (true) {
    if (c->in_off > 0 && c->in_off == c->in.size()) {
      c->in.clear();
      c->in_off = 0;
    }
    size_t avail = c->in.size() - c->in_off;
    if (avail == 0) break;
    Request r;
    const char* head = c->in.data() + c->in_off;
    ssize_t hl = parse_head(head, avail, &r);
    if (hl < 0) return -1;
    if (hl == 0) break;
    bool is_get = ieq(r.method, r.method_len, "GET");
    bool is_head = ieq(r.method, r.method_len, "HEAD");
    // the python filer routes POST and PUT to the same handler
    bool is_put = ieq(r.method, r.method_len, "PUT") ||
                  ieq(r.method, r.method_len, "POST");
    bool path_ok = filer_path_ok(r.path, r.path_len);
    bool writes_on = filer_writes_on.load(std::memory_order_relaxed);
    // deadline/fault gate — deferred while a fast-path PUT body is
    // still buffering so it fires exactly once per request
    bool fast_put_waiting =
        is_put && writes_on && path_ok && !r.has_query && !r.proxy_only &&
        !r.chunked && r.content_len > 0 && r.content_len <= (1 << 20) &&
        avail - r.head_len < (size_t)r.content_len;
    if (!fast_put_waiting && gate_request(c, r, avail)) continue;
    if ((is_get || is_head) && path_ok && !r.has_query && !r.proxy_only &&
        r.content_len == 0 && !r.chunked) {
      FilerEnt ent;
      bool hit = false;
      {
        std::shared_lock<std::shared_mutex> lk(filer_cache_mu);
        auto it = filer_cache.find(std::string(r.path, r.path_len));
        if (it != filer_cache.end()) {
          ent = it->second;
          hit = true;
        }
      }
      if (hit && filer_serve_cached(c, r, head, ent, is_head)) {
        c->in_off += r.head_len;
        c->sent_100 = false;
        n_filer_get++;
        continue;
      }
      // miss (maybe a 404, a directory, an inline/multi-chunk entry):
      // relay below — the cache is positive-plain-files-only
    } else if (is_put && writes_on && path_ok && !r.has_query &&
               !r.proxy_only && !r.chunked && r.content_len > 0 &&
               r.content_len <= (1 << 20)) {
      if (r.expect_100 && !c->sent_100 &&
          avail - r.head_len < (size_t)r.content_len) {
        c->out.append("HTTP/1.1 100 Continue\r\n\r\n");
        c->sent_100 = true;
      }
      if (avail - r.head_len < (size_t)r.content_len) break;
      const uint8_t* body = (const uint8_t*)head + r.head_len;
      int took = filer_handle_put(s, c, r, head, body, r.content_len);
      if (took) {
        c->in_off += r.head_len + r.content_len;
        c->sent_100 = false;
        if (c->repl_pending) return 0;  // awaiting the applier's ack
        continue;
      }
      // fall through to relay
    } else if (ieq(r.method, r.method_len, "DELETE") && path_ok &&
               !r.has_query && !r.proxy_only && !r.chunked &&
               r.content_len == 0) {
      bool hit = false;
      {
        std::shared_lock<std::shared_mutex> lk(filer_cache_mu);
        hit = filer_cache.count(std::string(r.path, r.path_len)) > 0;
      }
      if (hit && filer_handle_delete(s, c, r)) {
        c->in_off += r.head_len;
        c->sent_100 = false;
        if (c->repl_pending) return 0;
        continue;
      }
      // unknown path: relay (python's 404/recursive semantics)
    }
    return proxy_handoff(s, c, r, avail);
  }
  return 0;
}

void io_loop(Server* s) {
  t_role = s->role;
  struct epoll_event evs[128];
  while (!s->stop.load()) {
    int n = epoll_wait(s->epoll_fd, evs, 128, 1000);
    peer_sweep(s);  // hung-replicate watchdog, 1Hz
    for (int i = 0; i < n; i++) {
      if (evs[i].data.ptr == nullptr) {  // listen fd
        while (true) {
          int fd = accept4(s->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (fd < 0) break;
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          Conn* c = new Conn();
          c->fd = fd;
          c->last_active = time(nullptr);
          s->conns[fd] = c;
          arm(s, c, EPOLLIN);
        }
        continue;
      }
      if (evs[i].data.ptr == (void*)s) {  // eventfd: returned conns
        uint64_t junk;
        (void)!read(s->event_fd, &junk, 8);
        std::deque<Conn*> back;
        std::deque<CommitWaiter> cdone;
        {
          std::lock_guard<std::mutex> lk(s->ret_mu);
          back.swap(s->returned);
          cdone.swap(s->commit_done);
        }
        // fsync completions first: they release gated acks, and the
        // resumed pumps below may queue replicates for this batch's
        // flush_dirty_peers pass
        for (auto& w : cdone) commit_complete(s, w);
        for (Conn* c : back) {
          s->conns[c->fd] = c;
          set_nonblock(c->fd, true);
          int st = pump(s, c);
          if (st == -1)
            close_conn(s, c);
          else if (st == 0)
            flush_out(s, c);
          // st == 1: handed off again
        }
        continue;
      }
      if (*(int*)evs[i].data.ptr == KIND_PEER) {  // replica peer conn
        peer_event(s, (PeerConn*)evs[i].data.ptr, evs[i].events);
        continue;
      }
      if (*(int*)evs[i].data.ptr == KIND_CHAN) {  // S3 entry channel
        if (evs[i].events & EPOLLOUT) chan_flush(s);
        if (evs[i].events & (EPOLLIN | EPOLLHUP | EPOLLERR)) chan_read(s);
        continue;
      }
      Conn* c = (Conn*)evs[i].data.ptr;
      c->last_active = time(nullptr);
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        close_conn(s, c);
        continue;
      }
      if (evs[i].events & EPOLLOUT) {
        if (!flush_out(s, c)) continue;  // conn freed
      }
      if (evs[i].events & EPOLLIN) {
        char buf[64 << 10];
        bool closed = false;
        while (true) {
          ssize_t got = recv(c->fd, buf, sizeof buf, 0);
          if (got > 0) {
            c->in.append(buf, got);
            if (c->in.size() - c->in_off > (size_t)(280 << 20)) {
              closed = true;  // runaway request
              break;
            }
            continue;
          }
          if (got == 0) closed = true;
          break;  // EAGAIN or EOF
        }
        int st = pump(s, c);
        if (st == 1) continue;  // handed to proxy worker
        if (st == -1 || (closed && c->out.size() == c->out_off)) {
          close_conn(s, c);
          continue;
        }
        flush_out(s, c);
      }
    }
    flush_dirty_peers(s);  // one writev per peer for this whole batch
    if (s->chan_fd >= 0 && !s->chan_out.empty())
      chan_flush(s);  // ship the batch's entry records in one write
  }
}

void worker_loop(Server* s) {
  t_role = s->role;
  while (true) {
    Conn* c;
    {
      std::unique_lock<std::mutex> lk(s->q_mu);
      s->q_cv.wait(lk, [&] { return s->stop.load() || !s->proxy_q.empty(); });
      if (s->stop.load() && s->proxy_q.empty()) return;
      c = s->proxy_q.front();
      s->proxy_q.pop_front();
    }
    set_nonblock(c->fd, false);
    // pure relay to the python backend (replicated-volume writes are
    // the IO thread's async fan-out now). The head is re-parsed here:
    // Request views must point into this thread's view of the buffer.
    Request r;
    ssize_t hl =
        parse_head(c->in.data() + c->in_off, c->in.size() - c->in_off, &r);
    bool ok = hl > 0 && proxy_one(s, c, r);
    if (!ok) {
      if (c->backend_fd >= 0) close(c->backend_fd);
      close(c->fd);
      delete c;
      continue;
    }
    c->sent_100 = false;
    {
      std::lock_guard<std::mutex> lk(s->ret_mu);
      s->returned.push_back(c);
    }
    uint64_t one = 1;
    (void)!write(s->event_fd, &one, 8);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

// Start a front server (volume or S3 role). Returns 0, or -errno.
// `actual_port` reports the bound port (differs from listen_port when
// that was 0). `listen_ip` honors the operator's bind address (-ip)
// exactly like the Python listener; NULL/"" = all interfaces.
// `chan_fd` (S3 role): the C++ end of the entry-channel socketpair.
static int start_server(Server** slot, int role, uint16_t listen_port,
                        uint16_t backend_port, int n_proxy_workers,
                        uint16_t* actual_port, const char* listen_ip,
                        int chan_fd) {
  if (*slot) return -EALREADY;
  int lfd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (lfd < 0) return -errno;
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in a = {};
  a.sin_family = AF_INET;
  a.sin_port = htons(listen_port);
  a.sin_addr.s_addr = htonl(INADDR_ANY);
  if (listen_ip && *listen_ip &&
      inet_pton(AF_INET, listen_ip, &a.sin_addr) != 1) {
    close(lfd);
    return -EINVAL;
  }
  if (bind(lfd, (struct sockaddr*)&a, sizeof a) != 0 || listen(lfd, 1024) != 0) {
    int e = errno;
    close(lfd);
    return -e;
  }
  if (actual_port) {
    struct sockaddr_in bound = {};
    socklen_t blen = sizeof bound;
    getsockname(lfd, (struct sockaddr*)&bound, &blen);
    *actual_port = ntohs(bound.sin_port);
  }
  Server* s = new Server();
  s->role = role;
  s->backend_port = backend_port;
  s->listen_fd = lfd;
  s->epoll_fd = epoll_create1(0);
  s->event_fd = eventfd(0, EFD_NONBLOCK);
  struct epoll_event ev = {};
  ev.events = EPOLLIN;
  ev.data.ptr = nullptr;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, lfd, &ev);
  struct epoll_event ev2 = {};
  ev2.events = EPOLLIN;
  ev2.data.ptr = (void*)s;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->event_fd, &ev2);
  if (chan_fd >= 0) {
    s->chan_fd = chan_fd;
    set_nonblock(chan_fd, true);
    struct epoll_event ev3 = {};
    ev3.events = EPOLLIN;
    ev3.data.ptr = &s->chan_tag;
    epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, chan_fd, &ev3);
    s->chan_in_epoll = true;
  }
  *slot = s;
  n_active_servers++;
  s->io_thread = std::thread(io_loop, s);
  if (n_proxy_workers < 1) n_proxy_workers = 2;
  for (int i = 0; i < n_proxy_workers; i++)
    s->workers.emplace_back(worker_loop, s);
  return 0;
}

static void stop_server(Server** slot) {
  Server* s = *slot;
  if (!s) return;
  s->stop.store(true);
  s->q_cv.notify_all();
  uint64_t one = 1;
  (void)!write(s->event_fd, &one, 8);
  s->io_thread.join();
  for (auto& w : s->workers) w.join();
  // pull this server's queued commit waiters back (and wait out any
  // in-flight fsync delivery) BEFORE freeing conns/ops: parked in
  // s->commit_done, their ops join the sweeps below
  commit_drain_server(s);
  for (auto& [fd, c] : s->conns) {
    if (c->backend_fd >= 0) close(c->backend_fd);
    close(fd);
    if (c->repl_pending) {
      // an in-flight gated op still references this conn: freed via
      // its op in the sweeps below, not here (double-free otherwise)
      c->zombie = true;
      continue;
    }
    delete c;
  }
  for (Conn* c : s->returned) {
    if (c->backend_fd >= 0) close(c->backend_fd);
    close(c->fd);
    delete c;
  }
  // in-flight fan-out state: free wires once, ops once, and the client
  // conns the ops still reference (marked zombie above / by disconnect)
  {
    std::unordered_set<ReplOp*> ops;
    for (auto& [hp, pc] : s->peer_conns) {
      for (ReplWire* w : pc->sendq) {
        ops.insert(w->op);
        delete w;
      }
      for (ReplWire* w : pc->await) {
        ops.insert(w->op);
        delete w;
      }
      if (pc->fd >= 0) close(pc->fd);
      delete pc;
    }
    // undelivered fsync tokens reference ops too (a plain gated post
    // has no wires at all — this is its only reference)
    for (auto& w : s->commit_done)
      if (w.rop) ops.insert(w.rop);
    for (ReplOp* op : ops) {
      if (op->client && op->client->zombie) delete op->client;
      delete op;
    }
  }
  for (auto& [id, op] : s->s3_pending) {
    if (op->client && op->client->zombie) delete op->client;
    delete op;
  }
  if (s->chan_fd >= 0) close(s->chan_fd);
  close(s->listen_fd);
  close(s->epoll_fd);
  close(s->event_fd);
  delete s;
  *slot = nullptr;
  if (--n_active_servers == 0) commit_shutdown();
}

int dp_start(uint16_t listen_port, uint16_t backend_port, int n_proxy_workers,
             uint16_t* actual_port, const char* listen_ip) {
  return start_server(&g_srv, ROLE_VOLUME, listen_port, backend_port,
                      n_proxy_workers, actual_port, listen_ip, -1);
}

void dp_stop(void) {
  if (!g_srv) return;
  stop_server(&g_srv);
  std::unique_lock<std::shared_mutex> lk(vols_mu);
  vols.clear();
}

// jwt_req + the HS256 secret the master signs fid tokens with
// (security/guard.go:41; the front verifies write tokens in-process).
void dp_config(int jwt_req, const char* secret) {
  {
    std::unique_lock<std::shared_mutex> lk(jwt_mu);
    jwt_secret = secret ? secret : "";
  }
  jwt_required.store(jwt_req != 0 && secret && *secret);
}

// Group-commit ack contract for every front in this process
// (-commit.durability / -commit.maxDelay / -commit.maxBytes):
// mode 0=buffered, 1=batch, 2=sync. Set at spawn, before traffic.
int dp_set_commit(int mode, double max_delay_s, long long max_bytes) {
  if (mode < 0 || mode > 2) return -EINVAL;
  commit_mode.store(mode);
  if (max_delay_s > 0)
    commit_max_delay_ns.store((int64_t)(max_delay_s * 1e9));
  if (max_bytes > 0) commit_max_bytes_cfg.store((int64_t)max_bytes);
  return 0;
}

// out[6]: batches, fsyncs (syscalls), writes (committed), bytes,
// fsync-ns total, current queue depth. Monotonic except the depth.
void dp_commit_stats(int64_t* out) {
  out[0] = n_commit_batches.load();
  out[1] = n_commit_fsyncs.load();
  out[2] = n_commit_writes.load();
  out[3] = n_commit_bytes.load();
  out[4] = n_commit_fsync_ns.load();
  std::lock_guard<std::mutex> lk(commit_mu);
  out[5] = (int64_t)commit_q.size();
}

// Fault-injection knobs (the native front's share of a -fault.spec):
// error probability and fixed delay per op class (read = GET/HEAD,
// write = POST/PUT/DELETE), plus the RNG seed for deterministic chaos
// runs. Meant to be set once at spawn, before traffic; all zeros turn
// the gate off. dp_faults keeps the historical contract (volume role);
// dp_role_faults addresses any role so each native front gets its own
// -fault.spec gate (faults.native_params("volume"/"s3"/"filer")).
void dp_faults(double read_err, double write_err, double read_delay,
               double write_delay, uint64_t seed) {
  set_role_faults(ROLE_VOLUME, read_err, write_err, read_delay,
                  write_delay, seed);
}

void dp_role_faults(int role, double read_err, double write_err,
                    double read_delay, double write_delay, uint64_t seed) {
  if (role < 0 || role >= N_ROLES) return;
  set_role_faults(role, read_err, write_err, read_delay, write_delay, seed);
}

// -- native S3 front ---------------------------------------------------------

int dp_s3_start(uint16_t listen_port, uint16_t backend_port,
                int n_proxy_workers, uint16_t* actual_port,
                const char* listen_ip, int chan_fd) {
  return start_server(&g_s3srv, ROLE_S3, listen_port, backend_port,
                      n_proxy_workers, actual_port, listen_ip, chan_fd);
}

void dp_s3_stop(void) {
  stop_server(&g_s3srv);
  std::unique_lock<std::shared_mutex> lk(s3_mu);
  s3_idents.clear();
  s3_open_mode = true;
  s3_buckets.clear();
  s3_keycache.clear();
  {
    std::lock_guard<std::mutex> plk(s3_pool_mu);
    s3_pools.clear();
  }
  std::unique_lock<std::shared_mutex> clk(s3_cache_mu);
  s3_cache.clear();
}

// Identities as TSV lines: AK \t SECRET \t FLAGS \t wr_csv \t rd_csv
// FLAGS: 'A' admin, 'W' global write, 'R' global read (combined).
// Empty input = open mode (no identities).
void dp_s3_set_identities(const char* tsv) {
  std::unordered_map<std::string, S3Ident> idents;
  const char* p = tsv ? tsv : "";
  while (*p) {
    const char* nl = strchr(p, '\n');
    if (!nl) nl = p + strlen(p);
    std::vector<std::string> cols;
    const char* f = p;
    while (f < nl) {
      const char* tab = (const char*)memchr(f, '\t', nl - f);
      if (!tab) tab = nl;
      cols.emplace_back(f, tab - f);
      f = tab + 1;
    }
    if (cols.size() >= 3 && !cols[0].empty()) {
      S3Ident id;
      id.secret = cols[1];
      for (char ch : cols[2]) {
        if (ch == 'A') id.admin = true;
        if (ch == 'W') id.write_all = true;
        if (ch == 'R') id.read_all = true;
      }
      for (int ci = 3; ci < 5 && ci < (int)cols.size(); ci++) {
        auto& dst = ci == 3 ? id.wr : id.rd;
        size_t i = 0;
        const std::string& csv = cols[ci];
        while (i < csv.size()) {
          size_t j = csv.find(',', i);
          if (j == std::string::npos) j = csv.size();
          if (j > i) dst.insert(csv.substr(i, j - i));
          i = j + 1;
        }
      }
      idents[cols[0]] = std::move(id);
    }
    p = *nl ? nl + 1 : nl;
  }
  std::unique_lock<std::shared_mutex> lk(s3_mu);
  s3_open_mode = idents.empty();
  s3_idents.swap(idents);
  s3_keycache.clear();  // secrets may have rotated
}

// Known in-flight multipart uploads, maintained incrementally from the
// filer meta events for the .uploads marker directories: present=1 on
// initiate, 0 on complete/abort. Only marked uploads take the native
// part-upload path; unknown ids relay so python's NoSuchUpload XML is
// byte-identical.
void dp_s3_upload_mark(const char* bucket, const char* upload_id,
                       int present) {
  std::string k = std::string(bucket) + "\t" + upload_id;
  std::unique_lock<std::shared_mutex> lk(s3_upload_mu);
  if (present)
    s3_uploads.insert(std::move(k));
  else
    s3_uploads.erase(k);
}

void dp_s3_set_buckets(const char* csv) {
  std::unordered_set<std::string> buckets;
  const char* p = csv ? csv : "";
  while (*p) {
    const char* comma = strchr(p, ',');
    if (!comma) comma = p + strlen(p);
    if (comma > p) buckets.emplace(p, comma - p);
    p = *comma ? comma + 1 : comma;
  }
  std::unique_lock<std::shared_mutex> lk(s3_mu);
  s3_buckets.swap(buckets);
}

// Pre-assigned fid slots: base fid "vid,keyhexcookie" + count expands
// to (key+0..count-1), exactly the master's ?count=N slot contract.
int dp_s3_push_fids(const char* bucket, const char* fid, int count) {
  std::string path = std::string("/") + fid;
  uint32_t vid, cookie;
  uint64_t key;
  if (!parse_fid_path(path.c_str(), path.size(), &vid, &key, &cookie))
    return -EINVAL;
  std::lock_guard<std::mutex> lk(s3_pool_mu);
  auto& pool = s3_pools[bucket];
  for (int i = 0; i < count; i++)
    pool.push_back({vid, key + (uint64_t)i, cookie});
  return 0;
}

int dp_s3_pool_level(const char* bucket) {
  std::lock_guard<std::mutex> lk(s3_pool_mu);
  auto it = s3_pools.find(bucket);
  return it == s3_pools.end() ? 0 : (int)it->second.size();
}

// Cache maintenance — called ONLY from the filer's serialized meta
// event stream (under its mutation lock), so ordering matches the
// store. `meta_block` is a response-ready "x-amz-meta-k: v\r\n" blob.
int dp_s3_cache_put(const char* path, const char* fid, int64_t size,
                    const char* etag, const char* mime,
                    const char* meta_block, int64_t mtime) {
  std::string fp = std::string("/") + fid;
  S3Ent ent;
  if (!parse_fid_path(fp.c_str(), fp.size(), &ent.vid, &ent.key,
                      &ent.cookie))
    return -EINVAL;
  ent.size = size;
  ent.mtime = mtime;
  ent.etag = etag ? etag : "";
  ent.mime = mime ? mime : "";
  ent.meta = meta_block ? meta_block : "";
  std::unique_lock<std::shared_mutex> lk(s3_cache_mu);
  if (s3_cache.size() >= S3_CACHE_CAP) s3_cache.clear();
  s3_cache[path] = std::move(ent);
  return 0;
}

void dp_s3_invalidate(const char* path, int is_prefix) {
  std::unique_lock<std::shared_mutex> lk(s3_cache_mu);
  if (!is_prefix) {
    s3_cache.erase(path);
    return;
  }
  size_t plen = strlen(path);
  for (auto it = s3_cache.begin(); it != s3_cache.end();) {
    if (it->first.compare(0, plen, path) == 0)
      it = s3_cache.erase(it);
    else
      ++it;
  }
}

void dp_s3_stats(int64_t* out) {
  out[0] = n_s3_put.load();
  out[1] = n_s3_get.load();
  out[2] = n_s3_reject.load();
  out[3] = n_s3_chan_fail.load();
  out[4] = n_s3_del.load();
  out[5] = n_s3_part.load();
}

// -- native filer front ------------------------------------------------------

int dp_filer_start(uint16_t listen_port, uint16_t backend_port,
                   int n_proxy_workers, uint16_t* actual_port,
                   const char* listen_ip, int chan_fd) {
  return start_server(&g_filersrv, ROLE_FILER, listen_port, backend_port,
                      n_proxy_workers, actual_port, listen_ip, chan_fd);
}

void dp_filer_stop(void) {
  stop_server(&g_filersrv);
  filer_writes_on.store(false);
  {
    std::lock_guard<std::mutex> lk(filer_pool_mu);
    filer_pool.clear();
  }
  {
    std::unique_lock<std::shared_mutex> ulk(s3_upload_mu);
    s3_uploads.clear();  // populated via the same filer meta stream
  }
  std::unique_lock<std::shared_mutex> clk(filer_cache_mu);
  filer_cache.clear();
}

// Entry cache maintenance — like dp_s3_cache_put, called ONLY from the
// filer's serialized meta event stream so ordering matches the store.
// `ext_block` is a response-ready "x-seaweed-ext-k: v\r\n" blob.
int dp_filer_cache_put(const char* path, const char* fid, int64_t size,
                       const char* etag, const char* mime,
                       const char* ext_block, int64_t mtime) {
  std::string fp = std::string("/") + fid;
  FilerEnt ent;
  if (!parse_fid_path(fp.c_str(), fp.size(), &ent.vid, &ent.key,
                      &ent.cookie))
    return -EINVAL;
  ent.size = size;
  ent.mtime = mtime;
  ent.etag = etag ? etag : "";
  ent.mime = mime ? mime : "";
  ent.ext = ext_block ? ext_block : "";
  std::unique_lock<std::shared_mutex> lk(filer_cache_mu);
  if (filer_cache.size() >= FILER_CACHE_CAP) filer_cache.clear();
  filer_cache[path] = std::move(ent);
  return 0;
}

void dp_filer_invalidate(const char* path, int is_prefix) {
  std::unique_lock<std::shared_mutex> lk(filer_cache_mu);
  if (!is_prefix) {
    filer_cache.erase(path);
    return;
  }
  size_t plen = strlen(path);
  for (auto it = filer_cache.begin(); it != filer_cache.end();) {
    if (it->first.compare(0, plen, path) == 0)
      it = filer_cache.erase(it);
    else
      ++it;
  }
}

int dp_filer_push_fids(const char* fid, int count) {
  std::string path = std::string("/") + fid;
  uint32_t vid, cookie;
  uint64_t key;
  if (!parse_fid_path(path.c_str(), path.size(), &vid, &key, &cookie))
    return -EINVAL;
  std::lock_guard<std::mutex> lk(filer_pool_mu);
  for (int i = 0; i < count; i++)
    filer_pool.push_back({vid, key + (uint64_t)i, cookie});
  return 0;
}

int dp_filer_pool_level(void) {
  std::lock_guard<std::mutex> lk(filer_pool_mu);
  return (int)filer_pool.size();
}

// The write fast path is only sound while the filer would apply its
// defaults verbatim (no filer.conf path rules, no cipher, no
// save-inside-filer inlining); the glue re-checks each refill tick and
// flips this gate.
void dp_filer_set_writes(int on) {
  filer_writes_on.store(on != 0);
}

void dp_filer_stats(int64_t* out) {
  out[0] = n_filer_put.load();
  out[1] = n_filer_get.load();
  out[2] = n_filer_del.load();
  out[3] = n_filer_chan_fail.load();
}

// test hook: md5 hex of a buffer (validates the in-tree MD5)
void dp_md5_hex(const uint8_t* buf, int64_t n, char* out33) {
  std::string h = md5_hex(buf, (size_t)n);
  memcpy(out33, h.data(), 32);
  out33[32] = 0;
}

// Replica peer list for a volume: comma-separated "host:port" entries
// excluding this server, resolved by the python control plane from
// master lookups. Clears the stale flag — the list is authoritative as
// of this push.
int dp_set_peers(uint32_t vid, const char* peers_csv) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return -ENOENT;
  std::vector<std::string> peers;
  if (peers_csv) {
    const char* p = peers_csv;
    while (*p) {
      const char* comma = strchr(p, ',');
      size_t n = comma ? (size_t)(comma - p) : strlen(p);
      if (n) peers.emplace_back(p, n);
      if (!comma) break;
      p = comma + 1;
    }
  }
  std::lock_guard<std::mutex> lk(v->mu);
  v->peers = std::move(peers);
  v->peers_stale = false;
  return 0;
}

// 1 = fan-out hit a dead/failed peer since the last dp_set_peers push
// (writes are relaying to python until a fresh list arrives).
int dp_peers_stale(uint32_t vid) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return -ENOENT;
  std::lock_guard<std::mutex> lk(v->mu);
  return v->peers_stale ? 1 : 0;
}

// Attach a volume: open files, replay the index arrays (byte offsets,
// signed sizes, in .idx file order — load_needle_map semantics).
int dp_attach(uint32_t vid, const char* dat_path, const char* idx_path,
              int version, int offset_size, int read_only, int has_replicas,
              int64_t tail, uint64_t last_append_ns, const uint64_t* keys,
              const int64_t* byte_offsets, const int32_t* sizes, int64_t n) {
  auto v = std::make_shared<Vol>();
  v->dat_fd = open(dat_path, O_RDWR);
  if (v->dat_fd < 0) return -errno;
  v->idx_fd = open(idx_path, O_RDWR);
  if (v->idx_fd < 0) return -errno;
  struct stat st;
  fstat(v->idx_fd, &st);
  v->idx_tail = st.st_size;
  v->version = version;
  v->offset_size = offset_size;
  v->read_only = read_only != 0;
  v->has_replicas = has_replicas != 0;
  v->tail = tail;
  v->last_append_ns = last_append_ns;
  v->map.reserve((size_t)n * 2);
  for (int64_t i = 0; i < n; i++) {
    if (byte_offsets[i] > 0 && sizes[i] > 0)
      v->put(keys[i], byte_offsets[i], sizes[i]);
    else
      v->del(keys[i]);
  }
  std::unique_lock<std::shared_mutex> lk(vols_mu);
  if (vols.count(vid)) return -EEXIST;
  vols[vid] = std::move(v);
  return 0;
}

int dp_detach(uint32_t vid, int64_t* out_tail, uint64_t* out_last_ns) {
  std::unique_lock<std::shared_mutex> lk(vols_mu);
  auto it = vols.find(vid);
  if (it == vols.end()) return -ENOENT;
  {
    // taking mu drains in-flight ops; the detached flag turns away any
    // op that resolved the Vol before the erase but locks after it
    std::lock_guard<std::mutex> vk(it->second->mu);
    it->second->detached = true;
    if (out_tail) *out_tail = it->second->tail;
    if (out_last_ns) *out_last_ns = it->second->last_append_ns;
  }
  vols.erase(it);
  return 0;
}

int dp_set_readonly(uint32_t vid, int ro) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return -ENOENT;
  std::lock_guard<std::mutex> lk(v->mu);
  v->read_only = ro != 0;
  return 0;
}

int dp_set_replicas(uint32_t vid, int has) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return -ENOENT;
  std::lock_guard<std::mutex> lk(v->mu);
  v->has_replicas = has != 0;
  return 0;
}

// Append a pre-built record (Python Volume.append_needle delegated path).
// Returns the byte offset of the record, or -errno.
int64_t dp_append(uint32_t vid, const uint8_t* rec, int64_t len, uint64_t key,
                  int32_t size, uint64_t append_ns) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return -ENOENT;
  std::lock_guard<std::mutex> lk(v->mu);
  if (v->detached) return -ENOENT;
  if (v->read_only) return -EROFS;
  if (pwrite(v->dat_fd, rec, len, v->tail) != len) return -EIO;
  int64_t off = v->tail;
  v->tail += len;
  v->put(key, off, size);
  if (v->write_idx(key, off, (uint32_t)size) != 0) return -EIO;
  if (append_ns > v->last_append_ns) v->last_append_ns = append_ns;
  return off;
}

// Append a tombstone record; returns reclaimed bytes (0 = was absent,
// tombstone NOT written then — delete_needle semantics), or -errno.
int64_t dp_delete(uint32_t vid, uint64_t key, const uint8_t* tomb, int64_t len,
                  uint64_t append_ns) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return -ENOENT;
  std::lock_guard<std::mutex> lk(v->mu);
  if (v->detached) return -ENOENT;
  if (v->read_only) return -EROFS;
  auto it = v->map.find(key);
  if (it == v->map.end() || it->second.size <= 0) return 0;
  if (pwrite(v->dat_fd, tomb, len, v->tail) != len) return -EIO;
  v->tail += len;
  int64_t reclaimed = v->del(key);
  if (v->write_idx(key, 0, 0xFFFFFFFFu) != 0) return -EIO;
  if (append_ns > v->last_append_ns) v->last_append_ns = append_ns;
  return reclaimed;
}

// Live lookup. Returns 1 hit, 0 miss, -ENOENT no such volume.
int dp_lookup(uint32_t vid, uint64_t key, int64_t* out_byte_off,
              int32_t* out_size) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return -ENOENT;
  std::lock_guard<std::mutex> lk(v->mu);
  auto it = v->map.find(key);
  if (it == v->map.end() || it->second.size <= 0) return 0;
  *out_byte_off = it->second.offset;
  *out_size = it->second.size;
  return 1;
}

// Raw entry including tombstones (size < 0, original offset kept) —
// the python ?readDeleted=true path needs the offset of a deleted
// needle whose record still sits in the .dat.
int dp_lookup_any(uint32_t vid, uint64_t key, int64_t* out_byte_off,
                  int32_t* out_size) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return -ENOENT;
  std::lock_guard<std::mutex> lk(v->mu);
  auto it = v->map.find(key);
  if (it == v->map.end()) return 0;
  *out_byte_off = it->second.offset;
  *out_size = it->second.size;
  return 1;
}

// out[0..8] = file_count, file_bytes, deleted_count, deleted_bytes, tail,
// last_append_ns, max_key, map_len, read_only
int dp_stats(uint32_t vid, int64_t* out) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return -ENOENT;
  std::lock_guard<std::mutex> lk(v->mu);
  out[0] = v->file_count;
  out[1] = v->file_bytes;
  out[2] = v->deleted_count;
  out[3] = v->deleted_bytes;
  out[4] = v->tail;
  out[5] = (int64_t)v->last_append_ns;
  out[6] = (int64_t)v->max_key;
  out[7] = (int64_t)v->map.size();
  out[8] = v->read_only ? 1 : 0;
  return 0;
}

// Dump the whole map (tombstones included, size=-1). Returns count or -errno.
int64_t dp_export(uint32_t vid, uint64_t* keys, int64_t* byte_offsets,
                  int32_t* sizes, int64_t cap) {
  std::shared_ptr<Vol> v = find_vol(vid);
  if (!v) return -ENOENT;
  std::lock_guard<std::mutex> lk(v->mu);
  int64_t n = 0;
  for (auto& [k, mv] : v->map) {
    if (n >= cap) return -ENOSPC;
    keys[n] = k;
    byte_offsets[n] = mv.offset;
    sizes[n] = mv.size;
    n++;
  }
  return n;
}

// Test hook: HMAC-SHA256 over (key, msg) -> out[32]. Lets the test
// suite cross-check the in-tree SHA-256 against python hashlib without
// going through a full HTTP round-trip.
void dp_hmac_sha256(const uint8_t* key, int64_t keylen, const uint8_t* msg,
                    int64_t msglen, uint8_t* out) {
  hmac_sha256(key, (size_t)keylen, msg, (size_t)msglen, out);
}

// out[0..7] = fast gets, fast posts, proxied, errors, fast deletes,
// native replicated posts, jwt rejects, fan-out failures
void dp_http_stats(int64_t* out) {
  out[0] = n_fast_get.load();
  out[1] = n_fast_post.load();
  out[2] = n_proxied.load();
  out[3] = n_errors.load();
  out[4] = n_fast_delete.load();
  out[5] = n_repl_post.load();
  out[6] = n_jwt_reject.load();
  out[7] = n_fanout_fail.load();
}

// out[0..5] = 2xx, 3xx, 4xx, 5xx responses written by the native
// fronts, payload bytes in (uploads), payload bytes out (served
// bodies). dp_front_stats sums all roles (the historical series);
// dp_role_front_stats snapshots one role so the host can federate
// per-front families (native_front_requests_total{front=...}).
void dp_front_stats(int64_t* out) {
  for (int i = 0; i < 6; i++) out[i] = 0;
  for (int r = 0; r < N_ROLES; r++) {
    out[0] += front_stats[r].n_2xx.load();
    out[1] += front_stats[r].n_3xx.load();
    out[2] += front_stats[r].n_4xx.load();
    out[3] += front_stats[r].n_5xx.load();
    out[4] += front_stats[r].bytes_in.load();
    out[5] += front_stats[r].bytes_out.load();
  }
}

void dp_role_front_stats(int role, int64_t* out) {
  for (int i = 0; i < 6; i++) out[i] = 0;
  if (role < 0 || role >= N_ROLES) return;
  out[0] = front_stats[role].n_2xx.load();
  out[1] = front_stats[role].n_3xx.load();
  out[2] = front_stats[role].n_4xx.load();
  out[3] = front_stats[role].n_5xx.load();
  out[4] = front_stats[role].bytes_in.load();
  out[5] = front_stats[role].bytes_out.load();
}

// ---------------------------------------------------------------------------
// Benchmark client (the `weed benchmark` load-generator loop,
// command/benchmark.go:145 benchWrite / :172 benchRead, as native code —
// the Python requests client saturates one core at ~1.5k rps and would
// measure itself, not the server).
// ---------------------------------------------------------------------------

// mode 0 = GET, 1 = POST `payload_size` random-ish bytes.
// fids: newline-separated "vid,hex" strings. auths: optional parallel
// newline-separated per-fid bearer tokens ("" lines = unauthenticated;
// NULL = none at all) — the jwt-guarded benchmark rows need the signed
// token the master minted at assign time. latencies_ns: one per fid.
// Returns wall-clock ns for the whole run, or -errno.
int64_t dp_bench(const char* host, uint16_t port, int mode, const char* fids,
                 const char* auths, int64_t n_fids, int64_t payload_size,
                 int concurrency, int64_t* latencies_ns,
                 int64_t* out_errors) {
  std::vector<std::pair<const char*, size_t>> fid_list;
  fid_list.reserve(n_fids);
  const char* p = fids;
  for (int64_t i = 0; i < n_fids; i++) {
    const char* nl = strchr(p, '\n');
    if (!nl) nl = p + strlen(p);
    fid_list.emplace_back(p, nl - p);
    if (!*nl) break;
    p = nl + 1;
  }
  std::vector<std::pair<const char*, size_t>> auth_list;
  if (auths && *auths) {
    auth_list.reserve(n_fids);
    const char* a = auths;
    for (int64_t i = 0; i < n_fids; i++) {
      const char* nl = strchr(a, '\n');
      if (!nl) nl = a + strlen(a);
      auth_list.emplace_back(a, nl - a);
      if (!*nl) break;
      a = nl + 1;
    }
  }
  std::string payload(payload_size, 'x');
  for (int64_t i = 0; i < payload_size; i++)
    payload[i] = (char)('a' + (i * 31 + 7) % 26);
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> errors{0};
  struct sockaddr_in addr = {};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) return -EINVAL;

  auto worker = [&]() {
    int fd = -1;
    std::string resp;
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= (int64_t)fid_list.size()) break;
      struct timespec t0, t1;
      clock_gettime(CLOCK_MONOTONIC, &t0);
      bool ok = false;
      for (int attempt = 0; attempt < 2 && !ok; attempt++) {
        if (fd < 0) {
          fd = socket(AF_INET, SOCK_STREAM, 0);
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          struct timeval tv = {30, 0};
          setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
          if (connect(fd, (struct sockaddr*)&addr, sizeof addr) != 0) {
            close(fd);
            fd = -1;
            continue;
          }
        }
        char req[1024];
        char authhdr[600] = "";
        if (i < (int64_t)auth_list.size() && auth_list[i].second &&
            auth_list[i].second < 560)
          snprintf(authhdr, sizeof authhdr,
                   "Authorization: Bearer %.*s\r\n",
                   (int)auth_list[i].second, auth_list[i].first);
        int rn;
        if (mode == 1) {
          rn = snprintf(req, sizeof req,
                        "POST /%.*s HTTP/1.1\r\nHost: bench\r\n"
                        "Content-Type: application/octet-stream\r\n"
                        "%sContent-Length: %lld\r\n\r\n",
                        (int)fid_list[i].second, fid_list[i].first, authhdr,
                        (long long)payload_size);
        } else {
          rn = snprintf(req, sizeof req,
                        "GET /%.*s HTTP/1.1\r\nHost: bench\r\n%s\r\n",
                        (int)fid_list[i].second, fid_list[i].first, authhdr);
        }
        if (rn >= (int)sizeof req) {
          close(fd);
          fd = -1;
          continue;
        }
        if (!send_all(fd, req, rn) ||
            (mode == 1 && !send_all(fd, payload.data(), payload.size()))) {
          close(fd);
          fd = -1;
          continue;
        }
        int code = read_framed_response(fd, &resp, 64 << 20, false);
        if (code >= 200 && code < 300) {
          ok = true;
        } else {
          close(fd);
          fd = -1;
        }
      }
      clock_gettime(CLOCK_MONOTONIC, &t1);
      latencies_ns[i] = (t1.tv_sec - t0.tv_sec) * 1000000000ll +
                        (t1.tv_nsec - t0.tv_nsec);
      if (!ok) {
        errors++;
        latencies_ns[i] = -latencies_ns[i];  // mark failed
      }
    }
    if (fd >= 0) close(fd);
  };

  struct timespec w0, w1;
  clock_gettime(CLOCK_MONOTONIC, &w0);
  std::vector<std::thread> threads;
  for (int t = 0; t < concurrency; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  clock_gettime(CLOCK_MONOTONIC, &w1);
  if (out_errors) *out_errors = errors.load();
  return (w1.tv_sec - w0.tv_sec) * 1000000000ll + (w1.tv_nsec - w0.tv_nsec);
}

// Replay client: send PREBUILT request blobs (offsets[i]..offsets[i+1]
// delimit request i; offsets has n+1 entries) over keep-alive
// connections and read Content-Length-framed responses. Lets Python
// pre-sign arbitrary protocols (SigV4 S3, filer paths) while every
// timed byte moves in native code — the gateway benchmark needs ~50k
// rps of signed requests, far beyond a GIL-bound client.
// 2xx/3xx = success. Returns wall ns, or -errno.
int64_t dp_bench_raw(const char* host, uint16_t port, const uint8_t* blob,
                     const int64_t* offsets, int64_t n, int concurrency,
                     int64_t* latencies_ns, int64_t* out_errors) {
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> errors{0};
  struct sockaddr_in addr = {};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) return -EINVAL;

  auto worker = [&]() {
    int fd = -1;
    std::string resp;
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      const char* req = (const char*)blob + offsets[i];
      size_t req_len = (size_t)(offsets[i + 1] - offsets[i]);
      struct timespec t0, t1;
      clock_gettime(CLOCK_MONOTONIC, &t0);
      bool ok = false;
      for (int attempt = 0; attempt < 2 && !ok; attempt++) {
        if (fd < 0) {
          fd = socket(AF_INET, SOCK_STREAM, 0);
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          struct timeval tv = {30, 0};
          setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
          if (connect(fd, (struct sockaddr*)&addr, sizeof addr) != 0) {
            close(fd);
            fd = -1;
            continue;
          }
        }
        if (!send_all(fd, req, req_len)) {
          close(fd);
          fd = -1;
          continue;
        }
        int code = read_framed_response(fd, &resp, 64 << 20, true);
        if (code >= 200 && code < 400) {
          ok = true;
        } else {
          close(fd);
          fd = -1;
        }
      }
      clock_gettime(CLOCK_MONOTONIC, &t1);
      latencies_ns[i] = (t1.tv_sec - t0.tv_sec) * 1000000000ll +
                        (t1.tv_nsec - t0.tv_nsec);
      if (!ok) {
        errors++;
        latencies_ns[i] = -latencies_ns[i];
      }
    }
    if (fd >= 0) close(fd);
  };

  struct timespec w0, w1;
  clock_gettime(CLOCK_MONOTONIC, &w0);
  std::vector<std::thread> threads;
  for (int t = 0; t < concurrency; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  clock_gettime(CLOCK_MONOTONIC, &w1);
  if (out_errors) *out_errors = errors.load();
  return (w1.tv_sec - w0.tv_sec) * 1000000000ll + (w1.tv_nsec - w0.tv_nsec);
}

}  // extern "C"
