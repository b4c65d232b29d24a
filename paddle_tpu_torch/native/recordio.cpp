// RecordIO-style record file — C++ reader/writer with a C ABI.
//
// The port's copy of paddle_tpu/native/recordio.cpp, the same file
// format, so a file written by either package reads in the other. Built
// on first use by paddle_tpu_torch/native/build.py (g++, one shared
// library under build/paddle_tpu_torch/).
//
// Native data path mirroring the reference's recordio usage (the Go
// master partitions RecordIO chunks into tasks, go/master/service.go:106;
// the cpp/go recordio libraries frame records for fault-tolerant
// sharding). Format here:
//   file  := "PTR1" record*
//   record:= uint32 len | uint32 crc32(payload) | payload bytes
// CRC-verified sequential reads + cheap skip make (path, start, count)
// task descriptors cheap to serve, which is exactly what the elastic
// master schedules.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// table built by a static initializer: thread-safe under C++11 rules
struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
const CrcTable crc_tab;

uint32_t crc32(const char *buf, size_t len) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    c = crc_tab.t[(c ^ (uint8_t)buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

constexpr char kMagic[4] = {'P', 'T', 'R', '1'};

struct Writer {
  FILE *f;
};
struct Reader {
  FILE *f;
};

// A record length field must be sane before it sizes any read: lengths
// beyond this (or with the sign bit set) mean corruption, not data.
constexpr uint32_t kMaxRecordLen = 1u << 30;

// Read exactly 4 header bytes. Returns 1 ok, 0 clean EOF (zero bytes
// read), -2 truncated mid-header (1-3 bytes) — which callers must
// surface as corruption, not EOF.
int read_header_u32(FILE *f, uint32_t *v) {
  size_t got = std::fread(v, 1, 4, f);
  if (got == 4) return 1;
  if (got == 0 && std::feof(f)) return 0;
  return -2;
}

}  // namespace

extern "C" {

void *ptrio_open_write(const char *path) {
  FILE *f = std::fopen(path, "wb");
  if (!f) return nullptr;
  if (std::fwrite(kMagic, 1, 4, f) != 4) { std::fclose(f); return nullptr; }
  return new Writer{f};
}

int ptrio_write(void *h, const char *buf, int len) {
  auto *w = (Writer *)h;
  uint32_t l = (uint32_t)len, c = crc32(buf, len);
  if (std::fwrite(&l, 4, 1, w->f) != 1) return -1;
  if (std::fwrite(&c, 4, 1, w->f) != 1) return -1;
  if (len && std::fwrite(buf, 1, len, w->f) != (size_t)len) return -1;
  return 0;
}

int ptrio_close_write(void *h) {
  auto *w = (Writer *)h;
  int rc = std::fclose(w->f);
  delete w;
  return rc;
}

void *ptrio_open_read(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char magic[4];
  if (std::fread(magic, 1, 4, f) != 4 ||
      std::memcmp(magic, kMagic, 4) != 0) {
    std::fclose(f);
    return nullptr;
  }
  return new Reader{f};
}

// next record into buf; returns length, -1 on EOF, -2 on corruption,
// -(needed)-3 when cap is too small (caller re-reads after growing).
int ptrio_next(void *h, char *buf, int cap) {
  auto *r = (Reader *)h;
  uint32_t l, c;
  long pos = std::ftell(r->f);
  int rc = read_header_u32(r->f, &l);
  if (rc == 0) return -1;
  if (rc < 0) return -2;
  if (read_header_u32(r->f, &c) != 1) return -2;
  if (l > kMaxRecordLen) return -2;  // unsigned check: no sign-bit bypass
  if (l > (uint32_t)cap) {
    std::fseek(r->f, pos, SEEK_SET);
    return -(int)l - 3;
  }
  if (l && std::fread(buf, 1, l, r->f) != l) return -2;
  if (crc32(buf, l) != c) return -2;
  return (int)l;
}

// skip n records without copying payloads; returns records skipped.
int ptrio_skip(void *h, int n) {
  auto *r = (Reader *)h;
  int i = 0;
  for (; i < n; i++) {
    uint32_t l, c;
    if (read_header_u32(r->f, &l) != 1) break;
    if (read_header_u32(r->f, &c) != 1) break;
    if (l > kMaxRecordLen) break;
    if (std::fseek(r->f, l, SEEK_CUR) != 0) break;
  }
  return i;
}

int ptrio_close_read(void *h) {
  auto *r = (Reader *)h;
  int rc = std::fclose(r->f);
  delete r;
  return rc;
}

// total record count (one pass over the framing)
int ptrio_count(const char *path) {
  void *h = ptrio_open_read(path);
  if (!h) return -1;
  auto *r = (Reader *)h;
  std::fseek(r->f, 0, SEEK_END);
  long file_size = std::ftell(r->f);
  std::fseek(r->f, 4, SEEK_SET);  // past magic
  int n = 0;
  uint32_t l, c;
  int rc;
  while ((rc = read_header_u32(r->f, &l)) == 1) {
    // fseek happily lands past EOF, so a truncated payload must be
    // caught by an explicit bound check against the file size
    if (read_header_u32(r->f, &c) != 1 || l > kMaxRecordLen ||
        std::ftell(r->f) + (long)l > file_size ||
        std::fseek(r->f, l, SEEK_CUR) != 0) {
      ptrio_close_read(h);
      return -2;
    }
    n++;
  }
  ptrio_close_read(h);
  return rc < 0 ? -2 : n;
}

}  // extern "C"
