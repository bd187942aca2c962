// Native RecordIO framing: the dmlc-core on-disk format the reference's
// data path is built on (consumed via dmlc::RecordIOWriter/Reader from
// src/io/iter_image_recordio_2.cc and python/mxnet/recordio.py through the
// C API's MXRecordIO* functions, src/c_api/c_api.cc).
//
// Format (dmlc-core recordio): per record
//   uint32 magic = 0xced7230a
//   uint32 lrec  = (cflag << 29) | length      (cflag: 0 whole, 1 begin,
//                                               2 middle, 3 end)
//   payload[length], zero-padded to 4-byte alignment
// Records larger than the 29-bit piece limit are split begin/middle/end.
//
// Handle-based so Python keeps one FILE* per reader/writer; the byte-level
// scanning of multi-GB files runs here without the GIL (ctypes releases it
// around calls).
#include <cstdint>
#include <cstdio>
#include <cstring>

static const uint32_t kMagic = 0xced7230a;
static const uint32_t kLenMask = (1u << 29) - 1u;

extern "C" {

void *rio_open(const char *path, const char *mode) {
  return (void *)std::fopen(path, mode);
}

void rio_close(void *h) {
  if (h) std::fclose((FILE *)h);
}

long long rio_tell(void *h) { return std::ftell((FILE *)h); }

int rio_seek(void *h, long long pos) {
  return std::fseek((FILE *)h, (long)pos, SEEK_SET);
}

// Scan from the current position and emit the byte offset of every logical
// record (start of its first physical piece). Returns the count, or -1 on
// framing error. offsets may be null to just count.
long long rio_scan(void *h, long long *offsets, long long max_offsets) {
  FILE *f = (FILE *)h;
  long long count = 0;
  long long pos = std::ftell(f);
  bool in_split = false;
  while (true) {
    uint32_t head[2];
    size_t got = std::fread(head, 1, sizeof(head), f);
    if (got == 0) break;
    if (got != sizeof(head) || head[0] != kMagic) return -1;
    uint32_t cflag = head[1] >> 29;
    uint32_t len = head[1] & kLenMask;
    if (cflag == 0 || cflag == 1) {
      if (offsets && count < max_offsets) offsets[count] = pos;
      ++count;
      in_split = (cflag == 1);
    } else if (!in_split) {
      return -1;  // middle/end piece without a begin
    }
    if (cflag == 3) in_split = false;
    uint32_t padded = (len + 3u) & ~3u;
    if (std::fseek(f, padded, SEEK_CUR) != 0) return -1;
    pos += 8 + padded;
  }
  return count;
}

// Read the logical record at the current position (reassembling split
// pieces), advancing past it. Returns payload length, -1 on error/EOF, or
// -2 if `out` is too small (out=null queries the size and restores the
// position).
long long rio_read(void *h, char *out, long long out_cap) {
  FILE *f = (FILE *)h;
  long long start = std::ftell(f);
  long long total = 0;
  bool expect_more = true;
  bool first = true;
  while (expect_more) {
    uint32_t head[2];
    if (std::fread(head, 1, sizeof(head), f) != sizeof(head) ||
        head[0] != kMagic) return -1;
    uint32_t cflag = head[1] >> 29;
    uint32_t len = head[1] & kLenMask;
    if (first) {
      expect_more = (cflag == 1);
      first = false;
    } else {
      expect_more = (cflag == 2);
    }
    if (out) {
      if (total + len > out_cap) return -2;
      if (std::fread(out + total, 1, len, f) != len) return -1;
      uint32_t pad = ((len + 3u) & ~3u) - len;
      if (pad) std::fseek(f, pad, SEEK_CUR);
    } else {
      std::fseek(f, (len + 3u) & ~3u, SEEK_CUR);
    }
    total += len;
  }
  if (!out) std::fseek(f, (long)start, SEEK_SET);
  return total;
}

// Read the logical record starting at `offset`.
long long rio_read_at(void *h, long long offset, char *out,
                      long long out_cap) {
  if (std::fseek((FILE *)h, (long)offset, SEEK_SET) != 0) return -1;
  return rio_read(h, out, out_cap);
}

// Append one logical record (splitting if needed); returns bytes written
// or -1. `max_chunk` <= 0 selects the dmlc piece limit.
long long rio_write(void *h, const char *data, long long len,
                    long long max_chunk) {
  FILE *f = (FILE *)h;
  if (max_chunk <= 0 || max_chunk > (long long)kLenMask)
    max_chunk = kLenMask;
  long long written = 0;
  long long remaining = len;
  long long off = 0;
  int piece = 0;
  while (true) {
    uint32_t this_len = (uint32_t)(remaining < max_chunk ? remaining
                                                         : max_chunk);
    bool last = (remaining <= max_chunk);
    uint32_t cflag;
    if (piece == 0) cflag = last ? 0u : 1u;
    else cflag = last ? 3u : 2u;
    uint32_t head[2] = {kMagic, (cflag << 29) | this_len};
    if (std::fwrite(head, 1, sizeof(head), f) != sizeof(head)) return -1;
    if (this_len && std::fwrite(data + off, 1, this_len, f) != this_len)
      return -1;
    uint32_t pad = ((this_len + 3u) & ~3u) - this_len;
    static const char zeros[4] = {0, 0, 0, 0};
    if (pad) std::fwrite(zeros, 1, pad, f);
    written += 8 + this_len + pad;
    remaining -= this_len;
    off += this_len;
    ++piece;
    if (last) break;
  }
  return written;
}

int rio_flush(void *h) { return std::fflush((FILE *)h); }

}  // extern "C"
