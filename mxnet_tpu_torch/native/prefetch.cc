// Native threaded record prefetcher — the dmlc::ThreadedIter /
// PrefetcherIter analog (reference: src/io/iter_prefetcher.h:47,
// dmlc-core ThreadedIter): a producer thread reads logical RecordIO
// records off disk into a bounded ring while Python decodes/augments the
// previous ones. The file scan runs entirely outside the GIL, so disk
// latency overlaps Python-side JPEG decode.
//
// Framing matches recordio.cc (dmlc wire format: magic 0xced7230a,
// cflag/length word, 4-byte padding, begin/middle/end splits).
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

const uint32_t kMagic = 0xced7230a;
const uint32_t kLenMask = (1u << 29) - 1u;

struct Prefetcher {
  std::FILE *f = nullptr;
  size_t capacity = 4;
  std::deque<std::string> ring;
  std::mutex mu;
  std::condition_variable can_put, can_get;
  bool eof = false;       // producer finished the file
  bool error = false;     // framing error
  bool stopping = false;  // reset/close in progress
  std::thread worker;

  // read one logical record (reassembling splits) into out; false on
  // EOF or framing error (error flag distinguishes)
  bool ReadRecord(std::string *out) {
    out->clear();
    bool expect_more = true, first = true;
    while (expect_more) {
      uint32_t head[2];
      size_t got = std::fread(head, 1, sizeof(head), f);
      if (got == 0 && first) return false;  // clean EOF
      if (got != sizeof(head) || head[0] != kMagic) {
        error = true;
        return false;
      }
      uint32_t cflag = head[1] >> 29;
      uint32_t len = head[1] & kLenMask;
      if (first) {
        expect_more = (cflag == 1);
        first = false;
      } else {
        expect_more = (cflag == 2);
      }
      size_t off = out->size();
      out->resize(off + len);
      if (len && std::fread(&(*out)[off], 1, len, f) != len) {
        error = true;
        return false;
      }
      uint32_t pad = ((len + 3u) & ~3u) - len;
      if (pad) std::fseek(f, pad, SEEK_CUR);
    }
    return true;
  }

  void Run() {
    while (true) {
      std::string rec;
      bool ok = ReadRecord(&rec);
      std::unique_lock<std::mutex> lk(mu);
      if (!ok) {
        eof = true;
        can_get.notify_all();
        return;
      }
      can_put.wait(lk, [&] { return ring.size() < capacity || stopping; });
      if (stopping) return;
      ring.emplace_back(std::move(rec));
      can_get.notify_one();
    }
  }

  void Start() {
    eof = error = stopping = false;
    worker = std::thread([this] { Run(); });
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
      can_put.notify_all();
    }
    if (worker.joinable()) worker.join();
    ring.clear();
  }
};

}  // namespace

extern "C" {

void *rpf_open(const char *path, long long capacity) {
  std::FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Prefetcher *p = new Prefetcher();
  p->f = f;
  if (capacity > 0) p->capacity = (size_t)capacity;
  p->Start();
  return p;
}

// Next record into out (cap bytes). Returns length, -1 on EOF, -3 on
// framing error. Callers size `out` via rpf_peek_size first; the -2
// too-small return is a defensive bound check, not a retry protocol.
long long rpf_next(void *h, char *out, long long cap) {
  Prefetcher *p = (Prefetcher *)h;
  std::unique_lock<std::mutex> lk(p->mu);
  p->can_get.wait(lk, [&] { return !p->ring.empty() || p->eof; });
  if (p->ring.empty()) return p->error ? -3 : -1;
  std::string &rec = p->ring.front();
  if ((long long)rec.size() > cap) return -2;
  long long n = (long long)rec.size();
  std::memcpy(out, rec.data(), rec.size());
  p->ring.pop_front();
  p->can_put.notify_one();
  return n;
}

// Size of the next queued record (blocks like rpf_next); -1 EOF, -3 error.
long long rpf_peek_size(void *h) {
  Prefetcher *p = (Prefetcher *)h;
  std::unique_lock<std::mutex> lk(p->mu);
  p->can_get.wait(lk, [&] { return !p->ring.empty() || p->eof; });
  if (p->ring.empty()) return p->error ? -3 : -1;
  return (long long)p->ring.front().size();
}

void rpf_reset(void *h) {
  Prefetcher *p = (Prefetcher *)h;
  p->Stop();
  std::fseek(p->f, 0, SEEK_SET);
  p->Start();
}

void rpf_close(void *h) {
  Prefetcher *p = (Prefetcher *)h;
  p->Stop();
  std::fclose(p->f);
  delete p;
}

}  // extern "C"
