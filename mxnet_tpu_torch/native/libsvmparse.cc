// Native LibSVM text parser -> CSR arrays.
//
// The reference parses libsvm in C++ too (src/io/iter_libsvm.cc over
// dmlc's text InputSplit); the Python tokenizer in io.py is ~40x slower
// on large sparse datasets, so the iterator calls this when the
// toolchain is available. One pass builds label/indptr/indices/values
// vectors; Python wraps them into numpy without copying the text again.
//
// Line format: "<label[,more]> <idx>:<val> <idx>:<val> ..."; blank lines
// are skipped; only the first comma-separated label token is kept (the
// multi-label case re-parses the label FILE through the same entry
// point, where each "<idx>:<val>" row is the sparse label vector).
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct LsvmData {
  std::vector<float> labels;
  std::vector<long long> indptr;  // rows + 1
  std::vector<long long> indices;
  std::vector<float> values;
  long long error_line = 0;  // 1-based line of first parse error, 0 = ok
};

}  // namespace

extern "C" {

void *lsvm_parse(const char *path) {
  std::FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  LsvmData *d = new LsvmData();
  d->indptr.push_back(0);

  std::vector<char> line;
  line.reserve(1 << 16);
  long long lineno = 0;
  char buf[1 << 16];
  bool pending = false;  // line under construction
  auto flush_line = [&]() -> bool {
    ++lineno;
    pending = false;
    // strtod/strtoll scan to a terminator: without this NUL they run
    // into stale bytes of a longer previous line still in the buffer
    line.push_back('\0');
    const char *p = line.data();
    const char *end = p + line.size() - 1;
    while (p < end && std::isspace((unsigned char)*p)) ++p;
    if (p >= end) { line.clear(); return true; }  // blank line
    // label: first comma-separated float of the first token
    char *next = nullptr;
    double label = std::strtod(p, &next);
    if (next == p) { d->error_line = lineno; return false; }
    p = next;
    // skip any ",extra" label values and the rest of the token
    while (p < end && !std::isspace((unsigned char)*p)) ++p;
    // features
    while (true) {
      while (p < end && std::isspace((unsigned char)*p)) ++p;
      if (p >= end) break;
      long long idx = std::strtoll(p, &next, 10);
      if (next == p || *next != ':') { d->error_line = lineno; return false; }
      p = next + 1;
      double val = std::strtod(p, &next);
      if (next == p) { d->error_line = lineno; return false; }
      p = next;
      d->indices.push_back(idx);
      d->values.push_back((float)val);
    }
    d->labels.push_back((float)label);
    d->indptr.push_back((long long)d->indices.size());
    line.clear();
    return true;
  };

  bool ok = true;
  while (ok) {
    size_t got = std::fread(buf, 1, sizeof(buf), f);
    if (got == 0) break;
    size_t start = 0;
    for (size_t i = 0; i < got; ++i) {
      if (buf[i] == '\n') {
        line.insert(line.end(), buf + start, buf + i);
        pending = true;
        if (!flush_line()) { ok = false; break; }
        start = i + 1;
      }
    }
    if (ok && start < got) {
      line.insert(line.end(), buf + start, buf + got);
      pending = true;
    }
  }
  if (ok && pending && !line.empty()) flush_line();
  std::fclose(f);
  return d;
}

long long lsvm_rows(void *h) {
  return (long long)((LsvmData *)h)->labels.size();
}

long long lsvm_nnz(void *h) {
  return (long long)((LsvmData *)h)->indices.size();
}

long long lsvm_error_line(void *h) { return ((LsvmData *)h)->error_line; }

void lsvm_fill(void *h, float *labels, long long *indptr,
               long long *indices, float *values) {
  LsvmData *d = (LsvmData *)h;
  std::memcpy(labels, d->labels.data(), d->labels.size() * sizeof(float));
  std::memcpy(indptr, d->indptr.data(),
              d->indptr.size() * sizeof(long long));
  std::memcpy(indices, d->indices.data(),
              d->indices.size() * sizeof(long long));
  std::memcpy(values, d->values.data(), d->values.size() * sizeof(float));
}

void lsvm_free(void *h) { delete (LsvmData *)h; }

}  // extern "C"
