// rank_tpu_torch native host data plane (a copy of rank_tpu's
// native/src/rank_native.cpp; the two must give the same bytes).
//
// C++ equivalents of the host-side hot loops that the original repo runs
// in per-row Python (its per-model WechatDataset encode loops,
// algorithm/DIN/din.py:140-173 and algorithm/DeepFM/deepfm.py:52-70, and
// the DataLoader batch assembly). Device compute stays in PyTorch and the
// CUDA kernels; this library owns the token->id vocabulary encode (scalar
// + comma-separated sequence) and the row-gather used for host-side batch
// slicing.
//
// C ABI only (loaded via ctypes). All buffers are caller-allocated;
// strings cross the boundary as one contiguous newline-separated UTF-8
// buffer (built by str.join on the Python side, which is itself a C-speed
// operation) instead of per-object PyUnicode walks.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (see native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  // Backing copy of the newline-separated token buffer; the map's
  // string_view keys point into it.
  std::string storage;
  std::unordered_map<std::string_view, int32_t> index;  // token -> row (1-based)
};

// Start offset of every line in buf (split on '\n'), plus a sentinel one
// past a virtual trailing '\n', so line i spans
// [starts[i], starts[i+1] - 1).
std::vector<int64_t> line_starts(const char* buf, int64_t len) {
  std::vector<int64_t> starts;
  starts.push_back(0);
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) break;
    p = nl + 1;
    starts.push_back(p - buf);
  }
  starts.push_back(len + 1);
  return starts;
}

template <class F>
void parallel_rows(int64_t n, int32_t n_threads, F f) {
  if (n_threads <= 1 || n < 8192) {
    f(static_cast<int64_t>(0), n);
    return;
  }
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([lo, hi, &f] { f(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Tokens arrive newline-separated in file order; token on line i maps to
// row i+1 (row 0 is the dedicated OOV row — see rank_tpu_torch/features.py
// vocab_index and the documented divergence from deepfm.py:40,80-86).
void* rt_vocab_create(const char* buf, int64_t len) {
  auto* v = new Vocab();
  v->storage.assign(buf, static_cast<size_t>(len));
  auto starts = line_starts(v->storage.data(), len);
  int64_t n_lines = static_cast<int64_t>(starts.size()) - 1;
  v->index.reserve(static_cast<size_t>(n_lines) * 2);
  int32_t row = 1;
  for (int64_t i = 0; i < n_lines; ++i) {
    int64_t b = starts[i];
    int64_t e = starts[i + 1] - 1;
    if (e <= b) continue;  // skip empty lines (trailing newline etc.)
    v->index.emplace(
        std::string_view(v->storage.data() + b, static_cast<size_t>(e - b)),
        row++);
  }
  return v;
}

void rt_vocab_destroy(void* h) { delete static_cast<Vocab*>(h); }

int64_t rt_vocab_size(void* h) {
  return static_cast<int64_t>(static_cast<Vocab*>(h)->index.size());
}

// buf: n_rows newline-separated tokens ("" rows and OOV tokens -> 0).
// Returns the number of rows actually found (caller asserts == n_rows).
int64_t rt_encode_tokens(void* h, const char* buf, int64_t len,
                         int64_t n_rows, int32_t* out, int32_t n_threads) {
  const Vocab* v = static_cast<const Vocab*>(h);
  auto starts = line_starts(buf, len);
  int64_t found = static_cast<int64_t>(starts.size()) - 1;
  if (found != n_rows) return found;
  parallel_rows(n_rows, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t b = starts[i];
      int64_t e = starts[i + 1] - 1;
      if (e <= b) {
        out[i] = 0;
        continue;
      }
      auto it = v->index.find(
          std::string_view(buf + b, static_cast<size_t>(e - b)));
      out[i] = (it == v->index.end()) ? 0 : it->second;
    }
  });
  return found;
}

// buf: n_rows newline-separated rows, each a comma-separated token list
// ("" row = empty sequence). Keeps the most recent max_len tokens (the
// tail — DataGenerator.py:274 semantics), left-aligned into
// out_ids[i, 0:len]; out_ids must arrive zeroed. out_lens[i] = kept count.
int64_t rt_encode_seq(void* h, const char* buf, int64_t len, int64_t n_rows,
                      int32_t max_len, int32_t* out_ids, int32_t* out_lens,
                      int32_t n_threads) {
  const Vocab* v = static_cast<const Vocab*>(h);
  auto starts = line_starts(buf, len);
  int64_t found = static_cast<int64_t>(starts.size()) - 1;
  if (found != n_rows) return found;
  parallel_rows(n_rows, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<int64_t, int64_t>> toks;  // (begin, end) per token
    toks.reserve(256);
    for (int64_t i = lo; i < hi; ++i) {
      int64_t b = starts[i];
      int64_t e = starts[i + 1] - 1;
      out_lens[i] = 0;
      if (e <= b) continue;
      toks.clear();
      int64_t tb = b;
      for (int64_t p = b; p <= e; ++p) {
        if (p == e || buf[p] == ',') {
          toks.emplace_back(tb, p);
          tb = p + 1;
        }
      }
      int64_t n_tok = static_cast<int64_t>(toks.size());
      int64_t skip = n_tok > max_len ? n_tok - max_len : 0;  // keep tail
      int32_t* row_out = out_ids + i * max_len;
      int32_t c = 0;
      for (int64_t t = skip; t < n_tok; ++t) {
        auto [tb2, te2] = toks[t];
        if (te2 <= tb2) {
          row_out[c++] = 0;  // empty token between commas -> OOV
          continue;
        }
        auto it = v->index.find(
            std::string_view(buf + tb2, static_cast<size_t>(te2 - tb2)));
        row_out[c++] = (it == v->index.end()) ? 0 : it->second;
      }
      out_lens[i] = c;
    }
  });
  return found;
}

// Threaded row gather: out[j, :] = src[idx[j], :] for row_bytes-wide rows.
// Replaces numpy fancy indexing for host-side batch assembly.
void rt_gather_rows(const char* src, int64_t row_bytes, const int64_t* idx,
                    int64_t n_idx, char* out, int32_t n_threads) {
  parallel_rows(n_idx, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      memcpy(out + j * row_bytes, src + idx[j] * row_bytes,
             static_cast<size_t>(row_bytes));
    }
  });
}

int32_t rt_abi_version() { return 1; }

}  // extern "C"
