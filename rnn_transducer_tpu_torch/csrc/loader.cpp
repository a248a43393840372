// loader: the training and decode CLIs' multi-threaded prefetching
// manifest loader (the port's copy of the JAX package's host loader).
//
// Worker threads read manifest entries (precomputed .npy features, or raw
// 16 kHz PCM for {"audio"} records), accumulate them into length buckets,
// and publish fully padded, fixed-shape batches into a bounded ready queue.
// The training thread only memcpy's a finished batch out: file IO and
// padding overlap the card's compute instead of running on that thread.
//
// There is no host frontend here: an audio record's samples are bucketed
// by the frame count of `ops/logmel.log_mel`'s window formula (1 + (n -
// win) / hop frames, none when n < win) and published as padded PCM with
// its sample counts; the caller featurizes the batch with `log_mel` on
// its device. A manifest's records are all features or all audio.
//
// Bucket rule, padding and flush are those of data/bucketing.py's
// bucket_stream: the first (max_t, max_u) that fits, cyclic padding of a
// trailing partial batch with a true n_valid, the partial batches flushed
// in the order of their buckets' first example (the JAX package's copy
// flushes by bucket index); per epoch a std::shuffle by
// std::mt19937_64(seed + epoch) (seed -1 keeps the manifest order).
// Plain C ABI, bound with ctypes by data/native_loader.py; built by
// utils/build.py with
//   g++ -O3 -fPIC -shared -std=c++17 loader.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------- .npy reader -------------------------------
// Minimal parser: v1.0/2.0 headers, little-endian '<f4'/'<i4'/'<i2',
// C-order, 1-D or 2-D. Returns false on anything else.
bool read_npy(const std::string& path, std::vector<float>& data,
              int64_t* rows, int64_t* cols) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    std::fclose(f);
    return false;
  }
  const int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (std::fread(b, 1, 2, f) != 2) { std::fclose(f); return false; }
    hlen = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (std::fread(b, 1, 4, f) != 4) { std::fclose(f); return false; }
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
  }
  std::string header(hlen, '\0');
  if (std::fread(header.data(), 1, hlen, f) != hlen) {
    std::fclose(f);
    return false;
  }
  if (header.find("'fortran_order': True") != std::string::npos) {
    std::fclose(f);
    return false;
  }
  bool is_f4 = header.find("'<f4'") != std::string::npos;
  bool is_i4 = header.find("'<i4'") != std::string::npos;
  bool is_i2 = header.find("'<i2'") != std::string::npos;
  if (!is_f4 && !is_i4 && !is_i2) { std::fclose(f); return false; }
  auto sp = header.find("'shape': (");
  if (sp == std::string::npos) { std::fclose(f); return false; }
  int64_t r = 0, c = -1;
  const char* s = header.c_str() + sp + 10;
  r = std::strtoll(s, const_cast<char**>(&s), 10);
  while (*s == ',' || *s == ' ') ++s;
  if (*s != ')') c = std::strtoll(s, const_cast<char**>(&s), 10);
  if (r <= 0 || (c == 0)) { std::fclose(f); return false; }
  const int64_t n = r * (c > 0 ? c : 1);
  data.resize(n);
  if (is_f4) {
    if ((int64_t)std::fread(data.data(), 4, n, f) != n) {
      std::fclose(f);
      return false;
    }
  } else if (is_i4) {
    std::vector<int32_t> tmp(n);
    if ((int64_t)std::fread(tmp.data(), 4, n, f) != n) {
      std::fclose(f);
      return false;
    }
    for (int64_t i = 0; i < n; ++i) data[i] = float(tmp[i]);
  } else {
    std::vector<int16_t> tmp(n);
    if ((int64_t)std::fread(tmp.data(), 2, n, f) != n) {
      std::fclose(f);
      return false;
    }
    for (int64_t i = 0; i < n; ++i) data[i] = float(tmp[i]) / 32768.0f;
  }
  std::fclose(f);
  *rows = r;
  *cols = c;
  return true;
}

bool read_raw_f32(const std::string& path, std::vector<float>& data) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const int64_t bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  data.resize(bytes / 4);
  const bool ok =
      (int64_t)std::fread(data.data(), 4, data.size(), f) == (int64_t)data.size();
  std::fclose(f);
  return ok;
}

struct Batch {
  int bucket;
  int n_valid;
  std::vector<float> feats;     // (B, row): max_t * F features or PCM
  std::vector<int32_t> feat_lens;  // frames, or samples for audio
  std::vector<int32_t> labels;  // (B, max_u)
  std::vector<int32_t> label_lens;
};

struct Example {
  std::vector<float> feats;  // (t, F) features, or the PCM t frames span
  int64_t t;                 // frames
  std::vector<int32_t> labels;
};

struct Loader {
  // immutable config
  std::vector<std::string> paths;
  bool audio = false;  // every record raw PCM (else .npy features)
  std::vector<std::vector<int32_t>> labels;
  std::vector<std::pair<int, int>> buckets;  // (max_t, max_u), ascending
  int batch_size = 0, feat_dim = 0, blank = 0, win = 400, hop = 160;
  bool loop = false;
  uint64_t seed = 0;

  // work distribution
  std::mutex idx_mu;
  std::vector<int64_t> order;
  size_t next_idx = 0;
  int64_t epoch = 0;
  int64_t dropped = 0;  // examples not fitting any bucket

  // bucket accumulators, and the buckets holding examples in the order
  // of their first example (bucket_stream's dict order, the flush order)
  std::mutex acc_mu;
  std::vector<std::vector<Example>> acc;
  std::vector<int> pending;

  // ready queue (bounded)
  std::mutex q_mu;
  std::condition_variable q_cv_put, q_cv_get;
  std::deque<std::unique_ptr<Batch>> queue;
  size_t q_cap = 4;
  int active_workers = 0;
  bool done = false;     // non-loop: all examples consumed & flushed
  std::atomic<bool> stop{false};

  std::vector<std::thread> workers;

  // floats a padded row holds in a bucket of max_t frames
  int64_t row_floats(int max_t) const {
    return audio ? (int64_t)win + (int64_t)hop * (max_t - 1)
                 : (int64_t)max_t * feat_dim;
  }

  // floats an example of t frames fills in its row
  int64_t used_floats(const Example& e) const {
    return audio ? (int64_t)e.feats.size() : e.t * feat_dim;
  }

  void reshuffle_locked() {
    if (epoch == 0) {
      order.resize(paths.size());
      for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    }
    if (seed != ~0ull) {  // ~0 = keep manifest order (deterministic tests)
      std::mt19937_64 rng(seed + epoch);
      std::shuffle(order.begin(), order.end(), rng);
    }
    next_idx = 0;
  }

  // -1 = no more work (non-loop)
  int64_t take_index() {
    std::lock_guard<std::mutex> g(idx_mu);
    if (next_idx >= order.size()) {
      if (!loop) return -1;
      ++epoch;
      reshuffle_locked();
    }
    return order[next_idx++];
  }

  bool load_one(int64_t i, Example* ex) {
    std::vector<float> raw;
    int64_t r = 0, c = -1;
    const std::string& p = paths[i];
    if (p.size() > 4 && p.compare(p.size() - 4, 4, ".npy") == 0) {
      if (!read_npy(p, raw, &r, &c)) return false;
    } else {
      if (!read_raw_f32(p, raw)) return false;
      r = raw.size();
      c = -1;
    }
    if (audio) {
      const int64_t n = (c > 0) ? r * c : r;
      if (n < win) return false;  // no whole window: no frame
      ex->t = 1 + (n - win) / hop;
      // the samples past the last frame's window reach no frame
      raw.resize(win + hop * (ex->t - 1));
      ex->feats = std::move(raw);
    } else {
      if (c != feat_dim) return false;
      ex->feats = std::move(raw);
      ex->t = r;
    }
    ex->labels = labels[i];
    return true;
  }

  int pick_bucket(int64_t t, int64_t u) const {
    for (size_t b = 0; b < buckets.size(); ++b)
      if (t <= buckets[b].first && u <= buckets[b].second) return (int)b;
    return -1;
  }

  std::unique_ptr<Batch> pack(int b, std::vector<Example>& items,
                              int n_valid) {
    auto out = std::make_unique<Batch>();
    const int B = batch_size;
    const int max_u = buckets[b].second;
    const int64_t row = row_floats(buckets[b].first);
    out->bucket = b;
    out->n_valid = n_valid;
    out->feats.assign((int64_t)B * row, 0.0f);
    out->feat_lens.assign(B, 0);
    out->labels.assign((int64_t)B * max_u, blank);
    out->label_lens.assign(B, 0);
    for (int i = 0; i < B; ++i) {
      const Example& e = items[i];
      std::memcpy(out->feats.data() + (int64_t)i * row, e.feats.data(),
                  used_floats(e) * sizeof(float));
      out->feat_lens[i] = (int32_t)(audio ? e.feats.size() : e.t);
      std::memcpy(out->labels.data() + (int64_t)i * max_u, e.labels.data(),
                  e.labels.size() * sizeof(int32_t));
      out->label_lens[i] = (int32_t)e.labels.size();
    }
    return out;
  }

  void publish(std::unique_ptr<Batch> b) {
    std::unique_lock<std::mutex> lk(q_mu);
    q_cv_put.wait(lk, [&] { return queue.size() < q_cap || stop.load(); });
    if (stop.load()) return;
    queue.push_back(std::move(b));
    q_cv_get.notify_one();
  }

  void worker() {
    while (!stop.load()) {
      const int64_t i = take_index();
      if (i < 0) break;
      Example ex;
      if (!load_one(i, &ex)) continue;  // unreadable/mismatched: skip
      const int b = pick_bucket(ex.t, (int64_t)ex.labels.size());
      if (b < 0) {
        std::lock_guard<std::mutex> g(idx_mu);
        ++dropped;
        continue;
      }
      std::unique_ptr<Batch> ready;
      {
        std::lock_guard<std::mutex> g(acc_mu);
        if (acc[b].empty()) pending.push_back(b);
        acc[b].push_back(std::move(ex));
        if ((int)acc[b].size() == batch_size) {
          std::vector<Example> items;
          items.swap(acc[b]);
          pending.erase(std::find(pending.begin(), pending.end(), b));
          ready = pack(b, items, batch_size);
        }
      }
      if (ready) publish(std::move(ready));
    }
    // last worker out flushes partial buckets (non-loop) and marks done
    std::unique_lock<std::mutex> lk(q_mu);
    if (--active_workers == 0) {
      lk.unlock();
      if (!loop && !stop.load()) {
        std::lock_guard<std::mutex> g(acc_mu);
        for (const int b : pending) {
          const int n_valid = (int)acc[b].size();
          std::vector<Example> items;
          items.swap(acc[b]);
          for (int i = n_valid; i < batch_size; ++i) {
            const Example& src = items[i % n_valid];
            Example copy;
            copy.feats = src.feats;
            copy.t = src.t;
            copy.labels = src.labels;
            items.push_back(std::move(copy));
          }
          publish(pack(b, items, n_valid));
        }
        pending.clear();
      }
      lk.lock();
      done = true;
      q_cv_get.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// paths: \n-joined utf-8; audio: 1 when every record is raw PCM (then
// feat_dim is unused and a row holds win + hop * (max_t - 1) samples);
// labels: concatenated int32 with per-utterance lens; buckets: (max_t,
// max_u) pairs in frames and labels. seed == -1 keeps manifest order.
void* loader_create(const char* paths_joined, int audio, int n_paths,
                    const int32_t* labels_cat, const int32_t* label_lens,
                    const int32_t* buckets_tu, int n_buckets, int batch_size,
                    int feat_dim, int blank, int loop, int64_t seed,
                    int n_threads, int queue_cap, int win, int hop) {
  auto* L = new Loader();
  const char* s = paths_joined;
  for (int i = 0; i < n_paths; ++i) {
    const char* e = std::strchr(s, '\n');
    if (!e) e = s + std::strlen(s);
    L->paths.emplace_back(s, e - s);
    s = (*e ? e + 1 : e);
  }
  L->audio = audio != 0;
  const int32_t* lp = labels_cat;
  for (int i = 0; i < n_paths; ++i) {
    L->labels.emplace_back(lp, lp + label_lens[i]);
    lp += label_lens[i];
  }
  for (int b = 0; b < n_buckets; ++b)
    L->buckets.emplace_back(buckets_tu[2 * b], buckets_tu[2 * b + 1]);
  L->batch_size = batch_size;
  L->feat_dim = feat_dim;
  L->blank = blank;
  L->win = win;
  L->hop = hop;
  L->loop = loop != 0;
  L->seed = (seed < 0) ? ~0ull : (uint64_t)seed;
  L->q_cap = queue_cap > 0 ? queue_cap : 4;
  L->acc.resize(n_buckets);
  L->reshuffle_locked();
  const int nt = n_threads > 0 ? n_threads : 2;
  L->active_workers = nt;
  for (int t = 0; t < nt; ++t)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Blocks until a batch is ready. Returns the bucket index (>= 0), or -1
// when the loader is exhausted (non-loop) / stopped. Caller buffers must
// hold the LARGEST bucket's rows: feats B x row_floats(max_T), labels
// (B, max_U). The batch's bucket (max_t frames, max_u) lands in
// out_shape[0:2]; n_valid in [2].
int loader_next(void* h, float* feats, int32_t* feat_lens, int32_t* labels,
                int32_t* label_lens, int32_t* out_shape) {
  auto* L = static_cast<Loader*>(h);
  std::unique_ptr<Batch> b;
  {
    std::unique_lock<std::mutex> lk(L->q_mu);
    L->q_cv_get.wait(lk, [&] {
      return !L->queue.empty() || L->done || L->stop.load();
    });
    if (L->queue.empty()) return -1;
    b = std::move(L->queue.front());
    L->queue.pop_front();
    L->q_cv_put.notify_one();
  }
  std::memcpy(feats, b->feats.data(), b->feats.size() * sizeof(float));
  std::memcpy(feat_lens, b->feat_lens.data(),
              b->feat_lens.size() * sizeof(int32_t));
  std::memcpy(labels, b->labels.data(), b->labels.size() * sizeof(int32_t));
  std::memcpy(label_lens, b->label_lens.data(),
              b->label_lens.size() * sizeof(int32_t));
  out_shape[0] = L->buckets[b->bucket].first;
  out_shape[1] = L->buckets[b->bucket].second;
  out_shape[2] = b->n_valid;
  return b->bucket;
}

int64_t loader_dropped(void* h) {
  auto* L = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> g(L->idx_mu);
  return L->dropped;
}

void loader_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  L->stop.store(true);
  {
    std::lock_guard<std::mutex> g(L->q_mu);
    L->queue.clear();
    L->q_cv_put.notify_all();
    L->q_cv_get.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
