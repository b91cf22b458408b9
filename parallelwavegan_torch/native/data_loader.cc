// Native data loader: multi-threaded random-window batch assembly for
// mel2wav training. The port's own copy of
// parallelwavegan_tpu/native/data_loader.cc (the port imports nothing of
// the JAX package); its code is the same line for line, so both packages'
// loaders give bit-equal batches on the same dumps and seed.
//
// Reads .npy dumps (<utt>-wave.npy float32 (T,), <utt>-feats.npy float32
// (T', C)) and produces fixed-shape batches:
//   y (B, batch_max_steps, 1), c (B, batch_max_frames + 2*ctx, C),
//   z (B, batch_max_steps, 1) optional N(0,1).
//
// Unlike the Python path (whole-array reads), workers pread() only the
// cropped window bytes, so per-step I/O is O(window), not O(utterance).
// Crop semantics mirror Collater._mel2wav_batch: a random start frame in
// [ctx, len(c) - batch_max_frames - ctx), audio window [start*hop,
// start*hop + batch_max_steps), mel window [start-ctx, start+frames+ctx).
// The audio length is clamped/edge-padded to len(c)*hop (the framework
// alignment invariant). Batches are emitted in order, and batch i's RNG is
// seeded from (epoch seed, i) alone, so the thread count changes nothing.
//
// C API (ctypes-friendly): see pwg_loader_* below. Thread-safety: one
// consumer thread calling pwg_loader_next; internal pool of worker threads
// fills a bounded queue of ready batches.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct NpyInfo {
  int64_t data_offset = 0;   // byte offset of the array data
  int64_t rows = 0;          // first dim
  int64_t cols = 1;          // second dim (1 for 1-D)
  char dtype = 'f';          // 'f' = <f4, 'd' = <f8, 'h' = <i2
};

bool parse_npy_header(int fd, NpyInfo* info) {
  unsigned char magic[10];
  if (pread(fd, magic, 10, 0) != 10) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len;
  int64_t header_off;
  if (major == 1) {
    header_len = magic[8] | (magic[9] << 8);
    header_off = 10;
  } else {
    unsigned char ext[2];
    if (pread(fd, ext, 2, 10) != 2) return false;
    header_len = magic[8] | (magic[9] << 8) | (ext[0] << 16) | (ext[1] << 24);
    header_off = 12;
  }
  std::string header(header_len, '\0');
  if (pread(fd, &header[0], header_len, header_off) != (ssize_t)header_len)
    return false;
  info->data_offset = header_off + header_len;

  auto find_value = [&](const char* key) -> std::string {
    size_t p = header.find(key);
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    if (p == std::string::npos) return "";
    size_t e = header.find(',', p);
    // shape tuples contain commas; handle separately below
    return header.substr(p + 1, e - p - 1);
  };

  std::string descr = find_value("'descr'");
  if (descr.find("<f4") != std::string::npos) info->dtype = 'f';
  else if (descr.find("<f8") != std::string::npos) info->dtype = 'd';
  else if (descr.find("<i2") != std::string::npos) info->dtype = 'h';
  else return false;
  if (header.find("'fortran_order': True") != std::string::npos) return false;

  size_t sp = header.find("'shape'");
  if (sp == std::string::npos) return false;
  sp = header.find('(', sp);
  size_t se = header.find(')', sp);
  if (sp == std::string::npos || se == std::string::npos) return false;
  std::string shape = header.substr(sp + 1, se - sp - 1);
  long long d0 = 0, d1 = 1;
  int n = sscanf(shape.c_str(), "%lld, %lld", &d0, &d1);
  if (n < 1) return false;
  if (n == 1 && shape.find(',') != std::string::npos) d1 = 1;  // "(N,)"
  info->rows = d0;
  info->cols = (n >= 2) ? d1 : 1;
  return true;
}

int dtype_size(char d) { return d == 'h' ? 2 : (d == 'd' ? 8 : 4); }

// read `count` elements starting at element `start` (row-major, all cols)
// into float32 out; returns false on short read.
bool read_elems(int fd, const NpyInfo& in, int64_t start_elem,
                int64_t n_elems, float* out) {
  int es = dtype_size(in.dtype);
  int64_t nbytes = n_elems * es;
  std::vector<unsigned char> buf(nbytes);
  if (pread(fd, buf.data(), nbytes, in.data_offset + start_elem * es) !=
      (ssize_t)nbytes)
    return false;
  if (in.dtype == 'f') {
    memcpy(out, buf.data(), nbytes);
  } else if (in.dtype == 'd') {
    const double* p = reinterpret_cast<const double*>(buf.data());
    for (int64_t i = 0; i < n_elems; ++i) out[i] = (float)p[i];
  } else {
    const int16_t* p = reinterpret_cast<const int16_t*>(buf.data());
    for (int64_t i = 0; i < n_elems; ++i) out[i] = p[i] / 32768.0f;
  }
  return true;
}

struct Utt {
  std::string wave_path, feats_path;
  NpyInfo wave, feats;
};

struct Batch {
  std::vector<float> y, c, z;
};

struct Loader {
  std::vector<Utt> utts;
  int batch_size, batch_max_steps, hop, ctx, use_noise;
  int mel_dim = 0;
  int batch_max_frames, c_len;
  int n_threads, prefetch_depth;

  // epoch state
  std::vector<int> order;       // shard's utterance order this epoch
  std::atomic<int> next_batch_idx{0};
  int n_batches = 0;
  uint64_t seed, epoch_seed = 0;

  // pipeline
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<std::pair<int, Batch>> ready;  // (batch index, data)
  int emitted = 0;   // batches handed to consumer
  bool stopping = false;
  std::string error;

  ~Loader() { stop(); }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_produce.notify_all();
    cv_consume.notify_all();
    for (auto& t : workers) {
      if (t.joinable()) t.join();
    }
    workers.clear();
  }

  bool fill_one(int bidx, Batch* out) {
    std::mt19937_64 rng(epoch_seed * 0x9E3779B97F4A7C15ULL + bidx + 1);
    int frames = batch_max_frames;
    out->y.assign((size_t)batch_size * batch_max_steps, 0.f);
    out->c.assign((size_t)batch_size * c_len * mel_dim, 0.f);
    if (use_noise) out->z.resize((size_t)batch_size * batch_max_steps);
    for (int b = 0; b < batch_size; ++b) {
      const Utt& u = utts[order[(size_t)bidx * batch_size + b]];
      int64_t cl = u.feats.rows;
      int64_t lo = ctx, hi = cl - frames - ctx;  // exclusive
      int64_t start = lo + (int64_t)(rng() % (uint64_t)(hi - lo));
      int wfd = open(u.wave_path.c_str(), O_RDONLY);
      int ffd = open(u.feats_path.c_str(), O_RDONLY);
      bool ok = wfd >= 0 && ffd >= 0;
      if (ok) {
        ok = read_elems(ffd, u.feats, (start - ctx) * mel_dim,
                        (int64_t)c_len * mel_dim,
                        &out->c[(size_t)b * c_len * mel_dim]);
      }
      if (ok) {
        // audio window, clamped to the alignment invariant len(y)=len(c)*hop
        int64_t y0 = start * hop;
        int64_t avail = std::min<int64_t>(u.wave.rows, cl * hop) - y0;
        int64_t want = std::min<int64_t>(batch_max_steps, avail);
        float* dst = &out->y[(size_t)b * batch_max_steps];
        ok = want > 0 && read_elems(wfd, u.wave, y0, want, dst);
        for (int64_t i = want; i < batch_max_steps && ok; ++i)
          dst[i] = dst[want - 1];  // edge-pad short tails
      }
      if (wfd >= 0) close(wfd);
      if (ffd >= 0) close(ffd);
      if (!ok) return false;
    }
    if (use_noise) {
      std::normal_distribution<float> nd(0.f, 1.f);
      for (auto& v : out->z) v = nd(rng);
    }
    return true;
  }

  void worker_loop() {
    for (;;) {
      int bidx = next_batch_idx.fetch_add(1);
      if (bidx >= n_batches) return;
      Batch b;
      bool ok = fill_one(bidx, &b);
      std::unique_lock<std::mutex> lk(mu);
      if (!ok) {
        error = "read failed in batch " + std::to_string(bidx);
        stopping = true;
        cv_consume.notify_all();
        return;
      }
      cv_produce.wait(lk, [&] {
        // always admit the batch the consumer needs next, even when the
        // queue is full of later batches — otherwise a full queue of
        // out-of-order results deadlocks against the in-order consumer
        return stopping || bidx == emitted ||
               (int)ready.size() < prefetch_depth;
      });
      if (stopping) return;
      ready.emplace_back(bidx, std::move(b));
      cv_consume.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* pwg_loader_create(const char** wave_paths, const char** feats_paths,
                        int n_utts, int batch_size, int batch_max_steps,
                        int hop_size, int ctx, int use_noise, int n_threads,
                        int prefetch_depth, uint64_t seed) {
  auto* L = new Loader();
  L->batch_size = batch_size;
  L->batch_max_steps = batch_max_steps - (batch_max_steps % hop_size);
  L->hop = hop_size;
  L->ctx = ctx;
  L->use_noise = use_noise;
  L->n_threads = n_threads > 0 ? n_threads : 4;
  L->prefetch_depth = prefetch_depth > 0 ? prefetch_depth : 4;
  L->seed = seed;
  L->batch_max_frames = L->batch_max_steps / hop_size;
  L->c_len = L->batch_max_frames + 2 * ctx;
  int threshold = L->batch_max_frames + 2 * ctx;
  for (int i = 0; i < n_utts; ++i) {
    Utt u;
    u.wave_path = wave_paths[i];
    u.feats_path = feats_paths[i];
    int wfd = open(u.wave_path.c_str(), O_RDONLY);
    int ffd = open(u.feats_path.c_str(), O_RDONLY);
    bool ok = wfd >= 0 && ffd >= 0 && parse_npy_header(wfd, &u.wave) &&
              parse_npy_header(ffd, &u.feats);
    if (wfd >= 0) close(wfd);
    if (ffd >= 0) close(ffd);
    if (!ok) {
      delete L;
      return nullptr;
    }
    if (L->mel_dim == 0) L->mel_dim = (int)u.feats.cols;
    if ((int)u.feats.cols != L->mel_dim) {
      delete L;
      return nullptr;
    }
    if (u.feats.rows > threshold) L->utts.push_back(std::move(u));
  }
  if (L->utts.empty()) {
    delete L;
    return nullptr;
  }
  return L;
}

int pwg_loader_mel_dim(void* h) { return ((Loader*)h)->mel_dim; }

int pwg_loader_num_utts(void* h) { return (int)((Loader*)h)->utts.size(); }

int pwg_loader_start_epoch(void* h, int epoch, int shard_index,
                           int num_shards, int shuffle) {
  auto* L = (Loader*)h;
  L->stop();
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stopping = false;
    L->ready.clear();
    L->emitted = 0;
    L->error.clear();
  }
  int n = (int)L->utts.size();
  std::vector<int> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;
  L->epoch_seed = L->seed + (uint64_t)epoch;
  if (shuffle) {
    std::mt19937_64 rng(L->epoch_seed);
    for (int i = n - 1; i > 0; --i) {
      int j = (int)(rng() % (uint64_t)(i + 1));
      std::swap(idx[i], idx[j]);
    }
  }
  // pad to equal shard sizes (DistributedSampler-style wrap-around), with at
  // least one batch per shard
  int per_shard = std::max((n + num_shards - 1) / num_shards, L->batch_size);
  int total = per_shard * num_shards;
  L->order.clear();
  for (int i = shard_index; i < total; i += num_shards)
    L->order.push_back(idx[i % n]);
  L->n_batches = (int)L->order.size() / L->batch_size;
  L->next_batch_idx = 0;
  for (int t = 0; t < L->n_threads; ++t)
    L->workers.emplace_back([L] { L->worker_loop(); });
  return L->n_batches;
}

int pwg_loader_num_batches(void* h) { return ((Loader*)h)->n_batches; }

// Blocks until the next in-order batch is ready. Returns 1 and fills the
// buffers, 0 at epoch end, -1 on error.
int pwg_loader_next(void* h, float* y, float* c, float* z) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->emitted >= L->n_batches) return 0;
  int want = L->emitted;
  for (;;) {
    if (!L->error.empty()) return -1;
    for (auto it = L->ready.begin(); it != L->ready.end(); ++it) {
      if (it->first == want) {
        Batch b = std::move(it->second);
        L->ready.erase(it);
        L->emitted++;
        L->cv_produce.notify_all();
        lk.unlock();
        memcpy(y, b.y.data(), b.y.size() * sizeof(float));
        memcpy(c, b.c.data(), b.c.size() * sizeof(float));
        if (L->use_noise && z) memcpy(z, b.z.data(), b.z.size() * sizeof(float));
        return 1;
      }
    }
    L->cv_consume.wait(lk);
    if (L->stopping && L->error.empty() && L->ready.empty()) return 0;
  }
}

void pwg_loader_destroy(void* h) { delete (Loader*)h; }

}  // extern "C"
