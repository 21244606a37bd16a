// Native host runtime for alego_tpu_torch: fast point-cloud IO + threaded
// prefetching frame loader (a copy of the reference package's runtime).
//
// The reference's runtime layer is roscpp/nodelet transport + pcl IO
// (serialization copies at every stage boundary, SURVEY §5.8).  Here the
// native layer does what natives are good at — disk IO, parsing, and
// latency-hiding prefetch threads — and hands dense float32 buffers to the
// pipeline with zero further copies.  Exposed via a C ABI for ctypes.
//
// Built at first use by alego_tpu_torch/runtime/io_native.py into
// alego_tpu_torch/_build/ (c++ -O2 -std=c++17 -fPIC -shared -pthread).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Cloud {
  std::vector<float> data;  // n * stride floats
  int64_t n = 0;
  int stride = 0;
};

// ---------------------------------------------------------------------------
// PCD parsing (ascii + binary, F4 fields)
// ---------------------------------------------------------------------------

bool read_pcd_file(const std::string& path, Cloud& out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::string line;
  std::vector<int> sizes;
  std::vector<char> types;
  std::vector<int> counts;
  int64_t n_points = 0;
  std::string mode;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    char key[32] = {0};
    if (std::sscanf(line.c_str(), "%31s", key) != 1) continue;
    std::string k(key);
    if (k == "SIZE" || k == "TYPE" || k == "COUNT") {
      std::string rest = line.substr(k.size());
      const char* p = rest.c_str();
      char tok[32];
      int off = 0, used = 0;
      while (std::sscanf(p + off, "%31s%n", tok, &used) == 1) {
        off += used;
        if (k == "SIZE") sizes.push_back(std::atoi(tok));
        if (k == "TYPE") types.push_back(tok[0]);
        if (k == "COUNT") counts.push_back(std::atoi(tok));
      }
    } else if (k == "POINTS") {
      std::sscanf(line.c_str(), "POINTS %ld", &n_points);
    } else if (k == "DATA") {
      char m[32] = {0};
      std::sscanf(line.c_str(), "DATA %31s", m);
      mode = m;
      break;
    }
  }
  if (sizes.empty() || n_points <= 0) return false;
  if (counts.empty()) counts.assign(sizes.size(), 1);
  int n_cols = 0;
  int row_bytes = 0;
  for (size_t i = 0; i < sizes.size(); ++i) {
    n_cols += counts[i];
    row_bytes += sizes[i] * counts[i];
  }
  out.n = n_points;
  out.stride = n_cols;
  out.data.resize(static_cast<size_t>(n_points) * n_cols);

  if (mode == "ascii") {
    for (int64_t i = 0; i < n_points; ++i)
      for (int c = 0; c < n_cols; ++c) {
        double v;
        if (!(f >> v)) return false;
        out.data[i * n_cols + c] = static_cast<float>(v);
      }
    return true;
  }
  if (mode == "binary") {
    std::vector<char> row(row_bytes);
    for (int64_t i = 0; i < n_points; ++i) {
      if (!f.read(row.data(), row_bytes)) return false;
      int off = 0, col = 0;
      for (size_t fi = 0; fi < sizes.size(); ++fi) {
        for (int cc = 0; cc < counts[fi]; ++cc) {
          float v = 0.f;
          if (types[fi] == 'F' && sizes[fi] == 4) {
            std::memcpy(&v, row.data() + off, 4);
          } else if (types[fi] == 'F' && sizes[fi] == 8) {
            double d;
            std::memcpy(&d, row.data() + off, 8);
            v = static_cast<float>(d);
          } else if (sizes[fi] == 4) {
            int32_t x;
            std::memcpy(&x, row.data() + off, 4);
            v = static_cast<float>(x);
          } else if (sizes[fi] == 2) {
            int16_t x;
            std::memcpy(&x, row.data() + off, 2);
            v = static_cast<float>(x);
          } else if (sizes[fi] == 1) {
            v = static_cast<float>(row[off]);
          }
          out.data[i * n_cols + col] = v;
          off += sizes[fi];
          ++col;
        }
      }
    }
    return true;
  }
  return false;  // binary_compressed unsupported
}

// ---------------------------------------------------------------------------
// Threaded prefetching frame loader
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  size_t next_submit = 0;           // next file index to hand to a worker
  std::deque<std::pair<size_t, Cloud>> ready;
  size_t next_emit = 0;             // next file index to hand to the consumer
  size_t queue_cap = 4;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (stop || next_submit >= paths.size()) return;
        idx = next_submit++;
      }
      Cloud c;
      bool ok = false;
      const std::string& p = paths[idx];
      if (p.size() > 4 && p.substr(p.size() - 4) == ".bin") {
        std::ifstream f(p, std::ios::binary | std::ios::ate);
        if (f) {
          auto bytes = static_cast<size_t>(f.tellg());
          f.seekg(0);
          c.n = static_cast<int64_t>(bytes / (4 * sizeof(float)));
          c.stride = 4;
          c.data.resize(c.n * 4);
          ok = bool(f.read(reinterpret_cast<char*>(c.data.data()),
                           c.n * 4 * sizeof(float)));
        }
      } else {
        ok = read_pcd_file(p, c);
      }
      if (!ok) {
        c.n = 0;
        c.stride = 0;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return stop || ready.size() < queue_cap ||
                                     idx == next_emit; });
      if (stop) return;
      ready.emplace_back(idx, std::move(c));
      cv_ready.notify_all();
    }
  }

  bool pop(size_t want, Cloud& out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] {
      if (stop) return true;
      for (auto& kv : ready)
        if (kv.first == want) return true;
      return false;
    });
    if (stop) return false;
    for (auto it = ready.begin(); it != ready.end(); ++it) {
      if (it->first == want) {
        out = std::move(it->second);
        ready.erase(it);
        next_emit = want + 1;
        cv_space.notify_all();
        return true;
      }
    }
    return false;
  }
};

Cloud g_last_cloud;  // single-threaded consumer staging buffer

}  // namespace

extern "C" {

// ---- one-shot PCD read ----
// Returns number of points (stride via out_stride); data fetched with
// alego_copy_last. Returns -1 on failure.
int64_t alego_read_pcd(const char* path, int* out_stride) {
  Cloud c;
  if (!read_pcd_file(path, c)) return -1;
  *out_stride = c.stride;
  g_last_cloud = std::move(c);
  return g_last_cloud.n;
}

void alego_copy_last(float* dst) {
  std::memcpy(dst, g_last_cloud.data.data(),
              g_last_cloud.data.size() * sizeof(float));
}

// ---- PCD write (binary, float32 fields) ----
int alego_write_pcd(const char* path, const float* data, int64_t n, int cols) {
  std::ofstream f(path, std::ios::binary);
  if (!f) return -1;
  const char* names[4] = {"x", "y", "z", "intensity"};
  std::string fields, sizes, types, counts;
  for (int c = 0; c < cols && c < 4; ++c) {
    fields += std::string(c ? " " : "") + names[c];
    sizes += c ? " 4" : "4";
    types += c ? " F" : "F";
    counts += c ? " 1" : "1";
  }
  f << "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
    << "FIELDS " << fields << "\nSIZE " << sizes << "\nTYPE " << types
    << "\nCOUNT " << counts << "\nWIDTH " << n
    << "\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS " << n
    << "\nDATA binary\n";
  f.write(reinterpret_cast<const char*>(data), n * cols * sizeof(float));
  return f ? 0 : -1;
}

// ---- prefetching loader ----
void* alego_loader_create(const char** paths, int64_t n_paths, int n_threads,
                          int queue_cap) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->queue_cap = queue_cap > 0 ? queue_cap : 4;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocks until frame ``idx`` is loaded; returns point count (stride via
// out_stride), or -1. Data fetched with alego_loader_copy.
int64_t alego_loader_get(void* handle, int64_t idx, int* out_stride) {
  auto* L = static_cast<Loader*>(handle);
  Cloud c;
  if (!L->pop(static_cast<size_t>(idx), c)) return -1;
  *out_stride = c.stride;
  g_last_cloud = std::move(c);
  return g_last_cloud.n;
}

void alego_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_ready.notify_all();
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
