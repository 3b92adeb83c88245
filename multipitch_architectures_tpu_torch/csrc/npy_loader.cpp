// Native data loader: mmap-backed .npy reading + multithreaded context-
// window batch assembly.
//
// Host-side replacement for the reference's torch DataLoader worker pool
// (16 worker processes slicing HCQT windows, exp180d...py:281-288): files
// are mmapped once, and each batch is assembled into caller-provided
// buffers by a thread team doing cache-friendly strided copies. Used by
// multipitch_architectures_tpu_torch.io.native_loader (ctypes) when HCQT
// corpora exceed device memory; the device-resident TrainPipeline is the
// fast path otherwise.
//
// .npy layout expectations (reference notebook 01 outputs):
//   HCQT  : (F=216, T, C=6) float32/float64, C-order
//   annot : (P=128, T)      float32/float64, C-order
// Window (X, y) semantics match dataset_context (hcqt_datasets.py:67-75):
//   X[c][t][f] = hcqt[f][center-half+t][c],  shape (C, context, F)
//   y[p]       = annot[target_lo + p][center], shape (target_hi-target_lo)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct NpyArray {
  void* map_base = nullptr;
  size_t map_len = 0;
  const char* data = nullptr;  // first element
  bool is_f64 = false;
  std::vector<long> shape;

  ~NpyArray() {
    if (map_base) munmap(map_base, map_len);
  }
};

// Parse a .npy v1/v2 header and mmap the file. Returns false on error.
bool open_npy(const char* path, NpyArray* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return false;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return false;
  const unsigned char* p = static_cast<const unsigned char*>(base);
  if (st.st_size < 10 || memcmp(p, "\x93NUMPY", 6) != 0) {
    munmap(base, st.st_size);
    return false;
  }
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    header_len = p[8] | (p[9] << 8) | (p[10] << 16)
                 | (static_cast<size_t>(p[11]) << 24);
    header_off = 12;
  }
  std::string header(reinterpret_cast<const char*>(p) + header_off,
                     header_len);
  // descr
  size_t d = header.find("descr");
  if (d == std::string::npos) {
    munmap(base, st.st_size);
    return false;
  }
  bool f64;
  if (header.find("<f4", d) != std::string::npos) {
    f64 = false;
  } else if (header.find("<f8", d) != std::string::npos) {
    f64 = true;
  } else {
    munmap(base, st.st_size);
    return false;
  }
  if (header.find("'fortran_order': True") != std::string::npos) {
    munmap(base, st.st_size);
    return false;
  }
  // shape tuple
  size_t s0 = header.find('(');
  size_t s1 = header.find(')', s0);
  if (s0 == std::string::npos || s1 == std::string::npos) {
    munmap(base, st.st_size);
    return false;
  }
  std::vector<long> shape;
  long cur = -1;
  for (size_t i = s0 + 1; i <= s1; ++i) {
    char c = header[i];
    if (c >= '0' && c <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    } else if (cur >= 0) {
      shape.push_back(cur);
      cur = -1;
    }
  }
  out->map_base = base;
  out->map_len = st.st_size;
  out->data = reinterpret_cast<const char*>(p) + header_off + header_len;
  out->is_f64 = f64;
  out->shape = std::move(shape);
  return true;
}

inline float load_elem(const NpyArray& a, size_t idx) {
  if (a.is_f64)
    return static_cast<float>(
        reinterpret_cast<const double*>(a.data)[idx]);
  return reinterpret_cast<const float*>(a.data)[idx];
}

struct FileEntry {
  NpyArray hcqt;   // (F, T, C)
  NpyArray annot;  // (P, T)
  long t_frames = 0;
  long window_offset = 0;  // first global window index of this file
  long n_windows = 0;
};

struct Dataset {
  std::vector<FileEntry*> files;
  int context = 75;
  int stride = 50;
  int target_lo = 24;
  int target_hi = 96;
  long total_windows = 0;
  std::string error;
};

// Copy one window into x_out (C, context, F) and y_out (n_bins).
void fill_one(const Dataset& ds, long widx, float* x_out, float* y_out) {
  // locate file by global window index (files sorted by window_offset)
  size_t lo = 0, hi = ds.files.size();
  while (hi - lo > 1) {
    size_t mid = (lo + hi) / 2;
    if (ds.files[mid]->window_offset <= widx)
      lo = mid;
    else
      hi = mid;
  }
  const FileEntry& fe = *ds.files[lo];
  long local = widx - fe.window_offset;
  long center = local * ds.stride + ds.context / 2;
  long start = center - ds.context / 2;

  const long f_bins = fe.hcqt.shape[0];
  const long t_frames = fe.hcqt.shape[1];
  const long chans = fe.hcqt.shape[2];
  // src[f][t][c] -> dst[c][t][f]
  if (!fe.hcqt.is_f64) {
    const float* src = reinterpret_cast<const float*>(fe.hcqt.data);
    for (long c = 0; c < chans; ++c) {
      for (long t = 0; t < ds.context; ++t) {
        const float* col = src + (start + t) * chans + c;
        float* dst = x_out + (c * ds.context + t) * f_bins;
        for (long f = 0; f < f_bins; ++f) {
          dst[f] = col[f * t_frames * chans];
        }
      }
    }
  } else {
    for (long c = 0; c < chans; ++c)
      for (long t = 0; t < ds.context; ++t)
        for (long f = 0; f < f_bins; ++f)
          x_out[(c * ds.context + t) * f_bins + f] = load_elem(
              fe.hcqt, (f * t_frames + start + t) * chans + c);
  }
  const long t_annot = fe.annot.shape[1];
  for (long p = ds.target_lo; p < ds.target_hi; ++p) {
    y_out[p - ds.target_lo] = load_elem(fe.annot, p * t_annot + center);
  }
}

}  // namespace

extern "C" {

Dataset* mpe_dataset_create(int context, int stride, int target_lo,
                            int target_hi) {
  auto* ds = new Dataset;
  ds->context = context;
  ds->stride = stride;
  ds->target_lo = target_lo;
  ds->target_hi = target_hi;
  return ds;
}

// Returns the file's window count, or -1 on error.
long mpe_dataset_add_file(Dataset* ds, const char* hcqt_path,
                          const char* annot_path) {
  auto* fe = new FileEntry;
  if (!open_npy(hcqt_path, &fe->hcqt) || fe->hcqt.shape.size() != 3) {
    ds->error = std::string("bad hcqt npy: ") + hcqt_path;
    delete fe;
    return -1;
  }
  if (!open_npy(annot_path, &fe->annot) || fe->annot.shape.size() != 2) {
    ds->error = std::string("bad annot npy: ") + annot_path;
    delete fe;
    return -1;
  }
  if (fe->hcqt.shape[1] != fe->annot.shape[1]) {
    ds->error = "hcqt/annot frame count mismatch";
    delete fe;
    return -1;
  }
  fe->t_frames = fe->hcqt.shape[1];
  fe->n_windows = (fe->t_frames - ds->context) / ds->stride;
  if (fe->n_windows < 0) fe->n_windows = 0;
  fe->window_offset = ds->total_windows;
  ds->total_windows += fe->n_windows;
  ds->files.push_back(fe);
  return fe->n_windows;
}

long mpe_dataset_num_windows(const Dataset* ds) { return ds->total_windows; }

const char* mpe_dataset_error(const Dataset* ds) {
  return ds->error.c_str();
}

// Fill x_out (n, C, context, F) and y_out (n, target_hi-target_lo) for the
// given global window indices, using n_threads worker threads.
int mpe_dataset_fill_batch(const Dataset* ds, const long* indices, long n,
                           float* x_out, float* y_out, int n_threads) {
  if (ds->files.empty()) return -1;
  const long f_bins = ds->files[0]->hcqt.shape[0];
  const long chans = ds->files[0]->hcqt.shape[2];
  const long x_stride = chans * ds->context * f_bins;
  const long y_stride = ds->target_hi - ds->target_lo;
  n_threads = std::max(1, std::min<int>(n_threads, n));

  auto work = [&](long b0, long b1) {
    for (long b = b0; b < b1; ++b) {
      if (indices[b] < 0 || indices[b] >= ds->total_windows) continue;
      fill_one(*ds, indices[b], x_out + b * x_stride, y_out + b * y_stride);
    }
  };
  if (n_threads == 1) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    long per = (n + n_threads - 1) / n_threads;
    for (int i = 0; i < n_threads; ++i) {
      long b0 = i * per, b1 = std::min(n, b0 + per);
      if (b0 >= b1) break;
      threads.emplace_back(work, b0, b1);
    }
    for (auto& t : threads) t.join();
  }
  return 0;
}

void mpe_dataset_destroy(Dataset* ds) {
  for (auto* f : ds->files) delete f;
  delete ds;
}

}  // extern "C"
