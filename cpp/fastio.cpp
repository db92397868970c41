// Native IO runtime for the ocean framework.
//
// The reference's IO layer is Fortran MPI-IO (tools/io.f90: per-block
// subarray collectives against flat real4 record files) plus ASCII mask
// parsing (read_global_mask). With one process per host, the native
// layer is a straight high-throughput implementation of the same file
// formats:
//
//  - ASCII land/sea masks: one header line, ny rows of nx digits,
//    top row first (io.f90:36-82 format);
//  - direct-access float32 records of the (nx-4)x(ny-4) interior in
//    Fortran (column-major) order with undef at land
//    (tools/io.f90 write_data / legacy input_output_data.f90);
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
// Threaded record packing: the interior gather/scatter + undef masking
// runs across hardware threads, overlapping with device compute from the
// async output path.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// Parse an ASCII mask file into out[nx*ny] (row-major [m*ny + n], 0-based,
// matching the numpy (nx, ny) layout). Returns 0 on success, negative on
// error. Rows in the file are stored top (n = ny-1) first.
int fastio_read_mask(const char* path, int64_t nx, int64_t ny,
                     int32_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return -2;
  }
  fclose(f);

  // split lines
  std::vector<std::pair<const char*, long>> lines;
  const char* p = buf.data();
  const char* end = p + size;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    long len = nl ? nl - p : end - p;
    if (len > 0 && p[len - 1] == '\r') len--;
    lines.emplace_back(p, len);
    p = nl ? nl + 1 : end;
  }
  // drop the header line, then skip empties
  std::vector<std::pair<const char*, long>> rows;
  for (size_t i = 1; i < lines.size(); i++) {
    bool blank = true;
    for (long j = 0; j < lines[i].second; j++)
      if (lines[i].first[j] != ' ') { blank = false; break; }
    if (!blank) rows.push_back(lines[i]);
  }
  if ((int64_t)rows.size() < ny) return -3;

  for (int64_t i = 0; i < ny; i++) {
    int64_t n = ny - 1 - i;  // first data row is the top
    if (rows[i].second < nx) return -4;
    const char* r = rows[i].first;
    for (int64_t m = 0; m < nx; m++) out[m * ny + n] = r[m] - '0';
  }
  return 0;
}

// Pack the interior of field[nx*ny] (row-major) into rec[(nx-4)*(ny-4)]
// in Fortran order (m fastest), applying undef where lu <= 0.5.
// Multithreaded over columns.
void fastio_pack_interior(const double* field, const float* lu,
                          int64_t nx, int64_t ny, float undef,
                          float* rec) {
  const int64_t inx = nx - 4, iny = ny - 4;
  int nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  auto work = [&](int64_t j0, int64_t j1) {
    for (int64_t j = j0; j < j1; j++) {       // interior column j -> n=j+2
      for (int64_t i = 0; i < inx; i++) {     // interior row i -> m=i+2
        int64_t src = (i + 2) * ny + (j + 2);
        rec[j * inx + i] =
            lu[src] > 0.5f ? (float)field[src] : undef;
      }
    }
  };
  std::vector<std::thread> ts;
  int64_t chunk = (iny + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int64_t j0 = t * chunk;
    int64_t j1 = j0 + chunk < iny ? j0 + chunk : iny;
    if (j0 >= j1) break;
    ts.emplace_back(work, j0, j1);
  }
  for (auto& t : ts) t.join();
}

// Write record nrec (1-based) of length recl floats at its offset,
// extending the file with undef records if needed. Returns 0 or negative.
int fastio_write_record(const char* path, int64_t nrec, const float* rec,
                        int64_t recl, float undef) {
  int fd = open(path, O_RDWR | O_CREAT, 0644);
  if (fd < 0) return -1;
  struct stat st;
  fstat(fd, &st);
  int64_t bytes = recl * 4;
  int64_t offset = (nrec - 1) * bytes;
  if (st.st_size < offset) {
    // pre-fill the gap with undef
    std::vector<float> fill(recl, undef);
    for (int64_t pos = st.st_size; pos < offset; pos += bytes) {
      int64_t n = bytes < offset - pos ? bytes : offset - pos;
      if (pwrite(fd, fill.data(), n, pos) != n) { close(fd); return -2; }
    }
  }
  int rc = pwrite(fd, rec, bytes, offset) == bytes ? 0 : -3;
  close(fd);
  return rc;
}

// Read record nrec (1-based) of recl floats. Returns 0 or negative.
int fastio_read_record(const char* path, int64_t nrec, float* rec,
                       int64_t recl) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  int64_t bytes = recl * 4;
  int rc = pread(fd, rec, bytes, (nrec - 1) * bytes) == bytes ? 0 : -2;
  close(fd);
  return rc;
}

}  // extern "C"
