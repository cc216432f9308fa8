// traj_loader — native trajectory reader for molann_tpu_torch (a copy of
// the JAX package's native/traj_loader.cpp, built with g++ at first use by
// molann_tpu_torch/io/native_loader.py).
//
// The fused TPU kernels consume packed float32 frame batches at >10 GB/s;
// a Python mmap + fancy-index pipeline cannot feed that. This library
// memory-maps trajectory files and provides:
//
//   - zero-copy open (mmap, no read until touched)
//   - multi-threaded batch gather into a caller-provided packed buffer
//   - asynchronous prefetch (madvise WILLNEED + page touching) so the
//     next batch's pages are resident before the gather
//
// Formats (auto-detected by magic):
//   - .npy  — shape [n_frames, n_atoms, 3] or packed [n_frames, 3n],
//             dtype <f4, C-order (numpy format spec v1/2/3)
//   - .dcd  — CHARMM/NAMD/X-PLOR binary trajectories (little-endian,
//             32-bit Fortran record markers; fixed-atom files rejected).
//             Frames are stored as X/Y/Z component planes; the gather
//             interleaves them into the packed [3n] atom-major layout the
//             rest of the framework uses.
//   - .trr  — GROMACS full-precision trajectories (big-endian XDR;
//             float32 or float64 reals, velocities/forces skipped).
//             Variable frame sizes: a header walk at open builds a
//             frame-offset index.
//   - .xtc  — GROMACS compressed trajectories (big-endian XDR + the
//             public xdr3dfcoord adaptive-radix scheme). Decompressed
//             per frame at gather time (thread-safe, bounds-checked);
//             offset index built at open.
// The pure-Python counterpart (molann_tpu_torch/io/xdr.py) is the oracle:
// cross-language round-trip tests pin the two implementations together.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (molann_tpu_torch/io/native_loader.py). No Python.h dependency.
//
// The reference has no native components at all (SURVEY.md §2.3); this is
// the runtime-side native piece of the TPU build (data path), while the
// compute-side native pieces are the Pallas kernels.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

enum class Format { NPY, DCD, TRR, XTC, NC };

struct Loader {
  int fd = -1;
  const uint8_t* base = nullptr;   // mmap base
  size_t map_size = 0;
  Format format = Format::NPY;
  // NPY: contiguous float payload
  const float* data = nullptr;     // first element of the array payload
  // DCD: per-frame record geometry
  int64_t natoms = 0;
  size_t frame0_off = 0;
  size_t frame_stride = 0;
  size_t cell_bytes = 0;           // 0 or 48+8 (unit-cell record + markers)
  // TRR/XTC: variable frame sizes -> offset index (n_frames + 1 entries,
  // last = end of the final frame) built by a header walk at open
  std::vector<size_t> frame_off;
  // NC (Amber NetCDF-3 classic): coordinates record geometry
  size_t nc_begin = 0;      // byte offset of frame 0's coordinates
  size_t nc_recsize = 0;    // bytes per record slot (all record vars)
  size_t nc_per_rec = 0;    // bytes of coordinates within one record
  bool nc_double = false;   // NC_DOUBLE coordinates (NC_FLOAT otherwise)
  float nc_scale = 1.0f;    // coordinates scale_factor attribute
  // common
  int64_t n_frames = 0;
  int64_t floats_per_frame = 0;    // 3 * n_atoms
  // prefetch worker
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<int64_t> pending;    // frame indices to prefetch
  bool stop = false;

  // byte span of one frame's payload (for prefetch)
  const uint8_t* frame_ptr(int64_t f) const {
    if (format == Format::NPY) {
      return reinterpret_cast<const uint8_t*>(data) +
             static_cast<size_t>(f) * floats_per_frame * sizeof(float);
    }
    if (format == Format::TRR || format == Format::XTC) {
      return base + frame_off[static_cast<size_t>(f)];
    }
    if (format == Format::NC) {
      return base + nc_begin + static_cast<size_t>(f) * nc_recsize;
    }
    return base + frame0_off + static_cast<size_t>(f) * frame_stride;
  }
  size_t frame_bytes(int64_t f = 0) const {
    if (format == Format::NPY) return floats_per_frame * sizeof(float);
    if (format == Format::TRR || format == Format::XTC) {
      return frame_off[static_cast<size_t>(f) + 1] -
             frame_off[static_cast<size_t>(f)];
    }
    if (format == Format::NC) return nc_per_rec;
    return frame_stride;
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv.notify_all();
    if (worker.joinable()) worker.join();
    if (base != nullptr) munmap(const_cast<uint8_t*>(base), map_size);
    if (fd >= 0) close(fd);
  }
};

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Minimal .npy header parser (format spec v1.0/2.0/3.0). Returns payload
// offset or 0 on failure.
size_t parse_npy_header(const uint8_t* p, size_t size, Loader* L) {
  if (size < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) {
    set_error("not a .npy file");
    return 0;
  }
  const uint8_t major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    if (size < 12) {  // v2/v3 carry a 4-byte header length
      set_error("truncated .npy v2/v3 header");
      return 0;
    }
    header_len = static_cast<size_t>(p[8]) | (static_cast<size_t>(p[9]) << 8) |
                 (static_cast<size_t>(p[10]) << 16) |
                 (static_cast<size_t>(p[11]) << 24);
    header_off = 12;
  }
  if (header_off + header_len > size) {
    set_error("truncated .npy header");
    return 0;
  }
  std::string header(reinterpret_cast<const char*>(p + header_off), header_len);

  if (header.find("'<f4'") == std::string::npos &&
      header.find("'float32'") == std::string::npos) {
    set_error("dtype must be little-endian float32 ('<f4'), got: " + header);
    return 0;
  }
  if (header.find("'fortran_order': True") != std::string::npos) {
    set_error("fortran_order arrays are not supported");
    return 0;
  }
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) {
    set_error("missing shape in .npy header");
    return 0;
  }
  size_t lp = header.find('(', sp);
  size_t rp = header.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) {
    set_error("malformed shape in .npy header");
    return 0;
  }
  std::vector<int64_t> dims;
  std::string shape = header.substr(lp + 1, rp - lp - 1);
  const char* s = shape.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    dims.push_back(strtoll(s, const_cast<char**>(&s), 10));
  }
  if (dims.size() == 3 && dims[2] == 3) {
    L->n_frames = dims[0];
    L->floats_per_frame = dims[1] * 3;
  } else if (dims.size() == 2) {
    L->n_frames = dims[0];
    L->floats_per_frame = dims[1];
  } else {
    set_error("expected shape [n_frames, n_atoms, 3] or [n_frames, 3n]");
    return 0;
  }
  return header_off + header_len;
}

// CHARMM/NAMD/X-PLOR DCD header. Layout (little-endian, 32-bit Fortran
// record markers [len][payload][len]):
//   record 1 (84 bytes): "CORD" + icntrl[20]
//     icntrl[0]=NSET (frames), icntrl[8]=NAMNF (fixed atoms),
//     icntrl[10]=unit-cell flag (CHARMM), icntrl[11]=4D flag (CHARMM),
//     icntrl[19]=CHARMM version (0 => X-PLOR)
//   record 2: NTITLE + 80*NTITLE chars
//   record 3: NATOM (one int32)
//   per frame: [unit cell: 6 doubles, CHARMM w/ flag only] + X, Y, Z
//     planes (NATOM floats each).
bool parse_dcd_header(const uint8_t* p, size_t size, Loader* L) {
  if (size < 116) {
    set_error("file too small for a DCD header");
    return false;
  }
  uint32_t m0 = rd_u32(p);
  if (m0 != 84) {
    if (m0 == 0x54000000u) {  // 84 byte-swapped
      set_error("big-endian DCD files are not supported");
    } else {
      set_error("not a DCD file (bad first record marker)");
    }
    return false;
  }
  if (std::memcmp(p + 4, "CORD", 4) != 0) {
    set_error("not a coordinate DCD (missing CORD magic)");
    return false;
  }
  const uint8_t* icntrl = p + 8;
  int32_t nset = rd_i32(icntrl + 0 * 4);
  int32_t namnf = rd_i32(icntrl + 8 * 4);
  int32_t cell_flag = rd_i32(icntrl + 10 * 4);
  int32_t four_d = rd_i32(icntrl + 11 * 4);
  int32_t charmm_version = rd_i32(icntrl + 19 * 4);
  if (rd_u32(p + 4 + 84) != 84) {
    set_error("corrupt DCD header (trailing marker mismatch)");
    return false;
  }
  if (namnf != 0) {
    set_error("DCD files with fixed atoms (NAMNF != 0) are not supported");
    return false;
  }
  if (charmm_version != 0 && four_d != 0) {
    set_error("4-dimensional CHARMM DCD files are not supported");
    return false;
  }
  size_t off = 4 + 84 + 4;

  // title record
  if (off + 8 > size) {
    set_error("truncated DCD title record");
    return false;
  }
  uint32_t tlen = rd_u32(p + off);
  if (off + 8 + tlen > size || rd_u32(p + off + 4 + tlen) != tlen) {
    set_error("corrupt DCD title record");
    return false;
  }
  off += 8 + tlen;

  // natoms record
  if (off + 12 > size || rd_u32(p + off) != 4 ||
      rd_u32(p + off + 8) != 4) {
    set_error("corrupt DCD NATOM record");
    return false;
  }
  int32_t natoms = rd_i32(p + off + 4);
  if (natoms <= 0) {
    set_error("DCD NATOM must be positive");
    return false;
  }
  off += 12;

  L->format = Format::DCD;
  L->natoms = natoms;
  L->floats_per_frame = 3 * static_cast<int64_t>(natoms);
  L->cell_bytes =
      (charmm_version != 0 && cell_flag != 0) ? (8 + 6 * sizeof(double)) : 0;
  const size_t plane = 8 + static_cast<size_t>(natoms) * sizeof(float);
  L->frame_stride = L->cell_bytes + 3 * plane;
  L->frame0_off = off;

  const int64_t avail =
      static_cast<int64_t>((size - off) / L->frame_stride);
  L->n_frames = (nset > 0 && nset < avail) ? nset : avail;
  if (L->n_frames <= 0) {
    set_error("DCD contains no complete frames");
    return false;
  }
  // validate the first frame's record markers
  const uint8_t* f0 = p + off + L->cell_bytes;
  for (int c = 0; c < 3; c++) {
    const uint8_t* rec = f0 + c * plane;
    if (rd_u32(rec) != static_cast<uint32_t>(natoms) * 4 ||
        rd_u32(rec + 4 + natoms * 4) != static_cast<uint32_t>(natoms) * 4) {
      set_error("corrupt DCD coordinate record markers");
      return false;
    }
  }
  return true;
}

// Interleave one DCD frame's X/Y/Z planes into packed atom-major [3n].
void gather_dcd_frame(const Loader* L, int64_t f, float* out) {
  const uint8_t* base = L->frame_ptr(f) + L->cell_bytes;
  const size_t plane = 8 + static_cast<size_t>(L->natoms) * sizeof(float);
  const float* X = reinterpret_cast<const float*>(base + 4);
  const float* Y = reinterpret_cast<const float*>(base + plane + 4);
  const float* Z = reinterpret_cast<const float*>(base + 2 * plane + 4);
  for (int64_t a = 0; a < L->natoms; a++) {
    out[3 * a + 0] = X[a];
    out[3 * a + 1] = Y[a];
    out[3 * a + 2] = Z[a];
  }
}

// ---------------------------------------------------------------------------
// GROMACS TRR / XTC (big-endian XDR)
// ---------------------------------------------------------------------------

uint32_t rd_be_u32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

int32_t rd_be_i32(const uint8_t* p) {
  return static_cast<int32_t>(rd_be_u32(p));
}

float rd_be_f32(const uint8_t* p) {
  uint32_t v = rd_be_u32(p);
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}

double rd_be_f64(const uint8_t* p) {
  uint64_t v = (static_cast<uint64_t>(rd_be_u32(p)) << 32) | rd_be_u32(p + 4);
  double d;
  std::memcpy(&d, &v, 8);
  return d;
}

constexpr int32_t kTrrMagic = 1993;
constexpr int32_t kXtcMagic = 1995;

// One TRR frame header, parsed from `off`. On success fills the x-block
// offset/real-width and the end-of-frame offset.
struct TrrFrame {
  size_t x_off;
  int real_width;  // 4 or 8
  int32_t natoms;
  size_t end;
};

bool parse_trr_frame(const uint8_t* p, size_t size, size_t off,
                     TrrFrame* out) {
  if (off + 12 > size || rd_be_i32(p + off) != kTrrMagic) {
    set_error("bad TRR frame magic");
    return false;
  }
  // version string: int(len+1), then XDR string (int len, bytes, pad to 4)
  int32_t slen = rd_be_i32(p + off + 8);  // the XDR length (without NUL)
  if (slen < 0 || slen > 256) {
    set_error("corrupt TRR version string");
    return false;
  }
  size_t o = off + 12 + ((static_cast<size_t>(slen) + 3) / 4) * 4;
  if (o + 52 > size) {
    set_error("truncated TRR header");
    return false;
  }
  int32_t box_size = rd_be_i32(p + o + 2 * 4);
  int32_t vir_size = rd_be_i32(p + o + 3 * 4);
  int32_t pres_size = rd_be_i32(p + o + 4 * 4);
  int32_t x_size = rd_be_i32(p + o + 7 * 4);
  int32_t v_size = rd_be_i32(p + o + 8 * 4);
  int32_t f_size = rd_be_i32(p + o + 9 * 4);
  int32_t natoms = rd_be_i32(p + o + 10 * 4);
  o += 52;
  if (natoms <= 0 || x_size <= 0) {
    set_error("TRR frame carries no coordinates");
    return false;
  }
  // Negative section sizes would wrap around when widened to size_t and can
  // relocate x_off/end "in bounds" onto the wrong bytes — reject outright.
  if (box_size < 0 || vir_size < 0 || pres_size < 0 || v_size < 0 ||
      f_size < 0) {
    set_error("corrupt TRR sizes (negative section size)");
    return false;
  }
  int width = box_size ? box_size / 9 : x_size / (3 * natoms);
  if (width != 4 && width != 8) {
    set_error("corrupt TRR sizes (unrecognized real width)");
    return false;
  }
  // The x block must hold exactly 3*natoms reals: gather_trr_frame reads
  // 3*natoms*width bytes from x_off, so a header whose natoms outruns its
  // x_size (e.g. claims 50M atoms over a 24-byte payload) would read far
  // past the mmap. Same check for the optional v/f blocks.
  const int64_t want = 3ll * natoms * width;
  if (x_size != want || (v_size != 0 && v_size != want) ||
      (f_size != 0 && f_size != want)) {
    set_error("corrupt TRR sizes (x/v/f size does not match natoms)");
    return false;
  }
  o += 2 * static_cast<size_t>(width);  // t, lambda
  o += static_cast<size_t>(box_size) + vir_size + pres_size;
  out->x_off = o;
  out->real_width = width;
  out->natoms = natoms;
  out->end = o + static_cast<size_t>(x_size) + v_size + f_size;
  if (out->end > size) {
    set_error("truncated TRR frame");
    return false;
  }
  return true;
}

bool parse_trr_header(const uint8_t* p, size_t size, Loader* L) {
  L->format = Format::TRR;
  size_t off = 0;
  TrrFrame fr;
  while (off + 4 <= size) {
    if (!parse_trr_frame(p, size, off, &fr)) {
      if (L->frame_off.empty()) return false;  // first frame must parse
      break;  // trailing garbage / partial frame: keep complete frames
    }
    if (L->frame_off.empty()) {
      L->natoms = fr.natoms;
      L->floats_per_frame = 3 * static_cast<int64_t>(fr.natoms);
    } else if (fr.natoms != L->natoms) {
      set_error("TRR atom count changes mid-file");
      return false;
    }
    L->frame_off.push_back(off);
    off = fr.end;
  }
  if (L->frame_off.empty()) {
    set_error("TRR contains no complete frames");
    return false;
  }
  L->frame_off.push_back(off);
  L->n_frames = static_cast<int64_t>(L->frame_off.size()) - 1;
  return true;
}

bool gather_trr_frame(const Loader* L, int64_t f, float* out) {
  TrrFrame fr;
  // re-parse the (tiny) header: frames may mix float/double widths.
  // The frame parsed at open time, but never trust a stale/aliased mmap:
  // using an uninitialized TrrFrame on failure would read wild offsets.
  if (!parse_trr_frame(L->base, L->map_size, L->frame_off[f], &fr)) {
    return false;
  }
  const uint8_t* x = L->base + fr.x_off;
  const int64_t n3 = L->floats_per_frame;
  if (fr.real_width == 4) {
    for (int64_t k = 0; k < n3; k++) out[k] = rd_be_f32(x + 4 * k);
  } else {
    for (int64_t k = 0; k < n3; k++) {
      out[k] = static_cast<float>(rd_be_f64(x + 8 * k));
    }
  }
  return true;
}

// --- xdr3dfcoord decompression (the public GROMACS XTC scheme) ---

constexpr int kFirstIdx = 9;
constexpr int kMagicInts[] = {
    0,       0,       0,       0,       0,        0,        0,
    0,       0,       8,       10,      12,       16,       20,
    25,      32,      40,      50,      64,       80,       101,
    128,     161,     203,     256,     322,      406,      512,
    645,     812,     1024,    1290,    1625,     2048,     2580,
    3250,    4096,    5060,    6501,    8192,     10321,    13003,
    16384,   20642,   26007,   32768,   41285,    52015,    65536,
    82570,   104031,  131072,  165140,  208063,   262144,   330280,
    416127,  524287,  660561,  827625,  1048576,  1321122,  1664250,
    2097152, 2642245, 3328500, 4194304, 5284491,  6657000,  8388607,
    10568983, 13314000, 16777216};
constexpr int kLastIdx = sizeof(kMagicInts) / sizeof(kMagicInts[0]);

int sizeofint(uint32_t size) {
  uint32_t num = 1;
  int bits = 0;
  while (size >= num && bits < 32) {
    bits++;
    num <<= 1;
  }
  return bits;
}

int sizeofints(int n, const uint32_t* sizes) {
  uint32_t bytes[32];
  int num_of_bytes = 1;
  bytes[0] = 1;
  for (int i = 0; i < n; i++) {
    uint32_t tmp = 0;
    int bytecnt = 0;
    for (; bytecnt < num_of_bytes; bytecnt++) {
      tmp += bytes[bytecnt] * sizes[i];
      bytes[bytecnt] = tmp & 0xff;
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[bytecnt++] = tmp & 0xff;
      tmp >>= 8;
    }
    num_of_bytes = bytecnt;
  }
  uint32_t num = 1;
  int bits = 0;
  num_of_bytes--;
  while (bytes[num_of_bytes] >= num) {
    bits++;
    num *= 2;
  }
  return bits + num_of_bytes * 8;
}

// MSB-first bit reader over the compressed blob; reads past the end
// return 0 and latch `overflow` (corrupt frames error out, never OOB).
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t cnt = 0;
  int lastbits = 0;
  uint32_t lastbyte = 0;
  bool overflow = false;

  uint8_t next_byte() {
    if (cnt >= size) {
      overflow = true;
      return 0;
    }
    return data[cnt++];
  }

  uint32_t bits(int nbits) {
    uint32_t mask = nbits >= 32 ? 0xffffffffu : ((1u << nbits) - 1);
    uint32_t num = 0;
    while (nbits >= 8) {
      lastbyte = (lastbyte << 8) | next_byte();
      num |= (lastbyte >> lastbits) << (nbits - 8);
      nbits -= 8;
    }
    if (nbits > 0) {
      if (lastbits < nbits) {
        lastbits += 8;
        lastbyte = (lastbyte << 8) | next_byte();
      }
      lastbits -= nbits;
      num |= (lastbyte >> lastbits) & ((1u << nbits) - 1);
    }
    return num & mask;
  }

  void ints(int nbits, const uint32_t* sizes, int32_t* nums) {
    uint32_t bytes[32];
    bytes[1] = bytes[2] = bytes[3] = 0;
    int num_of_bytes = 0;
    while (nbits > 8) {
      bytes[num_of_bytes++] = bits(8);
      nbits -= 8;
    }
    if (nbits > 0) bytes[num_of_bytes++] = bits(nbits);
    for (int i = 2; i > 0; i--) {
      uint32_t num = 0;
      for (int j = num_of_bytes - 1; j >= 0; j--) {
        num = (num << 8) | bytes[j];
        uint32_t q = num / sizes[i];
        bytes[j] = q;
        num -= q * sizes[i];
      }
      nums[i] = static_cast<int32_t>(num);
    }
    nums[0] = static_cast<int32_t>(bytes[0] | (bytes[1] << 8) |
                                   (bytes[2] << 16) | (bytes[3] << 24));
  }
};

// Decode one XTC frame body (starting at the precision field) into
// packed [3n] floats. Returns false (with tl error) on corruption.
bool decode_xtc_frame(const uint8_t* p, size_t body_off, size_t body_end,
                      int64_t natoms, float* out) {
  if (body_off + 36 > body_end) {
    set_error("truncated XTC frame header");
    return false;
  }
  float precision = rd_be_f32(p + body_off);
  int32_t minint[3], maxint[3];
  for (int k = 0; k < 3; k++) {
    minint[k] = rd_be_i32(p + body_off + 4 + 4 * k);
    maxint[k] = rd_be_i32(p + body_off + 16 + 4 * k);
  }
  int32_t smallidx = rd_be_i32(p + body_off + 28);
  int32_t nbytes = rd_be_i32(p + body_off + 32);
  if (smallidx < kFirstIdx || smallidx >= kLastIdx) {
    set_error("corrupt XTC smallidx");
    return false;
  }
  if (nbytes < 0 || body_off + 36 + static_cast<size_t>(nbytes) > body_end) {
    set_error("truncated XTC frame data");
    return false;
  }
  if (precision <= 0) {
    set_error("corrupt XTC precision");
    return false;
  }

  uint32_t sizeint[3], bitsizeint[3] = {0, 0, 0};
  bool big = false;
  for (int k = 0; k < 3; k++) {
    sizeint[k] = static_cast<uint32_t>(
        static_cast<int64_t>(maxint[k]) - minint[k] + 1);
    if (sizeint[k] > 0xffffff) big = true;
  }
  int bitsize = 0;
  if (big) {
    for (int k = 0; k < 3; k++) bitsizeint[k] = sizeofint(sizeint[k]);
  } else {
    bitsize = sizeofints(3, sizeint);
  }

  int smaller = kMagicInts[smallidx - 1 > kFirstIdx ? smallidx - 1
                                                    : kFirstIdx] / 2;
  int smallnum = kMagicInts[smallidx] / 2;
  uint32_t sizesmall[3] = {static_cast<uint32_t>(kMagicInts[smallidx]),
                           static_cast<uint32_t>(kMagicInts[smallidx]),
                           static_cast<uint32_t>(kMagicInts[smallidx])};
  float inv = 1.0f / precision;

  BitReader r{p + body_off + 36, static_cast<size_t>(nbytes)};
  int32_t prev[3], thisc[3];
  int run = 0;
  int64_t i = 0;
  float* o = out;
  while (i < natoms) {
    if (bitsize == 0) {
      for (int k = 0; k < 3; k++) {
        thisc[k] = static_cast<int32_t>(r.bits(bitsizeint[k]));
      }
    } else {
      r.ints(bitsize, sizeint, thisc);
    }
    for (int k = 0; k < 3; k++) {
      thisc[k] += minint[k];
      prev[k] = thisc[k];
    }
    i++;

    // flag==0 repeats the previous run length (run persists)
    int is_smaller = 0;
    if (r.bits(1)) {
      int v = static_cast<int>(r.bits(5));
      is_smaller = v % 3;
      run = v - is_smaller;
      is_smaller--;
    }
    if (run > 0) {
      if (i + run / 3 > natoms) {
        set_error("corrupt XTC run length");
        return false;
      }
      for (int k = 0; k < run; k += 3) {
        int32_t d[3];
        r.ints(smallidx, sizesmall, d);
        for (int j = 0; j < 3; j++) thisc[j] = d[j] + prev[j] - smallnum;
        if (k == 0) {
          // undo the encoder's first/second-atom interchange; prev
          // stays on the earlier atom so the next delta chains right
          for (int j = 0; j < 3; j++) {
            int32_t t = thisc[j];
            thisc[j] = prev[j];
            prev[j] = t;
          }
          for (int j = 0; j < 3; j++) *o++ = prev[j] * inv;
        } else {
          for (int j = 0; j < 3; j++) prev[j] = thisc[j];
        }
        for (int j = 0; j < 3; j++) *o++ = thisc[j] * inv;
        i++;
      }
    } else {
      for (int j = 0; j < 3; j++) *o++ = thisc[j] * inv;
    }
    smallidx += is_smaller;
    if (is_smaller < 0) {
      smallnum = smaller;
      smaller = smallidx > kFirstIdx ? kMagicInts[smallidx - 1] / 2 : 0;
    } else if (is_smaller > 0) {
      smaller = smallnum;
      smallnum = kMagicInts[smallidx] / 2;
    }
    if (smallidx < kFirstIdx || smallidx >= kLastIdx) {
      set_error("corrupt XTC smallidx adaptation");
      return false;
    }
    for (int j = 0; j < 3; j++) {
      sizesmall[j] = static_cast<uint32_t>(kMagicInts[smallidx]);
    }
    if (r.overflow) {
      set_error("XTC bitstream overrun (corrupt frame)");
      return false;
    }
  }
  return true;
}

// One XTC frame span: header (56 bytes) + payload. Fills natoms + end.
bool parse_xtc_frame(const uint8_t* p, size_t size, size_t off,
                     int32_t* natoms, size_t* end) {
  if (off + 56 > size || rd_be_i32(p + off) != kXtcMagic) {
    set_error("bad XTC frame magic");
    return false;
  }
  int32_t n = rd_be_i32(p + off + 4);
  if (n <= 0 || n != rd_be_i32(p + off + 52)) {
    set_error("corrupt XTC frame (atom count mismatch)");
    return false;
  }
  *natoms = n;
  size_t o = off + 56;
  if (n <= 9) {
    *end = o + static_cast<size_t>(n) * 12;
  } else {
    if (o + 36 > size) {
      set_error("truncated XTC frame header");
      return false;
    }
    int32_t nbytes = rd_be_i32(p + o + 32);
    if (nbytes < 0) {
      set_error("corrupt XTC frame size");
      return false;
    }
    *end = o + 36 + ((static_cast<size_t>(nbytes) + 3) / 4) * 4;
  }
  if (*end > size) {
    set_error("truncated XTC frame");
    return false;
  }
  return true;
}

bool parse_xtc_header(const uint8_t* p, size_t size, Loader* L) {
  L->format = Format::XTC;
  size_t off = 0;
  while (off + 4 <= size) {
    int32_t natoms;
    size_t end;
    if (!parse_xtc_frame(p, size, off, &natoms, &end)) {
      if (L->frame_off.empty()) return false;
      break;  // keep the complete frames before trailing garbage
    }
    if (L->frame_off.empty()) {
      L->natoms = natoms;
      L->floats_per_frame = 3 * static_cast<int64_t>(natoms);
    } else if (natoms != L->natoms) {
      set_error("XTC atom count changes mid-file");
      return false;
    }
    L->frame_off.push_back(off);
    off = end;
  }
  if (L->frame_off.empty()) {
    set_error("XTC contains no complete frames");
    return false;
  }
  L->frame_off.push_back(off);
  L->n_frames = static_cast<int64_t>(L->frame_off.size()) - 1;
  return true;
}

bool gather_xtc_frame(const Loader* L, int64_t f, float* out) {
  size_t off = L->frame_off[f];
  size_t end = L->frame_off[f + 1];
  if (L->natoms <= 9) {
    const uint8_t* x = L->base + off + 56;
    for (int64_t k = 0; k < L->floats_per_frame; k++) {
      out[k] = rd_be_f32(x + 4 * k);
    }
    return true;
  }
  return decode_xtc_frame(L->base, off + 56, end, L->natoms, out);
}

// ---- Amber NetCDF-3 (classic CDF-1 / 64-bit-offset CDF-2) ---------------
// Big-endian header: numrecs, dimension list, global attributes, then a
// variable list where each variable carries its own attributes, type,
// vsize and begin offset. The AMBER trajectory convention stores
// coordinates as a record variable [frame, atom, spatial=3] of
// NC_FLOAT/NC_DOUBLE, interleaved with the other record variables
// (time, cell_lengths, cell_angles) in per-record slots of `recsize`
// bytes. Mirrors molann_tpu_torch/io/netcdf.py — the Python oracle;
// tests/test_torch_port_io.py pins the two implementations together.

constexpr int32_t kNcDimension = 0x0A;
constexpr int32_t kNcVariable = 0x0B;
constexpr int32_t kNcAttribute = 0x0C;

size_t nc_type_size(int32_t t) {
  switch (t) {
    case 1: case 2: return 1;  // NC_BYTE, NC_CHAR
    case 3: return 2;          // NC_SHORT
    case 4: case 5: return 4;  // NC_INT, NC_FLOAT
    case 6: return 8;          // NC_DOUBLE
    default: return 0;
  }
}

struct NcCursor {
  const uint8_t* p;
  size_t size, off;
  bool fail = false;
  bool need(size_t n) {
    if (fail || off + n > size) { fail = true; return false; }
    return true;
  }
  uint32_t u4() {
    if (!need(4)) return 0;
    uint32_t v = rd_be_u32(p + off);
    off += 4;
    return v;
  }
  int32_t i4() { return static_cast<int32_t>(u4()); }
  int64_t i8() {
    if (!need(8)) return 0;
    uint64_t hi = rd_be_u32(p + off), lo = rd_be_u32(p + off + 4);
    off += 8;
    return static_cast<int64_t>((hi << 32) | lo);
  }
  bool read_name(std::string* out) {
    int32_t n = i4();
    if (fail || n < 0 || n > (1 << 20)) { fail = true; return false; }
    size_t padded = (static_cast<size_t>(n) + 3) & ~size_t{3};
    if (!need(padded)) return false;
    out->assign(reinterpret_cast<const char*>(p + off),
                static_cast<size_t>(n));
    off += padded;
    return true;
  }
  // tag+count pair; ABSENT = (0, 0)
  int32_t tagged_count(int32_t expect) {
    int32_t tag = i4(), count = i4();
    if (fail) return -1;
    if (tag == 0 && count == 0) return 0;
    if (tag != expect || count < 0) { fail = true; return -1; }
    return count;
  }
  // Walk one attribute list; if scale_out != nullptr, capture a numeric
  // "scale_factor" into it.
  bool skip_attrs(double* scale_out) {
    int32_t count = tagged_count(kNcAttribute);
    if (count < 0) return false;
    for (int32_t i = 0; i < count; i++) {
      std::string nm;
      if (!read_name(&nm)) return false;
      int32_t t = i4(), nelems = i4();
      size_t esz = nc_type_size(t);
      if (fail || esz == 0 || nelems < 0) { fail = true; return false; }
      size_t raw = static_cast<size_t>(nelems) * esz;
      size_t padded = (raw + 3) & ~size_t{3};
      if (!need(padded)) return false;
      if (scale_out && nm == "scale_factor" && nelems == 1) {
        if (t == 5) *scale_out = rd_be_f32(p + off);
        else if (t == 6) *scale_out = rd_be_f64(p + off);
        else if (t == 4) *scale_out = rd_be_i32(p + off);
      }
      off += padded;
    }
    return true;
  }
};

bool parse_nc_header(const uint8_t* p, size_t size, Loader* L) {
  L->format = Format::NC;
  const int version = p[3];
  if (version == 5) {
    set_error("NetCDF CDF-5 (64-bit data) is not supported; only classic "
              "CDF-1/CDF-2 (the AMBER convention variants)");
    return false;
  }
  if (version != 1 && version != 2) {
    set_error("unsupported NetCDF variant (only classic CDF-1/CDF-2; "
              "NetCDF-4/HDF5 files need the netCDF4 library)");
    return false;
  }
  NcCursor c{p, size, 4};
  const uint32_t numrecs_raw = c.u4();

  // dimensions
  int32_t ndims = c.tagged_count(kNcDimension);
  if (ndims < 0) { set_error("corrupt NetCDF dimension list"); return false; }
  std::vector<int64_t> dimsize;
  int rec_dim = -1;
  for (int32_t i = 0; i < ndims; i++) {
    std::string nm;
    if (!c.read_name(&nm)) { set_error("corrupt NetCDF dimension"); return false; }
    int32_t sz = c.i4();
    if (c.fail || sz < 0) { set_error("corrupt NetCDF dimension"); return false; }
    if (sz == 0 && rec_dim < 0) rec_dim = i;
    dimsize.push_back(sz);
  }
  if (!c.skip_attrs(nullptr)) {
    set_error("corrupt NetCDF global attributes");
    return false;
  }

  // variables: accumulate record geometry in header order
  int32_t nvars = c.tagged_count(kNcVariable);
  if (nvars < 0) { set_error("corrupt NetCDF variable list"); return false; }
  size_t recsize = 0, n_rec_vars = 0;
  size_t rec0 = size;        // min begin over record variables
  bool have_coords = false;
  size_t coords_per_rec = 0;
  for (int32_t i = 0; i < nvars; i++) {
    std::string nm;
    if (!c.read_name(&nm)) { set_error("corrupt NetCDF variable"); return false; }
    int32_t nd = c.i4();
    if (c.fail || nd < 0 || nd > 32) {
      set_error("corrupt NetCDF variable " + nm);
      return false;
    }
    std::vector<int32_t> dimids(nd);
    for (int32_t d = 0; d < nd; d++) {
      dimids[d] = c.i4();
      if (c.fail || dimids[d] < 0 ||
          dimids[d] >= static_cast<int32_t>(dimsize.size())) {
        set_error("corrupt dimension ids on " + nm);
        return false;
      }
    }
    double scale = 1.0;
    if (!c.skip_attrs(&scale)) {
      set_error("corrupt attributes on " + nm);
      return false;
    }
    int32_t nc_type = c.i4();
    c.i4();  // vsize: recomputed below, never trusted
    int64_t begin = version == 2 ? c.i8() : static_cast<int64_t>(c.u4());
    size_t esz = nc_type_size(nc_type);
    if (c.fail || esz == 0 || begin < 0) {
      set_error("corrupt NetCDF variable " + nm);
      return false;
    }
    const bool is_record = nd > 0 && rec_dim >= 0 && dimids[0] == rec_dim;
    int64_t per_elems = 1;
    for (int32_t d = is_record ? 1 : 0; d < nd; d++) {
      per_elems *= dimsize[static_cast<size_t>(dimids[d])];
    }
    const size_t per_rec = esz * static_cast<size_t>(per_elems);
    if (is_record) {
      recsize += (per_rec + 3) & ~size_t{3};
      n_rec_vars++;
      if (static_cast<size_t>(begin) < rec0) {
        rec0 = static_cast<size_t>(begin);
      }
    }
    if (nm == "coordinates") {
      if (!is_record || nd != 3 ||
          dimsize[static_cast<size_t>(dimids[2])] != 3) {
        set_error("coordinates is not a record [frame, atom, 3] variable "
                  "(not an AMBER trajectory convention file)");
        return false;
      }
      if (nc_type != 5 && nc_type != 6) {
        set_error("coordinates must be NC_FLOAT or NC_DOUBLE");
        return false;
      }
      const int64_t natoms = dimsize[static_cast<size_t>(dimids[1])];
      if (natoms <= 0) {
        set_error("non-positive NetCDF atom count");
        return false;
      }
      have_coords = true;
      coords_per_rec = per_rec;
      L->natoms = natoms;
      L->floats_per_frame = 3 * natoms;
      L->nc_begin = static_cast<size_t>(begin);
      L->nc_double = nc_type == 6;
      L->nc_scale = static_cast<float>(scale);
    }
  }
  if (c.fail) { set_error("truncated NetCDF header"); return false; }
  if (!have_coords) {
    set_error("no record 'coordinates' variable (not an AMBER trajectory "
              "convention file)");
    return false;
  }
  // classic-format special rule: a single record variable is unpadded
  if (n_rec_vars == 1) recsize = coords_per_rec;
  if (recsize == 0) { set_error("zero NetCDF record size"); return false; }
  L->nc_recsize = recsize;
  L->nc_per_rec = coords_per_rec;

  int64_t numrecs;
  if (numrecs_raw == 0xFFFFFFFFu) {  // STREAMING: count from file size
    numrecs = rec0 < size
                  ? static_cast<int64_t>((size - rec0) / recsize)
                  : 0;
    if (numrecs < 0) numrecs = 0;
  } else {
    numrecs = static_cast<int64_t>(numrecs_raw);
  }
  if (numrecs > 0) {
    const size_t need = L->nc_begin +
                        static_cast<size_t>(numrecs - 1) * recsize +
                        coords_per_rec;
    if (need > size) {
      set_error("truncated NetCDF (file smaller than header promises)");
      return false;
    }
  }
  L->n_frames = numrecs;
  return true;
}

void gather_nc_frame(const Loader* L, int64_t f, float* out) {
  const uint8_t* x =
      L->base + L->nc_begin + static_cast<size_t>(f) * L->nc_recsize;
  const int64_t n = L->floats_per_frame;
  if (L->nc_double) {
    for (int64_t k = 0; k < n; k++) {
      out[k] = static_cast<float>(rd_be_f64(x + 8 * k));
    }
  } else {
    for (int64_t k = 0; k < n; k++) out[k] = rd_be_f32(x + 4 * k);
  }
  if (L->nc_scale != 1.0f) {
    for (int64_t k = 0; k < n; k++) out[k] *= L->nc_scale;
  }
}

void prefetch_loop(Loader* L) {
  const size_t page = static_cast<size_t>(sysconf(_SC_PAGESIZE));
  for (;;) {
    std::vector<int64_t> batch;
    {
      std::unique_lock<std::mutex> lock(L->mu);
      L->cv.wait(lock, [L] { return L->stop || !L->pending.empty(); });
      if (L->stop) return;
      batch.swap(L->pending);
    }
    volatile uint8_t sink = 0;
    for (int64_t f : batch) {
      if (f < 0 || f >= L->n_frames) continue;  // never touch out-of-range
      const size_t frame_bytes = L->frame_bytes(f);
      const uint8_t* ptr = L->frame_ptr(f);
      madvise(const_cast<uint8_t*>(
                  reinterpret_cast<const uint8_t*>(
                      reinterpret_cast<uintptr_t>(ptr) & ~(page - 1))),
              frame_bytes + page, MADV_WILLNEED);
      // touch one byte per page to force residency
      for (size_t off = 0; off < frame_bytes; off += page) sink ^= ptr[off];
    }
    (void)sink;
  }
}

}  // namespace

extern "C" {

const char* tl_last_error() { return g_error.c_str(); }

void* tl_open(const char* path, int64_t* out_n_frames,
              int64_t* out_floats_per_frame) {
  auto L = new Loader();
  L->fd = open(path, O_RDONLY);
  if (L->fd < 0) {
    set_error(std::string("cannot open ") + path);
    delete L;
    return nullptr;
  }
  struct stat st;
  if (fstat(L->fd, &st) != 0) {
    set_error("fstat failed");
    delete L;
    return nullptr;
  }
  L->map_size = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, L->map_size, PROT_READ, MAP_PRIVATE, L->fd, 0);
  if (m == MAP_FAILED) {
    set_error("mmap failed");
    delete L;
    return nullptr;
  }
  L->base = static_cast<const uint8_t*>(m);

  if (L->map_size >= 8 && std::memcmp(L->base + 4, "CORD", 4) == 0) {
    if (!parse_dcd_header(L->base, L->map_size, L)) {
      delete L;
      return nullptr;
    }
  } else if (L->map_size >= 4 && rd_be_i32(L->base) == kTrrMagic) {
    if (!parse_trr_header(L->base, L->map_size, L)) {
      delete L;
      return nullptr;
    }
  } else if (L->map_size >= 4 && rd_be_i32(L->base) == kXtcMagic) {
    if (!parse_xtc_header(L->base, L->map_size, L)) {
      delete L;
      return nullptr;
    }
  } else if (L->map_size >= 8 && std::memcmp(L->base, "CDF", 3) == 0) {
    if (!parse_nc_header(L->base, L->map_size, L)) {
      delete L;
      return nullptr;
    }
  } else {
    size_t off = parse_npy_header(L->base, L->map_size, L);
    if (off == 0) {
      delete L;
      return nullptr;
    }
    const size_t need =
        off + static_cast<size_t>(L->n_frames) * L->floats_per_frame * 4;
    if (need > L->map_size) {
      set_error("file smaller than header claims");
      delete L;
      return nullptr;
    }
    L->data = reinterpret_cast<const float*>(L->base + off);
  }
  L->worker = std::thread(prefetch_loop, L);
  *out_n_frames = L->n_frames;
  *out_floats_per_frame = L->floats_per_frame;
  return L;
}

void tl_close(void* handle) { delete static_cast<Loader*>(handle); }

// Gather `count` frames (by index) into `out` ([count, floats_per_frame],
// packed atom-major, caller-allocated). Multi-threaded for large batches.
int tl_read_batch(void* handle, const int64_t* indices, int64_t count,
                  float* out, int n_threads) {
  auto* L = static_cast<Loader*>(handle);
  const int64_t fpf = L->floats_per_frame;
  for (int64_t i = 0; i < count; i++) {
    if (indices[i] < 0 || indices[i] >= L->n_frames) {
      set_error("frame index out of range");
      return -1;
    }
  }
  std::atomic<bool> failed{false};
  auto copy_range = [&](int64_t lo, int64_t hi) {
    switch (L->format) {
      case Format::NPY:
        for (int64_t i = lo; i < hi; i++) {
          std::memcpy(out + i * fpf, L->data + indices[i] * fpf,
                      fpf * sizeof(float));
        }
        break;
      case Format::DCD:
        for (int64_t i = lo; i < hi; i++) {
          gather_dcd_frame(L, indices[i], out + i * fpf);
        }
        break;
      case Format::TRR:
        for (int64_t i = lo; i < hi; i++) {
          if (!gather_trr_frame(L, indices[i], out + i * fpf)) {
            failed.store(true);
            return;
          }
        }
        break;
      case Format::XTC:
        for (int64_t i = lo; i < hi; i++) {
          if (!gather_xtc_frame(L, indices[i], out + i * fpf)) {
            failed.store(true);
            return;
          }
        }
        break;
      case Format::NC:
        for (int64_t i = lo; i < hi; i++) {
          gather_nc_frame(L, indices[i], out + i * fpf);
        }
        break;
    }
  };
  if (n_threads <= 1 || count < 1024) {
    copy_range(0, count);
  } else {
    const int t = n_threads;
    std::vector<std::thread> threads;
    threads.reserve(t);
    for (int k = 0; k < t; k++) {
      int64_t lo = count * k / t, hi = count * (k + 1) / t;
      threads.emplace_back(copy_range, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  if (failed.load()) {
    // decode errors in worker threads land in their thread-local slots
    set_error("corrupt compressed frame during batch gather");
    return -1;
  }
  return 0;
}

// Contiguous range read (no per-frame gather).
int tl_read_range(void* handle, int64_t start, int64_t count, float* out) {
  auto* L = static_cast<Loader*>(handle);
  if (start < 0 || count < 0 || start + count > L->n_frames) {
    set_error("range out of bounds");
    return -1;
  }
  switch (L->format) {
    case Format::NPY:
      std::memcpy(out, L->data + start * L->floats_per_frame,
                  static_cast<size_t>(count) * L->floats_per_frame *
                      sizeof(float));
      break;
    case Format::DCD:
      for (int64_t i = 0; i < count; i++) {
        gather_dcd_frame(L, start + i, out + i * L->floats_per_frame);
      }
      break;
    case Format::TRR:
      for (int64_t i = 0; i < count; i++) {
        if (!gather_trr_frame(L, start + i,
                              out + i * L->floats_per_frame)) {
          return -1;
        }
      }
      break;
    case Format::XTC:
      for (int64_t i = 0; i < count; i++) {
        if (!gather_xtc_frame(L, start + i, out + i * L->floats_per_frame)) {
          return -1;
        }
      }
      break;
    case Format::NC:
      for (int64_t i = 0; i < count; i++) {
        gather_nc_frame(L, start + i, out + i * L->floats_per_frame);
      }
      break;
  }
  return 0;
}

// Queue asynchronous prefetch of the given frames (returns immediately).
// Out-of-range indices are dropped (the worker re-checks too — a stale
// prefetch must never fault).
void tl_prefetch(void* handle, const int64_t* indices, int64_t count) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->pending.clear();
    L->pending.reserve(count);
    for (int64_t i = 0; i < count; i++) {
      if (indices[i] >= 0 && indices[i] < L->n_frames) {
        L->pending.push_back(indices[i]);
      }
    }
  }
  L->cv.notify_one();
}

}  // extern "C"
