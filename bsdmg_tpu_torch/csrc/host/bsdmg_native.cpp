// bsdmg_tpu native runtime: vertex welding + OBJ serialization.
//
// The reference does both on the CPU in Rust: hash-map welding with
// coordinates quantized by round(x * 1e5) (src/cuda/mod.rs:268-296) and OBJ
// assembly through the `obj` crate (src/renderer/mod.rs:204). This is the
// C++ equivalent, exposed as a C ABI for ctypes: an open-addressing hash on
// the quantized (i64, i64, i64) key, first-encounter ordering, and a
// buffered OBJ writer. The NumPy fallback in bsdmg_tpu/mesh/weld.py produces
// identical meshes; this path is ~10x faster on multi-million-triangle
// extractions.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libbsdmg_native.so bsdmg_native.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// Weld a triangle soup into an indexed mesh.
//   positions, normals: n_vertices * 3 floats (triangle order, 3 verts/tri)
//   quant: quantization factor (1e5 for the reference tolerance)
//   out_vertices, out_normals: capacity n_vertices * 3 floats
//   out_indices: capacity n_vertices ints
// Returns the number of unique vertices (V); out_indices holds n_vertices
// indices into the V unique vertices. Negative return = error.
int64_t bsdmg_weld(const float* positions, const float* normals,
                   int64_t n_vertices, double quant,
                   float* out_vertices, float* out_normals,
                   int32_t* out_indices) {
  if (n_vertices <= 0) return 0;

  // open addressing, power-of-two capacity >= 2 * n
  uint64_t cap = 16;
  while (cap < (uint64_t)n_vertices * 2) cap <<= 1;
  const uint64_t mask = cap - 1;

  struct Slot { int64_t kx, ky, kz; int32_t index; };
  const int64_t EMPTY = INT64_MIN;
  std::vector<Slot> table(cap);
  for (auto& s : table) { s.kx = EMPTY; s.index = -1; }

  auto quantize = [quant](float x) -> int64_t {
    return (int64_t)llroundf((float)(x * quant));
  };
  auto hash3 = [](int64_t a, int64_t b, int64_t c) -> uint64_t {
    uint64_t h = 0x9E3779B97F4A7C15ull;
    h ^= (uint64_t)a; h *= 0xBF58476D1CE4E5B9ull;
    h ^= (uint64_t)b; h *= 0x94D049BB133111EBull;
    h ^= (uint64_t)c; h *= 0xBF58476D1CE4E5B9ull;
    h ^= h >> 31;
    return h;
  };

  int32_t unique = 0;
  for (int64_t i = 0; i < n_vertices; ++i) {
    const float* p = positions + 3 * i;
    int64_t kx = quantize(p[0]), ky = quantize(p[1]), kz = quantize(p[2]);
    uint64_t h = hash3(kx, ky, kz) & mask;
    for (;;) {
      Slot& s = table[h];
      if (s.kx == EMPTY) {
        s.kx = kx; s.ky = ky; s.kz = kz; s.index = unique;
        memcpy(out_vertices + 3 * unique, p, 3 * sizeof(float));
        memcpy(out_normals + 3 * unique, normals + 3 * i, 3 * sizeof(float));
        out_indices[i] = unique;
        ++unique;
        break;
      }
      if (s.kx == kx && s.ky == ky && s.kz == kz) {
        out_indices[i] = s.index;
        break;
      }
      h = (h + 1) & mask;
    }
  }
  return unique;
}

// Buffered OBJ writer: v/vn lines then f a//a b//b c//c (1-based).
// Returns 0 on success, negative on I/O error.
int32_t bsdmg_write_obj(const char* path,
                        const float* vertices, const float* normals,
                        int64_t n_vertices,
                        const int32_t* faces, int64_t n_faces) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  setvbuf(f, nullptr, _IOFBF, 1 << 20);

  fputs("# bsdmg_tpu generated mesh (native writer)\n", f);
  for (int64_t i = 0; i < n_vertices; ++i) {
    const float* v = vertices + 3 * i;
    fprintf(f, "v %.6f %.6f %.6f\n", v[0], v[1], v[2]);
  }
  for (int64_t i = 0; i < n_vertices; ++i) {
    const float* n = normals + 3 * i;
    fprintf(f, "vn %.6f %.6f %.6f\n", n[0], n[1], n[2]);
  }
  for (int64_t i = 0; i < n_faces; ++i) {
    const int32_t* t = faces + 3 * i;
    fprintf(f, "f %d//%d %d//%d %d//%d\n",
            t[0] + 1, t[0] + 1, t[1] + 1, t[1] + 1, t[2] + 1, t[2] + 1);
  }
  int rc = ferror(f) ? -2 : 0;
  fclose(f);
  return rc;
}

// Compact finite-marker triangle soup rows (dropping masked slots) —
// the CPU-side analogue used for host post-processing benchmarks.
int64_t bsdmg_compact_triangles(const float* positions, const float* normals,
                                const uint8_t* valid, int64_t n_triangles,
                                float* out_positions, float* out_normals) {
  int64_t out = 0;
  for (int64_t i = 0; i < n_triangles; ++i) {
    if (valid[i]) {
      memcpy(out_positions + 9 * out, positions + 9 * i, 9 * sizeof(float));
      memcpy(out_normals + 9 * out, normals + 9 * i, 9 * sizeof(float));
      ++out;
    }
  }
  return out;
}

// --- OBJ reader ---
// Pass 1 (bsdmg_obj_count): scan the file, return counts so the caller can
// allocate. Pass 2 (bsdmg_obj_read): fill vertex/normal/face buffers.
// Supports "v x y z", "vn x y z" and "f" rows with 3+ indices in any of the
// a, a/b, a//c, a/b/c forms (fan-triangulated; negative indices relative).
// Mirrors the Python reader (bsdmg_tpu/mesh/export.py::load_obj). The whole
// file is read into memory and split on newlines, so arbitrarily long face
// rows (CAD exporters emit multi-KB fans) parse correctly — a fixed fgets
// buffer would silently split them identically in both passes.

static char* read_whole_file(const char* path, long* out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  if (len < 0) { fclose(f); return nullptr; }
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc((size_t)len + 1);
  if (!buf) { fclose(f); return nullptr; }
  size_t got = fread(buf, 1, (size_t)len, f);
  fclose(f);
  buf[got] = '\0';
  *out_len = (long)got;
  return buf;
}

static const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

// Parse one line starting at `p`; advance `*next` past the newline.
// mode 0: count only. mode 1: fill buffers.
struct ObjState {
  int64_t nv, nn, nf;
  float* vertices; int64_t cap_v;
  float* normals;  int64_t cap_n;
  int32_t* faces;  int64_t cap_f;
  int overflow;
};

static void obj_line(const char* p, const char* line_end, int mode, ObjState* st) {
  p = skip_ws(p);
  if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
    if (mode) {
      if (st->nv >= st->cap_v) { st->overflow = 1; return; }
      char* end;
      float x = strtof(p + 1, &end);
      float y = strtof(end, &end);
      float z = strtof(end, &end);
      st->vertices[3 * st->nv] = x;
      st->vertices[3 * st->nv + 1] = y;
      st->vertices[3 * st->nv + 2] = z;
    }
    ++st->nv;
  } else if (p[0] == 'v' && p[1] == 'n' && (p[2] == ' ' || p[2] == '\t')) {
    if (mode) {
      if (st->nn >= st->cap_n) { st->overflow = 1; return; }
      char* end;
      float x = strtof(p + 2, &end);
      float y = strtof(end, &end);
      float z = strtof(end, &end);
      st->normals[3 * st->nn] = x;
      st->normals[3 * st->nn + 1] = y;
      st->normals[3 * st->nn + 2] = z;
    }
    ++st->nn;
  } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
    const char* q = p + 1;
    int64_t corners = 0;
    int32_t first = 0, prev = 0;
    for (;;) {
      q = skip_ws(q);
      if (q >= line_end || *q == '\0' || *q == '\n' || *q == '#') break;
      char* end;
      long idx = strtol(q, &end, 10);
      if (end == q) break;
      if (mode) {
        long zero_based = idx > 0 ? idx - 1 : (long)st->nv + idx;
        int32_t cur = (int32_t)zero_based;
        if (corners >= 2) {
          if (st->nf >= st->cap_f) { st->overflow = 1; return; }
          st->faces[3 * st->nf] = first;
          st->faces[3 * st->nf + 1] = prev;
          st->faces[3 * st->nf + 2] = cur;
          ++st->nf;
        } else if (corners == 0) {
          first = cur;
        }
        prev = cur;
      }
      ++corners;
      q = end;
      while (q < line_end && *q && *q != ' ' && *q != '\t' && *q != '\n' && *q != '\r') ++q;
    }
    if (!mode && corners >= 3) st->nf += corners - 2;
  }
}

static int obj_scan(const char* path, int mode, ObjState* st) {
  long len = 0;
  char* buf = read_whole_file(path, &len);
  if (!buf) return -1;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* line_end = nl ? nl : end;
    obj_line(p, line_end, mode, st);
    if (st->overflow) { free(buf); return -2; }
    p = line_end + 1;
  }
  free(buf);
  return 0;
}

int32_t bsdmg_obj_count(const char* path, int64_t* n_vertices,
                        int64_t* n_normals, int64_t* n_faces) {
  ObjState st = {};
  int rc = obj_scan(path, 0, &st);
  if (rc != 0) return rc;
  *n_vertices = st.nv; *n_normals = st.nn; *n_faces = st.nf;
  return 0;
}

int32_t bsdmg_obj_read(const char* path,
                       float* vertices, int64_t n_vertices,
                       float* normals, int64_t n_normals,
                       int32_t* faces, int64_t n_faces) {
  ObjState st = {};
  st.vertices = vertices; st.cap_v = n_vertices;
  st.normals = normals;  st.cap_n = n_normals;
  st.faces = faces;      st.cap_f = n_faces;
  int rc = obj_scan(path, 1, &st);
  if (rc != 0) return rc;
  return (st.nv == n_vertices && st.nf == n_faces) ? 0 : -3;
}

}  // extern "C"
