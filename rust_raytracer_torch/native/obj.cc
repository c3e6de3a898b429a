// Native OBJ mesh loader.
//
// Replaces the reference's line-by-line Rust parser (reference:
// src/loaders/obj.rs:13-107) for the host-side scene-build path.  Grammar
// parity: v / vt / vn / f records; faces as v, v/vt, v//vn or v/vt/vn;
// missing vt allowed; negative (relative, 1-based-from-end) indices allowed;
// polygon faces fan-triangulated.  Everything else is ignored, matching the
// reference's `_ => ()` arm.
//
// C ABI consumed via ctypes (rust_raytracer_torch/native/__init__.py;
// the port's copy of rust_raytracer_tpu/native/).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ObjData {
  std::vector<double> verts;    // 3 * nv
  std::vector<double> normals;  // 3 * nn
  std::vector<double> uvs;      // 2 * nu
  std::vector<int32_t> tris;    // 9 * nt: per corner (v, vn, vt); -1 = none
};

// Resolve an OBJ index: 1-based, negative = relative to current count.
// Returns -1 for 0/invalid.
static inline int32_t resolve(long idx, size_t count) {
  if (idx > 0 && (size_t)idx <= count) return (int32_t)(idx - 1);
  if (idx < 0 && (size_t)(-idx) <= count) return (int32_t)(count + idx);
  return -1;
}

struct Corner {
  int32_t v = -1, vt = -1, vn = -1;
};

// Parse one face vertex "v[/vt][/vn]" (vt may be empty: "v//vn").
static bool parse_corner(const char *tok, const ObjData &d, Corner *out) {
  char *end = nullptr;
  long v = std::strtol(tok, &end, 10);
  if (end == tok) return false;
  out->v = resolve(v, d.verts.size() / 3);
  if (out->v < 0) return false;
  if (*end == '/') {
    const char *p = end + 1;
    if (*p != '/') {
      long vt = std::strtol(p, &end, 10);
      if (end != p) out->vt = resolve(vt, d.uvs.size() / 2);
      p = end;
    }
    if (*p == '/') {
      ++p;
      long vn = std::strtol(p, &end, 10);
      if (end != p) out->vn = resolve(vn, d.normals.size() / 3);
    }
  }
  return true;
}

}  // namespace

extern "C" {

void *rrt_obj_load(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto *d = new ObjData();

  std::string line;
  char buf[1 << 16];
  std::vector<Corner> corners;
  while (std::fgets(buf, sizeof(buf), f)) {
    char *s = buf;
    while (*s == ' ' || *s == '\t') ++s;
    if (s[0] == 'v' && (s[1] == ' ' || s[1] == '\t')) {
      double x = 0, y = 0, z = 0;
      if (std::sscanf(s + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        d->verts.push_back(x);
        d->verts.push_back(y);
        d->verts.push_back(z);
      }
    } else if (s[0] == 'v' && s[1] == 't' && (s[2] == ' ' || s[2] == '\t')) {
      double u = 0, v = 0;
      if (std::sscanf(s + 3, "%lf %lf", &u, &v) >= 1) {
        d->uvs.push_back(u);
        d->uvs.push_back(v);
      }
    } else if (s[0] == 'v' && s[1] == 'n' && (s[2] == ' ' || s[2] == '\t')) {
      double x = 0, y = 0, z = 0;
      if (std::sscanf(s + 3, "%lf %lf %lf", &x, &y, &z) == 3) {
        d->normals.push_back(x);
        d->normals.push_back(y);
        d->normals.push_back(z);
      }
    } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      corners.clear();
      char *save = nullptr;
      for (char *tok = strtok_r(s + 2, " \t\r\n", &save); tok;
           tok = strtok_r(nullptr, " \t\r\n", &save)) {
        Corner c;
        if (parse_corner(tok, *d, &c)) corners.push_back(c);
      }
      // fan triangulation (reference triangulates via assimp/3-vertex faces;
      // obj.rs accepts only triangles — fan is the superset behavior)
      for (size_t k = 2; k < corners.size(); ++k) {
        const Corner cs[3] = {corners[0], corners[k - 1], corners[k]};
        for (const Corner &c : cs) {
          d->tris.push_back(c.v);
          d->tris.push_back(c.vn);
          d->tris.push_back(c.vt);
        }
      }
    }
  }
  std::fclose(f);
  (void)line;
  return d;
}

void rrt_obj_counts(void *handle, int64_t *nv, int64_t *nn, int64_t *nu,
                    int64_t *nt) {
  auto *d = (ObjData *)handle;
  *nv = (int64_t)(d->verts.size() / 3);
  *nn = (int64_t)(d->normals.size() / 3);
  *nu = (int64_t)(d->uvs.size() / 2);
  *nt = (int64_t)(d->tris.size() / 9);
}

void rrt_obj_copy(void *handle, double *verts, double *normals, double *uvs,
                  int32_t *tris) {
  auto *d = (ObjData *)handle;
  std::memcpy(verts, d->verts.data(), d->verts.size() * sizeof(double));
  std::memcpy(normals, d->normals.data(), d->normals.size() * sizeof(double));
  std::memcpy(uvs, d->uvs.data(), d->uvs.size() * sizeof(double));
  std::memcpy(tris, d->tris.data(), d->tris.size() * sizeof(int32_t));
}

void rrt_obj_free(void *handle) { delete (ObjData *)handle; }

}  // extern "C"
