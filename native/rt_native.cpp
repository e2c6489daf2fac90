// rt_native — host-side native runtime for the JAX path tracer.
//
// The reference's performance-critical host code is native Rust (tobj OBJ
// parsing, BVH construction — geometry.rs:138-217). These are the same
// components here, as a C++ shared library bound via ctypes:
//
//   rt_obj_load:  Wavefront OBJ parse with tobj-equivalent semantics
//                 (fan triangulation + single-index vertex unification).
//   rt_bvh_build: threaded flat BVH (DFS order + skip links, median split
//                 on the largest centroid axis) matching the layout that
//                 ops/bvh.py's traversal consumes.
//
// Both have pure-Python fallbacks (utils/obj_loader.py, ops/bvh.py); the
// native versions exist for load-time throughput on big scenes.
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

struct RtObjMesh {
  float* positions;   // (n_vertices, 3)
  float* normals;     // (n_vertices, 3)
  float* texcoords;   // (n_vertices, 2)
  int32_t* indices;   // (n_triangles, 3)
  int64_t n_vertices;
  int64_t n_triangles;
  int32_t has_normals;
  int32_t has_texcoords;
};

void rt_free(void* p) { free(p); }

void rt_obj_free(RtObjMesh* m) {
  if (!m) return;
  free(m->positions);
  free(m->normals);
  free(m->texcoords);
  free(m->indices);
  m->positions = m->normals = m->texcoords = nullptr;
  m->indices = nullptr;
}

namespace {

struct Key {
  int32_t v, vt, vn;
  bool operator==(const Key& o) const {
    return v == o.v && vt == o.vt && vn == o.vn;
  }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    size_t h = (size_t)(uint32_t)k.v;
    h = h * 1000003u ^ (size_t)(uint32_t)k.vt;
    h = h * 1000003u ^ (size_t)(uint32_t)k.vn;
    return h;
  }
};

// Parse one face token "v", "v/vt", "v//vn", "v/vt/vn"; 1-based, negative
// = relative to current array end. Returns 0-based ids, -1 for absent.
inline Key parse_corner(const char* tok, int64_t nv, int64_t nvt, int64_t nvn) {
  Key k{-1, -1, -1};
  const char* p = tok;
  auto read = [&](int64_t n) -> int32_t {
    if (*p == '\0' || *p == '/') return -1;
    long i = strtol(p, const_cast<char**>(&p), 10);
    return (int32_t)(i > 0 ? i - 1 : n + i);
  };
  k.v = read(nv);
  if (*p == '/') {
    ++p;
    k.vt = read(nvt);
    if (*p == '/') {
      ++p;
      k.vn = read(nvn);
    }
  }
  return k;
}

}  // namespace

// Load the first model of an OBJ file. Returns 0 on success.
int rt_obj_load(const char* path, RtObjMesh* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  memset(out, 0, sizeof(*out));

  std::vector<float> vs, vts, vns;        // raw attribute pools
  std::vector<float> pos, uv, nrm;        // unified output pools
  std::vector<int32_t> idx;               // triangle indices
  std::unordered_map<Key, int32_t, KeyHash> unified;
  std::vector<int32_t> face;              // per-face unified ids

  // getline (not a fixed fgets buffer): OBJ lines from scan exporters
  // can exceed any fixed size, and a silently split line corrupts face
  // parsing with no error.
  char* line = nullptr;
  size_t cap = 0;
  while (getline(&line, &cap, f) != -1) {
    char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (s[0] == 'v' && (s[1] == ' ' || s[1] == '\t')) {
      float x = 0, y = 0, z = 0;
      sscanf(s + 2, "%f %f %f", &x, &y, &z);
      vs.push_back(x); vs.push_back(y); vs.push_back(z);
    } else if (s[0] == 'v' && s[1] == 't') {
      float u = 0, v = 0;
      sscanf(s + 3, "%f %f", &u, &v);
      vts.push_back(u); vts.push_back(v);
    } else if (s[0] == 'v' && s[1] == 'n') {
      float x = 0, y = 0, z = 0;
      sscanf(s + 3, "%f %f %f", &x, &y, &z);
      vns.push_back(x); vns.push_back(y); vns.push_back(z);
    } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      face.clear();
      char* save = nullptr;
      for (char* tok = strtok_r(s + 2, " \t\r\n", &save); tok;
           tok = strtok_r(nullptr, " \t\r\n", &save)) {
        Key k = parse_corner(tok, (int64_t)vs.size() / 3,
                             (int64_t)vts.size() / 2, (int64_t)vns.size() / 3);
        // malformed/out-of-range indices (0, past-the-end, unresolvable
        // negatives) skip the corner — never index the pools unchecked
        if (k.v < 0 || (size_t)k.v * 3 + 2 >= vs.size()) continue;
        if (k.vt >= 0 && (size_t)k.vt * 2 + 1 >= vts.size()) k.vt = -1;
        if (k.vn >= 0 && (size_t)k.vn * 3 + 2 >= vns.size()) k.vn = -1;
        auto it = unified.find(k);
        int32_t uid;
        if (it != unified.end()) {
          uid = it->second;
        } else {
          uid = (int32_t)(pos.size() / 3);
          unified.emplace(k, uid);
          pos.push_back(vs[(size_t)k.v * 3 + 0]);
          pos.push_back(vs[(size_t)k.v * 3 + 1]);
          pos.push_back(vs[(size_t)k.v * 3 + 2]);
          if (k.vt >= 0) {
            uv.push_back(vts[(size_t)k.vt * 2 + 0]);
            uv.push_back(vts[(size_t)k.vt * 2 + 1]);
          } else {
            uv.push_back(0.f); uv.push_back(0.f);
          }
          if (k.vn >= 0) {
            nrm.push_back(vns[(size_t)k.vn * 3 + 0]);
            nrm.push_back(vns[(size_t)k.vn * 3 + 1]);
            nrm.push_back(vns[(size_t)k.vn * 3 + 2]);
          } else {
            nrm.push_back(0.f); nrm.push_back(0.f); nrm.push_back(0.f);
          }
        }
        face.push_back(uid);
      }
      // fan triangulation (tobj `triangulate: true`)
      for (size_t i = 1; i + 1 < face.size(); ++i) {
        idx.push_back(face[0]);
        idx.push_back(face[i]);
        idx.push_back(face[i + 1]);
      }
    }
  }
  free(line);
  fclose(f);

  out->n_vertices = (int64_t)(pos.size() / 3);
  out->n_triangles = (int64_t)(idx.size() / 3);
  out->has_normals = vns.empty() ? 0 : 1;
  out->has_texcoords = vts.empty() ? 0 : 1;
  auto dup = [](const std::vector<float>& v) {
    float* p = (float*)malloc(std::max<size_t>(1, v.size()) * sizeof(float));
    memcpy(p, v.data(), v.size() * sizeof(float));
    return p;
  };
  out->positions = dup(pos);
  out->normals = dup(nrm);
  out->texcoords = dup(uv);
  out->indices = (int32_t*)malloc(std::max<size_t>(1, idx.size()) * sizeof(int32_t));
  memcpy(out->indices, idx.data(), idx.size() * sizeof(int32_t));
  return 0;
}

// ---------------------------------------------------------------------------
// Skip-link-threaded flat BVH build (same layout as ops/bvh.py::build_bvh).
// "Threaded" in the tree sense — every node carries the index of the
// next node to visit on an AABB miss — NOT multithreading; the build
// itself is single-threaded (scene loads are host-startup, not hot).
// ---------------------------------------------------------------------------

namespace {

struct Builder {
  const float* tv;  // (nt, 9) triangle corners
  int leaf_size;
  std::vector<float> bmin, bmax;       // (nn, 3)
  std::vector<int32_t> skip, lstart, lcount;
  std::vector<int32_t> order;
  std::vector<float> cmin, cmax, cent; // per-tri bounds/centroids (nt, 3)

  void tri_bounds(int64_t nt) {
    cmin.resize(nt * 3);
    cmax.resize(nt * 3);
    cent.resize(nt * 3);
    for (int64_t i = 0; i < nt; ++i) {
      for (int a = 0; a < 3; ++a) {
        float v0 = tv[i * 9 + a], v1 = tv[i * 9 + 3 + a], v2 = tv[i * 9 + 6 + a];
        float lo = std::min(v0, std::min(v1, v2));
        float hi = std::max(v0, std::max(v1, v2));
        cmin[i * 3 + a] = lo;
        cmax[i * 3 + a] = hi;
        cent[i * 3 + a] = 0.5f * (lo + hi);
      }
    }
  }

  void rec(int32_t* ids, int64_t n, int64_t out_base) {
    size_t node = skip.size();
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = 0; i < n; ++i) {
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], cmin[(size_t)ids[i] * 3 + a]);
        hi[a] = std::max(hi[a], cmax[(size_t)ids[i] * 3 + a]);
      }
    }
    bmin.insert(bmin.end(), lo, lo + 3);
    bmax.insert(bmax.end(), hi, hi + 3);
    skip.push_back(-1);
    if (n <= leaf_size) {
      lstart.push_back((int32_t)out_base);
      lcount.push_back((int32_t)n);
      order.insert(order.end(), ids, ids + n);
    } else {
      lstart.push_back(-1);
      lcount.push_back(0);
      // largest centroid extent axis
      float cl[3] = {1e30f, 1e30f, 1e30f}, ch[3] = {-1e30f, -1e30f, -1e30f};
      for (int64_t i = 0; i < n; ++i)
        for (int a = 0; a < 3; ++a) {
          float c = cent[(size_t)ids[i] * 3 + a];
          cl[a] = std::min(cl[a], c);
          ch[a] = std::max(ch[a], c);
        }
      int axis = 0;
      float best = ch[0] - cl[0];
      for (int a = 1; a < 3; ++a)
        if (ch[a] - cl[a] > best) { best = ch[a] - cl[a]; axis = a; }
      int64_t mid = n / 2;
      std::nth_element(ids, ids + mid, ids + n, [&](int32_t x, int32_t y) {
        return cent[(size_t)x * 3 + axis] < cent[(size_t)y * 3 + axis];
      });
      rec(ids, mid, out_base);
      rec(ids + mid, n - mid, out_base + mid);
    }
    skip[node] = (int32_t)skip.size();
  }
};

}  // namespace

int rt_bvh_build(const float* tri_verts, int64_t nt, int32_t leaf_size,
                 float** bounds_min, float** bounds_max, int32_t** skip,
                 int32_t** leaf_start, int32_t** leaf_count,
                 int32_t** tri_order, int64_t* n_nodes) {
  if (nt <= 0) return 1;
  Builder b;
  b.tv = tri_verts;
  b.leaf_size = leaf_size;
  b.tri_bounds(nt);
  std::vector<int32_t> ids(nt);
  for (int64_t i = 0; i < nt; ++i) ids[i] = (int32_t)i;
  b.rec(ids.data(), nt, 0);

  size_t nn = b.skip.size();
  *n_nodes = (int64_t)nn;
  auto dupf = [](const std::vector<float>& v) {
    float* p = (float*)malloc(v.size() * sizeof(float));
    memcpy(p, v.data(), v.size() * sizeof(float));
    return p;
  };
  auto dupi = [](const std::vector<int32_t>& v) {
    int32_t* p = (int32_t*)malloc(v.size() * sizeof(int32_t));
    memcpy(p, v.data(), v.size() * sizeof(int32_t));
    return p;
  };
  *bounds_min = dupf(b.bmin);
  *bounds_max = dupf(b.bmax);
  *skip = dupi(b.skip);
  *leaf_start = dupi(b.lstart);
  *leaf_count = dupi(b.lcount);
  *tri_order = dupi(b.order);
  return 0;
}

}  // extern "C"
