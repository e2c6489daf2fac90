// cpu_tracer — native multithreaded CPU path-tracer baseline.
//
// The BASELINE.json north-star compares the JAX renderer against "the Rust
// multithreaded CPU reference". No Rust toolchain exists in this image, so
// this C++ program is the measured stand-in: a straightforward
// multithreaded CPU path tracer running the SAME benchmark scene (Cornell
// box + teapot OBJ under a BVH + metal/glass spheres + area light) with
// the same estimator family (unidirectional path tracing, uniform
// hemisphere sampling, depth cutoff). It is written the way a competent
// CPU implementation would be — per-ray recursion, pointer BVH, thread
// pool over image rows — i.e., the architecture the wavefront rebuild replaces.
//
// Build: make -C native cpu_tracer
// Run:   native/build/cpu_tracer [width] [spp] [depth] [teapot.obj]
// Output: one line "segments=<N> wall=<s> mrays=<Mrays/s>"

#include <atomic>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <fstream>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

struct V3 {
  float x = 0, y = 0, z = 0;
};
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
static inline V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float len(V3 a) { return std::sqrt(dot(a, a)); }
static inline V3 norm(V3 a) { float l = len(a); return {a.x / l, a.y / l, a.z / l}; }

enum MatKind { LAMBERT, METAL, GLASS };
struct Material {
  MatKind kind = LAMBERT;
  V3 albedo{0.8f, 0.8f, 0.8f};
  V3 emission{0, 0, 0};
  float roughness = 0.0f, ior = 1.5f;
};

struct Hit {
  float t = 1e30f;
  V3 p, n;
  bool front = true;
  const Material* mat = nullptr;
};

struct Sphere {
  V3 c;
  float r;
  Material mat;
};
struct PlaneP {
  V3 p, n;
  Material mat;
};
struct Tri {
  V3 a, e1, e2, gn;
  const Material* mat;
};

// --- simple median-split BVH over triangles ---
struct BVHNode {
  V3 bmin, bmax;
  int left = -1, right = -1, start = 0, count = 0;
};

struct Mesh {
  std::vector<Tri> tris;
  std::vector<BVHNode> nodes;
  Material mat;

  void build() {
    std::vector<int> ids(tris.size());
    for (size_t i = 0; i < ids.size(); ++i) ids[i] = (int)i;
    std::vector<Tri> reordered;
    reordered.reserve(tris.size());
    build_rec(ids.data(), (int)ids.size(), reordered);
    tris = std::move(reordered);
  }
  int build_rec(int* ids, int n, std::vector<Tri>& out) {
    BVHNode node;
    node.bmin = {1e30f, 1e30f, 1e30f};
    node.bmax = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < n; ++i) {
      const Tri& t = tris[ids[i]];
      V3 v[3] = {t.a, t.a + t.e1, t.a + t.e2};
      for (auto& p : v) {
        node.bmin = {std::min(node.bmin.x, p.x), std::min(node.bmin.y, p.y), std::min(node.bmin.z, p.z)};
        node.bmax = {std::max(node.bmax.x, p.x), std::max(node.bmax.y, p.y), std::max(node.bmax.z, p.z)};
      }
    }
    int my = (int)nodes.size();
    nodes.push_back(node);
    if (n <= 4) {
      nodes[my].start = (int)out.size();
      nodes[my].count = n;
      for (int i = 0; i < n; ++i) out.push_back(tris[ids[i]]);
    } else {
      V3 ext = node.bmax - node.bmin;
      int ax = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2) : (ext.y > ext.z ? 1 : 2);
      auto cent = [&](int id) {
        const Tri& t = tris[id];
        V3 c = t.a + 0.3333f * (t.e1 + t.e2);
        return ax == 0 ? c.x : ax == 1 ? c.y : c.z;
      };
      std::nth_element(ids, ids + n / 2, ids + n,
                       [&](int a, int b) { return cent(a) < cent(b); });
      int l = build_rec(ids, n / 2, out);
      int r = build_rec(ids + n / 2, n - n / 2, out);
      nodes[my].left = l;
      nodes[my].right = r;
    }
    return my;
  }
};

static inline bool slab(const BVHNode& nd, V3 o, V3 inv, float tmin, float tmax) {
  float t0 = (nd.bmin.x - o.x) * inv.x, t1 = (nd.bmax.x - o.x) * inv.x;
  if (inv.x < 0) std::swap(t0, t1);
  tmin = std::max(t0, tmin); tmax = std::min(t1, tmax);
  t0 = (nd.bmin.y - o.y) * inv.y; t1 = (nd.bmax.y - o.y) * inv.y;
  if (inv.y < 0) std::swap(t0, t1);
  tmin = std::max(t0, tmin); tmax = std::min(t1, tmax);
  t0 = (nd.bmin.z - o.z) * inv.z; t1 = (nd.bmax.z - o.z) * inv.z;
  if (inv.z < 0) std::swap(t0, t1);
  tmin = std::max(t0, tmin); tmax = std::min(t1, tmax);
  return tmax > tmin;
}

static inline bool tri_hit(const Tri& tr, V3 o, V3 d, float tmin, float tmax, float& t) {
  V3 q = cross(d, tr.e2);
  float det = dot(tr.e1, q);
  if (std::fabs(det) < 1e-4f) return false;
  float f = 1.0f / det;
  V3 s = o - tr.a;
  float u = f * dot(s, q);
  if (u < 0) return false;
  V3 r = cross(s, tr.e1);
  float v = f * dot(d, r);
  if (v < 0 || u + v > 1) return false;
  t = f * dot(tr.e2, r);
  return t >= tmin && t <= tmax;
}

struct Scene {
  std::vector<Sphere> spheres;
  std::vector<PlaneP> planes;
  std::vector<Tri> tris;  // standalone (area light)
  Mesh mesh;

  bool intersect(V3 o, V3 d, float tmin, float tmax, Hit& h) const {
    bool any = false;
    for (auto& s : spheres) {
      V3 f = o - s.c;
      float a = dot(d, d), b = 2 * dot(f, d), c = dot(f, f) - s.r * s.r;
      float disc = b * b - 4 * a * c;
      if (disc < 0) continue;
      float sq = std::sqrt(disc);
      float t1 = (-b - sq) / (2 * a), t2 = (-b + sq) / (2 * a);
      float t = t1 >= tmin ? t1 : t2;
      if (t < tmin || t > tmax || t >= h.t) continue;
      h.t = t; h.p = o + t * d;
      V3 n = norm(h.p - s.c);
      h.front = dot(n, d) < 0;
      h.n = h.front ? n : -1.0f * n;
      h.mat = &s.mat;
      any = true;
    }
    for (auto& pl : planes) {
      float od = dot(o - pl.p, pl.n);
      V3 n = (od >= 0 ? 1.0f : -1.0f) * pl.n;
      float dd = dot(d, n);
      if (dd >= 0) continue;
      float t = std::fabs(od) / std::fabs(dd);
      if (t < tmin || t > tmax || t >= h.t) continue;
      h.t = t; h.p = o + t * d; h.n = n; h.front = true; h.mat = &pl.mat;
      any = true;
    }
    for (auto& tr : tris) {
      float t;
      if (tri_hit(tr, o, d, tmin, std::min(tmax, h.t), t)) {
        h.t = t; h.p = o + t * d;
        h.front = dot(tr.gn, d) < 0;
        h.n = h.front ? tr.gn : -1.0f * tr.gn;
        h.mat = tr.mat;
        any = true;
      }
    }
    if (!mesh.nodes.empty()) {
      V3 inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
      int stack[64];
      int sp = 0;
      stack[sp++] = 0;
      while (sp) {
        const BVHNode& nd = mesh.nodes[stack[--sp]];
        if (!slab(nd, o, inv, tmin, std::min(tmax, h.t))) continue;
        if (nd.count) {
          for (int i = 0; i < nd.count; ++i) {
            const Tri& tr = mesh.tris[nd.start + i];
            float t;
            if (tri_hit(tr, o, d, tmin, std::min(tmax, h.t), t)) {
              h.t = t; h.p = o + t * d;
              h.front = dot(tr.gn, d) < 0;
              h.n = h.front ? tr.gn : -1.0f * tr.gn;
              h.mat = &mesh.mat;
              any = true;
            }
          }
        } else {
          stack[sp++] = nd.left;
          stack[sp++] = nd.right;
        }
      }
    }
    return any;
  }
};

static thread_local std::mt19937 g_rng;
static inline float rnd() {
  return std::uniform_real_distribution<float>(0.0f, 1.0f)(g_rng);
}
static inline V3 ball() {
  for (;;) {
    V3 v{2 * rnd() - 1, 2 * rnd() - 1, 2 * rnd() - 1};
    if (dot(v, v) <= 1.0f) return v;
  }
}

int main(int argc, char** argv) {
  int W = argc > 1 ? atoi(argv[1]) : 512;
  int SPP = argc > 2 ? atoi(argv[2]) : 16;
  int DEPTH = argc > 3 ? atoi(argv[3]) : 8;
  const char* obj = argc > 4 ? argv[4] : "/root/reference/obj/teapot.obj";
  int H = W;

  Scene sc;
  Material white{LAMBERT, {0.73f, 0.73f, 0.73f}};
  Material red{LAMBERT, {0.65f, 0.05f, 0.05f}};
  Material green{LAMBERT, {0.12f, 0.45f, 0.15f}};
  Material light{LAMBERT, {0, 0, 0}, {15, 15, 15}};
  sc.planes = {
      {{0, 0, 0}, {0, 1, 0}, white},   {{0, 5, 0}, {0, -1, 0}, white},
      {{0, 0, -2.5f}, {0, 0, 1}, white}, {{-2.5f, 0, 0}, {1, 0, 0}, red},
      {{2.5f, 0, 0}, {-1, 0, 0}, green},
  };
  sc.spheres = {
      {{1.4f, 0.7f, 0.6f}, 0.7f, {METAL, {0.8f, 0.8f, 0.9f}, {0, 0, 0}, 0.05f}},
      {{-1.6f, 0.6f, 1.2f}, 0.6f, {GLASS, {1, 1, 1}, {0, 0, 0}, 0.0f, 1.5f}},
  };
  static Material lightMat = light;
  sc.tris = {
      {{-1.2f, 4.99f, -1.5f}, {2.4f, 0, 0}, {2.4f, 0, 2.0f}, {0, -1, 0}, &lightMat},
      {{-1.2f, 4.99f, -1.5f}, {0, 0, 2.0f}, {2.4f, 0, 2.0f}, {0, -1, 0}, &lightMat},
  };

  // teapot OBJ (positions + triangulated faces), transform ~ bench scene
  {
    std::ifstream in(obj);
    std::vector<V3> vs;
    std::string line;
    auto xf = [](V3 p) {
      // rotate_x(-90) then scale 1.5 then translate (0, 0.75, -0.6)
      V3 r{p.x, p.z, -p.y};
      return V3{1.5f * r.x + 0.0f, 1.5f * r.y + 0.75f, 1.5f * r.z - 0.6f};
    };
    while (std::getline(in, line)) {
      if (line.rfind("v ", 0) == 0) {
        V3 p;
        sscanf(line.c_str(), "v %f %f %f", &p.x, &p.y, &p.z);
        vs.push_back(xf(p));
      } else if (line.rfind("f ", 0) == 0) {
        std::istringstream ss(line.substr(2));
        std::vector<int> ids;
        std::string tok;
        while (ss >> tok) ids.push_back(atoi(tok.c_str()) - 1);
        for (size_t i = 1; i + 1 < ids.size(); ++i) {
          Tri t;
          t.a = vs[ids[0]];
          t.e1 = vs[ids[i]] - t.a;
          t.e2 = vs[ids[i + 1]] - t.a;
          t.gn = norm(cross(t.e1, t.e2));
          t.mat = nullptr;
          sc.mesh.tris.push_back(t);
        }
      }
    }
    sc.mesh.mat = Material{LAMBERT, {0.7f, 0.45f, 0.2f}};
    if (!sc.mesh.tris.empty()) sc.mesh.build();
  }

  V3 eye{0, 2.5f, 7.5f};
  float focal = 0.8f;
  std::atomic<long long> segments{0};
  auto t0 = std::chrono::steady_clock::now();

  int nthreads = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> pool;
  std::atomic<int> next_row{0};
  for (int ti = 0; ti < nthreads; ++ti) {
    pool.emplace_back([&, ti] {
      g_rng.seed(1234 + ti);
      long long local_segs = 0;
      for (;;) {
        int y = next_row.fetch_add(1);
        if (y >= H) break;
        for (int x = 0; x < W; ++x) {
          for (int s = 0; s < SPP; ++s) {
            float px = ((x + rnd()) / W - 0.5f) * ((float)W / H);
            float py = 0.5f - (y + rnd()) / H;
            V3 d = norm(V3{px, py, -focal});
            V3 o = eye;
            V3 thr{1, 1, 1};
            for (int depth = 0; depth < DEPTH; ++depth) {
              ++local_segs;
              Hit h;
              if (!sc.intersect(o, d, 0.001f, 100.0f, h)) break;
              const Material& m = *h.mat;
              V3 nd;
              float fac;
              if (m.kind == LAMBERT) {
                V3 b = ball();
                if (dot(b, h.n) < 0) b = b - 2.0f * dot(b, h.n) * h.n;
                nd = b;
                float ct = std::min(1.0f, std::fabs(dot(nd, h.n)));
                fac = 2.0f * ct;  // (albedo/pi)/(1/2pi)*cos
                thr = fac * mul(thr, m.albedo);
              } else if (m.kind == METAL) {
                nd = d - 2.0f * dot(d, h.n) * h.n + m.roughness * ball();
                thr = std::min(1.0f, std::fabs(dot(nd, h.n))) * mul(thr, m.albedo);
              } else {  // GLASS
                float eta = h.front ? 1.0f / m.ior : m.ior;
                float ct = std::min(-dot(d, h.n), 1.0f);
                float k = 1 - eta * eta * (1 - ct * ct);
                float r0 = (m.ior - 1) / (m.ior + 1);
                r0 *= r0;
                float fres = r0 + (1 - r0) * std::pow(1 - std::fabs(dot(d, h.n)), 5.0f);
                if (k < 0 || rnd() < fres) {
                  nd = d - 2.0f * dot(d, h.n) * h.n;
                } else {
                  nd = eta * (d + ct * h.n) - std::sqrt(k) * h.n;
                }
              }
              o = h.p;
              d = nd;
              if (thr.x + thr.y + thr.z < 1e-5f) break;
            }
          }
        }
      }
      segments += local_segs;
    });
  }
  for (auto& t : pool) t.join();
  double wall =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
  printf("segments=%lld wall=%.2f mrays=%.2f threads=%d tris=%zu\n",
         (long long)segments, wall, segments / wall / 1e6, nthreads,
         sc.mesh.tris.size());
  return 0;
}
