// Mesh over-segmentation via Felzenszwalb-Huttenlocher graph segmentation.
//
// A copy of the JAX package's pbnet_tpu/native/segmentator/segmentator.cc
// (the equivalent of PBNet's lib/segmentator/csrc/segmentator.cpp, itself
// the public ScanNet Segmentator / https://cs.brown.edu/~pff/segment/), with
// a plain C ABI for ctypes binding (no torch/pybind11).
//
// Semantics kept identical to the reference:
//  * vertex normals accumulated by incremental lerp of (normalized) face
//    normals in face order
//  * edge weight w = 1 - n1.n2, squared when the edge is "convex"
//    (n2 . normalize(p2-p1) > 0)
//  * Felzenszwalb merge with adaptive threshold thr = w + c/size
//  * second pass joins segments smaller than seg_min_verts
//  * output: representative vertex id per vertex (compacted in Python)
//
// Built at first use by pbnet_torch/native/segmentator/__init__.py:
//   g++ -O3 -shared -fPIC -o <build>/segmentator-<hash>.so segmentator.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int> parent, rank_, size_;
  explicit UnionFind(int n) : parent(n), rank_(n, 0), size_(n, 1) {
    for (int i = 0; i < n; ++i) parent[i] = i;
  }
  int find(int x) {
    int root = x;
    while (root != parent[root]) root = parent[root];
    parent[x] = root;
    return root;
  }
  void join(int a, int b) {
    if (rank_[a] > rank_[b]) {
      parent[b] = a;
      size_[a] += size_[b];
    } else {
      parent[a] = b;
      size_[b] += size_[a];
      if (rank_[a] == rank_[b]) rank_[b]++;
    }
  }
  int size(int x) const { return size_[x]; }
};

struct Edge {
  float w;
  int a, b;
};

void felzenszwalb(int num_vertices, std::vector<Edge>& edges, float c,
                  int seg_min_verts, int* out) {
  std::stable_sort(edges.begin(), edges.end(),
                   [](const Edge& x, const Edge& y) { return x.w < y.w; });
  UnionFind u(num_vertices);
  std::vector<float> threshold(num_vertices, c);
  for (const Edge& e : edges) {
    int a = u.find(e.a);
    int b = u.find(e.b);
    if (a != b && e.w <= threshold[a] && e.w <= threshold[b]) {
      u.join(a, b);
      a = u.find(a);
      threshold[a] = e.w + c / u.size(a);
    }
  }
  for (const Edge& e : edges) {
    int a = u.find(e.a);
    int b = u.find(e.b);
    if (a != b && (u.size(a) < seg_min_verts || u.size(b) < seg_min_verts))
      u.join(a, b);
  }
  for (int q = 0; q < num_vertices; ++q) out[q] = u.find(q);
}

struct V3 {
  float x = 0, y = 0, z = 0;
};

inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

inline V3 cross_unit(const V3& u, const V3& v) {
  V3 c{u.y * v.z - u.z * v.y, u.z * v.x - u.x * v.z, u.x * v.y - u.y * v.x};
  float n = std::sqrt(c.x * c.x + c.y * c.y + c.z * c.z);
  c.x /= n; c.y /= n; c.z /= n;
  return c;
}

inline V3 lerp(const V3& a, const V3& b, float v) {
  float uu = 1.0f - v;
  return {v * b.x + uu * a.x, v * b.y + uu * a.y, v * b.z + uu * a.z};
}

inline float edge_weight(const V3& n1, const V3& n2, const V3& p1, const V3& p2) {
  float dx = p2.x - p1.x, dy = p2.y - p1.y, dz = p2.z - p1.z;
  float dd = std::sqrt(dx * dx + dy * dy + dz * dz);
  dx /= dd; dy /= dd; dz /= dd;
  float dot = n1.x * n2.x + n1.y * n2.y + n1.z * n2.z;
  float dot2 = n2.x * dx + n2.y * dy + n2.z * dz;
  float w = 1.0f - dot;
  if (dot2 > 0) w = w * w;  // soften convex normal differences
  return w;
}

}  // namespace

extern "C" {

// Segment a triangle mesh.  verts: (V,3) f32, faces: (F,3) i64.
// out: (V,) i32 representative ids.
void segment_mesh(const float* verts, int64_t vertex_count,
                  const int64_t* faces, int64_t face_count, float kthr,
                  int seg_min_verts, int* out) {
  std::vector<V3> points(vertex_count), normals(vertex_count);
  std::vector<int> counts(vertex_count, 0);
  std::vector<Edge> edges(face_count * 3);

  for (int64_t i = 0; i < face_count; ++i) {
    int64_t i1 = faces[3 * i], i2 = faces[3 * i + 1], i3 = faces[3 * i + 2];
    V3 p1{verts[3 * i1], verts[3 * i1 + 1], verts[3 * i1 + 2]};
    V3 p2{verts[3 * i2], verts[3 * i2 + 1], verts[3 * i2 + 2]};
    V3 p3{verts[3 * i3], verts[3 * i3 + 1], verts[3 * i3 + 2]};
    points[i1] = p1;
    points[i2] = p2;
    points[i3] = p3;
    edges[3 * i] = {0.f, (int)i1, (int)i2};
    edges[3 * i + 1] = {0.f, (int)i1, (int)i3};
    edges[3 * i + 2] = {0.f, (int)i3, (int)i2};
    V3 fn = cross_unit(sub(p2, p1), sub(p3, p1));
    normals[i1] = lerp(normals[i1], fn, 1.0f / (counts[i1] + 1.0f));
    normals[i2] = lerp(normals[i2], fn, 1.0f / (counts[i2] + 1.0f));
    normals[i3] = lerp(normals[i3], fn, 1.0f / (counts[i3] + 1.0f));
    counts[i1]++; counts[i2]++; counts[i3]++;
  }
  for (Edge& e : edges)
    e.w = edge_weight(normals[e.a], normals[e.b], points[e.a], points[e.b]);

  felzenszwalb((int)vertex_count, edges, kthr, seg_min_verts, out);
}

// Segment an arbitrary point graph: points+normals (N,3) f32, edges (E,2) i64.
void segment_point(const float* points_f, const float* normals_f,
                   int64_t point_count, const int64_t* edge_idx,
                   int64_t edge_count, float kthr, int seg_min_verts,
                   int* out) {
  std::vector<Edge> edges(edge_count);
  for (int64_t i = 0; i < edge_count; ++i) {
    int a = (int)edge_idx[2 * i], b = (int)edge_idx[2 * i + 1];
    V3 n1{normals_f[3 * a], normals_f[3 * a + 1], normals_f[3 * a + 2]};
    V3 n2{normals_f[3 * b], normals_f[3 * b + 1], normals_f[3 * b + 2]};
    V3 p1{points_f[3 * a], points_f[3 * a + 1], points_f[3 * a + 2]};
    V3 p2{points_f[3 * b], points_f[3 * b + 1], points_f[3 * b + 2]};
    edges[i] = {edge_weight(n1, n2, p1, p2), a, b};
  }
  felzenszwalb((int)point_count, edges, kthr, seg_min_verts, out);
}

}  // extern "C"
