// Native LBVH builder (counterpart of accel/lbvh.py build_lbvh, its plain
// version).
//
// Same algorithm, same output: Morton-code sort of AABB centroids (30-bit)
// followed by an iterative preorder median split with leaf size <= 4 (the
// reference's leaf bound, Code/acceleration.cpp:30).  The numpy builder is
// the semantics oracle; this one exists because large scenes (10^5+ geoms)
// make the Python build a scene-load bottleneck.
//
// C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

uint32_t spread(uint32_t v) {
    v = (v | (v << 16)) & 0x030000FFu;
    v = (v | (v << 8)) & 0x0300F00Fu;
    v = (v | (v << 4)) & 0x030C30C3u;
    v = (v | (v << 2)) & 0x09249249u;
    return v;
}

struct Range {
    int32_t node, start, end;
};

}  // namespace

extern "C" {

// aabbs: (g, 6) [min xyz | max xyz].  Outputs (caller-allocated):
//   boxes: (2g-1, 6) f32    — only the first *n_nodes rows are written
//   topo:  (2g-1, 4) int32  — [left, right, first, count], left<0 = leaf
//   order: (g,) int64       — Morton-sorted geom order
// Returns n_nodes, or -1 on error.
int64_t lbvh_build(const float* aabbs, int64_t g, int32_t leaf_size,
                   float* boxes, int32_t* topo, int64_t* order) {
    if (g <= 0) return -1;

    // Centroids + normalization bounds.
    std::vector<float> cx(g), cy(g), cz(g);
    float lo[3] = {1e30f, 1e30f, 1e30f};
    float hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = 0; i < g; i++) {
        const float* b = aabbs + i * 6;
        cx[i] = 0.5f * (b[0] + b[3]);
        cy[i] = 0.5f * (b[1] + b[4]);
        cz[i] = 0.5f * (b[2] + b[5]);
        float c[3] = {cx[i], cy[i], cz[i]};
        for (int a = 0; a < 3; a++) {
            lo[a] = std::min(lo[a], c[a]);
            hi[a] = std::max(hi[a], c[a]);
        }
    }
    float span[3];
    for (int a = 0; a < 3; a++) span[a] = hi[a] - lo[a] > 0 ? hi[a] - lo[a] : 1.0f;

    std::vector<std::pair<uint64_t, int64_t>> keyed(g);
    for (int64_t i = 0; i < g; i++) {
        auto q = [&](float c, int a) -> uint32_t {
            float t = (c - lo[a]) / span[a] * 1023.0f;
            if (t < 0) t = 0;
            if (t > 1023) t = 1023;
            return (uint32_t)t;
        };
        uint64_t code = ((uint64_t)spread(q(cx[i], 0)) << 2) |
                        ((uint64_t)spread(q(cy[i], 1)) << 1) |
                        (uint64_t)spread(q(cz[i], 2));
        keyed[i] = {code, i};
    }
    std::stable_sort(keyed.begin(), keyed.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    for (int64_t i = 0; i < g; i++) order[i] = keyed[i].second;

    // Iterative preorder median split.
    int64_t n_nodes = 0;
    std::vector<Range> stack;
    stack.push_back({(int32_t)n_nodes++, 0, (int32_t)g});
    while (!stack.empty()) {
        Range r = stack.back();
        stack.pop_back();
        float bmin[3] = {1e30f, 1e30f, 1e30f};
        float bmax[3] = {-1e30f, -1e30f, -1e30f};
        for (int32_t i = r.start; i < r.end; i++) {
            const float* b = aabbs + order[i] * 6;
            for (int a = 0; a < 3; a++) {
                bmin[a] = std::min(bmin[a], b[a]);
                bmax[a] = std::max(bmax[a], b[a + 3]);
            }
        }
        float* out_box = boxes + (int64_t)r.node * 6;
        std::memcpy(out_box, bmin, 12);
        std::memcpy(out_box + 3, bmax, 12);
        int32_t* out_topo = topo + (int64_t)r.node * 4;
        int32_t count = r.end - r.start;
        if (count <= leaf_size) {
            out_topo[0] = -1;
            out_topo[1] = -1;
            out_topo[2] = r.start;
            out_topo[3] = count;
            continue;
        }
        int32_t mid = (r.start + r.end) / 2;
        int32_t left = (int32_t)n_nodes++;
        int32_t right = (int32_t)n_nodes++;
        out_topo[0] = left;
        out_topo[1] = right;
        out_topo[2] = 0;
        out_topo[3] = 0;
        stack.push_back({right, mid, r.end});
        stack.push_back({left, r.start, mid});
    }
    return n_nodes;
}

}  // extern "C"
