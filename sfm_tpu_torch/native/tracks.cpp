// Native track builder (SURVEY.md §2.5) — the framework's C++ runtime
// component, mirroring the reference class's native graph/track code.
//
// Union-find over (image, keypoint) nodes joined by verified inlier
// matches, with path compression + union by size; then component
// collection, per-image-consistency rejection (a track may not visit one
// image twice) and min-length filtering. At Rome16K scale this is ~10^8
// union operations — minutes in Python, well under a second here.
//
// Pure C ABI (ctypes-bound from sfm_tpu_torch/native/__init__.py; no pybind11).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct UnionFind {
    std::vector<int64_t> parent;
    std::vector<int32_t> size;

    explicit UnionFind(int64_t n) : parent(n), size(n, 1) {
        for (int64_t i = 0; i < n; ++i) parent[i] = i;
    }

    int64_t find(int64_t x) {
        int64_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int64_t next = parent[x];
            parent[x] = root;
            x = next;
        }
        return root;
    }

    void unite(int64_t a, int64_t b) {
        int64_t ra = find(a), rb = find(b);
        if (ra == rb) return;
        if (size[ra] < size[rb]) std::swap(ra, rb);
        parent[rb] = ra;
        size[ra] += size[rb];
    }
};

}  // namespace

extern "C" {

// Returns the number of observation rows written (== capacity needed when
// out buffers are null), and writes num_tracks via *num_tracks_out.
//
// pairs:    [E, 2] int32 image index pairs
// ok:       [E] uint8 edge validity
// idx_i/j:  [E, M] int32 keypoint indices
// inlier:   [E, M] uint8 match inlier mask
// Outputs (caller-allocated, capacity cap_rows):
// obs_image/obs_kp/track_id: int32 arrays sorted by track id.
int64_t sfm_build_tracks(
    const int32_t* pairs, const uint8_t* ok,
    const int32_t* idx_i, const int32_t* idx_j, const uint8_t* inlier,
    int64_t num_edges, int64_t m,
    int64_t num_images, int64_t max_kp, int64_t min_length,
    int32_t* obs_image, int32_t* obs_kp, int32_t* track_id,
    int64_t cap_rows, int64_t* num_tracks_out)
{
    const int64_t n_nodes = num_images * max_kp;
    UnionFind uf(n_nodes);
    std::vector<uint8_t> touched(n_nodes, 0);

    for (int64_t e = 0; e < num_edges; ++e) {
        if (!ok[e]) continue;
        const int64_t i = pairs[2 * e], j = pairs[2 * e + 1];
        const int32_t* ii = idx_i + e * m;
        const int32_t* jj = idx_j + e * m;
        const uint8_t* in = inlier + e * m;
        for (int64_t k = 0; k < m; ++k) {
            if (!in[k]) continue;
            const int64_t a = i * max_kp + ii[k];
            const int64_t b = j * max_kp + jj[k];
            uf.unite(a, b);
            touched[a] = touched[b] = 1;
        }
    }

    // Gather touched nodes grouped by root: counting sort by root id.
    std::vector<int64_t> nodes;
    nodes.reserve(1 << 20);
    for (int64_t n = 0; n < n_nodes; ++n)
        if (touched[n]) nodes.push_back(n);
    std::vector<int64_t> roots(nodes.size());
    for (size_t t = 0; t < nodes.size(); ++t) roots[t] = uf.find(nodes[t]);

    std::vector<size_t> order(nodes.size());
    for (size_t t = 0; t < order.size(); ++t) order[t] = t;
    std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
        if (roots[a] != roots[b]) return roots[a] < roots[b];
        return nodes[a] < nodes[b];
    });

    int64_t rows = 0;
    int64_t tracks = 0;
    size_t t = 0;
    std::vector<uint8_t> img_seen(num_images, 0);
    std::vector<int64_t> imgs_used;
    while (t < order.size()) {
        size_t start = t;
        const int64_t root = roots[order[t]];
        while (t < order.size() && roots[order[t]] == root) ++t;
        const int64_t len = static_cast<int64_t>(t - start);
        if (len < min_length) continue;

        // Per-image consistency: reject tracks visiting one image twice.
        bool consistent = true;
        imgs_used.clear();
        for (size_t u = start; u < t; ++u) {
            const int64_t img = nodes[order[u]] / max_kp;
            if (img_seen[img]) { consistent = false; }
            else { img_seen[img] = 1; imgs_used.push_back(img); }
        }
        for (int64_t img : imgs_used) img_seen[img] = 0;
        if (!consistent) continue;

        if (obs_image != nullptr) {
            if (rows + len > cap_rows) return -1;  // caller buffer too small
            for (size_t u = start; u < t; ++u) {
                const int64_t node = nodes[order[u]];
                obs_image[rows] = static_cast<int32_t>(node / max_kp);
                obs_kp[rows] = static_cast<int32_t>(node % max_kp);
                track_id[rows] = static_cast<int32_t>(tracks);
                ++rows;
            }
        } else {
            rows += len;
        }
        ++tracks;
    }
    if (num_tracks_out) *num_tracks_out = tracks;
    return rows;
}

}  // extern "C"
