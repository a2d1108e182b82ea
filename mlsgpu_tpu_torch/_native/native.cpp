// Native runtime components for mlsgpu_tpu.
//
// The reference implements its entire host runtime in C++ (union-find
// src/union_find.h, mesher hash maps src/mesher.h:349-352, PLY decode
// src/fast_ply.cpp:334). These are the host-side hot paths at
// billion-splat scale, so they are native here too: a batch union-find
// operating on numpy-owned buffers, a 64-bit open-addressing hash map with
// batch get-or-insert (the mesher's key->clump / key->index maps), and a
// vectorized PLY record decoder.
//
// Plain C ABI, loaded via ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- unionfind
// Iterative find with path halving. parent is an int64 numpy buffer.
static inline int64_t uf_find(int64_t* parent, int64_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

void mls_uf_find_many(int64_t* parent, const int64_t* xs, int64_t* out,
                      int64_t n) {
    for (int64_t i = 0; i < n; i++) out[i] = uf_find(parent, xs[i]);
}

// Merge pairs, maintaining size plus up to `n_meta` extra int64 metadata
// arrays that accumulate child totals into the root (the reference's
// UnionFind node-metadata merge hook, src/union_find.h:51-212).
void mls_uf_merge_pairs(int64_t* parent, int64_t* size,
                        int64_t** meta, int64_t n_meta,
                        const int64_t* a, const int64_t* b, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        int64_t ra = uf_find(parent, a[i]);
        int64_t rb = uf_find(parent, b[i]);
        if (ra == rb) continue;
        if (size[ra] < size[rb]) { int64_t t = ra; ra = rb; rb = t; }
        parent[rb] = ra;
        size[ra] += size[rb];
        for (int64_t m = 0; m < n_meta; m++) meta[m][ra] += meta[m][rb];
    }
}

// ------------------------------------------------------------------ keymap
// Open-addressing hash map int64 -> int64 (linear probing, power-of-two
// capacity). EMPTY slots use key = INT64_MIN.
struct KeyMap {
    std::vector<int64_t> keys;
    std::vector<int64_t> vals;
    int64_t count;
    int64_t mask;
};

static const int64_t KM_EMPTY = INT64_MIN;

static void km_grow(KeyMap* km);

void* mls_keymap_new(int64_t capacity_hint) {
    KeyMap* km = new KeyMap();
    int64_t cap = 1024;
    while (cap < capacity_hint * 2) cap <<= 1;
    km->keys.assign(cap, KM_EMPTY);
    km->vals.assign(cap, 0);
    km->count = 0;
    km->mask = cap - 1;
    return km;
}

void mls_keymap_free(void* h) { delete static_cast<KeyMap*>(h); }

int64_t mls_keymap_size(void* h) { return static_cast<KeyMap*>(h)->count; }

static inline int64_t km_hash(int64_t k) {
    uint64_t x = (uint64_t)k;
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return (int64_t)x;
}

static void km_grow(KeyMap* km) {
    std::vector<int64_t> ok = std::move(km->keys);
    std::vector<int64_t> ov = std::move(km->vals);
    int64_t ncap = (km->mask + 1) * 2;
    km->keys.assign(ncap, KM_EMPTY);
    km->vals.assign(ncap, 0);
    km->mask = ncap - 1;
    for (size_t i = 0; i < ok.size(); i++) {
        if (ok[i] == KM_EMPTY) continue;
        int64_t slot = km_hash(ok[i]) & km->mask;
        while (km->keys[slot] != KM_EMPTY) slot = (slot + 1) & km->mask;
        km->keys[slot] = ok[i];
        km->vals[slot] = ov[i];
    }
}

// For each key: if present, out_vals = stored value, out_new = 0;
// else insert insert_vals[i], out_vals = insert_vals[i], out_new = 1.
void mls_keymap_get_or_insert(void* h, const int64_t* keys, int64_t n,
                              const int64_t* insert_vals,
                              int64_t* out_vals, uint8_t* out_new) {
    KeyMap* km = static_cast<KeyMap*>(h);
    for (int64_t i = 0; i < n; i++) {
        if ((km->count + 1) * 4 >= (km->mask + 1) * 3) km_grow(km);
        int64_t k = keys[i];
        int64_t slot = km_hash(k) & km->mask;
        while (true) {
            if (km->keys[slot] == k) {
                out_vals[i] = km->vals[slot];
                out_new[i] = 0;
                break;
            }
            if (km->keys[slot] == KM_EMPTY) {
                km->keys[slot] = k;
                km->vals[slot] = insert_vals[i];
                km->count++;
                out_vals[i] = insert_vals[i];
                out_new[i] = 1;
                break;
            }
            slot = (slot + 1) & km->mask;
        }
    }
}

void mls_keymap_lookup(void* h, const int64_t* keys, int64_t n,
                       int64_t* out_vals) {
    KeyMap* km = static_cast<KeyMap*>(h);
    for (int64_t i = 0; i < n; i++) {
        int64_t k = keys[i];
        int64_t slot = km_hash(k) & km->mask;
        out_vals[i] = -1;
        while (km->keys[slot] != KM_EMPTY) {
            if (km->keys[slot] == k) { out_vals[i] = km->vals[slot]; break; }
            slot = (slot + 1) & km->mask;
        }
    }
}

// Dump all items (for checkpointing). out_keys/out_vals sized keymap_size.
void mls_keymap_items(void* h, int64_t* out_keys, int64_t* out_vals) {
    KeyMap* km = static_cast<KeyMap*>(h);
    int64_t j = 0;
    for (size_t i = 0; i < km->keys.size(); i++) {
        if (km->keys[i] == KM_EMPTY) continue;
        out_keys[j] = km->keys[i];
        out_vals[j] = km->vals[i];
        j++;
    }
}

// -------------------------------------------------------------- ply decode
// Decode n fixed-stride little-endian records into the (n, 8) splat layout
// [x y z radius nx ny nz quality], applying the radius clamp + smooth scale
// and quality = 1/r^2 (src/fast_ply.cpp:334-350). offsets: byte offsets of
// x,y,z,nx,ny,nz,radius within a record.
static void decode_range(const char* buf, int64_t lo, int64_t hi,
                         int64_t stride, const int64_t* offsets,
                         float smooth, float max_radius, float* out) {
    for (int64_t i = lo; i < hi; i++) {
        const char* rec = buf + i * stride;
        float f[7];
        for (int j = 0; j < 7; j++)
            std::memcpy(&f[j], rec + offsets[j], 4);
        float r = f[6];
        if (r > max_radius) r = max_radius;  // NaN compares false: preserved
        r *= smooth;
        float* o = out + i * 8;
        o[0] = f[0]; o[1] = f[1]; o[2] = f[2];
        o[3] = r;
        o[4] = f[3]; o[5] = f[4]; o[6] = f[5];
        o[7] = 1.0f / (r * r);
    }
}

void mls_decode_splats(const char* buf, int64_t n, int64_t stride,
                       const int64_t* offsets, float smooth,
                       float max_radius, float* out) {
    decode_range(buf, 0, n, stride, offsets, smooth, max_radius, out);
}

// Parallel decode over row ranges (the reference's OpenMP decode loop,
// src/splat_set.cpp:213). Rows are independent, so a plain static split
// across std::threads suffices; callers pass nthreads = hardware cores.
void mls_decode_splats_mt(const char* buf, int64_t n, int64_t stride,
                          const int64_t* offsets, float smooth,
                          float max_radius, float* out, int64_t nthreads) {
    if (nthreads <= 1 || n < 1 << 16) {
        decode_range(buf, 0, n, stride, offsets, smooth, max_radius, out);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve((size_t)nthreads);
    for (int64_t t = 0; t < nthreads; t++) {
        int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
        threads.emplace_back(decode_range, buf, lo, hi, stride, offsets,
                             smooth, max_radius, out);
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------- blob RLE
// One pass of the blob precompute (pipeline/blobs.py, the reference's
// FastBlobSet::computeBlobs src/splat_set_impl.h:669-726): per-splat
// microblock ranges, run-length encoding against the carried run, cell
// bounding box and non-finite count. Float expressions mirror the numpy
// path exactly (f32 subtract/multiply then floorf) so the python and
// native paths produce identical blobs.
static inline int64_t floordiv_i64(int64_t a, int64_t b) {
    int64_t q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

int64_t mls_blob_rle(const float* splats, int64_t n, int64_t first_id,
                     float inv_spacing, int64_t micro,
                     int64_t* carry,      // [valid, start, count, lo0..2, hi0..2]
                     int64_t* bbox,       // [min0..2, max0..2] (in/out)
                     int64_t* nonfinite,  // in/out
                     int64_t* out_start, int64_t* out_count,
                     int64_t* out_lo, int64_t* out_hi) {
    int64_t k = 0;
    for (int64_t i = 0; i < n; i++) {
        const float* s = splats + i * 8;
        bool finite = true;
        for (int j = 0; j < 8; j++) finite = finite && std::isfinite(s[j]);
        finite = finite && (s[3] > 0.0f);
        if (!finite) {
            (*nonfinite)++;
            if (carry[0]) {  // close the carried run
                out_start[k] = carry[1];
                out_count[k] = carry[2];
                for (int a = 0; a < 3; a++) {
                    out_lo[k * 3 + a] = carry[3 + a];
                    out_hi[k * 3 + a] = carry[6 + a];
                }
                k++;
                carry[0] = 0;
            }
            continue;
        }
        int64_t mlo[3], mhi[3];
        for (int a = 0; a < 3; a++) {
            float p = s[a], r = s[3];
            int64_t lo_c = (int64_t)std::floor((double)(float)((p - r) * inv_spacing));
            int64_t hi_c = (int64_t)std::floor((double)(float)((p + r) * inv_spacing));
            if (lo_c < bbox[a]) bbox[a] = lo_c;
            if (hi_c > bbox[3 + a]) bbox[3 + a] = hi_c;
            mlo[a] = floordiv_i64(lo_c, micro);
            mhi[a] = floordiv_i64(hi_c, micro);
        }
        bool same = carry[0] != 0;
        for (int a = 0; a < 3 && same; a++)
            same = (carry[3 + a] == mlo[a]) && (carry[6 + a] == mhi[a]);
        if (same) {
            carry[2]++;
        } else {
            if (carry[0]) {
                out_start[k] = carry[1];
                out_count[k] = carry[2];
                for (int a = 0; a < 3; a++) {
                    out_lo[k * 3 + a] = carry[3 + a];
                    out_hi[k * 3 + a] = carry[6 + a];
                }
                k++;
            }
            carry[0] = 1;
            carry[1] = first_id + i;
            carry[2] = 1;
            for (int a = 0; a < 3; a++) {
                carry[3 + a] = mlo[a];
                carry[6 + a] = mhi[a];
            }
        }
    }
    return k;
}

// ---------------------------------------------------------- packed readback
// Native decode of ops/block._pack_readback's single-transfer buffer
// (layout documented at ops/block.py PackFormat). Bitwise-identical to the
// numpy unpack_readback path: every float op replicates the numpy
// expression order ((float)base + frac, then + (float)cell_origin).
// index_mode: 0 = u16, 1 = u21x3, 2 = u32.
void mls_unpack_readback(const uint32_t* flat, int64_t ni, int64_t nv,
                         int64_t fe, int32_t index_mode,
                         int32_t vertex_words,
                         const int64_t* cell_origin,
                         float* out_verts,     // (nv, 3) global grid coords
                         int32_t* out_tris,    // (ni/3, 3)
                         int64_t* out_keys) {  // (nv - fe,)
    int64_t iw;
    if (index_mode == 0) {
        iw = (ni + 1) / 2;
        const uint16_t* u16 = reinterpret_cast<const uint16_t*>(flat);
        for (int64_t i = 0; i < ni; i++) out_tris[i] = (int32_t)u16[i];
    } else if (index_mode == 1) {
        iw = 2 * (ni / 3);
        const uint32_t m21 = 0x1FFFFF;
        for (int64_t t = 0; t < ni / 3; t++) {
            uint32_t w0 = flat[2 * t], w1 = flat[2 * t + 1];
            out_tris[3 * t + 0] = (int32_t)(w0 & m21);
            out_tris[3 * t + 1] =
                (int32_t)(((w0 >> 21) | ((w1 & 0x3FFu) << 11)) & m21);
            out_tris[3 * t + 2] = (int32_t)((w1 >> 10) & m21);
        }
    } else {
        iw = ni;
        const int32_t* raw = reinterpret_cast<const int32_t*>(flat);
        for (int64_t i = 0; i < ni; i++) out_tris[i] = raw[i];
    }

    const uint16_t* words =
        reinterpret_cast<const uint16_t*>(flat + iw);
    const float co_f[3] = {(float)cell_origin[0], (float)cell_origin[1],
                           (float)cell_origin[2]};
    for (int64_t i = 0; i < nv; i++) {
        int32_t base[3], parity[3];
        bool dirb[3];
        uint32_t t16;
        if (vertex_words == 3) {
            const uint16_t* w = words + i * 3;
            uint32_t tp[3];
            for (int a = 0; a < 3; a++) {
                base[a] = (int32_t)(w[a] & 0xFF);
                parity[a] = (int32_t)((w[a] >> 8) & 1);
                dirb[a] = ((w[a] >> 9) & 1) != 0;
                tp[a] = (uint32_t)(w[a] >> 10);
            }
            t16 = (tp[0] & 0x3F) | ((tp[1] & 0x3F) << 6)
                | ((tp[2] & 0xF) << 12);
        } else {
            const uint16_t* w = words + i * 4;
            for (int a = 0; a < 3; a++) {
                base[a] = (int32_t)(w[a] & 0x1FFF);
                parity[a] = (int32_t)((w[a] >> 13) & 1);
                dirb[a] = ((w[a] >> 14) & 1) != 0;
            }
            t16 = (uint32_t)w[3];
        }
        float t = (float)t16 / 65535.0f;
        for (int a = 0; a < 3; a++) {
            float frac = (parity[a] == 1) ? (dirb[a] ? 1.0f - t : t) : 0.0f;
            out_verts[i * 3 + a] = ((float)base[a] + frac) + co_f[a];
        }
        if (i >= fe) {
            int64_t kg0 = 2 * (int64_t)base[0] + parity[0]
                + 2 * cell_origin[0];
            int64_t kg1 = 2 * (int64_t)base[1] + parity[1]
                + 2 * cell_origin[1];
            int64_t kg2 = 2 * (int64_t)base[2] + parity[2]
                + 2 * cell_origin[2];
            out_keys[i - fe] = kg0 | (kg1 << 21) | (kg2 << 42);
        }
    }
}

// --------------------------------------------------------------- mesher add
// OOCMesher.add (pipeline/mesher.py; the reference's OOCMesher::add,
// src/mesher.cpp:447-468) in two calls. mls_mesher_prepare reads the block
// alone, so several blocks prepare at once on other threads: local
// components over the block triangles, labelled by root index order, each
// label's vertex and triangle counts, a vertex record per vertex (its local
// label in the clump lane), the triangle records in block-local ids and the
// list of their slots that name an external vertex. mls_mesher_commit, in
// block order, does what depends on the blocks before: global clump
// registration + key-based cross-block merging, chunk-local external
// dedup, and the records' chunk ids. The Python numpy path remains as the
// fallback; this produces the same mesh (clump id numbering may differ
// from the numpy path, which only affects internal temp state, never
// output geometry).

// Returns num_local, or -1 when a triangle index is out of range (caller
// raises the corrupt-block error). label_nv and label_nt hold n entries,
// ext_slots 3 m; *out_num_slots gets the slots listed.
int64_t mls_mesher_prepare(const float* verts, int64_t n,
                           const int32_t* tris, int64_t m, int64_t first_ext,
                           int64_t* label_nv, int64_t* label_nt,
                           uint32_t* vrec, uint32_t* trec,
                           int64_t* ext_slots, int64_t* out_num_slots) {
    // Local components (union by size, path halving).
    std::vector<int32_t> parent((size_t)n), sz((size_t)n, 1);
    for (int64_t i = 0; i < n; i++) parent[(size_t)i] = (int32_t)i;
    auto lfind = [&](int32_t x) {
        while (parent[(size_t)x] != x) {
            parent[(size_t)x] = parent[(size_t)parent[(size_t)x]];
            x = parent[(size_t)x];
        }
        return x;
    };
    for (int64_t t = 0; t < m; t++) {
        int32_t a = tris[t * 3], b = tris[t * 3 + 1], c = tris[t * 3 + 2];
        if (a < 0 || b < 0 || c < 0 || a >= n || b >= n || c >= n) return -1;
        for (int k = 0; k < 2; k++) {
            int32_t ra = lfind(a), rb = lfind(k == 0 ? b : c);
            if (ra == rb) continue;
            if (sz[(size_t)ra] < sz[(size_t)rb]) std::swap(ra, rb);
            parent[(size_t)rb] = ra;
            sz[(size_t)ra] += sz[(size_t)rb];
        }
    }
    // Label components by root index order, in the records' clump lane;
    // count verts/tris per label.
    int64_t num_local = 0;
    for (int64_t i = 0; i < n; i++)
        if (lfind((int32_t)i) == (int32_t)i)
            vrec[i * 4 + 3] = (uint32_t)num_local++;
    for (int64_t j = 0; j < num_local; j++) label_nv[j] = label_nt[j] = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t* row = vrec + i * 4;
        std::memcpy(row, verts + i * 3, 12);
        row[3] = vrec[(int64_t)lfind((int32_t)i) * 4 + 3];
        label_nv[row[3]]++;
    }
    int64_t ns = 0;
    for (int64_t t = 0; t < m * 3; t++) {
        trec[t] = (uint32_t)tris[t];
        if (tris[t] >= first_ext) ext_slots[ns++] = t;
    }
    for (int64_t t = 0; t < m; t++) label_nt[vrec[(int64_t)tris[t * 3] * 4 + 3]]++;
    *out_num_slots = ns;
    return num_local;
}

static inline void global_union(int64_t* parent, int64_t* size,
                                int64_t* nv, int64_t* nt,
                                int64_t a, int64_t b) {
    int64_t ra = uf_find(parent, a);
    int64_t rb = uf_find(parent, b);
    if (ra == rb) return;
    if (size[ra] < size[rb]) { int64_t t = ra; ra = rb; rb = t; }
    parent[rb] = ra;
    size[ra] += size[rb];
    nv[ra] += nv[rb];
    nt[ra] += nt[rb];
}

// The prepared block's records become the chunk's in place: vrec's rows
// compacted to the n_new written (internals first, then the externals
// whose key the chunk has not seen) with their global clump ids, trec's
// ids the chunk's. Returns n_new.
// out_stats: [new_global_keys, new_chunk_keys].
int64_t mls_mesher_commit(int64_t n, int64_t m, int64_t first_ext,
                          const int64_t* keys, int64_t num_local,
                          const int64_t* label_nv, const int64_t* label_nt,
                          const int64_t* ext_slots, int64_t num_slots,
                          uint32_t* vrec, uint32_t* trec,
                          int64_t* cl_parent, int64_t* cl_size,
                          int64_t* cl_nv, int64_t* cl_nt, int64_t base,
                          void* key_clump_h, void* chunk_keys_h,
                          int64_t chunk_nv_base, int64_t* out_stats) {
    // 1. Register new global clumps [base, base + num_local).
    for (int64_t j = 0; j < num_local; j++) {
        cl_parent[base + j] = base + j;
        cl_size[base + j] = 1;
        cl_nv[base + j] = label_nv[j];
        cl_nt[base + j] = label_nt[j];
    }

    // 2. Cross-block clump merge via shared external keys.
    KeyMap* gk = static_cast<KeyMap*>(key_clump_h);
    int64_t new_global = 0;
    for (int64_t i = first_ext; i < n; i++) {
        int64_t k = keys[i - first_ext];
        int64_t c = base + (int64_t)vrec[i * 4 + 3];
        if ((gk->count + 1) * 4 >= (gk->mask + 1) * 3) km_grow(gk);
        int64_t slot = km_hash(k) & gk->mask;
        while (true) {
            if (gk->keys[(size_t)slot] == k) {
                int64_t prev = gk->vals[(size_t)slot];
                if (prev != c)
                    global_union(cl_parent, cl_size, cl_nv, cl_nt, prev, c);
                break;
            }
            if (gk->keys[(size_t)slot] == KM_EMPTY) {
                gk->keys[(size_t)slot] = k;
                gk->vals[(size_t)slot] = c;
                gk->count++;
                new_global++;
                break;
            }
            slot = (slot + 1) & gk->mask;
        }
    }

    // 3. Chunk-local dedup of the externals + record compaction. An
    // internal i is always written, as chunk vertex chunk_nv_base + i.
    // Lookup-only during the pass (so duplicate in-block keys each get
    // their own row, matching the numpy path), inserts deferred (first id
    // wins).
    const uint32_t clump_base = (uint32_t)base;
    for (int64_t i = 0; i < first_ext; i++) vrec[i * 4 + 3] += clump_base;
    KeyMap* ck = static_cast<KeyMap*>(chunk_keys_h);
    std::vector<int64_t> remap((size_t)(n - first_ext));
    std::vector<int64_t> nkeys, nvals;
    int64_t running = chunk_nv_base + first_ext;
    int64_t n_new = first_ext;
    for (int64_t i = first_ext; i < n; i++) {
        int64_t k = keys[i - first_ext];
        int64_t mapped = -1;
        int64_t slot = km_hash(k) & ck->mask;
        while (ck->keys[(size_t)slot] != KM_EMPTY) {
            if (ck->keys[(size_t)slot] == k) {
                mapped = ck->vals[(size_t)slot];
                break;
            }
            slot = (slot + 1) & ck->mask;
        }
        if (mapped < 0) {
            nkeys.push_back(k);
            nvals.push_back(running);
            uint32_t* row = vrec + n_new * 4;
            uint32_t label = vrec[i * 4 + 3];
            std::memmove(row, vrec + i * 4, 12);
            row[3] = label + clump_base;
            mapped = running++;
            n_new++;
        }
        remap[(size_t)(i - first_ext)] = mapped;
    }
    if (!nkeys.empty()) {
        std::vector<uint8_t> tmp_new(nkeys.size());
        std::vector<int64_t> tmp_val(nkeys.size());
        mls_keymap_get_or_insert(ck, nkeys.data(), (int64_t)nkeys.size(),
                                 nvals.data(), tmp_val.data(),
                                 tmp_new.data());
    }

    // 4. Triangle records: the listed external slots take their vertex's
    // chunk id less the base, then every slot gets the base (mod 2^32,
    // as the records store it).
    const uint32_t vert_base = (uint32_t)chunk_nv_base;
    for (int64_t s = 0; s < num_slots; s++) {
        int64_t t = ext_slots[s];
        trec[t] = (uint32_t)remap[(size_t)((int64_t)trec[t] - first_ext)]
            - vert_base;
    }
    for (int64_t t = 0; t < m * 3; t++) trec[t] += vert_base;

    out_stats[0] = new_global;
    out_stats[1] = (int64_t)nkeys.size();
    return n_new;
}

// ------------------------------------------------------------ block rebuild
// Host-side rebuild of a welded block mesh from the codes-mode readback
// (ops/marching.py BlockCodes): per occupied cell a flat id + case code,
// per emitted vertex a 16-bit interpolant. Replays the device's output-
// driven emission (same tables, same order), computes vertex keys and
// positions exactly as the packed-readback decode does (base + {0,t,1-t}
// + origin, t = t16/65535), and welds by key with first-occurrence order
// (internals compacted before externals). This replaces the reference's
// on-device weld + index remap (kernels/marching.cl:271-345) when the
// device ships codes instead of a mesh.
//
// Returns n_welded, or -1 when the emission replay disagrees with the
// device totals (corrupt readback).
struct RebuildMap {
    std::vector<uint64_t> keys;
    std::vector<int32_t> vals;
    uint64_t mask;
};

static inline uint64_t rb_hash(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

int64_t mls_rebuild_block(
    const uint32_t* cells, const uint8_t* codes, const uint16_t* t16,
    int64_t num_cells, int64_t num_unwelded, int64_t num_indices,
    int64_t nc_axis, const int64_t* cell_origin,
    const int64_t* region_cells,
    const int32_t* vert_tab, int64_t mv,
    const int32_t* index_tab, int64_t mi,
    const int32_t* edges, const int32_t* edge_key,
    const int32_t* count_tab,
    float* out_verts, int32_t* out_tris, int64_t* out_keys,
    int64_t* out_counts) {
    // weld hash map: key -> wid (first-occurrence order)
    uint64_t cap = 64;
    while (cap < (uint64_t)num_unwelded * 2 + 2) cap <<= 1;
    std::vector<uint64_t> hkeys(cap, ~0ULL);
    std::vector<int32_t> hvals(cap);
    uint64_t mask = cap - 1;

    std::vector<int32_t> slot_wid((size_t)num_unwelded);
    // per-wid data (worst case one per slot)
    std::vector<float> wpos((size_t)num_unwelded * 3);
    std::vector<int64_t> wkey63((size_t)num_unwelded);
    std::vector<uint8_t> wext((size_t)num_unwelded);

    const float org_f[3] = {(float)cell_origin[0], (float)cell_origin[1],
                            (float)cell_origin[2]};
    int64_t slot = 0;
    int32_t n_wid = 0;
    for (int64_t i = 0; i < num_cells; i++) {
        uint32_t cid = cells[i];
        int code = codes[i];
        int64_t cx = cid % nc_axis;
        int64_t cy = (cid / nc_axis) % nc_axis;
        int64_t cz = cid / (nc_axis * nc_axis);
        // Occupied cells are region-masked on device; a decode outside the
        // region means the cell-id stride (nc_axis) disagrees with the
        // producing program — fail loudly instead of welding garbage.
        if (cx >= region_cells[0] || cy >= region_cells[1]
            || cz >= region_cells[2]) return -1;
        int cnv = count_tab[code * 2];
        for (int j = 0; j < cnv; j++, slot++) {
            if (slot >= num_unwelded) return -1;
            int e = vert_tab[code * mv + j];
            if (e < 0) return -1;
            int c0 = edges[e * 2], c1 = edges[e * 2 + 1];
            int64_t kl[3], kg[3];
            bool ext = false;
            const int64_t cc[3] = {cx, cy, cz};
            for (int a = 0; a < 3; a++) {
                kl[a] = 2 * cc[a] + edge_key[e * 3 + a];
                if (kl[a] == 0 || kl[a] == 2 * region_cells[a]) ext = true;
                kg[a] = kl[a] + 2 * cell_origin[a];
            }
            uint64_t wk = ((uint64_t)(ext ? 1 : 0) << 63)
                | ((uint64_t)kg[2] << 42) | ((uint64_t)kg[1] << 21)
                | (uint64_t)kg[0];
            uint64_t s = rb_hash(wk) & mask;
            int32_t wid;
            while (true) {
                if (hkeys[s] == wk) { wid = hvals[s]; break; }
                if (hkeys[s] == ~0ULL) {
                    hkeys[s] = wk;
                    wid = hvals[s] = n_wid++;
                    // first occurrence: compute position + 63-bit key
                    float t = (float)t16[slot] / 65535.0f;
                    for (int a = 0; a < 3; a++) {
                        int o0 = (c0 >> a) & 1, o1 = (c1 >> a) & 1;
                        float frac = (o0 == o1) ? 0.0f
                            : (o0 == 0 ? t : 1.0f - t);
                        wpos[(size_t)wid * 3 + a] =
                            ((float)(kl[a] >> 1) + frac) + org_f[a];
                    }
                    wkey63[(size_t)wid] = kg[0] | (kg[1] << 21)
                        | (kg[2] << 42);
                    wext[(size_t)wid] = ext ? 1 : 0;
                    break;
                }
                s = (s + 1) & mask;
            }
            slot_wid[(size_t)slot] = wid;
        }
    }
    if (slot != num_unwelded) return -1;

    // final ids: internals first (stable within class)
    std::vector<int32_t> fid((size_t)n_wid);
    int32_t n_int = 0;
    for (int32_t w = 0; w < n_wid; w++) if (!wext[(size_t)w]) n_int++;
    int32_t ipos = 0, epos = n_int;
    for (int32_t w = 0; w < n_wid; w++)
        fid[(size_t)w] = wext[(size_t)w] ? epos++ : ipos++;
    for (int32_t w = 0; w < n_wid; w++) {
        int32_t f = fid[(size_t)w];
        std::memcpy(out_verts + (size_t)f * 3, wpos.data() + (size_t)w * 3,
                    12);
        if (wext[(size_t)w]) out_keys[f - n_int] = wkey63[(size_t)w];
    }

    // triangles: replay the per-cell index tables
    int64_t tpos = 0, vbase = 0;
    for (int64_t i = 0; i < num_cells; i++) {
        int code = codes[i];
        int cni = count_tab[code * 2 + 1];
        for (int k = 0; k < cni; k++, tpos++) {
            if (tpos >= num_indices) return -1;
            int lv = index_tab[code * mi + k];
            if (lv < 0) return -1;
            out_tris[tpos] =
                fid[(size_t)slot_wid[(size_t)(vbase + lv)]];
        }
        vbase += count_tab[code * 2];
    }
    if (tpos != num_indices) return -1;

    out_counts[0] = n_wid;
    out_counts[1] = n_int;
    return n_wid;
}

// ------------------------------------------------------------- final write
// Native passes of OOCMesher._write_chunk (pipeline/mesher.py; the
// reference's final write loop, src/mesher.cpp:763-852).

// Pass A over one vertex-record slice: remap rec-local id -> final vertex
// id (0xFFFFFFFF = pruned). pruned_sorted: sorted clump-ROOT ids. Returns
// number kept. parent is mutated by path halving (benign).
int64_t mls_write_pass_a(const uint32_t* raw, int64_t n, int64_t* parent,
                         const int64_t* pruned_sorted, int64_t n_pruned,
                         int64_t nv_base, uint32_t* remap_out) {
    int64_t kept = 0;
    for (int64_t i = 0; i < n; i++) {
        bool keep = true;
        if (n_pruned > 0) {
            int64_t root = uf_find(parent, (int64_t)raw[i * 4 + 3]);
            int64_t lo = 0, hi = n_pruned;
            while (lo < hi) {
                int64_t mid = (lo + hi) / 2;
                if (pruned_sorted[mid] < root) lo = mid + 1;
                else hi = mid;
            }
            keep = !(lo < n_pruned && pruned_sorted[lo] == root);
        }
        remap_out[i] = keep ? (uint32_t)(nv_base + kept++) : 0xFFFFFFFFu;
    }
    return kept;
}

// Pass B vertices: compact kept records and apply the grid->world
// transform ((v + ext_lo) * spacing + reference, matching the numpy
// expression order). Returns number written.
int64_t mls_write_verts(const uint32_t* raw, int64_t n,
                        const uint32_t* remap, const float* ext_lo,
                        float spacing, const float* reference, float* out) {
    int64_t j = 0;
    for (int64_t i = 0; i < n; i++) {
        if (remap[i] == 0xFFFFFFFFu) continue;
        const float* v = reinterpret_cast<const float*>(raw + i * 4);
        for (int a = 0; a < 3; a++)
            out[j * 3 + a] = (v[a] + ext_lo[a]) * spacing + reference[a];
        j++;
    }
    return j;
}

// Pass B triangles: keep iff vertex a survives (all three share a clump);
// emit 13-byte PLY records (count byte 3 + three u32 LE). Returns kept.
int64_t mls_write_tris(const uint32_t* raw, int64_t m,
                       const uint32_t* remap, uint8_t* out) {
    int64_t j = 0;
    for (int64_t t = 0; t < m; t++) {
        uint32_t a = remap[raw[t * 3]];
        if (a == 0xFFFFFFFFu) continue;
        uint8_t* rec = out + j * 13;
        rec[0] = 3;
        uint32_t tri[3] = {a, remap[raw[t * 3 + 1]], remap[raw[t * 3 + 2]]};
        std::memcpy(rec + 1, tri, 12);
        j++;
    }
    return j;
}

// Count-only variant of pass B triangles (header sizing under pruning).
int64_t mls_count_tris_kept(const uint32_t* raw, int64_t m,
                            const uint32_t* remap) {
    int64_t j = 0;
    for (int64_t t = 0; t < m; t++)
        if (remap[raw[t * 3]] != 0xFFFFFFFFu) j++;
    return j;
}

}  // extern "C"
