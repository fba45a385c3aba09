// Incremental binary-descriptor place-recognition index (the port's own
// copy of the JAX package's native/bow/bow_index.cpp; same algorithm, same
// constants, so both indexes return the same ids and scores).
//
// The role OBIndex2 + iBoW-LCD play in the reference
// (Thirdparty/obindex2/lib/src/*.cc, Thirdparty/ibow_lcd/src/lcdetector.cc):
// an online, incrementally built index over BRIEF-256 descriptors that maps a
// query image's descriptors to previously seen keyframes with vote scores.
//
// Design: multi-table LSH over fixed pseudo-random 16-bit substrings of the
// 256-bit descriptor + exact Hamming re-ranking of bucket candidates. This is
// pointer-chasing, allocation-heavy host work, so it stays in C++ on the
// host. Built by slam/bow.py with g++ -O3 (no -march=native, so the library
// runs on any x86-64 host).
//
// C ABI for ctypes. Thread-compatible (external synchronization).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <algorithm>
#include <random>

namespace {

constexpr int kWords = 8;          // 8 x uint32 = 256 bits
constexpr int kTables = 6;         // LSH tables
constexpr int kBitsPerKey = 16;    // bucket key width
constexpr int kMaxHamming = 64;    // accept threshold for a descriptor match

struct DescRef {
  int32_t image_id;
  uint32_t desc_off;  // offset into the descriptor store (in descriptors)
};

struct Index {
  // fixed random bit selections per table
  int bit_sel[kTables][kBitsPerKey];
  // descriptor store (append-only)
  std::vector<uint32_t> store;                 // n_desc * kWords
  std::vector<int32_t> store_img;              // n_desc
  // per-table hash buckets
  std::unordered_map<uint32_t, std::vector<DescRef>> tables[kTables];
  // per-image descriptor counts
  std::unordered_map<int32_t, int32_t> image_sizes;

  Index() {
    std::mt19937 rng(12345);
    for (int t = 0; t < kTables; ++t) {
      // distinct random bits per table
      std::vector<int> bits(256);
      for (int i = 0; i < 256; ++i) bits[i] = i;
      std::shuffle(bits.begin(), bits.end(), rng);
      for (int b = 0; b < kBitsPerKey; ++b) bit_sel[t][b] = bits[b];
    }
  }

  uint32_t key_of(const uint32_t* d, int t) const {
    uint32_t k = 0;
    for (int b = 0; b < kBitsPerKey; ++b) {
      int bit = bit_sel[t][b];
      uint32_t w = d[bit >> 5];
      k |= ((w >> (bit & 31)) & 1u) << b;
    }
    return k;
  }
};

inline int hamming(const uint32_t* a, const uint32_t* b) {
  int h = 0;
  for (int w = 0; w < kWords; ++w) h += __builtin_popcount(a[w] ^ b[w]);
  return h;
}

}  // namespace

extern "C" {

void* bow_create() { return new Index(); }

void bow_destroy(void* h) { delete static_cast<Index*>(h); }

int bow_num_images(void* h) {
  return static_cast<int>(static_cast<Index*>(h)->image_sizes.size());
}

void bow_add_image(void* h, int image_id, const uint32_t* descs, int n) {
  Index* idx = static_cast<Index*>(h);
  for (int i = 0; i < n; ++i) {
    const uint32_t* d = descs + i * kWords;
    uint32_t off = static_cast<uint32_t>(idx->store.size() / kWords);
    idx->store.insert(idx->store.end(), d, d + kWords);
    idx->store_img.push_back(image_id);
    for (int t = 0; t < kTables; ++t) {
      idx->tables[t][idx->key_of(d, t)].push_back({image_id, off});
    }
  }
  idx->image_sizes[image_id] += n;
}

// Query: vote for images by matched descriptors. A query descriptor matches
// the best bucket candidate per image if its exact Hamming distance is under
// kMaxHamming; each match adds (1 - dist/256) to that image's score.
// Images with id > max_image_id are ignored (temporal guard: don't match
// against recent frames). Returns the number of results written.
int bow_query(void* h, const uint32_t* descs, int n, int max_image_id,
              int topk, int* out_ids, float* out_scores) {
  Index* idx = static_cast<Index*>(h);
  std::unordered_map<int32_t, float> votes;
  std::unordered_map<int32_t, int> best_dist;  // per-image best for this desc

  std::vector<uint32_t> cand;  // candidate desc offsets for one query desc
  for (int i = 0; i < n; ++i) {
    const uint32_t* d = descs + i * kWords;
    cand.clear();
    for (int t = 0; t < kTables; ++t) {
      auto it = idx->tables[t].find(idx->key_of(d, t));
      if (it == idx->tables[t].end()) continue;
      for (const DescRef& r : it->second) {
        if (r.image_id > max_image_id) continue;
        cand.push_back(r.desc_off);
      }
    }
    if (cand.empty()) continue;
    std::sort(cand.begin(), cand.end());
    cand.erase(std::unique(cand.begin(), cand.end()), cand.end());

    best_dist.clear();
    for (uint32_t off : cand) {
      const uint32_t* s = idx->store.data() + size_t(off) * kWords;
      int dist = hamming(d, s);
      if (dist > kMaxHamming) continue;
      int32_t img = idx->store_img[off];
      auto it = best_dist.find(img);
      if (it == best_dist.end() || dist < it->second) best_dist[img] = dist;
    }
    for (const auto& kv : best_dist) {
      votes[kv.first] += 1.0f - float(kv.second) / 256.0f;
    }
  }

  std::vector<std::pair<float, int32_t>> ranked;
  ranked.reserve(votes.size());
  for (const auto& kv : votes) ranked.push_back({kv.second, kv.first});
  std::sort(ranked.begin(), ranked.end(),
            [](const auto& a, const auto& b) { return a.first > b.first; });
  int k = std::min<int>(topk, static_cast<int>(ranked.size()));
  for (int i = 0; i < k; ++i) {
    out_ids[i] = ranked[i].second;
    out_scores[i] = ranked[i].first;
  }
  return k;
}

}  // extern "C"
