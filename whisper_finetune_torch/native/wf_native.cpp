// Native core for the host-side hot loops.
//
// The reference's only native in-repo-equivalent dependency is a forked Rust
// tiktoken whose encode() takes a dropout probability (BPE-dropout; used at
// reference src/whisper_finetune/data/data_loader.py:230,249) plus the C++
// RapidFuzz backend jiwer uses for WER/CER (eval/metrics.py:12). This file
// provides both for the training stack:
//
//   * the byte-level BPE merge loop with per-occurrence merge dropout,
//     operating on token ids against a prebuilt (left,right)->(rank,merged)
//     table — the O(n^2)-ish inner loop that dominates tokenization cost and
//     runs inside data-loader workers (releases the GIL via ctypes),
//   * Levenshtein distance on int sequences for WER/CER.
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in the
// image). Build: g++ -O3 -shared -fPIC (see whisper_finetune_torch/native/__init__.py).

#include <cstdint>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

struct MergeTable {
    // key: (left << 32) | right  ->  (rank, merged_id)
    std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> table;
};

inline uint64_t pair_key(int32_t l, int32_t r) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(l)) << 32) |
           static_cast<uint32_t>(r);
}

// xorshift64* — fast deterministic per-call PRNG for dropout decisions.
struct Rng {
    uint64_t state;
    explicit Rng(uint64_t seed) : state(seed ? seed : 0x9E3779B97F4A7C15ULL) {}
    inline uint64_t next() {
        uint64_t x = state;
        x ^= x >> 12;
        x ^= x << 25;
        x ^= x >> 27;
        state = x;
        return x * 0x2545F4914F6CDD1DULL;
    }
    inline float uniform() {
        return static_cast<float>(next() >> 40) * (1.0f / 16777216.0f);
    }
};

}  // namespace

extern "C" {

void* wf_bpe_create(const int32_t* left, const int32_t* right,
                    const int32_t* merged, int32_t n_merges) {
    auto* mt = new MergeTable();
    mt->table.reserve(static_cast<size_t>(n_merges) * 2);
    for (int32_t i = 0; i < n_merges; ++i) {
        mt->table.emplace(pair_key(left[i], right[i]),
                          std::make_pair(i, merged[i]));
    }
    return mt;
}

void wf_bpe_destroy(void* handle) { delete static_cast<MergeTable*>(handle); }

// Encode one pre-tokenized piece. `syms` holds the initial symbol ids (one
// per byte-level character); result ids are written to `out` (capacity >= n).
// Returns the number of output tokens. Dropout: every candidate pair
// occurrence is independently skipped with probability `dropout` at each
// scan, reproducing the BPE-dropout training distribution.
int32_t wf_bpe_encode_piece(void* handle, const int32_t* syms, int32_t n,
                            float dropout, uint64_t seed, int32_t* out) {
    auto* mt = static_cast<MergeTable*>(handle);
    std::vector<int32_t> word(syms, syms + n);
    const bool use_dropout = dropout > 0.0f;
    Rng rng(seed);

    while (word.size() >= 2) {
        int32_t best_rank = INT32_MAX;
        int32_t best_idx = -1;
        int32_t best_merged = -1;
        for (size_t i = 0; i + 1 < word.size(); ++i) {
            auto it = mt->table.find(pair_key(word[i], word[i + 1]));
            if (it == mt->table.end()) continue;
            if (use_dropout && rng.uniform() < dropout) continue;
            if (it->second.first < best_rank) {
                best_rank = it->second.first;
                best_idx = static_cast<int32_t>(i);
                best_merged = it->second.second;
            }
        }
        if (best_idx < 0) break;
        word[best_idx] = best_merged;
        word.erase(word.begin() + best_idx + 1);
    }

    std::copy(word.begin(), word.end(), out);
    return static_cast<int32_t>(word.size());
}

int32_t wf_levenshtein(const int32_t* a, int32_t n, const int32_t* b, int32_t m) {
    if (n == 0) return m;
    if (m == 0) return n;
    std::vector<int32_t> prev(m + 1), cur(m + 1);
    for (int32_t j = 0; j <= m; ++j) prev[j] = j;
    for (int32_t i = 1; i <= n; ++i) {
        cur[0] = i;
        const int32_t av = a[i - 1];
        for (int32_t j = 1; j <= m; ++j) {
            const int32_t sub = prev[j - 1] + (b[j - 1] != av);
            const int32_t del = prev[j] + 1;
            const int32_t ins = cur[j - 1] + 1;
            cur[j] = std::min(sub, std::min(del, ins));
        }
        std::swap(prev, cur);
    }
    return prev[m];
}

}  // extern "C"
