// Native backoff n-gram store for NASD drafting (the port's copy of
// specdec_tpu/ngram/_native/ngram_store.cpp, unchanged below this header).
//
// The same data structure as the Python NGramStorage
// (specdec_tpu_torch/ngram/storage.py) in C++: per-order hash maps, gram ->
// token counts + argmax cache, exposed through a C ABI consumed via ctypes
// (specdec_tpu_torch/ngram/native.py). Semantics are identical to the Python
// implementation, unknown-context draws aside (std::mt19937 here,
// random.Random there); the tests cross-check them on random streams.
//
// Build (native.py does it at first use, into build/ngram/):
//   g++ -O3 -shared -fPIC -std=c++17 ngram_store.cpp -o libngram_store.so

#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct VecHash {
    size_t operator()(const std::vector<int32_t>& v) const {
        size_t h = 1469598103934665603ull;  // FNV-1a
        for (int32_t t : v) {
            h ^= static_cast<uint32_t>(t);
            h *= 1099511628211ull;
        }
        return h;
    }
};

struct Entry {
    std::unordered_map<int32_t, int64_t> counts;
    int32_t best = -1;
    int64_t best_count = 0;
};

using OrderMap = std::unordered_map<std::vector<int32_t>, Entry, VecHash>;

struct Store {
    int32_t n = 3;
    int32_t vocab_size = 0;
    // orders 2..n-1 (index by order length j = gram size)
    std::unordered_map<int32_t, OrderMap> orders;
    std::mt19937 rng;

    // argmax-count tracked incrementally; strict > keeps the incumbent on
    // ties (ref ngram_storage.py:214-221 semantics)
    void bump(int32_t j, std::vector<int32_t>&& gram, int32_t token) {
        Entry& e = orders[j][std::move(gram)];
        int64_t c = ++e.counts[token];
        if (e.best < 0 || token == e.best) {
            if (e.best < 0) e.best = token;
            e.best_count = c;
        } else if (c > e.best_count) {
            e.best = token;
            e.best_count = c;
        }
    }
};

std::vector<int32_t> tail(const int32_t* ctx, int64_t len, int32_t j) {
    return std::vector<int32_t>(ctx + len - j, ctx + len);
}

}  // namespace

extern "C" {

void* ngram_create(int32_t n, int32_t vocab_size, uint64_t seed) {
    Store* s = new Store();
    s->n = n;
    s->vocab_size = vocab_size;
    s->rng.seed(seed);
    return s;
}

void ngram_destroy(void* h) { delete static_cast<Store*>(h); }

void ngram_reset(void* h) { static_cast<Store*>(h)->orders.clear(); }

// Most-likely next token with multi-order backoff (orders n-1 .. 2).
// Returns token; *known set to 1 on a hit, 0 → uniformly random token.
int32_t ngram_next_token(void* h, const int32_t* ctx, int64_t len,
                         int32_t* known) {
    Store* s = static_cast<Store*>(h);
    int32_t jmax = s->n - 1 < static_cast<int32_t>(len)
                       ? s->n - 1 : static_cast<int32_t>(len);
    for (int32_t j = jmax; j > 1; --j) {
        auto it_order = s->orders.find(j);
        if (it_order == s->orders.end()) continue;
        auto it = it_order->second.find(tail(ctx, len, j));
        if (it != it_order->second.end() && it->second.best >= 0) {
            *known = 1;
            return it->second.best;
        }
    }
    *known = 0;
    std::uniform_int_distribution<int32_t> d(0, s->vocab_size - 1);
    return d(s->rng);
}

int32_t ngram_has_gram(void* h, const int32_t* ids, int64_t len) {
    Store* s = static_cast<Store*>(h);
    if (len < 1) return 0;
    int32_t jmax = s->n - 1 < static_cast<int32_t>(len - 1)
                       ? s->n - 1 : static_cast<int32_t>(len - 1);
    for (int32_t j = jmax; j > 1; --j) {
        auto it_order = s->orders.find(j);
        if (it_order == s->orders.end()) continue;
        std::vector<int32_t> gram(ids + len - 1 - j, ids + len - 1);
        auto it = it_order->second.find(gram);
        if (it != it_order->second.end() &&
            it->second.counts.count(ids[len - 1])) {
            return 1;
        }
    }
    return 0;
}

// Update every order's tail gram of `ctx` with each of `tokens`.
void ngram_update(void* h, const int32_t* ctx, int64_t len,
                  const int32_t* tokens, int64_t ntok) {
    Store* s = static_cast<Store*>(h);
    if (len < 1) return;
    int32_t jmax = s->n - 1 < static_cast<int32_t>(len)
                       ? s->n - 1 : static_cast<int32_t>(len);
    for (int32_t j = jmax; j > 1; --j) {
        for (int64_t t = 0; t < ntok; ++t) {
            s->bump(j, tail(ctx, len, j), tokens[t]);
        }
    }
}

// Seed from a token sequence: for each position i, update all orders
// (ref initialize, ngram_storage.py:223-245).
void ngram_initialize(void* h, const int32_t* ids, int64_t len) {
    Store* s = static_cast<Store*>(h);
    for (int64_t i = 0; i < len; ++i) {
        int32_t jmax = s->n - 1 < static_cast<int32_t>(i)
                           ? s->n - 1 : static_cast<int32_t>(i);
        for (int32_t j = jmax; j > 1; --j) {
            s->bump(j, std::vector<int32_t>(ids + i - j, ids + i), ids[i]);
        }
    }
}

int64_t ngram_size(void* h) {
    Store* s = static_cast<Store*>(h);
    int64_t total = 0;
    for (auto& kv : s->orders) total += kv.second.size();
    return total;
}

}  // extern "C"
