// parsec_tpu_torch native core: hot runtime structures in C++.
//
// Stands where the reference's C substrate stands (parsec/class/hash_table.c,
// parsec/class/lifo.c, parsec/utils/zone_malloc.c, and the dependency update
// path parsec_update_deps_with_mask, parsec/parsec.c:1657): the Python layer
// binds these via ctypes; a failed build raises there (no fallback while
// --mca native_enabled is on).
//
// Exposed C ABI (see parsec_tpu_torch/native.py):
//   dependency table  — concurrent open-addressing map from small int64[]
//                       keys to a satisfied mask/counter; update returns
//                       whether the task just became ready (goal reached),
//                       erasing the entry exactly once.
//   zone allocator    — first-fit, unit-granular, coalescing free list.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <new>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// dependency table
// ---------------------------------------------------------------------------

static const int PT_KEY_MAX = 16;   // matches MAX_LOCAL_COUNT in the DSLs

struct pt_dep_entry {
    int64_t key[PT_KEY_MAX];
    int32_t klen;       // -1 = empty, -2 = tombstone
    int64_t value;
};

struct pt_dep_table {
    std::vector<pt_dep_entry> slots;
    std::mutex lock;      // one mutex: probe sequences must be atomic, and
                          // growth rehashes in place (striping would race)
    int64_t used{0};      // live entries
    int64_t filled{0};    // live + tombstones (what the load factor counts)
    uint64_t mask;

    explicit pt_dep_table(size_t cap) : slots(cap), mask(cap - 1) {
        for (auto &e : slots) e.klen = -1;
    }
};

static inline uint64_t pt_hash_key(const int64_t *key, int32_t klen) {
    // FNV-1a over the raw key words; bucket choice only (compares are exact)
    uint64_t h = 1469598103934665603ull;
    for (int32_t i = 0; i < klen; i++) {
        uint64_t w = (uint64_t)key[i];
        for (int b = 0; b < 8; b++) {
            h ^= (w >> (8 * b)) & 0xff;
            h *= 1099511628211ull;
        }
    }
    return h;
}

void *pt_dep_table_create(uint64_t capacity_pow2) {
    size_t cap = 1;
    while (cap < capacity_pow2) cap <<= 1;
    return new (std::nothrow) pt_dep_table(cap);
}

void pt_dep_table_destroy(void *t) {
    delete static_cast<pt_dep_table *>(t);
}

int64_t pt_dep_table_size(void *tv) {
    auto *t = static_cast<pt_dep_table *>(tv);
    std::lock_guard<std::mutex> g(t->lock);
    return t->used;
}

// locked helpers -------------------------------------------------------------

static void pt_dep_rehash(pt_dep_table *t, size_t newcap) {
    std::vector<pt_dep_entry> old;
    old.swap(t->slots);
    t->slots.assign(newcap, pt_dep_entry{});
    for (auto &e : t->slots) e.klen = -1;
    t->mask = newcap - 1;
    t->filled = 0;
    for (auto &e : old) {
        if (e.klen < 0) continue;
        uint64_t idx = pt_hash_key(e.key, e.klen) & t->mask;
        while (t->slots[idx].klen != -1) idx = (idx + 1) & t->mask;
        t->slots[idx] = e;
        t->filled++;
    }
}

// mode 0: OR contribution into a mask; mode 1: add (counter).
// Returns 1 when value reached `goal` (entry retired), else 0. The whole
// update is atomic: the "becomes ready exactly once" guarantee of
// parsec_update_deps_with_mask.
int32_t pt_dep_table_update(void *tv, const int64_t *key, int32_t klen,
                            int64_t contribution, int64_t goal, int32_t mode) {
    auto *t = static_cast<pt_dep_table *>(tv);
    if (klen > PT_KEY_MAX) return -1;
    uint64_t h = pt_hash_key(key, klen);
    std::lock_guard<std::mutex> g(t->lock);
    if ((uint64_t)t->filled * 4 >= (t->mask + 1) * 3)   // load > 0.75: grow
        pt_dep_rehash(t, (t->mask + 1) * 2);
    uint64_t idx = h & t->mask;
    uint64_t first_tomb = (uint64_t)-1;
    for (uint64_t probe = 0; probe <= t->mask; probe++, idx = (idx + 1) & t->mask) {
        pt_dep_entry &e = t->slots[idx];
        if (e.klen == -1) {  // empty: insert here (or at first tombstone)
            uint64_t at = (first_tomb != (uint64_t)-1) ? first_tomb : idx;
            pt_dep_entry &ne = t->slots[at];
            if (contribution == goal) return 1;   // single-dep: never stored
            ne.klen = klen;
            std::memcpy(ne.key, key, sizeof(int64_t) * klen);
            ne.value = contribution;
            t->used++;
            if (at == idx) t->filled++;           // tombstone reuse keeps filled
            return 0;
        }
        if (e.klen == -2) {
            if (first_tomb == (uint64_t)-1) first_tomb = idx;
            continue;
        }
        if (e.klen == klen && 0 == std::memcmp(e.key, key, sizeof(int64_t) * klen)) {
            e.value = (mode == 0) ? (e.value | contribution)
                                  : (e.value + contribution);
            if (e.value == goal) {
                e.klen = -2;          // retire: task launches exactly once
                t->used--;
                return 1;
            }
            return 0;
        }
    }
    return -2;  // table full (cannot happen after growth)
}

int64_t pt_dep_table_get(void *tv, const int64_t *key, int32_t klen) {
    auto *t = static_cast<pt_dep_table *>(tv);
    uint64_t h = pt_hash_key(key, klen);
    std::lock_guard<std::mutex> g(t->lock);
    uint64_t idx = h & t->mask;
    for (uint64_t probe = 0; probe <= t->mask; probe++, idx = (idx + 1) & t->mask) {
        pt_dep_entry &e = t->slots[idx];
        if (e.klen == -1) return 0;
        if (e.klen == klen && 0 == std::memcmp(e.key, key, sizeof(int64_t) * klen))
            return e.value;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// zone allocator (ref: parsec/utils/zone_malloc.c)
// ---------------------------------------------------------------------------

struct pt_zone {
    std::map<int64_t, int64_t> free_ranges;  // start_unit -> nb_units
    std::mutex lock;
    int64_t unit;
    int64_t total_units;
    int64_t in_use{0};
    int64_t hwm{0};
};

void *pt_zone_create(int64_t total_bytes, int64_t unit) {
    auto *z = new (std::nothrow) pt_zone();
    if (!z) return nullptr;
    z->unit = unit > 0 ? unit : (1 << 20);
    z->total_units = total_bytes / z->unit;
    if (z->total_units < 1) z->total_units = 1;
    z->free_ranges[0] = z->total_units;
    return z;
}

void pt_zone_destroy(void *zv) { delete static_cast<pt_zone *>(zv); }

// returns byte offset, or -1 when no hole fits
int64_t pt_zone_alloc(void *zv, int64_t nbytes) {
    auto *z = static_cast<pt_zone *>(zv);
    int64_t need = (nbytes + z->unit - 1) / z->unit;
    if (need < 1) need = 1;
    std::lock_guard<std::mutex> g(z->lock);
    for (auto it = z->free_ranges.begin(); it != z->free_ranges.end(); ++it) {
        if (it->second >= need) {
            int64_t start = it->first;
            int64_t rest = it->second - need;
            z->free_ranges.erase(it);
            if (rest > 0) z->free_ranges[start + need] = rest;
            z->in_use += need;
            if (z->in_use > z->hwm) z->hwm = z->in_use;
            return start * z->unit;
        }
    }
    return -1;
}

void pt_zone_free(void *zv, int64_t offset, int64_t nbytes) {
    auto *z = static_cast<pt_zone *>(zv);
    int64_t start = offset / z->unit;
    int64_t size = (nbytes + z->unit - 1) / z->unit;
    if (size < 1) size = 1;
    std::lock_guard<std::mutex> g(z->lock);
    z->in_use -= size;
    auto it = z->free_ranges.emplace(start, size).first;
    // coalesce with next
    auto nxt = std::next(it);
    if (nxt != z->free_ranges.end() && it->first + it->second == nxt->first) {
        it->second += nxt->second;
        z->free_ranges.erase(nxt);
    }
    // coalesce with prev
    if (it != z->free_ranges.begin()) {
        auto prv = std::prev(it);
        if (prv->first + prv->second == it->first) {
            prv->second += it->second;
            z->free_ranges.erase(it);
        }
    }
}

void pt_zone_stats(void *zv, int64_t *out4) {
    auto *z = static_cast<pt_zone *>(zv);
    std::lock_guard<std::mutex> g(z->lock);
    int64_t free_units = 0, largest = 0;
    for (auto &kv : z->free_ranges) {
        free_units += kv.second;
        if (kv.second > largest) largest = kv.second;
    }
    out4[0] = free_units * z->unit;
    out4[1] = z->in_use * z->unit;
    out4[2] = z->hwm * z->unit;
    out4[3] = largest * z->unit;
}

}  // extern "C"
