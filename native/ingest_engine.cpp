// Native k-mer ingest: streaming canonical chop + open-addressing
// aggregation for the CPU backend.
//
// The device path chops/aggregates with fused vector ops + sort + segment
// reduce (contig/graph.py); this engine is its host-side twin for
// environments where the compute devices are CPU (scale validation,
// file-fed runs behind a slow device link).  Same aggregate semantics:
// canonical k-mer = min(fwd, rc) (DBGgraph.cpp:80-89 rule), strand-adjusted
// left/right neighbor-base counters, first-occurrence stream index.
//
// The table is a power-of-two open-addressing hash with nodes stored
// INLINE in the slot array (count == 0 marks an empty slot), so a probe
// and the counter update touch one cache line — the earlier
// slot-index -> node-vector indirection paid two random accesses per
// probe and dominated ingest wall time.  (Own design; the reference uses
// a prime-size CAS table — we only need the aggregate, not its layout,
// which RefAssembler emulates separately from first_idx.)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

#include <sys/mman.h>

namespace ingest {

// Anonymous-mmap allocation with transparent-huge-page advice: the table
// is probed at random, so with 4 KiB pages every probe is also a TLB
// miss + page walk; 2 MiB pages cut TLB pressure ~512x and make the
// first-touch fault cost per byte negligible.
static void* table_alloc(size_t bytes) {
    void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) { perror("ingest table mmap"); abort(); }
#ifdef MADV_HUGEPAGE
    madvise(p, bytes, MADV_HUGEPAGE);
#endif
    return p;
}

static void table_free(void* p, size_t bytes) {
    if (p) munmap(p, bytes);
}

struct Node {
    uint64_t kmer;
    int64_t first_idx;
    int32_t count;       // occurrence count; 0 = slot empty
    uint32_t l;          // 4x8-bit saturating edge counters (byte b =
    uint32_t r;          // base b) — the reference's own counter format
                         // (BitAddVal, DBGgraph.cpp:93-96); 32-byte node
                         // = one probe+update per cache line
};

struct Table {
    Node* slots = nullptr;     // open addressing, nodes inline (mmap/THP)
    uint64_t mask;             // slot count - 1
    uint64_t n_nodes;
    int k;
    uint64_t kmask;
    int64_t n_valid_total;

    ~Table() { table_free(slots, (mask + 1) * sizeof(Node)); }

    static uint64_t hash(uint64_t kk) {
        // 64-bit mix (splitmix64 finalizer)
        kk += 0x9E3779B97F4A7C15ULL;
        kk = (kk ^ (kk >> 30)) * 0xBF58476D1CE4E5B9ULL;
        kk = (kk ^ (kk >> 27)) * 0x94D049BB133111EBULL;
        return kk ^ (kk >> 31);
    }

    void init(int k_, uint64_t cap) {
        k = k_;
        kmask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
        uint64_t s = 1024;
        while (s < cap * 2) s <<= 1;
        slots = (Node*)table_alloc(s * sizeof(Node));
        mask = s - 1;
        n_nodes = 0;
        n_valid_total = 0;
    }

    void grow() {
        uint64_t ns = (mask + 1) << 1;
        Node* fresh = (Node*)table_alloc(ns * sizeof(Node));
        uint64_t nm = ns - 1;
        // software-prefetch ring over the random re-insert targets (same
        // rationale as add(): the rehash is a stream of independent DRAM
        // misses, ~2x the final table size in total work)
        const int PD = 32;
        uint64_t ring[PD];
        int head = 0, cnt = 0;
        for (uint64_t i = 0; i <= mask; i++) {
            if (slots[i].count == 0) continue;
            __builtin_prefetch(&fresh[hash(slots[i].kmer) & nm], 1, 1);
            if (cnt == PD) {
                uint64_t src = ring[head];
                head = (head + 1) & (PD - 1);
                cnt--;
                uint64_t hc = hash(slots[src].kmer) & nm;
                while (fresh[hc].count) hc = (hc + 1) & nm;
                fresh[hc] = slots[src];
            }
            ring[(head + cnt) & (PD - 1)] = i;
            cnt++;
        }
        for (; cnt > 0; cnt--) {
            uint64_t src = ring[head];
            head = (head + 1) & (PD - 1);
            uint64_t hc = hash(slots[src].kmer) & nm;
            while (fresh[hc].count) hc = (hc + 1) & nm;
            fresh[hc] = slots[src];
        }
        table_free(slots, (mask + 1) * sizeof(Node));
        slots = fresh;
        mask = nm;
    }

    inline Node* upsert(uint64_t key, int64_t sidx) {
        if ((n_nodes + 1) * 10 > (mask + 1) * 7) grow();
        uint64_t hc = hash(key) & mask;
        while (true) {
            Node* nd = &slots[hc];
            if (nd->count == 0) {
                nd->kmer = key;
                nd->first_idx = sidx;
                n_nodes++;
                return nd;
            }
            if (nd->kmer == key) return nd;
            hc = (hc + 1) & mask;
        }
    }

    // scratch for the per-read chop pass (sized to the batch's P once)
    std::vector<uint64_t> scr_can;
    std::vector<uint8_t> scr_lr;

    // chop one batch of padded reads and aggregate.  Two passes per read:
    // (1) chop the row's canonical k-mers + strand-adjusted neighbor
    // bases into scratch (pure ALU), (2) walk the scratch with a
    // software-prefetch pipeline — the table probe is one random DRAM
    // line per k-mer (~70-100 ns uncovered, and it dominated the contig
    // stage), so issuing the line fetch PF_DIST k-mers ahead overlaps
    // ~16 misses instead of serializing them.
    void add(const uint8_t* codes, int64_t N, int L,
             const int32_t* lengths, int64_t base_index) {
        int kk = k;
        int P = L - kk + 1;
        uint64_t head_shift = 2ULL * (kk - 1);
        if ((int64_t)scr_can.size() < P) {
            scr_can.resize(P);
            scr_lr.resize(2 * (size_t)P);
        }
        uint64_t* cans = scr_can.data();
        uint8_t* lr = scr_lr.data();
        const int PF_DIST = 32;
        for (int64_t r = 0; r < N; r++) {
            const uint8_t* row = codes + r * L;
            int len = lengths[r];
            if (len > L) len = L;
            int np = len - kk + 1;
            if (np <= 0) continue;
            uint64_t fwd = 0, rc = 0;
            for (int i = 0; i < kk; i++) {
                fwd = (fwd << 2) | row[i];
                rc = rc | ((uint64_t)(3 - row[i]) << (2 * i));
            }
            int64_t sbase = base_index + r * P;
            for (int j = 0; j < np + PF_DIST; j++) {
                if (j < np) {                      // chop lane (j)
                    if (j > 0) {
                        uint64_t b = row[j + kk - 1];
                        fwd = ((fwd << 2) | b) & kmask;
                        rc = (rc >> 2) | ((3ULL - b) << head_shift);
                    }
                    bool use_fwd = fwd <= rc;
                    cans[j] = use_fwd ? fwd : rc;
                    int left, right;
                    int has_left = j > 0;
                    int has_right = j < len - kk;
                    if (use_fwd) {
                        left = has_left ? row[j - 1] : 4;
                        right = has_right ? row[j + kk] : 4;
                    } else {
                        left = has_right ? 3 - row[j + kk] : 4;
                        right = has_left ? 3 - row[j - 1] : 4;
                    }
                    lr[2 * j] = (uint8_t)left;
                    lr[2 * j + 1] = (uint8_t)right;
                    uint64_t phc = hash(cans[j]) & mask;
                    __builtin_prefetch(&slots[phc], 1, 1);
                    __builtin_prefetch(&slots[(phc + 2) & mask], 1, 1);
                }
                if (j >= PF_DIST) {                // upsert lane (j - PF)
                    int u = j - PF_DIST;
                    Node* nd = upsert(cans[u], sbase + u);
                    nd->count++;
                    int left = lr[2 * u], right = lr[2 * u + 1];
                    if (left < 4 && ((nd->l >> (8 * left)) & 0xFFu) < 255u)
                        nd->l += 1u << (8 * left);
                    if (right < 4 && ((nd->r >> (8 * right)) & 0xFFu) < 255u)
                        nd->r += 1u << (8 * right);
                }
            }
            n_valid_total += np;
        }
    }

    // occupied slot indices sorted by k-mer value.  Keys are copied
    // INLINE next to the indices before sorting — a comparator that
    // dereferences slots[] pays one random DRAM line per comparison
    // (~23 x n of them), which made extraction ~3x slower than the sort
    // itself.
    std::vector<uint64_t> sorted_occupied() const {
        std::vector<std::pair<uint64_t, uint64_t>> keyed;
        keyed.reserve(n_nodes);
        for (uint64_t i = 0; i <= mask; i++)
            if (slots[i].count) keyed.emplace_back(slots[i].kmer, i);
        std::sort(keyed.begin(), keyed.end());
        std::vector<uint64_t> order(keyed.size());
        for (size_t i = 0; i < keyed.size(); i++) order[i] = keyed[i].second;
        return order;
    }
};

}  // namespace ingest

extern "C" {

void* ingest_create(int k, uint64_t capacity_hint) {
    ingest::Table* t = new ingest::Table();
    t->init(k, capacity_hint ? capacity_hint : 1 << 20);
    return t;
}

void ingest_add(void* h, const uint8_t* codes, int64_t N, int L,
                const int32_t* lengths, int64_t base_index) {
    ((ingest::Table*)h)->add(codes, N, L, lengths, base_index);
}

int64_t ingest_size(void* h) {
    return (int64_t)((ingest::Table*)h)->n_nodes;
}

// pre-size the table for an expected node count (one rehash now instead
// of log2 doublings mid-stream); no-op if already large enough
void ingest_reserve(void* h, uint64_t nodes) {
    ingest::Table* t = (ingest::Table*)h;
    while (nodes * 10 > (t->mask + 1) * 7) t->grow();
}

int64_t ingest_total(void* h) {
    return ((ingest::Table*)h)->n_valid_total;
}

// extract sorted-by-kmer arrays; buffers sized by ingest_size()
void ingest_extract(void* h, uint64_t* kmers, int32_t* lcnt, int32_t* rcnt,
                    int64_t* first_idx) {
    ingest::Table* t = (ingest::Table*)h;
    std::vector<uint64_t> order = t->sorted_occupied();
    for (uint64_t i = 0; i < order.size(); i++) {
        if (i + 16 < order.size())
            __builtin_prefetch(&t->slots[order[i + 16]], 0, 1);
        const ingest::Node& nd = t->slots[order[i]];
        kmers[i] = nd.kmer;
        first_idx[i] = nd.first_idx;
        for (int j = 0; j < 4; j++) {
            lcnt[4 * i + j] = (int32_t)((nd.l >> (8 * j)) & 0xFFu);
            rcnt[4 * i + j] = (int32_t)((nd.r >> (8 * j)) & 0xFFu);
        }
    }
}

// everything in one pass (single sort); buffers sized by ingest_size()
void ingest_extract_full(void* h, uint64_t* kmers, int32_t* lcnt,
                         int32_t* rcnt, int64_t* first_idx,
                         int32_t* counts) {
    ingest::Table* t = (ingest::Table*)h;
    std::vector<uint64_t> order = t->sorted_occupied();
    for (uint64_t i = 0; i < order.size(); i++) {
        if (i + 16 < order.size())
            __builtin_prefetch(&t->slots[order[i + 16]], 0, 1);
        const ingest::Node& nd = t->slots[order[i]];
        kmers[i] = nd.kmer;
        first_idx[i] = nd.first_idx;
        counts[i] = nd.count;
        for (int j = 0; j < 4; j++) {
            lcnt[4 * i + j] = (int32_t)((nd.l >> (8 * j)) & 0xFFu);
            rcnt[4 * i + j] = (int32_t)((nd.r >> (8 * j)) & 0xFFu);
        }
    }
}

// counts-only extraction (kmerfreq path); buffers sized by ingest_size()
void ingest_extract_counts(void* h, uint64_t* kmers, int32_t* counts) {
    ingest::Table* t = (ingest::Table*)h;
    std::vector<uint64_t> order = t->sorted_occupied();
    for (uint64_t i = 0; i < order.size(); i++) {
        if (i + 16 < order.size())
            __builtin_prefetch(&t->slots[order[i + 16]], 0, 1);
        const ingest::Node& nd = t->slots[order[i]];
        kmers[i] = nd.kmer;
        counts[i] = nd.count;
    }
}

void ingest_free(void* h) {
    delete (ingest::Table*)h;
}

}  // extern "C"
