// Native runtime helpers for dbg_assembly (loaded via ctypes).
//
// These cover the host-side sequential tails where the device bulk path needs
// the reference's EMERGENT ordering reproduced exactly:
//
//  * jenkins64 / find_next_prime — hash sizing/placement rules of the
//    reference's open-addressing KmerSet (DBG_contig/kmerSet.h:105-116,
//    kmerSet.cpp:72-95), including the reference's idiosyncratic primality
//    loop bound (strict '<' against a float sqrt), which must be copied
//    behaviorally or table sizes diverge.
//  * hash_layout — linear-probe slot assignment for species inserted in
//    first-occurrence order (what a single-threaded run of the reference's
//    CAS insert produces, DBGgraph.cpp:167-205).
//  * stdsort_perm_desc — the permutation produced by libstdc++ std::sort
//    with the reference's by-length-descending comparator
//    (contig.cpp:48-50,1014; link_func.cpp:69-71).  std::sort is unstable;
//    comparison-based introsort yields a deterministic, type-independent
//    permutation, so sorting (len, idx) pairs here reproduces the exact
//    tie order of the reference's struct sorts.
//
// Build: make -C native   (g++ -O2 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <ctime>

#include <sys/mman.h>

// mmap + MADV_HUGEPAGE allocation for the big random-access tables: this
// host runs THP in madvise mode with 4K base pages, so a 0.5GB hash
// table probed at random takes a TLB miss (which also DROPS the software
// prefetch) on nearly every access; 2MB pages make it TLB-resident.
static void* huge_alloc(size_t bytes) {
    void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return nullptr;
    madvise(p, bytes, MADV_HUGEPAGE);
    return p;
}

static void huge_free(void* p, size_t bytes) {
    if (p) munmap(p, bytes);
}

extern "C" {

// Mark a caller-owned buffer for huge pages (effective when called
// BEFORE first touch — fresh np.empty allocations fault hugepages in).
void madv_huge(void* p, int64_t bytes) {
    uintptr_t a = (uintptr_t)p;
    uintptr_t lo = (a + 4095) & ~(uintptr_t)4095;
    int64_t n = bytes - (int64_t)(lo - a);
    if (n > 4096) madvise((void*)lo, (size_t)(n & ~(int64_t)4095),
                          MADV_HUGEPAGE);
}

uint64_t jenkins64(uint64_t kmer) {
    kmer += ~(kmer << 32);
    kmer ^= (kmer >> 22);
    kmer += ~(kmer << 13);
    kmer ^= (kmer >> 8);
    kmer += (kmer << 3);
    kmer ^= (kmer >> 15);
    kmer += ~(kmer << 27);
    kmer ^= (kmer >> 31);
    return kmer;
}

static int is_prime_ref(uint64_t num) {
    // behavioral parity with kmerSet.cpp:72-82 (strict '<' bound, float sqrt)
    uint64_t i, max;
    if (num < 4) return 1;
    if (num % 2 == 0) return 0;
    max = (uint64_t)sqrt((float)num);
    for (i = 3; i < max; i += 2) {
        if (num % i == 0) return 0;
    }
    return 1;
}

uint64_t find_next_prime(uint64_t num) {
    if (num % 2 == 0) num++;
    while (1) {
        if (is_prime_ref(num)) return num;
        num += 2;
    }
}

// Assign hash slots by linear probing for keys given in insertion order.
// slots_out[i] = slot of kmers[i].  Occupancy via a byte map.
// Returns the number of probe conflicts (parity: kset->count_conflict).
int64_t hash_layout(const uint64_t* kmers, int64_t n, uint64_t size,
                    uint8_t* occupied /* size bytes, zeroed by caller */,
                    int64_t* slots_out) {
    int64_t conflicts = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t hc = jenkins64(kmers[i]) % size;
        while (occupied[hc]) {
            conflicts++;
            hc = (hc + 1 == size) ? 0 : hc + 1;
        }
        occupied[hc] = 1;
        slots_out[i] = (int64_t)hc;
    }
    return conflicts;
}

static inline uint64_t revcomp_k(uint64_t x, int k) {
    x = ~x;
    x = ((x & 0x3333333333333333ULL) << 2) |
        ((x >> 2) & 0x3333333333333333ULL);
    x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) |
        ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
    x = __builtin_bswap64(x);
    return x >> (64 - 2 * k);
}

// Directed successor function over the 2M interleaved states of
// read_out_contigs (state 2i = node i walking canonical-rightward,
// 2i+1 leftward): next-kmer math + canonical flip + table lookup via a
// jenkins open-addressing hash (the XLA searchsorted twin costs ~10s at
// 13M nodes on this 2-core host).
//
// The table holds (key, id) pairs for ALIVE nodes only, at load <= 0.5:
// a probe touches ONE 16-byte slot instead of three dependent cache
// lines (id table -> kmers[cand] -> alive[cand]), a dead/absent
// successor terminates on the first empty slot, and both the build and
// probe loops run block-wise with software prefetch so the random slot
// reads overlap (the DRAM-latency-bound form cost 12.7s at 9.3M nodes
// on this host; this one ~3s).
// kmers: sorted ascending (node id = position); alive: uint8.
void succ_build(const uint64_t* kmers, int64_t M, const int32_t* l_base,
                const int32_t* r_base, const uint8_t* alive, int k,
                int64_t* succ_out) {
    const uint64_t kmask =
        (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int head_shift = 2 * (k - 1);
    struct timespec tp0, tp1, tp2;
    const bool prof = getenv("DBG_PD_PROFILE") != nullptr;
    if (prof) clock_gettime(CLOCK_MONOTONIC, &tp0);
    int64_t n_alive = 0;
    for (int64_t i = 0; i < M; i++) n_alive += (alive[i] != 0);
    uint64_t size = 16;
    while (size < (uint64_t)n_alive * 2 + 2) size <<= 1;
    const uint64_t hm = size - 1;
    struct Slot { uint64_t key; int64_t id; };
    Slot* table = (Slot*)huge_alloc(size * sizeof(Slot));
    for (uint64_t s = 0; s < size; s++) table[s].id = -1;
    enum { B = 256 };
    {
        uint64_t hcs[B];
        for (int64_t blk = 0; blk < M; blk += B) {
            const int64_t hi = std::min<int64_t>(blk + B, M);
            for (int64_t i = blk; i < hi; i++) {
                hcs[i - blk] = jenkins64(kmers[i]) & hm;
                __builtin_prefetch(&table[hcs[i - blk]], 1, 1);
            }
            for (int64_t i = blk; i < hi; i++) {
                if (!alive[i]) continue;
                uint64_t hc = hcs[i - blk];
                while (table[hc].id >= 0) hc = (hc + 1) & hm;
                table[hc].key = kmers[i];
                table[hc].id = i;
            }
        }
    }
    if (prof) clock_gettime(CLOCK_MONOTONIC, &tp1);
    const int64_t STOP = 2 * M;
    uint64_t nfs[2 * B];
    uint64_t hcs[2 * B];
    int las[2 * B];
    for (int64_t blk = 0; blk < M; blk += B) {
        const int64_t hi = std::min<int64_t>(blk + B, M);
        int m = 0;
        for (int64_t i = blk; i < hi; i++) {
            const uint64_t km = kmers[i];
            for (int right = 1; right >= 0; right--, m++) {
                const uint64_t b =
                    (uint64_t)(right ? r_base[i] : l_base[i]);
                const uint64_t nk =
                    right ? (((km << 2) | b) & kmask)
                          : ((km >> 2) | (b << head_shift));
                const uint64_t rc = revcomp_k(nk, k);
                const bool flip = nk >= rc;
                nfs[m] = flip ? rc : nk;
                las[m] = right ? (int)flip : (int)(!flip);
                hcs[m] = jenkins64(nfs[m]) & hm;
                __builtin_prefetch(&table[hcs[m]], 0, 1);
            }
        }
        m = 0;
        for (int64_t i = blk; i < hi; i++) {
            for (int right = 1; right >= 0; right--, m++) {
                int64_t s = STOP;
                if (alive[i]) {
                    uint64_t hc = hcs[m];
                    while (table[hc].id >= 0) {
                        if (table[hc].key == nfs[m]) {
                            s = 2 * table[hc].id + las[m];
                            break;
                        }
                        hc = (hc + 1) & hm;
                    }
                }
                succ_out[2 * i + (right ? 0 : 1)] = s;
            }
        }
    }
    if (prof) {
        clock_gettime(CLOCK_MONOTONIC, &tp2);
        auto d = [](timespec a, timespec b) {
            return (b.tv_sec - a.tv_sec) + 1e-9 * (b.tv_nsec - a.tv_nsec);
        };
        fprintf(stderr, "      [sb] build %.2fs probe %.2fs (size %lu)\n",
                d(tp0, tp1), d(tp1, tp2), (unsigned long)size);
    }
    huge_free(table, size * sizeof(Slot));
}

// One-pass head/fallback collection for the doubling readout: state s
// (s>>1 = node, interleaved directions) is a chain head iff its node is
// alive, neither s nor its reverse state s^1 is cyclic, and s^1 has no
// successor (succ[s^1] >= n).  Also collects the nodes of cyclic alive
// states (serial-fallback set).  Replaces five full-width numpy
// temporaries with a single scan.  Returns the head count; fb_count
// receives the fallback-node count.
int64_t collect_heads(const uint8_t* alive, const int64_t* succ,
                      const uint8_t* cyclic, int64_t n,
                      int64_t* heads_out, int64_t* fb_nodes_out,
                      int64_t* fb_count) {
    int64_t nh = 0, nf = 0;
    for (int64_t s = 0; s < n; s++) {
        if (!alive[s >> 1]) continue;
        if (cyclic[s]) {
            if (!(s & 1)) fb_nodes_out[nf++] = s >> 1;
            else if (!cyclic[s ^ 1]) fb_nodes_out[nf++] = s >> 1;
            continue;
        }
        if (!cyclic[s ^ 1] && succ[s ^ 1] >= n) heads_out[nh++] = s;
    }
    *fb_count = nf;
    return nh;
}

// Per-group argmin: out[g] = index i of the smallest (key[i], i) among
// cid[i] == g.  One sequential pass with the (tiny, cache-resident)
// result array — replaces the readout's seed np.lexsort + np.unique
// over all chain states (ties broken by lowest i, matching lexsort's
// stable first-in-group pick).
void seg_argmin(const int64_t* cid, const int64_t* key, int64_t n,
                int64_t n_groups, int64_t* out) {
    std::vector<int64_t> best(n_groups, INT64_MAX);
    for (int64_t g = 0; g < n_groups; g++) out[g] = -1;
    for (int64_t i = 0; i < n; i++) {
        const int64_t g = cid[i];
        if (g < 0 || g >= n_groups) continue;
        if (key[i] < best[g]) { best[g] = key[i]; out[g] = i; }
    }
}

// Host chain resolution over the directed-state successor function:
// one O(n) pointer chase from every in-degree-0 source with path
// backfill, producing the SAME (end, dist, cyclic) triple the XLA
// pointer-doubling program (_resolve_chains) computes for every
// non-cyclic state — end = last chain state, dist = states from s to
// end inclusive.  States that never reach STOP (on or leading into a
// cycle) get (e=s, dist=1, cyclic=1); the readout masks them out and
// hands their nodes to the serial fallback walker, so only the flag
// must match the XLA program.  Walks that join an already-resolved
// chain backfill from its stored values, so merge shapes (in-degree>1)
// stay O(n) total.  succ: [n] with STOP encoded as any value >= n.
void resolve_chains_host(const int64_t* succ, int64_t n,
                         int64_t* e, int64_t* dist, uint8_t* cyclic) {
    for (int64_t s = 0; s < n; s++) { e[s] = -1; cyclic[s] = 0; }
    uint8_t* has_pred = (uint8_t*)huge_alloc((size_t)n);
    memset(has_pred, 0, (size_t)n);
    for (int64_t s = 0; s < n; s++) {
        const int64_t t = succ[s];
        if (t >= 0 && t < n) has_pred[t] = 1;
    }
    std::vector<int64_t> path;
    path.reserve(4096);
    for (int64_t src = 0; src < n; src++) {
        if (has_pred[src] || e[src] != -1) continue;
        path.clear();
        int64_t s = src;
        int64_t tail_e = -1, tail_d = 0;
        uint8_t tail_cyc = 0;
        while (true) {
            if (s < 0 || s >= n) break;           // STOP: end = path.back()
            if (e[s] == -2) { tail_cyc = 1; break; }   // own path: cycle
            if (e[s] != -1) {                     // joins a resolved chain
                tail_e = e[s]; tail_d = dist[s]; tail_cyc = cyclic[s];
                break;
            }
            e[s] = -2;
            path.push_back(s);
            s = succ[s];
        }
        const int64_t L = (int64_t)path.size();
        if (tail_cyc) {
            for (int64_t j = 0; j < L; j++) {
                const int64_t p = path[j];
                e[p] = p; dist[p] = 1; cyclic[p] = 1;
            }
        } else {
            const int64_t end = (tail_e >= 0) ? tail_e : path[L - 1];
            for (int64_t j = 0; j < L; j++) {
                const int64_t p = path[j];
                e[p] = end;
                dist[p] = tail_d + (L - j);
            }
        }
    }
    // pure cycles (every member in-degree 1): unreached above
    for (int64_t s = 0; s < n; s++) {
        if (e[s] == -1) { e[s] = s; dist[s] = 1; cyclic[s] = 1; }
    }
    huge_free(has_pred, (size_t)n);
}

// One-pass link/topology computation (calculate_kmer_links bulk math):
// per-node qualified-link count (capped 3), first-strict-max base, and
// the 256-bin depth histogram over BOTH counter planes.
void links_pass(const int32_t* lcnt, const int32_t* rcnt, int64_t M,
                int32_t cut, int32_t* l_num, int32_t* r_num,
                int32_t* l_base, int32_t* r_base, int64_t* hist256) {
    for (int i = 0; i < 256; i++) hist256[i] = 0;
    for (int64_t i = 0; i < M; i++) {
        const int32_t* l = lcnt + 4 * i;
        const int32_t* r = rcnt + 4 * i;
        int ln = 0, rn = 0, lb = 0, rb = 0;
        int lbest = 0, rbest = 0;
        for (int j = 0; j < 4; j++) {
            hist256[l[j] & 255]++;
            hist256[r[j] & 255]++;
            if (l[j] > cut) {
                ln++;
                if (l[j] > lbest) { lbest = l[j]; lb = j; }
            }
            if (r[j] > cut) {
                rn++;
                if (r[j] > rbest) { rbest = r[j]; rb = j; }
            }
        }
        l_num[i] = ln > 3 ? 3 : ln;
        r_num[i] = rn > 3 ? 3 : rn;
        l_base[i] = lb;
        r_base[i] = rb;
    }
}

// node -> iteration rank by ascending slot (the reference's hash-slot
// scan order).  One O(size) dense pass in C replaces a 13M-key argsort
// or a numpy random scatter into a 400MB table (~2.5 s each at E. coli
// x10 scale).
void slot_rank(const int64_t* slot_of, int64_t n, uint64_t size,
               int64_t* prio_out) {
    std::vector<int64_t> slot_node(size, -1);
    for (int64_t i = 0; i < n; i++) slot_node[slot_of[i]] = i;
    int64_t rank = 0;
    for (uint64_t s = 0; s < size; s++) {
        if (slot_node[s] >= 0) prio_out[slot_node[s]] = rank++;
    }
}

// hash_layout + per-node insert displacement (slot - home mod size): the
// callers weight displacement by occurrence counts for count_conflict
// parity and previously recomputed jenkins + modulo over all keys in
// numpy (~2.5 s at 13M nodes).
int64_t hash_layout_disp(const uint64_t* kmers, int64_t n, uint64_t size,
                         uint8_t* occupied, int64_t* slots_out,
                         int64_t* disp_out) {
    int64_t conflicts = 0;
    for (int64_t i = 0; i < n; i++) {
        uint64_t hc = jenkins64(kmers[i]) % size;
        int64_t d = 0;
        while (occupied[hc]) {
            d++;
            hc = (hc + 1 == size) ? 0 : hc + 1;
        }
        conflicts += d;
        occupied[hc] = 1;
        slots_out[i] = (int64_t)hc;
        disp_out[i] = d;
    }
    return conflicts;
}

// Epoch-aware layout: the hash-enlargement emulation.  Inserts kmers in
// first-occurrence order into a table of sizes[0]; after ends[e] total
// nodes are in (checked between ingest buffers by the caller's schedule),
// redistributes into sizes[e+1] via the reference's eviction walk
// (enlarge_kmerset_parallel, DBG_contig/kmerSet.cpp:132-189): old slots
// scanned ascending, each entry re-homed by jenkins % new_size with linear
// probing; landing on a not-yet-moved old entry swaps and continues
// placing the displaced entry.  No deletions exist during ingest, so the
// old del_flag only tracks "moved in this walk".
//
// snapshots_out: int64 [n_enlarge+1, n]; row e = slot of node i during
// epoch e, -1 before its insertion (callers weight per-epoch probe
// displacements by per-epoch occurrence counts to reproduce
// kset->count_conflict).  Final row equals slots_out.
// Returns the insert-time displacement total.
int64_t hash_layout_epochs(const uint64_t* kmers, int64_t n,
                           const uint64_t* sizes, const int64_t* ends,
                           int64_t n_enlarge,
                           int64_t* slots_out, int64_t* snapshots_out) {
    uint64_t size = sizes[0];
    std::vector<int64_t> slot_node(size, -1);   // slot -> node (or -1)
    int64_t conflicts = 0;
    int64_t inserted = 0;
    for (int64_t e = 0; e <= n_enlarge; e++) {
        int64_t upto = (e < n_enlarge) ? ends[e] : n;
        for (; inserted < upto; inserted++) {
            uint64_t hc = jenkins64(kmers[inserted]) % size;
            while (slot_node[hc] >= 0) {
                conflicts++;
                hc = (hc + 1 == size) ? 0 : hc + 1;
            }
            slot_node[hc] = inserted;
            slots_out[inserted] = (int64_t)hc;
        }
        if (snapshots_out) {
            int64_t* row = snapshots_out + e * n;
            for (int64_t i = 0; i < n; i++)
                row[i] = (i < inserted) ? slots_out[i] : -1;
        }
        if (e == n_enlarge) break;
        // ---- redistribution into sizes[e+1] (kmerSet.cpp:146-186)
        uint64_t old_size = size;
        uint64_t new_size = sizes[e + 1];
        std::vector<int64_t> old_node;
        old_node.swap(slot_node);               // old occupancy (nul_flag)
        std::vector<uint8_t> old_moved(old_size, 0);  // del_flag
        std::vector<uint8_t> new_nul(new_size, 0);
        slot_node.assign(new_size, -1);
        for (uint64_t i = 0; i < old_size; i++) {
            if (old_node[i] < 0 || old_moved[i]) continue;
            int64_t carry = old_node[i];
            old_node[i] = -1;
            old_moved[i] = 1;
            while (1) {
                uint64_t hc = jenkins64(kmers[carry]) % new_size;
                while (new_nul[hc]) hc = (hc + 1 == new_size) ? 0 : hc + 1;
                new_nul[hc] = 1;
                if (hc < old_size && old_node[hc] >= 0 && !old_moved[hc]) {
                    int64_t displaced = old_node[hc];
                    old_node[hc] = -1;
                    old_moved[hc] = 1;
                    slot_node[hc] = carry;
                    slots_out[carry] = (int64_t)hc;
                    carry = displaced;
                } else {
                    slot_node[hc] = carry;
                    slots_out[carry] = (int64_t)hc;
                    break;
                }
            }
        }
        size = new_size;
    }
    return conflicts;
}

// Permutation of indices under libstdc++ std::sort with comparator
// cmp(a,b) = lens[b] < lens[a]  (i.e. descending by length, unstable).
struct LenIdx {
    uint64_t len;
    int64_t idx;
};

// LSD radix argsort for distinct (or any) uint64 keys: 4 passes of
// 16-bit digits.  numpy's int64 argsort is a comparison sort (~1.2 s for
// 5M keys in _build_hash); this runs the same permutation in ~0.15 s.
void radix_argsort_u64(const uint64_t* keys, int64_t n, int64_t* idx_out) {
    std::vector<int64_t> tmp(n);
    std::vector<int64_t> cnt(1 << 16);
    int64_t* a = idx_out;
    int64_t* b = tmp.data();
    for (int64_t i = 0; i < n; i++) a[i] = i;
    for (int pass = 0; pass < 4; pass++) {
        int shift = 16 * pass;
        // skip a pass whose digit is constant across all keys
        uint64_t first = n ? ((keys[a[0]] >> shift) & 0xFFFF) : 0;
        bool constant = true;
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t i = 0; i < n; i++) {
            uint64_t d = (keys[a[i]] >> shift) & 0xFFFF;
            constant &= (d == first);
            cnt[d]++;
        }
        if (constant) continue;
        int64_t run = 0;
        for (int64_t d = 0; d < (1 << 16); d++) {
            int64_t c = cnt[d];
            cnt[d] = run;
            run += c;
        }
        for (int64_t i = 0; i < n; i++)
            b[cnt[(keys[a[i]] >> shift) & 0xFFFF]++] = a[i];
        std::swap(a, b);
    }
    if (a != idx_out) std::copy(a, a + n, idx_out);
}

void stdsort_perm_desc(const uint64_t* lens, int64_t n, int64_t* idx_out) {
    LenIdx* v = new LenIdx[n];
    for (int64_t i = 0; i < n; i++) {
        v[i].len = lens[i];
        v[i].idx = i;
    }
    std::sort(v, v + n, [](const LenIdx& a, const LenIdx& b) {
        return b.len < a.len;
    });
    for (int64_t i = 0; i < n; i++) idx_out[i] = v[i].idx;
    delete[] v;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// GCC 4.4-era std::sort permutation.  The shipped reference binaries were
// built with GCC 4.4.7 (strings: "GCC: (GNU) 4.4.7"); libstdc++'s introsort
// pivot selection changed in 4.7 (__unguarded_partition_pivot), so a modern
// std::sort produces a different TIE order.  This reimplements the 4.4
// algorithm structure (threshold-16 introsort + final insertion sort +
// heapsort fallback) so equal-length records land in the same order the
// reference emits them.  Comparator: cmp(a,b) = b.len < a.len (descending).
// ---------------------------------------------------------------------------

namespace gcc44 {

struct El {
    uint64_t len;
    int64_t idx;
};

static inline bool cmp(const El& a, const El& b) { return b.len < a.len; }

static const int64_t S_threshold = 16;

static El median(const El& a, const El& b, const El& c) {
    // exact SGI/GCC __median branch order (stl_algo.h) — note the else
    // chain returns a, c, b (verified against the shipped binary via the
    // link_scaffold singleton oracle, tools/sort_oracle_fuzz.py)
    if (cmp(a, b)) {
        if (cmp(b, c)) return b;
        else if (cmp(a, c)) return c;
        else return a;
    } else if (cmp(a, c)) return a;
    else if (cmp(b, c)) return c;
    else return b;
}

static int64_t unguarded_partition(El* v, int64_t first, int64_t last,
                                   El pivot) {
    while (true) {
        while (cmp(v[first], pivot)) ++first;
        --last;
        while (cmp(pivot, v[last])) --last;
        if (!(first < last)) return first;
        El t = v[first];
        v[first] = v[last];
        v[last] = t;
        ++first;
    }
}

static void unguarded_linear_insert(El* v, int64_t last, El val) {
    int64_t next = last - 1;
    while (cmp(val, v[next])) {
        v[last] = v[next];
        last = next;
        --next;
    }
    v[last] = val;
}

static void insertion_sort(El* v, int64_t first, int64_t last) {
    if (first == last) return;
    for (int64_t i = first + 1; i != last; ++i) {
        if (cmp(v[i], v[first])) {
            El val = v[i];
            for (int64_t j = i; j > first; --j) v[j] = v[j - 1];
            v[first] = val;
        } else {
            unguarded_linear_insert(v, i, v[i]);
        }
    }
}

static void unguarded_insertion_sort(El* v, int64_t first, int64_t last) {
    for (int64_t i = first; i != last; ++i)
        unguarded_linear_insert(v, i, v[i]);
}

static void adjust_heap(El* v, int64_t first, int64_t hole, int64_t len,
                        El val) {
    // 4.4-era __adjust_heap + __push_heap
    int64_t top = hole;
    int64_t second = 2 * hole + 2;
    while (second < len) {
        if (cmp(v[first + second], v[first + (second - 1)])) second--;
        v[first + hole] = v[first + second];
        hole = second;
        second = 2 * (second + 1);
    }
    if (second == len) {
        v[first + hole] = v[first + (second - 1)];
        hole = second - 1;
    }
    int64_t parent = (hole - 1) / 2;
    while (hole > top && cmp(v[first + parent], val)) {
        v[first + hole] = v[first + parent];
        hole = parent;
        parent = (hole - 1) / 2;
    }
    v[first + hole] = val;
}

static void make_heap(El* v, int64_t first, int64_t last) {
    int64_t len = last - first;
    if (len < 2) return;
    int64_t parent = (len - 2) / 2;
    while (true) {
        El val = v[first + parent];
        adjust_heap(v, first, parent, len, val);
        if (parent == 0) return;
        parent--;
    }
}

static void heap_sort(El* v, int64_t first, int64_t last) {
    make_heap(v, first, last);
    while (last - first > 1) {
        --last;
        El val = v[last];
        v[last] = v[first];
        adjust_heap(v, first, 0, last - first, val);
    }
}

static int lg(int64_t n) {
    int k = 0;
    for (; n != 1; n >>= 1) ++k;
    return k;
}

static void introsort_loop(El* v, int64_t first, int64_t last,
                           int depth_limit) {
    while (last - first > S_threshold) {
        if (depth_limit == 0) {
            heap_sort(v, first, last);  // __partial_sort(first,last,last)
            return;
        }
        --depth_limit;
        El pivot = median(v[first], v[first + (last - first) / 2],
                          v[last - 1]);
        int64_t cut = unguarded_partition(v, first, last, pivot);
        introsort_loop(v, cut, last, depth_limit);
        last = cut;
    }
}

static void sort(El* v, int64_t n) {
    if (n == 0) return;
    introsort_loop(v, 0, n, lg(n) * 2);
    if (n > S_threshold) {
        insertion_sort(v, 0, S_threshold);
        unguarded_insertion_sort(v, S_threshold, n);
    } else {
        insertion_sort(v, 0, n);
    }
}

}  // namespace gcc44

extern "C" {

void gcc44_sort_perm_desc(const uint64_t* lens, int64_t n, int64_t* idx_out) {
    gcc44::El* v = new gcc44::El[n];
    for (int64_t i = 0; i < n; i++) {
        v[i].len = lens[i];
        v[i].idx = i;
    }
    gcc44::sort(v, n);
    for (int64_t i = 0; i < n; i++) idx_out[i] = v[i].idx;
    delete[] v;
}

}  // extern "C"
