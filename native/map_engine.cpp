// Native positional-index read mapper: seed-and-extend with the
// first-qualifying-seed early exit.
//
// C++ twin of dbg_assembly/scaffold/index.py (which stays as the
// readable specification and DBG_PY_MAP=1 fallback).  Same semantics:
// index = canonical contig k-mers -> (contig id, offset, strand, unique),
// first-inserted payload kept and duplicates clear the uniqueness bit;
// seed = first read position i >= search_start-1 with unique same-contig
// k-mers at i and i+S spaced |S| apart; extension = ungapped end-to-end
// byte comparison with float32 identity arithmetic.
//
// The Python path evaluates ALL positions and argmaxes; the reference (and
// this engine) stop at the first qualifying seed — identical result, ~10x
// fewer probes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace mapN {

struct Entry {
    uint64_t kmer;
    int32_t id;
    int32_t pos;
    uint8_t dir;
    uint8_t uniq;
};

struct Index {
    std::vector<uint32_t> slots;   // entry index + 1; 0 empty
    std::vector<Entry> entries;
    uint64_t mask;
    int k;
    uint64_t kmask;
    // contig bases for extension
    const uint8_t* concat;
    std::vector<int64_t> offsets;
    std::vector<int64_t> lengths;
    std::vector<uint8_t> concat_own;

    static uint64_t hash(uint64_t kk) {
        kk += 0x9E3779B97F4A7C15ULL;
        kk = (kk ^ (kk >> 30)) * 0xBF58476D1CE4E5B9ULL;
        kk = (kk ^ (kk >> 27)) * 0x94D049BB133111EBULL;
        return kk ^ (kk >> 31);
    }

    void grow() {
        uint64_t ns = (mask + 1) << 1;
        std::vector<uint32_t> fresh(ns, 0);
        uint64_t nm = ns - 1;
        for (uint64_t i = 0; i < entries.size(); i++) {
            uint64_t hc = hash(entries[i].kmer) & nm;
            while (fresh[hc]) hc = (hc + 1) & nm;
            fresh[hc] = (uint32_t)(i + 1);
        }
        slots.swap(fresh);
        mask = nm;
    }

    void insert(uint64_t key, int32_t id, int32_t pos, uint8_t dir) {
        // slots hold uint32 entry-index+1: abort before the index space
        // overflows and silently aliases distinct k-mers (ADVICE round 1)
        if (entries.size() >= 0xFFFFFFFEULL) {
            fprintf(stderr, "map_engine: >4.29e9 index entries exceeds the "
                            "32-bit entry index space\n");
            abort();
        }
        if ((entries.size() + 1) * 10 > (mask + 1) * 7) grow();
        uint64_t hc = hash(key) & mask;
        while (true) {
            uint32_t s = slots[hc];
            if (s == 0) {
                slots[hc] = (uint32_t)(entries.size() + 1);
                entries.push_back(Entry{key, id, pos, dir, 1});
                return;
            }
            Entry& e = entries[s - 1];
            if (e.kmer == key) {
                e.uniq = 0;      // duplicate: keep first payload
                return;
            }
            hc = (hc + 1) & mask;
        }
    }

    const Entry* find(uint64_t key) const {
        uint64_t hc = hash(key) & mask;
        while (true) {
            uint32_t s = slots[hc];
            if (s == 0) return nullptr;
            const Entry& e = entries[s - 1];
            if (e.kmer == key) return &e;
            hc = (hc + 1) & mask;
        }
    }
};

// ASCII -> 2-bit (kmer variant: everything 0 except CcGgTt; dna.py _KMER_LUT)
static uint8_t CODE_LUT[256];
static uint8_t COMP_LUT[256];
static bool luts_ready = false;

static void init_luts() {
    if (luts_ready) return;
    memset(CODE_LUT, 0, sizeof(CODE_LUT));
    CODE_LUT['C'] = CODE_LUT['c'] = 1;
    CODE_LUT['G'] = CODE_LUT['g'] = 2;
    CODE_LUT['T'] = CODE_LUT['t'] = 3;
    memset(COMP_LUT, 0, sizeof(COMP_LUT));
    COMP_LUT['A'] = 'T';
    COMP_LUT['C'] = 'G';
    COMP_LUT['G'] = 'C';
    COMP_LUT['T'] = 'A';
    COMP_LUT['N'] = 'N';
    luts_ready = true;
}

static uint64_t revcomp(uint64_t kbit, int k) {
    uint64_t out = 0;
    for (int i = 0; i < k; i++) {
        out = (out << 2) | (3ULL - (kbit & 3ULL));
        kbit >>= 2;
    }
    return out;
}

}  // namespace mapN

extern "C" {

// concat: raw ASCII of all contig slots back-to-back; offsets [n+1]
void* mapidx_create(int k, const uint8_t* concat, const int64_t* offsets,
                    int64_t n_contigs) {
    mapN::init_luts();
    mapN::Index* ix = new mapN::Index();
    ix->k = k;
    ix->kmask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    ix->slots.assign(1 << 16, 0);
    ix->mask = (1 << 16) - 1;
    ix->offsets.assign(offsets, offsets + n_contigs + 1);
    ix->lengths.resize(n_contigs);
    for (int64_t i = 0; i < n_contigs; i++)
        ix->lengths[i] = offsets[i + 1] - offsets[i];
    int64_t total = offsets[n_contigs];
    ix->concat_own.assign(concat, concat + total);
    ix->concat = ix->concat_own.data();

    uint64_t head_shift = 2ULL * (k - 1);
    for (int64_t i = 0; i < n_contigs; i++) {
        int64_t len = ix->lengths[i];
        if (len < k) continue;
        const uint8_t* seq = concat + offsets[i];
        // split at N/n runs (scaffold_to_contig semantics)
        int64_t s = 0;
        while (s < len) {
            while (s < len && (seq[s] == 'N' || seq[s] == 'n')) s++;
            int64_t e = s;
            while (e < len && seq[e] != 'N' && seq[e] != 'n') e++;
            if (e - s >= k) {
                uint64_t fwd = 0, rc = 0;
                for (int j = 0; j < k; j++) {
                    uint64_t b = mapN::CODE_LUT[seq[s + j]];
                    fwd = (fwd << 2) | b;
                    rc |= (3ULL - b) << (2 * j);
                }
                for (int64_t j = 0; j + k <= e - s; j++) {
                    if (j > 0) {
                        uint64_t b = mapN::CODE_LUT[seq[s + j + k - 1]];
                        fwd = ((fwd << 2) | b) & ix->kmask;
                        rc = (rc >> 2) | ((3ULL - b) << head_shift);
                    }
                    uint8_t dir = fwd < rc;
                    uint64_t can = dir ? fwd : rc;
                    ix->insert(can, (int32_t)i, (int32_t)(s + j), dir);
                }
            }
            s = e;
        }
    }
    return ix;
}

void mapidx_free(void* h) {
    delete (mapN::Index*)h;
}

int64_t mapidx_nkmers(void* h) {
    return (int64_t)((mapN::Index*)h)->entries.size();
}

void mapidx_map(void* h, const uint8_t* codes, const uint8_t* ascii_,
                int64_t N, int L, const int32_t* lengths,
                const int64_t* search_start, int S, double min_identity,
                uint8_t* mapped, int32_t* out_cid, int32_t* read_start,
                int32_t* read_end, int32_t* ctg_start, int32_t* ctg_end,
                uint8_t* out_dir, float* identity) {
    mapN::Index* ix = (mapN::Index*)h;
    const int k = ix->k;
    uint64_t head_shift = 2ULL * (k - 1);
    std::vector<uint64_t> can((size_t)(L > k ? L - k + 1 : 1));
    std::vector<uint8_t> rdir(can.size());
    std::vector<const mapN::Entry*> ent(can.size());
    std::vector<uint8_t> probed(can.size());

    for (int64_t r = 0; r < N; r++) {
        mapped[r] = 0;
        out_cid[r] = 0;
        read_start[r] = read_end[r] = ctg_start[r] = ctg_end[r] = 0;
        out_dir[r] = 0;
        identity[r] = 0.0f;
        int64_t len = lengths[r];
        if (len > L) len = L;
        int64_t P = len - k + 1;
        if (P <= 0) continue;
        const uint8_t* row = codes + r * L;
        // rolling canonical k-mers of the whole read (cheap linear pass)
        uint64_t fwd = 0, rc = 0;
        for (int j = 0; j < k; j++) {
            fwd = (fwd << 2) | row[j];
            rc |= (3ULL - (uint64_t)row[j]) << (2 * j);
        }
        for (int64_t j = 0; j < P; j++) {
            if (j > 0) {
                uint64_t b = row[j + k - 1];
                fwd = ((fwd << 2) | b) & ix->kmask;
                rc = (rc >> 2) | ((3ULL - b) << head_shift);
            }
            rdir[j] = fwd < rc;
            can[j] = rdir[j] ? fwd : rc;
            probed[j] = 0;
        }
        auto probe = [&](int64_t j) -> const mapN::Entry* {
            if (!probed[j]) {
                probed[j] = 1;
                ent[j] = ix->find(can[j]);
            }
            return ent[j];
        };
        int64_t ss = search_start[r];
        int64_t i_lo = ss - 1;
        if (i_lo < 0) i_lo = 0;
        int64_t i_hi = len - k - S;          // inclusive
        int64_t seed = -1;
        const mapN::Entry *e1 = nullptr, *e2 = nullptr;
        for (int64_t i = i_lo; i <= i_hi; i++) {
            const mapN::Entry* a = probe(i);
            if (!a || !a->uniq) continue;
            const mapN::Entry* b = probe(i + S);
            if (!b || !b->uniq) continue;
            if (a->id != b->id) continue;
            int64_t d = (int64_t)b->pos - (int64_t)a->pos;
            if (d != S && d != -S) continue;
            seed = i;
            e1 = a;
            e2 = b;
            break;
        }
        if (seed < 0) continue;

        int64_t p1 = e1->pos, p2 = e2->pos;
        bool is_f = rdir[seed] == e1->dir;
        int64_t seed_ctg_start = is_f ? p1 + 1 : p2 + 1;
        int64_t seed_ctg_end = is_f ? p2 + k : p1 + k;
        int64_t seed_read_start = seed + 1;
        int64_t seed_read_end = seed + S + k;
        int64_t clen = ix->lengths[e1->id];
        int64_t coff = ix->offsets[e1->id];

        int64_t w_start = is_f ? seed_read_start : len - seed_read_end + 1;
        int64_t w_end = is_f ? seed_read_end : len - seed_read_start + 1;
        int64_t ext_l = w_start - 1 < seed_ctg_start - 1
            ? w_start - 1 : seed_ctg_start - 1;
        int64_t ext_r = len - w_end < clen - seed_ctg_end
            ? len - w_end : clen - seed_ctg_end;
        int64_t a_read_start = w_start - ext_l;
        int64_t a_read_end = w_end + ext_r;
        int64_t a_ctg_start = seed_ctg_start - ext_l;
        int64_t a_ctg_end = seed_ctg_end + ext_r;
        int64_t align_len = a_read_end - a_read_start + 1;

        const uint8_t* asc = ascii_ + r * L;
        int64_t mm = 0;
        for (int64_t t = a_read_start; t <= a_read_end; t++) {
            if (t >= w_start && t <= w_end) continue;
            uint8_t rch = is_f ? asc[t - 1] : mapN::COMP_LUT[asc[len - t]];
            uint8_t cch = ix->concat[coff + a_ctg_start - 1
                                     + (t - a_read_start)];
            if (rch != cch) mm++;
        }
        float frac = (float)mm / (float)align_len;
        float ident = (float)(1.0 - (double)frac);
        identity[r] = ident;
        if ((double)ident < min_identity) continue;

        mapped[r] = 1;
        out_cid[r] = e1->id;
        read_start[r] = (int32_t)(is_f ? a_read_start : len - a_read_end + 1);
        read_end[r] = (int32_t)(is_f ? a_read_end : len - a_read_start + 1);
        ctg_start[r] = (int32_t)a_ctg_start;
        ctg_end[r] = (int32_t)a_ctg_end;
        out_dir[r] = is_f ? 1 : 0;
    }
}

}  // extern "C"
