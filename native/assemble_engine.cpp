// Native contig assembler: order-exact graph pruning + readout.
//
// C++ transcription of dbg_assembly/contig/refassemble.py (the byte-
// parity path replaying DBG_contig/contig.cpp:54-1046 semantics over the
// device-aggregated node table).  The Python module remains the readable
// specification and fallback (DBG_PY_ASSEMBLE=1); this engine makes the
// host tail run at reference-binary speed.
//
// All inputs are prepared by RefAssembler._build_hash (hash layout, slot
// order); this engine performs calculate_kmer_links, tips/lowedges/bubbles,
// contig readout and writes the eight .contig.* artifacts directly.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" void gcc44_sort_perm_desc(const uint64_t* lens, int64_t n,
                                     int64_t* idx_out);

namespace asmN {

static const char BASES[] = "ACGTN";
static const char C_BASES[] = "TGCAN";

struct Engine {
    // set to the failing path on fopen failure; assemble_run surfaces it
    // as a nonzero return so the Python wrapper can raise (ADVICE round 1)
    std::string io_error;

    FILE* xopen(const std::string& path, const char* mode) {
        FILE* f = fopen(path.c_str(), mode);
        if (!f && io_error.empty()) io_error = path;
        return f;
    }

    // node arrays (size n+1, last row = sentinel zeros)
    const uint64_t* kmer;
    int32_t* lcnt;   // [n+1][4], mutated by recalculate
    int32_t* rcnt;
    int64_t n;       // real nodes (sentinel id == n)
    int k;
    uint64_t mask;
    int cut;

    // hash for exist()
    const int64_t* slot_of;   // [n]
    uint64_t size;

    // link state
    std::vector<int8_t> l_num, l_base, r_num, r_base;
    std::vector<uint8_t> linear, deleted;

    std::vector<int64_t> tip_nodes, branch_nodes;
    int64_t depth_stat[256];

    // params
    int is_tip, tip_len_cut;
    double tip_depth_cut;
    int is_lowedge, lowedge_len_cut;
    double lowedge_depth_cut;
    int is_bubble, bubble_len_cut;
    double bubble_len_diff, bubble_base_diff;
    int contig_len_cutoff;

    // stats
    int64_t st_total, st_del_lowfreq, st_linear, st_tipcand, st_branchcand;
    int64_t st_tips, st_tiplen, st_lowedges, st_lowedgelen;
    int64_t st_bubbles, st_bubblelen;
    int64_t st_ctg_num, st_ctg_len, st_small_num, st_small_len;

    static uint64_t jenkins(uint64_t kk) {
        kk = kk + ~(kk << 32);
        kk = kk ^ (kk >> 22);
        kk = kk + ~(kk << 13);
        kk = kk ^ (kk >> 8);
        kk = kk + (kk << 3);
        kk = kk ^ (kk >> 15);
        kk = kk + ~(kk << 27);
        kk = kk ^ (kk >> 31);
        return kk;
    }

    // bit-parallel reverse complement (complement = ~x per 2-bit unit,
    // then reverse the 2-bit units and right-align) — the walk hot loops
    // call this once per step; the naive k-iteration shift loop was ~2x
    // of the whole walk cost at k=31
    uint64_t revcomp(uint64_t v) const {
        v = ~v;
        v = ((v >> 2) & 0x3333333333333333ULL) |
            ((v & 0x3333333333333333ULL) << 2);
        v = ((v >> 4) & 0x0F0F0F0F0F0F0F0FULL) |
            ((v & 0x0F0F0F0F0F0F0F0FULL) << 4);
        v = __builtin_bswap64(v);
        return v >> (64 - 2 * k);
    }

    // exist_kmerset equivalent: probe the emulated layout; deleted -> n.
    // Key and node id live in ONE 16-byte slot (like the reference's
    // KmerNode array, kmerSet.h:70-75) so a probe is a single random
    // cache-line access instead of slot->id->key double indirection.
    struct Slot { uint64_t key; int32_t nid; int32_t pad; };
    std::vector<Slot> slots_;

    int64_t exist(uint64_t key) const {
        uint64_t hc = jenkins(key) % size;
        while (true) {
            const Slot& s = slots_[hc];
            if (s.nid < 0) return n;
            if (s.key == key) return deleted[s.nid] ? n : s.nid;
            hc++;
            if (hc == size) hc = 0;
        }
    }

    void build_slot_table() {
        slots_.assign(size, Slot{0, -1, 0});
        for (int64_t i = 0; i < n; i++)
            if (slot_of[i] >= 0) {
                slots_[slot_of[i]].key = kmer[i];
                slots_[slot_of[i]].nid = (int32_t)i;
            }
    }

    // ------------------------------------------------------------- klinks
    void calculate_kmer_links() {
        l_num.assign(n + 1, 0); l_base.assign(n + 1, 0);
        r_num.assign(n + 1, 0); r_base.assign(n + 1, 0);
        linear.assign(n + 1, 0); deleted.assign(n + 1, 0);
        memset(depth_stat, 0, sizeof(depth_stat));
        st_total = n; st_del_lowfreq = 0; st_linear = 0;
        for (int64_t i = 0; i < n; i++) {
            const int32_t* l = lcnt + 4 * i;
            const int32_t* r = rcnt + 4 * i;
            int ln = 0, rn = 0, lb = 0, rb = 0, lmax = 0, rmax = 0;
            for (int j = 0; j < 4; j++) {
                depth_stat[l[j] & 0xFF]++;
                depth_stat[r[j] & 0xFF]++;
                if (l[j] > cut) { ln++; if (l[j] > lmax) { lmax = l[j]; lb = j; } }
                if (r[j] > cut) { rn++; if (r[j] > rmax) { rmax = r[j]; rb = j; } }
            }
            if (ln > 3) ln = 3;
            if (rn > 3) rn = 3;
            l_num[i] = (int8_t)ln; l_base[i] = (int8_t)lb;
            r_num[i] = (int8_t)rn; r_base[i] = (int8_t)rb;
            if (ln == 1 && rn == 1) { linear[i] = 1; st_linear++; }
            if (ln == 0 && rn == 0) { deleted[i] = 1; st_del_lowfreq++; }
        }
    }

    void collect_candidates(const int64_t* slot_order) {
        for (int64_t s = 0; s < n; s++) {
            int64_t i = slot_order[s];
            int tot = l_num[i] + r_num[i];
            if (tot == 1) tip_nodes.push_back(i);
            if (l_num[i] > 1 || r_num[i] > 1) branch_nodes.push_back(i);
        }
        st_tipcand = (int64_t)tip_nodes.size();
        st_branchcand = (int64_t)branch_nodes.size();
    }

    void write_kmer_freq(const std::string& path) {
        FILE* f = xopen(path, "w");
        if (!f) return;
        fprintf(f, "Kmer_depth\tAppear_times\n");
        for (int i = 1; i < 256; i++)
            fprintf(f, "%d\t%lld\n", i, (long long)depth_stat[i]);
        fclose(f);
    }

    // parity contig.cpp:210-277
    void recalculate_kmer_links(int64_t idx) {
        if (idx == n) return;
        uint64_t km = kmer[idx];
        l_num[idx] = 0; l_base[idx] = 0; linear[idx] = 0;
        int maxd = 0;
        for (int j = 0; j < 4; j++) {
            int d = lcnt[4 * idx + j];
            if (d > cut) {
                uint64_t nk = (km >> 2) + ((uint64_t)j << (2 * (k - 1)));
                uint64_t rc = revcomp(nk);
                uint64_t nf = nk < rc ? nk : rc;
                if (exist(nf) != n) {
                    if (l_num[idx] < 3) l_num[idx]++;
                    if (maxd < d) { maxd = d; l_base[idx] = (int8_t)j; }
                } else {
                    lcnt[4 * idx + j] = 0;
                }
            }
        }
        r_num[idx] = 0; r_base[idx] = 0;
        maxd = 0;
        for (int j = 0; j < 4; j++) {
            int d = rcnt[4 * idx + j];
            if (d > cut) {
                uint64_t nk = ((km << 2) | (uint64_t)j) & mask;
                uint64_t rc = revcomp(nk);
                uint64_t nf = nk < rc ? nk : rc;
                if (exist(nf) != n) {
                    if (r_num[idx] < 3) r_num[idx]++;
                    if (maxd < d) { maxd = d; r_base[idx] = (int8_t)j; }
                } else {
                    rcnt[4 * idx + j] = 0;
                }
            }
        }
        if (l_num[idx] == 1 && r_num[idx] == 1) linear[idx] = 1;
    }

    // ---------------------------------------------------------------- walks
    struct PathRes {
        int64_t len;
        int64_t depth;
        std::vector<int64_t> vec;
        std::string chars;
        int64_t last;
        const char* mark;
    };

    // parity contig.cpp:779-827
    void get_linear_path(int64_t idx, int walk, int64_t len_cutoff,
                         PathRes& out) {
        int original = walk;
        out.len = 0; out.depth = 0;
        out.vec.clear(); out.chars.clear();
        while (true) {
            out.len++;
            out.vec.push_back(idx);
            uint64_t km = kmer[idx];
            uint64_t nk;
            if (walk == 1) {
                int b = r_base[idx];
                nk = ((km << 2) | (uint64_t)b) & mask;
                out.depth += rcnt[4 * idx + b];
                out.chars.push_back(original == 1 ? BASES[b] : C_BASES[b]);
            } else {
                int b = l_base[idx];
                nk = (km >> 2) + ((uint64_t)b << (2 * (k - 1)));
                out.depth += lcnt[4 * idx + b];
                out.chars.push_back(original == 1 ? C_BASES[b] : BASES[b]);
            }
            uint64_t rc = revcomp(nk);
            uint64_t nf;
            if (nk < rc) {
                nf = nk;
            } else {
                nf = rc;
                walk = -walk;
            }
            int64_t nxt = exist(nf);
            if (!linear[nxt] || nxt == n || out.len >= len_cutoff) {
                out.last = nxt;
                if (nxt == n) out.mark = "break";
                else if (l_num[nxt] == 0 || r_num[nxt] == 0) out.mark = "break";
                else out.mark = "branch";
                return;
            }
            idx = nxt;
        }
    }

    struct SeqRes {
        int64_t len;
        int64_t depth;
        std::string chars;
        int64_t last;
        const char* mark;
        std::string depths;     // raw bytes
        const char* is_repeat;  // "Unknown"/"Repeat"/"Unique"
    };

    // parity contig.cpp:832-896 (deletes traversed nodes)
    void get_linear_seq(int64_t idx, int walk, SeqRes& out) {
        int original = walk;
        out.len = 0; out.depth = 0;
        out.chars.clear(); out.depths.clear();
        out.is_repeat = "Unknown";
        while (true) {
            out.len++;
            uint64_t km = kmer[idx];
            uint64_t nk;
            int d;
            if (walk == 1) {
                int b = r_base[idx];
                nk = ((km << 2) | (uint64_t)b) & mask;
                d = rcnt[4 * idx + b];
                out.depth += d;
                if (d == 10 || d == 62) d -= 1;
                out.depths.push_back((char)(d & 0xFF));
                out.chars.push_back(original == 1 ? BASES[b] : C_BASES[b]);
            } else {
                int b = l_base[idx];
                nk = (km >> 2) + ((uint64_t)b << (2 * (k - 1)));
                d = lcnt[4 * idx + b];
                out.depth += d;
                if (d == 10 || d == 62) d -= 1;
                out.depths.push_back((char)(d & 0xFF));
                out.chars.push_back(original == 1 ? C_BASES[b] : BASES[b]);
            }
            uint64_t rc = revcomp(nk);
            uint64_t nf;
            if (nk < rc) {
                nf = nk;
            } else {
                nf = rc;
                walk = -walk;
            }
            int64_t nxt = exist(nf);
            if (!linear[nxt] || nxt == n) {
                out.last = nxt;
                if (nxt == n) out.mark = "break";
                else if (l_num[nxt] == 0 || r_num[nxt] == 0) out.mark = "break";
                else {
                    out.mark = "branch";
                    if ((walk == 1 && r_num[nxt] > 1) ||
                        (walk == -1 && l_num[nxt] > 1))
                        out.is_repeat = "Repeat";
                    else
                        out.is_repeat = "Unique";
                }
                return;
            }
            deleted[nxt] = 1;
            idx = nxt;
        }
    }

    static std::string g6(double x) {
        char buf[64];
        snprintf(buf, sizeof(buf), "%g", x);
        return buf;
    }
    static std::string lex17(double x) {
        char buf[64];
        snprintf(buf, sizeof(buf), "%.17g", x);
        return buf;
    }

    std::string bit2seq(uint64_t kbit) const {
        std::string s(k, 'A');
        for (int i = 0; i < k; i++)
            s[i] = BASES[(kbit >> (2 * (k - 1 - i))) & 3];
        return s;
    }

    // ----------------------------------------------------------------- tips
    void remove_error_tips(const std::string& path) {
        FILE* f = xopen(path, "w");
        if (!f) return;
        int64_t total_num = 0, total_len = 0;
        PathRes pr;
        for (int64_t idx : tip_nodes) {
            int walk = (l_num[idx] == 1) ? -1 : 1;
            get_linear_path(idx, walk, tip_len_cut, pr);
            double avg = (double)pr.depth / (double)pr.len;
            if (avg <= tip_depth_cut && pr.len <= tip_len_cut) {
                total_num++;
                total_len += pr.len;
                for (int64_t v : pr.vec) deleted[v] = 1;
                recalculate_kmer_links(pr.last);
                uint64_t lkm, rkm;
                const char *lmark, *rmark;
                if (walk == 1) {
                    lkm = kmer[idx]; lmark = "break";
                    rkm = kmer[pr.last]; rmark = pr.mark;
                } else {
                    rkm = kmer[idx]; rmark = "break";
                    lkm = kmer[pr.last]; lmark = pr.mark;
                }
                std::string ks = bit2seq(kmer[idx]);
                std::string out;
                if (walk == 1) {
                    out = ks + pr.chars;
                } else {
                    out.assign(pr.chars.rbegin(), pr.chars.rend());
                    out += ks;
                }
                fprintf(f, ">tip_%lld\tlength: %lld\tavgDepth: %s"
                        "\tLeftEndKmer: %llu %s\tRightEndKmer: %llu %s\n%s\n",
                        (long long)total_num, (long long)(pr.len + k),
                        g6(avg).c_str(), (unsigned long long)lkm, lmark,
                        (unsigned long long)rkm, rmark, out.c_str());
            }
        }
        fclose(f);
        st_tips = total_num;
        st_tiplen = total_len;
    }

    // ------------------------------------------------------------- lowedges
    void branch_bases(const int32_t* row, int* vb, int* vd, int* cnt) const {
        *cnt = 0;
        for (int j = 0; j < 4; j++) {
            if (row[j] > cut) {
                vb[*cnt] = j;
                vd[*cnt] = row[j];
                (*cnt)++;
            }
        }
    }

    void remove_lowCov_edges(const std::string& path) {
        FILE* f = xopen(path, "w");
        if (!f) return;
        int64_t num = 0, tot_len = 0;
        PathRes pr;
        int vb[4], vd[4], cntb;
        for (int64_t idx : branch_nodes) {
            if (r_num[idx] >= 2) {
                branch_bases(rcnt + 4 * idx, vb, vd, &cntb);
                for (int j = 0; j < cntb; j++) {
                    uint64_t km = kmer[idx];
                    uint64_t nk = ((km << 2) | (uint64_t)vb[j]) & mask;
                    uint64_t rc = revcomp(nk);
                    uint64_t nf;
                    int w1;
                    if (nk < rc) { nf = nk; w1 = 1; }
                    else { nf = rc; w1 = -1; }
                    int64_t idx1 = exist(nf);
                    if (!linear[idx1]) continue;
                    get_linear_path(idx1, w1, lowedge_len_cut, pr);
                    int64_t elen = pr.len + 1;
                    int64_t edep = pr.depth + vd[j];
                    double avg = (double)edep / (double)elen;
                    if (elen <= lowedge_len_cut && avg <= lowedge_depth_cut
                            && !linear[pr.last]) {
                        num++;
                        tot_len += elen;
                        for (int64_t v : pr.vec) deleted[v] = 1;
                        recalculate_kmer_links(pr.last);
                        recalculate_kmer_links(idx);
                        std::string ks1 = bit2seq(kmer[idx1]);
                        std::string out1;
                        if (w1 == 1) out1 = ks1 + pr.chars;
                        else {
                            out1.assign(pr.chars.rbegin(), pr.chars.rend());
                            out1 += ks1;
                        }
                        fprintf(f, ">lowedge_%lld\tlength: %lld"
                                "\tavgDepth: %s\tLeftEndKmer: %llu branch"
                                "\tRightEndKmer: %llu %s\n%s\n",
                                (long long)num, (long long)(elen + k),
                                g6(avg).c_str(),
                                (unsigned long long)kmer[idx],
                                (unsigned long long)kmer[pr.last], pr.mark,
                                out1.c_str());
                    }
                }
            }
            if (l_num[idx] >= 2) {
                branch_bases(lcnt + 4 * idx, vb, vd, &cntb);
                for (int j = 0; j < cntb; j++) {
                    uint64_t km = kmer[idx];
                    uint64_t nk = (km >> 2)
                        + ((uint64_t)vb[j] << (2 * (k - 1)));
                    uint64_t rc = revcomp(nk);
                    uint64_t nf;
                    int w1;
                    if (nk < rc) { nf = nk; w1 = -1; }
                    else { nf = rc; w1 = 1; }
                    int64_t idx1 = exist(nf);
                    if (!linear[idx1]) continue;
                    get_linear_path(idx1, w1, lowedge_len_cut, pr);
                    int64_t elen = pr.len + 1;
                    int64_t edep = pr.depth + vd[j];
                    double avg = (double)edep / (double)elen;
                    if (elen <= lowedge_len_cut && avg <= lowedge_depth_cut
                            && !linear[pr.last]) {
                        num++;
                        tot_len += elen;
                        for (int64_t v : pr.vec) deleted[v] = 1;
                        recalculate_kmer_links(pr.last);
                        recalculate_kmer_links(idx);
                        std::string ks1 = bit2seq(kmer[idx1]);
                        std::string out1;
                        if (w1 == 1) out1 = ks1 + pr.chars;
                        else {
                            out1.assign(pr.chars.rbegin(), pr.chars.rend());
                            out1 += ks1;
                        }
                        // divergent leftward spacing (contig.cpp:763)
                        fprintf(f, ">lowedge_%lld    length:%lld"
                                "    avgDepth:%s\tLeftEndKmer: %llu %s"
                                "\tRightEndKmer: %llu branch\n%s\n",
                                (long long)num, (long long)(elen + k),
                                g6(avg).c_str(),
                                (unsigned long long)kmer[pr.last], pr.mark,
                                (unsigned long long)kmer[idx], out1.c_str());
                    }
                }
            }
        }
        fclose(f);
        st_lowedges = num;
        st_lowedgelen = tot_len;
    }

    // -------------------------------------------------------------- bubbles
    // NW, match +3 / mismatch -5 / gap -5, tie subs >= gap_i >= gap_j
    // (global_aligning.cpp:20-35,98-182)
    static void global_aligning(const std::string& si, const std::string& sj,
                                std::string& ai, std::string& aj) {
        const int gap = -5;
        int64_t nn = (int64_t)si.size(), mm = (int64_t)sj.size();
        std::vector<int64_t> score((nn + 1) * (mm + 1));
        std::vector<int8_t> direct((nn + 1) * (mm + 1));
        for (int64_t j = 1; j <= mm; j++) {
            score[j] = gap * j;
            direct[j] = 1;
        }
        for (int64_t i = 1; i <= nn; i++) {
            score[i * (mm + 1)] = gap * i;
            direct[i * (mm + 1)] = 2;
        }
        for (int64_t i = 1; i <= nn; i++) {
            const int64_t* srow = &score[(i - 1) * (mm + 1)];
            int64_t* row = &score[i * (mm + 1)];
            int8_t* drow = &direct[i * (mm + 1)];
            for (int64_t j = 1; j <= mm; j++) {
                int64_t s = srow[j - 1]
                    + (si[i - 1] == sj[j - 1] ? 3 : -5);
                int64_t gi = row[j - 1] + gap;
                int64_t gj = srow[j] + gap;
                if (s >= gi && s >= gj) { row[j] = s; drow[j] = 0; }
                else if (gi > s && gi >= gj) { row[j] = gi; drow[j] = 1; }
                else { row[j] = gj; drow[j] = 2; }
            }
        }
        ai.clear(); aj.clear();
        int64_t pi = nn, pj = mm;
        while (pi > 0 || pj > 0) {
            int d = direct[pi * (mm + 1) + pj];
            if (d == 0) {
                ai.push_back(si[pi - 1]);
                aj.push_back(sj[pj - 1]);
                pi--; pj--;
            } else if (d == 1) {
                ai.push_back('-');
                aj.push_back(sj[pj - 1]);
                pj--;
            } else {
                ai.push_back(si[pi - 1]);
                aj.push_back('-');
                pi--;
            }
        }
        std::string ra(ai.rbegin(), ai.rend());
        std::string rj(aj.rbegin(), aj.rend());
        ai.swap(ra);
        aj.swap(rj);
    }

    static int64_t compare_simple(const std::string& s1,
                                  const std::string& s2) {
        int64_t m = (int64_t)(s1.size() < s2.size() ? s1.size() : s2.size());
        int64_t diff = 0;
        for (int64_t i = 0; i < m; i++)
            if (s1[i] != s2[i] && s1[i] != '-' && s2[i] != '-') diff++;
        return diff;
    }

    static char comp_char(char c) {
        switch (c) {
            case 'A': return 'T';
            case 'C': return 'G';
            case 'G': return 'C';
            case 'T': return 'A';
            default: return 'N';
        }
    }

    void remove_hetero_bubbles(const std::string& path) {
        FILE* f = xopen(path, "w");
        if (!f) return;
        int64_t num = 0, tot_len = 0;
        PathRes p1, p2;
        int vb[4], vd[4], cntb;
        for (int64_t idx : branch_nodes) {
            int walk;
            if (l_num[idx] == 2 && r_num[idx] == 1) {
                walk = -1;
                branch_bases(lcnt + 4 * idx, vb, vd, &cntb);
            } else if (l_num[idx] == 1 && r_num[idx] == 2) {
                walk = 1;
                branch_bases(rcnt + 4 * idx, vb, vd, &cntb);
            } else {
                continue;
            }
            uint64_t km = kmer[idx];
            uint64_t nk1, nk2;
            if (walk == 1) {
                nk1 = ((km << 2) | (uint64_t)vb[0]) & mask;
                nk2 = ((km << 2) | (uint64_t)vb[1]) & mask;
            } else {
                nk1 = (km >> 2) + ((uint64_t)vb[0] << (2 * (k - 1)));
                nk2 = (km >> 2) + ((uint64_t)vb[1] << (2 * (k - 1)));
            }
            uint64_t rc1 = revcomp(nk1), rc2 = revcomp(nk2);
            uint64_t nf1, nf2;
            int w1, w2;
            if (nk1 < rc1) { nf1 = nk1; w1 = walk; }
            else { nf1 = rc1; w1 = -walk; }
            if (nk2 < rc2) { nf2 = nk2; w2 = walk; }
            else { nf2 = rc2; w2 = -walk; }
            int64_t idx1 = exist(nf1);
            int64_t idx2 = exist(nf2);
            if (!linear[idx1] || !linear[idx2]) continue;
            get_linear_path(idx1, w1, bubble_len_cut, p1);
            get_linear_path(idx2, w2, bubble_len_cut, p2);
            double avg1 = (double)p1.depth / (double)p1.len;
            double avg2 = (double)p2.depth / (double)p2.len;
            if (p1.last != p2.last) {
                // non-reconverging deep branch pairs (contig.cpp:470-475)
                continue;
            }
            std::string ks1 = bit2seq(kmer[idx1]);
            std::string bs1;
            if (w1 == 1) bs1 = ks1 + p1.chars;
            else {
                bs1.assign(p1.chars.rbegin(), p1.chars.rend());
                bs1 += ks1;
            }
            std::string ks2 = bit2seq(kmer[idx2]);
            std::string bs2;
            if (w2 == 1) bs2 = ks2 + p2.chars;
            else {
                bs2.assign(p2.chars.rbegin(), p2.chars.rend());
                bs2 += ks2;
            }
            if (w1 != w2) {
                std::string r(bs1.rbegin(), bs1.rend());
                for (auto& c : r) c = comp_char(c);
                bs1.swap(r);
            }
            int64_t len1 = p1.len + 1;
            int64_t len2 = p2.len + 1;
            int64_t dep1 = p1.depth + vd[0];
            int64_t dep2 = p2.depth + vd[1];
            (void)dep1; (void)dep2;
            double diff_rate = 0.0;
            const char* btype = "";
            if (len1 == len2) {
                int64_t diff = compare_simple(bs1, bs2);
                diff_rate = (double)diff / (double)len1;
                btype = "SNP";
            }
            if (len1 != len2 || diff_rate > bubble_base_diff) {
                std::string a1, a2;
                global_aligning(bs1, bs2, a1, a2);
                bs1.swap(a1);
                bs2.swap(a2);
                int64_t diff = compare_simple(bs1, bs2);
                diff_rate = (double)diff / (double)len1;
                btype = "INDEL";
            }
            int64_t ld = len1 - len2;
            if (ld < 0) ld = -ld;
            if (diff_rate < bubble_base_diff
                    && (double)ld < bubble_len_cut * bubble_len_diff
                    && len1 <= bubble_len_cut && len2 <= bubble_len_cut) {
                int removed;
                if (avg1 < avg2) {
                    for (int64_t v : p1.vec) deleted[v] = 1;
                    recalculate_kmer_links(p1.last);
                    recalculate_kmer_links(idx);
                    num++;
                    tot_len += len1;
                    removed = 1;
                } else {
                    for (int64_t v : p2.vec) deleted[v] = 1;
                    recalculate_kmer_links(p2.last);
                    recalculate_kmer_links(idx);
                    num++;
                    tot_len += len2;
                    removed = 2;
                }
                uint64_t lkm, rkm;
                const char *lmark, *rmark;
                if (walk == 1) {
                    lkm = kmer[idx]; lmark = "branch";
                    rkm = kmer[p1.last]; rmark = p1.mark;
                } else {
                    rkm = kmer[idx]; rmark = "branch";
                    lkm = kmer[p1.last]; lmark = p1.mark;
                }
                fprintf(f, ">bubble_%lld\ttype: %s\tlength1: %lld"
                        "\tavgDepth1: %s\tlength2: %lld\tavgDepth2: %s"
                        "\tremoved: %d\tLeftEndKmer: %llu %s"
                        "\tRightEndKmer: %llu %s\n%s\n%s\n",
                        (long long)num, btype, (long long)(len1 + k),
                        g6(avg1).c_str(), (long long)(len2 + k),
                        g6(avg2).c_str(), removed,
                        (unsigned long long)lkm, lmark,
                        (unsigned long long)rkm, rmark,
                        bs1.c_str(), bs2.c_str());
            }
        }
        fclose(f);
        st_bubbles = num;
        st_bubblelen = tot_len;
    }

    // -------------------------------------------------------------- readout
    void read_out_contig(const std::string& prefix,
                         const int64_t* slot_order) {
        struct Rec {
            int64_t len;
            std::string header;   // after ">ctg_<id>"
            std::string depths;
        };
        std::vector<Rec> recs;
        SeqRes r1, r2;
        for (int64_t s = 0; s < n; s++) {
            int64_t i = slot_order[s];
            if (deleted[i] || !linear[i]) continue;
            std::string ks = bit2seq(kmer[i]);
            get_linear_seq(i, 1, r1);
            get_linear_seq(i, -1, r2);
            const char* ctype =
                (strcmp(r2.is_repeat, "Repeat") == 0
                 && strcmp(r1.is_repeat, "Repeat") == 0) ? "RepeatNode" : "";
            deleted[i] = 1;
            std::string contig_str(r2.chars.rbegin(), r2.chars.rend());
            contig_str += ks;
            contig_str += r1.chars;
            int64_t contig_len = r2.len + k + r1.len;
            double contig_depth = (double)(r2.depth + r1.depth)
                / (double)(r2.len + r1.len);
            int dv = (int)((int64_t)contig_depth & 0xFF);
            if (dv == 10 || dv == 62) dv -= 1;
            std::string depth_bytes(r2.depths.rbegin(), r2.depths.rend());
            depth_bytes.append((size_t)k, (char)dv);
            depth_bytes += r1.depths;
            char head[512];
            snprintf(head, sizeof(head),
                     "\tlength: %lld\tavgDepth: %s\tLeftEndKmer: %llu %s-%s"
                     "\tRightEndKmer: %llu %s-%s\t%s\n",
                     (long long)contig_len, lex17(contig_depth).c_str(),
                     (unsigned long long)kmer[r2.last], r2.mark, r2.is_repeat,
                     (unsigned long long)kmer[r1.last], r1.mark, r1.is_repeat,
                     ctype);
            Rec rec;
            rec.len = (int64_t)contig_str.size();
            rec.header = std::string(head) + contig_str + "\n";
            rec.depths = depth_bytes;
            recs.push_back(std::move(rec));
        }

        std::vector<uint64_t> lens(recs.size());
        for (size_t i = 0; i < recs.size(); i++)
            lens[i] = (uint64_t)recs[i].len;
        std::vector<int64_t> perm(recs.size());
        if (!recs.empty())
            gcc44_sort_perm_desc(lens.data(), (int64_t)recs.size(),
                                 perm.data());

        FILE* cf = xopen(prefix + ".contig.seq.fa", "w");
        FILE* cd = xopen(prefix + ".contig.seq.depth", "wb");
        FILE* sf = xopen(prefix + ".contig.small.fa", "w");
        FILE* sd = xopen(prefix + ".contig.small.depth", "wb");
        if (!cf || !cd || !sf || !sd) {
            if (cf) fclose(cf); if (cd) fclose(cd);
            if (sf) fclose(sf); if (sd) fclose(sd);
            return;
        }
        st_ctg_num = st_ctg_len = st_small_num = st_small_len = 0;
        int64_t contig_id = 1;
        for (size_t pi = 0; pi < perm.size(); pi++) {
            const Rec& r = recs[perm[pi]];
            char name[32];
            int nl = snprintf(name, sizeof(name), ">ctg_%lld",
                              (long long)contig_id);
            if (r.len >= contig_len_cutoff) {
                fwrite(name, 1, nl, cf);
                fwrite(r.header.data(), 1, r.header.size(), cf);
                fwrite(name, 1, nl, cd);
                fputc('\n', cd);
                fwrite(r.depths.data(), 1, r.depths.size(), cd);
                fputc('\n', cd);
                st_ctg_num++;
                st_ctg_len += r.len;
            } else {
                fwrite(name, 1, nl, sf);
                fwrite(r.header.data(), 1, r.header.size(), sf);
                fwrite(name, 1, nl, sd);
                fputc('\n', sd);
                fwrite(r.depths.data(), 1, r.depths.size(), sd);
                fputc('\n', sd);
                st_small_num++;
                st_small_len += r.len;
            }
            contig_id += 2;
        }
        fclose(cf); fclose(cd); fclose(sf); fclose(sd);
    }
};

}  // namespace asmN

extern "C" int assemble_run(
        const uint64_t* kmer, int32_t* lcnt, int32_t* rcnt,
        int64_t n_nodes,
        const int64_t* slot_of, uint64_t hash_size,
        const int64_t* slot_order,
        int k, int freq_cutoff,
        int is_tip, int tip_len_cut, double tip_depth_cut,
        int is_lowedge, int lowedge_len_cut, double lowedge_depth_cut,
        int is_bubble, int bubble_len_cut, double bubble_len_diff,
        double bubble_base_diff,
        int contig_len_cutoff, const char* prefix,
        int64_t* out_stats /* [15] */) {
    asmN::Engine e;
    e.kmer = kmer;
    e.lcnt = lcnt;
    e.rcnt = rcnt;
    e.n = n_nodes;
    e.k = k;
    e.mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    e.cut = freq_cutoff;
    e.slot_of = slot_of;
    e.size = hash_size;
    e.is_tip = is_tip;
    e.tip_len_cut = tip_len_cut;
    e.tip_depth_cut = tip_depth_cut;
    e.is_lowedge = is_lowedge;
    e.lowedge_len_cut = lowedge_len_cut;
    e.lowedge_depth_cut = lowedge_depth_cut;
    e.is_bubble = is_bubble;
    e.bubble_len_cut = bubble_len_cut;
    e.bubble_len_diff = bubble_len_diff;
    e.bubble_base_diff = bubble_base_diff;
    e.contig_len_cutoff = contig_len_cutoff;
    e.st_tips = e.st_tiplen = e.st_lowedges = e.st_lowedgelen = 0;
    e.st_bubbles = e.st_bubblelen = 0;

    std::string pfx(prefix);
    e.build_slot_table();
    e.calculate_kmer_links();
    e.collect_candidates(slot_order);
    e.write_kmer_freq(pfx + ".contig.kmer.freq");
    if (is_tip) e.remove_error_tips(pfx + ".contig.tip.fa");
    if (is_lowedge) e.remove_lowCov_edges(pfx + ".contig.lowedge.fa");
    if (is_bubble) e.remove_hetero_bubbles(pfx + ".contig.bubble.fa");
    e.read_out_contig(pfx, slot_order);

    out_stats[0] = e.st_total;
    out_stats[1] = e.st_del_lowfreq;
    out_stats[2] = e.st_linear;
    out_stats[3] = e.st_tipcand;
    out_stats[4] = e.st_branchcand;
    out_stats[5] = e.st_tips;
    out_stats[6] = e.st_tiplen;
    out_stats[7] = e.st_lowedges;
    out_stats[8] = e.st_lowedgelen;
    out_stats[9] = e.st_bubbles;
    out_stats[10] = e.st_bubblelen;
    out_stats[11] = e.st_ctg_num;
    out_stats[12] = e.st_ctg_len;
    out_stats[13] = e.st_small_num;
    out_stats[14] = e.st_small_len;
    if (!e.io_error.empty()) {
        fprintf(stderr, "assemble_engine: cannot open %s\n",
                e.io_error.c_str());
        return 1;
    }
    return 0;
}
