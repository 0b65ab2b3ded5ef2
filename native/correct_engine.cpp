// Native correction engine — production-rate implementation of the 5-phase
// k-mer-spectrum corrector (see dbg_assembly/correct/engine.py, which is
// the readable parity spec; both implement the behavior of
// correct_error/correct.cpp:146-635 and are cross-checked in
// tests/test_native_correct.py).
//
// API (ctypes): correct_batch() processes a batch of reads in place against
// the 1-bit high-frequency bitmap and reports per-read scores/trims.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const char BASES[5] = {'A', 'C', 'G', 'T', 'N'};

inline int code_of(uint8_t c) {
    switch (c) {
        case 'A': case 'a': case 'N': case 'n': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return 0;  // k-mer alphabet: everything else -> 0
    }
}

struct Params {
    int ksize;
    int high_freq_reg_len;
    int max_change;
    int further_trim;
    int64_t max_bbt_nodes;
    int min_read_len;
};

struct Ctx {
    const uint8_t* bitmap;
    Params p;
    uint64_t mask;
};

inline int freq(const Ctx& ctx, uint64_t kbit) {
    return (ctx.bitmap[kbit >> 3] >> (7 - (kbit & 7))) & 1;
}

inline uint64_t seq2bit(const uint8_t* read, int start, int len) {
    uint64_t v = 0;
    for (int i = 0; i < len; i++) v = (v << 2) | code_of(read[start + i]);
    return v;
}

struct Node {
    uint32_t parent;
    uint8_t base;
    uint8_t change;
    uint8_t same;
    uint64_t kmer;
};

// correct_multi_bases_rightward/leftward (correct.cpp:380-635) with cached
// sliding k-mers (value-identical to the parent-walk reconstruction).
// Returns num_corrected; outputs len_need_trim and last_change_pos.
int bbt(const Ctx& ctx, uint8_t* read, int read_len, int check_start,
        int check_end, bool rightward, int is_modify, int max_allowed,
        int* len_need_trim, int* last_change_pos, int last_change_init) {
    const int k = ctx.p.ksize;
    if (max_allowed > 2) max_allowed = 2;
    uint64_t spb;
    uint64_t root_kmer;
    if (rightward) {
        spb = seq2bit(read, check_start - k, k - 1);
        root_kmer = spb;
    } else {
        spb = seq2bit(read, check_start, k - 1);
        root_kmer = spb << 2;
    }
    std::vector<Node> nodes;
    nodes.push_back({0, 0, 0, 0, root_kmer});
    std::vector<uint32_t> cur{0};
    std::vector<uint32_t> tmp;
    int64_t node_pos = 0;
    int cycle = check_start;
    while (rightward ? (cycle <= check_end) : (cycle >= check_end)) {
        tmp.clear();
        uint8_t read_c = read[cycle - 1];
        for (uint32_t parent : cur) {
            uint8_t pchange = nodes[parent].change;
            uint64_t pk = nodes[parent].kmer;
            for (uint8_t j = 0; j < 4; j++) {
                uint64_t kbit;
                if (rightward) kbit = ((pk << 2) | j) & ctx.mask;
                else kbit = (pk >> 2) | ((uint64_t)j << (2 * (k - 1)));
                uint8_t same = (BASES[j] == (char)read_c) ? 1 : 0;
                uint8_t change = same ? pchange : pchange + 1;
                if (change <= max_allowed && freq(ctx, kbit)) {
                    nodes.push_back({parent, j, change, same, kbit});
                    node_pos++;
                    tmp.push_back((uint32_t)node_pos);
                }
            }
        }
        if (tmp.size() >= 1 && node_pos < ctx.p.max_bbt_nodes) {
            cur.swap(tmp);
        } else {
            break;
        }
        cycle += rightward ? 1 : -1;
    }
    int min_change = nodes[cur[0]].change;
    uint32_t min_pos = cur[0];
    int min_path = 0;
    for (uint32_t cp : cur) {
        int c = nodes[cp].change;
        if (c < min_change) {
            min_change = c;
            min_pos = cp;
            min_path = 1;
        } else if (c == min_change) {
            min_path++;
        }
    }
    int trim = rightward ? (check_end - cycle + 1) : (cycle - check_end + 1);
    *len_need_trim = trim;
    int num = 0;
    int last_change = last_change_init;
    if (min_path == 1 && (trim == 0 || (trim > 0 && is_modify))) {
        num = min_change;
        uint32_t pos = min_pos;
        int rp = rightward ? (cycle - 1) : (cycle + 1);
        while (pos > 0) {
            const Node& nd = nodes[pos];
            if (!nd.same) {
                read[rp - 1] = (uint8_t)BASES[nd.base];
                if (rightward) {
                    if (last_change == read_len + 1) last_change = rp;
                } else {
                    if (last_change == 0) last_change = rp;
                }
            }
            pos = nd.parent;
            rp += rightward ? -1 : 1;
        }
    }
    *last_change_pos = last_change;
    return num;
}

// correct_one_base (correct.cpp:74-107)
int correct_one_base(const Ctx& ctx, uint8_t* read, int error_pos,
                     int check_start, int check_end) {
    const int k = ctx.p.ksize;
    uint8_t error_base = read[error_pos - 1];
    int check_num = check_end - check_start + 1;
    for (int i = 0; i < 4; i++) {
        if (error_base != (uint8_t)BASES[i]) {
            read[error_pos - 1] = (uint8_t)BASES[i];
            int high = 0;
            for (int j = check_start - 1; j < check_end; j++) {
                if (freq(ctx, seq2bit(read, j, k))) high++;
                else break;
            }
            if (high == check_num) return 1;
        }
    }
    read[error_pos - 1] = error_base;
    return 0;
}

struct Region {
    int start, end, status;
};

}  // namespace

extern "C" {

// Correct one batch of reads in place.
//   reads: concatenated read bytes; offsets[i]..offsets[i]+lens[i] = read i
//   bits:  phase-1 high/low flags, P_max per read (row-major), from the
//          batch classifier (original read content)
// Outputs per read: one_score, multi_score, deleted, trim_left, trim_right.
void correct_batch(uint8_t* reads, const int64_t* offsets,
                   const int32_t* lens, int64_t n_reads,
                   const uint8_t* bits, int64_t bits_stride,
                   const uint8_t* bitmap,
                   int ksize, int high_freq_reg_len, int max_change,
                   int further_trim, int64_t max_bbt_nodes,
                   int min_read_len,
                   int32_t* one_score, int32_t* multi_score,
                   int32_t* deleted, int32_t* trim_left,
                   int32_t* trim_right) {
    Ctx ctx;
    ctx.bitmap = bitmap;
    ctx.p = {ksize, high_freq_reg_len, max_change, further_trim,
             max_bbt_nodes, min_read_len};
    ctx.mask = (ksize >= 32) ? ~0ULL : ((1ULL << (2 * ksize)) - 1);
    const int k = ksize;

    std::vector<Region> regs, highs;
    std::vector<int> fail_ids;

    for (int64_t r = 0; r < n_reads; r++) {
        uint8_t* read = reads + offsets[r];
        int read_len = lens[r];
        one_score[r] = 0;
        multi_score[r] = 0;
        trim_left[r] = 0;
        trim_right[r] = 0;
        if (read_len < k) {
            deleted[r] = 1;
            continue;
        }
        const uint8_t* b = bits + r * bits_stride;
        int total_kmers = read_len - k + 1;

        // phase 1: regions from precomputed bits
        regs.clear();
        int i = 0;
        while (i < total_kmers) {
            int s = i;
            while (i < total_kmers && b[i] == 0) i++;
            if (i > s) regs.push_back({s + 1, i, 0});
            s = i;
            while (i < total_kmers && b[i] == 1) i++;
            if (i > s) regs.push_back({s + 1, i, 1});
        }
        int num_c = (int)regs.size();
        int accum = 0;

        // phase 2: fast single-base correction
        for (int ri = 1; ri < num_c - 1; ri++) {
            if (regs[ri].status != 0) continue;
            if (accum >= max_change) break;
            int size = regs[ri].end - regs[ri].start + 1;
            int corrected = 0;
            if (size == k) {
                corrected = correct_one_base(ctx, read, regs[ri].end,
                                             regs[ri].start, regs[ri].end);
            }
            if (corrected) {
                one_score[r]++;
                regs[ri].status = 1;
                accum++;
            }
        }

        // phase 3: merge + filter + shave
        highs.clear();
        i = 0;
        while (i < num_c) {
            while (i < num_c && regs[i].status == 0) i++;
            int s = i;
            while (i < num_c && regs[i].status == 1) i++;
            if (i > s && regs[i - 1].end - regs[s].start + 1 >=
                    high_freq_reg_len) {
                highs.push_back({regs[s].start, regs[i - 1].end, 1});
            }
        }
        int num_h = (int)highs.size();
        int edge_cut = high_freq_reg_len / 3;
        for (auto& h : highs) {
            if (h.start != 1) h.start += edge_cut;
            if (h.end != total_kmers) h.end -= edge_cut;
        }
        if (num_h == 0) {
            deleted[r] = 1;
            continue;
        }

        // phase 4: BBT between consecutive high regions
        fail_ids.clear();
        int t_dummy, lc_dummy;
        if (num_h >= 2) {
            for (int hi = 0; hi < num_h - 1; hi++) {
                if (accum >= max_change) {
                    for (int kk = hi; kk < num_h - 1; kk++)
                        fail_ids.push_back(kk);
                    break;
                }
                int high_end = highs[hi].end + k - 1;
                int low_end = highs[hi + 1].start - 1 + k - 1;
                int tr;
                int num = bbt(ctx, read, read_len, high_end + 1, low_end,
                              true, 0, max_change - accum, &tr, &lc_dummy,
                              -1);
                if (tr == 0 && num > 0) {
                    multi_score[r] += num;
                    accum += num;
                }
                if (tr > 0 || num == 0) {
                    int high_start = highs[hi + 1].start;
                    int low_start = highs[hi].end + 1;
                    int tl;
                    int num2 = bbt(ctx, read, read_len, high_start - 1,
                                   low_start, false, 0, max_change - accum,
                                   &tl, &lc_dummy, -1);
                    if (tl == 0 && num2 > 0) {
                        multi_score[r] += num2;
                        accum += num2;
                    } else {
                        fail_ids.push_back(hi);
                    }
                }
            }
        }

        // get_max_highFreq_region
        fail_ids.push_back(num_h - 1);
        int cur_start = highs[0].start;
        int max_len = 0, max_start = 0, max_end = 0;
        for (size_t fi = 0; fi < fail_ids.size(); fi++) {
            int stop_id = fail_ids[fi];
            int cur_end = highs[stop_id].end;
            int this_len = cur_end - cur_start + 1;
            if (this_len > max_len) {
                max_len = this_len;
                max_start = cur_start;
                max_end = cur_end;
            }
            if (stop_id != num_h - 1) cur_start = highs[stop_id + 1].start;
        }

        int left_last = 0;
        int right_last = read_len + 1;
        int tl = 0, tr = 0;

        // phase 5 head
        if (max_start > 1) {
            if (accum < max_change) {
                int num = bbt(ctx, read, read_len, max_start - 1, 1, false,
                              1, max_change - accum, &tl, &left_last, 0);
                if (num > 0) {
                    multi_score[r] += num;
                    accum += num;
                } else {
                    tl = max_start - 1;
                    left_last = 0;
                }
            } else {
                tl = max_start - 1;
                left_last = 0;
            }
        }
        // phase 5 tail
        int high_end = max_end + k - 1;
        if (high_end < read_len) {
            if (accum < max_change) {
                int num = bbt(ctx, read, read_len, high_end + 1, read_len,
                              true, 1, max_change - accum, &tr, &right_last,
                              read_len + 1);
                if (num > 0) {
                    multi_score[r] += num;
                    accum += num;
                } else {
                    tr = read_len - high_end;
                    right_last = read_len + 1;
                }
            } else {
                tr = read_len - high_end;
                right_last = read_len + 1;
            }
        }

        // further trimming
        if (tl > 0 || (left_last > 0 && left_last <= further_trim)) {
            tl += further_trim;
            if (tl > read_len) tl = read_len;
        }
        if (tr > 0 || (right_last < read_len + 1 &&
                       right_last >= read_len - further_trim + 1)) {
            tr += further_trim;
            if (tr > read_len) tr = read_len;
        }
        trim_left[r] = tl;
        trim_right[r] = tr;
        deleted[r] = (read_len - tl - tr < min_read_len) ? 1 : 0;
    }
}

}  // extern "C"
