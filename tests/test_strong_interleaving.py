"""Unit tests for LinkGraph.strong_remove_interleaving — the 2-rank BFS
interleaving remover (parity: link_scaffold/link_func.cpp:587-666).

Hand-built graphs mirroring the reference's rank semantics: a direct
successor reachable again within <=2 BFS ranks from any direct successor
loses its direct link from the start node; deeper paths survive.
"""
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dbg_assembly.scaffold.link import LinkGraph


def build(n, edges, freq=5):
    g = LinkGraph.create(n)
    for s, d in edges:
        for _ in range(freq):
            g.add(s, d, 10)
    g.remove_lowfreq_and_stat(pair_num_cut=3)
    return g


def test_rank1_shortcut_removed():
    # 1 -> {3, 5}, 3 -> 5: the shortcut 1->5 is an interleaving link
    g = build(8, [(1, 3), (1, 5), (3, 5)])
    g.strong_remove_interleaving()
    ids, _ = g.linked_ids(1)
    assert ids == [3]
    assert g.counters["interleave"] == 1
    # 3 -> 5 survives
    assert g.linked_ids(3)[0] == [5]


def test_rank2_shortcut_removed():
    # 1 -> {3, 5}, 3 -> 7 -> 5: 5 is reachable at rank 2 -> removed
    g = build(10, [(1, 3), (1, 5), (3, 7), (7, 5)])
    g.strong_remove_interleaving()
    assert g.linked_ids(1)[0] == [3]
    assert g.counters["interleave"] == 1


def test_rank3_survives():
    # 1 -> {3, 5}, 3 -> 7 -> 9 -> 5: rank 3 is beyond Rank_Num=2 -> kept
    g = build(12, [(1, 3), (1, 5), (3, 7), (7, 9), (9, 5)])
    g.strong_remove_interleaving()
    assert sorted(g.linked_ids(1)[0]) == [3, 5]
    assert g.counters["interleave"] == 0


def test_only_2_or_3_outlinks_considered():
    # start node with 4 out-links is skipped entirely
    g = build(14, [(1, 3), (1, 5), (1, 7), (1, 9), (3, 5)])
    assert g.link[1] == 4
    g.strong_remove_interleaving()
    assert sorted(g.linked_ids(1)[0]) == [3, 5, 7, 9]
    assert g.counters["interleave"] == 0


def test_deletion_order_is_ascending_target_id():
    # both successors each reachable from the other -> both deleted,
    # in ascending order (std::map iteration); with 2 out-links both go
    g = build(10, [(1, 3), (1, 5), (3, 5), (5, 3)])
    order = []
    orig = g.delete_link

    def spy(src, dst):
        order.append((src, dst))
        orig(src, dst)

    g.delete_link = spy
    g.strong_remove_interleaving()
    assert order == [(1, 3), (1, 5)]
    assert g.linked_ids(1)[0] == []
