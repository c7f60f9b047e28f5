"""Row provenance and the suspicion scorer: the port's
crypto/provenance.py held against the JAX package's on the same sequences
of (sources, mask) records. After every record both scorers must give the
same stats(), quarantined_sources() and punish-callback firings. Covered:
the quarantine threshold, decay by clean rows, parole, LRU eviction that
spares quarantined sources, lane tags never quarantined, the punish
callback (and one that raises), and fill_sources. Tolerance: zero (equal
states after every step).
"""

import numpy as np
import pytest

from tendermint_tpu.crypto import provenance as ref_prov
from tendermint_tpu_torch.crypto import provenance as port_prov


def _pair(**kw):
    """(reference scorer, port scorer, the callback firings of each)."""
    out = []
    for mod in (ref_prov, port_prov):
        scorer = mod.SuspicionScorer(**kw)
        fired = []
        scorer.add_punish_callback(lambda src, info, fired=fired: fired.append((src, info)))
        out += [scorer, fired]
    return out


def _feed(records, **kw):
    """Both scorers through `records`; the states must agree after each."""
    ref, ref_fired, port, port_fired = _pair(**kw)
    for sources, mask in records:
        ref.record_rows(sources, np.asarray(mask, dtype=bool))
        port.record_rows(sources, np.asarray(mask, dtype=bool))
        assert port.stats() == ref.stats()
        assert port.quarantined_sources() == ref.quarantined_sources()
        assert port_fired == ref_fired
        for s in set(sources):
            assert port.is_quarantined(s) == ref.is_quarantined(s)
        assert port.any_quarantined(sources) == ref.any_quarantined(sources)
    return ref, port, ref_fired


def test_threshold_quarantines_after_three_failures():
    recs = [(["peer:a", "peer:b"], [False, True])] * 2 + [(["peer:a"], [False])]
    ref, port, _ = _feed(recs)
    assert port.quarantined_sources() == frozenset({"peer:a"})


def test_clean_rows_decay_failures_below_the_threshold():
    recs = [(["peer:a"] * 2, [False, False]), (["peer:a"] * 5, [True] * 5),
            (["peer:a"], [False])]
    _, port, _ = _feed(recs)
    assert not port.quarantined_sources()


def test_parole_after_a_clean_streak():
    recs = [(["sender:x"] * 3, [False] * 3)] + [(["sender:x"] * 16, [True] * 16)] * 4
    ref, port, _ = _feed(recs)
    assert port.stats()["paroles"] == 1 and not port.quarantined_sources()


def test_repeat_offender_fires_punish_callbacks_once():
    recs = [(["peer:p"] * 3, [False] * 3)] + [(["peer:p"] * 3, [False] * 3)] * 4
    _, _, fired = _feed(recs)
    assert [src for src, _ in fired] == ["peer:p"]


def test_lane_tags_are_never_quarantined():
    recs = [(["lane:votes"] * 10, [False] * 10), (["lane:catchup", "peer:q"], [False, False])]
    _, port, _ = _feed(recs)
    assert not port.quarantined_sources()
    assert {w["source"] for w in port.stats()["worst"]} == {"lane:votes", "lane:catchup",
                                                           "peer:q"}


def test_lru_eviction_spares_quarantined_sources():
    recs = [(["peer:bad"] * 3, [False] * 3)]
    recs += [([f"peer:n{i}"], [True]) for i in range(12)]
    _, port, _ = _feed(recs, max_sources=4)
    assert port.quarantined_sources() == frozenset({"peer:bad"})
    assert port.stats()["sources"] == 4


def test_eviction_of_an_all_quarantined_table_rebuilds_the_snapshot():
    recs = [([f"peer:b{i}"] * 3, [False] * 3) for i in range(4)]
    _, port, _ = _feed(recs, max_sources=2)
    assert len(port.quarantined_sources()) == 2


def test_a_raising_callback_never_breaks_scoring():
    scorers = []
    for mod in (ref_prov, port_prov):
        s = mod.SuspicionScorer(punish_fails=1)
        s.add_punish_callback(lambda src, info: 1 / 0)
        for _ in range(3):
            s.record_rows(["peer:z"] * 3, np.zeros(3, dtype=bool))
        scorers.append(s)
    assert scorers[1].stats() == scorers[0].stats()
    assert scorers[1].stats()["punished"] == 1


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_random_record_sequences(seed):
    """A seeded stream of mixed batches over peer, sender and lane tags,
    with small thresholds and table so every transition occurs."""
    rng = np.random.default_rng(seed)
    names = [f"peer:{i}" for i in range(6)] + ["sender:s0", "sender:s1", "lane:light"]
    recs = []
    for _ in range(300):
        n = int(rng.integers(1, 12))
        srcs = [names[int(i)] for i in rng.integers(0, len(names), size=n)]
        bad_rate = 0.6 if rng.random() < 0.3 else 0.05
        recs.append((srcs, rng.random(n) >= bad_rate))
    ref, port, _ = _feed(recs, fail_quarantine=2, parole_clean=6, punish_fails=3,
                         max_sources=5)
    port.reset()
    ref.reset()
    assert port.stats() == ref.stats()


@pytest.mark.parametrize("sources,n", [(None, 3), (["peer:a", "", "sender:b"], 3),
                                       (["peer:a"], 3), (["peer:a", "peer:b", "x"], 2)])
def test_fill_sources(sources, n):
    assert port_prov.fill_sources(sources, n, "votes") == ref_prov.fill_sources(
        sources, n, "votes")


def test_default_scorer_swap():
    mine = port_prov.SuspicionScorer()
    prev = port_prov.set_default(mine)
    try:
        assert port_prov.default_scorer() is mine
    finally:
        assert port_prov.set_default(prev) is mine
    cb = [].append
    mine.add_punish_callback(cb)
    mine.remove_punish_callback(cb)
    mine.remove_punish_callback(cb)  # absent: no error, as the reference's
    assert mine._callbacks == []
