"""The generator's modBAM decodes back to its truth through the
benchmark's own reader."""

import json
import os

import numpy as np
import pytest

from benchmark import bamio, gen
from conftest import ROOT


def _config(name: str, length: int) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["data"]["contig_length"] = length
    return cfg


@pytest.mark.parametrize("name", ["allc-5mC5hmC-30x", "cpg-5mCG5hmCG-30x"])
def test_modbam_decodes_to_truth(tmp_path, name):
    cfg = _config(name, 60000)
    seed = 2**31 + 11
    meta = gen.generate(cfg, seed, str(tmp_path), workers=2)
    recs = bamio.read_bam(str(tmp_path / "reads.bam"))
    layout = gen.make_layout(cfg["data"], seed)
    assert len(recs) == meta["reads"] == len(layout.starts)
    i = 0
    for b in range(gen.batch_count(cfg)):
        batch = gen.batch_of(layout, cfg["data"], cfg["model"], seed, b)
        for k in range(len(batch.starts)):
            rec = recs[i]
            i += 1
            a, e = batch.q_off[k], batch.q_off[k] + batch.q_len[k]
            assert rec["pos"] == batch.starts[k]
            assert rec["flag"] == (16 if batch.reverse[k] else 0)
            np.testing.assert_array_equal(rec["seq"], batch.seq[a:e])
            np.testing.assert_array_equal(rec["qual"], batch.qual[a:e])
            # the CIGAR's reference span and query length
            ref_len = sum(n for op, n in rec["cigar"] if op in (0, 2))
            q_len = sum(n for op, n in rec["cigar"] if op in (0, 1))
            assert ref_len == batch.spans[k] and q_len == batch.q_len[k]
            assert rec["cigar"][0][0] == 0 and rec["cigar"][-1][0] == 0
            # the calls: MM skips over the read's C's, ML in its orientation
            sel = batch.call_read == k
            calls = batch.call_q[sel] - a
            qh, qm = batch.qh[sel], batch.qm[sel]
            seq = rec["seq"] if not batch.reverse[k] else (3 - rec["seq"])[::-1]
            if batch.reverse[k]:
                calls = (batch.q_len[k] - 1 - calls)[::-1]
                qh, qm = qh[::-1], qm[::-1]
            c_pos = np.flatnonzero(seq == gen.C)
            groups = [g for g in rec["mm"].split(";") if g]
            assert [g.split(",")[0] for g in groups] == ["C+h?", "C+m?"]
            for g in groups:
                skips = np.array([int(x) for x in g.split(",")[1:]], dtype=np.int64)
                np.testing.assert_array_equal(c_pos[np.cumsum(skips + 1) - 1], calls)
            np.testing.assert_array_equal(rec["ml"], np.concatenate([qh, qm]))
    assert i == len(recs)


def test_cpg_calls_are_the_read_cpgs(tmp_path):
    cfg = _config("cpg-5mCG5hmCG-30x", 60000)
    layout = gen.make_layout(cfg["data"], 5)
    batch = gen.batch_of(layout, cfg["data"], "cpg", 5, 0)
    nxt = np.append(batch.seq[1:], 255)
    prv = np.insert(batch.seq[:-1], 0, 255)
    rev = batch.reverse[batch.call_read]
    q = batch.call_q
    assert np.all(np.where(rev, (batch.seq[q] == gen.G) & (prv[q] == gen.C),
                           (batch.seq[q] == gen.C) & (nxt[q] == gen.G)))


def test_same_sizes_for_every_seed():
    cfg = _config("allc-5mC5hmC-30x", 8_000_000)
    a = gen.read_spans(cfg["data"])
    assert 15000 < len(a) < 16000
    # the N50 of the fixed lengths is the configured one
    s = np.sort(a)[::-1]
    n50 = s[np.searchsorted(np.cumsum(s), s.sum() / 2)]
    assert abs(n50 - cfg["data"]["read_n50"]) < 0.05 * cfg["data"]["read_n50"]
    l1 = gen.make_layout({**cfg["data"], "contig_length": 200000}, 1)
    l2 = gen.make_layout({**cfg["data"], "contig_length": 200000}, 2)
    np.testing.assert_array_equal(np.sort(l1.spans), np.sort(l2.spans))


def test_allc_calls_follow_the_emission_threshold():
    """The all-context model writes a C only where the modified classes'
    ML values reach dorado's --modified-bases-threshold; the other C's are
    skipped, so the MM skips are not all 0."""
    cfg = _config("allc-5mC5hmC-30x", 60000)
    data = cfg["data"]
    layout = gen.make_layout(data, 9)
    batch = gen.batch_of(layout, data, "allc", 9, 0)
    least = int(np.floor(data["modified_bases_threshold"] * 256))
    assert least == 12
    assert np.all(batch.qh.astype(int) + batch.qm >= least)
    rev_q = np.repeat(batch.reverse, batch.q_len)
    is_c = np.where(rev_q, batch.seq == gen.G, batch.seq == gen.C)
    # every call is at a read C, and a large share of the C's is skipped
    assert np.all(is_c[batch.call_q])
    share = len(batch.call_q) / int(is_c.sum())
    assert 0.3 < share < 0.9
    no_threshold = gen.batch_of(layout, {**data, "modified_bases_threshold": 0.0}, "allc", 9, 0)
    assert len(no_threshold.call_q) == int(is_c.sum())
