"""The generator's modBAM decodes back to its truth through the
benchmark's own reader."""

import json
import os

import numpy as np
import pytest

from benchmark import bamio, gen
from conftest import A_GROUP, C_GROUP, ROOT, with_groups


def _config(name: str, length: int) -> dict:
    if name == "two-base":  # dorado's 5mC_5hmC and 6mA models on one read
        return with_groups("allc-5mC5hmC-30x.pileup", [C_GROUP, A_GROUP],
                           {"contig_length": length})[1]
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["data"]["contig_length"] = length
    return cfg


@pytest.mark.parametrize("name", ["allc-5mC5hmC-30x", "cpg-5mCG5hmCG-30x", "two-base"])
def test_modbam_decodes_to_truth(tmp_path, name):
    cfg = _config(name, 60000)
    seed = 2**31 + 11
    meta = gen.generate(cfg, seed, str(tmp_path), workers=2)
    recs = bamio.read_bam(str(tmp_path / "reads.bam"))
    layout = gen.make_layout(cfg, seed)
    assert len(recs) == meta["reads"] == len(layout.starts)
    groups = gen.call_groups(cfg)
    # dorado's tag: one group for each (base, code) in model order
    tags = [f"{g['base']}+{c}?" for g in groups for c in g["codes"]]
    calls = dict.fromkeys(meta["calls_per_base"], 0)
    i = 0
    for b in range(gen.batch_count(cfg)):
        batch = gen.batch_of(layout, cfg, seed, b)
        assert [c.base for c in batch.calls] == [g["base"] for g in groups]
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
            # the calls: MM skips over the read's own bases of the group
            # (a reverse read's A is a T of the reference), ML in its
            # orientation
            seq = rec["seq"] if not batch.reverse[k] else (3 - rec["seq"])[::-1]
            mm = [g for g in rec["mm"].split(";") if g]
            assert [g.split(",")[0] for g in mm] == tags
            ml = []
            for c in batch.calls:
                sel = c.read == k
                q, values = c.q[sel] - a, c.ml[:, sel]
                calls[c.base] += len(q)
                if batch.reverse[k]:
                    q, values = (batch.q_len[k] - 1 - q)[::-1], values[:, ::-1]
                own = np.flatnonzero(seq == gen.BASES[c.base])
                for code, v in zip(c.codes, values):
                    g = mm.pop(0)
                    assert g.split(",")[0] == f"{c.base}+{code}?"
                    skips = np.array([int(x) for x in g.split(",")[1:]], dtype=np.int64)
                    np.testing.assert_array_equal(own[np.cumsum(skips + 1) - 1], q)
                    ml.append(v)
            np.testing.assert_array_equal(rec["ml"], np.concatenate(ml))
    assert i == len(recs)
    assert calls == meta["calls_per_base"] and sum(calls.values()) == meta["calls"]
    assert set(meta["thresholds"]) == {g["base"] for g in groups}


def test_cpg_calls_are_the_read_cpgs(tmp_path):
    cfg = _config("cpg-5mCG5hmCG-30x", 60000)
    layout = gen.make_layout(cfg, 5)
    batch = gen.batch_of(layout, cfg, 5, 0)
    (c,) = batch.calls
    nxt = np.append(batch.seq[1:], 255)
    prv = np.insert(batch.seq[:-1], 0, 255)
    rev = batch.reverse[c.read]
    q = c.q
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
    small = {**cfg, "data": {**cfg["data"], "contig_length": 200000}}
    l1 = gen.make_layout(small, 1)
    l2 = gen.make_layout(small, 2)
    np.testing.assert_array_equal(np.sort(l1.spans), np.sort(l2.spans))


@pytest.mark.parametrize("base", ["C", "A"])
def test_allc_calls_follow_the_emission_threshold(base):
    """An all-context model writes a base only where the modified classes'
    ML values reach dorado's --modified-bases-threshold; the other bases
    are skipped, so the MM skips are not all 0. An A group's calls are on
    the read's own A's, and leave the C group's calls as they are."""
    cfg = _config("two-base", 60000)
    layout = gen.make_layout(cfg, 9)
    batch = gen.batch_of(layout, cfg, 9, 0)
    (g,) = [g for g in cfg["call_groups"] if g["base"] == base]
    (c,) = [c for c in batch.calls if c.base == base]
    least = int(np.floor(g["modified_bases_threshold"] * 256))
    assert least == 12
    assert np.all(c.ml.astype(int).sum(axis=0) >= least)
    rev_q = np.repeat(batch.reverse, batch.q_len)
    own = gen.BASES[base]
    is_b = np.where(rev_q, batch.seq == gen.COMPLEMENT[own], batch.seq == own)
    # every call is at a read base of the group, and a large share of
    # those bases is skipped
    assert np.all(is_b[c.q])
    share = len(c.q) / int(is_b.sum())
    assert 0.3 < share < 0.9
    groups = [{**x, "modified_bases_threshold": 0.0} if x is g else x
              for x in cfg["call_groups"]]
    every = gen.batch_of(layout, {**cfg, "call_groups": groups}, 9, 0)
    assert len([x for x in every.calls if x.base == base][0].q) == int(is_b.sum())
    # the C calls do not depend on whether an A group is there
    alone = {**cfg, "call_groups": [C_GROUP]}
    (c_alone,) = gen.batch_of(gen.make_layout(alone, 9), alone, 9, 0).calls
    c_two = batch.calls[0]
    for f in ("q", "read", "pos", "ml"):
        np.testing.assert_array_equal(getattr(c_alone, f), getattr(c_two, f))


def test_call_groups_out_of_range_are_refused():
    cfg = _config("two-base", 60000)
    for bad in ({**A_GROUP, "context": "cpg"},
                {**A_GROUP, "base": "G"}, {**A_GROUP, "codes": ["a", "b", "c"]},
                {**A_GROUP, "code_shares": [0.5]}, {**A_GROUP, "extra": 1}, C_GROUP):
        with pytest.raises(ValueError):
            gen.call_groups({**cfg, "call_groups": [C_GROUP, bad]})
    with pytest.raises(ValueError):
        gen.call_groups({**cfg, "model": "allc"})
    with pytest.raises(ValueError):
        gen.model_groups("6mA", cfg["data"])
