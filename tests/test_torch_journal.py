"""The port's request journal (``paddle_tpu_torch.inference.serving.journal``)
against the JAX package's.

* The journal-file contract, each case run on both packages' classes:
  round trip, torn tail truncated in place, resume/rebase idempotence,
  snapshot fallback newest -> older -> full replay, a torn tail below the
  snapshot's offset, ``abandon`` losing only the unflushed tail, snapshot
  retention, and the sync-policy check.
* The on-disk format is the same bytes: a directory written by the port
  opens in the JAX ``RequestJournal`` with equal ``live()`` records and
  counters, and the reverse — torn tails and corrupt snapshots included.
"""

import dataclasses
import os

import numpy as np
import pytest

from paddle_tpu.inference.serving import journal as JJ
from paddle_tpu.testing.chaos import corrupt_snapshot, torn_journal_tail
from paddle_tpu_torch.inference.serving import journal as TJ

PKGS = {"jax": JJ.RequestJournal, "port": TJ.RequestJournal}


def jsubmit(j, prompt=(1, 2, 3), mnt=4, **kw):
    base = dict(prompt=list(prompt), max_new_tokens=mnt, eos_token_id=None,
                temperature=0.0, top_k=None, top_p=None, seed=0,
                tenant="default", priority=0, deadline=None)
    base.update(kw)
    return j.log_submit(**base)


@pytest.fixture(params=list(PKGS))
def RJ(request):
    return PKGS[request.param]


class TestJournalFile:
    def test_roundtrip_restores_mirror(self, RJ, tmp_path):
        j = RJ(str(tmp_path))
        a = jsubmit(j, prompt=[5, 6], mnt=3, tenant="t0", priority=2,
                    temperature=0.7, top_k=9, top_p=0.9, seed=4)
        b = jsubmit(j, prompt=[7], mnt=2)
        j.log_tokens(a, [10, 11])
        j.log_tokens(b, [12])
        j.log_terminal(b, "finished")
        j.flush()
        j.close()
        j2 = RJ(str(tmp_path))
        assert j2.recovered_records == 2
        assert j2.torn_tail_bytes == 0
        ra, rb = j2.records[a], j2.records[b]
        assert ra.tokens == [10, 11] and not ra.terminal
        assert (ra.tenant, ra.priority, ra.temperature, ra.top_k,
                ra.top_p, ra.seed) == ("t0", 2, 0.7, 9, 0.9, 4)
        assert rb.terminal and rb.state == "finished"
        assert list(j2.live()) == [a]
        assert jsubmit(j2) == b + 1
        j2.close()

    def test_torn_tail_truncated_in_place(self, RJ, tmp_path):
        j = RJ(str(tmp_path))
        a = jsubmit(j)
        j.log_tokens(a, [1])
        j.flush()
        j.close()
        wal = os.path.join(str(tmp_path), "journal.wal")
        good = os.path.getsize(wal)
        garbage = b"\x40\x00\x00\x00\xde\xad\xbe\xefpartial"
        with open(wal, "ab") as fh:
            fh.write(garbage)
        j2 = RJ(str(tmp_path))
        assert j2.torn_tail_bytes == len(garbage)
        assert os.path.getsize(wal) == good
        assert j2.records[a].tokens == [1]
        j2.log_tokens(a, [2])
        j2.flush()
        j2.close()
        j3 = RJ(str(tmp_path))
        assert j3.records[a].tokens == [1, 2]
        assert j3.torn_tail_bytes == 0
        j3.close()

    def test_resume_rebase_and_idempotence(self, RJ, tmp_path):
        j = RJ(str(tmp_path))
        a = jsubmit(j)
        j.log_tokens(a, [1, 2])
        n = j.appended_records
        assert j.resume(a, [1, 2]) is True
        assert j.appended_records == n
        assert j.resume(a, [1, 2, 3]) is True
        assert j.records[a].tokens == [1, 2, 3]
        assert j.resume(a + 99, []) is False
        j.log_terminal(a, "finished")
        assert j.resume(a, [1, 2, 3]) is False
        n = j.appended_records
        j.log_terminal(a, "cancelled")
        assert j.appended_records == n
        assert j.records[a].state == "finished"
        j.close()

    def test_snapshot_fallback_newest_to_oldest_to_full_replay(
            self, RJ, tmp_path):
        j = RJ(str(tmp_path))
        a = jsubmit(j)
        j.log_tokens(a, [1])
        j.snapshot()
        j.log_tokens(a, [2])
        j.snapshot()
        j.log_tokens(a, [3])
        j.flush()
        j.close()

        def reopen():
            r = RJ(str(tmp_path))
            toks, fb = r.records[a].tokens, r.snapshot_fallbacks
            r.close()
            return toks, fb

        assert reopen() == ([1, 2, 3], 0)
        assert corrupt_snapshot(str(tmp_path), seed=1)["enabled"]
        assert reopen() == ([1, 2, 3], 1)
        for name in os.listdir(str(tmp_path)):
            if name.startswith("snapshot-"):
                with open(os.path.join(str(tmp_path), name), "r+b") as fh:
                    fh.seek(6)
                    fh.write(b"\xff\xff\xff\xff")
        assert reopen() == ([1, 2, 3], 2)

    def test_deep_torn_tail_snapshot_is_last_good(self, RJ, tmp_path):
        j = RJ(str(tmp_path))
        a = jsubmit(j)
        j.log_tokens(a, [1])
        j.snapshot()
        j.log_tokens(a, [2])
        j.flush()
        j.close()
        with open(os.path.join(str(tmp_path), "journal.wal"), "r+b") as fh:
            fh.truncate(5)
        j2 = RJ(str(tmp_path))
        assert j2.records[a].tokens == [1]
        j2.close()

    def test_abandon_loses_only_the_unflushed_tail(self, RJ, tmp_path):
        j = RJ(str(tmp_path))
        a = jsubmit(j)
        j.log_tokens(a, [1])
        j.flush()
        wal = os.path.join(str(tmp_path), "journal.wal")
        durable = os.path.getsize(wal)
        j.log_tokens(a, [2])
        assert j.abandon() == durable
        assert os.path.getsize(wal) == durable
        j2 = RJ(str(tmp_path))
        assert j2.records[a].tokens == [1]
        j2.close()

    def test_snapshot_retention_and_auto_snapshot(self, RJ, tmp_path):
        j = RJ(str(tmp_path), snapshot_every=2)
        jsubmit(j)
        for _ in range(6):
            j.flush()
        assert j.snapshots_written == 3
        snaps = [n for n in os.listdir(str(tmp_path))
                 if n.startswith("snapshot-")]
        assert len(snaps) == 2
        j.close()

    def test_unknown_sync_policy_rejected(self, RJ, tmp_path):
        with pytest.raises(ValueError, match="sync policy"):
            RJ(str(tmp_path), sync="fsync-sometimes")


# ---------------------------------------------------------------------------
# one on-disk format: cross-reads
# ---------------------------------------------------------------------------

def _write_history(RJ, d, snapshot_every=3):
    """A mixed history: several requests, token cursors, a rebase, terminal
    records, snapshots, and a last flush; left open-and-closed."""
    rng = np.random.default_rng(5)
    j = RJ(str(d), snapshot_every=snapshot_every)
    jids = []
    for i in range(5):
        jids.append(jsubmit(
            j, prompt=[int(t) for t in rng.integers(0, 97, 4 + i)],
            mnt=6, temperature=0.5 * (i % 2), top_k=10 if i % 2 else None,
            top_p=0.9 if i == 3 else None, seed=i, tenant=f"t{i % 2}",
            priority=i, deadline=1e9 + i if i == 2 else None,
            adapter_id="a1" if i == 4 else None))
    for step in range(6):
        for jid in jids:
            j.log_tokens(jid, [int(rng.integers(0, 97))])
        if step == 2:
            j.log_terminal(jids[1], "cancelled")
            j.resume(jids[0], j.records[jids[0]].tokens + [42])
        j.flush()
    j.log_terminal(jids[3], "finished")
    j.flush()
    j.close()
    return jids


def _view(j):
    return ({k: dataclasses.asdict(r) for k, r in j.live().items()},
            {k: dataclasses.asdict(r) for k, r in j.records.items()},
            j.torn_tail_bytes, j.snapshot_fallbacks, j.recovered_records,
            j._next_jid)


@pytest.mark.parametrize("damage", ["clean", "torn_tail", "corrupt_snapshot"])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_directory_opens_in_the_other_package(tmp_path, writer, reader,
                                              damage):
    for who in ("a", "b"):               # the same history, twice
        _write_history(PKGS[writer], tmp_path / who)
        if damage == "torn_tail":
            assert torn_journal_tail(str(tmp_path / who))["enabled"]
        elif damage == "corrupt_snapshot":
            assert corrupt_snapshot(str(tmp_path / who))["enabled"]
    # both dirs hold byte-equal files
    for name in sorted(os.listdir(tmp_path / "a")):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name
    same = PKGS[writer](str(tmp_path / "a"))
    other = PKGS[reader](str(tmp_path / "b"))
    assert _view(other) == _view(same)
    assert other.live()
    if damage == "torn_tail":
        assert other.torn_tail_bytes > 0
    if damage == "corrupt_snapshot":
        assert other.snapshot_fallbacks == 1
    # the reader appends; the writer's package reads that back
    jid = jsubmit(other, prompt=[9, 9])
    other.log_tokens(jid, [3])
    other.flush()
    other.close()
    same.close()
    back = PKGS[writer](str(tmp_path / "b"))
    assert back.records[jid].tokens == [3]
    back.close()


def test_the_same_writes_give_the_same_bytes(tmp_path):
    """Both packages write byte-identical WAL and snapshot files for one
    history (the framing, the JSON payloads, the snapshot names)."""
    for name, RJ in PKGS.items():
        _write_history(RJ, tmp_path / name)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "journal.wal" in names and any(
        n.startswith("snapshot-") for n in names)
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


def test_frame_and_parse_match_reference():
    payloads = [b"{}", b'{"ev": "tok", "jid": 1, "toks": [1, 2]}', b""]
    raw = b"".join(TJ._frame(p) for p in payloads)
    assert raw == b"".join(JJ._frame(p) for p in payloads)
    cut = raw[:-3]
    assert TJ._parse_frames(cut) == JJ._parse_frames(cut)
    assert TJ._parse_frames(raw, 0) == JJ._parse_frames(raw, 0)
