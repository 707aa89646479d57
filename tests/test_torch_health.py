"""The port's health ladder (``paddle_tpu_torch.health``: ``HealthMonitor``,
``guard_step``, ``tree_where``) against the JAX package's.

* ``HealthMonitor`` (``tests/test_health.py::TestHealthMonitor``): the JAX
  and port monitors fed the same loss sequences (host checks and given
  verdicts, NaN / Inf / spikes before and after the warmup) return the
  same actions, kinds, streaks and steps, with the EMA within 1e-6
  (relative); the skip -> restore -> abort ladder restores the same step
  through each package's ``AsyncCheckpointer`` with the same ``lr_scale``
  and aborts with the diagnosis.
* ``guard_step`` over a pure step (a linear regression with a NaN batch
  and an Inf batch in it) matches the JAX ``guard_step``: parameters,
  optimizer state and health vectors within 1e-6 each step; a bad step
  returns the input tensors' values.
* ``tests/test_chaos.py::TestRuntimeChaos``: K consecutive NaN steps
  escalate to a last-good restore in both packages; ``nan_payload``
  poisons the same positions as the reference on numpy, and a torch
  tensor on its own device.
* ``test_anomalous_run_converges_to_clean_loss`` (``tests/test_chaos.py
  :396``) with the same faulted schedule in both packages (NaN bursts,
  transient bad samples healed by the loader's retries, commits every 3
  epochs): the same monitor records, final losses within 1e-5, and the
  faulted run within the reference's 5e-2 of its clean run.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import health as JH
from paddle_tpu.distributed.checkpoint import AsyncCheckpointer as JCk
from paddle_tpu.io import DataLoader as JLoader
from paddle_tpu.io import Dataset as JDataset
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import health as TH
from paddle_tpu_torch.distributed.checkpoint import AsyncCheckpointer as TCk
from paddle_tpu_torch.io import DataLoader as TLoader
from paddle_tpu_torch.io import Dataset as TDataset
from paddle_tpu_torch.testing import chaos as tchaos

torch.set_num_threads(2)

NAN, INF = float("nan"), float("inf")


def _record(r):
    return (r.step, r.kind, r.action.value, r.streak)


def _same_records(a, b):
    assert [_record(r) for r in a] == [_record(r) for r in b]
    for x, y in zip(a, b):
        for u, v in ((x.loss, y.loss), (x.ema, y.ema)):
            assert u == v or (np.isnan(u) and np.isnan(v)) or \
                abs(u - v) <= 1e-6 * max(1.0, abs(v)), (x, y)


# (losses, bad verdicts or None for the host check, monitor kwargs)
SEQUENCES = {
    "nan-streaks": ([2.0, NAN, 1.9, NAN, INF, NAN, 1.8, -INF, 1.7], None,
                    dict(skip_threshold=3)),
    "spike-after-warmup": ([2.0, 1.9, 1.8, 9.0, 1.7, 50.0, 60.0, 1.6],
                           None, dict(spike_factor=3.0, spike_warmup=3,
                                      skip_threshold=2)),
    "spike-before-warmup": ([2.0, 40.0, 1.9, 30.0, 1.7], None,
                            dict(spike_factor=2.0, spike_warmup=20)),
    "given-verdicts": ([2.0, 3.0, NAN, 2.5, 2.4, 9.0], [False, True, True,
                                                         False, True, True],
                       dict(skip_threshold=2)),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_monitor_records_match_jax(name):
    losses, bads, kw = SEQUENCES[name]
    mons = {side: M.HealthMonitor(verbose=False, **kw)
            for side, M in (("jax", JH), ("port", TH))}
    out = {}
    for side, mon in mons.items():
        acts = []
        for i, loss in enumerate(losses):
            rec = mon.observe(i, loss, None if bads is None else bads[i])
            acts.append(_record(rec))
            if rec.action.value == "restore":
                assert mon.restore() is None   # caller-owned rollback
        out[side] = (acts, mon.streak, mon.bad_steps, mon.good_steps,
                     mon.restores, mon.lr_scale)
    assert out["port"] == out["jax"]
    _same_records(mons["port"].records, mons["jax"].records)
    j, t = mons["jax"]._ema, mons["port"]._ema
    assert (np.isnan(j) and np.isnan(t)) or abs(j - t) <= 1e-6 * abs(j)


def _state(side, val):
    if side == "jax":
        return {"w": paddle.to_tensor(np.full((4,), val, np.float32))}
    return {"w": torch.full((4,), float(val))}


@pytest.mark.parametrize("side", ["jax", "port"])
def test_skip_restore_abort_ladder(tmp_path, side):
    """``TestHealthMonitor.test_skip_then_restore_then_abort_ladder`` on
    each package; both give the same observable outcome."""
    H, Ck = (JH, JCk) if side == "jax" else (TH, TCk)
    ck = Ck(str(tmp_path / "ck"), keep_last_k=2)
    ck.save(_state(side, 5.0), 7)
    ck.wait()
    mon = H.HealthMonitor(checkpointer=ck, skip_threshold=2, max_restores=1,
                          lr_backoff=0.5, verbose=False)
    assert mon.observe(0, 1.0).action is H.HealthAction.OK
    assert mon.observe(1, NAN).action is H.HealthAction.SKIP
    r = mon.observe(2, NAN)
    assert r.action is H.HealthAction.RESTORE and r.streak == 2
    dst = _state(side, 0.0)
    assert mon.restore(dst) == 7
    np.testing.assert_array_equal(np.asarray(dst["w"].numpy()),
                                  np.full((4,), 5.0))
    assert mon.lr_scale == 0.5 and mon.streak == 0 and np.isnan(mon._ema)
    mon.observe(3, NAN)
    mon.observe(4, NAN)
    with pytest.raises(H.HealthAbortError, match="Recent anomalies"):
        mon.restore(dst)
    assert [_record(x) for x in mon.records] == [
        (1, "nan", "skip", 1), (2, "nan", "restore", 2),
        (7, "restore", "restore", 0), (3, "nan", "skip", 1),
        (4, "nan", "restore", 2)]


def test_monitor_edges_match_jax():
    """Good step resets the streak; records are structured; a restore
    without a checkpointer counts only; flags give the defaults."""
    for H in (JH, TH):
        mon = H.HealthMonitor(skip_threshold=2, verbose=False)
        mon.observe(0, NAN)
        mon.observe(1, 1.0)
        r = mon.observe(2, NAN)
        assert r.action is H.HealthAction.SKIP and r.streak == 1
        assert isinstance(mon.records[-1], H.AnomalyRecord)
        mon2 = H.HealthMonitor(skip_threshold=1, max_restores=2,
                               verbose=False)
        mon2.observe(0, NAN)
        assert mon2.restore() is None
        assert mon2.restores == 1 and mon2.streak == 0
        d = H.HealthMonitor(verbose=False)
        assert (d.skip_threshold, d.max_restores, d.lr_backoff,
                d.spike_factor, d.spike_warmup) == (3, 3, 1.0, 0.0, 20)
    seen = []
    mon = TH.HealthMonitor(skip_threshold=1, verbose=False,
                           on_anomaly=seen.append)
    mon.observe(0, NAN)
    assert [_record(r) for r in seen] == [(0, "nan", "restore", 1)]


def _pure_step(lib):
    """A pure linear-regression step in ``lib`` (jnp or torch)."""
    def step(params, opt, x, t):
        pred = x @ params["w"]
        loss = ((pred - t) ** 2).mean()
        g = 2.0 * x.T @ (pred - t) / x.shape[0]
        return ({"w": params["w"] - 0.05 * g, "b": params["b"] * 0.5},
                {"n": opt["n"] + 1}, loss)
    return step


def test_guard_step_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((6, 8, 3)).astype(np.float32)
    T = X @ np.array([[1.5], [-2.0], [0.5]], np.float32)
    X[2] = jchaos.nan_payload(X[2], frac=0.25)
    X[4, 0, 0] = np.inf
    jg = JH.guard_step(_pure_step(jnp), spike_factor=5.0, warmup=1)
    tg = TH.guard_step(_pure_step(torch), spike_factor=5.0, warmup=1)
    w0 = rng.standard_normal((3, 1)).astype(np.float32)
    jp, jo, js = ({"w": jnp.asarray(w0), "b": jnp.ones(2)},
                  {"n": jnp.zeros((), jnp.int32)}, JH.sentinel_init())
    tp, to, ts = ({"w": torch.from_numpy(w0.copy()), "b": torch.ones(2)},
                  {"n": torch.zeros((), dtype=torch.int32)},
                  TH.sentinel_init(device="cpu"))
    for i in range(len(X)):
        before = tp["w"].clone()
        jp, jo, js, jh = jg(jp, jo, js, jnp.asarray(X[i]), jnp.asarray(T[i]))
        tp, to, ts, th = tg(tp, to, ts, torch.from_numpy(X[i]),
                            torch.from_numpy(T[i]))
        jl, jb, je = JH.unpack_health(jh)
        tl, tb, te = TH.unpack_health(th)
        assert jb == tb
        if tb:
            assert torch.equal(tp["w"], before)
        for a, b in ((jl, tl), (je, te)):
            assert (np.isnan(a) and np.isnan(b)) or np.isinf(a) and a == b \
                or abs(a - b) <= 1e-6 * max(1.0, abs(a))
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tp["b"].numpy(), np.asarray(jp["b"]),
                                   rtol=1e-6)
        assert int(to["n"]) == int(jo["n"])
        assert int(ts["count"]) == int(js["count"])
    assert int(to["n"]) == 4         # two bad steps skipped


def test_tree_where_selects_per_leaf():
    old = {"a": torch.zeros(2), "b": [torch.ones(3), (torch.full((1,), 2.),)]}
    new = {"a": torch.ones(2), "b": [torch.zeros(3), (torch.full((1,), 5.),)]}
    bad, good = torch.tensor(True), torch.tensor(False)
    kept = TH.tree_where(bad, old, new)
    took = TH.tree_where(good, old, new)
    assert torch.equal(kept["a"], old["a"])
    assert torch.equal(kept["b"][1][0], old["b"][1][0])
    assert torch.equal(took["b"][0], new["b"][0])
    assert isinstance(took["b"], list) and isinstance(took["b"][1], tuple)


def test_nan_payload_matches_jax():
    x = np.arange(40, dtype=np.float32).reshape(5, 8)
    for frac, seed in ((0.25, 0), (0.1, 3), (1.0, 0)):
        want = jchaos.nan_payload(x, frac=frac, seed=seed)
        got_np = tchaos.nan_payload(x, frac=frac, seed=seed)
        got_t = tchaos.nan_payload(torch.from_numpy(x), frac=frac,
                                   seed=seed)
        np.testing.assert_array_equal(got_np, want)
        np.testing.assert_array_equal(got_t.numpy(), want)
    assert not np.isnan(x).any()                       # a copy
    ints = tchaos.nan_payload(torch.arange(4))
    assert torch.equal(ints, torch.arange(4))
    batch = tchaos.nan_payload({"x": torch.ones(2, 2).t(), "y": [x]},
                               value=float("inf"), frac=0.5, seed=1)
    assert np.isinf(batch["x"].numpy()).sum() == 2
    assert np.isinf(batch["y"][0]).sum() == 20


@pytest.mark.parametrize("side", ["jax", "port"])
def test_k_consecutive_nan_triggers_last_good_restore(tmp_path, side):
    """``TestRuntimeChaos`` of the reference: K NaN steps escalate
    through HealthMonitor to the last-good restore."""
    if side == "jax":
        H, Ck, chaos = JH, JCk, jchaos
        sent, arr = H.sentinel_init(), jnp.asarray
        params = {"w": jnp.full((4,), 3.0)}
        opt = {"n": jnp.zeros((), jnp.int32)}
    else:
        H, Ck, chaos = TH, TCk, tchaos
        sent, arr = H.sentinel_init(device="cpu"), torch.as_tensor
        params = {"w": torch.full((4,), 3.0)}
        opt = {"n": torch.zeros((), dtype=torch.int32)}

    def stepfn(params, opt, x):
        loss = (params["w"] * x).mean()
        return {"w": params["w"] - 0.1 * x.mean()}, {"n": opt["n"] + 1}, loss

    ck = Ck(str(tmp_path / "ck"), keep_last_k=2)
    g = H.guard_step(stepfn)
    mon = H.HealthMonitor(checkpointer=ck, skip_threshold=2, max_restores=2,
                          verbose=False)
    params, opt, sent, h = g(params, opt, sent, arr(np.ones(4, np.float32)))
    good_w = np.asarray(params["w"]).copy()
    ck.save({"w": paddle.to_tensor(good_w) if side == "jax"
             else torch.from_numpy(good_w)}, 1)
    ck.wait()
    mon.observe(1, *H.unpack_health(h)[:2])
    nan_x = arr(chaos.nan_payload(np.ones(4, np.float32)))
    actions = []
    for s in (2, 3):
        params, opt, sent, h = g(params, opt, sent, nan_x)
        loss, bad, _ = H.unpack_health(h)
        actions.append(mon.observe(s, loss, bad).action)
    assert actions == [H.HealthAction.SKIP, H.HealthAction.RESTORE]
    np.testing.assert_array_equal(np.asarray(params["w"]), good_w)
    dst = _state(side, -1.0)
    assert mon.restore(dst) == 1
    np.testing.assert_array_equal(np.asarray(dst["w"].numpy()), good_w)


# ---------------------------------------------------------------------------
# test_anomalous_run_converges_to_clean_loss, both packages, one schedule
# ---------------------------------------------------------------------------

def _regression_data():
    rng = np.random.RandomState(0)
    X = rng.randn(64, 3).astype(np.float32)
    y = X @ np.array([[1.5], [-2.0], [0.5]], np.float32)
    return X, y


def _convergence_run(side, root, poison):
    X, y = _regression_data()
    Base = JDataset if side == "jax" else TDataset

    class _DS(Base):
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return X[i], y[i]

    if side == "jax":
        H, Ck, Loader, chaos = JH, JCk, JLoader, jchaos
        sent = H.sentinel_init()
        params = {"w": jnp.zeros((3, 1))}
        opt = {"n": jnp.zeros((), jnp.int32)}

        def arr(b):
            return jnp.asarray(b.numpy() if isinstance(b, paddle.Tensor)
                               else b)

        def host(x):
            return np.asarray(x)

        def to_state(w):
            return {"w": paddle.to_tensor(np.asarray(w))}

        def blank():
            return {"w": paddle.to_tensor(np.zeros((3, 1), np.float32))}

        def from_state(st):
            return jnp.asarray(st["w"].numpy())
    else:
        H, Ck, Loader, chaos = TH, TCk, TLoader, tchaos
        sent = H.sentinel_init(device="cpu")
        params = {"w": torch.zeros((3, 1))}
        opt = {"n": torch.zeros((), dtype=torch.int32)}

        def arr(b):
            return b

        def host(x):
            return x.numpy()

        def to_state(w):
            return {"w": w.clone()}

        def blank():
            return {"w": torch.zeros((3, 1))}

        def from_state(st):
            return st["w"].clone()

    def stepfn(params, opt, x, t):
        pred = x @ params["w"]
        loss = ((pred - t) ** 2).mean()
        g = 2.0 * x.T @ (pred - t) / x.shape[0]
        return {"w": params["w"] - 0.05 * g}, {"n": opt["n"] + 1}, loss

    ck = Ck(str(root), keep_last_k=3)
    g = H.guard_step(stepfn)
    mon = H.HealthMonitor(checkpointer=ck, skip_threshold=3, max_restores=3,
                          verbose=False)
    ds = _DS()
    if poison:
        ds = chaos.bad_sample(ds, [11, 40], fails_each=1)
    kw = dict(use_buffer_reader=False) if side == "jax" else {}
    loader = Loader(ds, batch_size=8, shuffle=False,
                    sample_retries=2 if poison else 0,
                    sample_retry_backoff=0.001, **kw)
    step, final = 0, None
    for epoch in range(12):
        for batch in loader:
            x, t = arr(batch[0]), arr(batch[1])
            if poison and epoch in (2, 5) and step % 8 == 5:
                # a NaN burst shorter than K: pure skips
                x = arr(chaos.nan_payload(host(x), frac=0.25)) \
                    if side == "jax" else chaos.nan_payload(x, frac=0.25)
            if poison and epoch == 7 and step % 8 in (1, 2, 3):
                # a burst of K: skip, skip, restore the last commit
                x = x * float("nan")
            params, opt, sent, h = g(params, opt, sent, x, t)
            loss, bad, _ = H.unpack_health(h)
            rec = mon.observe(step, loss, bad)
            if rec.action is H.HealthAction.RESTORE:
                state = blank()
                mon.restore(state)
                params = {"w": from_state(state)}
                sent = H.sentinel_init() if side == "jax" else \
                    H.sentinel_init(device="cpu")
            if not bad:
                final = loss
            step += 1
        if epoch % 3 == 2:
            ck.save(to_state(params["w"]), step)
            ck.wait()
    return final, mon


def test_anomalous_run_converges_to_clean_loss(tmp_path):
    """The reference's convergence parity, plus a K-long NaN burst that
    restores: the port's faulted run gives JAX's monitor records and
    final loss, and reaches its clean run's loss."""
    got = {}
    for side in ("jax", "port"):
        clean, _ = _convergence_run(side, tmp_path / f"{side}_c", False)
        faulted, mon = _convergence_run(side, tmp_path / f"{side}_p", True)
        assert mon.bad_steps >= 2 and mon.restores == 1
        np.testing.assert_allclose(faulted, clean, rtol=5e-2, atol=1e-4)
        got[side] = (clean, faulted, mon)
    _same_records(got["port"][2].records, got["jax"][2].records)
    for i in (0, 1):
        assert abs(got["port"][i] - got["jax"][i]) <= 1e-5 * max(
            1.0, abs(got["jax"][i]))
    assert os.path.isdir(tmp_path / "port_p")


@pytest.mark.parametrize("name", [
    "FLAGS_checkpoint_verify", "FLAGS_health_skip_threshold",
    "FLAGS_health_max_restores", "FLAGS_health_lr_backoff",
    "FLAGS_health_data_retries", "FLAGS_health_data_backoff_s",
    "FLAGS_health_worker_restarts"])
def test_flags_match_jax(name):
    """The checkpoint and health flags carry the reference's default,
    type and help text; ``set_flags`` reaches the monitor's default."""
    from paddle_tpu import flags as JF
    from paddle_tpu_torch import flags as TF
    j, t = JF._registry[name], TF._registry[name]
    assert (t.default, t.type, t.help) == (j.default, j.type, j.help)
    assert TF.flag(name) == JF.flag(name)
    if name == "FLAGS_health_skip_threshold":
        TF.set_flags({name: 5})
        try:
            assert TH.HealthMonitor(verbose=False).skip_threshold == 5
        finally:
            TF.set_flags({name: t.default})
