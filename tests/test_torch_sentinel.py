"""The port's health sentinel (``paddle_tpu_torch.health``) and the
health-guarded train step (``make_train_step(sentinel=True)``) against the
JAX package's.

* ``sentinel_check`` over loss sequences with NaN, +-Inf, spikes before
  and after the warmup, ``spike_factor`` 0 and > 0 and a ``[2]`` loss:
  the same verdicts and the same state (count equal, EMA rtol 1e-6) as
  JAX's, step by step; ``pack_health`` / ``unpack_health`` likewise.
* ``make_train_step(sentinel=True)`` over 5 steps whose third batch holds
  an out-of-vocabulary id (it embeds as NaN, so the loss is NaN): the
  health vectors, the step count, the parameters and the moments equal
  the JAX step's after every step. AdamW runs with ``eps=1e-3`` here: at
  the default 1e-8 Adam's ``m / sqrt(v)`` turns the 1e-7 gradient noise
  of near-zero entries into O(lr) parameter differences between any two
  frameworks. Parameters within atol 1e-5 (|p| <= ~1: the gradients'
  last-bit differences, through four updates), moments 1e-5 x max|m|.
* The bad step leaves every parameter and moment tensor with the bits it
  had and the step count unchanged; a good guarded step gives the
  unguarded step's parameters, moments and loss bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import health as JH
from paddle_tpu.health.sentinel import pack_health as jax_pack_health
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import health as TH
from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import (config_from_jax,
                                             params_from_jax, to_numpy)

torch.set_num_threads(2)

NAN, INF = float("nan"), float("inf")
SEQS = {
    "nan-inf": [2.0, NAN, 1.9, INF, -INF, 1.8, 1.7],
    "spike-after-warmup": [2.0, 1.9, 1.8, 9.0, 1.7, 50.0, 1.6],
    "spike-before-warmup": [2.0, 40.0, 1.9, 1.8, 30.0, 1.7, 1.6],
    "nan-first": [NAN, INF, 3.0, 2.5, 2.4, 20.0, 2.3],
    "negative": [-1.0, -1.1, 5.0, -1.2, NAN, -1.3, 0.5],
}


def _run(side, seq, **kw):
    if side == "jax":
        sent, check, arr = JH.sentinel_init(), JH.sentinel_check, jnp.asarray
    else:
        sent, check = TH.sentinel_init(device="cpu"), TH.sentinel_check

        def arr(x):
            return torch.tensor(x, dtype=torch.float32)
    out = []
    for loss in seq:
        bad, sent = check(arr(loss), sent, **kw)
        out.append((bool(bad), int(sent["count"]), float(sent["ema"])))
    return out


@pytest.mark.parametrize("kw", [dict(spike_factor=0.0, warmup=2),
                                dict(spike_factor=3.0, warmup=2),
                                dict(spike_factor=3.0, warmup=0),
                                dict(spike_factor=1.5, warmup=4,
                                     ema_alpha=0.5)],
                         ids=["factor0", "factor3", "warmup0", "alpha"])
@pytest.mark.parametrize("seq", list(SEQS))
def test_sentinel_check_matches_jax(seq, kw):
    got, want = _run("torch", SEQS[seq], **kw), _run("jax", SEQS[seq], **kw)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-6)


def test_sentinel_multi_element_loss_and_pack():
    seq = [[1.0, 2.0], [1.5, 1.0], [NAN, 1.0], [30.0, 1.0], [1.2, 1.3]]
    kw = dict(spike_factor=2.0, warmup=1)
    jsent, tsent = JH.sentinel_init(), TH.sentinel_init(device="cpu")
    for loss in seq:
        jbad, jsent = JH.sentinel_check(jnp.asarray(loss), jsent, **kw)
        tbad, tsent = TH.sentinel_check(torch.tensor(loss), tsent, **kw)
        want = JH.unpack_health(jax_pack_health(jnp.asarray(loss), jbad,
                                               jsent))
        got = TH.unpack_health(TH.pack_health(torch.tensor(loss), tbad,
                                              tsent))
        assert got[1] == want[1] and bool(tbad) == bool(jbad)
        np.testing.assert_allclose([got[0], got[2]], [want[0], want[2]],
                                   rtol=1e-6)


def test_sentinel_defaults_come_from_flags():
    assert flag("FLAGS_health_spike_factor") == 0.0
    assert flag("FLAGS_health_spike_warmup") == 20
    # spike test off by default: a huge finite loss is good
    bad, sent = TH.sentinel_check(torch.tensor(1.0),
                                  TH.sentinel_init(device="cpu"))
    bad, sent = TH.sentinel_check(torch.tensor(1e9), sent)
    assert not bool(bad) and int(sent["count"]) == 2
    s = TH.sentinel_init(device="cpu")
    assert s["ema"].dtype == torch.float32 and s["count"].dtype == \
        torch.int32 and s["ema"].dim() == 0


# ---------------------------------------------------------------------------
# the guarded train step
# ---------------------------------------------------------------------------

V, B, S = 97, 2, 16
OPT = dict(lr=1e-2, eps=1e-3, weight_decay=0.01)


def _cfg(**kw):
    base = dict(vocab_size=V, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2)
    base.update(kw)
    return JL.LlamaConfig(**base)


def _batches(n=5, poisoned=2):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        ids = rng.integers(0, V, (B, S)).astype(np.int32)
        labels = rng.integers(0, V, (B, S)).astype(np.int32)
        if i == poisoned:
            ids[1, 5] = 50 * V        # out of vocabulary: a NaN embedding
        out.append((ids, labels))
    return out


def _clone(tree):
    return TL._tree_map(lambda t: t.detach().clone(), tree)


def _assert_bits(a, b):
    for x, y in zip(TL._leaves(a), TL._leaves(b)):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)


@pytest.mark.parametrize("kw", [dict(), dict(use_kernels=True, remat=True,
                                             remat_policy="save_flash")],
                         ids=["plain", "save_flash"])
def test_guarded_step_trajectory_matches_jax(kw):
    jcfg = _cfg(**kw)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(2))
    init_j, jstep = JL.make_train_step(jcfg, sentinel=True, spike_factor=4.0,
                                       spike_warmup=2, **OPT)
    jo, js = init_j(jp), JH.sentinel_init()
    tcfg = config_from_jax(jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    init_t, tstep = TL.make_train_step(tcfg, sentinel=True,
                                       spike_factor=4.0, spike_warmup=2,
                                       **OPT)
    to, ts = init_t(tp), TH.sentinel_init(device="cpu")
    jfn = jax.jit(jstep)
    for i, (ids, labels) in enumerate(_batches()):
        jp, jo, js, jh = jfn(jp, jo, js, jnp.asarray(ids),
                             jnp.asarray(labels))
        before = (_clone(tp), _clone(to))
        tp, to, ts, th = tstep(tp, to, ts, torch.from_numpy(ids),
                               torch.from_numpy(labels))
        want, got = JH.unpack_health(jh), TH.unpack_health(th)
        assert got[1] == want[1] == (i == 2), (i, got, want)
        np.testing.assert_allclose([got[0], got[2]], [want[0], want[2]],
                                   rtol=1e-5)
        assert int(to["step"]) == int(jo["step"]) == i + (i < 2)
        if i == 2:                   # the bad step: the same bits
            _assert_bits(tp, before[0])
            _assert_bits(to["m"], before[1]["m"])
            _assert_bits(to["v"], before[1]["v"])
        jpn = jax.tree_util.tree_map(np.asarray, jp)
        for a, b in zip(TL._leaves(to_numpy(tp)), TL._leaves(jpn)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        for name in ("m", "v"):
            want_m = jax.tree_util.tree_map(np.asarray, jo[name])
            for a, b in zip(TL._leaves(to_numpy(to[name])),
                            TL._leaves(want_m)):
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("opt_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_good_guarded_step_is_the_unguarded_step(opt_dtype):
    jcfg = _cfg()
    tcfg = config_from_jax(jcfg)
    base = params_from_jax(jax.tree_util.tree_map(
        np.asarray, JL.init_params(jcfg, jax.random.PRNGKey(4))),
        device="cpu")
    init, step = TL.make_train_step(tcfg, opt_dtype=opt_dtype, **OPT)
    _, gstep = TL.make_train_step(tcfg, opt_dtype=opt_dtype, sentinel=True,
                                  **OPT)
    p1, p2 = _clone(base), _clone(base)
    o1, o2 = init(p1), init(p2)
    sent = TH.sentinel_init(device="cpu")
    for ids, labels in _batches(poisoned=-1)[:3]:
        ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)
        p1, o1, loss = step(p1, o1, ids, labels)
        p2, o2, sent, h = gstep(p2, o2, sent, ids, labels)
        assert loss.view(torch.int32) == h[0].view(torch.int32)
        assert not TH.unpack_health(h)[1]
        _assert_bits(p1, p2)
        for name in ("m", "v"):
            for a, b in zip(TL._leaves(o1[name]), TL._leaves(o2[name])):
                assert torch.equal(a, b)
        assert int(o1["step"]) == int(o2["step"])


def test_poisoned_params_are_contained():
    """NaN-poisoned parameters (the JAX ``bench.py`` containment probe):
    the guarded step reports bad, leaves the step count and every moment
    as they were, and the moments stay finite."""
    tcfg = config_from_jax(_cfg())
    params = TL.init_params(tcfg, seed=1, device="cpu")
    init, gstep = TL.make_train_step(tcfg, sentinel=True, **OPT)
    opt = init(params)
    sent = TH.sentinel_init(device="cpu")
    ids, labels = (torch.from_numpy(a) for a in _batches(poisoned=-1)[0])
    params, opt, sent, _ = gstep(params, opt, sent, ids, labels)
    with torch.no_grad():
        for p in TL._leaves(params):
            p.mul_(float("nan"))
    before = _clone(opt)
    params, opt, sent, h = gstep(params, opt, sent, ids, labels)
    loss, bad, _ = TH.unpack_health(h)
    assert bad and not np.isfinite(loss)
    assert int(opt["step"]) == int(before["step"]) == 1
    for name in ("m", "v"):
        _assert_bits(opt[name], before[name])
        assert all(torch.isfinite(t).all() for t in TL._leaves(opt[name]))
