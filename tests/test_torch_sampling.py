"""The port's counter-based PRNG and samplers (``paddle_tpu_torch.prng``,
``paddle_tpu_torch.models.generation``) against ``jax.random`` and the JAX
package's samplers, on the same numpy inputs.

* ``threefry2x32``, ``fold_in``, ``random_bits32`` and ``uniform`` are
  bit-equal to JAX's (keys with the top bit set, counters and indices past
  2**31 included).
* The Gumbel noise goes through ``log`` twice; ``torch.log`` and XLA's
  ``log`` differ by up to one ulp, so it is held to 2e-6 absolute.
* ``sample_tokens`` and ``_sample`` give the JAX samplers' tokens over a
  grid of knobs, seeds and sample indices. A token may differ only where
  the reference's two candidates lie within 4e-6 of each other in
  ``gumbel + logits`` (the noise's bound, twice) — the bounded divergence
  ROADMAP.md section C records.
* The top-p / top-k boundary cases of ``tests/test_serving.py::
  TestTopPBoundaries`` hold on the port's samplers.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from paddle_tpu.models import generation as JG
from paddle_tpu_torch import prng
from paddle_tpu_torch.models import generation as TG

torch.set_num_threads(2)

TINY = float(np.finfo(np.float32).tiny)
MARGIN = 4e-6


def _t(a):
    """numpy uint32 (or any int) array -> int64 torch tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# the PRNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_threefry2x32_bit_equal(seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
    key[seed % 2] |= 0x80000000                    # top bit set
    cnt = rng.integers(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
    cnt[:8] |= 0x80000000                          # counts >= 2**31
    want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(cnt)))
    y0, y1 = prng.threefry2x32(_t(key[0]), _t(key[1]), _t(cnt[:128]),
                               _t(cnt[128:]))
    np.testing.assert_array_equal(np.concatenate([_u32(y0), _u32(y1)]),
                                  want)


@pytest.mark.parametrize("V", [23, 97, 32000])
@pytest.mark.parametrize("seed", [0, 1, 2**32 + 5, -1])
def test_fold_in_bits_uniform_bit_equal_gumbel_bounded(seed, V):
    base = JG.seed_key(seed)
    np.testing.assert_array_equal(_u32(TG.seed_key(seed)), base)
    for idx in (0, 1, 7, 2**31 - 1):
        jk = np.asarray(jax.random.fold_in(jnp.asarray(base), idx))
        tk = prng.fold_in(TG.seed_key(seed), idx)
        np.testing.assert_array_equal(_u32(tk), jk)
        bits = np.asarray(jax.random.bits(jnp.asarray(jk), (V,), jnp.uint32))
        np.testing.assert_array_equal(_u32(prng.random_bits32(tk, (V,))),
                                      bits)
        u = np.asarray(jax.random.uniform(jnp.asarray(jk), (V,),
                                          minval=TINY, maxval=1.0))
        np.testing.assert_array_equal(
            prng.uniform(tk, (V,)).numpy().view(np.uint32), u.view(np.uint32))
        g = np.asarray(jax.random.gumbel(jnp.asarray(jk), (V,)))
        assert np.abs(prng.gumbel(tk, (V,)).numpy() - g).max() <= 2e-6


def test_batched_keys_draw_like_vmap():
    """A key batch [B, 2] draws what ``jax.vmap`` over the keys draws; one
    key over a 2-D shape draws over the flat index."""
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in range(5)])
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(
        k, (7,), jnp.uint32))(jnp.asarray(keys)))
    np.testing.assert_array_equal(_u32(prng.random_bits32(_t(keys), (7,))),
                                  want)
    want2 = np.asarray(jax.random.bits(jnp.asarray(keys[2]), (5, 7),
                                       jnp.uint32))
    np.testing.assert_array_equal(
        _u32(prng.random_bits32(_t(keys[2]), (5, 7))), want2)


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------

def _assert_tokens(got, want, logits, gumbel_rows, temperature):
    """Equal tokens, or — per differing row — the reference's two
    candidates within MARGIN of each other in gumbel + logits / t."""
    for r in np.nonzero(got != want)[0]:
        s = logits[r].astype(np.float64) / max(float(temperature[r]), 1e-6)
        z = gumbel_rows[r].astype(np.float64) + s
        margin = abs(z[want[r]] - z[got[r]])
        assert margin < MARGIN, (r, int(got[r]), int(want[r]), margin)


def _keys(seeds, idx):
    return np.stack([np.asarray(jax.random.fold_in(
        jnp.asarray(JG.seed_key(s)), idx)) for s in seeds])


def _device_pair(lg, keys, temp, topk, topp):
    """(port tokens, JAX tokens, JAX's Gumbel rows) for one row set."""
    B, V = lg.shape
    want = np.asarray(JG.sample_tokens(
        jnp.asarray(lg), jnp.asarray(keys), jnp.asarray(temp),
        jnp.asarray(topk), jnp.asarray(topp)))
    got = TG.sample_tokens(torch.from_numpy(lg), _t(keys),
                           torch.from_numpy(temp), torch.from_numpy(topk),
                           torch.from_numpy(topp)).numpy()
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(
        jnp.asarray(keys)))
    return got, want, g


@pytest.mark.parametrize("top_p", [0.5, 0.9, 1.0])
@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_tokens_matches_jax(temperature, top_k, top_p):
    """16 rows x 4 seeds x 3 sample indices at V 97."""
    rng = np.random.default_rng(7)
    B, V = 16, 97
    for seed in range(4):
        lg = (rng.normal(size=(B, V)) * 3).astype(np.float32)
        for idx in (0, 5, 2**31 - 1):
            keys = _keys([seed * 1000 + b for b in range(B)], idx)
            temp = np.full((B,), temperature, np.float32)
            got, want, g = _device_pair(
                lg, keys, temp, np.full((B,), top_k, np.int32),
                np.full((B,), top_p, np.float32))
            _assert_tokens(got, want, lg, g, temp)
            if temperature == 0.0:
                np.testing.assert_array_equal(got, np.argmax(lg, -1))


def test_sample_tokens_matches_jax_full_vocab():
    """One row set at V 32000, per-row knobs mixed (greedy rows among
    sampled ones)."""
    rng = np.random.default_rng(8)
    B, V = 8, 32000
    lg = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    keys = _keys(range(B), 3)
    temp = np.array([0.0, 0.7, 1.3, 0.7, 1.0, 0.0, 1.3, 0.9], np.float32)
    topk = np.array([0, 0, 50, 5, 0, 7, 1, 40], np.int32)
    topp = np.array([1.0, 0.9, 0.95, 1.0, 0.5, 0.3, 1.0, 0.99], np.float32)
    got, want, g = _device_pair(lg, keys, temp, topk, topp)
    _assert_tokens(got, want, lg, g, temp)


@pytest.mark.parametrize("top_k", [None, 1, 5])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_dense_sample_matches_jax(temperature, top_k):
    """The static-knob ``_sample``: one key over the whole [B, V] block."""
    rng = np.random.default_rng(9)
    B, V = 8, 97
    lg = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    for top_p, s in itertools.product((None, 0.5, 0.9, 1.0), range(3)):
        want = np.asarray(JG._sample(jnp.asarray(lg), jax.random.PRNGKey(s),
                                     temperature, top_k, top_p))
        got = TG._sample(torch.from_numpy(lg), TG.seed_key(s), temperature,
                         top_k, top_p).numpy()
        g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(s), (B, V)))
        _assert_tokens(got, want, lg, g, np.full((B,), temperature))


# ---------------------------------------------------------------------------
# TestTopPBoundaries on the port's samplers
# ---------------------------------------------------------------------------

def _dense(logits, seed, temperature, top_k, top_p):
    return TG._sample(torch.from_numpy(logits), TG.seed_key(seed),
                      temperature, top_k, top_p).numpy()


def _device(logits, seed, temperature, top_k, top_p):
    B = logits.shape[0]
    return TG.sample_tokens(
        torch.from_numpy(logits), TG.seed_key(seed).expand(B, 2),
        torch.full((B,), temperature),
        torch.full((B,), top_k if top_k is not None else 0,
                   dtype=torch.int32),
        torch.full((B,), top_p if top_p is not None else 1.0)).numpy()


_SAMPLERS = {"dense": _dense, "device": _device}
_PROBS = np.array([0.5, 0.25, 0.125, 0.125], np.float64)


def _tie_logits():
    # powers of two: exact probabilities and cumulative sums
    # [0.5, 0.75, 0.875, 1.0]
    return np.repeat(np.log(_PROBS)[None, :].astype(np.float32), 64, axis=0)


@pytest.mark.parametrize("sampler", ["dense", "device"])
def test_exact_cumulative_tie_excludes_next_token(sampler):
    """top_p 0.75 on [.5, .25, .125, .125]: {0, 1} reaches the mass
    exactly, so token 2 is out."""
    seen = set()
    for s in range(16):
        seen.update(_SAMPLERS[sampler](_tie_logits(), s, 1.0, None,
                                       0.75).tolist())
    assert seen == {0, 1}, seen


@pytest.mark.parametrize("sampler", ["dense", "device"])
def test_crossing_token_stays_in(sampler):
    seen = set()
    for s in range(16):
        seen.update(_SAMPLERS[sampler](_tie_logits(), s, 1.0, None,
                                       0.6).tolist())
    assert seen == {0, 1}, seen


@pytest.mark.parametrize("sampler", ["dense", "device"])
def test_top_p_one_keeps_full_distribution(sampler):
    lg = np.random.default_rng(0).normal(size=(32, 23)).astype(np.float32)
    for s in range(8):
        np.testing.assert_array_equal(
            _SAMPLERS[sampler](lg, s, 1.0, None, 1.0),
            _SAMPLERS[sampler](lg, s, 1.0, None, None))


@pytest.mark.parametrize("sampler", ["dense", "device"])
def test_top_k_value_threshold_keeps_ties(sampler):
    lg = np.repeat(np.log(np.array([0.5, 0.2, 0.2, 0.1]))[None, :]
                   .astype(np.float32), 64, axis=0)
    seen = set()
    for s in range(24):
        seen.update(_SAMPLERS[sampler](lg, s, 1.0, 2, None).tolist())
    assert seen == {0, 1, 2}, seen


@pytest.mark.parametrize("sampler", ["dense", "device"])
@pytest.mark.parametrize("temperature", [0.1, 1.0, 5.0])
def test_top_k_one_is_greedy_bitwise(sampler, temperature):
    lg = np.random.default_rng(1).normal(size=(32, 23)).astype(np.float32)
    for s in range(4):
        np.testing.assert_array_equal(
            _SAMPLERS[sampler](lg, s, temperature, 1, None),
            np.argmax(lg, axis=-1))


def test_device_temperature_zero_is_argmax_bitwise():
    lg = np.random.default_rng(2).normal(size=(16, 50)).astype(np.float32)
    np.testing.assert_array_equal(_device(lg, 0, 0.0, 7, 0.3),
                                  np.argmax(lg, axis=-1))


# ---------------------------------------------------------------------------
# validate_sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    dict(temperature=-1.0), dict(temperature=float("nan")),
    dict(temperature=float("inf")), dict(top_k=0), dict(top_p=0.0),
    dict(top_p=1.5)])
def test_validate_sampling_rejects_like_jax(knobs):
    with pytest.raises(ValueError) as want:
        JG.validate_sampling(JG.GenerationConfig(**knobs))
    with pytest.raises(ValueError, match="supported knobs") as got:
        TG.validate_sampling(TG.GenerationConfig(**knobs))
    assert str(got.value) == str(want.value)


def test_validate_sampling_accepts_the_supported_surface():
    for knobs in (dict(), dict(temperature=0.7, top_k=1, top_p=1.0),
                  dict(temperature=2.0, top_k=None, top_p=0.01)):
        TG.validate_sampling(TG.GenerationConfig(**knobs))
