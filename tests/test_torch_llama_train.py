"""The port's dense LLaMA training path (``paddle_tpu_torch.models.llama``:
``forward``, ``loss_fn``, the AdamW update, ``make_train_step``) against the
JAX package's, on the same weights and inputs.

The config is ``tests/test_llama.py``'s ``tiny_cfg`` (vocab 97, hidden 32,
2 layers, 4 heads, 2 kv heads) at fp32, weights from the JAX
``init_params`` through ``models.convert.params_from_jax``, ids and labels
from numpy with a seed. With ``use_kernels`` the JAX side runs its Pallas
flash kernels in interpret mode and the port its flash Function's plain
CPU path; with ``use_fused_norm`` the JAX side runs its Pallas rms_norm
and rope kernels in interpret mode and the port its rms_norm and
apply_rope Functions' plain paths (packed batches with per-row positions
keep the plain RoPE route on both sides). Tolerances: logits atol 2e-5, loss 1e-5 and every gradient leaf
atol 1e-5 (the same fp32 arithmetic, summed in other orders); the AdamW
update on given identical gradients rtol 1e-6, taken of each leaf's
largest magnitude (where ``p - lr * u`` cancels to near 0 both sides keep
only the absolute precision of ``p``); loss trajectories over 4
steps rtol 1e-4 (parameters after several steps are not compared: Adam's
``m / sqrt(v)`` turns 1e-7 gradient differences on near-zero entries into
O(lr) steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as JL
from paddle_tpu.kernels.rope import rope_cos_sin as jax_rope_cos_sin
from paddle_tpu_torch.kernels.rope import rope_cos_sin
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import (config_from_jax,
                                             opt_state_from_jax,
                                             params_from_jax, to_numpy)

torch.set_num_threads(2)

B, S = 2, 16


def tiny_cfg(**kw):
    base = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, use_kernels=False)
    base.update(kw)
    return JL.LlamaConfig(**base)


def _setup(seed=0, **kw):
    jcfg = tiny_cfg(**kw)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jcfg, config_from_jax(jcfg), jp, tp


def _batch(seed, packed=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 97, (B, S)).astype(np.int32)
    labels = rng.integers(0, 97, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.25] = -100
    seg = pos = None
    if packed:        # two packed sequences per row, positions restart
        cut = np.array([[5], [11]])
        j = np.arange(S)[None]
        seg = (j >= cut).astype(np.int32)
        pos = np.where(j >= cut, j - cut, j).astype(np.int32)
    return ids, labels, seg, pos


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_logits_match_jax(use_kernels):
    jcfg, tcfg, jp, tp = _setup(1, use_kernels=use_kernels)
    ids, *_ = _batch(1)
    want = np.asarray(JL.forward(jp, jnp.asarray(ids), jcfg))
    with torch.no_grad():
        got = TL.forward(tp, torch.from_numpy(ids), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("use_kernels,ce_chunks,remat,packed", [
    (False, 1, False, False),
    (True, 4, True, False),
    (True, 1, True, True),
    (False, 4, False, True),
])
def test_loss_and_grads_match_jax(use_kernels, ce_chunks, remat, packed):
    _check_loss_and_grads(use_kernels=use_kernels, ce_chunks=ce_chunks,
                          remat=remat, packed=packed)


def _check_loss_and_grads(packed, **kw):
    jcfg, tcfg, jp, tp = _setup(2, **kw)
    ids, labels, seg, pos = _batch(2, packed)
    jl, jg = jax.value_and_grad(JL.loss_fn)(
        jp, jnp.asarray(ids), jnp.asarray(labels), jcfg,
        None if seg is None else jnp.asarray(seg),
        None if pos is None else jnp.asarray(pos))
    leaves = TL._leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl = TL.loss_fn(tp, torch.from_numpy(ids), torch.from_numpy(labels), tcfg,
                    None if seg is None else torch.from_numpy(seg),
                    None if pos is None else torch.from_numpy(pos))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, jg))
    got = _flat(TL._tree_map(lambda p: p.grad.numpy(), tp))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   rtol=0, err_msg=name)


# the fused-norm path (``use_fused_norm=True``): every RMSNorm through the
# rms_norm Function, RoPE through apply_rope where the tables are [S, D];
# the JAX side runs its Pallas rms_norm / rope kernels in interpret mode


@pytest.mark.parametrize("use_kernels", [False, True])
def test_fused_norm_forward_logits_match_jax(use_kernels):
    jcfg, tcfg, jp, tp = _setup(1, use_kernels=use_kernels,
                                use_fused_norm=True)
    ids, *_ = _batch(1)
    want = np.asarray(JL.forward(jp, jnp.asarray(ids), jcfg))
    with torch.no_grad():
        got = TL.forward(tp, torch.from_numpy(ids), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


# packed: 2-D position_ids give [B, S, D] tables, the plain RoPE route with
# the fused norms
@pytest.mark.parametrize("use_kernels,ce_chunks,remat,packed", [
    (True, 1, True, False),
    (True, 4, True, True),
    (False, 1, False, False),
])
def test_fused_norm_loss_and_grads_match_jax(use_kernels, ce_chunks, remat,
                                             packed):
    _check_loss_and_grads(use_kernels=use_kernels, ce_chunks=ce_chunks,
                          remat=remat, packed=packed, use_fused_norm=True)


def _opt_case(seed, opt_dtype):
    """Params, grads and a mid-run AdamW state (step 3, moments as a few
    steps would leave them), as numpy trees."""
    jcfg = tiny_cfg()
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray,
                               JL.init_params(jcfg, jax.random.PRNGKey(seed)))
    like = lambda f: jax.tree_util.tree_map(  # noqa: E731
        lambda a: f(a.shape).astype(np.float32), p)
    g = like(lambda s: rng.standard_normal(s) * 0.1)
    m = like(lambda s: rng.standard_normal(s) * 0.05)
    v = like(lambda s: rng.random(s) * 0.01)
    jdt = jnp.bfloat16 if opt_dtype == "bf16" else jnp.float32
    state = {"m": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), m),
             "v": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), v),
             "step": jnp.int32(3)}
    return p, g, state


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("opt_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("skip", [False, True])
def test_adamw_apply_matches_jax(opt_dtype, skip):
    p, g, state = _opt_case(4, opt_dtype)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    jp, jo = JL._adamw_apply(
        jax.tree_util.tree_map(jnp.asarray, p),
        jax.tree_util.tree_map(jnp.asarray, g), state,
        opt_dtype=jnp.bfloat16 if opt_dtype == "bf16" else jnp.float32,
        skip=jnp.bool_(skip), **kw)
    tdt = torch.bfloat16 if opt_dtype == "bf16" else torch.float32
    tp0 = params_from_jax(p, device="cpu")
    with torch.no_grad():
        tp, to = TL._adamw_apply(
            tp0, params_from_jax(g, device="cpu"),
            opt_state_from_jax(state, device="cpu"), opt_dtype=tdt,
            skip=torch.tensor(skip), **kw)
    assert int(to["step"]) == int(jo["step"]) == (3 if skip else 4)
    for name, got, want in (("params", tp, jp), ("m", to["m"], jo["m"]),
                            ("v", to["v"], jo["v"])):
        got, want = _flat(to_numpy(got)), _flat(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), want))
        for leaf in want:
            _close(got[leaf], want[leaf], f"{name} {leaf}")
    if skip:     # an exact no-op
        for leaf, a in _flat(p).items():
            np.testing.assert_array_equal(_flat(to_numpy(tp))[leaf], a)


def test_adamw_apply_without_skip_matches_jax():
    p, g, state = _opt_case(5, "fp32")
    kw = dict(lr=3e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.0)
    jp, jo = JL._adamw_apply(jax.tree_util.tree_map(jnp.asarray, p),
                             jax.tree_util.tree_map(jnp.asarray, g), state,
                             opt_dtype=jnp.float32, **kw)
    with torch.no_grad():
        tp, to = TL._adamw_apply(params_from_jax(p, device="cpu"),
                                 params_from_jax(g, device="cpu"),
                                 opt_state_from_jax(state, device="cpu"),
                                 opt_dtype=torch.float32, **kw)
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        got, want = _flat(to_numpy(got)), _flat(want)
        for leaf in want:
            _close(got[leaf], want[leaf], leaf)


def test_loss_trajectory_matches_jax():
    _check_trajectory()


def _check_trajectory(**kw):
    jcfg, tcfg, jp, tp = _setup(6, use_kernels=True, remat=True, **kw)
    ids, labels, *_ = _batch(6)
    j_init, j_step = JL.make_train_step(jcfg, lr=1e-2, weight_decay=0.01)
    t_init, t_step = TL.make_train_step(tcfg, lr=1e-2, weight_decay=0.01)
    jo, to = j_init(jp), t_init(tp)
    j_step = jax.jit(j_step)
    jl, tl = [], []
    tids, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    for _ in range(4):
        jp, jo, loss = j_step(jp, jo, jnp.asarray(ids), jnp.asarray(labels))
        jl.append(float(loss))
        tp, to, loss = t_step(tp, to, tids, tlab)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert int(to["step"]) == 4


def test_fused_norm_loss_trajectory_matches_jax():
    _check_trajectory(use_fused_norm=True)


def _train(tcfg, tp, steps, **kw):
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (4, 16)))
    init, step = TL.make_train_step(tcfg, lr=1e-2, **kw)
    opt = init(tp)
    losses = []
    for _ in range(steps):
        tp, opt, loss = step(tp, opt, ids, ids)
        losses.append(loss.item())
    return losses, opt


def test_train_step_decreases_loss():
    cfg = TL.LlamaConfig(**{**dataclasses.asdict(config_from_jax(
        tiny_cfg())), "dtype": torch.float32})
    losses, _ = _train(cfg, TL.init_params(cfg, seed=2, device="cpu"), 8)
    assert losses[-1] < losses[0] * 0.8, losses


def test_bf16_grads_and_moments_train():
    cfg = config_from_jax(tiny_cfg(use_kernels=True, remat=True))
    tp = TL.init_params(cfg, seed=3, device="cpu")
    losses, opt = _train(cfg, tp, 8, grad_dtype=torch.bfloat16,
                         opt_dtype=torch.bfloat16)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses
    assert opt["m"]["embed"].dtype == torch.bfloat16


def test_fused_norm_bf16_train_step_decreases_loss():
    # bf16 activations, fp32 params: the rms_norm Function's dx in bf16,
    # dw in fp32, under checkpoint recompute
    cfg = config_from_jax(tiny_cfg(use_kernels=True, remat=True,
                                   use_fused_norm=True, dtype=jnp.bfloat16))
    losses, _ = _train(cfg, TL.init_params(cfg, seed=4, device="cpu"), 8)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses


def test_num_params_matches_leaves():
    for kw in (dict(), dict(tie_word_embeddings=True),
               dict(moe_num_experts=4)):
        jcfg = tiny_cfg(**kw)
        cfg = config_from_jax(jcfg)
        n = sum(p.numel() for p in TL._leaves(
            TL.init_params(cfg, device="cpu")))
        assert n == TL.num_params(cfg) == JL.num_params(jcfg)


def test_row_position_tables_match_jax():
    pos = np.array([[0, 1, 2, 0, 1, 2, 3, 4], [5, 6, 0, 1, 2, 3, 4, 5]],
                   np.int32)
    mk = jax.vmap(lambda p: jax_rope_cos_sin(8, 16, 500.0, position_ids=p))
    jc, js = mk(jnp.asarray(pos))
    tc, ts = rope_cos_sin(8, 16, 500.0, position_ids=torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_ce_chunks_must_divide_tokens():
    jcfg, tcfg, jp, tp = _setup(0, ce_chunks=3)
    ids, labels, *_ = _batch(0)
    with pytest.raises(ValueError, match="ce_chunks") as want:
        JL.loss_fn(jp, jnp.asarray(ids), jnp.asarray(labels), jcfg)
    with pytest.raises(ValueError, match="ce_chunks") as got:
        TL.loss_fn(tp, torch.from_numpy(ids), torch.from_numpy(labels), tcfg)
    assert str(got.value) == str(want.value)


def test_config_from_jax_carries_training_fields():
    cfg = config_from_jax(tiny_cfg(use_kernels=True, remat=True,
                                   remat_policy="nothing", ce_chunks=4,
                                   dtype=jnp.bfloat16))
    assert (cfg.use_kernels, cfg.remat, cfg.remat_policy, cfg.ce_chunks,
            cfg.dtype) == (True, True, "nothing", 4, torch.bfloat16)


@pytest.mark.parametrize("field,value", [("sep_axis", "sep"),
                                         ("ep_axis", "ep"),
                                         ("tp_axis", "tp")])
def test_config_from_jax_refuses_unported_fields(field, value):
    with pytest.raises(ValueError, match=field):
        config_from_jax(tiny_cfg(**{field: value}))


@pytest.mark.parametrize("change,what", [
    (dict(sep_axis="sep"), "sep_axis"),
])
def test_unported_paths_raise(change, what):
    _, tcfg, _, tp = _setup(0)
    cfg = dataclasses.replace(tcfg, **change)
    ids, labels, *_ = _batch(0)
    with pytest.raises(NotImplementedError, match=what):
        TL.loss_fn(tp, torch.from_numpy(ids), torch.from_numpy(labels), cfg)


def test_unknown_remat_policy_and_sentinel():
    _, tcfg, _, tp = _setup(0)
    ids, labels, *_ = _batch(0)
    with pytest.raises(ValueError, match="unknown remat_policy") as got:
        TL.forward(tp, torch.from_numpy(ids),
                   dataclasses.replace(tcfg, remat=True, remat_policy="x"))
    with pytest.raises(ValueError) as want:
        JL._remat_policy("x")
    assert str(got.value) == str(want.value)
    init_opt, step = TL.make_train_step(tcfg, sentinel=True)
    assert step.__name__ == "train_step_sentinel"
