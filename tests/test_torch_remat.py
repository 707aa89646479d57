"""The port's named remat policies (``paddle_tpu_torch.models.llama``,
``cfg.remat_policy``) against the JAX package's.

Every policy computes the same function, so a gradient test alone cannot
show that a policy was honoured: two oracles.

* Numerics: for each of the nine policy values (``None``, ``"nothing"``
  and the seven names), with ``use_kernels`` on and off, the port's loss
  and every gradient leaf equal ``jax.value_and_grad(loss_fn)`` under the
  same policy (fp32: loss rtol 1e-5, each leaf atol 1e-5 x its max|g|).
  With ``use_kernels`` the JAX side runs its Pallas flash kernels in
  interpret mode, the port its flash Function's plain CPU path.
* Counts: the flash forwards and the q/k/v projections a training step
  runs (forward and backward), counted by wrapping the flash forward's
  plain version and ``llama._mm``, equal what each JAX policy keeps and
  recomputes (``POLICY_COUNTS``, per layer: 1 = run once, 2 = run again
  in backward). The other GEMMs (``wo``, the FFN) are recorded, not held:
  ``torch.utils.checkpoint`` re-runs a whole region where JAX's recompute
  is dead-code-eliminated (ROADMAP.md section C).

The config is ``tests/test_llama.py``'s tiny one (vocab 97, hidden 32, 2
layers, 4 heads, 2 kv heads), weights from the JAX ``init_params``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as JL
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax

torch.set_num_threads(2)

FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

B, S, L = 2, 16, 2
POLICIES = (None, "nothing", "dots", "dots_saveable", "save_attn",
            "save_qkv_attn", "save_flash", "save_flash_qk",
            "save_flash_only")
# per layer and step, read from the JAX source with use_kernels=True:
# (flash forwards, wq, wk, wv runs)
POLICY_COUNTS = {
    None: (2, 2, 2, 2),
    "nothing": (2, 2, 2, 2),
    "dots": (2, 1, 1, 1),
    "dots_saveable": (2, 1, 1, 1),
    "save_attn": (2, 2, 2, 2),
    "save_qkv_attn": (2, 1, 1, 1),
    "save_flash": (1, 1, 1, 1),
    "save_flash_qk": (1, 1, 1, 2),
    "save_flash_only": (1, 2, 2, 2),
}


def _cfg(policy, use_kernels, **kw):
    base = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
                num_hidden_layers=L, num_attention_heads=4,
                num_key_value_heads=2, use_kernels=use_kernels, remat=True,
                remat_policy=policy)
    base.update(kw)
    return JL.LlamaConfig(**base)


def _batch(seed=0, vocab=97):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    return ids, labels


@pytest.fixture(scope="module")
def weights():
    jp = JL.init_params(_cfg(None, False), jax.random.PRNGKey(3))
    return jax.tree_util.tree_map(np.asarray, jp)


def _jax_value_and_grad(np_params, cfg, ids, labels):
    fn = jax.jit(jax.value_and_grad(
        lambda p, i, l: JL.loss_fn(p, i, l, cfg)))
    loss, grads = fn(jax.tree_util.tree_map(jnp.asarray, np_params),
                     jnp.asarray(ids), jnp.asarray(labels))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _port_value_and_grad(np_params, cfg, ids, labels):
    tp = params_from_jax(np_params, device="cpu")
    leaves = TL._leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = TL.loss_fn(tp, torch.from_numpy(ids), torch.from_numpy(labels),
                      cfg)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(g.numpy() for g in grads)
    return loss.item(), TL._tree_map(lambda _: next(it), tp)


def _assert_grads(got, want):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_grads(got[k], w)
            continue
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_policy_loss_and_grads_match_jax(weights, policy, use_kernels):
    jcfg = _cfg(policy, use_kernels)
    ids, labels = _batch(1)
    want_loss, want = _jax_value_and_grad(weights, jcfg, ids, labels)
    got_loss, got = _port_value_and_grad(weights, config_from_jax(jcfg),
                                         ids, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _assert_grads(got, want)


def _count_step(np_params, cfg, monkeypatch):
    """Run one loss + gradient; return the flash-forward calls and
    ``_mm`` calls by weight name."""
    calls = {"flash": 0}
    fwd, mm = FA.flash_attention_fwd_plain, TL._mm

    def counted_fwd(*a, **kw):
        calls["flash"] += 1
        return fwd(*a, **kw)

    def counted_mm(h, lp, name, dt):
        calls[name] = calls.get(name, 0) + 1
        return mm(h, lp, name, dt)

    monkeypatch.setattr(FA, "flash_attention_fwd_plain", counted_fwd)
    monkeypatch.setattr(TL, "_mm", counted_mm)
    _port_value_and_grad(np_params, cfg, *_batch(2))
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_policy_recompute_counts(weights, policy, use_kernels, monkeypatch):
    calls = _count_step(weights, config_from_jax(_cfg(policy, use_kernels)),
                        monkeypatch)
    flash, wq, wk, wv = POLICY_COUNTS[policy]
    assert (calls["wq"], calls["wk"], calls["wv"]) == \
        (wq * L, wk * L, wv * L), calls
    assert calls["flash"] == (flash * L if use_kernels else 0), calls
    # the output projection and the FFN run once in the forward and at
    # most once more in backward; the head once
    for name in ("wo", "w_gate", "w_up", "w_down"):
        assert calls[name] in (L, 2 * L), calls
    assert calls["lm_head"] == 1, calls


def test_dots_runs_tail_gemms_once(weights, monkeypatch):
    """``dots`` keeps every projection output: the output projection and
    the FFN GEMMs run once a step, as in JAX."""
    calls = _count_step(weights, config_from_jax(_cfg("dots", True)),
                        monkeypatch)
    assert all(calls[n] == L for n in ("wo", "w_gate", "w_up", "w_down"))


def test_save_flash_keeps_flash_residuals_and_not_q_k_v(weights):
    """Under ``save_flash_only`` the flash Function's saved tensors are
    the segment ids, ``out`` and ``lse``: q/k/v are rebuilt in backward."""
    cfg = config_from_jax(_cfg("save_flash_only", True))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    tp = params_from_jax(weights, device="cpu")
    for p in TL._leaves(tp):
        p.requires_grad_(True)
    ids, labels = _batch(0)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        q = torch.randn(B, S, 4, 8, requires_grad=True)
        k = torch.randn(B, S, 2, 8, requires_grad=True)
        v = torch.randn(B, S, 2, 8, requires_grad=True)
        out, lse = FA.flash_attention_with_lse(
            q, k, v, causal=True, regen_inputs=lambda: (q, k, v))
    assert saved == [tuple(out.shape), tuple(lse.shape)]
    out.sum().backward()
    assert q.grad is not None and v.grad is not None
    loss = TL.loss_fn(tp, torch.from_numpy(ids), torch.from_numpy(labels),
                      cfg)
    loss.backward()
    assert all(p.grad is not None for p in TL._leaves(tp))


def test_policy_moe_layers_match_jax():
    """The policies hold on MoE layers too: ``save_flash`` and
    ``dots`` on a 4-expert top-2 model against JAX (loss 1e-5, gradients
    1e-5 x max|g|)."""
    for policy in ("save_flash", "dots"):
        jcfg = _cfg(policy, True, moe_num_experts=4, moe_top_k=2,
                    moe_capacity_factor=2.0)
        np_params = jax.tree_util.tree_map(
            np.asarray, JL.init_params(jcfg, jax.random.PRNGKey(5)))
        ids, labels = _batch(3)
        want_loss, want = _jax_value_and_grad(np_params, jcfg, ids, labels)
        got_loss, got = _port_value_and_grad(np_params,
                                             config_from_jax(jcfg), ids,
                                             labels)
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
        _assert_grads(got, want)
