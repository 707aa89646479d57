"""Optimizer update rules — counterpart of ``paddle_tpu/optimizer/ops.py``
(the optimizer ops of Paddle's ``ops.yaml``: ``sgd_``, ``momentum_``,
``adam_``, ``adamw_``, ``adamax_``, ``adagrad_``, ``rmsprop_``,
``adadelta_``, ``lamb_``, ``lars_momentum_``, ``ftrl``,
``proximal_adagrad``, ``proximal_gd``, ``decayed_adagrad``,
``sparse_momentum``, ``dgc_momentum``, ``nadam_``, ``radam_``).

Upstream each op is a CUDA kernel that mutates the parameter and its
state in place; here, as in the reference, each ``*_update`` is a pure
function ``(param, grad, *state) -> (new_param, *new_state)`` on Tensors,
registered under the reference's name. The rules that a class of
``optimizer.py`` also applies (``_sgd`` ... ``_lamb``) are written once,
here, on torch values: the class and the ``*_update`` op both call them.
"""

from __future__ import annotations

import torch

from ..core.dispatch import register_op
from ..ops._helpers import ensure_tensor, forward_op

__all__ = [
    "adadelta_update", "adamax_update", "ftrl_update", "lamb_update",
    "lars_momentum_update", "proximal_adagrad_update", "proximal_gd_update",
    "decayed_adagrad_update", "sparse_momentum_update", "dgc_momentum_update",
    "sgd_update", "momentum_update", "adagrad_update", "rmsprop_update",
    "adam_update", "adamw_update", "nadam_update", "radam_update",
]


# -- the rules the optimizer classes share (torch values) ---------------------

def _sgd(p, g, lr):
    return p - lr * g


def _momentum(p, g, v, lr, mu, nesterov):
    v2 = mu * v + g
    return p - lr * (g + mu * v2 if nesterov else v2), v2


def _adagrad(p, g, m, lr, eps):
    m2 = m + g * g
    return p - lr * g / (torch.sqrt(m2) + eps), m2


def _rmsprop(p, g, mom, ms, lr, rho, eps, momentum, mg=None):
    """RMSProp; centered when ``mg`` (the mean gradient) is given. Returns
    (p, mom, ms, mg)."""
    ms2 = rho * ms + (1 - rho) * g * g
    denom = ms2
    if mg is not None:
        mg = rho * mg + (1 - rho) * g
        denom = denom - mg * mg
    mom2 = momentum * mom + lr * g / torch.sqrt(denom + eps)
    return p - mom2, mom2, ms2, mg


def _adam(p, g, m, v, b1p, b2p, lr, b1, b2, eps, vmax=None):
    """Adam with ``b1p`` / ``b2p`` the powers of this step (beta ** t);
    AMSGrad when ``vmax`` is given. Returns (p, m, v, vmax)."""
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * g * g
    if vmax is not None:
        vmax = torch.maximum(vmax, v2)
    vhat = (v2 if vmax is None else vmax) / (1 - b2p)
    return p - lr * (m2 / (1 - b1p)) / (torch.sqrt(vhat) + eps), m2, v2, vmax


def _adamax(p, g, m, u, b1p, lr, b1, b2, eps):
    m2 = b1 * m + (1 - b1) * g
    u2 = torch.maximum(b2 * u, torch.abs(g))
    return p - lr / (1 - b1p) * m2 / (u2 + eps), m2, u2


def _adadelta(p, g, eg, ex, lr, rho, eps):
    eg2 = rho * eg + (1 - rho) * g * g
    upd = torch.sqrt(ex + eps) / torch.sqrt(eg2 + eps) * g
    ex2 = rho * ex + (1 - rho) * upd * upd
    return p - lr * upd, eg2, ex2


def _lamb(p, g, m, v, b1p, b2p, lr, b1, b2, eps, wd):
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * g * g
    r = (m2 / (1 - b1p)) / (torch.sqrt(v2 / (1 - b2p)) + eps) + wd * p
    w_norm = torch.linalg.vector_norm(p)
    r_norm = torch.linalg.vector_norm(r)
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    return p - lr * trust * r, m2, v2


# -- the ops ------------------------------------------------------------------

def _op(name, impl, tensors):
    return forward_op(name, impl, [ensure_tensor(t) for t in tensors],
                      differentiable=False)


def adadelta_update(param, grad, avg_squared_grad, avg_squared_update,
                    rho: float = 0.95, epsilon: float = 1e-6,
                    learning_rate: float = 1.0, name=None):
    """Adadelta rule (ref: adadelta_ op): accumulate E[g^2], scale by
    RMS(Δx)/RMS(g)."""
    return _op("adadelta_update",
               lambda p, g, eg, ex: _adadelta(p, g, eg, ex, learning_rate,
                                              rho, epsilon),
               [param, grad, avg_squared_grad, avg_squared_update])


def adamax_update(param, grad, moment, inf_norm, beta1_pow,
                  learning_rate: float = 0.001, beta1: float = 0.9,
                  beta2: float = 0.999, epsilon: float = 1e-8, name=None):
    """Adamax rule (ref: adamax_ op): infinity-norm second moment."""
    return _op("adamax_update",
               lambda p, g, m, u, b1p: _adamax(
                   p, g, m, u, b1p, learning_rate, beta1, beta2, epsilon)
               + (b1p * beta1,),
               [param, grad, moment, inf_norm, beta1_pow])


def ftrl_update(param, grad, squared_accum, linear_accum,
                learning_rate: float = 0.01, l1: float = 0.0,
                l2: float = 0.0, lr_power: float = -0.5, name=None):
    """FTRL-proximal rule (ref: ftrl op, the CTR workhorse)."""
    def impl(p, g, sq, lin):
        new_sq = sq + g * g
        sigma = (new_sq ** (-lr_power) - sq ** (-lr_power)) / learning_rate
        new_lin = lin + g - sigma * p
        pre = torch.clamp(new_lin, -l1, l1) - new_lin
        denom = new_sq ** (-lr_power) / learning_rate + 2 * l2
        return pre / denom, new_sq, new_lin
    return _op("ftrl_update", impl, [param, grad, squared_accum,
                                     linear_accum])


def lamb_update(param, grad, moment1, moment2, beta1_pow, beta2_pow,
                learning_rate: float = 0.001, beta1: float = 0.9,
                beta2: float = 0.999, epsilon: float = 1e-6,
                weight_decay: float = 0.01, name=None):
    """LAMB rule (ref: lamb_ op): Adam direction with layerwise trust
    ratio."""
    return _op("lamb_update",
               lambda p, g, m, v, b1p, b2p: _lamb(
                   p, g, m, v, b1p, b2p, learning_rate, beta1, beta2,
                   epsilon, weight_decay) + (b1p * beta1, b2p * beta2),
               [param, grad, moment1, moment2, beta1_pow, beta2_pow])


def lars_momentum_update(param, grad, velocity, learning_rate: float = 0.001,
                         mu: float = 0.9, lars_coeff: float = 0.001,
                         lars_weight_decay: float = 0.0005,
                         epsilon: float = 0.0, name=None):
    """LARS rule (ref: lars_momentum_ op): local LR scaled by
    ||w||/||g||."""
    def impl(p, g, v):
        w_norm = torch.linalg.vector_norm(p)
        g_norm = torch.linalg.vector_norm(g)
        local = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lars_coeff * w_norm /
            (g_norm + lars_weight_decay * w_norm + epsilon),
            torch.ones_like(w_norm))
        v2 = mu * v + local * learning_rate * (g + lars_weight_decay * p)
        return p - v2, v2
    return _op("lars_momentum_update", impl, [param, grad, velocity])


def _soft_threshold(pro, lr, l1, l2):
    return torch.sign(pro) * torch.clamp(torch.abs(pro) - lr * l1, min=0) / \
        (1.0 + lr * l2)


def proximal_adagrad_update(param, grad, moment,
                            learning_rate: float = 0.01, l1: float = 0.0,
                            l2: float = 0.0, name=None):
    """Proximal Adagrad rule (ref: proximal_adagrad op): adagrad step then
    soft-threshold."""
    def impl(p, g, m):
        m2 = m + g * g
        lr = learning_rate / torch.sqrt(m2)
        return _soft_threshold(p - lr * g, lr, l1, l2), m2
    return _op("proximal_adagrad_update", impl, [param, grad, moment])


def proximal_gd_update(param, grad, learning_rate: float = 0.01,
                       l1: float = 0.0, l2: float = 0.0, name=None):
    """Proximal gradient-descent rule (ref: proximal_gd op)."""
    return _op("proximal_gd_update",
               lambda p, g: _soft_threshold(p - learning_rate * g,
                                            learning_rate, l1, l2),
               [param, grad])


def decayed_adagrad_update(param, grad, moment, learning_rate: float = 0.01,
                           decay: float = 0.95, epsilon: float = 1e-6,
                           name=None):
    """Decayed Adagrad rule (ref: decayed_adagrad op)."""
    def impl(p, g, m):
        m2 = decay * m + (1 - decay) * g * g
        return p - learning_rate * g / (torch.sqrt(m2) + epsilon), m2
    return _op("decayed_adagrad_update", impl, [param, grad, moment])


def sparse_momentum_update(param, grad, velocity, index, axis: int = 0,
                           learning_rate: float = 0.001, mu: float = 0.9,
                           name=None):
    """Momentum touching only the rows in ``index`` along ``axis`` (ref:
    sparse_momentum op — the SelectedRows update of the parameter-server
    embedding path)."""
    def impl(p, g, v, idx):
        idx = idx.long()
        v_rows = mu * torch.index_select(v, axis, idx) + g
        p_rows = torch.index_select(p, axis, idx) - learning_rate * v_rows
        return p.index_copy(axis, idx, p_rows), v.index_copy(axis, idx, v_rows)
    return _op("sparse_momentum_update", impl,
               [param, grad, velocity, index])


def dgc_momentum_update(param, grad, velocity, accum_grad,
                        learning_rate: float = 0.001, mu: float = 0.9,
                        sparsity: float = 0.75, name=None):
    """Deep-gradient-compression momentum (ref: dgc_momentum_op): momentum
    correction on the locally-accumulated gradient, the top (1 - sparsity)
    of its entries applied, the rest accumulated again."""
    def impl(p, g, v, acc):
        v2 = mu * v + g
        u = acc + v2
        flat = torch.abs(u).reshape(-1)
        k = max(1, int(flat.shape[0] * (1 - sparsity)))
        thresh = torch.sort(flat).values[-k]
        mask = torch.abs(u) >= thresh
        zero = torch.zeros_like(u)
        return (p - learning_rate * torch.where(mask, u, zero), v2 * 0.0,
                torch.where(mask, zero, u))
    return _op("dgc_momentum_update", impl,
               [param, grad, velocity, accum_grad])


def sgd_update(param, grad, learning_rate: float = 0.01, name=None):
    """Plain SGD rule (ref: sgd_ op)."""
    return _op("sgd_update", lambda p, g: _sgd(p, g, learning_rate),
               [param, grad])


def momentum_update(param, grad, velocity, learning_rate: float = 0.01,
                    mu: float = 0.9, use_nesterov: bool = False, name=None):
    """(Nesterov) momentum rule (ref: momentum_ op)."""
    return _op("momentum_update",
               lambda p, g, v: _momentum(p, g, v, learning_rate, mu,
                                         use_nesterov),
               [param, grad, velocity])


def adagrad_update(param, grad, moment, learning_rate: float = 0.01,
                   epsilon: float = 1e-6, name=None):
    """Adagrad rule (ref: adagrad_ op)."""
    return _op("adagrad_update",
               lambda p, g, m: _adagrad(p, g, m, learning_rate, epsilon),
               [param, grad, moment])


def rmsprop_update(param, grad, moment, mean_square,
                   learning_rate: float = 0.01, rho: float = 0.95,
                   epsilon: float = 1e-6, momentum: float = 0.0, name=None):
    """RMSProp rule (ref: rmsprop_ op)."""
    return _op("rmsprop_update",
               lambda p, g, m, ms: _rmsprop(p, g, m, ms, learning_rate, rho,
                                            epsilon, momentum)[:3],
               [param, grad, moment, mean_square])


def adam_update(param, grad, moment1, moment2, beta1_pow, beta2_pow,
                learning_rate: float = 0.001, beta1: float = 0.9,
                beta2: float = 0.999, epsilon: float = 1e-8, name=None):
    """Adam rule (ref: adam_ op)."""
    return _op("adam_update",
               lambda p, g, m, v, b1p, b2p: _adam(
                   p, g, m, v, b1p, b2p, learning_rate, beta1, beta2,
                   epsilon)[:3] + (b1p * beta1, b2p * beta2),
               [param, grad, moment1, moment2, beta1_pow, beta2_pow])


def adamw_update(param, grad, moment1, moment2, beta1_pow, beta2_pow,
                 learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01, name=None):
    """AdamW rule (decoupled decay; ref: adamw_ op)."""
    return _op("adamw_update",
               lambda p, g, m, v, b1p, b2p: _adam(
                   p * (1 - learning_rate * weight_decay), g, m, v, b1p, b2p,
                   learning_rate, beta1, beta2, epsilon)[:3]
               + (b1p * beta1, b2p * beta2),
               [param, grad, moment1, moment2, beta1_pow, beta2_pow])


def nadam_update(param, grad, moment1, moment2, beta1_pow, beta2_pow,
                 learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, name=None):
    """NAdam rule (Nesterov Adam; ref: nadam_ op)."""
    def impl(p, g, m, v, b1p, b2p):
        m2 = beta1 * m + (1 - beta1) * g
        v2 = beta2 * v + (1 - beta2) * g * g
        mh = (beta1 * m2 + (1 - beta1) * g) / (1 - b1p * beta1)
        vh = v2 / (1 - b2p)
        return (p - learning_rate * mh / (torch.sqrt(vh) + epsilon),
                m2, v2, b1p * beta1, b2p * beta2)
    return _op("nadam_update", impl, [param, grad, moment1, moment2,
                                      beta1_pow, beta2_pow])


def radam_update(param, grad, moment1, moment2, beta1_pow, beta2_pow,
                 step, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, name=None):
    """RAdam rule (rectified Adam; ref: radam_ op)."""
    def impl(p, g, m, v, b1p, b2p, t):
        m2 = beta1 * m + (1 - beta1) * g
        v2 = beta2 * v + (1 - beta2) * g * g
        mh = m2 / (1 - b1p)
        rho_inf = 2 / (1 - beta2) - 1
        rho_t = rho_inf - 2 * t * b2p * beta2 / (1 - b2p * beta2)
        vh = torch.sqrt(v2 / (1 - b2p * beta2))
        r = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf) /
                       torch.clamp((rho_inf - 4) * (rho_inf - 2) * rho_t,
                                   min=1e-12))
        upd = torch.where(rho_t > 5.0, r * mh / (vh + epsilon), mh)
        return (p - learning_rate * upd, m2, v2, b1p * beta1, b2p * beta2)
    return _op("radam_update", impl, [param, grad, moment1, moment2,
                                      beta1_pow, beta2_pow, step])


for _n in __all__:
    _f = globals()[_n]
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                differentiable=False, category="optimizer", public=_f)
