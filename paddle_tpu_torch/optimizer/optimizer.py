"""Optimizer base + concrete optimizers — counterpart of
``paddle_tpu/optimizer/optimizer.py`` (``python/paddle/optimizer/`` in
Paddle): the Optimizer base with accumulators, ``step`` / ``clear_grad`` /
``minimize``, gradient clipping, the regularizer folded into the gradient,
the LR-scheduler hook and ``multi_precision`` fp32 master weights;
accumulators are Tensors keyed by parameter name (Paddle's convention,
and the ``state_dict`` keys the reference writes).

Each update is the reference's formula in torch operations; the rules
that ``optimizer.ops`` also exposes as ``*_update`` ops are written once,
there (``ops._sgd`` ... ``ops._lamb``). ``step`` runs
under ``no_grad`` and writes each parameter in place (``copy_`` into the
leaf's storage), so parameter memory stays flat; nothing autograd saved
is a parameter written this way once the step's backward has run.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch

from ..core.tensor import Parameter, Tensor, _wrap, as_torch
from ..core import autograd
from . import ops as R
from .lr import LRScheduler


def _full(shape, fill_value, dtype, device) -> Tensor:
    return _wrap(torch.full(tuple(shape), fill_value, dtype=dtype,
                            device=device))


def _as_value(v, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A state value (Tensor, torch tensor, numpy, scalar) as a torch
    tensor, on ``like``'s device and in its dtype when given."""
    t = as_torch(v, device=None if like is None else like.device) \
        if not isinstance(v, (Tensor, torch.Tensor)) else as_torch(v)
    if like is not None:
        t = t.to(device=like.device, dtype=like.dtype)
    return t.detach().clone()


class Optimizer:
    # the update is elementwise, so it runs on any slice of a parameter
    # (a distributed or ZeRO-sharded update runs per mesh coordinate)
    _elementwise = True

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        self._lr = learning_rate
        self._parameter_list = list(parameters) if parameters is not None else None
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision
        self._accumulators: Dict[str, Dict[str, Tensor]] = defaultdict(dict)
        self._master_weights: Dict[str, Tensor] = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------------
    def _lr_value(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def get_lr(self):
        return self._lr_value()

    def _step_lr(self):
        """The lr one ``step`` applies: inside a captured program
        (``jit/trace.py``) a device scalar the program refills before every
        replay — a float would be baked into the graph, and a scheduler's
        later lr would never reach it — else the host value."""
        from ..jit.trace import current_ctx
        ctx = current_ctx()
        if ctx is None:
            return self._lr_value()
        return ctx.host_scalar(("lr", id(self)), self._lr_value)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler):
        self._lr = scheduler

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name: str, param: Tensor, fill_value=0.0, dtype=None,
                         shape=None):
        store = self._accumulators[name]
        if param.name not in store:
            pending = getattr(self, "_pending_state", None)
            key = f"{param.name}_{name}"
            dt = dtype or (torch.float32 if self._multi_precision
                           else param.dtype)
            layout = self._layout(param)
            if layout is not None:     # laid out like the parameter's update
                from ..distributed.dist_tensor import state_tensor
                t = state_tensor(param, layout, fill_value, dt, shape)
                if pending and key in pending:
                    t.set_value(as_torch(pending.pop(key)))
            else:
                shp = shape if shape is not None else param._value.shape
                t = _full(shp, fill_value, dt, param._value.device)
                if pending and key in pending:
                    t._value = _as_value(pending.pop(key), t._value)
            t._acc_init = float(fill_value)   # a skipped first step's fill
            store[param.name] = t
        return store[param.name]

    def _get_accumulator(self, name: str, param: Tensor) -> Tensor:
        return self._accumulators[name][param.name]

    def _master(self, p: Parameter):
        """fp32 master weight for low-precision params (ref: multi_precision /
        master_weights in paddle optimizers + amp O2)."""
        if not self._multi_precision or p.dtype == torch.float32:
            return None
        if p.name not in self._master_weights:
            layout = self._layout(p)
            if layout is not None:
                from ..distributed.dist_tensor import state_tensor
                self._master_weights[p.name] = state_tensor(p, layout,
                                                            master=True)
            else:
                self._master_weights[p.name] = _wrap(
                    p._value.detach().to(torch.float32))
            # a skipped first step re-derives it from the rolled-back param
            self._master_weights[p.name]._master_of = p
        return self._master_weights[p.name]

    # -- the step ------------------------------------------------------------
    def _params(self) -> List[Parameter]:
        if self._parameter_list is None:
            raise ValueError("optimizer constructed without parameters")
        flat = []
        for p in self._parameter_list:
            if isinstance(p, dict):  # param group
                flat.extend(p["params"])
            else:
                flat.append(p)
        return flat

    @autograd.no_grad()
    def step(self):
        params_grads = [(p, g) for p in self._params() if not p.stop_gradient
                        for g in (p.grad,) if g is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self._step_lr()
        self._step_count += 1
        for p, g in params_grads:
            scale = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
            param_lr = lr if scale == 1.0 else lr * scale
            layout = self._layout(p)
            if layout is not None:
                from ..distributed.dist_tensor import laid_out_step
                laid_out_step(self, p, g, param_lr, layout)
                continue
            new_base = self._update_value(p, p._value, g._value, param_lr)
            p._value.copy_(new_base.to(p._value.dtype))
            p._version += 1

    def _update_value(self, p, value, g_val, lr):
        """The new value of ``value`` (the parameter, or its slice) from
        the gradient ``g_val``: the regularizer folded in, the update on the
        master weight when there is one."""
        wd, l1 = self._decay_value(p)
        if wd:  # fold into gradient (paddle regularizer semantics)
            pv = value.to(g_val.dtype)
            g_val = g_val + wd * (torch.sign(pv) if l1 else pv)
        master = self._master(p)
        base = master._value if master is not None else value
        new_base = self._apply_one(p, base, g_val.to(base.dtype), lr)
        if master is not None:
            master._value = new_base
        return new_base

    def _layout(self, p):
        """The mesh layout ``(mesh, spec)`` of ``p``'s optimizer state when
        ``p`` is distributed or the states are sharded (ZeRO stage 1), else
        None (the serial update)."""
        if not (getattr(p, "is_distributed", False) or
                getattr(self, "_sharding_axis", None)):
            return None
        from ..distributed.dist_tensor import state_layout
        return state_layout(self, p)

    def _decay_value(self, p):
        """Returns (coeff, is_l1). Per-param regularizer wins over the optimizer's
        weight_decay (paddle semantics)."""
        from ..regularizer import L1Decay

        reg = getattr(p, "regularizer", None)
        if reg is not None:
            return float(getattr(reg, "coeff", 0.0)), isinstance(reg, L1Decay)
        wd = self._weight_decay
        if wd is None:
            return 0.0, False
        if hasattr(wd, "coeff"):
            return float(wd.coeff), isinstance(wd, L1Decay)
        return float(wd), False

    def _apply_one(self, p, value, grad, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._params():
            p.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        from ..static import in_static_mode
        if in_static_mode():
            # the static workflow: the Program's replay ends with backward
            # and this optimizer's update (the append_backward contract)
            from ..static.program import default_main_program
            default_main_program().train_spec = (self, loss)
            return None, []
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._params()]

    def fuse(self, model, loss_fn, **kwargs):
        """The fused train step over this optimizer
        (``jit.train_step.TrainStep``: forward, backward and this update as
        one captured program)."""
        from ..jit.train_step import TrainStep
        return TrainStep(model, self, loss_fn, **kwargs)

    # -- state dict ----------------------------------------------------------
    def state_dict(self) -> Dict:
        out = {}
        for acc_name, store in self._accumulators.items():
            for pname, t in store.items():
                out[f"{pname}_{acc_name}"] = t
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        out["@step"] = _wrap(torch.tensor(float(self._step_count)))
        if self._master_weights:
            out["master_weights"] = dict(self._master_weights)
        return out

    def set_state_dict(self, state: Dict):
        def _restore(cur: Optional[Tensor], v: Any) -> Tensor:
            """Restore into the existing Tensor when the shapes match (its
            identity kept), else a new Tensor of the value."""
            if cur is not None and tuple(as_torch(v).shape) == tuple(cur.shape):
                cur._value = _as_value(v, cur._value)
                cur._version += 1
                return cur
            return _wrap(_as_value(v))

        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        if "@step" in state:
            v = state["@step"]
            self._step_count = int(v.item() if hasattr(v, "item") else v)
        mw = state.get("master_weights", {})
        for k, v in mw.items():
            self._master_weights[k] = _restore(self._master_weights.get(k), v)
        for acc_name, store in list(self._accumulators.items()):
            for pname in list(store):
                key = f"{pname}_{acc_name}"
                if key in state:
                    store[pname] = _restore(store[pname], state[key])
        # keys for accumulators not yet created are applied lazily
        self._pending_state = {k: v for k, v in state.items()
                               if k not in ("LR_Scheduler", "@step", "master_weights")}

class SGD(Optimizer):
    """ref: python/paddle/optimizer/sgd.py"""

    def _apply_one(self, p, value, grad, lr):
        return R._sgd(value, grad, lr)


class Momentum(Optimizer):
    """ref: python/paddle/optimizer/momentum.py (use_nesterov supported)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _apply_one(self, p, value, grad, lr):
        vel = self._add_accumulator("velocity", p, dtype=value.dtype)
        new, vel._value = R._momentum(value, grad, vel._value, lr,
                                      self._momentum, self._nesterov)
        return new


class Adam(Optimizer):
    """ref: python/paddle/optimizer/adam.py"""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, use_multi_tensor=False, name=None,
                 amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._amsgrad = amsgrad

    def _beta(self, b):
        return float(b.item()) if isinstance(b, Tensor) else float(b)

    def _apply_one(self, p, value, grad, lr):
        b1, b2 = self._beta(self._beta1), self._beta(self._beta2)
        m = self._add_accumulator("moment1", p, dtype=value.dtype)
        v = self._add_accumulator("moment2", p, dtype=value.dtype)
        b1p = self._add_accumulator("beta1_pow_acc", p, fill_value=1.0,
                                    dtype=torch.float32, shape=())
        b2p = self._add_accumulator("beta2_pow_acc", p, fill_value=1.0,
                                    dtype=torch.float32, shape=())
        b1p._value = b1p._value * b1
        b2p._value = b2p._value * b2
        vmax = self._add_accumulator("moment2_max", p, dtype=value.dtype) \
            if self._amsgrad else None
        new, m._value, v._value, vm = R._adam(
            value, grad, m._value, v._value, b1p._value, b2p._value, lr, b1,
            b2, self._eps, None if vmax is None else vmax._value)
        if vmax is not None:
            vmax._value = vm
        return new


class AdamW(Adam):
    """Decoupled weight decay (ref: python/paddle/optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None, amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name, amsgrad=amsgrad)
        self._wd = weight_decay
        self._apply_decay_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decay_value(self, p):
        return 0.0, False  # decay handled decoupled in _apply_one

    def _apply_one(self, p, value, grad, lr):
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        wd = self._wd if not hasattr(self._wd, "coeff") else self._wd.coeff
        if self._apply_decay_fun is None or self._apply_decay_fun(p.name):
            value = value * (1.0 - lr * float(wd))
        return super()._apply_one(p, value, grad, lr)


class Adamax(Optimizer):
    """ref: python/paddle/optimizer/adamax.py"""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _apply_one(self, p, value, grad, lr):
        m = self._add_accumulator("moment", p, dtype=value.dtype)
        u = self._add_accumulator("inf_norm", p, dtype=value.dtype)
        b1p = self._add_accumulator("beta1_pow_acc", p, fill_value=1.0,
                                    dtype=torch.float32, shape=())
        b1p._value = b1p._value * self._beta1
        new, m._value, u._value = R._adamax(
            value, grad, m._value, u._value, b1p._value, lr, self._beta1,
            self._beta2, self._eps)
        return new


class Adagrad(Optimizer):
    """ref: python/paddle/optimizer/adagrad.py"""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _apply_one(self, p, value, grad, lr):
        acc = self._add_accumulator("moment", p, fill_value=self._init_acc,
                                    dtype=value.dtype)
        new, acc._value = R._adagrad(value, grad, acc._value, lr, self._eps)
        return new


class RMSProp(Optimizer):
    """ref: python/paddle/optimizer/rmsprop.py"""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _apply_one(self, p, value, grad, lr):
        ms = self._add_accumulator("mean_square", p, dtype=value.dtype)
        mom = self._add_accumulator("momentum", p, dtype=value.dtype)
        mg = self._add_accumulator("mean_grad", p, dtype=value.dtype) \
            if self._centered else None
        new, mom._value, ms._value, g_mean = R._rmsprop(
            value, grad, mom._value, ms._value, lr, self._rho, self._eps,
            self._momentum, None if mg is None else mg._value)
        if mg is not None:
            mg._value = g_mean
        return new


class Lamb(Optimizer):
    """ref: python/paddle/optimizer/lamb.py"""

    _elementwise = False    # the trust ratio takes whole-parameter norms

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _apply_one(self, p, value, grad, lr):
        m = self._add_accumulator("moment1", p, dtype=value.dtype)
        v = self._add_accumulator("moment2", p, dtype=value.dtype)
        b1p = self._add_accumulator("beta1_pow_acc", p, fill_value=1.0,
                                    dtype=torch.float32, shape=())
        b2p = self._add_accumulator("beta2_pow_acc", p, fill_value=1.0,
                                    dtype=torch.float32, shape=())
        b1p._value = b1p._value * self._beta1
        b2p._value = b2p._value * self._beta2
        wd = 0.0 if (self._exclude_fn is not None and self._exclude_fn(p)) \
            else self._lamb_wd
        new, m._value, v._value = R._lamb(
            value, grad, m._value, v._value, b1p._value, b2p._value, lr,
            self._beta1, self._beta2, self._eps, wd)
        return new


class Adadelta(Optimizer):
    """ref: python/paddle/optimizer/adadelta.py (accumulated squared grads +
    squared updates, rho-averaged)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._eps = epsilon
        self._rho = rho

    def _apply_one(self, p, value, grad, lr):
        avg_sq_g = self._add_accumulator("avg_squared_grad", p,
                                         dtype=value.dtype)
        avg_sq_u = self._add_accumulator("avg_squared_update", p,
                                         dtype=value.dtype)
        new, avg_sq_g._value, avg_sq_u._value = R._adadelta(
            value, grad, avg_sq_g._value, avg_sq_u._value, lr, self._rho,
            self._eps)
        return new


class Rprop(Optimizer):
    """ref: python/paddle/optimizer/rprop.py (sign-based resilient prop)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _apply_one(self, p, value, grad, lr):
        prev = self._add_accumulator("prev_grad", p, dtype=value.dtype)
        step_sz = self._add_accumulator("learning_rate_step", p,
                                        fill_value=float(self._lr_value()),
                                        dtype=value.dtype)
        sign = torch.sign(grad * prev._value)
        one = torch.ones_like(sign)
        factor = torch.where(sign > 0, self._eta_pos * one,
                             torch.where(sign < 0, self._eta_neg * one, one))
        new_step = torch.clamp(step_sz._value * factor, self._lr_min,
                               self._lr_max)
        # on sign change the pending gradient is zeroed (classic Rprop-)
        g_eff = torch.where(sign < 0, torch.zeros_like(grad), grad)
        step_sz._value = new_step
        prev._value = g_eff
        return value - torch.sign(g_eff) * new_step


class NAdam(Optimizer):
    """ref: python/paddle/optimizer/nadam.py (Adam + Nesterov momentum
    schedule mu_t = b1*(1 - 0.5*0.96^(t*psi)))."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _apply_one(self, p, value, grad, lr):
        m = self._add_accumulator("momentum", p, dtype=value.dtype)
        v = self._add_accumulator("moment2", p, dtype=value.dtype)
        mu_prod = self._add_accumulator("mu_product", p, fill_value=1.0,
                                        dtype=torch.float32, shape=())
        t_acc = self._add_accumulator("t", p, fill_value=0.0,
                                      dtype=torch.float32, shape=())
        t_acc._value = t_acc._value + 1.0
        t = t_acc._value
        mu_t = self._b1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = self._b1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        mu_prod._value = mu_prod._value * mu_t
        m._value = self._b1 * m._value + (1 - self._b1) * grad
        v._value = self._b2 * v._value + (1 - self._b2) * torch.square(grad)
        mhat = (mu_t1 * m._value / (1 - mu_prod._value * mu_t1)
                + (1 - mu_t) * grad / (1 - mu_prod._value))
        vhat = v._value / (1 - self._b2 ** t)
        return value - lr * mhat / (torch.sqrt(vhat) + self._eps)


class RAdam(Optimizer):
    """ref: python/paddle/optimizer/radam.py (rectified Adam: SGD-with-
    momentum warmup until the variance rectification term is defined)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon

    def _apply_one(self, p, value, grad, lr):
        m = self._add_accumulator("moment1", p, dtype=value.dtype)
        v = self._add_accumulator("moment2", p, dtype=value.dtype)
        t_acc = self._add_accumulator("t", p, fill_value=0.0,
                                      dtype=torch.float32, shape=())
        t_acc._value = t_acc._value + 1.0
        t = t_acc._value
        m._value = self._b1 * m._value + (1 - self._b1) * grad
        v._value = self._b2 * v._value + (1 - self._b2) * torch.square(grad)
        mhat = m._value / (1 - self._b1 ** t)
        rho_inf = 2 / (1 - self._b2) - 1
        rho_t = rho_inf - 2 * t * self._b2 ** t / (1 - self._b2 ** t)
        safe_rho = torch.clamp(rho_t, min=4.0 + 1e-3)
        r = torch.sqrt(((safe_rho - 4) * (safe_rho - 2) * rho_inf)
                     / ((rho_inf - 4) * (rho_inf - 2) * safe_rho))
        vhat = torch.sqrt(v._value / (1 - self._b2 ** t))
        rect = value - lr * r * mhat / (vhat + self._eps)
        warm = value - lr * mhat
        return torch.where(rho_t > 5.0, rect, warm)


class ASGD(Optimizer):
    """ref: python/paddle/optimizer/asgd.py (averaged SGD: the d/y/ys
    recursion over a window of n steps)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._n = max(1, int(batch_num))

    def _apply_one(self, p, value, grad, lr):
        d = self._add_accumulator("d", p, dtype=value.dtype)
        ys = self._add_accumulator("ys", p,
                                   shape=(self._n,) + tuple(value.shape),
                                   dtype=value.dtype)
        t_acc = self._add_accumulator("t", p, fill_value=0.0,
                                      dtype=torch.float32, shape=())
        t_acc._value = t_acc._value + 1.0
        idx = (int(t_acc._value.item()) - 1) % self._n
        y_old = ys._value[idx]
        d._value = d._value - y_old + grad
        ys._value = ys._value.clone()
        ys._value[idx] = grad.to(ys._value.dtype)
        m = torch.clamp(t_acc._value, max=float(self._n))
        return value - lr * d._value / m


class LBFGS(Optimizer):
    """ref: python/paddle/optimizer/lbfgs.py — limited-memory BFGS with the
    closure API: ``step(closure)`` re-evaluates the loss (closure must call
    ``backward()``). Two-loop recursion over a curvature history; step length
    by backtracking Armijo line search (the reference's strong_wolfe is
    approximated by backtracking — documented divergence)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = int(max_iter)
        self._tol_grad = float(tolerance_grad)
        self._tol_change = float(tolerance_change)
        self._history = int(history_size)
        self._line_search = line_search_fn  # None or "strong_wolfe"
        self._s, self._y = [], []
        self._prev_flat_g = None

    def _flat(self, vals):
        return torch.cat([v.reshape(-1) for v in vals])

    @autograd.no_grad()
    def _assign_flat(self, flat):
        ofs = 0
        for p in self._params():
            n = p._value.numel()
            p._value.copy_(flat[ofs:ofs + n].reshape(p._value.shape))
            p._version += 1
            ofs += n

    def _gather(self):
        ps = self._params()
        flat_w = self._flat([p._value.detach().float() for p in ps])
        flat_g = self._flat([
            (p.grad._value if p.grad is not None
             else torch.zeros_like(p._value)).detach().float() for p in ps])
        return flat_w, flat_g

    def _direction(self, g):
        # two-loop recursion
        q = g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if self._y:
            y_last, s_last = self._y[-1], self._s[-1]
            gamma = torch.dot(s_last, y_last) / torch.clamp(
                torch.dot(y_last, y_last), min=1e-10)
            q = q * gamma
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return -q

    def step(self, closure):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure that recomputes "
                             "the loss and calls backward()")
        loss = closure()
        self._step_count += 1
        w, g = self._gather()
        if float(torch.abs(g).max()) <= self._tol_grad:
            return loss
        for _ in range(self._max_iter):
            d = self._direction(g)
            lr = self._lr_value()
            # backtracking Armijo
            f0 = float(loss)
            gtd = float(torch.dot(g, d))
            t = lr
            for _ls in range(10):
                self._assign_flat(w + t * d)
                self.clear_grad()
                loss = closure()
                if float(loss) <= f0 + 1e-4 * t * gtd:
                    break
                t *= 0.5
            w_new, g_new = self._gather()
            s, yv = w_new - w, g_new - g
            if float(torch.dot(s, yv)) > 1e-10:
                self._s.append(s)
                self._y.append(yv)
                if len(self._s) > self._history:
                    self._s.pop(0)
                    self._y.pop(0)
            if float(torch.abs(g_new).max()) <= self._tol_grad or \
                    float(torch.abs(s).max()) <= self._tol_change:
                w, g = w_new, g_new
                break
            w, g = w_new, g_new
        return loss
