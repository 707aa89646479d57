"""LR schedulers — counterpart of ``paddle_tpu/optimizer/lr.py``
(``python/paddle/optimizer/lr.py`` in Paddle: the LRScheduler base with
get_lr/step/state_dict and the full scheduler family). Pure Python, as the
reference's."""

from __future__ import annotations

import math

__all__ = ["LRScheduler", "NoamDecay", "ExponentialDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "PiecewiseDecay",
           "CosineAnnealingDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
           "ReduceOnPlateau", "MultiplicativeDecay", "OneCycleLR",
           "CyclicLR", "CosineAnnealingWarmRestarts"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(
            step ** -0.5, step * self.warmup_steps ** -1.5)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * max(div, 1)
        else:
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * \
            (1 - step / decay_steps) ** self.power + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1,
                 verbose=False):
        self.lr_after = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * \
                self.last_epoch / self.warmup_steps + self.start_lr
        if isinstance(self.lr_after, ReduceOnPlateau):
            # metric-driven, not epoch-indexed: the user drives its .step(metrics);
            # here just read its current lr
            return self.lr_after()
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.last_epoch = self.last_epoch - self.warmup_steps
            self.lr_after.last_lr = self.lr_after.get_lr()
            return self.lr_after()
        return float(self.lr_after)

    def state_dict(self):
        d = super().state_dict()
        if isinstance(self.lr_after, LRScheduler):
            d["lr_after"] = self.lr_after.state_dict()
        return d

    def set_state_dict(self, state):
        nested = state.pop("lr_after", None) if isinstance(state, dict) else None
        super().set_state_dict(state)
        if nested is not None and isinstance(self.lr_after, LRScheduler):
            self.lr_after.set_state_dict(nested)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = self.last_epoch
        t_i = self.T_0
        while t >= t_i:
            t -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * t / t_i)) / 2


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        d = super().state_dict()
        d.pop("lr_lambda", None)
        return d


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        m = float(metrics.item() if hasattr(metrics, "item") else metrics)
        better = False
        if self.best is None:
            better = True
        elif self.mode == "min":
            thr = self.best * (1 - self.threshold) if self.threshold_mode == "rel" \
                else self.best - self.threshold
            better = m < thr
        else:
            thr = self.best * (1 + self.threshold) if self.threshold_mode == "rel" \
                else self.best + self.threshold
            better = m > thr
        if better:
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, anneal_strategy="cos",
                 three_phase=False, last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return start + (end - start) * pct

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up = int(self.phase_pct * self.total_steps)
        if step <= up and up > 0:
            return self._interp(self.initial_lr, self.max_lr, step / up)
        if self.three_phase:
            # up -> symmetric down to initial_lr -> annihilate to end_lr
            down_end = min(2 * up, self.total_steps)
            if step <= down_end:
                return self._interp(self.max_lr, self.initial_lr,
                                    (step - up) / max(down_end - up, 1))
            return self._interp(self.initial_lr, self.end_lr,
                                (step - down_end) / max(self.total_steps - down_end, 1))
        down = self.total_steps - up
        return self._interp(self.max_lr, self.end_lr,
                            (step - up) / max(down, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down if step_size_down is not None else step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        scale = x / self.up if x <= self.up else 1 - (x - self.up) / self.down
        amp = (self.max_lr - self.base_lr) * scale
        if self.scale_fn is not None:
            arg = cycle if self.scale_mode == "cycle" else self.last_epoch
            amp *= self.scale_fn(arg)
        elif self.mode == "triangular2":
            amp /= 2 ** (cycle - 1)
        elif self.mode == "exp_range":
            amp *= self.exp_gamma ** self.last_epoch
        return self.base_lr + amp


# ---------------------------------------------------------------------------
# r5: the legacy functional decay ops (ref: the *_decay ops the reference
# keeps in fluid/layers/learning_rate_scheduler + ops.yaml: each computes
# lr(step) as a graph op). Pure closed forms over a step count — usable
# inside a compiled train step (the scheduler classes above are the
# stateful eager tier).
# ---------------------------------------------------------------------------

def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate^(step/decay_steps) (ref: exponential_decay op)."""
    def at(step):
        e = step / decay_steps
        if staircase:
            e = e // 1
        return learning_rate * decay_rate ** e
    return at


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * e^(-decay_rate * step/decay_steps)."""
    import math
    def at(step):
        e = step / decay_steps
        if staircase:
            e = e // 1
        return learning_rate * math.e ** (-decay_rate * e)
    return at


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step/decay_steps)."""
    def at(step):
        e = step / decay_steps
        if staircase:
            e = e // 1
        return learning_rate / (1 + decay_rate * e)
    return at


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    """Polynomial ramp to end_learning_rate (ref: polynomial_decay op)."""
    def at(step):
        s = min(step, decay_steps) if not cycle else step % decay_steps
        frac = (1 - s / decay_steps) ** power
        return (learning_rate - end_learning_rate) * frac + end_learning_rate
    return at


def piecewise_decay(boundaries, values):
    """Step function over boundaries (ref: piecewise_decay op)."""
    def at(step):
        for b, v in zip(boundaries, values):
            if step < b:
                return v
        return values[len(boundaries)]
    return at


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """Half-cosine anneal (ref: cosine_decay op)."""
    import math
    def at(step):
        ep = step // step_each_epoch
        return learning_rate * 0.5 * (math.cos(ep * math.pi / epochs) + 1)
    return at


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """Transformer Noam schedule (ref: noam_decay op)."""
    def at(step):
        step = max(step, 1)
        return learning_rate * d_model ** -0.5 * min(
            step ** -0.5, step * warmup_steps ** -1.5)
    return at


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Linear warmup wrapper (ref: linear_lr_warmup op); learning_rate may
    be a constant or another decay callable."""
    def at(step):
        if step < warmup_steps:
            return start_lr + (end_lr - start_lr) * step / warmup_steps
        return learning_rate(step) if callable(learning_rate) \
            else learning_rate
    return at


__all__ = [n for n in dir() if not n.startswith("_")]


def _register_decay_ops():
    from ..core.dispatch import OP_REGISTRY, register_op
    for _n in ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
               "polynomial_decay", "piecewise_decay", "cosine_decay",
               "noam_decay", "linear_lr_warmup"]:
        if _n not in OP_REGISTRY:
            _f = globals()[_n]
            register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                        differentiable=False, category="lr", public=_f)


_register_decay_ops()
