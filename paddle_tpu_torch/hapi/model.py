"""hapi ``Model`` — counterpart of ``paddle_tpu/hapi/model.py`` (ref:
``python/paddle/hapi/model.py``).

The batch loops run eagerly: ``train_batch`` is the network's forward
(under ``amp.auto_cast`` when ``prepare`` got ``amp_configs``), the loss,
``backward``, the optimizer's ``step`` and ``clear_grad``. ``fit``,
``evaluate`` and ``predict`` iterate a ``DataLoader`` (built from a
``Dataset``) through ``io.prefetch_to_device``, which pins each batch and
copies it to the card ahead of the step that reads it.

``prepare(jit=True)`` trains through the fused ``jit.TrainStep`` (one
captured CUDA graph a step, with ``sentinel=`` fused into it);
``prepare(sentinel=...)`` guards only that fused step, so without
``jit`` it warns and is ignored, as in the reference.
``save(training=False)`` writes the inference program through
``jit.save`` with ``Model(inputs=...)`` as its input spec.
"""

from __future__ import annotations

from functools import reduce
from typing import List, Optional

import numpy as np
import torch

from ..core import autograd
from ..core.place import torch_device
from ..core.tensor import Tensor, to_tensor
from ..io import DataLoader, Dataset
from ..io.dataloader import prefetch_to_device
from ..metric import Metric
from ..nn.layer import Layer

__all__ = ["Model"]

def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _as_tensors(xs):
    """Batch fields as Tensors on the current place (a torch tensor
    already there is taken without a copy)."""
    out = []
    for x in _as_list(xs):
        if isinstance(x, Tensor):
            out.append(x)
        elif isinstance(x, torch.Tensor):
            out.append(Tensor(x.to(torch_device())))
        else:
            out.append(to_tensor(x))
    return out


class Model:
    """ref: paddle.Model — fit/evaluate/predict over a Layer."""

    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._amp_level = None
        self._jit = False
        self._sentinel = None
        self._train_step = None

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit: bool = False, sentinel=None):
        """``amp_configs``: the reference's level string ("O1"/"O2") or a
        dict with a "level" key, applied to ``train_batch``. ``jit=True``
        fuses forward, backward and the optimizer update into one captured
        program per input signature (``jit.TrainStep``); ``sentinel``
        (None -> FLAGS_health_sentinel) is fused into that step, so
        without ``jit`` it warns and is ignored."""
        self._optimizer = optimizer
        self._loss = loss
        self._jit = bool(jit)
        if sentinel and not self._jit:
            import warnings
            warnings.warn(
                "Model.prepare(sentinel=...) only guards the fused jit "
                "train step — pass jit=True, or use the "
                "callbacks.AnomalyMonitor callback for the eager path; "
                "ignoring sentinel.")
            sentinel = None
        self._sentinel = sentinel
        self._train_step = None
        if amp_configs is None:
            self._amp_level = None
        elif isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level", "O1")
        else:
            raise TypeError(f"amp_configs must be a level string or dict, "
                            f"got {type(amp_configs)}")
        ms = _as_list(metrics)
        for m in ms:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be paddle.metric.Metric, "
                                f"got {type(m)}")
        self._metrics = ms

    # -- single-batch ops ----------------------------------------------------
    def _compute_loss(self, outputs, labels):
        if not callable(self._loss):
            raise RuntimeError("Model.prepare(loss=...) must be set for "
                               "training")
        loss = self._loss(*_as_list(outputs), *_as_list(labels))
        if isinstance(loss, (list, tuple)):
            loss = reduce(lambda a, b: a + b, loss)
        return loss

    def train_batch(self, inputs, labels=None, update=True):
        if self._optimizer is None:
            raise RuntimeError("Model.prepare(optimizer=...) must be set")
        import contextlib

        from .. import amp
        from ..health import watchdog
        watchdog.touch()   # hang-watchdog progress tick (free when off)
        self.network.train()
        ins, labs = _as_tensors(inputs), _as_tensors(labels)
        if self._jit and update and self._loss is not None:
            # the fused path: one captured program per signature
            if self._train_step is None:
                from ..jit.train_step import TrainStep
                self._train_step = TrainStep(
                    self.network, self._optimizer, self._loss,
                    amp=self._amp_level is not None,
                    amp_level=self._amp_level or "O1",
                    return_outputs=True, sentinel=self._sentinel)
            loss, outputs = self._train_step(ins, labs)
            metrics = self._update_metrics(outputs, labs)
            return ([float(loss)], metrics) if metrics else [float(loss)]
        cm = (amp.auto_cast(level=self._amp_level) if self._amp_level
              else contextlib.nullcontext())
        with cm:
            outputs = self.network(*ins)
            loss = self._compute_loss(outputs, labs)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labs)
        return ([float(loss)], metrics) if metrics else [float(loss)]

    @autograd.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        ins, labs = _as_tensors(inputs), _as_tensors(labels)
        outputs = self.network(*ins)
        res = []
        if self._loss is not None and labs:
            res = [float(self._compute_loss(outputs, labs))]
        metrics = self._update_metrics(outputs, labs)
        return (res, metrics) if metrics else res

    @autograd.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        out = self.network(*_as_tensors(inputs))
        return [o.numpy() for o in _as_list(out)]

    def _update_metrics(self, outputs, labels):
        vals = []
        outs = _as_list(outputs)
        for m in self._metrics:
            r = m.compute(outs[0], *labels) if labels else outs[0]
            vals.append(m.update(r))
        return vals

    # -- loops ---------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, num_workers):
        """``data`` as an iterable of batches on the current place: a
        ``Dataset`` through a ``DataLoader``; any iterable of batches
        through ``prefetch_to_device``."""
        if data is None:
            return None
        if isinstance(data, Dataset):
            data = DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers)
        return _Placed(data)

    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, eval_freq: int = 1, log_freq: int = 10,
            save_dir: Optional[str] = None, save_freq: int = 1,
            verbose: int = 2, drop_last: bool = False, shuffle: bool = True,
            num_workers: int = 0, callbacks=None, **kwargs):
        from ..callbacks import CallbackList, ProgBarLogger

        train_loader = self._loader(train_data, batch_size, shuffle,
                                    num_workers)
        eval_loader = self._loader(eval_data, batch_size, False, num_workers)
        cbks = CallbackList(_as_list(callbacks) or [ProgBarLogger(log_freq,
                                                                  verbose)])
        cbks.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks.set_params({"epochs": epochs, "steps": steps,
                         "verbose": verbose,
                         "metrics": self._metric_names()})
        self.stop_training = False
        cbks.on_train_begin()
        history = {}
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            epoch_losses = []
            for step, batch in enumerate(train_loader):
                cbks.on_train_batch_begin(step)
                ins, labs = self._split_batch(batch)
                res = self.train_batch(ins, labs)
                logs = self._pack_logs(res)
                epoch_losses.append(logs["loss"])
                cbks.on_train_batch_end(step, logs)
            if epoch_losses:
                logs["loss"] = float(np.mean(epoch_losses))
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0,
                                          _from_fit=True)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            history.setdefault("loss", []).append(logs.get("loss"))
            cbks.on_epoch_end(epoch, logs)
            if save_dir is not None and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
        cbks.on_train_end(logs)
        if save_dir is not None:
            self.save(f"{save_dir}/final")
        return history

    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 2, num_workers: int = 0, callbacks=None,
                 _from_fit: bool = False, **kwargs):
        loader = eval_data if isinstance(eval_data, _Placed) else \
            self._loader(eval_data, batch_size, False, num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            ins, labs = self._split_batch(batch)
            res = self.eval_batch(ins, labs)
            loss_part = res[0] if isinstance(res, tuple) else res
            if loss_part:
                losses.append(loss_part[0])
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            names = m.name()
            vals = m.accumulate()
            if isinstance(names, (list, tuple)):
                vals_list = vals if isinstance(vals, (list, tuple)) else [vals]
                logs.update(dict(zip(names, vals_list)))
            else:
                logs[names] = vals
        if verbose and not _from_fit:
            print("Eval:", {k: round(float(v), 5) for k, v in logs.items()})
        return logs

    def predict(self, test_data, batch_size: int = 1, num_workers: int = 0,
                stack_outputs: bool = False, callbacks=None, verbose: int = 1,
                **kwargs):
        loader = self._loader(test_data, batch_size, False, num_workers)
        outputs = []
        for batch in loader:
            # labeled datasets predict on the input fields (the trailing
            # label field is dropped, reference convention)
            ins, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    def _split_batch(self, batch, labeled: bool = True):
        if isinstance(batch, (list, tuple)):
            if labeled and len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return list(batch), []
        return [batch], []

    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, (list, tuple)) else [n])
        return names

    def _pack_logs(self, res):
        logs = {}
        if isinstance(res, tuple):
            losses, metrics = res
            logs["loss"] = losses[0]
            for m, v in zip(self._metrics, metrics):
                names = m.name()
                names = names if isinstance(names, (list, tuple)) else [names]
                vs = v if isinstance(v, (list, tuple, np.ndarray)) else [v]
                for n, vv in zip(names, list(vs)):
                    logs[n] = float(vv)
        else:
            logs["loss"] = res[0]
        return logs

    # -- persistence ----------------------------------------------------------
    def save(self, path: str, training: bool = True,
             async_save: bool = False):
        """``path.pdparams`` (and ``path.pdopt``) through ``framework.io``,
        the files the reference writes; ``training=False`` writes the
        inference program (``path.pdmodel`` / ``path.pdiparams``) through
        ``jit.save`` with ``Model(inputs=...)`` as its input spec."""
        if not training:
            from ..jit import api as jit_api
            jit_api.save(self.network, path, input_spec=self._inputs)
            return
        from ..framework import io as fio
        _save = fio.async_save if async_save else fio.save
        _save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None and hasattr(self._optimizer,
                                                   "state_dict"):
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer: bool = False):
        import os

        from ..framework import io as fio
        dev = torch_device()
        self.network.set_state_dict(fio.load(path + ".pdparams", device=dev))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(fio.load(path + ".pdopt",
                                                    device=dev))

    def parameters(self, *a, **k):
        return self.network.parameters(*a, **k)

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        return summary(self.network, input_size, dtypes=dtype)


class _Placed:
    """An iterable of batches, each pass through ``prefetch_to_device`` to
    the current place; keeps the source's ``len``."""

    def __init__(self, source):
        self.source = source

    def __len__(self):
        return len(self.source)

    def __iter__(self):
        return prefetch_to_device(self.source, device=torch_device())
