"""``paddle.summary`` — counterpart of ``paddle_tpu/hapi/model_summary.py``
(ref: ``python/paddle/hapi/model_summary.py``): the layer table and the
parameter counts, with output shapes from forward hooks when an input is
given."""

from __future__ import annotations

import numpy as np

from ..nn.layer import Layer

__all__ = ["summary"]


def summary(net: Layer, input_size=None, dtypes=None, input=None):  # noqa: A002
    """Layer table + param counts. Runs a forward pass when ``input_size``
    (or ``input``) is given to record output shapes via forward hooks."""
    rows = []
    hooks = []

    def mk_hook(name, layer):
        def hook(lyr, ins, out):
            shape = None
            o = out[0] if isinstance(out, (tuple, list)) and out else out
            if hasattr(o, "shape"):
                shape = list(o.shape)
            n_params = sum(int(np.prod(p.shape))
                           for p in lyr.parameters(include_sublayers=False))
            rows.append((name, type(lyr).__name__, shape, n_params))
        return layer.register_forward_post_hook(hook)

    for name, layer in net.named_sublayers(include_self=False):
        if not list(layer.children()):
            hooks.append(mk_hook(name, layer))

    ran = False
    try:
        if input is not None:
            net(input)
            ran = True
        elif input_size is not None:
            from ..core.tensor import to_tensor
            sizes = input_size if isinstance(input_size, list) else [input_size]
            dts = dtypes if isinstance(dtypes, (list, tuple)) else \
                [dtypes] * len(sizes)
            args = []
            for s, dt in zip(sizes, dts):
                shape = tuple(1 if d is None or (isinstance(d, int) and d < 0)
                              else int(d) for d in s)
                args.append(to_tensor(
                    np.zeros(shape, np.dtype(dt or "float32"))))
            net(*args)
            ran = True
    finally:
        for h in hooks:
            h.remove()

    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if not p.stop_gradient)
    lines = ["-" * 80,
             f"{'Layer (type)':<36}{'Output Shape':<24}{'Param #':>12}",
             "=" * 80]
    if ran:
        for name, cls, shape, n in rows:
            lines.append(f"{name + ' (' + cls + ')':<36}"
                         f"{str(shape):<24}{n:>12,}")
    lines += ["=" * 80,
              f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}",
              "-" * 80]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
