"""Normalization functionals — counterpart of
``paddle_tpu/nn/functional/norm.py``. ``batch_norm`` updates the running
statistics it is handed through ``set_value``, as Paddle mutates them.

``rms_norm`` is an eager caller of the RMSNorm kernel: with a weight, on
a CUDA tensor, with x and the weight each float32 or bfloat16 (what
``csrc/rms_norm.cu`` takes; it takes any row length and row count, where
the TPU kernel wanted ``d % 128 == 0`` and ``rows % 8 == 0``), it runs
``kernels.rms_norm.rms_norm``, whose forward and backward launch the
kernels; otherwise the plain formula below.

``sync_batch_norm`` normalizes by the statistics of the whole batch
across the processes of a launched world (``init_parallel_env`` over
gloo): each process's per-channel sum and sum of squares and its row
count are all-reduced (an autograd ``Function`` whose backward
all-reduces the gradients, since every process's output depends on every
process's input), and the running statistics take the global mean and
unbiased variance. In one process it is ``batch_norm``.
"""

from __future__ import annotations

import torch

from ...device import on_cuda
from ...ops._helpers import ensure_tensor, forward_op

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None,
               name=None):
    x = ensure_tensor(x)
    ch_axis = x.ndim - 1 if data_format[-1] == "C" and len(data_format) > 2 else 1
    axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    use_batch_stats = training and not use_global_stats

    stat_shape = [1] * x.ndim
    stat_shape[ch_axis] = x.shape[ch_axis]
    wb = [ensure_tensor(a) for a in (weight, bias) if a is not None]

    def affine(out, *wbv):
        i = 0
        if weight is not None:
            out = out * wbv[i].reshape(stat_shape)
            i += 1
        if bias is not None:
            out = out + wbv[i].reshape(stat_shape)
        return out

    if use_batch_stats:
        def impl(v, *wbv):
            mean = torch.mean(v, dim=axes, keepdim=True)
            var = torch.var(v, dim=axes, keepdim=True, correction=0)
            out = (v - mean) * torch.rsqrt(var + epsilon)
            return affine(out, *wbv), mean.reshape(-1), var.reshape(-1)

        out, bmean, bvar = forward_op("batch_norm", impl, [x] + wb)
        if running_mean is not None:
            running_mean.set_value(momentum * running_mean._value +
                                   (1 - momentum) * bmean._value.detach())
        if running_var is not None:
            n = 1
            for a in axes:
                n *= x.shape[a]
            unbiased = bvar._value.detach() * (n / max(n - 1, 1))
            running_var.set_value(momentum * running_var._value +
                                  (1 - momentum) * unbiased)
        return out

    def impl_infer(v, m, var, *wbv):
        out = (v - m.reshape(stat_shape)) * torch.rsqrt(
            var.reshape(stat_shape) + epsilon)
        return affine(out, *wbv)

    return forward_op("batch_norm_infer", impl_infer,
                      [x, ensure_tensor(running_mean),
                       ensure_tensor(running_var)] + wb)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5, name=None):
    x = ensure_tensor(x)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n_axes = len(tuple(normalized_shape))
    axes = tuple(range(x.ndim - n_axes, x.ndim))
    args = [x] + [ensure_tensor(a) for a in (weight, bias) if a is not None]

    def impl(v, *wb):
        mean = torch.mean(v, dim=axes, keepdim=True)
        var = torch.var(v, dim=axes, keepdim=True, correction=0)
        out = (v - mean) * torch.rsqrt(var + epsilon)
        i = 0
        if weight is not None:
            out = out * wb[i]
            i += 1
        if bias is not None:
            out = out + wb[i]
        return out

    return forward_op("layer_norm", impl, args)


def _rms_norm_plain(v, eps, w=None):
    """The reference's off-kernel formula: normalize in fp32, cast to x's
    dtype, then scale by the weight."""
    vf = v.to(torch.float32)
    out = (vf * torch.rsqrt(torch.mean(vf * vf, dim=-1, keepdim=True) + eps)
           ).to(v.dtype)
    return out * w if w is not None else out


def rms_kernel_route(v: torch.Tensor, w) -> bool:
    """Whether ``rms_norm`` launches the kernel for x ``v`` and weight
    ``w``: a weight, a CUDA tensor, and the dtypes the kernel takes."""
    return w is not None and on_cuda(v, "rms_norm") and \
        v.dtype in _KERNEL_DTYPES and w.dtype in _KERNEL_DTYPES


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis (ref: paddle.incubate.nn.functional.
    fused_rms_norm): the kernel route (:func:`rms_kernel_route`) or the
    plain formula."""
    x = ensure_tensor(x)
    args = [x] + ([ensure_tensor(weight)] if weight is not None else [])

    def impl(v, *w):
        if rms_kernel_route(v, w[0] if w else None):
            from ...kernels.rms_norm import rms_norm as rms_kernel
            return rms_kernel(v, w[0], epsilon)
        return _rms_norm_plain(v, epsilon, w[0] if w else None)

    return forward_op("rms_norm", impl, args)


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-5, data_format="NCHW",
                  name=None):
    x = ensure_tensor(x)
    ch_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    axes = tuple(i for i in range(2, x.ndim)) if ch_axis == 1 else \
        tuple(i for i in range(1, x.ndim - 1))
    stat_shape = [1] * x.ndim
    stat_shape[ch_axis] = x.shape[ch_axis]
    args = [x] + [ensure_tensor(a) for a in (weight, bias) if a is not None]

    def impl(v, *wb):
        if axes:
            mean = torch.mean(v, dim=axes, keepdim=True)
            var = torch.var(v, dim=axes, keepdim=True, correction=0)
        else:   # no spatial axes: each value is its own instance
            mean, var = v, torch.zeros_like(v)
        out = (v - mean) * torch.rsqrt(var + eps)
        i = 0
        if weight is not None:
            out = out * wb[i].reshape(stat_shape)
            i += 1
        if bias is not None:
            out = out + wb[i].reshape(stat_shape)
        return out

    return forward_op("instance_norm", impl, args)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    x = ensure_tensor(x)
    channels_last = data_format[-1] == "C" and len(data_format) > 2
    args = [x] + [ensure_tensor(a) for a in (weight, bias) if a is not None]

    def impl(v, *wb):
        if channels_last:
            v = torch.movedim(v, -1, 1)
        n, c = v.shape[:2]
        g = v.reshape(n, num_groups, c // num_groups, *v.shape[2:])
        axes = tuple(range(2, g.dim()))
        mean = torch.mean(g, dim=axes, keepdim=True)
        var = torch.var(g, dim=axes, keepdim=True, correction=0)
        out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(v.shape)
        stat_shape = [1] * out.dim()
        stat_shape[1] = c
        i = 0
        if weight is not None:
            out = out * wb[i].reshape(stat_shape)
            i += 1
        if bias is not None:
            out = out + wb[i].reshape(stat_shape)
        if channels_last:
            out = torch.movedim(out, 1, -1)
        return out

    return forward_op("group_norm", impl, args)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                        name=None):
    x = ensure_tensor(x)

    def impl(v):
        if data_format != "NCHW":
            v = torch.movedim(v, -1, 1)
        sq = torch.square(v)
        half = size // 2
        # window sum over channels: pad the channel axis, then sum shifts
        pads = [0, 0] * (v.dim() - 2) + [half, size - 1 - half]
        padded = torch.nn.functional.pad(sq, pads)
        summed = sum(padded.narrow(1, s, v.shape[1]) for s in range(size))
        out = v / (k + alpha * summed) ** beta
        if data_format != "NCHW":
            out = torch.movedim(out, 1, -1)
        return out

    return forward_op("local_response_norm", impl, [x])


def spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12, name=None):
    weight, u, v = ensure_tensor(weight), ensure_tensor(u), ensure_tensor(v)

    def impl(w, u_, v_):
        wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
        for _ in range(power_iters):
            v_ = wm.T @ u_
            v_ = v_ / (torch.linalg.vector_norm(v_) + eps)
            u_ = wm @ v_
            u_ = u_ / (torch.linalg.vector_norm(u_) + eps)
        sigma = u_ @ wm @ v_
        return w / sigma

    return forward_op("spectral_norm", impl, [weight, u, v])


class _AllReduceProcesses(torch.autograd.Function):
    """Sum over the launched world's processes; backward, the sum of the
    processes' gradients."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist
        out = x.detach().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        out = g.detach().clone()
        dist.all_reduce(out)
        return out


def sync_batch_norm(x, running_mean, running_var, weight=None, bias=None,
                    training: bool = False, momentum: float = 0.9,
                    epsilon: float = 1e-5, data_format="NCHW", name=None):
    """Batch norm over the global batch of a launched multi-process world
    (see the module note); ``batch_norm`` otherwise."""
    from ...distributed import collective as C
    if not (training and C._launched() and C.get_world_size() > 1):
        return batch_norm(x, running_mean, running_var, weight=weight,
                          bias=bias, training=training, momentum=momentum,
                          epsilon=epsilon, data_format=data_format)
    x = ensure_tensor(x)
    ch_axis = x.ndim - 1 if data_format[-1] == "C" and len(data_format) > 2 else 1
    axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    stat_shape = [1] * x.ndim
    stat_shape[ch_axis] = x.shape[ch_axis]
    wb = [ensure_tensor(a) for a in (weight, bias) if a is not None]

    def impl(v, *wbv):
        n_local = 1
        for a in axes:
            n_local *= v.shape[a]
        vf = v.to(torch.float32)
        packed = torch.cat([vf.sum(dim=axes), (vf * vf).sum(dim=axes),
                            torch.tensor([float(n_local)], device=v.device)])
        total = _AllReduceProcesses.apply(packed)
        C_ = v.shape[ch_axis]
        n = total[-1].detach()
        mean = total[:C_] / n
        var = total[C_:2 * C_] / n - mean * mean
        out = ((vf - mean.reshape(stat_shape)) *
               torch.rsqrt(var.reshape(stat_shape) + epsilon)).to(v.dtype)
        i = 0
        if weight is not None:
            out = out * wbv[i].reshape(stat_shape)
            i += 1
        if bias is not None:
            out = out + wbv[i].reshape(stat_shape)
        return out, mean, var, n

    out, mean, var, n = forward_op("sync_batch_norm", impl, [x] + wb)
    nv = float(n._value)
    if running_mean is not None:
        running_mean.set_value(momentum * running_mean._value +
                               (1 - momentum) * mean._value.detach())
    if running_var is not None:
        running_var.set_value(momentum * running_var._value + (1 - momentum)
                              * var._value.detach() * (nv / max(nv - 1, 1)))
    return out
