"""``nn.functional.sync_batch_norm`` / ``nn.SyncBatchNorm`` across the
processes of a launched world: a 2-rank job (the port's launcher, gloo
on the CPU, as ``tests/test_torch_launch.py`` runs its jobs:
``torch.set_num_threads(1)`` in every child, a 60 s process-group
timeout, the launcher's ``--elastic_timeout``) in which each rank
normalizes its half of one batch.

Oracle: the JAX package's ``batch_norm`` in training mode on the whole
batch (its running statistics updated as Paddle does). Each rank's
output rows, its input-gradient rows and the running statistics match
within 1e-5; the weight and bias gradients summed over the ranks match
the whole batch's within 1e-5 x max|g|.
"""

import json
import os
import textwrap

import numpy as np

import paddle_tpu as J
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.distributed.launch.main import _parse, launch_procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    r = np.random.default_rng(0)
    x = r.standard_normal((8, 3, 4, 4)).astype(np.float32) * 2 + 1
    w = r.standard_normal((8, 3, 4, 4)).astype(np.float32)
    gamma = r.standard_normal(3).astype(np.float32)
    beta = r.standard_normal(3).astype(np.float32)
    return x, w, gamma, beta


def test_sync_batch_norm_two_ranks(tmp_path):
    x, w, gamma, beta = _inputs()
    np.savez(tmp_path / "in.npz", x=x, w=w, gamma=gamma, beta=beta)
    script = tmp_path / "train.py"
    script.write_text(textwrap.dedent(f"""
        import json, os, sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.distributed import collective as C
        paddle.set_device("cpu")
        C.init_parallel_env(timeout=60)
        r = C.get_rank()
        d = np.load({str(tmp_path / "in.npz")!r})
        bn = paddle.nn.SyncBatchNorm(3, momentum=0.9)
        bn.weight.set_value(d["gamma"])
        bn.bias.set_value(d["beta"])
        x = paddle.to_tensor(d["x"][r * 4:(r + 1) * 4], stop_gradient=False)
        y = bn(x)
        (y * paddle.to_tensor(d["w"][r * 4:(r + 1) * 4])).sum().backward()
        out = {{k: v.tolist() for k, v in (
            ("y", y.numpy()), ("dx", x.grad.numpy()),
            ("dgamma", bn.weight.grad.numpy()), ("dbeta", bn.bias.grad.numpy()),
            ("mean", bn._mean.numpy()), ("var", bn._variance.numpy()))}}
        with open({str(tmp_path)!r} + f"/out{{r}}.json", "w") as f:
            json.dump(out, f)
        C.barrier()
    """))
    rc = launch_procs(_parse(["--nproc_per_node", "2", "--max_restart", "0",
                              "--elastic_timeout", "60",
                              "--log_dir", str(tmp_path / "log"),
                              str(script)]))
    logs = [(tmp_path / "log" / f"workerlog.{k}").read_text()
            for k in range(2)]
    assert rc == 0, logs
    outs = [json.loads((tmp_path / f"out{k}.json").read_text())
            for k in range(2)]

    rm = J.to_tensor(np.zeros(3, np.float32))
    rv = J.to_tensor(np.ones(3, np.float32))
    jx = J.to_tensor(x, stop_gradient=False)
    jg = J.to_tensor(gamma, stop_gradient=False)
    jb = J.to_tensor(beta, stop_gradient=False)
    jy = JF.batch_norm(jx, rm, rv, jg, jb, training=True, momentum=0.9)
    (jy * J.to_tensor(w)).sum().backward()
    want_y, want_dx = jy.numpy(), jx.grad.numpy()
    for k, o in enumerate(outs):
        np.testing.assert_allclose(o["y"], want_y[k * 4:(k + 1) * 4],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(o["dx"], want_dx[k * 4:(k + 1) * 4],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(o["mean"], rm.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(o["var"], rv.numpy(), atol=1e-5, rtol=0)
    for key, ref in (("dgamma", jg.grad.numpy()), ("dbeta", jb.grad.numpy())):
        got = np.add(outs[0][key], outs[1][key])
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()))
