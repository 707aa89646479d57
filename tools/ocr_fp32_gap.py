"""How far each package's fp32 run of ``tests/test_ocr.py``'s reading task
lies from fp64: the first BatchNorm's batch mean and variance over each
channel (against numpy in fp64), and three Adam steps' losses against the
reference's fp64 run from the same weights.

    JAX_PLATFORMS=cpu python tools/ocr_fp32_gap.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as T  # noqa: E402
import test_torch_ocr as O  # noqa: E402


def main():
    T.set_device("cpu")
    J.seed(0)
    jm = O.JCRNN(num_classes=4, image_height=32, hidden_size=32)
    sd = O.state_dict_from_jax(jm)
    imgs, _ = O._reading_task()
    h = jm.features[0].conv(J.to_tensor(imgs)).numpy()
    h64 = h.astype(np.float64)
    mean64, var64 = h64.mean((0, 2, 3)), h64.var((0, 2, 3))
    ht = torch.from_numpy(h.copy())
    mean = {"reference": np.asarray(jnp.mean(jnp.asarray(h), (0, 2, 3))),
            "port": torch.mean(ht, (0, 2, 3)).numpy()}
    var = {"reference": np.asarray(jnp.var(jnp.asarray(h), (0, 2, 3))),
           "port": torch.var(ht, (0, 2, 3), correction=0).numpy()}
    print(f"first BatchNorm, {h.shape[0] * h.shape[2] * h.shape[3]} values "
          f"a channel, least variance {var64.min():.3g}")
    for k in mean:
        print(f"  {k}: mean error {np.abs(mean[k] - mean64).max():.3g}, "
              f"variance error {np.abs(var[k] - var64).max():.3g}")
    with jax.enable_x64(True):
        exact = O._train(J, O.JCRNN, sd, np.float64)[0]
    runs = {"reference fp32": O._train(J, O.JCRNN, sd, np.float32)[0],
            "port fp32": O._train(T, O.TCRNN, sd, np.float32)[0],
            "port fp64": O._train(T, O.TCRNN, sd, np.float64)[0]}
    print(f"reference fp64 losses {exact}")
    for k, v in runs.items():
        print(f"{k} losses {v}: largest gap to the reference's fp64 "
              f"{np.abs(np.subtract(v, exact)).max():.3g}")


if __name__ == "__main__":
    main()
