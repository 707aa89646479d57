"""Measure how far the port's paged entry points under LoRA sit from the
JAX package's at fp32, as the adapters' scale grows.

For each adapter scale, each model of ``tests/test_torch_lora.py``
(dense and MoE) and each paged entry point, one call on the same inputs,
weights and adapter pool in both packages; prints the largest absolute
gap of the logits and of the K/V the call wrote, beside the largest
|value| of each, and their ratio. Run on the CPU from the repository
root::

    JAX_PLATFORMS=cpu python tools/lora_kv_gap.py
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_lora as T  # noqa: E402
from paddle_tpu_torch.models.convert import config_from_jax  # noqa: E402


def gaps(cfg, jp, tp, scale):
    adapters = {f"a{i}": T.TLoRA.lora_init_params(T.CFG, T.RANK, seed=i,
                                                  scale=scale)
                for i in (1, 2)}
    jpool = T.JLoRA.AdapterPool(cfg, T.RANK, 2, 4)
    tpool = T.TLoRA.AdapterPool(config_from_jax(cfg), T.RANK, 2, 4,
                                device="cpu")
    for pool in (jpool, tpool):
        for name in ("a1", "a2"):
            pool.register(name, adapters[name])
            pool.acquire(name)
    for entry in T.ENTRIES:
        fn, args, kw, ids = T._entry_inputs(entry)
        start = T._start_pool(cfg)
        pi = next(i for i, a in enumerate(args) if a is None)
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else
                 jnp.asarray(a, jnp.int32) for a in args[:pi]] + \
            [{k: jnp.asarray(v) for k, v in start.items()}] + \
            [jnp.asarray(a) for a in args[pi + 1:]]
        jkw = dict(kw, use_kernel=False) if "use_kernel" in kw else dict(kw)
        jl, jpl, _ = getattr(T.JG, fn)(jp, cfg, *jargs, **jkw, lora={
            "ids": jnp.asarray(ids), "layers": jpool.layers})
        targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args[:pi]] + \
            [{k: torch.from_numpy(v.copy()) for k, v in start.items()}] + \
            [torch.from_numpy(a) for a in args[pi + 1:]]
        tl, tpl, _ = getattr(T.TG, fn)(tp, config_from_jax(cfg), *targs,
                                       **kw, lora={
                                           "ids": torch.from_numpy(ids),
                                           "layers": tpool.layers})
        row = [entry, np.abs(tl.numpy() - np.asarray(jl)).max(),
               np.abs(np.asarray(jl)).max()]
        for k in ("k", "v"):
            ref = np.asarray(jpl[k])[:, 1:]
            written = ref != start[k][:, 1:]     # the entries the call wrote
            row += [np.abs(tpl[k][:, 1:].numpy() - ref)[written].max(),
                    np.abs(ref[written]).max()]
        yield row


def main():
    print("model scale entry logit_gap max|logit| K_gap max|K| K_rel "
          "V_gap max|V| V_rel")
    for tag, cfg in (("dense", T.CFG), ("moe", T.MOE_CFG)):
        jp = T.JL.init_params(cfg, jax.random.PRNGKey(4))
        tp = T._port(jp)
        for scale in (0.05, 0.5, 1.0, 2.0):
            for e, lg, lm, kg, km, vg, vm in gaps(cfg, jp, tp, scale):
                print(f"{tag} {scale} {e} {lg:.3e} {lm:.3f} {kg:.3e} "
                      f"{km:.3f} {kg / km:.2e} {vg:.3e} {vm:.3f} "
                      f"{vg / vm:.2e}")


if __name__ == "__main__":
    main()
