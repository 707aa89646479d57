"""The port's checkpoint stack (``paddle_tpu_torch.framework`` and
``paddle_tpu_torch.distributed.checkpoint``) against the JAX package's.

* Files cross in both directions, bit for bit: a JAX ``save_state_dict``
  of arrays sharded over the 8-device CPU mesh (replicated dp8, row- and
  column-sharded, 2-D dp2 x mp4) loads into the port's tensors; the
  port's saves (fp32, int32, int8, bool, bf16, 0-d) load into JAX's,
  sharded destinations included; a JAX bf16 save loads into bf16 tensors
  with the same bits (the port reads ``ml_dtypes`` payloads through their
  bits and never imports ``ml_dtypes``); a LLaMA train state (params and
  AdamW) moves either way through the files. Equality is exact.
* ``framework.io``: the port's ``save`` loads in JAX's ``paddle.load``
  (parameters, tensors, nesting, bf16 as JAX's ``bfloat16``, bit for
  bit) and JAX's ``paddle.save`` loads in the port (bf16 restored).
* The fast chaos tier of ``tests/test_chaos.py`` (``TestFastChaos``) runs
  on both packages side by side: truncated and bit-flipped shards walk
  back to the same step, a corrupt committed dir raises, an uncommitted
  newest is ignored and pruned, writer faults surface and the next save
  recovers, a failed rename keeps the series on last-good, the tier-1
  file is atomic and verified. A JAX series whose newest commit is
  bit-flipped restores, in the port, to the step JAX's restore returns.
* The reference's round-trip cases (``tests/test_dist_checkpoint.py``)
  on the port: missing key, shape mismatch, the per-rank metadata union,
  an empty state, 0-d tensors, stale higher-rank files of a larger-world
  save.
"""

import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as JC
from paddle_tpu.distributed.topology import build_mesh
from paddle_tpu.framework import io as jio
from paddle_tpu.framework.async_writer import default_writer as jwriter
from paddle_tpu.models import llama as JL
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.distributed import checkpoint as TC
from paddle_tpu_torch.framework import CheckpointCorruptionError
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.framework.async_writer import default_writer as twriter
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax
from paddle_tpu_torch.testing import chaos as tchaos

torch.set_num_threads(2)

LAYOUTS = {"dp8": ({"dp": 8}, P()),
           "rows8": ({"sharding": 8}, P("sharding", None)),
           "cols4": ({"sharding": 4}, P(None, "sharding")),
           "dp2xmp4": ({"dp": 2, "mp": 4}, P("dp", "mp"))}


def _mesh(degrees):
    n = int(np.prod(list(degrees.values())))
    return build_mesh(degrees, jax.devices()[:n])


def _jax_sharded(a, layout):
    degrees, spec = LAYOUTS[layout]
    return paddle.to_tensor(jax.device_put(
        jnp.asarray(a), NamedSharding(_mesh(degrees), spec)))


def _bf16_bits(t):
    return t.view(torch.int16).numpy()


def _jax_bf16_bits(x):
    return np.asarray(x).view(np.int16)


# ---------------------------------------------------------------------------
# sharded checkpoints across the packages
# ---------------------------------------------------------------------------

class TestCrossPackage:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_jax_sharded_save_loads_in_port(self, tmp_path, layout):
        """A JAX save over the 8-device mesh: each tensor assembled from
        its shards, filled in place (same tensor object, same dtype)."""
        rng = np.random.default_rng(0)
        w = rng.standard_normal((16, 8)).astype(np.float32)
        b = rng.standard_normal((8, 8)).astype(np.float32)
        JC.save_state_dict({"model": {"w": _jax_sharded(w, layout),
                                      "b": _jax_sharded(b, layout)},
                            "step": 7}, str(tmp_path / "c"))
        dst = {"model": {"w": torch.zeros(16, 8), "b": torch.zeros(8, 8)},
               "step": 0}
        w_obj = dst["model"]["w"]
        TC.load_state_dict(dst, str(tmp_path / "c"))
        assert dst["model"]["w"] is w_obj
        np.testing.assert_array_equal(dst["model"]["w"].numpy(), w)
        np.testing.assert_array_equal(dst["model"]["b"].numpy(), b)
        assert dst["step"] == 0      # objects restored only by assignment

    def test_jax_bf16_and_mixed_dtypes_load_in_port(self, tmp_path):
        h = jnp.asarray(np.random.default_rng(1).standard_normal(
            (8, 6)).astype(np.float32)).astype(jnp.bfloat16)
        src = {"bf16": paddle.to_tensor(h),
               "bf16_sharded": _jax_sharded(
                   np.asarray(h, np.float32), "rows8"),
               "int8": paddle.to_tensor(np.array([-128, 0, 127], np.int8)),
               "fp32": paddle.to_tensor(np.linspace(0, 1, 5,
                                                    dtype=np.float32)),
               "mask": paddle.to_tensor(np.array([True, False, True])),
               "scalar": paddle.to_tensor(np.float32(41.0))}
        src["bf16_sharded"] = paddle.to_tensor(
            src["bf16_sharded"]._value.astype(jnp.bfloat16))
        JC.save_state_dict(src, str(tmp_path / "c"))
        dst = {"bf16": torch.zeros(8, 6, dtype=torch.bfloat16),
               "bf16_sharded": torch.zeros(8, 6, dtype=torch.bfloat16),
               "int8": torch.zeros(3, dtype=torch.int8),
               "fp32": torch.zeros(5),
               "mask": torch.zeros(3, dtype=torch.bool),
               "scalar": torch.zeros(())}
        TC.load_state_dict(dst, str(tmp_path / "c"))
        for k in ("bf16", "bf16_sharded"):
            assert dst[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_bf16_bits(dst[k]),
                                          _jax_bf16_bits(h))
        np.testing.assert_array_equal(dst["int8"].numpy(), [-128, 0, 127])
        np.testing.assert_array_equal(dst["fp32"].numpy(),
                                      np.linspace(0, 1, 5, dtype=np.float32))
        np.testing.assert_array_equal(dst["mask"].numpy(),
                                      [True, False, True])
        assert float(dst["scalar"]) == 41.0

    @pytest.mark.parametrize("layout", ["single", "rows8", "dp2xmp4"])
    def test_port_save_loads_in_jax(self, tmp_path, layout):
        """fp32, int32, int8, bool, bf16 and 0-d leaves of the port's save
        load into JAX destinations (sharded ones keep their sharding);
        bf16 bit-exact, through the float32 payload."""
        rng = np.random.default_rng(2)
        src = {"w": torch.from_numpy(rng.standard_normal(
                   (8, 16)).astype(np.float32)),
               "h": torch.from_numpy(rng.standard_normal(
                   (8, 16)).astype(np.float32)).to(torch.bfloat16),
               "i": torch.arange(8, dtype=torch.int32),
               "q": torch.tensor([-128, 5, 127], dtype=torch.int8),
               "m": torch.tensor([True, False]),
               "opt": {"step": torch.tensor(41, dtype=torch.int32)}}
        TC.save_state_dict(src, str(tmp_path / "c"))

        def dst(shape, dtype):
            z = jnp.zeros(shape, dtype)
            if layout == "single" or len(shape) != 2:
                return paddle.to_tensor(z)
            return _jax_sharded(z, layout)

        jd = {"w": dst((8, 16), jnp.float32), "h": dst((8, 16), jnp.bfloat16),
              "i": dst((8,), jnp.int32), "q": dst((3,), jnp.int8),
              "m": dst((2,), jnp.bool_),
              "opt": {"step": dst((), jnp.int32)}}
        JC.load_state_dict(jd, str(tmp_path / "c"))
        np.testing.assert_array_equal(jd["w"].numpy(), src["w"].numpy())
        assert jd["h"]._value.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_jax_bf16_bits(jd["h"]._value),
                                      _bf16_bits(src["h"]))
        for k in ("i", "q", "m"):
            np.testing.assert_array_equal(jd[k].numpy(), src[k].numpy())
        assert int(jd["opt"]["step"]) == 41
        if layout != "single":
            assert tuple(jd["w"]._value.sharding.spec) == tuple(
                LAYOUTS[layout][1])
        # and the port reads its own file bit for bit
        back = {k: torch.zeros_like(v) for k, v in src.items() if k != "opt"}
        back["opt"] = {"step": torch.tensor(0, dtype=torch.int32)}
        TC.load_state_dict(back, str(tmp_path / "c"))
        for k in ("w", "i", "q", "m"):
            assert torch.equal(back[k], src[k])
        np.testing.assert_array_equal(_bf16_bits(back["h"]),
                                      _bf16_bits(src["h"]))

    def test_llama_train_state_crosses_through_files(self, tmp_path):
        """A JAX LLaMA train state (params fsdp-sharded, AdamW moments and
        step) saved by JAX loads into the port's tensors, and the port's
        save of it loads back into JAX — no conversion function."""
        cfg = JL.LlamaConfig(vocab_size=64, hidden_size=32,
                             intermediate_size=64, num_hidden_layers=2,
                             num_attention_heads=4)
        params = JL.init_params(cfg, jax.random.PRNGKey(0))
        init_opt, _ = JL.make_train_step(cfg)
        opt = init_opt(params)
        opt = {"m": jax.tree_util.tree_map(lambda a: a + 0.5, opt["m"]),
               "v": jax.tree_util.tree_map(lambda a: a + 0.25, opt["v"]),
               "step": jnp.asarray(7, jnp.int32)}
        ps = JL.shard_params(params, _mesh({"dp": 4, "sharding": 2}), cfg,
                             mp_axis=None, fsdp_axis="sharding")
        JC.save_state_dict({"params": jax.tree_util.tree_map(
            paddle.to_tensor, ps), "opt": jax.tree_util.tree_map(
            paddle.to_tensor, opt)}, str(tmp_path / "j"))
        tcfg = config_from_jax(cfg)
        tp = TL.init_params(tcfg, seed=5, device="cpu")
        tstate = {"params": tp, "opt": TL.make_train_step(tcfg)[0](tp)}
        TC.load_state_dict(tstate, str(tmp_path / "j"))
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               device="cpu")
        got = TC._flatten(tstate["params"])
        assert set(got) == set(TC._flatten(want))
        for k, v in TC._flatten(want).items():
            assert torch.equal(got[k], v), k
        jopt = JC._flatten(opt)
        topt = TC._flatten(tstate["opt"])
        assert set(jopt) == set(topt)
        for k, v in jopt.items():
            np.testing.assert_array_equal(np.asarray(v), topt[k].numpy())
        TC.save_state_dict(tstate, str(tmp_path / "t"))
        jd = {"params": jax.tree_util.tree_map(
                  lambda a: paddle.to_tensor(jnp.zeros_like(a)), params),
              "opt": jax.tree_util.tree_map(
                  lambda a: paddle.to_tensor(jnp.zeros_like(a)), opt)}
        JC.load_state_dict(jd, str(tmp_path / "t"))
        back = JC._flatten(jd)
        for k, v in JC._flatten({"params": params, "opt": opt}).items():
            np.testing.assert_array_equal(np.asarray(v), back[k].numpy())

    def test_jax_series_bit_flipped_restores_same_step_in_port(self, tmp_path):
        root = str(tmp_path / "ck")
        ck = JC.AsyncCheckpointer(root, keep_last_k=3)
        for s in range(3):
            ck.save({"w": paddle.to_tensor(np.full((4,), float(s),
                                                   np.float32))}, s)
        ck.wait()
        step, path = JC.manifest.latest_committed(root)
        jchaos.flip_bits(os.path.join(path, "data_0.pkl"),
                         offset=os.path.getsize(
                             os.path.join(path, "data_0.pkl")) // 2)
        jdst = {"w": paddle.to_tensor(np.zeros((4,), np.float32))}
        want = ck.restore(jdst)
        tdst = {"w": torch.zeros(4)}
        got = TC.AsyncCheckpointer(root).restore(tdst)
        assert got == want == step - 1
        np.testing.assert_array_equal(tdst["w"].numpy(), jdst["w"].numpy())

    def test_port_series_restores_in_jax(self, tmp_path):
        root = str(tmp_path / "ck")
        ck = TC.AsyncCheckpointer(root, keep_last_k=2)
        for s in range(4):
            ck.save({"w": torch.full((4,), float(s))}, s)
        ck.wait()
        assert ck.all_steps() == [2, 3]
        assert JC.AsyncCheckpointer(root).all_steps() == [2, 3]
        jdst = {"w": paddle.to_tensor(np.zeros((4,), np.float32))}
        assert JC.AsyncCheckpointer(root).restore(jdst) == 3
        np.testing.assert_array_equal(jdst["w"].numpy(), np.full(4, 3.0))


# ---------------------------------------------------------------------------
# framework.io (paddle.save / paddle.load) across the packages
# ---------------------------------------------------------------------------

class TestFrameworkIO:
    def test_port_save_loads_in_jax(self, tmp_path):
        rng = np.random.default_rng(3)
        p = torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal((3, 4)).astype(np.float32)))
        h = torch.from_numpy(rng.standard_normal(6).astype(
            np.float32)).to(torch.bfloat16)
        obj = {"w": p, "b": torch.arange(5, dtype=torch.int32), "h": h,
               "g": torch.ones(2, requires_grad=True),
               "meta": {"step": 3, "l": [torch.zeros(2)]}}
        tio.save(obj, str(tmp_path / "m.pdparams"))
        got = jio.load(str(tmp_path / "m.pdparams"))
        assert isinstance(got["w"], paddle.Parameter) and got["w"].trainable
        np.testing.assert_array_equal(got["w"].numpy(), p.detach().numpy())
        np.testing.assert_array_equal(got["b"].numpy(), obj["b"].numpy())
        # bf16 crosses as bf16: JAX's dtype, 2 bytes an element, the bits
        jh = np.asarray(got["h"].numpy())
        assert jh.dtype.name == "bfloat16" and jh.itemsize == 2
        np.testing.assert_array_equal(_jax_bf16_bits(jh), _bf16_bits(h))
        with open(tmp_path / "m.pdparams", "rb") as f:
            payload = tio.unpickle(f)["h"]["value"]
        assert payload.dtype.itemsize == 2 and payload.nbytes == 2 * h.numel()
        assert got["b"].stop_gradient and not got["g"].stop_gradient
        assert got["meta"]["step"] == 3
        np.testing.assert_array_equal(got["meta"]["l"][0].numpy(),
                                      np.zeros(2, np.float32))
        # the port restores bf16 from the same file, bit for bit
        back = tio.load(str(tmp_path / "m.pdparams"), device="cpu")
        assert back["h"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bf16_bits(back["h"]), _bf16_bits(h))
        assert isinstance(back["w"], torch.nn.Parameter)
        assert torch.equal(back["w"], p)
        assert back["g"].requires_grad and not back["b"].requires_grad

    def test_jax_save_loads_in_port(self, tmp_path):
        h = jnp.asarray(np.linspace(-2, 2, 7, dtype=np.float32)).astype(
            jnp.bfloat16)
        w = paddle.create_parameter([3, 4], "float32")
        obj = {"w": w, "h": paddle.to_tensor(h),
               "i": paddle.to_tensor(np.arange(4, dtype=np.int32)),
               "nested": [paddle.to_tensor(np.ones((2, 2), np.float32)),
                          "tag"]}
        jio.save(obj, str(tmp_path / "m.pdparams"))
        got = tio.load(str(tmp_path / "m.pdparams"), device="cpu")
        assert isinstance(got["w"], torch.nn.Parameter)
        np.testing.assert_array_equal(got["w"].detach().numpy(), w.numpy())
        assert got["h"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bf16_bits(got["h"]),
                                      _jax_bf16_bits(h))
        np.testing.assert_array_equal(got["i"].numpy(), np.arange(4))
        assert got["nested"][1] == "tag"
        np.testing.assert_array_equal(got["nested"][0].numpy(),
                                      np.ones((2, 2), np.float32))
        num = tio.load(str(tmp_path / "m.pdparams"), return_numpy=True)
        np.testing.assert_array_equal(num["h"], np.asarray(h, np.float32))

    def test_load_defaults_to_the_card(self, tmp_path):
        """No quiet CPU run: without ``device="cpu"`` the port loads onto
        the card, and with none present it raises."""
        tio.save({"w": torch.ones(2)}, str(tmp_path / "m.pdparams"))
        if torch.cuda.is_available():
            assert tio.load(str(tmp_path / "m.pdparams"))["w"].is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tio.load(str(tmp_path / "m.pdparams"))


# ---------------------------------------------------------------------------
# TestFastChaos of tests/test_chaos.py, on both packages side by side
# ---------------------------------------------------------------------------

class _Pkg:
    """One package's checkpoint surface behind one spelling."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.C = JC if jax_side else TC
        self.io = jio if jax_side else tio
        self.chaos = jchaos if jax_side else tchaos
        self.writer = jwriter if jax_side else twriter
        self.jax = jax_side

    def state(self, val, n=4):
        if self.jax:
            return {"w": paddle.to_tensor(np.full((n,), val, np.float32))}
        return {"w": torch.full((n,), float(val))}

    def value(self, state):
        return np.asarray(state["w"].numpy())

    def load(self, path):
        if self.jax:
            return self.io.load(path)
        return self.io.load(path, device="cpu")

    def series(self, root, steps=3, keep=3):
        ck = self.C.AsyncCheckpointer(str(root), keep_last_k=keep)
        for s in range(steps):
            ck.save(self.state(float(s)), s)
        ck.wait()
        return ck

    def newest_shard(self, root):
        step, path = self.C.manifest.latest_committed(str(root))
        return step, os.path.join(path, "data_0.pkl")


def _truncated(pkg, tmp):
    ck = pkg.series(tmp / "ckpt")
    step, shard = pkg.newest_shard(tmp / "ckpt")
    pkg.chaos.truncate_file(shard, frac=0.4)
    dst = pkg.state(-1.0)
    return step, ck.restore(dst), pkg.value(dst).tolist()


def _flipped(pkg, tmp):
    ck = pkg.series(tmp / "ckpt")
    step, shard = pkg.newest_shard(tmp / "ckpt")
    pkg.chaos.flip_bits(shard, offset=os.path.getsize(shard) // 2)
    dst = pkg.state(-1.0)
    return step, ck.restore(dst), pkg.value(dst).tolist()


def _corrupt_committed(pkg, tmp):
    pkg.C.save_state_dict(pkg.state(7.0), str(tmp / "ck"))
    pkg.chaos.flip_bits(str(tmp / "ck" / "data_0.pkl"))
    with pytest.raises(pkg.C.CheckpointCorruptionError, match="SHA-256|bytes"):
        pkg.C.load_state_dict(pkg.state(0.0), str(tmp / "ck"))
    return True


def _uncommitted_newest(pkg, tmp):
    ck = pkg.series(tmp / "ckpt", steps=3)
    _, path = pkg.C.manifest.latest_committed(str(tmp / "ckpt"))
    os.remove(os.path.join(path, pkg.C.manifest.COMMITTED_MARKER))
    first = ck.restore(pkg.state(-1.0))
    removed = pkg.C.prune_uncommitted(str(tmp / "ckpt"))
    return first, [os.path.basename(p) for p in removed], \
        ck.restore(pkg.state(-1.0))


def _writer_fault_then_recover(pkg, tmp):
    ck = pkg.C.AsyncCheckpointer(str(tmp / "ckpt"))
    ck.save(pkg.state(0.0), 0)
    ck.wait()
    with pkg.chaos.async_writer_fault(RuntimeError("chaos boom")):
        ck.save(pkg.state(1.0), 1)
        with pytest.raises(RuntimeError, match="chaos boom"):
            ck.wait()
    latest = ck.latest_step()
    ck.save(pkg.state(2.0), 2)
    ck.wait()
    dst = pkg.state(-1.0)
    return latest, ck.restore(dst), pkg.value(dst).tolist()


def _writer_fault_on_next_submit(pkg, tmp):
    pkg.writer().wait_all()
    with pkg.chaos.async_writer_fault(RuntimeError("lost write")):
        j = pkg.C.save_state_dict(pkg.state(1.0), str(tmp / "ck"),
                                  async_save=True)
        deadline = time.time() + 30
        while not j.done:
            assert time.time() < deadline
            time.sleep(0.01)
    with pytest.raises(RuntimeError, match="lost write"):
        pkg.C.save_state_dict(pkg.state(2.0), str(tmp / "ck"),
                              async_save=True)
    pkg.writer().wait_all()
    return True


def _fail_nth_rename(pkg, tmp):
    ck = pkg.series(tmp / "ckpt", steps=2)
    with pkg.chaos.fail_nth(os, "replace", n=2):
        with pytest.raises(OSError, match="chaos"):
            pkg.C.save_state_dict(pkg.state(9.0), str(
                tmp / "ckpt" / pkg.C.manifest.step_dir_name(2)))
    dst = pkg.state(-1.0)
    return ck.latest_step(), ck.restore(dst), pkg.value(dst).tolist()


def _tier1_atomic(pkg, tmp):
    p = str(tmp / "m.pdparams")
    pkg.io.save(pkg.state(1.0), p)
    with pkg.chaos.fail_nth(os, "replace", n=1):
        with pytest.raises(OSError, match="chaos"):
            pkg.io.save(pkg.state(2.0), p)
    return pkg.value(pkg.load(p)).tolist()


def _tier1_corrupt(pkg, tmp):
    out = []
    for how in ("truncate", "flip"):
        p = str(tmp / f"{how}.pdparams")
        pkg.io.save(pkg.state(3.0), p)
        if how == "truncate":
            pkg.chaos.truncate_file(p, frac=0.7)
        else:
            pkg.chaos.flip_bits(p, offset=os.path.getsize(p) // 3)
        with pytest.raises(pkg.C.CheckpointCorruptionError):
            pkg.load(p)
        out.append(how)
    return out


def _tier1_async(pkg, tmp):
    p = str(tmp / "m.pdparams")
    pkg.io.async_save(pkg.state(5.0), p)
    pkg.io.wait_save()
    return pkg.io.is_saving(), pkg.value(pkg.load(p)).tolist()


SCENARIOS = {"truncated_shard_falls_back": _truncated,
             "bit_flipped_shard_falls_back": _flipped,
             "corrupt_committed_raises": _corrupt_committed,
             "uncommitted_newest_ignored": _uncommitted_newest,
             "writer_fault_surfaces_then_recovers": _writer_fault_then_recover,
             "writer_fault_on_next_submit": _writer_fault_on_next_submit,
             "fail_nth_rename_keeps_last_good": _fail_nth_rename,
             "tier1_atomic_under_rename_failure": _tier1_atomic,
             "tier1_corruption_detected": _tier1_corrupt,
             "tier1_async_save_lands": _tier1_async}


@pytest.mark.chaos
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fast_chaos_matches_jax(tmp_path, name):
    """Each fault gives the port what it gives the JAX package."""
    got = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        got[side] = SCENARIOS[name](_Pkg(side), d)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# the reference's round-trip cases, on the port
# ---------------------------------------------------------------------------

class TestPortRoundTrip:
    def test_missing_key_raises(self, tmp_path):
        TC.save_state_dict({"a": torch.zeros(2)}, str(tmp_path / "c"))
        with pytest.raises(KeyError, match="lacks"):
            TC.load_state_dict({"zzz": torch.zeros(2)}, str(tmp_path / "c"))

    def test_shape_mismatch_raises(self, tmp_path):
        TC.save_state_dict({"a": torch.zeros(4)}, str(tmp_path / "c"))
        with pytest.raises(ValueError, match="shape mismatch"):
            TC.load_state_dict({"a": torch.zeros(5)}, str(tmp_path / "c"))

    def test_empty_and_zero_dim(self, tmp_path):
        TC.save_state_dict({}, str(tmp_path / "e"))
        assert TC.manifest.is_committed(str(tmp_path / "e"))
        TC.load_state_dict({}, str(tmp_path / "e"))
        src = {"step": torch.tensor(41.0), "count": torch.tensor(7)}
        TC.save_state_dict(src, str(tmp_path / "z"))
        dst = {"step": torch.tensor(0.0), "count": torch.tensor(0)}
        TC.load_state_dict(dst, str(tmp_path / "z"))
        assert float(dst["step"]) == 41.0 and int(dst["count"]) == 7

    def test_multihost_metadata_union(self, tmp_path):
        """A JAX save over 8 devices split into two rank files with the
        coordinator's metadata listing only its own shards: the port finds
        the rest through the per-rank meta files."""
        ck = tmp_path / "c"
        w = np.random.default_rng(4).standard_normal((16, 4)).astype(
            np.float32)
        JC.save_state_dict({"w": _jax_sharded(w, "rows8")}, str(ck))
        with open(ck / "data_0.pkl", "rb") as f:
            payload = pickle.load(f)
        with open(ck / "metadata.pkl", "rb") as f:
            meta = pickle.load(f)
        keep, moved = payload["w"][:4], payload["w"][4:]
        moved_idx = {idx for idx, _ in moved}
        payload["w"] = keep
        with open(ck / "data_0.pkl", "wb") as f:
            pickle.dump(payload, f)
        with open(ck / "data_1.pkl", "wb") as f:
            pickle.dump({"w": moved}, f)
        kept = [r for r in meta["w"]["shards"] if r["index"] not in moved_idx]
        meta["w"]["shards"] = kept
        with open(ck / "metadata.pkl", "wb") as f:
            pickle.dump(meta, f)
        with open(ck / "meta_0.pkl", "wb") as f:
            pickle.dump({"w": kept}, f)
        with open(ck / "meta_1.pkl", "wb") as f:
            pickle.dump({"w": [{"file": "data_1.pkl", "index": idx}
                               for idx, _ in moved]}, f)
        TC.manifest.write_manifest(str(ck), ["data_0.pkl", "meta_0.pkl",
                                             "metadata.pkl"], rank=0)
        TC.manifest.write_manifest(str(ck), ["data_1.pkl", "meta_1.pkl"],
                                   rank=1)
        TC.manifest.mark_committed(str(ck))
        dst = {"w": torch.zeros(16, 4)}
        TC.load_state_dict(dst, str(ck))
        np.testing.assert_array_equal(dst["w"].numpy(), w)

    def test_missing_shard_is_corruption(self, tmp_path):
        ck = tmp_path / "c"
        JC.save_state_dict({"w": _jax_sharded(np.ones((16, 4), np.float32),
                                              "rows8")}, str(ck))
        with open(ck / "metadata.pkl", "rb") as f:
            meta = pickle.load(f)
        meta["w"]["shards"] = meta["w"]["shards"][:3]
        with open(ck / "metadata.pkl", "wb") as f:
            pickle.dump(meta, f)
        with open(ck / "meta_0.pkl", "wb") as f:
            pickle.dump({"w": meta["w"]["shards"]}, f)
        with pytest.raises(CheckpointCorruptionError, match="coverage"):
            TC.load_state_dict({"w": torch.zeros(16, 4)}, str(ck),
                               verify=False)

    def test_smaller_world_resave_ignores_stale_rank_files(self, tmp_path):
        ck = tmp_path / "c"
        TC.save_state_dict({"w": torch.zeros(8)}, str(ck))
        stale = {"w": [(((4, 8, 1),), np.full(4, 99.0, np.float32))]}
        with open(ck / "data_1.pkl", "wb") as f:
            pickle.dump(stale, f)
        with open(ck / "meta_1.pkl", "wb") as f:
            pickle.dump({"w": [{"file": "data_1.pkl",
                                "index": ((4, 8, 1),)}]}, f)
        TC.manifest.write_manifest(str(ck), ["data_1.pkl", "meta_1.pkl"],
                                   rank=1)
        assert TC.manifest.committed_world(str(ck)) == 1
        TC.manifest.verify(str(ck))
        dst = {"w": torch.full((8,), -1.0)}
        TC.load_state_dict(dst, str(ck))
        assert torch.equal(dst["w"], torch.zeros(8))

    def test_streamed_digests_match_a_reread(self, tmp_path):
        """The manifest's digests, taken while each file streamed to disk,
        equal the SHA-256 of the file read back (what JAX records)."""
        TC.save_state_dict({"w": torch.randn(64, 8),
                            "h": torch.randn(5).bfloat16()},
                           str(tmp_path / "c"))
        import json
        from paddle_tpu.framework.integrity import sha256_file
        with open(tmp_path / "c" / "manifest_0.json") as f:
            files = json.load(f)["files"]
        assert set(files) == {"data_0.pkl", "meta_0.pkl", "metadata.pkl"}
        for fname, rec in files.items():
            p = str(tmp_path / "c" / fname)
            assert rec["sha256"] == sha256_file(p)
            assert rec["bytes"] == os.path.getsize(p)
        assert JC.manifest.verify(str(tmp_path / "c"))
