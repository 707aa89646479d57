"""The port's launcher and elastic layer
(``paddle_tpu_torch.distributed.launch``, ``.elastic``, ``.store`` and the
launched world of ``collective.init_parallel_env``), mirroring
``tests/test_launch.py`` class by class on the CPU.

Children are plain Python scripts written per test; they find the
repository from this file's path, run on the CPU, join the gloo process
group (short timeouts) only where the test needs the collectives, and save
and resume through the port's distributed checkpoint. Every rendezvous
and store binds port 0. The argument parser equals the JAX launcher's on
the same argv. The reference marks scale-in, scale-out and the
two-process loss parity slow (``tests/test_launch.py:282``, ``:369``,
``:468``: each starts JAX in every child); here each takes under 10 s on
the CPU, so none is marked.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed.launch.main import _parse as jax_parse
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.distributed.launch.main import (HUNG_RC, _parse,
                                                      launch_procs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the head of every child that imports the port: the repository first on
# the path, one thread (the suite runs several workers at once)
HEAD = f"""
import os, sys
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(1)
"""


def _script(tmp_path, body, head=False):
    """``body`` (dedented) as ``train.py``, after :data:`HEAD` when
    ``head``."""
    p = tmp_path / "train.py"
    p.write_text((HEAD if head else "") + textwrap.dedent(body))
    return str(p)


def _args(tmp_path, script, *extra):
    return _parse([*extra, "--log_dir", str(tmp_path / "log"), script])


def _logs(tmp_path, n):
    return [(tmp_path / "log" / f"workerlog.{r}").read_text()
            for r in range(n)]


class TestLaunch:
    def test_single_proc_env_and_log(self, tmp_path):
        script = _script(tmp_path, """
            import os
            print("rank", os.environ["PADDLE_TRAINER_ID"],
                  "world", os.environ["PADDLE_TRAINERS_NUM"],
                  "master", os.environ["PADDLE_MASTER"])
        """)
        rc = launch_procs(_args(tmp_path, script))
        assert rc == 0
        assert "rank 0 world 1" in _logs(tmp_path, 1)[0]

    def test_multi_proc_ranks(self, tmp_path):
        script = _script(tmp_path, """
            import os
            print("R%s/%s" % (os.environ["PADDLE_TRAINER_ID"],
                              os.environ["PADDLE_TRAINERS_NUM"]))
        """)
        rc = launch_procs(_args(tmp_path, script, "--nproc_per_node", "3"))
        assert rc == 0
        for r, log in enumerate(_logs(tmp_path, 3)):
            assert f"R{r}/3" in log

    def test_env_contract(self, tmp_path):
        """The launcher's environment: ``--devices`` becomes
        ``CUDA_VISIBLE_DEVICES`` (not the JAX package's
        ``TPU_VISIBLE_DEVICES``), no ``JAX_PLATFORMS`` is set, and the
        checkpoint root, grace, job id, local rank and round pass
        through."""
        script = _script(tmp_path, """
            import json, os
            keys = ["PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                    "PADDLE_MASTER", "PADDLE_LOCAL_RANK",
                    "PADDLE_RESTART_ROUND", "PADDLE_JOB_ID",
                    "PADDLE_CHECKPOINT_DIR", "PADDLE_PREEMPT_GRACE",
                    "CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_DEVICES",
                    "JAX_PLATFORMS"]
            print("ENV" + json.dumps({k: os.environ.get(k) for k in keys}))
        """)
        env_bak = dict(os.environ)
        os.environ.pop("JAX_PLATFORMS", None)
        try:
            rc = launch_procs(_args(
                tmp_path, script, "--nproc_per_node", "2", "--devices",
                "0,1", "--job_id", "j7", "--ckpt_dir", str(tmp_path / "ck"),
                "--preempt_grace", "4"))
        finally:
            os.environ.clear()
            os.environ.update(env_bak)
        assert rc == 0
        envs = [json.loads(log.split("ENV", 1)[1].splitlines()[0])
                for log in _logs(tmp_path, 2)]
        for r, e in enumerate(envs):
            assert e["PADDLE_TRAINER_ID"] == e["PADDLE_LOCAL_RANK"] == str(r)
            assert e["PADDLE_TRAINERS_NUM"] == "2"
            assert e["PADDLE_RESTART_ROUND"] == "0"
            assert e["PADDLE_JOB_ID"] == "j7"
            assert e["PADDLE_CHECKPOINT_DIR"] == str(tmp_path / "ck")
            assert e["PADDLE_PREEMPT_GRACE"] == "4.0"
            assert e["CUDA_VISIBLE_DEVICES"] == "0,1"
            assert e["TPU_VISIBLE_DEVICES"] is None
            assert e["JAX_PLATFORMS"] is None
        assert envs[0]["PADDLE_MASTER"] == envs[1]["PADDLE_MASTER"]

    def test_parse_matches_jax(self):
        """The same argv through both launchers' parsers gives the same
        namespace."""
        argv = ["--nproc_per_node", "4", "--gpus", "0,1", "--elastic_level",
                "2", "--elastic_timeout", "7.5", "--elastic_rejoin_file",
                "/tmp/r", "--elastic_min_nprocs", "1",
                "--elastic_max_nprocs", "8", "--ckpt_dir", "/tmp/ck",
                "--preempt_grace", "9", "--log_dir", "lg", "--job_id", "j",
                "--master", "127.0.0.1:1", "--rank", "0", "train.py",
                "--lr", "0.1"]
        assert vars(_parse(argv)) == vars(jax_parse(argv))
        assert vars(_parse(["t.py"])) == vars(jax_parse(["t.py"]))

    def test_failure_propagates_and_kills_peers(self, tmp_path):
        script = _script(tmp_path, """
            import os, sys, time
            if os.environ["PADDLE_TRAINER_ID"] == "1":
                sys.exit(3)
            time.sleep(30)   # would time out unless killed by the launcher
        """)
        t0 = time.time()
        rc = launch_procs(_args(tmp_path, script, "--nproc_per_node", "2"))
        assert rc == 3
        assert time.time() - t0 < 25  # rank 0 was terminated, not waited out

    def test_elastic_restart_until_success(self, tmp_path):
        marker = tmp_path / "attempts"
        script = _script(tmp_path, f"""
            import os, sys
            p = {str(marker)!r}
            n = int(open(p).read()) if os.path.exists(p) else 0
            open(p, "w").write(str(n + 1))
            sys.exit(0 if n >= 2 else 1)   # succeed on the 3rd attempt
        """)
        rc = launch_procs(_args(tmp_path, script, "--max_restart", "3"))
        assert rc == 0
        assert marker.read_text() == "3"

    def test_elastic_exhausted(self, tmp_path):
        script = _script(tmp_path, "import sys; sys.exit(9)")
        rc = launch_procs(_args(tmp_path, script, "--max_restart", "1"))
        assert rc == 9

    def test_module_entrypoint(self, tmp_path):
        script = _script(tmp_path, "print('hello from child')")
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        out = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--log_dir", str(tmp_path / "log"), script],
            cwd=REPO, env=env, capture_output=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "hello from child" in _logs(tmp_path, 1)[0]


class TestElasticDetection:
    def test_heartbeat_monitor_unit(self):
        """Worker stamps -> the monitor sees them; a stale stamp -> hung."""
        mon = elastic.HeartbeatMonitor("jobX")
        try:
            assert mon.hung_ranks([0, 1], ttl=0.2) == []  # never beat: quiet
            os.environ["PADDLE_JOB_ID"] = "jobX"
            t = elastic.start_heartbeat(store_addr=mon.addr, rank=0,
                                        interval=0.1)
            assert t is not None
            time.sleep(0.4)
            assert mon.last_beat(0) is not None
            assert mon.hung_ranks([0], ttl=5.0) == []
            elastic.stop_heartbeat()
            time.sleep(0.8)
            assert mon.hung_ranks([0], ttl=0.5) == [0]   # stamp went stale
            mon.clear(2)
            assert mon.last_beat(0) is None
        finally:
            elastic.stop_heartbeat()
            os.environ.pop("PADDLE_JOB_ID", None)
            mon.close()

    def test_store_roundtrip_and_missing_key(self):
        """The launcher's store on port 0: a client reads what another
        set; ``get`` of a missing or deleted key raises ``KeyError`` at
        once (torch's own ``get`` blocks); a closed store refuses."""
        from paddle_tpu_torch.distributed.store import TCPStore
        master = TCPStore(is_master=True, timeout=5)
        client = TCPStore(port=master.port, timeout=5)
        try:
            assert master.port > 0
            client.set("hb/j/0", "1.5")
            assert master.get("hb/j/0") == b"1.5"
            t0 = time.time()
            with pytest.raises(KeyError):
                client.get("hb/j/1")
            assert time.time() - t0 < 2
            assert master.delete_key("hb/j/0")
            with pytest.raises(KeyError):
                client.get("hb/j/0")
            client.close()
            client.close()
            with pytest.raises(RuntimeError, match="closed"):
                client.set("k", "v")
        finally:
            client.close()
            master.close()

    def test_stop_heartbeat_idempotent_and_joins(self):
        """``stop_heartbeat`` is idempotent and joins the beat thread; a
        fresh ``start_heartbeat`` afterwards works."""
        mon = elastic.HeartbeatMonitor("jobLC")
        try:
            os.environ["PADDLE_JOB_ID"] = "jobLC"
            t = elastic.start_heartbeat(store_addr=mon.addr, rank=0,
                                        interval=0.1)
            assert t is not None and t.daemon
            assert elastic.start_heartbeat(store_addr=mon.addr) is None
            beats = [x for x in threading.enumerate()
                     if x.name == "elastic-heartbeat"]
            assert beats == [t], beats
            time.sleep(0.3)
            assert mon.last_beat(0) is not None
            elastic.stop_heartbeat()
            assert not t.is_alive()            # joined, not just signalled
            elastic.stop_heartbeat()
            elastic.stop_heartbeat()
            t2 = elastic.start_heartbeat(store_addr=mon.addr, rank=0,
                                         interval=0.1)
            assert t2 is not None and t2 is not t
            time.sleep(0.3)
            assert mon.last_beat(0) is not None
        finally:
            elastic.stop_heartbeat()
            os.environ.pop("PADDLE_JOB_ID", None)
            mon.close()

    def test_unreachable_store_warns_and_returns_none(self):
        """Liveness never aborts training: a store nobody listens on warns
        and gives no thread."""
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        elastic._CONNECT_TIMEOUT_S, was = 0.5, elastic._CONNECT_TIMEOUT_S
        try:
            with pytest.warns(UserWarning, match="heartbeat disabled"):
                assert elastic.start_heartbeat(
                    store_addr=f"127.0.0.1:{port}") is None
        finally:
            elastic._CONNECT_TIMEOUT_S = was

    def test_preemption_handler_flag_and_save_fn(self):
        """SIGTERM -> ``preempted()`` flips and the emergency ``save_fn``
        runs (``exit_code=None``: the handler must not exit)."""
        ran = []
        try:
            elastic.install_preemption_handler(
                save_fn=lambda: ran.append(1), deadline=5.0, exit_code=None)
            assert not elastic.preempted()
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.2)
            assert elastic.preempted()
            assert ran == [1]
        finally:
            elastic.uninstall_preemption_handler()
        assert not elastic.preempted()

    def test_hung_worker_detected_job_restarts_and_resumes(self, tmp_path):
        """Rank 1 freezes (SIGSTOP) mid-training; the launcher's heartbeat
        watch declares it hung, kills the job and restarts it with a fresh
        rendezvous; the script resumes from the distributed checkpoint and
        finishes."""
        ckpt_dir = tmp_path / "ckpt"
        ckpt_dir.mkdir()
        script = _script(tmp_path, head=True, body=f"""
            import signal, time
            rank = int(os.environ["PADDLE_TRAINER_ID"])
            rnd = int(os.environ["PADDLE_RESTART_ROUND"])
            from paddle_tpu_torch.distributed.elastic import start_heartbeat
            start_heartbeat(interval=0.25)
            from paddle_tpu_torch.distributed.checkpoint import (
                load_state_dict, save_state_dict)
            ck = {str(ckpt_dir)!r}
            state = {{"w": torch.zeros(3, 1), "step": torch.zeros(())}}
            if os.path.exists(os.path.join(ck, "metadata.pkl")):
                load_state_dict(state, ck)
                open(os.path.join(ck, "resumed.%d" % rank), "w").write(
                    str(float(state["step"])))
            start = int(float(state["step"]))
            g = torch.Generator().manual_seed(0)
            X = torch.randn(32, 3, generator=g)
            y = X @ torch.tensor([[1.5], [-2.0], [0.5]])
            w = state["w"].clone()
            for step in range(start, 8):
                w = w - 0.1 * (2 * X.T @ (X @ w - y) / X.shape[0])
                if rank == 0:
                    save_state_dict({{"w": w,
                                      "step": torch.tensor(step + 1.0)}}, ck)
                if rnd == 0 and rank == 1 and step == 3:
                    os.kill(os.getpid(), signal.SIGSTOP)   # freeze == hung
                time.sleep(0.05)
            final = float(((X @ w - y) ** 2).mean())
            open(os.path.join(ck, "final.%d" % rank), "w").write(str(final))
        """)
        env_bak = dict(os.environ)
        os.environ["PADDLE_HEARTBEAT_INTERVAL"] = "0.25"
        try:
            rc = launch_procs(_args(tmp_path, script, "--nproc_per_node", "2",
                                    "--max_restart", "2",
                                    "--elastic_timeout", "2.5"))
        finally:
            os.environ.clear()
            os.environ.update(env_bak)
        logs = _logs(tmp_path, 2)
        assert rc == 0, logs
        assert (ckpt_dir / "resumed.1").exists(), logs
        assert float((ckpt_dir / "resumed.1").read_text()) >= 3
        final = float((ckpt_dir / "final.1").read_text())
        assert np.isfinite(final) and final < 0.5, final

    def test_hung_round_gives_hung_rc_without_restarts(self, tmp_path):
        """With one restart round and a worker that freezes in every
        round, the job's rc is ``HUNG_RC`` (98)."""
        script = _script(tmp_path, head=True, body="""
            import signal, time
            from paddle_tpu_torch.distributed.elastic import start_heartbeat
            start_heartbeat(interval=0.2)
            time.sleep(0.6)
            os.kill(os.getpid(), signal.SIGSTOP)
        """)
        rc = launch_procs(_args(tmp_path, script, "--max_restart", "1",
                                "--elastic_timeout", "1.5"))
        assert rc == HUNG_RC


class TestLaunchDistributedInit:
    def test_two_process_collective(self, tmp_path):
        """The launcher's environment drives the port's
        ``init_parallel_env`` into gloo's process group: rank and world
        size are right, and ``all_reduce`` (sum, avg, max), ``all_gather``,
        ``broadcast``, ``reduce_scatter``, ``alltoall``, ``scatter`` (both
        forms) and ``barrier`` run across the two processes, and the
        heartbeat starts from the exported store."""
        script = _script(tmp_path, head=True, body="""
            from paddle_tpu_torch.distributed import collective as C
            from paddle_tpu_torch.distributed import elastic
            C.init_parallel_env(timeout=60)
            r, n = C.get_rank(), C.get_world_size()
            assert (r, n) == (int(os.environ["PADDLE_TRAINER_ID"]), 2)
            assert elastic._pause_event() is not None   # heartbeat runs
            x = torch.tensor([r + 1.0, 10.0 * r])
            C.all_reduce(x)
            a = torch.tensor([r + 1.0]); C.all_reduce(a, op=C.ReduceOp.AVG)
            m = torch.tensor([r + 1.0]); C.all_reduce(m, op=C.ReduceOp.MAX)
            g = C.all_gather(torch.tensor([float(r)]))
            lst = []
            C.all_gather(lst, torch.tensor([r * 2.0]))
            b = torch.tensor([r * 5.0]); C.broadcast(b, src=1)
            rs = C.reduce_scatter(torch.arange(4.0) * (r + 1))
            a2a = C.alltoall(torch.arange(4.0) + 10 * r)
            sc = torch.empty(1)
            C.scatter(sc, [torch.tensor([10.0 * r + 1]),
                           torch.tensor([10.0 * r + 2])], src=1)
            part = C.scatter(torch.arange(4.0) + 100 * r, src=0)
            C.barrier()
            assert x.tolist() == [3.0, 10.0], x
            assert a.tolist() == [1.5] and m.tolist() == [2.0], (a, m)
            assert g.tolist() == [0.0, 1.0], g
            assert [t.item() for t in lst] == [0.0, 2.0], lst
            assert b.tolist() == [5.0], b
            assert rs.tolist() == ([0.0, 3.0] if r == 0 else [6.0, 9.0]), rs
            assert a2a.tolist() == ([0.0, 1.0, 10.0, 11.0] if r == 0
                                    else [2.0, 3.0, 12.0, 13.0]), a2a
            assert sc.tolist() == [11.0 + r], sc
            assert part.tolist() == [2.0 * r, 2.0 * r + 1], part
            print("COLLECTIVE_OK rank", r)
        """)
        rc = launch_procs(_args(tmp_path, script, "--nproc_per_node", "2",
                                "--max_restart", "1",
                                "--elastic_timeout", "30"))
        logs = _logs(tmp_path, 2)
        assert rc == 0, logs
        for log in logs:
            assert "COLLECTIVE_OK" in log, log


# a toy dp job shared by scale-in and scale-out: linear regression, rank r
# trains on rows r::world, rank 0 saves a distributed checkpoint each step
_RESCALE = HEAD + """
import time
rank = int(os.environ["PADDLE_TRAINER_ID"])
world = int(os.environ["PADDLE_TRAINERS_NUM"])
rnd = int(os.environ["PADDLE_RESTART_ROUND"])
from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                     save_state_dict)
ck = {ck!r}
state = {{"w": torch.zeros(3, 1), "step": torch.zeros(())}}
if os.path.exists(os.path.join(ck, "metadata.pkl")):
    load_state_dict(state, ck)
    open(os.path.join(ck, "resumed.w%d.r%d" % (world, rank)), "w").write(
        str(float(state["step"])))
start = int(float(state["step"]))
g = torch.Generator().manual_seed(0)
Xall = torch.randn(32, 3, generator=g)
X = Xall[rank::world]
y = X @ torch.tensor([[1.5], [-2.0], [0.5]])
w = state["w"].clone()
for step in range(start, 10):
    w = w - 0.1 * (2 * X.T @ (X @ w - y) / X.shape[0])
    if rank == 0:
        save_state_dict({{"w": w, "step": torch.tensor(step + 1.0)}}, ck)
        open(os.path.join(ck, "saved.%d" % (step + 1)), "w").write("1")
{fault}
final = float(((X @ w - y) ** 2).mean())
open(os.path.join(ck, "final.w%d.r%d" % (world, rank)), "w").write(str(final))
"""


class TestElasticScaleIn:
    def test_2proc_loses_worker_restarts_as_1proc_and_resumes(self,
                                                              tmp_path):
        """A 2-process dp job loses rank 1; with ``--elastic_min_nprocs``
        the next round runs at the surviving world size (1) and resumes
        from the 2-process checkpoint (reshard-on-load), and converges."""
        ckpt_dir = tmp_path / "ckpt"
        ckpt_dir.mkdir()
        fault = """
    if rnd == 0 and rank == 1 and step == 3:
        while not os.path.exists(os.path.join(ck, "saved.4")):
            time.sleep(0.05)
        os._exit(17)
    if rnd == 0:
        time.sleep(0.2)
"""
        script = _script(tmp_path, _RESCALE.format(ck=str(ckpt_dir),
                                                   fault=fault))
        rc = launch_procs(_args(tmp_path, script, "--nproc_per_node", "2",
                                "--max_restart", "2",
                                "--elastic_min_nprocs", "1"))
        assert rc == 0, _logs(tmp_path, 1)[0]
        resumed = list(ckpt_dir.glob("resumed.w1.r0"))
        assert resumed, list(ckpt_dir.iterdir())
        assert float(resumed[0].read_text()) >= 3
        final = float((ckpt_dir / "final.w1.r0").read_text())
        assert np.isfinite(final) and final < 0.5, final
        assert not list(ckpt_dir.glob("final.w2.*"))


class TestMultiProcessTrainingParity:
    def test_2proc_dp_training_loss_parity_vs_serial(self, tmp_path):
        """Two launched processes train a tiny MLP data-parallel (each
        rank's half of the batch, gradients averaged by ``all_reduce(...,
        op=AVG)`` over gloo as one flat buffer) and reproduce the serial
        loss trajectory on the whole batch within 1e-5."""
        out_dir = tmp_path / "out"
        out_dir.mkdir()
        script = _script(tmp_path, head=True, body=f"""
            import json
            from paddle_tpu_torch.distributed import collective as C
            world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
            if world > 1:
                C.init_parallel_env(timeout=60)
            rank = C.get_rank()
            g = torch.Generator().manual_seed(0)
            W1 = torch.randn(4, 16, generator=g, dtype=torch.float64) * 0.3
            W2 = torch.randn(16, 1, generator=g, dtype=torch.float64) * 0.3
            X = torch.randn(8, 4, generator=g, dtype=torch.float64)
            Y = X @ torch.randn(4, 1, generator=g, dtype=torch.float64)
            x, y = X[rank::world], Y[rank::world]
            losses = []
            for _ in range(6):
                W1.requires_grad_(True); W2.requires_grad_(True)
                loss = ((torch.tanh(x @ W1) @ W2 - y) ** 2).mean()
                g1, g2 = torch.autograd.grad(loss, [W1, W2])
                flat = torch.cat([g1.reshape(-1), g2.reshape(-1),
                                  loss.detach().reshape(1)])
                if world > 1:
                    C.all_reduce(flat, op=C.ReduceOp.AVG)
                with torch.no_grad():
                    W1 = W1 - 0.1 * flat[:64].reshape(4, 16)
                    W2 = W2 - 0.1 * flat[64:80].reshape(16, 1)
                losses.append(float(flat[80]))
            if rank == 0:
                tag = "dp" if world > 1 else "serial"
                open(os.path.join({str(out_dir)!r}, tag + ".json"),
                     "w").write(json.dumps(losses))
        """)
        rc2 = launch_procs(_args(tmp_path, script, "--nproc_per_node", "2"))
        rc1 = launch_procs(_args(tmp_path, script, "--nproc_per_node", "1"))
        assert rc2 == 0 and rc1 == 0, _logs(tmp_path, 2)
        dp = json.loads((out_dir / "dp.json").read_text())
        serial = json.loads((out_dir / "serial.json").read_text())
        np.testing.assert_allclose(dp, serial, rtol=1e-5, atol=1e-6)
        assert dp[-1] < dp[0]


class TestElasticScaleOut:
    def test_1proc_scales_back_to_2proc_on_rejoin(self, tmp_path):
        """A job below its full world (1 process, ``--elastic_max_nprocs
        2``) sees the rejoin signal, restarts at 2 processes and resumes
        from the 1-process checkpoint."""
        ckpt_dir = tmp_path / "ckpt"
        ckpt_dir.mkdir()
        rejoin = tmp_path / "rejoin.signal"
        fault = f"""
    if rnd == 0 and step == 3:
        open({str(rejoin)!r}, "w").write("2")
    if rnd == 0:
        time.sleep(0.3)
"""
        script = _script(tmp_path, _RESCALE.format(ck=str(ckpt_dir),
                                                   fault=fault))
        rc = launch_procs(_args(tmp_path, script, "--nproc_per_node", "1",
                                "--max_restart", "2",
                                "--elastic_max_nprocs", "2",
                                "--elastic_rejoin_file", str(rejoin)))
        assert rc == 0, _logs(tmp_path, 1)[0]
        resumed = list(ckpt_dir.glob("resumed.w2.r*"))
        assert len(resumed) == 2, list(ckpt_dir.iterdir())
        assert all(float(p.read_text()) >= 3 for p in resumed)
        for r in range(2):
            final = float((ckpt_dir / f"final.w2.r{r}").read_text())
            assert np.isfinite(final) and final < 0.5, final
