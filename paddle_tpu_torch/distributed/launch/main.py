"""The launcher — counterpart of ``paddle_tpu/distributed/launch/main.py``.

It starts ``--nproc_per_node`` copies of a training script, one process a
rank, each with its log in ``<log_dir>/workerlog.<rank>``; watches them;
kills the rest when one fails; and, at ``--max_restart`` > 0, restarts the
whole job (a fresh rendezvous port each round) on a crash, a hung rank
(its heartbeat stale for ``--elastic_timeout`` seconds), or a rejoin
signal that offers more workers. The script resumes from its own
checkpoints.

Environment exported to every child:

  PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM   rank and world size
  PADDLE_MASTER             host:port of this round's rendezvous: the
                            ``init_method`` of ``torch.distributed``'s
                            gloo process group (``init_parallel_env``)
  PADDLE_LOCAL_RANK         the rank on this node
  PADDLE_RESTART_ROUND      0 for the first round, then 1, 2, ...
  PADDLE_JOB_ID             ``--job_id`` (the heartbeat keys' namespace)
  PADDLE_ELASTIC_STORE      host:port of the launcher's store (heartbeats),
                            when liveness detection is on
  PADDLE_CHECKPOINT_DIR     ``--ckpt_dir`` (``AsyncCheckpointer``'s root)
  PADDLE_PREEMPT_GRACE      ``--preempt_grace`` seconds
  CUDA_VISIBLE_DEVICES      ``--devices`` / ``--gpus``, when given

A child runs on the card unless its script asks for the CPU; several
ranks may share one card, since the process group is gloo's.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

from ..elastic import EMERGENCY_EXIT_RC

__all__ = ["main", "launch_procs", "write_rejoin_file",
           "read_rejoin_count", "consume_rejoin_file", "HUNG_RC",
           "RESCALE_RC", "PREEMPT_RC"]

HUNG_RC = 98     # job rc when a rank was killed for missing heartbeats
RESCALE_RC = 97  # internal rc: a healthy round interrupted to scale out
PREEMPT_RC = 96  # the launcher was SIGTERMed (preemption): the workers got
#                  --preempt_grace to save, then the job exited without
#                  spending a restart round (the rescheduled job resumes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parse(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a (multi-process) training job")
    p.add_argument("--master", default=None,
                   help="rendezvous host:port (default: a free port on "
                        "localhost, fresh each round)")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", "--rank", type=int, default=0)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes (ranks) on this node")
    p.add_argument("--devices", "--gpus", default=None,
                   help="visible device ids (exported as "
                        "CUDA_VISIBLE_DEVICES)")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--job_id", default="default")
    p.add_argument("--max_restart", "--elastic_level", type=int, default=0,
                   dest="max_restart",
                   help="elastic level: 0 = fail fast (no restarts); N > 0 "
                        "= restart the whole job up to N times on a crash "
                        "or a hung worker (see --elastic_timeout); each "
                        "round gets a fresh rendezvous and the script "
                        "resumes from its own checkpoints")
    p.add_argument("--elastic_timeout", type=float, default=60.0,
                   help="seconds without a worker heartbeat before the rank "
                        "is declared hung and the job restarts. Active only "
                        "when --max_restart > 0; 0 disables liveness "
                        "detection. Workers stamp heartbeats from "
                        "init_parallel_env")
    p.add_argument("--elastic_rejoin_file", default=None,
                   help="a file the infrastructure writes (optionally with "
                        "a worker count) when capacity returns; the watcher "
                        "restarts the round and the next one runs larger "
                        "(scale-out)")
    p.add_argument("--elastic_max_nprocs", type=int, default=0,
                   help="upper bound for elastic scale-out (0 = the "
                        "original --nproc_per_node)")
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint-series root exported to workers as "
                        "PADDLE_CHECKPOINT_DIR; each restart round first "
                        "prunes torn (uncommitted) step dirs")
    p.add_argument("--preempt_grace", type=float, default=15.0,
                   help="seconds between forwarding SIGTERM to the workers "
                        "(exported as PADDLE_PREEMPT_GRACE) and SIGKILL, "
                        "when the launcher itself gets SIGTERM")
    p.add_argument("--elastic_min_nprocs", type=int, default=0,
                   help="scale-in floor: when > 0, a restart after a crash "
                        "or hang runs with the surviving world size (the "
                        "failed ranks dropped, down to this minimum); the "
                        "script derives its degrees from "
                        "PADDLE_TRAINERS_NUM and resumes through the "
                        "distributed checkpoint's reshard-on-load. 0 = a "
                        "fixed world")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


class _Proc:
    def __init__(self, rank: int, popen: subprocess.Popen, log_path: str):
        self.rank = rank
        self.popen = popen
        self.log_path = log_path


def _spawn(args, restart_round: int,
           elastic_store: Optional[str] = None,
           nproc_override: Optional[int] = None) -> List[_Proc]:
    os.makedirs(args.log_dir, exist_ok=True)
    nproc = nproc_override if nproc_override is not None \
        else args.nproc_per_node
    world = args.nnodes * nproc
    # a fresh rendezvous every round: a restarted job must not meet the
    # previous round's state
    master = args.master or f"127.0.0.1:{_free_port()}"
    procs = []
    for local_rank in range(nproc):
        rank = args.node_rank * nproc + local_rank
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_MASTER": master,
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_RESTART_ROUND": str(restart_round),
            "PADDLE_JOB_ID": args.job_id,
            "PADDLE_PREEMPT_GRACE": str(args.preempt_grace),
        })
        if elastic_store:
            env["PADDLE_ELASTIC_STORE"] = elastic_store
        if args.ckpt_dir:
            env["PADDLE_CHECKPOINT_DIR"] = args.ckpt_dir
        if args.devices is not None:
            env["CUDA_VISIBLE_DEVICES"] = args.devices
        log_path = os.path.join(args.log_dir, f"workerlog.{rank}")
        with open(log_path, "ab", buffering=0) as logf:
            logf.write(f"==== launch rank {rank} round {restart_round} "
                       f"{time.strftime('%F %T')} ====\n".encode())
            popen = subprocess.Popen(
                [sys.executable, args.training_script,
                 *args.training_script_args],
                env=env, stdout=logf, stderr=subprocess.STDOUT)
        procs.append(_Proc(rank, popen, log_path))
    return procs


# set by the launcher's SIGTERM handler, polled by the watch loop (a bare
# flag is async-signal-safe)
_preempt_flag = {"v": False}


def _kill_all(procs: List[_Proc], grace: float = 10.0,
              force_first: Optional[List[int]] = None):
    force_first = force_first or []
    for q in procs:
        if q.popen.poll() is None:
            # a stopped or hung process will not act on SIGTERM
            if q.rank in force_first:
                q.popen.kill()
            else:
                q.popen.send_signal(signal.SIGTERM)
    deadline = time.time() + grace
    for q in procs:
        try:
            q.popen.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            q.popen.kill()
            q.popen.wait()


def _check_rejoin(path) -> int:
    """The worker count a rejoin signal file offers (0: no signal). An
    empty file means "capacity is back, take what you need"."""
    if not path or not os.path.exists(path):
        return 0
    try:
        with open(path) as f:
            txt = f.read().strip()
        return int(txt) if txt else 10 ** 9
    except (OSError, ValueError):
        return 10 ** 9


read_rejoin_count = _check_rejoin


def write_rejoin_file(path: str, workers: Optional[int] = None) -> str:
    """Write the ``--elastic_rejoin_file`` signal (empty: take what you
    need; an integer: the offered worker count), atomically."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        if workers is not None:
            f.write(str(int(workers)))
    os.replace(tmp, path)
    return path


def consume_rejoin_file(path: Optional[str]) -> int:
    """Read one rejoin signal and remove the file (a zero-count one too),
    so the next round starts clean; returns the offered count."""
    offered = _check_rejoin(path)
    if path:
        try:
            os.remove(path)
        except OSError:
            pass
    return offered


def _watch(procs: List[_Proc], monitor=None, ttl: float = 0.0,
           rejoin_file=None, want_more: bool = False,
           preempt_grace: float = 15.0):
    """Wait for every child; on a nonzero exit kill the rest. With a
    heartbeat ``monitor``, a rank whose stamp is stale for ``ttl`` seconds
    is declared hung and killed with the rest (rc :data:`HUNG_RC`). A rank
    that exits :data:`EMERGENCY_EXIT_RC`, or SIGTERM to the launcher, is a
    preemption (rc :data:`PREEMPT_RC`). Returns ``(rc, failed ranks)``."""
    try:
        last_hb_check = 0.0
        while True:
            if _preempt_flag["v"]:
                print(f"launch: SIGTERM received — forwarding to workers "
                      f"with {preempt_grace}s emergency-checkpoint grace",
                      file=sys.stderr)
                _kill_all(procs, grace=preempt_grace)
                return PREEMPT_RC, []
            alive = 0
            for p in procs:
                rc = p.popen.poll()
                if rc is None:
                    alive += 1
                elif rc == EMERGENCY_EXIT_RC:
                    print(f"rank {p.rank} exited after an emergency "
                          f"checkpoint (preempted); forwarding SIGTERM to "
                          f"peers with {preempt_grace}s grace",
                          file=sys.stderr)
                    _kill_all(procs, grace=preempt_grace)
                    return PREEMPT_RC, []
                elif rc != 0:
                    # every rank already dead, before the kill makes the
                    # terminated peers report nonzero too
                    dead = [q.rank for q in procs
                            if q.popen.poll() not in (None, 0)]
                    _kill_all(procs)
                    print(f"rank(s) {dead} exited nonzero (first: rank "
                          f"{p.rank} rc {rc}, log: {p.log_path}); peers "
                          f"terminated", file=sys.stderr)
                    return rc, dead
            if alive == 0:
                return 0, []
            if want_more and _check_rejoin(rejoin_file):
                print("elastic: rejoin signal observed — interrupting the "
                      "round to scale out", file=sys.stderr)
                _kill_all(procs, grace=5.0)
                return RESCALE_RC, []
            if monitor is not None and ttl > 0 and \
                    time.time() - last_hb_check > min(1.0, ttl / 3):
                last_hb_check = time.time()
                live = [p.rank for p in procs if p.popen.poll() is None]
                hung = monitor.hung_ranks(live, ttl)
                if hung:
                    print(f"elastic: rank(s) {hung} missed heartbeats for "
                          f"> {ttl}s — declaring hung, terminating the job",
                          file=sys.stderr)
                    _kill_all(procs, grace=3.0, force_first=hung)
                    return HUNG_RC, list(hung)
            time.sleep(0.2)
    except KeyboardInterrupt:
        _kill_all(procs, grace=5.0)
        return 130, []


def launch_procs(args) -> int:
    """Run the job with elastic restarts; returns the job's rc."""
    rounds = args.max_restart + 1
    # liveness detection only with restarts: without one, a hung-kill
    # would turn a stall into a failure with no recovery
    ttl = float(args.elastic_timeout or 0.0) if args.max_restart > 0 \
        else 0.0
    monitor = None
    if ttl > 0:
        from ..elastic import HeartbeatMonitor
        monitor = HeartbeatMonitor(args.job_id)
    min_nprocs = int(args.elastic_min_nprocs or 0)
    max_nprocs = int(args.elastic_max_nprocs or 0) or args.nproc_per_node
    rejoin_file = args.elastic_rejoin_file
    preempt_grace = float(args.preempt_grace or 15.0)
    cur_nproc = args.nproc_per_node
    rc = 1

    # SIGTERM to the launcher (the infrastructure's eviction notice) is an
    # emergency-checkpoint window for the workers, not an instant kill;
    # the handler only flips a flag and the watch loop forwards it
    _preempt_flag["v"] = False
    prev_term = None
    try:
        prev_term = signal.signal(
            signal.SIGTERM, lambda s, f: _preempt_flag.__setitem__("v", True))
    except ValueError:
        pass  # not the main thread (embedded use): no preemption watch
    try:
        for attempt in range(rounds):
            if attempt > 0 and args.ckpt_dir:
                # drop torn (uncommitted) step dirs, so any resume policy
                # lands on a committed save
                from ..checkpoint.manifest import prune_uncommitted
                removed = prune_uncommitted(args.ckpt_dir)
                if removed:
                    print(f"elastic: pruned {len(removed)} torn "
                          f"checkpoint dir(s) under {args.ckpt_dir}",
                          file=sys.stderr)
            if monitor is not None:
                monitor.clear(args.nnodes * max(cur_nproc, max_nprocs))
            procs = _spawn(args, attempt,
                           elastic_store=monitor.addr if monitor else None,
                           nproc_override=cur_nproc)
            # interrupt a healthy round for scale-out only when a restart
            # round remains to perform it
            rc, bad = _watch(procs, monitor=monitor, ttl=ttl,
                             rejoin_file=rejoin_file,
                             want_more=(cur_nproc < max_nprocs
                                        and attempt < rounds - 1),
                             preempt_grace=preempt_grace)
            if rc in (0, 130, PREEMPT_RC):
                return rc
            if attempt < rounds - 1:
                if rc == RESCALE_RC or (rejoin_file and
                                        _check_rejoin(rejoin_file)):
                    offered = consume_rejoin_file(rejoin_file)
                    new_nproc = min(max_nprocs,
                                    max(cur_nproc, min(offered,
                                                       max_nprocs)))
                    if new_nproc != cur_nproc:
                        print(f"elastic: scale-out {cur_nproc} -> "
                              f"{new_nproc} procs (rejoin signal)",
                              file=sys.stderr)
                        cur_nproc = new_nproc
                elif min_nprocs > 0 and bad:
                    new_nproc = max(min_nprocs, cur_nproc - len(bad))
                    if new_nproc != cur_nproc:
                        print(f"elastic: scale-in {cur_nproc} -> "
                              f"{new_nproc} procs (lost ranks {bad})",
                              file=sys.stderr)
                    cur_nproc = new_nproc
                print(f"elastic: restarting job (attempt {attempt + 2}/"
                      f"{rounds}; the last round's rc {rc})",
                      file=sys.stderr)
    finally:
        if prev_term is not None:
            try:
                signal.signal(signal.SIGTERM, prev_term)
            except ValueError:
                pass
        if monitor is not None:
            monitor.close()
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    rc = launch_procs(_parse(argv))
    if rc != 0:
        sys.exit(rc)
    return 0


if __name__ == "__main__":
    main()
