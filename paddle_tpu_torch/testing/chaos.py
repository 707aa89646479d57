"""Chaos / fault-injection harness of the port — counterpart of
``paddle_tpu/testing/chaos.py``.

Composable injectors that drive the port's training stack (checkpoint
writer, health sentinel, DataLoader) and serving stack (engine,
supervisor, front-end server, fleet router, offload tier, journal,
adapter pool) through the failure modes a production deployment sees,
so the robustness machinery is EXERCISED, not just written. Every
injector reaches the port's own objects and imports only the port
(``async_writer_fault`` arms the port's writer; ``flood_tenant`` catches
the port's ``ServingQueueFull``; the journal injectors read the port's
WAL framing):

=========================  ==============================================
injector                   fault it models
=========================  ==============================================
``truncate_file``          a file cut short by a crash / full disk
``flip_bits``              silent data corruption (bad DMA, bit rot)
``fail_nth``               the Nth call of ``module.name`` inside a region
                           raising (quota, I/O error) — syscall shim
``async_writer_fault``     an exception inside the background checkpoint
                           writer thread
``kill_self``              the process dying mid-step (preemption without
                           grace, OOM kill)
``nan_payload``            NaN/Inf landing in a batch, an activation or a
                           parameter (the sentinel's bad-step fault)
``bad_sample``             a corrupt record: ``Dataset.__getitem__``
                           raising, transiently (retry) or forever
                           (quarantine)
``dead_worker``            a DataLoader worker killed mid-epoch (fires
                           once; the resurrected replacement survives)
``stalled_consumer``       a streaming client that reads a few tokens then
                           vanishes without draining — the abandoned-
                           stream block leak
``poison_prompt``          a malformed request: out-of-vocab / negative /
                           empty prompts that must not corrupt
                           neighbouring requests' outputs
``flood_tenant``           one tenant burst-submitting until the bounded
                           queue sheds — the noisy-neighbour overload
``engine_crash``           the engine's step loop raising mid-trace — the
                           supervisor must rebuild and resubmit bit-exactly
``disconnect_mid_stream``  a front-end client that consumes a few SSE
                           events then closes the connection
``slow_client``            a front-end client reading slower than the
                           engine produces: its bounded buffer overflows
                           and the server disconnects it through cancel
``replica_kill``           a fleet replica dying for good mid-trace
``slow_replica``           a replica alive but making no progress
``flaky_probe``            a replica whose health surface raises
``host_pressure``          host RAM pressure shrinking the KV offload tier
``corrupt_offload_block``  a bit flip inside a host-offloaded KV block
``kill_prefill_replica``   a prefill replica dying mid-handoff
``stale_directory``        a poisoned fleet-cache-directory entry
``process_kill``           the whole serving process dying without grace
``torn_journal_tail``      a crash mid-append cutting the WAL's last record
``corrupt_snapshot``       bit rot inside the newest state snapshot
``adapter_churn``          hostile LoRA-adapter locality
=========================  ==============================================

The reference's ``stall_heartbeat`` drives its elastic launcher's
heartbeats, which the port does not have yet (ROADMAP item 10a): it is
not here, and :data:`INJECTORS` holds the ported names only. The timeline half (:class:`ChaosEvent`,
:class:`ChaosTimeline`, :func:`chaos_timeline` and the kind tuples) is
the reference's, draw for draw: one seed gives one schedule in both
packages, so a replay manifest moves between them.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import random
import signal
import time
from typing import Optional

__all__ = ["truncate_file", "flip_bits", "fail_nth", "async_writer_fault",
           "kill_self", "nan_payload", "bad_sample", "dead_worker",
           "stalled_consumer", "poison_prompt", "flood_tenant",
           "engine_crash", "disconnect_mid_stream", "slow_client",
           "replica_kill", "slow_replica", "flaky_probe", "host_pressure",
           "corrupt_offload_block", "kill_prefill_replica",
           "stale_directory", "process_kill", "torn_journal_tail",
           "corrupt_snapshot", "adapter_churn",
           "ChaosEvent", "ChaosTimeline", "chaos_timeline",
           "TIMELINE_INJECTORS", "TIER_INJECTORS", "DISAGG_INJECTORS",
           "DURABLE_INJECTORS", "LORA_INJECTORS", "INJECTORS"]


def truncate_file(path: str, frac: float = 0.5,
                  keep_bytes: Optional[int] = None) -> int:
    """Cut ``path`` short (a crash mid-write / disk-full artifact).
    Keeps ``keep_bytes`` bytes when given, else ``frac`` of the file.
    Returns the new size."""
    size = os.path.getsize(path)
    keep = keep_bytes if keep_bytes is not None else int(size * frac)
    keep = max(0, min(size, keep))
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep


def flip_bits(path: str, offset: Optional[int] = None, nbits: int = 8,
              seed: int = 0) -> int:
    """XOR-corrupt ``nbits`` bits at ``offset`` (random position when None)
    — silent corruption a checksum must catch. Returns the offset hit."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot bit-flip empty file {path!r}")
    rng = random.Random(seed)
    if offset is None:
        offset = rng.randrange(size)
    offset = min(offset, size - 1)
    with open(path, "rb+") as f:
        f.seek(offset)
        b = f.read(1)[0]
        mask = 0
        for _ in range(max(1, nbits)):
            mask |= 1 << rng.randrange(8)
        f.seek(offset)
        f.write(bytes([b ^ (mask or 0x01)]))
    return offset


@contextlib.contextmanager
def fail_nth(module, name: str, n: int = 1, exc: Optional[BaseException] = None):
    """Monkeypatched syscall shim: the Nth call (1-based) of
    ``module.name`` inside the region raises (default ``OSError``). Models
    quota/EIO failures at exact protocol positions, e.g.::

        with chaos.fail_nth(os, "replace", n=2):
            save_state_dict(state, path)   # 2nd atomic rename dies
    """
    real = getattr(module, name)
    err = exc if exc is not None else OSError(
        f"chaos: injected failure on call #{n} of {module.__name__}.{name}")
    state = {"calls": 0}

    def shim(*args, **kwargs):
        state["calls"] += 1
        if state["calls"] == n:
            raise err
        return real(*args, **kwargs)

    setattr(module, name, shim)
    try:
        yield state
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def async_writer_fault(exc: Optional[BaseException] = None):
    """Every job the port's background checkpoint writer picks up inside
    the region fails with ``exc`` (stored on the job, surfaced by
    ``wait()``/the next save — the error-propagation contract under
    test)."""
    from ..framework import async_writer
    err = exc if exc is not None else RuntimeError(
        "chaos: injected async-writer fault")
    async_writer.set_fault(err)
    try:
        yield err
    finally:
        async_writer.set_fault(None)


def kill_self(sig: int = signal.SIGKILL) -> None:
    """Die mid-step with no cleanup (default SIGKILL: no atexit, no flush
    — exactly what a preemption without grace or an OOM kill looks like)."""
    os.kill(os.getpid(), sig)


# ---------------------------------------------------------------------------
# runtime-anomaly injectors (health, io.DataLoader)
# ---------------------------------------------------------------------------

def nan_payload(x, frac: float = 1.0, value: float = float("nan"),
                seed: int = 0):
    """Poison a numpy array or a torch tensor (or a nested batch of them)
    with NaN/Inf — an overflowed reduction, a bf16 numerics edge, or
    corrupt DMA landing in an input, activation or parameter buffer: the
    fault the on-device sentinel must catch as a bad step. ``frac`` of the
    elements (chosen by ``seed``, the reference's draw) are replaced;
    returns a poisoned COPY, a tensor's on that tensor's device. Integer
    payloads cannot carry NaN and pass through as copies."""
    import numpy as np
    import torch
    if isinstance(x, dict):
        return {k: nan_payload(v, frac, value, seed) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(nan_payload(v, frac, value, seed) for v in x)
    if isinstance(x, torch.Tensor):
        out = x.detach().clone(memory_format=torch.contiguous_format)
        if not out.is_floating_point():
            return out
        flat = out.view(-1)
    else:
        out = np.array(x, copy=True)
        if not np.issubdtype(out.dtype, np.floating):
            return out
        flat = out.reshape(-1)
    size = flat.shape[0]
    n = max(1, int(size * min(1.0, max(0.0, frac))))
    if n < size:
        idx = random.Random(seed).sample(range(size), n)
        if isinstance(flat, torch.Tensor):
            idx = torch.tensor(idx, device=flat.device)
        flat[idx] = value
    else:
        flat[:] = value
    return out


class bad_sample:
    """Dataset wrapper: ``__getitem__`` raises for the chosen indices — a
    corrupt record / undecodable image. ``fails_each=None`` makes the
    fault DETERMINISTIC (every access raises: the quarantine path);
    ``fails_each=n`` makes it TRANSIENT (the first n accesses per index
    raise, then heal: the retry/backoff path). Counts live in the process
    that fetches (a forked worker counts its own)."""

    def __init__(self, dataset, indices, fails_each: Optional[int] = None,
                 exc_type=ValueError):
        self.dataset = dataset
        self.bad = set(int(i) for i in indices)
        self.fails_each = fails_each
        self.exc_type = exc_type
        self._counts = {}

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        if int(i) in self.bad:
            n = self._counts.get(int(i), 0)
            if self.fails_each is None or n < self.fails_each:
                self._counts[int(i)] = n + 1
                raise self.exc_type(
                    f"chaos: injected bad sample at index {i} "
                    f"(attempt {n + 1})")
        return self.dataset[i]


class dead_worker:
    """Dataset wrapper: the DataLoader worker that fetches ``at_index``
    kills itself (default SIGKILL) — a segfault/OOM in dataset code
    mid-epoch. The death fires ONCE per ``marker`` file (fork-shared), so
    the resurrected replacement survives the re-queued batch."""

    def __init__(self, dataset, at_index: int, marker: str,
                 sig: int = signal.SIGKILL):
        self.dataset = dataset
        self.at_index = int(at_index)
        self.marker = marker
        self.sig = sig

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        if int(i) == self.at_index:
            try:
                fd = os.open(self.marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                pass            # already died once — the replacement lives
            else:
                os.close(fd)
                os.kill(os.getpid(), self.sig)
        return self.dataset[i]


# ---------------------------------------------------------------------------
# serving-overload injectors (inference.serving engine)
# ---------------------------------------------------------------------------

def stalled_consumer(engine, events: int = 2, close: bool = True) -> dict:
    """A streaming client that reads ``events`` tokens from
    ``engine.stream()`` and then VANISHES — the closed-SSE-connection /
    crashed-downstream fault. Before the lifecycle work this leaked the
    in-flight requests' KV blocks until someone else happened to drain
    the engine; now closing the abandoned generator must CANCEL the
    remaining work and return every block to the pool.

    ``close=True`` closes the generator explicitly (what CPython's GC
    does to an abandoned generator, made deterministic for the test).
    Returns ``{"events": tokens consumed, "cancelled": requests
    cancelled by the close}``."""
    gen = engine.stream()
    got = 0
    try:
        for _ in range(max(0, int(events))):
            next(gen)
            got += 1
    except StopIteration:
        pass
    before = engine.stats()["cancelled"]
    if close:
        gen.close()               # the consumer is gone; nobody resumes it
    return {"events": got,
            "cancelled": engine.stats()["cancelled"] - before}


def poison_prompt(prompt, vocab_size: int, mode: str = "oov",
                  seed: int = 0):
    """Corrupt a serving prompt the way a broken tokenizer / malicious
    client would: ``"oov"`` replaces every id with one >= ``vocab_size``
    (an out-of-range embedding lookup — the embedding fills it with NaN,
    as ``jnp.take`` does, and that poison must stay CONTAINED to this
    request), ``"neg"``
    flips ids negative, ``"empty"`` returns a zero-length prompt (must be
    rejected or served, never wedge the engine). Returns the poisoned
    COPY; the recovery proof is that co-scheduled clean requests still
    match the dense oracle bit-for-bit and pool accounting balances."""
    import numpy as np
    p = np.array(prompt, np.int32, copy=True)
    if mode == "empty":
        return p[:0]
    rng = random.Random(seed)
    if mode == "oov":
        return np.asarray([vocab_size + rng.randrange(2 ** 16)
                           for _ in p], np.int32)
    if mode == "neg":
        return -np.abs(p) - 1
    raise ValueError(f"unknown poison_prompt mode {mode!r}")


def flood_tenant(engine, tenant: str, n: int, prompt_len: int = 8,
                 max_new_tokens: int = 4, vocab_size: int = 97,
                 seed: int = 0, **submit_kwargs) -> dict:
    """One tenant burst-submits ``n`` requests — the noisy-neighbour /
    abusive-client overload fault. Submits ride the normal ``submit()``
    path, so the bounded queue SHEDS the overflow (``ServingQueueFull``
    with a retry-after hint) instead of queueing unboundedly; under the
    fair-share policy the flood's ADMITTED share stays proportional to
    its weight, and with a tenant cache quota its churn cannot evict
    other tenants' prefix blocks. Returns ``{"rids": accepted ids,
    "shed": refused submits, "retry_after_s": last hint}``."""
    import numpy as np
    from ..inference.serving.scheduler import ServingQueueFull
    rng = np.random.default_rng(seed)
    rids, shed, hint = [], 0, None
    for _ in range(int(n)):
        p = rng.integers(0, vocab_size, (int(prompt_len),)).astype(np.int32)
        try:
            rids.append(engine.submit(p, max_new_tokens=max_new_tokens,
                                      tenant=tenant, **submit_kwargs))
        except ServingQueueFull as e:
            shed += 1
            hint = e.retry_after_s
    return {"rids": rids, "shed": shed, "retry_after_s": hint}


# ---------------------------------------------------------------------------
# serving front-line injectors (inference.serving server / supervisor)
# ---------------------------------------------------------------------------

def engine_crash(target, at_step: int = 1,
                 exc: Optional[BaseException] = None) -> BaseException:
    """Arm the LIVE serving engine to raise from its step loop after
    ``at_step`` more iterations — a device error or host-side bug landing
    mid-trace. ``target`` is an :class:`EngineSupervisor` (or a bare
    engine). The patch rides the engine instance, so it dies with the
    crashed engine: the supervisor's rebuilt replacement runs clean, and
    the recovery proof is that every request still finishes bit-identical
    to an uninterrupted dense run with BlockManager accounting balanced.
    Returns the armed exception (for matching in asserts)."""
    eng = getattr(target, "engine", target)
    err = exc if exc is not None else RuntimeError(
        f"chaos: injected engine crash at step +{at_step}")
    real = eng._step
    state = {"calls": 0}

    def crashing(max_iters=None):
        state["calls"] += 1
        if state["calls"] >= max(1, int(at_step)):
            raise err
        return real(max_iters)

    eng._step = crashing
    return err


async def disconnect_mid_stream(server, prompt, events: int = 2,
                                **submit_kwargs) -> dict:
    """An asyncio front-line client that consumes ``events`` stream
    events then CLOSES the stream (the SSE tab closed / TCP reset fault,
    made deterministic). Closing must cancel the request through
    ``engine.cancel`` so its KV blocks free immediately. Async — run
    inside the loop the server is bound to. Returns ``{"events": n,
    "rid": srid}``."""
    gen = server.agenerate(prompt, **submit_kwargs)
    got, rid = 0, None
    try:
        async for ev in gen:
            if ev["type"] == "start":
                rid = ev["rid"]
                continue
            got += 1
            if got >= max(0, int(events)):
                break
    finally:
        await gen.aclose()            # the consumer is gone
    return {"events": got, "rid": rid}


async def slow_client(server, prompt, read_events: int = 1,
                      timeout_s: float = 20.0, **submit_kwargs) -> dict:
    """A front-line client that reads ``read_events`` events and then
    STOPS consuming while the engine keeps producing — the slow-consumer
    fault. The per-client buffer (``FLAGS_serving_client_queue`` /
    ``ServingServer(client_queue=)``) overflows, the server marks the
    stream dropped and cancels the request, and the client's eventual
    reads end in a terminal ``disconnect`` event. Returns ``{"events",
    "dropped", "disconnected", "rid"}``."""
    srid, client = await server.open_stream(prompt, **submit_kwargs)
    got = 0
    it = client.events()
    while got < max(0, int(read_events)):
        try:
            await it.__anext__()
            got += 1
        except StopAsyncIteration:
            break
    # stall: consume nothing until the server drops us (or the request
    # finishes first — the sentinel overflowing the full buffer also
    # marks the stream dropped, so this is bounded either way)
    t0 = time.time()
    while not (client.dropped or client.done) \
            and time.time() - t0 < timeout_s:
        await asyncio.sleep(0.01)
    disconnected = False
    try:
        async for ev in it:
            if ev.get("type") == "disconnect":
                disconnected = True
    finally:
        client.closed = True
        await it.aclose()
    return {"events": got, "dropped": client.dropped,
            "disconnected": disconnected, "rid": srid}


# ---------------------------------------------------------------------------
# serving-fleet injectors (inference.serving router / replica)
# ---------------------------------------------------------------------------

def _fleet_sup(target, rid=None):
    """Resolve (supervisor, rid) from a ServingRouter (+ optional replica
    rid), a Replica, or a bare EngineSupervisor."""
    if hasattr(target, "_replicas"):          # ServingRouter
        reps = target._replicas
        rid = next(iter(reps)) if rid is None else rid
        return reps[rid].sup, rid
    if hasattr(target, "sup"):                # Replica
        return target.sup, getattr(target, "rid", None)
    return target, rid                        # EngineSupervisor


def replica_kill(target, rid=None,
                 exc: Optional[BaseException] = None) -> Optional[int]:
    """Kill one fleet replica FOR GOOD mid-trace — host loss / a crash
    loop that exhausts the restart budget. Arms the replica's engine to
    crash on its next step with the supervisor's remaining restart budget
    zeroed, so that crash flips the replica ``broken`` (in-flight
    requests FAILED, partials readable) exactly like a real budget
    exhaustion. The recovery proof: the router fails every non-terminal
    request over to a healthy replica and final outputs stay bit-identical
    to a single-replica oracle with no delivered-token repeats. ``target``
    is a :class:`ServingRouter` (``rid`` picks the victim; default the
    first replica), a :class:`Replica`, or a bare supervisor. Returns the
    killed replica's rid."""
    sup, rid = _fleet_sup(target, rid)
    sup.max_restarts = sup.restarts           # budget: already spent
    engine_crash(sup, at_step=1, exc=exc)
    if not sup.pending:
        # an idle replica's step loop never runs through the router, so
        # the armed crash would never fire: detonate now (the supervised
        # step hits the barrier, budget is spent -> broken immediately)
        sup.step()
    return rid


def slow_replica(target, rid=None, stall_steps: int = 3,
                 delay_s: float = 0.02) -> dict:
    """A replica that is alive but making NO progress (wedged
    accelerator, swap storm): its next ``stall_steps`` engine iterations
    sleep ``delay_s`` and return nothing, then the replica heals. TTFT
    on its requests stalls, so the router's hedged retry fires (and a
    long enough stall opens the breaker). The patch rides the ENGINE
    instance — a supervisor rebuild sheds it. Returns the shared state
    dict (``calls`` counts stalled iterations)."""
    sup, rid = _fleet_sup(target, rid)
    eng = sup.engine
    real = eng._step
    state = {"calls": 0, "rid": rid}

    def stalled(max_iters=None):
        if state["calls"] < max(0, int(stall_steps)):
            state["calls"] += 1
            time.sleep(max(0.0, float(delay_s)))
            return {}
        return real(max_iters)

    eng._step = stalled
    return state


def flaky_probe(target, rid=None, fails: int = 3,
                exc: Optional[BaseException] = None) -> dict:
    """A replica whose health/ops surface is wedged while the engine may
    be fine: the next ``fails`` ``health_snapshot()`` calls raise, then
    the surface heals. The router's probe path must route traffic around
    it, charge its circuit breaker per failure, and — once the breaker
    opens — re-probe half-open after the cooldown so the healed replica
    REJOINS. Patches the supervisor instance (a rolling-restart rebuild
    sheds it). Returns the shared state dict (``calls`` counts raised
    probes)."""
    sup, rid = _fleet_sup(target, rid)
    err = exc if exc is not None else RuntimeError(
        "chaos: injected flaky health probe")
    real = sup.health_snapshot
    state = {"calls": 0, "rid": rid}

    def shim():
        if state["calls"] < max(0, int(fails)):
            state["calls"] += 1
            raise err
        return real()

    sup.health_snapshot = shim
    return state


# ---------------------------------------------------------------------------
# KV-tier injectors (inference.serving.offload)
# ---------------------------------------------------------------------------

def _tier(target, rid=None):
    """Resolve (HostOffloadTier or None, rid) from a router / replica /
    supervisor / bare engine."""
    sup, rid = _fleet_sup(target, rid)
    eng = getattr(sup, "engine", sup)
    return getattr(eng.cache, "offload", None), rid


def host_pressure(target, rid=None, blocks: int = 0) -> dict:
    """Host RAM pressure: shrink one replica's KV offload tier to
    ``blocks`` live (default 0 — the tier drops everything it holds).
    Models the OOM killer reclaiming headroom or a co-tenant ballooning.
    Displaced entries silently fall back to the recompute path — the
    recovery proof is bit-identical outputs with pool accounting and the
    ``tier_partition`` invariant intact. Returns ``{"rid", "enabled",
    "before", "after", "capacity"}`` (``enabled=False`` with the tier
    off — the fault is then vacuous, like killing a replica that holds
    nothing)."""
    tier, rid = _tier(target, rid)
    if tier is None:
        return {"rid": rid, "enabled": False, "before": 0, "after": 0,
                "capacity": 0}
    before = tier.blocks
    tier.resize(blocks)
    return {"rid": rid, "enabled": True, "before": before,
            "after": tier.blocks, "capacity": tier.capacity}


def corrupt_offload_block(target, rid=None, seed: int = 0) -> dict:
    """Flip one byte inside one host-offloaded KV block WITHOUT updating
    its write-time checksum — silent host-memory corruption (ECC miss,
    bit rot). The next swap-in attempt must detect the mismatch and
    degrade to a cache MISS (``corrupt_drops`` increments, the chain
    recomputes bit-exactly); wrong KV must never reach a request.
    Returns ``{"rid", "enabled", "key"}`` — ``key=None`` when the tier
    holds nothing to corrupt (the fault is vacuous)."""
    tier, rid = _tier(target, rid)
    if tier is None:
        return {"rid": rid, "enabled": False, "key": None}
    return {"rid": rid, "enabled": True,
            "key": tier.corrupt_one(int(seed))}


# ---------------------------------------------------------------------------
# disaggregated-prefill / fleet-cache injectors
# ---------------------------------------------------------------------------

def kill_prefill_replica(target, rid=None,
                         exc: Optional[BaseException] = None) -> dict:
    """Kill a PREFILL-pool replica for good — possibly mid-handoff, with
    prompts mid-chunked-prefill and first tokens not yet adopted by a
    decode replica. Same mechanics as :func:`replica_kill` (restart
    budget zeroed + armed crash, detonated immediately when idle), aimed
    at the first replica with ``role == "prefill"`` (or ``rid``). The
    recovery proof: every staged request lands on a decode replica
    through the failover/recompute fallback — ZERO failed requests,
    outputs bit-identical to a single-replica oracle — and subsequent
    long prompts collapse to the unified path while the pool is empty.
    Returns ``{"rid", "enabled"}``; ``enabled=False`` when the fleet has
    no prefill replica (the fault is vacuous — nothing to kill)."""
    victim = rid
    if victim is None and hasattr(target, "_replicas"):
        victim = next((r for r, rep in target._replicas.items()
                       if getattr(rep, "role", "decode") == "prefill"),
                      None)
    if victim is None:
        return {"rid": None, "enabled": False}
    replica_kill(target, rid=victim, exc=exc)
    return {"rid": victim, "enabled": True}


def stale_directory(target, seed: int = 0) -> dict:
    """Poison the fleet cache directory: arm one holder replica so its
    NEXT chain export flips a byte AFTER stamping the per-leaf checksums
    (``ServingEngine._corrupt_next_export``) — the moral equivalent of a
    directory entry pointing at a replica whose cached bytes are no
    longer what the chain key promises (torn update, host corruption in
    flight). The next cross-replica pull through that holder must fail
    checksum verification at the graft end and degrade to recompute
    (``pull_fallbacks``/partial graft) — wrong KV is never served, and
    outputs stay bit-identical. The holder is picked deterministically
    by ``seed`` from the directory's current entries. Returns ``{"rid",
    "enabled", "key"}``; ``enabled=False`` when the directory is off or
    empty (the fault is vacuous)."""
    directory = getattr(target, "_directory", None)
    if directory is None:
        return {"rid": None, "enabled": False, "key": None}
    items = directory.items()
    if not items:
        return {"rid": None, "enabled": False, "key": None}
    key, holders = items[int(seed) % len(items)]
    rid = holders[int(seed) % len(holders)]
    rep = target._replicas.get(rid)
    if rep is None:
        return {"rid": rid, "enabled": False, "key": key}
    rep.sup.engine._corrupt_next_export = True
    return {"rid": rid, "enabled": True, "key": key}


# ---------------------------------------------------------------------------
# durable-serving injectors (inference.serving.journal)
# ---------------------------------------------------------------------------

def _journal_of(target):
    """Resolve the shared RequestJournal from a router / supervisor /
    engine / bare journal (or None)."""
    for attr in ("_journal", "journal"):
        j = getattr(target, attr, None)
        if j is not None:
            return j
    return target if hasattr(target, "records") \
        and hasattr(target, "abandon") else None


def _journal_dir_of(target):
    """Resolve a journal directory from a path string or anything
    :func:`_journal_of` understands."""
    if isinstance(target, (str, os.PathLike)):
        return os.fspath(target)
    j = _journal_of(target)
    return None if j is None else j.dir


def process_kill(target) -> dict:
    """Whole-process death without grace (kill -9 between engine steps:
    preemption with the grace window gone, OOM kill, host loss): every
    userspace buffer dies, no drain, no final snapshot — the only state
    that survives is what the journal's per-step fsync already made
    durable. In-process spelling: the shared journal is ABANDONED
    (buffered WAL tail discarded, handle dropped) and the live fleet
    must be thrown away untouched. The recovery proof is a NEW fleet
    built via ``EngineSupervisor.recover(journal_dir)`` /
    ``ServingRouter.cold_start(journal_dir)`` finishing every
    non-terminal request bit-identically to an unkilled oracle, with
    zero lost requests and no delivered token re-emitted. Returns ``{"enabled", "journal_dir",
    "wal_bytes", "live"}`` — ``enabled=False`` without a journal (a
    kill -9 then loses everything by design: the fault is vacuous for
    durability)."""
    j = _journal_of(target)
    if j is None:
        return {"enabled": False, "journal_dir": None,
                "wal_bytes": 0, "live": 0}
    live = len(j.live())
    size = j.abandon()
    return {"enabled": True, "journal_dir": j.dir,
            "wal_bytes": size, "live": live}


def torn_journal_tail(target, frac: float = 0.5) -> dict:
    """A crash mid-append: the WAL's last record is cut short (power
    loss between ``write`` and ``fsync``, a full disk). Truncates the
    final frame to ``frac`` of its payload so the length/crc framing
    CANNOT validate it. Recovery must truncate the torn tail in place
    and come up at the last durable record — degrade to the last good
    state, never parse garbage, never emit a wrong token. ``target`` is
    a journal directory path or anything holding a journal (apply AFTER
    :func:`process_kill` / ``abandon`` — the file must not have a live
    writer). Returns ``{"enabled", "wal", "before", "after"}`` —
    ``enabled=False`` with no WAL or an empty one (the fault is
    vacuous)."""
    d = _journal_dir_of(target)
    from ..inference.serving import journal as _jm
    wal = None if d is None else os.path.join(d, _jm.WAL_NAME)
    if wal is None or not os.path.exists(wal):
        return {"enabled": False, "wal": wal, "before": 0, "after": 0}
    with open(wal, "rb") as fh:
        raw = fh.read()
    # walk the framing to the last complete frame's start
    pos, last = 0, None
    while pos + _jm._FRAME.size <= len(raw):
        length, _ = _jm._FRAME.unpack_from(raw, pos)
        end = pos + _jm._FRAME.size + length
        if end > len(raw):
            break
        last = (pos, length)
        pos = end
    if last is None:
        return {"enabled": False, "wal": wal,
                "before": len(raw), "after": len(raw)}
    start, length = last
    keep = start + _jm._FRAME.size + max(0, min(length - 1,
                                                int(length * frac)))
    with open(wal, "r+b") as fh:
        fh.truncate(keep)
        fh.flush()
        os.fsync(fh.fileno())
    return {"enabled": True, "wal": wal,
            "before": len(raw), "after": keep}


def corrupt_snapshot(target, seed: int = 0, nbits: int = 8) -> dict:
    """Silent corruption inside the NEWEST serving-state snapshot (bit
    rot, torn block-device write under the atomic-rename window's
    fsync): flips ``nbits`` bits without touching its crc frame.
    Recovery must reject the generation at load (``snapshot_fallbacks``
    increments) and fall back to the previous snapshot or a full WAL
    replay — the last good state, never wrong output. ``target`` as in
    :func:`torn_journal_tail`. Returns ``{"enabled", "path"}`` —
    ``enabled=False`` with no snapshot on disk (recovery then replays
    the WAL from byte 0 anyway: the fault is vacuous)."""
    d = _journal_dir_of(target)
    if d is None:
        return {"enabled": False, "path": None}
    try:
        names = sorted((n for n in os.listdir(d)
                        if n.startswith("snapshot-")
                        and n.endswith(".snap")), reverse=True)
    except OSError:
        names = []
    if not names:
        return {"enabled": False, "path": None}
    path = os.path.join(d, names[0])
    flip_bits(path, nbits=nbits, seed=seed)
    return {"enabled": True, "path": path}


# ---------------------------------------------------------------------------
# multi-adapter LoRA injectors
# ---------------------------------------------------------------------------

def adapter_churn(target, rid=None, rounds: int = 4, seed: int = 0) -> dict:
    """Hostile adapter locality: ``rounds`` seeded acquire/release cycles
    aimed at COLD (registered-but-evicted) adapters, forcing the device
    pool's LRU to evict warm ones and fault the cold ones back in while
    traffic is live — the worst-case adapter mix a multi-tenant LoRA
    fleet sees. Pinned (running) adapters must survive in place
    (``_free_slot`` never evicts a pinned slot), reloads must be
    bit-exact, and the ``adapter_pool_partition`` invariant must hold
    throughout. When every registered adapter is already resident the
    cycles only reshuffle LRU order — the fault is then mild, not
    vacuous: eviction order for the NEXT overflow still changes.
    ``target`` is a router (``rid`` picks the replica), replica, or bare
    supervisor/engine. Returns ``{"rid", "enabled", "touched", "loads",
    "evictions"}`` (deltas) — ``enabled=False`` with multi-adapter
    serving off or nothing registered (the fault is vacuous)."""
    sup, rid = _fleet_sup(target, rid)
    eng = getattr(sup, "engine", sup)
    pool = getattr(eng, "_lora", None)
    if pool is None or not pool.registered():
        return {"rid": rid, "enabled": False, "touched": [],
                "loads": 0, "evictions": 0}
    rng = random.Random(int(seed))
    loads0, evictions0 = pool.loads, pool.evictions
    touched = []
    for _ in range(max(1, int(rounds))):
        cold = sorted(pool.evicted())
        name = rng.choice(cold) if cold \
            else rng.choice(sorted(pool.registered()))
        slot = pool.acquire(name)
        if slot is not None:       # every slot pinned -> skip, like admit
            pool.release(name)
            touched.append(name)
    return {"rid": rid, "enabled": True, "touched": touched,
            "loads": pool.loads - loads0,
            "evictions": pool.evictions - evictions0}


# ---------------------------------------------------------------------------
# chaos timeline (fleet-scale replay)
# ---------------------------------------------------------------------------

class ChaosEvent:
    """One scheduled injector firing: ``step`` (``run_replay``'s
    engine-step index — NOT wall-clock, so two replays of one seed fire
    in the identical order), the injector ``name`` (a serving entry of
    :data:`INJECTORS`, or ``"disconnect_mid_stream"`` which ``run_replay``
    applies at the client layer), and its ``kwargs``."""

    __slots__ = ("step", "name", "kwargs")

    def __init__(self, step: int, name: str, **kwargs):
        self.step = int(step)
        self.name = str(name)
        self.kwargs = kwargs

    def __repr__(self):
        kw = "".join(f", {k}={v!r}" for k, v in sorted(self.kwargs.items()))
        return f"ChaosEvent({self.step}, {self.name!r}{kw})"


class ChaosTimeline:
    """A seeded, step-indexed schedule of serving-injector firings — the
    chaos half of a replay manifest. Events are plain ``(step,
    injector, kwargs)`` triples sorted by step; :meth:`due` pops the
    ones whose step has arrived and
    :func:`~paddle_tpu_torch.inference.serving.workload.run_replay`
    interprets them against the live fleet, logging each firing into the
    replay's deterministic chaos log. Because steps (not timestamps) key the
    schedule, two replays of one manifest fire every event at the
    identical point in the request stream."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: (e.step, e.name))
        self._cursor = 0
        self.fired: list = []     # (step, name, detail) — the chaos log

    def due(self, step: int) -> list:
        """Events scheduled at or before ``step`` that have not fired."""
        out = []
        while self._cursor < len(self.events) and \
                self.events[self._cursor].step <= step:
            out.append(self.events[self._cursor])
            self._cursor += 1
        return out

    @property
    def remaining(self) -> int:
        return len(self.events) - self._cursor

    def log(self, step: int, name: str, detail) -> None:
        self.fired.append((int(step), str(name), detail))

    def spec(self) -> list:
        """JSON-serializable schedule (the manifest's ``chaos`` field):
        ``[[step, name, kwargs], ...]``."""
        return [[e.step, e.name, dict(e.kwargs)] for e in self.events]

    @classmethod
    def from_spec(cls, spec) -> "ChaosTimeline":
        return cls([ChaosEvent(s, n, **kw) for s, n, kw in spec])


# serving injectors a timeline may schedule (``run_replay`` knows how
# to aim each one at a live router/fleet; disconnect_mid_stream is applied
# at the client layer — cancel a live stream mid-flight)
TIMELINE_INJECTORS = ("replica_kill", "slow_replica", "flood_tenant",
                      "poison_prompt", "disconnect_mid_stream",
                      "flaky_probe")

# the KV-tier faults — NOT in the default timeline mix, which
# would silently reshuffle every previously generated seed's schedule;
# tier-exercising replays pass ``kinds=TIMELINE_INJECTORS +
# TIER_INJECTORS`` (or any mix) explicitly
TIER_INJECTORS = ("host_pressure", "corrupt_offload_block")

# the disaggregated-prefill / fleet-cache faults — same
# out-of-default-mix rule as TIER_INJECTORS, for the same reason:
# previously generated seeds must keep their schedules byte-identical
DISAGG_INJECTORS = ("kill_prefill_replica", "stale_directory")

# the durable-serving faults — out of the default mix too;
# process_kill additionally ends the replay's fleet object outright, so
# a timeline scheduling it must drive recovery itself
DURABLE_INJECTORS = ("process_kill", "torn_journal_tail",
                     "corrupt_snapshot")

# the multi-adapter LoRA fault — out of the default mix for
# the same seed-stability reason; adapter-exercising replays pass
# ``kinds=TIMELINE_INJECTORS + LORA_INJECTORS`` explicitly
LORA_INJECTORS = ("adapter_churn",)


def chaos_timeline(seed: int, horizon_steps: int,
                   kinds=TIMELINE_INJECTORS, events: int = 6,
                   start_frac: float = 0.1,
                   end_frac: float = 0.75) -> ChaosTimeline:
    """Build a seeded chaos schedule for a replay: ``events`` firings
    drawn round-robin over ``kinds`` (every kind fires at least once when
    ``events >= len(kinds)``), at seeded steps inside ``[start_frac,
    end_frac)`` of the horizon — early enough that recovery happens under
    traffic, late enough that the fleet has work in flight. Pure function
    of its arguments: the schedule IS replayable."""
    rng = random.Random(int(seed))
    lo = max(1, int(horizon_steps * start_frac))
    hi = max(lo + 1, int(horizon_steps * end_frac))
    out = []
    for i in range(int(events)):
        name = kinds[i % len(kinds)]
        step = rng.randrange(lo, hi)
        kw = {}
        if name == "slow_replica":
            kw = {"stall_steps": rng.randrange(2, 5), "delay_s": 0.001}
        elif name == "flood_tenant":
            kw = {"n": rng.randrange(8, 17), "seed": rng.randrange(1000)}
        elif name == "poison_prompt":
            kw = {"mode": rng.choice(["oov", "neg"]),
                  "seed": rng.randrange(1000)}
        elif name == "flaky_probe":
            kw = {"fails": rng.randrange(2, 5)}
        elif name == "host_pressure":
            kw = {"blocks": rng.randrange(0, 4)}
        elif name == "corrupt_offload_block":
            kw = {"seed": rng.randrange(1000)}
        elif name == "stale_directory":
            kw = {"seed": rng.randrange(1000)}
        elif name == "adapter_churn":
            kw = {"rounds": rng.randrange(2, 6),
                  "seed": rng.randrange(1000)}
        out.append(ChaosEvent(step, name, **kw))
    return ChaosTimeline(out)


# name -> injector: every ported injector (the reference's registry
# minus stall_heartbeat)
INJECTORS = {
    "truncate_file": truncate_file,
    "flip_bits": flip_bits,
    "fail_nth": fail_nth,
    "async_writer_fault": async_writer_fault,
    "kill_self": kill_self,
    "nan_payload": nan_payload,
    "bad_sample": bad_sample,
    "dead_worker": dead_worker,
    "stalled_consumer": stalled_consumer,
    "poison_prompt": poison_prompt,
    "flood_tenant": flood_tenant,
    "engine_crash": engine_crash,
    "disconnect_mid_stream": disconnect_mid_stream,
    "slow_client": slow_client,
    "replica_kill": replica_kill,
    "slow_replica": slow_replica,
    "flaky_probe": flaky_probe,
    "host_pressure": host_pressure,
    "corrupt_offload_block": corrupt_offload_block,
    "kill_prefill_replica": kill_prefill_replica,
    "stale_directory": stale_directory,
    "process_kill": process_kill,
    "torn_journal_tail": torn_journal_tail,
    "corrupt_snapshot": corrupt_snapshot,
    "adapter_churn": adapter_churn,
}
