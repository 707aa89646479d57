"""The port's asyncio serving front end
(``paddle_tpu_torch.inference.serving.server``) against the JAX package's.

Every scenario that the clock does not decide runs twice — once on the
JAX ``ServingServer`` over its ``EngineSupervisor`` and once on the
port's, with the same weights, prompts and fault — and what the clients
observe must be equal: each stream's tokens, its event type sequence
(``start``, ``token``..., ``finish`` / ``disconnect``), finish records
and the endpoints' status codes. Streams are also held to the JAX dense
oracle, as the reference's tests hold its own. Scenarios whose outcome
the clock decides (the disconnect fuzz, the metrics hammer, TPOT) run on
the port alone and hold it to the reference's assertions and the
oracle.

Mirrors ``tests/test_server.py``'s ``TestServerInProcess``,
``TestSnapshotThreadSafety``, ``TestRetryAfterColdStart``,
``TestDisconnectFuzz`` and ``TestServerTCP`` (a fast test here: the port
compiles nothing), plus the port's ``cold_start`` and ``serve_requests``
entry points and the pump thread's device.
"""

import asyncio
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.inference.serving as JV
from paddle_tpu import flags as JF
from paddle_tpu.models import generation as JG
from paddle_tpu.models import llama as JL

import paddle_tpu_torch.inference.serving as TV
from paddle_tpu_torch import flags as TF
from paddle_tpu_torch.models.convert import config_from_jax, params_from_jax
from paddle_tpu_torch.testing import chaos

torch.set_num_threads(2)

BASE = dict(block_size=4, max_slots=2, max_model_len=32, decode_chunk=2,
            queue_depth=8)
JAX = types.SimpleNamespace(name="jax", V=JV)
PORT = types.SimpleNamespace(name="port", V=TV)


@pytest.fixture(scope="module")
def setup():
    cfg = JL.LlamaConfig(vocab_size=97, hidden_size=64,
                         intermediate_size=96, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, (s,)).astype(np.int32)
               for s in [9, 5, 12, 7]]
    donor = JV.EngineSupervisor(params, cfg, JV.ServingConfig(**BASE))
    donor.run(prompts, max_new_tokens=[2] * 4, eos_token_id=None)
    return types.SimpleNamespace(
        cfg=cfg, params=params, prompts=prompts,
        programs=donor.engine.programs, tcfg=config_from_jax(cfg),
        tparams=params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu"),
        oracle={})


def dense(s, i, n):
    """The JAX dense-cache oracle for prompt ``i`` and ``n`` new tokens."""
    key = (i, n)
    if key not in s.oracle:
        s.oracle[key] = [int(t) for t in np.asarray(JG.generate(
            s.params, jnp.asarray(s.prompts[i][None]), s.cfg,
            max_new_tokens=int(n)))[0]]
    return s.oracle[key]


def mk_sup(s, ns, programs="donor", **kw):
    """A supervisor of either package at BASE (+ overrides); JAX ones at
    BASE's shape share the donor's compiled programs."""
    sup_kw = {k: kw.pop(k) for k in list(kw)
              if k in ("max_restarts", "drain_deadline_s", "journal")}
    sc = {**BASE, **kw}
    if ns is JAX:
        if programs == "donor" and all(sc[k] == BASE[k] for k in
                                       ("block_size", "max_slots",
                                        "max_model_len")):
            sup_kw["programs"] = s.programs
        return JV.EngineSupervisor(s.params, s.cfg, JV.ServingConfig(**sc),
                                   **sup_kw)
    return TV.EngineSupervisor(s.tparams, s.tcfg, TV.ServingConfig(**sc),
                               device="cpu", **sup_kw)


def both(scenario, s, *args, **kw):
    """Run ``scenario(s, ns, ...)`` on the JAX package and on the port;
    the two observations must be equal. Returns the port's."""
    want = scenario(s, JAX, *args, **kw)
    got = scenario(s, PORT, *args, **kw)
    assert got == want
    return got


def balanced(ns, backend) -> bool:
    ns.V.InvariantAuditor().check(backend)
    return backend.block_partition()["in_use"] == 0


def run_async(coro, timeout=120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def consume(gen):
    """(token list, event type sequence, finish record) of one stream."""
    toks, types_, fin = [], [], None
    async for ev in gen:
        types_.append(ev["type"])
        if ev["type"] == "token":
            toks.append(ev["token"])
        elif ev["type"] == "finish":
            fin = ev
    return toks, types_, fin


async def wait_idle(sup, deadline_s=10.0):
    deadline = time.time() + deadline_s
    while sup.pending and time.time() < deadline:
        await asyncio.sleep(0.01)


class TestServerInProcess:
    def test_many_clients_multiplex_bit_exact(self, setup):
        def scenario(s, ns):
            sup = mk_sup(s, ns)

            async def main():
                srv = ns.V.ServingServer(sup)
                async with srv.running():
                    got = await asyncio.gather(*(consume(srv.agenerate(
                        s.prompts[i % 4], max_new_tokens=5,
                        eos_token_id=None, tenant=f"t{i % 2}"))
                        for i in range(6)))
                assert srv.pump_error is None
                return got

            got = run_async(main())
            assert balanced(ns, sup.engine)
            return [(toks, types_, fin["state"], fin["tokens"])
                    for toks, types_, fin in got]

        got = both(scenario, setup)
        for i, (toks, types_, state, n) in enumerate(got):
            assert toks == dense(setup, i % 4, 5)
            assert types_ == ["start"] + ["token"] * 5 + ["finish"]
            assert state == "finished" and n == 5

    def test_endpoints_health_ready_metrics(self, setup):
        def scenario(s, ns):
            sup = mk_sup(s, ns)

            async def main():
                srv = ns.V.ServingServer(sup)
                async with srv.running():
                    return [await srv.handle("GET", "/healthz"),
                            await srv.handle("GET", "/readyz"),
                            await srv.handle("GET", "/metrics"),
                            await srv.handle("GET", "/nope"),
                            await srv.handle("POST", "/generate", {})]

            (st_h, hz), (st_r, rz), (st_m, mz), (st_404, e404), \
                (st_400, bad) = run_async(main())
            assert hz["ok"] is True and hz["pump_alive"]
            assert rz["ready"] is True
            assert rz["restart_budget"] == sup.max_restarts
            assert "supervisor" in mz and "autoscale" in mz
            json.dumps(mz)
            return (st_h, sorted(hz), st_r, rz, st_m, sorted(mz), st_404,
                    e404, st_400, bad)

        got = both(scenario, setup)
        assert got[0::2][:5] == (200, 200, 200, 404, 400)
        assert "prompt" in got[-1]["error"]

    def test_supervisor_snapshot_shape_pinned_to_registry(self, setup):
        sup = mk_sup(setup, PORT)
        sup.run(setup.prompts[:2], max_new_tokens=3, eos_token_id=None)
        snap = sup.health_snapshot()
        assert set(snap) == set(JV.HEALTH_SNAPSHOT_FIELDS)
        json.dumps(snap)

    def test_metrics_tpot_per_tenant(self, setup):
        sup = mk_sup(setup, PORT)
        for i, p in enumerate(setup.prompts):
            sup.submit(p, max_new_tokens=4, eos_token_id=None,
                       tenant="a" if i % 2 else "b")
        while sup.pending:
            sup.step()
        snap = sup.health_snapshot()
        for t in ("a", "b"):
            rec = snap["tenants"][t]
            assert rec["tpot_p50_s"] is not None and rec["tpot_p50_s"] > 0
            assert rec["tpot_p99_s"] >= rec["tpot_p50_s"]
            assert rec["ttft_p50_s"] is not None

    def test_readyz_503_during_drain_and_when_broken(self, setup):
        def scenario(s, ns):
            sup = mk_sup(s, ns, max_restarts=0)

            async def main():
                srv = ns.V.ServingServer(sup)
                async with srv.running():
                    st0, _ = await srv.handle("GET", "/readyz")
                    chaos.engine_crash(sup, at_step=1)
                    await srv.submit(prompt=s.prompts[0], max_new_tokens=4,
                                     eos_token_id=None)
                    deadline = time.time() + 10
                    while not sup.broken and time.time() < deadline:
                        await asyncio.sleep(0.01)
                    st1, body1 = await srv.handle("GET", "/readyz")
                return st0, st1, body1["broken"], body1["ready"]

            return run_async(main())

        assert both(scenario, setup) == (200, 503, True, False)

    def test_generate_503_structured_during_drain(self, setup):
        def scenario(s, ns):
            sup = mk_sup(s, ns)

            async def main():
                srv = ns.V.ServingServer(sup)
                async with srv.running():
                    sup.request_drain()
                    deadline = time.time() + 10
                    while srv.drain_report is None and \
                            time.time() < deadline:
                        await asyncio.sleep(0.01)
                    st, body = await srv.handle(
                        "POST", "/generate",
                        {"prompt": s.prompts[0].tolist(),
                         "max_new_tokens": 4})
                    st_r, _ = await srv.handle("GET", "/readyz")
                return st, body, st_r

            st, body, st_r = run_async(main())
            assert body["retry_after_s"] is not None \
                and body["retry_after_s"] > 0
            return st, body["reason"], sorted(body), st_r

        assert both(scenario, setup)[::3] == (503, 503)

    def test_generate_429_when_queue_full(self, setup):
        def scenario(s, ns):
            sup = mk_sup(s, ns, queue_depth=1, max_slots=1)

            async def main():
                srv = ns.V.ServingServer(sup)
                async with srv.running():
                    await srv.submit(prompt=s.prompts[0].tolist(),
                                     max_new_tokens=8, eos_token_id=None)
                    while len(sup.engine._sched.queue):
                        await asyncio.sleep(0.005)
                    await srv.submit(prompt=s.prompts[1].tolist(),
                                     max_new_tokens=8, eos_token_id=None)
                    return await srv.handle(
                        "POST", "/generate",
                        {"prompt": s.prompts[2].tolist(),
                         "max_new_tokens": 4})

            st, body = run_async(main())
            assert body["retry_after_s"] is not None \
                and body["retry_after_s"] > 0
            return st, body["reason"], body["queue_depth"], sorted(body)

        assert both(scenario, setup)[:2] == (429, "shed")

    def test_abandoned_stream_cancels_and_frees(self, setup):
        def scenario(s, ns):
            sup = mk_sup(s, ns)

            async def main():
                srv = ns.V.ServingServer(sup)
                async with srv.running():
                    r = await chaos.disconnect_mid_stream(
                        srv, s.prompts[0], events=2, max_new_tokens=24,
                        eos_token_id=None)
                    await wait_idle(sup)
                assert srv.pump_error is None
                return r

            r = run_async(main())
            assert sup.engine.stats()["cancelled"] >= 1
            assert balanced(ns, sup.engine)
            return r["events"]

        assert both(scenario, setup) == 2

    def test_slow_client_disconnected_via_cancel(self, setup):
        def scenario(s, ns):
            sup = mk_sup(s, ns)

            async def main():
                srv = ns.V.ServingServer(sup, client_queue=2)
                async with srv.running():
                    r = await chaos.slow_client(
                        srv, s.prompts[0], read_events=1,
                        max_new_tokens=24, eos_token_id=None)
                    await wait_idle(sup)
                return r

            r = run_async(main())
            assert sup.engine.stats()["cancelled"] >= 1
            assert balanced(ns, sup.engine)
            return r["events"], r["dropped"], r["disconnected"]

        assert both(scenario, setup) == (1, True, True)

    def test_server_crash_recovery_streams_bit_exact(self, setup):
        def scenario(s, ns):
            sup = mk_sup(s, ns)
            chaos.engine_crash(sup, at_step=3)

            async def main():
                srv = ns.V.ServingServer(sup)
                async with srv.running():
                    got = await asyncio.gather(*(consume(srv.agenerate(
                        s.prompts[i], max_new_tokens=8, eos_token_id=None))
                        for i in range(4)))
                assert srv.pump_error is None
                return got

            got = run_async(main())
            assert balanced(ns, sup.engine)
            return sup.restarts, [(t, ty) for t, ty, _ in got]

        restarts, got = both(scenario, setup)
        assert restarts == 1
        for i, (toks, types_) in enumerate(got):
            assert toks == dense(setup, i, 8)
            assert types_ == ["start"] + ["token"] * 8 + ["finish"]


# the tensor reads that copy or wait on a device tensor's data
TENSOR_READS = ("item", "cpu", "tolist", "numpy", "to", "__array__",
                "__bool__", "__float__", "__int__", "__index__")


def record_tensor_reads(monkeypatch, threads):
    """Wrap every ``TENSOR_READS`` method of ``torch.Tensor`` to log the
    calls made on a thread named in ``threads`` (a set filled as the
    threads start); returns that log."""
    seen = []
    for name in TENSOR_READS:
        real = getattr(torch.Tensor, name)

        def wrapped(self, *a, _real=real, _name=name, **kw):
            if threading.current_thread().name in threads:
                seen.append(_name)
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: seen.append("synchronize"))
    return seen


class TestSnapshotThreadSafety:
    def test_metrics_hammer_while_serving(self, setup, monkeypatch):
        """Two threads hammer the port's engine and supervisor snapshots
        while the main thread serves: no exception, every payload
        serializable, counters monotonic, streams equal the oracle — and
        no snapshot reads a tensor's data or synchronizes (``/metrics``
        runs on the event loop's thread while the pump steps)."""
        sup = mk_sup(setup, PORT)
        eng = sup.engine
        stop = threading.Event()
        errors = []
        seen_retired = [0]
        names = {"hammer-0", "hammer-1"}
        reads = record_tensor_reads(monkeypatch, names)

        def hammer():
            try:
                while not stop.is_set():
                    json.dumps(eng.health_snapshot())
                    st = eng.stats()
                    assert st["retired"] >= seen_retired[0]
                    seen_retired[0] = st["retired"]
                    assert 0 <= st["live_slots"] <= BASE["max_slots"]
                    json.dumps(sup.health_snapshot())
                    eng.block_partition()
            except Exception as e:          # noqa: BLE001 — recorded
                errors.append(e)

        threads = [threading.Thread(target=hammer, name=n) for n in names]
        for t in threads:
            t.start()
        try:
            for _ in range(3):
                srids = [sup.submit(p, max_new_tokens=6, eos_token_id=None)
                         for p in setup.prompts]
                while sup.pending:
                    sup.step(2)
                for i, srid in enumerate(srids):
                    assert [int(t) for t in sup.result(srid)] == \
                        dense(setup, i, 6)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert reads == []

    def test_router_snapshot_reads_no_tensor(self, setup, monkeypatch):
        """The fleet's ``/metrics`` payload (``ServingRouter.
        health_snapshot``, which probes every replica) read from another
        thread while the fleet serves touches no tensor data either."""
        r = TV.ServingRouter(setup.tparams, setup.tcfg,
                             TV.ServingConfig(**BASE), replicas=2,
                             device="cpu")
        stop = threading.Event()
        errors, snaps = [], [0]
        reads = record_tensor_reads(monkeypatch, {"scraper"})

        def scrape():
            try:
                while not stop.is_set():
                    json.dumps(r.health_snapshot())
                    r.block_partitions()
                    snaps[0] += 1
            except Exception as e:          # noqa: BLE001 — recorded
                errors.append(e)

        t = threading.Thread(target=scrape, name="scraper")
        t.start()
        try:
            frids = [r.submit(p, max_new_tokens=6, eos_token_id=None)
                     for p in setup.prompts]
            while r.pending:
                r.step(2)
        finally:
            stop.set()
            t.join(timeout=10)
        assert not t.is_alive() and not errors, errors
        assert snaps[0] > 0 and reads == []
        for i, f in enumerate(frids):
            assert [int(x) for x in r.result(f)] == dense(setup, i, 6)


class TestRetryAfterColdStart:
    def test_cold_start_returns_documented_default(self, setup):
        want = float(TF.flag("FLAGS_serving_retry_after_s"))
        assert want == float(JF.flag("FLAGS_serving_retry_after_s"))
        sup = mk_sup(setup, PORT, queue_depth=1, max_slots=1)
        eng = sup.engine
        assert eng._sched.retry_after_s() == pytest.approx(want)
        assert eng.health_snapshot()["retry_after_s"] == \
            pytest.approx(want)
        eng.submit(setup.prompts[0], max_new_tokens=2, eos_token_id=None)
        with pytest.raises(TV.ServingQueueFull) as ei:
            eng.submit(setup.prompts[0], max_new_tokens=2,
                       eos_token_id=None)
        assert ei.value.retry_after_s == pytest.approx(want)
        while eng.pending:
            eng.step()
        eng.run([setup.prompts[0]], max_new_tokens=2, eos_token_id=None)
        measured = eng._sched.retry_after_s()
        assert measured is not None and measured != want or \
            len(eng._sched._finish_times) >= 2


class TestDisconnectFuzz:
    def test_disconnect_fuzz_every_lifecycle_point(self, setup):
        """Clients of the port's server drop at random moments — queued,
        mid-prefill, decoding, preempted, during the final drain — while
        the auditor runs from the event loop; the streams that completed
        equal the JAX oracle."""
        rng = np.random.default_rng(7)
        sup = mk_sup(setup, PORT, max_slots=2, num_blocks=10,
                     prefill_chunk=4, queue_depth=16)
        auditor = TV.InvariantAuditor()

        async def main():
            srv = TV.ServingServer(sup, client_queue=16)
            completed = {}

            async def client(i):
                n = int(rng.integers(2, 9))
                drop_after = int(rng.integers(0, n + 2))
                gen = srv.agenerate(setup.prompts[i % 4], max_new_tokens=n,
                                    eos_token_id=None)
                toks, got = [], 0
                try:
                    async for ev in gen:
                        if ev["type"] != "token":
                            continue
                        toks.append(ev["token"])
                        got += 1
                        if got >= drop_after and drop_after <= n:
                            if rng.integers(0, 2):
                                return
                finally:
                    await gen.aclose()
                if len(toks) == n:
                    completed[(i, n)] = toks

            async with srv.running():
                tasks = [asyncio.ensure_future(client(i))
                         for i in range(12)]
                while not all(t.done() for t in tasks):
                    auditor.check(sup)
                    await asyncio.sleep(0.005)
                await asyncio.gather(*tasks)
                stragglers = [srv.agenerate(setup.prompts[i % 4],
                                            max_new_tokens=8,
                                            eos_token_id=None)
                              for i in range(3)]
                for st in stragglers:
                    await st.__anext__()
                auditor.check(sup)
                for st in stragglers:
                    await st.aclose()
            auditor.check(sup)
            assert srv.pump_error is None
            return completed

        completed = run_async(main(), timeout=300.0)
        auditor.quiesce(sup)
        assert completed
        for (i, n), toks in completed.items():
            assert toks == dense(setup, i % 4, n)
        assert balanced(PORT, sup.engine)
        assert sup.engine.stats()["cancelled"] >= 1


async def http(port, request: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(request)
    await writer.drain()
    out = await reader.read()
    writer.close()
    await writer.wait_closed()
    return out


def sse_tokens(raw: bytes):
    toks, kinds = [], []
    for line in raw.decode().splitlines():
        if line.startswith("event: "):
            kinds.append(line[7:])
        elif line.startswith("data: "):
            ev = json.loads(line[6:])
            if ev.get("type") == "token":
                toks.append(ev["token"])
    return toks, kinds


class TestServerTCP:
    def test_tcp_sse_round_trip(self, setup):
        """HTTP/1.1 + SSE on a real socket: /healthz, a streamed
        /generate and a malformed one, each package's server answering
        the same status lines, headers and event sequence."""
        def scenario(s, ns):
            sup = mk_sup(s, ns)

            async def main():
                srv = ns.V.ServingServer(sup)
                async with srv.running(host="127.0.0.1", port=0):
                    health = await http(
                        srv.port, b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
                    body = json.dumps({"prompt": s.prompts[0].tolist(),
                                       "max_new_tokens": 4,
                                       "eos_token_id": None}).encode()
                    sse = await http(
                        srv.port, b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                        b"Content-Length: " + str(len(body)).encode() +
                        b"\r\n\r\n" + body)
                    bad = await http(
                        srv.port, b"POST /generate HTTP/1.1\r\n"
                        b"Content-Length: 2\r\n\r\n{}")
                return health, sse, bad

            health, sse, bad = run_async(main())
            head = sse.split(b"\r\n\r\n", 1)[0]
            return (health.split(b"\r\n")[0], b'"ok": true' in health,
                    head, sse_tokens(sse), bad.split(b"\r\n")[0])

        health, ok, head, (toks, kinds), bad = both(scenario, setup)
        assert health == b"HTTP/1.1 200 OK" and ok
        assert b"text/event-stream" in head
        assert toks == dense(setup, 0, 4)
        assert kinds == ["start"] + ["token"] * 4 + ["finish"]
        assert bad == b"HTTP/1.1 400 Bad Request"


class TestEntryPoints:
    @pytest.mark.parametrize("replicas", [None, 2])
    def test_cold_start_resumes_journaled_streams(self, setup, tmp_path,
                                                  replicas):
        """``ServingServer.cold_start`` over a journal whose process died
        after a few steps (a supervisor, or a 2-replica fleet): the new
        server's pump finishes every recovered request, each stream the
        delivered prefix plus the rest, equal to the JAX package's run
        and to the oracle."""
        def scenario(s, ns, jdir):
            sc = ns.V.ServingConfig(**BASE)
            kw = {} if ns is JAX else {"device": "cpu"}
            params, cfg = (s.params, s.cfg) if ns is JAX else \
                (s.tparams, s.tcfg)
            if replicas is None:
                first = ns.V.EngineSupervisor(
                    params, cfg, sc, journal=ns.V.RequestJournal(jdir), **kw)
            else:
                first = ns.V.ServingRouter(
                    params, cfg, sc, replicas=replicas,
                    journal=ns.V.RequestJournal(jdir), **kw)
            ids = [first.submit(p, max_new_tokens=6, eos_token_id=None)
                   for p in s.prompts]
            jids = [first._reqs[i].jid for i in ids]
            pre = {j: [] for j in jids}
            for _ in range(2):
                for i, toks in first.step(2).items():
                    pre[first._reqs[i].jid].extend(int(t) for t in toks)
            chaos.process_kill(first)
            srv = ns.V.ServingServer.cold_start(
                jdir, params, cfg, ns.V.ServingConfig(**BASE),
                replicas=replicas, **kw)

            async def main():
                async with srv.running():
                    await wait_idle(srv.sup, 60.0)
                assert srv.pump_error is None

            run_async(main())
            for j in jids:
                srid = next(r for r, rec in srv.sup._reqs.items()
                            if rec.jid == j)
                pre[j] = (pre[j], [int(t) for t in srv.sup.result(srid)])
            return [pre[j] for j in jids]

        want = scenario(setup, JAX, str(tmp_path / "jax"))
        got = scenario(setup, PORT, str(tmp_path / "port"))
        assert got == want
        for i, (early, full) in enumerate(got):
            assert full == dense(setup, i, 6)
            assert full[:len(early)] == early

    def test_serve_requests_equals_reference(self, setup):
        def scenario(s, ns):
            out = ns.V.serve_requests(ns.V.ServingServer(mk_sup(s, ns)),
                                      s.prompts, max_new_tokens=4,
                                      eos_token_id=None)
            assert out["drain_report"]["leaked_blocks"] == 0
            return [[int(t) for t in o] for o in out["outputs"]]

        got = both(scenario, setup)
        assert got == [dense(setup, i, 4) for i in range(4)]

    def test_pump_makes_the_backend_device_current(self, setup,
                                                   monkeypatch):
        """The pump thread sets the backend's CUDA device before its
        first step (the current device is per thread). A CPU backend
        whose ``_device`` names ``cuda:1`` stands in for a card here."""
        calls = []
        monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(
            (d, threading.current_thread().name)))
        sup = mk_sup(setup, PORT)
        assert TV.ServingServer(sup)._cuda_index is None
        sup._device = "cuda:1"
        srv = TV.ServingServer(sup)

        async def main():
            async with srv.running():
                return await consume(srv.agenerate(
                    setup.prompts[0], max_new_tokens=3, eos_token_id=None))

        toks, _, _ = run_async(main())
        assert calls == [(1, "serving-pump")]
        assert toks == dense(setup, 0, 3)


class TestRouterServer:
    """Mirrors the server tests of ``tests/test_router.py``'s
    ``TestRouterSnapshotAndServer``: one server in front of a fleet."""

    @staticmethod
    def fleet(s, ns, replicas=2):
        if ns is JAX:
            return JV.ServingRouter(s.params, s.cfg, JV.ServingConfig(**BASE),
                                    replicas=replicas)
        return TV.ServingRouter(s.tparams, s.tcfg, TV.ServingConfig(**BASE),
                                replicas=replicas, device="cpu")

    def test_server_front_lines_router_bit_exact(self, setup):
        def scenario(s, ns):
            r = self.fleet(s, ns)
            srv = ns.V.ServingServer(r)

            async def main():
                async with srv.running():
                    code, ready = await srv.handle("GET", "/readyz")
                    got = await asyncio.gather(*(consume(srv.agenerate(
                        s.prompts[i], max_new_tokens=6, eos_token_id=None))
                        for i in range(4)))
                    code_m, metrics = await srv.handle("GET", "/metrics")
                    code_h, health = await srv.handle("GET", "/healthz")
                assert srv.pump_error is None
                assert "replicas" in metrics and health["ok"]
                return (code, ready["ready"], code_m, code_h,
                        [(t, k) for t, k, _ in got])

            out = run_async(main())
            assert srv.drain_report["leaked_blocks"] == 0
            return out

        *codes, streams = both(scenario, setup)
        assert codes == [200, True, 200, 200]
        for i, (toks, kinds) in enumerate(streams):
            assert toks == dense(setup, i, 6)
            assert kinds == ["start"] + ["token"] * 6 + ["finish"]

    def test_server_readyz_degraded_then_recovered(self, setup):
        def scenario(s, ns):
            r = self.fleet(s, ns)
            for rid in list(r.replicas):
                chaos.replica_kill(r, rid=rid)
            r.step()
            r.step()
            srv = ns.V.ServingServer(r)

            async def main():
                code0, body0 = await srv.handle("GET", "/readyz")
                r.spawn_replica()                   # capacity restored
                code1, body1 = await srv.handle("GET", "/readyz")
                return code0, body0["broken"], code1, body1["ready"]

            return asyncio.run(asyncio.wait_for(main(), timeout=60.0))

        assert both(scenario, setup) == (503, True, 200, True)
