"""The port's fault-tolerant tuning service, on the CPU: the reference's
service tests run against ``repro_torch.tuning_cache.service``, and the
wire format is held to the reference's in both directions.

Covers: the wire protocol's corruption armor, single-flight coalescing
(threads, processes, leader failure), the resilient client (deadline,
retry/backoff, circuit breaker, strict graceful degradation under every
fault class), generation-stamped invalidation of frozen tables, the
chaos matrix (under injected server kill/delay/corrupt/drop/disconnect
faults every dispatch still returns correct params and no exception
escapes ``lookup_or_tune``), and a port client against a reference
server and a reference client against a port server (the same params
and digests under ``tpu-v5e`` and ``kepler-k20``).  The reference's
adapter onto its training supervisor (``runtime/fault.py``) is not
ported, so its test is not either.
"""
import json
import logging
import os
import subprocess
import sys
import threading
import time

import pytest

import repro.kernels  # noqa: F401  (the reference's, for wire parity)
import repro_torch.kernels  # noqa: F401  (registers dispatch problems)
from repro import tuning_cache as ref_tc
from repro.tuning_cache.service import ServiceClient as RefClient
from repro.tuning_cache.service import TuningServer as RefServer
from repro_torch import tuning_cache
from repro_torch.tuning_cache import TuningDatabase, registry
from repro_torch.tuning_cache.service import (CORRUPT, DELAY, DISCONNECT, DROP,
                                        ERROR, ClientPolicy, FaultInjector,
                                        FaultSchedule, ServiceClient,
                                        ServiceFault, SingleFlight,
                                        TuningServer, parse_fault, protocol)

SIG = {"m": 320, "n": 320, "k": 320}       # off the pretuned grid: always
TARGET = "tpu-v5e"                         # a genuine cold tune server-side


def fast_policy(**over):
    kw = dict(deadline_s=5.0, connect_timeout_s=2.0, retries=1,
              backoff_base_s=0.01, backoff_max_s=0.02,
              breaker_threshold=100, breaker_cooldown_s=60.0)
    kw.update(over)
    return ClientPolicy(**kw)


@pytest.fixture(autouse=True)
def _fresh_state():
    """Isolate each test: fresh default db, no service, thawed tables."""
    tuning_cache.configure_service(None)
    tuning_cache.set_default_db(TuningDatabase())
    ref_tc.configure_service(None)
    ref_tc.set_default_db(ref_tc.TuningDatabase())
    yield
    tuning_cache.configure_service(None)
    tuning_cache.reset_default_db()
    ref_tc.configure_service(None)
    ref_tc.reset_default_db()


@pytest.fixture()
def server():
    with TuningServer() as srv:
        yield srv


def local_params():
    """What the local default path answers for SIG (no service)."""
    return tuning_cache.lookup_or_tune("matmul", spec=TARGET, **SIG)


# ---------------------------------------------------------------------------
# protocol armor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("payload", [
    {"results": [{"params": {"bm": 1}}]},                   # no generation
    {"generation": True, "results": [{"params": {"bm": 1}}]},
    {"generation": 0, "results": "oops"},                   # not a list
    {"generation": 0, "results": []},                       # wrong length
    {"generation": 0, "results": [["not", "a", "dict"]]},
    {"generation": 0, "results": [{"params": {}}]},         # empty params
    {"generation": 0, "results": [{"params": "x"}]},
    {"generation": 0, "results": [{"no_params": 1}]},
])
def test_check_lookup_response_rejects_corruption(payload):
    with pytest.raises(ValueError):
        protocol.check_lookup_response(payload, 1)


def test_check_lookup_response_accepts_hits_and_errors():
    gen, out = protocol.check_lookup_response(
        {"generation": 3, "results": [{"params": {"bm": 8}, "digest": "d"},
                                      {"error": "unknown kernel"}]}, 2)
    assert gen == 3
    assert out[0]["params"] == {"bm": 8} and out[1] is None


def test_decode_rejects_non_objects():
    with pytest.raises(ValueError):
        protocol.decode(b"[1, 2, 3]")
    with pytest.raises(ValueError):
        protocol.decode(b'{"generation": }garbage')


# ---------------------------------------------------------------------------
# fault vocabulary
# ---------------------------------------------------------------------------


def test_fault_schedule_arithmetic():
    s = FaultSchedule(after=2, every=3, times=2)
    fired = 0
    hits = [h for h in range(1, 12)
            if s.fires_at(h, fired) and (fired := fired + 1)]
    assert hits == [2, 5]                   # after=2, stride 3, budget 2
    once = FaultSchedule(after=4, every=0)
    assert [h for h in range(1, 8) if once.fires_at(h, 0)] == [4]
    always = FaultSchedule()
    assert all(always.fires_at(h, h - 1) for h in range(1, 5))


def test_parse_fault():
    f = parse_fault("delay@server.tune:delay=2.0,after=3,times=1")
    assert (f.kind, f.site, f.delay_s) == (DELAY, "server.tune", 2.0)
    assert f.schedule == FaultSchedule(after=3, every=1, times=1)
    assert parse_fault("drop@client.request").schedule == FaultSchedule()
    for bad in ("drop", "drop@", "@site", "drop@site:delay",
                "drop@site:bogus=1", "nope@site"):
        with pytest.raises(ValueError):
            parse_fault(bad)


def test_injector_first_match_and_counters():
    inj = FaultInjector([ServiceFault("s", DROP,
                                      schedule=FaultSchedule(after=2))])
    assert inj.fire("s") is None            # hit 1: before `after`
    assert inj.fire("other") is None        # sites count independently
    assert inj.fire("s").kind == DROP
    assert inj.hits("s") == 2 and inj.fired == [("s", DROP)]


# ---------------------------------------------------------------------------
# single-flight coalescing
# ---------------------------------------------------------------------------


def test_singleflight_coalesces_threads():
    sf = SingleFlight()
    calls = []
    gate = threading.Event()

    def slow():
        calls.append(1)
        gate.wait(5)
        return "rec"

    results = []
    ts = [threading.Thread(target=lambda: results.append(sf.do("k", slow)))
          for _ in range(6)]
    for t in ts:
        t.start()
    time.sleep(0.2)                         # let racers park on the event
    gate.set()
    for t in ts:
        t.join(5)
    assert len(calls) == 1                  # fn ran exactly once
    assert [r[0] for r in results] == ["rec"] * 6
    assert sum(1 for r in results if r[1]) == 1     # one leader


def test_singleflight_leader_failure_reelects():
    """A failed leader must not fan its error out to parked racers —
    they re-elect and run the callable themselves."""
    sf = SingleFlight()
    entered, release = threading.Event(), threading.Event()

    def failing():
        entered.set()
        release.wait(5)
        raise RuntimeError("leader dies")

    leader_error, racer_result = [], []

    def leader():
        try:
            sf.do("k", failing)
        except RuntimeError as e:
            leader_error.append(e)

    t1 = threading.Thread(target=leader)
    t1.start()
    assert entered.wait(5)
    t2 = threading.Thread(
        target=lambda: racer_result.append(sf.do("k", lambda: "fresh")))
    t2.start()
    time.sleep(0.1)                         # racer parks on the flight
    release.set()
    t1.join(5)
    t2.join(5)
    assert len(leader_error) == 1           # the leader saw its own error
    assert racer_result and racer_result[0][0] == "fresh"


def test_server_coalesces_concurrent_client_threads(server):
    server.injector.add(parse_fault("delay@server.tune:delay=0.5,times=1"))
    client = ServiceClient(server.url, policy=fast_policy())
    barrier = threading.Barrier(6)
    results = []

    def worker():
        barrier.wait(5)
        results.append(client.resolve("matmul", SIG, target=TARGET))

    ts = [threading.Thread(target=worker) for _ in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(15)
    client.close()
    assert len(results) == 6 and all(r is not None for r in results)
    assert len({json.dumps(r["params"], sort_keys=True)
                for r in results}) == 1
    assert server.stats.tunes == 1          # exactly one rank ran
    assert server.stats.coalesced >= 1


# ---------------------------------------------------------------------------
# client resilience
# ---------------------------------------------------------------------------


def test_roundtrip_matches_local_params(server):
    client = ServiceClient(server.url, policy=fast_policy())
    res = client.resolve("matmul", SIG, target=TARGET)
    assert res is not None and res["params"] == local_params()
    assert res["space_size"] > 0 and res["source"] == "static"
    assert client.stats.hits == 1 and client.stats.failures == 0
    health = client.health()
    assert health["ok"] and health["records"] >= 1
    stats = client.remote_stats()
    assert stats["server"]["tunes"] == 1
    client.close()


def test_batch_mixes_hits_and_definitive_misses(server):
    client = ServiceClient(server.url, policy=fast_policy())
    out = client.resolve_batch([
        {"kernel_id": "matmul", "signature": SIG, "target": TARGET},
        {"kernel_id": "no_such_kernel", "signature": {}, "target": TARGET},
    ])
    assert out[0] is not None and out[1] is None
    # a definitive miss is NOT a transport failure: breaker untouched
    assert client.stats.failures == 0 and client.stats.misses == 1
    assert client.breaker.state == client.breaker.CLOSED
    client.close()


def test_fingerprint_mismatch_is_miss_not_failure(server):
    client = ServiceClient(server.url, policy=fast_policy())
    res = client.resolve("matmul", SIG, target=TARGET,
                         fingerprint="tpu-v5e@000000000000")
    assert res is None
    assert client.stats.misses == 1 and client.stats.failures == 0
    client.close()


def test_dead_server_degrades_to_local_tiers():
    client = ServiceClient("http://127.0.0.1:9",        # nothing listens
                           policy=fast_policy(deadline_s=2.0))
    tuning_cache.configure_service(client=client)
    params = local_params()                 # must not raise, must answer
    assert params and client.stats.degraded >= 1
    # the local answer primed the memo: repeats never re-consult the
    # dead service
    requests0 = client.stats.requests
    assert local_params() == params
    assert client.stats.requests == requests0


def test_retry_backoff_then_success(server):
    inj = FaultInjector([parse_fault("error@client.request:times=2")])
    client = ServiceClient(server.url, injector=inj,
                           policy=fast_policy(retries=3))
    res = client.resolve("matmul", SIG, target=TARGET)
    assert res is not None                  # third attempt lands
    assert client.stats.retries == 2 and client.stats.failures == 2
    assert client.breaker.state == client.breaker.CLOSED
    client.close()


def test_circuit_breaker_trips_half_opens_recovers(server):
    now = [0.0]
    inj = FaultInjector([parse_fault("error@client.request:times=3")])
    client = ServiceClient(
        server.url, injector=inj, clock=lambda: now[0],
        policy=fast_policy(retries=1, breaker_threshold=2,
                           breaker_cooldown_s=10.0, backoff_base_s=0.0,
                           jitter=0.0))
    assert client.resolve("matmul", SIG, target=TARGET) is None
    assert client.breaker.state == client.breaker.OPEN
    assert client.breaker.trips == 1 and client.stats.failures == 2
    # open: short-circuit without touching the network
    attempts0 = client.stats.attempts
    assert client.resolve("matmul", SIG, target=TARGET) is None
    assert client.stats.attempts == attempts0
    # cooldown elapses -> half-open admits exactly ONE probe (no
    # retries while half-open), which eats the last budgeted fault and
    # re-opens the circuit
    now[0] += 10.0
    assert client.breaker.state == client.breaker.HALF_OPEN
    assert client.resolve("matmul", SIG, target=TARGET) is None
    assert client.breaker.state == client.breaker.OPEN
    assert client.breaker.trips == 2
    # next half-open probe succeeds (budget exhausted) -> CLOSED
    now[0] += 10.0
    res = client.resolve("matmul", SIG, target=TARGET)
    assert res is not None and res["params"] == local_params()
    assert client.breaker.state == client.breaker.CLOSED
    client.close()


def test_degradation_logs_once_per_kernel(caplog):
    client = ServiceClient("http://127.0.0.1:9",
                           policy=fast_policy(retries=0, deadline_s=1.0))
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.tuning_cache.service.client"):
        client.resolve("matmul", SIG, target=TARGET)
        client.resolve("matmul", SIG, target=TARGET)
        client.resolve("matvec", {"m": 128, "n": 128}, target=TARGET)
    warnings = [r.getMessage() for r in caplog.records
                if r.levelno >= logging.WARNING]
    assert len(warnings) == 2               # one per kernel, not per call
    assert any("matmul" in w for w in warnings)
    assert any("matvec" in w for w in warnings)


def test_unserializable_signature_degrades():
    client = ServiceClient("http://127.0.0.1:9", policy=fast_policy())
    out = client.resolve("matmul", {"m": object()}, target=TARGET)
    assert out is None
    assert client.stats.attempts == 0       # never hit the wire


# ---------------------------------------------------------------------------
# chaos matrix: every fault class degrades, nothing escapes dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", [
    "drop@server.request",
    "delay@server.request:delay=0.05",
    "corrupt@server.request",
    "disconnect@server.request",
    "error@server.request",
    "error@client.request",
    "corrupt@client.request",
])
def test_chaos_dispatch_always_answers(fault):
    expected = local_params()
    tuning_cache.set_default_db(TuningDatabase())   # re-cold the local db
    inj = FaultInjector([parse_fault(fault)])
    client_inj = inj if fault.endswith("client.request") else None
    server_inj = inj if client_inj is None else None
    with TuningServer(injector=server_inj) as srv:
        client = ServiceClient(srv.url, injector=client_inj,
                               policy=fast_policy(retries=1, deadline_s=2.0))
        tuning_cache.configure_service(client=client)
        params = tuning_cache.lookup_or_tune("matmul", spec=TARGET, **SIG)
        assert params == expected           # degraded or served: correct
        assert inj.fired                    # the fault actually fired
        # standing faults keep degrading without ever raising
        assert tuning_cache.lookup_or_tune("matmul", spec=TARGET,
                                           **SIG) == expected


def test_chaos_delay_past_deadline_degrades():
    """A backend slower than the deadline is indistinguishable from a
    dead one: the dispatch answers from the local tiers in bounded
    time instead of stalling behind the service."""
    expected = local_params()
    tuning_cache.set_default_db(TuningDatabase())
    inj = FaultInjector([parse_fault("delay@server.request:delay=30")])
    with TuningServer(injector=inj) as srv:
        client = ServiceClient(srv.url, policy=fast_policy(
            retries=0, deadline_s=0.5, connect_timeout_s=0.3))
        tuning_cache.configure_service(client=client)
        t0 = time.monotonic()
        assert tuning_cache.lookup_or_tune("matmul", spec=TARGET,
                                           **SIG) == expected
        assert time.monotonic() - t0 < 5.0  # bounded, not 30s
        assert client.stats.degraded == 1


def test_service_skipped_for_explicit_db_and_model():
    client = ServiceClient("http://127.0.0.1:9", policy=fast_policy())
    tuning_cache.configure_service(client=client)
    params = tuning_cache.lookup_or_tune("matmul", spec=TARGET,
                                         db=TuningDatabase(), **SIG)
    assert params and client.stats.requests == 0


# ---------------------------------------------------------------------------
# generation-stamped invalidation
# ---------------------------------------------------------------------------


def test_generation_change_invalidates_frozen_tables(server):
    client = ServiceClient(server.url, policy=fast_policy())
    tuning_cache.configure_service(client=client)
    params = tuning_cache.lookup_or_tune("matmul", spec=TARGET, **SIG)
    assert params and client.generation == 0
    assert tuning_cache.freeze() > 0 and registry.is_frozen()
    local_gen = tuning_cache.get_default_db().generation
    # operator mutates the SHARED db: the server's generation moves
    server.db.invalidate()
    assert registry.is_frozen()             # not yet observed
    # ...and the next response's stamp thaws us through the hooks
    client.health()
    assert client.stats.generation_changes == 1
    assert not registry.is_frozen()
    assert tuning_cache.get_default_db().generation == local_gen + 1
    # dispatch still answers (through the live tiers)
    assert tuning_cache.lookup_or_tune("matmul", spec=TARGET,
                                       **SIG) == params


def test_env_var_configures_service(server, monkeypatch):
    monkeypatch.setenv(tuning_cache.ENV_SERVICE, server.url)
    tuning_cache._service_env_checked = False       # re-arm the lazy probe
    try:
        client = tuning_cache.service_client()
        assert client is not None and client.url == server.url
        assert tuning_cache.lookup_or_tune("matmul", spec=TARGET,
                                           **SIG) == local_params()
        assert client.stats.requests >= 1
    finally:
        tuning_cache.configure_service(None)


# ---------------------------------------------------------------------------
# multi-process: exactly one tune per cold key; crash mid-tune
# ---------------------------------------------------------------------------

_CLIENT_SCRIPT = """
import json, sys
from repro_torch.tuning_cache.service.client import ClientPolicy, ServiceClient
c = ServiceClient(sys.argv[1],
                  policy=ClientPolicy(deadline_s=60, connect_timeout_s=50,
                                      retries=0))
r = c.resolve("matmul", {"m": 320, "n": 320, "k": 320}, target="tpu-v5e")
print(json.dumps(None if r is None else r["params"]))
"""


def test_multiprocess_cold_key_tunes_exactly_once(server):
    """≥4 client *processes* race the same cold key: the delay fault
    holds the single tune open long enough that every process arrives
    mid-flight, and the server still runs exactly one rank."""
    server.injector.add(parse_fault("delay@server.tune:delay=3.0,times=1"))
    env = dict(os.environ,
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _CLIENT_SCRIPT,
                               server.url],
                              stdout=subprocess.PIPE, env=env, text=True)
             for _ in range(4)]
    try:
        outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    finally:
        for p in procs:                 # a hung client costs seconds
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert all(p.returncode == 0 for p in procs)
    params = [json.loads(o) for o in outs]
    assert all(p is not None for p in params)
    assert all(p == params[0] for p in params)
    assert server.stats.tunes == 1          # the hard guarantee
    assert server.injector.hits("server.tune") == 1


def test_server_killed_mid_tune_client_degrades(tmp_path):
    """kill@server.tune crashes the server process inside the rank; the
    client degrades to None (and dispatch would fall through locally)
    while the server exits with the injected code."""
    env = dict(os.environ,
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.tuning_cache",
         "--db", str(tmp_path / "db"), "serve",
         "--fault", "kill@server.tune"],
        stdout=subprocess.PIPE, env=env, text=True)
    try:
        line = proc.stdout.readline()       # the flushed ready line
        assert "listening on" in line
        url = line.split("listening on ")[1].split()[0]
        client = ServiceClient(url, policy=fast_policy(
            retries=0, deadline_s=10.0, connect_timeout_s=8.0))
        assert client.resolve("matmul", SIG, target=TARGET) is None
        assert client.stats.degraded == 1
        client.close()
        assert proc.wait(timeout=30) == 86  # died exactly where injected
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()


# ---------------------------------------------------------------------------
# launcher integration
# ---------------------------------------------------------------------------


def test_warm_tuning_db_reports_and_strict_exits(tmp_path, capsys):
    from repro_torch.core.hw import TPU_V5E
    from repro_torch.launch.serve import _warm_tuning_db
    rec = tuning_cache.TuningRecord(
        key=tuning_cache.make_key("matvec", spec=TPU_V5E, m=128, n=128,
                                  dtype="float32"),
        params={"bm": 64})
    path = tmp_path / "mix.jsonl"
    path.write_text(json.dumps(rec.to_dict()) + "\n"
                    + "corrupt line one\n" + '{"params": {}}\n')
    db = TuningDatabase()
    assert _warm_tuning_db(db, str(path)) == (1, 2)
    assert "2 corrupt lines skipped" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        _warm_tuning_db(TuningDatabase(), str(path), strict=True)
    with pytest.raises(SystemExit):         # unreadable + strict: loud
        _warm_tuning_db(TuningDatabase(), str(tmp_path / "absent.jsonl"),
                        strict=True)
    assert _warm_tuning_db(TuningDatabase(),
                           str(tmp_path / "absent.jsonl")) == (0, 0)


# ---------------------------------------------------------------------------
# wire parity with the reference, both ways
# ---------------------------------------------------------------------------

WIRE_CASES = [("matmul", SIG), ("matvec", {"m": 640, "n": 320}),
              ("rms_norm", {"m": 96, "d": 320, "dtype": "bfloat16"}),
              ("flash_attention", {"b": 1, "h": 2, "sq": 128, "skv": 128,
                                   "d": 64, "causal": True})]


@pytest.mark.parametrize("target", ["tpu-v5e", "kepler-k20"])
@pytest.mark.parametrize("direction", ["port-client", "reference-client"])
def test_wire_parity_both_ways(target, direction):
    """A port client against a reference server, and a reference client
    against a port server: every lookup answered, with the params and
    digest the answering side's own default path gives, which are the
    other package's too; and dispatch through the service ranks
    nothing locally."""
    server_cls, client_cls, local, remote = (
        (RefServer, ServiceClient, tuning_cache, ref_tc)
        if direction == "port-client"
        else (TuningServer, RefClient, ref_tc, tuning_cache))
    with server_cls() as srv:
        client = client_cls(srv.url, policy=fast_policy())
        out = client.resolve_batch([
            {"kernel_id": k, "signature": s, "target": target}
            for k, s in WIRE_CASES])
        assert all(r is not None for r in out)
        assert client.stats.failures == 0
        for (k, s), r in zip(WIRE_CASES, out):
            want = remote.lookup_or_tune(k, spec=target,
                                         db=remote.TuningDatabase(), **s)
            assert r["params"] == want
            assert r["params"] == local.lookup_or_tune(
                k, spec=target, db=local.TuningDatabase(), **s)
            mem = local.TuningDatabase()
            local.lookup_or_tune(k, spec=target, db=mem, **s)
            (rec,) = mem.records()
            assert r["digest"] == rec.key.digest
        client.close()
        # the client package's dispatch takes the service's answers
        # under its own keys (the digest guard passes) and ranks nothing
        local.configure_service(srv.url, policy=fast_policy())
        db = local.get_default_db()
        tunes0 = db.stats.tunes
        for k, s in WIRE_CASES:
            assert local.lookup_or_tune(k, spec=target, **s) \
                == remote.lookup_or_tune(k, spec=target,
                                         db=remote.TuningDatabase(), **s)
        assert db.stats.tunes == tunes0
        assert local.service_client().stats.hits == len(WIRE_CASES)
        local.configure_service(None)
