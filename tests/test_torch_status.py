"""The port's status page (`node/http_status.py`), its Prometheus text
exposition (`metrics.prometheus_text`) and the node's fleet wiring
(`ShardNode(fleet_frontend=..., http_port=...)`, `sharding
--fleet-frontend` and `--http`), held against the JAX package's on the CPU.

1. `prometheus_text` equals the JAX package's byte for byte for the same
   registry contents (counters, gauges, timers, histograms, names that need
   escaping, the empty registry);
2. `StatusServer` on the same node configuration in both packages: the
   same `/healthz` payload and the same `/status` keys, less the sections
   whose modules the port has not yet (``devscope``, ``fleettrace``); its
   routes over HTTP;
3. the CLI: `--http` serves the page, `--fleet-frontend` refuses a local
   composition by flag and runs a notary whose verification goes to a
   frontend, with no device resolved and no launch.
"""

import importlib
import json
import logging
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)

PORT, REF = "gethsharding_tpu_torch", "gethsharding_tpu"
PKGS = (PORT, REF)


def pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        root=root, metrics=mod("metrics"), node=mod("node.backend"),
        status=mod("node.http_status"), chain=mod("smc.chain"),
        sig=mod("sigbackend"), router=mod("fleet.router"),
        frontend=mod("fleet.frontend"), slo=mod("slo"))


P = {root: pkg(root) for root in PKGS}


@pytest.fixture(scope="module", autouse=True)
def _recorder_dir(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GETHSHARDING_TORCH_PERFWATCH_DIR",
                  str(tmp_path_factory.mktemp("port_recorder")))
        yield


# == 1. the Prometheus text exposition ========================================

def _fill(registry, case: str) -> None:
    if case == "empty":
        return
    registry.counter("notary/votes").inc(3)
    registry.counter("serving/ecrecover/requests").inc()
    registry.gauge("fleet/replica/127.0.0.1:9000/state").set(2)
    registry.gauge("slo/interactive/burn_rate").set(0.125)
    timer = registry.timer("notary/head_latency")
    for v in (0.5, 0.25, 1.75, 0.0625):
        timer.observe(v)
    if case == "mixed":
        return
    hist = registry.histogram("serving/ecrecover/batch_size",
                              buckets=(1, 2, 4, 8, 16, 128))
    for v in (1, 1, 3, 5, 9, 200, 16, 0.5):
        hist.observe(v)
    registry.histogram("serving/empty/batch_size", buckets=(1, 10))
    registry.counter("das/odd name-with.dots").inc(7)
    registry.timer("trace/never")


@pytest.mark.parametrize("case", ["empty", "mixed", "histograms"])
def test_prometheus_text_equals_reference_byte_for_byte(case):
    texts = {}
    for root, m in P.items():
        registry = m.metrics.Registry()
        _fill(registry, case)
        texts[root] = m.metrics.prometheus_text(registry)
    assert texts[PORT] == texts[REF]
    if case == "histograms":
        text = texts[PORT]
        assert ('gethsharding_serving_ecrecover_batch_size_bucket'
                '{le="+Inf"} 8') in text
        assert "gethsharding_notary_votes_total 3" in text
    assert texts[PORT].endswith("\n")


# == 2. the status page on the same node ======================================

def _node(m, **kw):
    base = ({"sig_backend": "failover-torch", "device": "cpu"}
            if m.root == PORT else {"sig_backend": "failover-python"})
    base.update(kw)
    return m.node.ShardNode(actor="notary",
                            backend=m.chain.SimulatedMainchain(),
                            http_port=0, serving=True, soundness_rate=0.05,
                            **base)


# /status sections every payload carries, and those it carries only where
# the process's registry holds metrics under the section's prefix (what
# ran before in the process decides, so each package is held to the rule
# on its own registry)
ALWAYS = {"actor", "shard_id", "account", "block_number", "period",
          "restarts", "soundness", "slo", "perf", "trace"}
BY_PREFIX = {"serving": "serving/", "resilience": "resilience/",
             "fleet": "fleet/"}


@pytest.mark.parametrize("da_mode", ["full", "sampled"])
def test_status_payloads_match_reference(da_mode):
    got = {}
    for root, m in P.items():
        m.slo.tracker()       # both packages' SLO sections present
        node = _node(m, da_mode=da_mode)
        try:
            status = node.service(m.status.StatusServer)
            before = set(m.metrics.DEFAULT_REGISTRY.snapshot())
            health = status.health_payload()
            payload = status.status_payload()
            after = set(m.metrics.DEFAULT_REGISTRY.snapshot())
            trace = status.trace_payload()
            got[root] = (health, payload, sorted(trace))
        finally:
            node.stop()
        assert ALWAYS <= set(payload), root
        for key, prefix in BY_PREFIX.items():
            if any(n.startswith(prefix) for n in before):
                assert key in payload, (root, key)
            if key in payload:
                assert any(n.startswith(prefix) for n in after), (root, key)
        assert ("das" in payload) == (da_mode == "sampled" or any(
            n.startswith("das/") for n in after)), root
    (p_health, port, p_trace), (r_health, ref, r_trace) = got[PORT], got[REF]
    assert p_health == r_health
    assert p_health["status"] == "degraded"        # nothing started
    assert {"devscope", "fleettrace"} <= set(ref)
    assert not {"devscope", "fleettrace"} & set(port)
    assert set(port) - set(ALWAYS) - set(BY_PREFIX) <= {"das"}
    for key in ("actor", "shard_id", "block_number", "period", "restarts"):
        assert port[key] == ref[key], key
    assert sorted(port["soundness"]) == sorted(ref["soundness"])
    assert port["soundness"]["rate"] == ref["soundness"]["rate"] == 0.05
    assert sorted(port["trace"]) == sorted(ref["trace"])
    assert sorted(port["slo"]) == sorted(ref["slo"])
    assert sorted(port["perf"]) == ["recorder"]
    if da_mode == "sampled":
        assert port["das"]["soundness"] == ref["das"]["soundness"]
        assert port["das"]["proof_mode"] == ref["das"]["proof_mode"]
    assert p_trace == r_trace


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type"), exc.read()


def test_status_routes_over_http():
    m = P[PORT]
    node = _node(m)
    status = node.service(m.status.StatusServer)
    status.start()
    try:
        port = status.port
        assert port > 0
        code, kind, body = _get(port, "/healthz")
        assert code == 200 and kind == "application/json"
        assert json.loads(body)["services"]["http-status"] == "running"
        code, _, body = _get(port, "/metrics")
        assert code == 200 and isinstance(json.loads(body), dict)
        code, kind, body = _get(port, "/metrics?format=prom")
        assert code == 200 and kind.startswith("text/plain; version=0.0.4")
        text = body.decode()
        assert "# TYPE gethsharding_notary_" in text
        assert "gethsharding_resilience_breaker_" in text
        code, _, body = _get(port, "/status")
        assert code == 200 and json.loads(body)["actor"] == "notary"
        code, _, body = _get(port, "/trace")
        assert code == 200 and "traces" in json.loads(body)
        code, kind, body = _get(port, "/")
        assert code == 200 and kind.startswith("text/html")
        assert b"<script>" in body
        for path in ("/profile", "/profile/stacks"):
            code, _, body = _get(port, path)
            assert code == 501 and b"devscope/" in body
        assert _get(port, "/nope")[0] == 404
    finally:
        status.stop()
        node.stop()


# == 3. the CLI ===============================================================

def test_cli_http_serves_the_status_page(caplog):
    from gethsharding_tpu_torch.node import cli

    args = cli.build_parser().parse_args(
        ["sharding", "--actor", "light", "--http", "0", "--runtime", "0.5",
         "--blocktime", "0.05"])
    with caplog.at_level(logging.INFO, logger="sharding"):
        assert cli.run_sharding_node(args) == 0
    assert "status endpoint on http://127.0.0.1:" in caplog.text
    assert "service error" not in caplog.text


@pytest.mark.parametrize("flags", [
    ["--serving"], ["--chaos", "seed=1,backend.ecrecover_addresses=1"],
    ["--soundness-rate", "0.1"], ["--sigbackend", "failover-torch"],
], ids=["serving", "chaos", "soundness", "failover"])
def test_cli_fleet_frontend_refuses_a_local_composition(flags, capsys):
    from gethsharding_tpu_torch.node import cli

    args = cli.build_parser().parse_args(
        ["sharding", "--actor", "notary", "--fleet-frontend",
         "127.0.0.1:1", "--runtime", "0.1"] + flags)
    assert cli.run_sharding_node(args) == 2
    err = capsys.readouterr().err
    assert "--fleet-frontend replaces the local verification" in err
    assert flags[0] in err


def test_cli_notary_through_a_frontend_resolves_no_device(caplog):
    """`sharding --actor notary --fleet-frontend HOST:PORT --http 0`: the
    node starts where there is no card (its verification is the frontend's
    replicas'), composes nothing of its own, and launches nothing."""
    from gethsharding_tpu_torch.node import cli

    m = P[PORT]
    registry = m.metrics.Registry()
    router = m.router.FleetRouter(
        [m.router.Replica("r0", m.sig.PythonSigBackend(), probe=None,
                          registry=registry)],
        health_interval_s=0.0, registry=registry)
    frontend = m.frontend.FrontendServer(router)
    frontend.start()
    try:
        args = cli.build_parser().parse_args(
            ["sharding", "--actor", "notary", "--deposit",
             "--fleet-frontend", "127.0.0.1:%d" % frontend.address[1],
             "--http", "0", "--runtime", "0.6", "--blocktime", "0.05"])
        with caplog.at_level(logging.INFO, logger="sharding"):
            assert cli.run_sharding_node(args) == 0
    finally:
        frontend.stop(grace_s=1.0, notice_s=0.0)
    text = caplog.text
    assert "device=None" in text and "service error" not in text
    assert "status endpoint on http://" in text
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("node at exit: ")][-1]
    assert json.loads(line[len("node at exit: "):])["launches"] == {}


def test_devnet_http_base_serves_each_actors_status_page(tmp_path):
    """`devnet --http-base P` (the `Devnet` the command builds): the
    notary child serves its status page on port P, which answers
    `/healthz` while the net runs."""
    import socket
    import time

    from gethsharding_tpu_torch.devnet import Devnet

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        http = sock.getsockname()[1]
    net = Devnet(notaries=1, proposers=0, base_dir=str(tmp_path),
                 sigbackend="python", http_base=http)
    log = tmp_path / "logs" / "notary-0.log"
    try:
        net.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not (
                log.exists() and f"status endpoint on http://127.0.0.1:"
                f"{http}" in log.read_text()):
            time.sleep(0.2)
        code, _, body = _get(http, "/healthz")
        assert code == 200 and json.loads(body)["services"]
    finally:
        net.stop()
