"""HTTP status + metrics endpoint for a running node (the port's copy of
the JAX package's `node/http_status.py`).

The native counterpart of the reference's observability servers: the
embedded dashboard streaming system samples (`dashboard/dashboard.go:36`),
the ethstats push reporter (`ethstats/ethstats.go:86`), and the expvar
metrics exporter (`metrics/exp`). One small stdlib HTTP server exposes:

  GET /healthz  -> {"status": "ok"|"degraded", "services": {...}}
  GET /metrics  -> the metrics registry snapshot (counters/gauges/timers);
                   ?format=prom serves Prometheus text exposition so the
                   node is scrapeable without Telegraf
  GET /status   -> node identity + chain view (actor, shard, account,
                   period, restart counts)
  GET /trace    -> recent finished traces from the span tracer
                   (gethsharding_tpu_torch/tracing)
  GET /         -> a single-file live dashboard (no build step, no
                   bundle: inline JS polling the three JSON endpoints)

JSON over plain HTTP so `curl` works everywhere; the root page is the
dashboard role itself, self-contained where the reference embeds a
38.6k-line generated React bundle. Runs as a Service on the node
(started/stopped with it).

The /status payload carries the views of the port's composed backend
(serving, resilience and breaker, soundness, DAS, fleet, SLO), the flight
recorder and the tracer. The JAX package's ``perf`` ledger and gate,
``devscope`` and ``fleettrace`` sections and its ``/profile`` routes wait
for the port's perfwatch ledger, `devscope/` and `fleettrace/`: the
routes answer 501 naming the module. The page computes nothing on a
device.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from gethsharding_tpu_torch.actors.base import Service
from gethsharding_tpu_torch.metrics import DEFAULT_REGISTRY, prometheus_text


class StatusServer(Service):
    """Serves /healthz, /metrics and /status for one ShardNode."""

    name = "http-status"

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0):
        super().__init__()
        self.node = node
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- payloads ----------------------------------------------------------

    def health_payload(self) -> dict:
        services = {}
        degraded = False
        for service in self.node.services:
            if not isinstance(service, Service):
                continue
            state = ("crashed" if service.crashed
                     else "running" if service.running else "stopped")
            degraded = degraded or state != "running"
            services[service.name] = state
        return {"status": "degraded" if degraded else "ok",
                "services": services}

    def status_payload(self) -> dict:
        node = self.node
        try:
            period = node.client.current_period()
            block = node.client.block_number
        except Exception:
            period, block = None, None
        payload = {
            "actor": node.actor,
            "shard_id": node.shard_id,
            "account": node.client.account().hex_str,
            "block_number": block,
            "period": period,
            "restarts": dict(node.restarts),
        }
        # the serving tier's health at a glance (--serving): queue
        # depths, coalesced batch sizes, shed counts — and the
        # resilience layer's (breaker state, retry/giveup, watchdog,
        # journal, chaos counters) — the /metrics snapshot filtered by
        # namespace so an operator reads backpressure + failover state
        # off /status without grepping
        snapshot = DEFAULT_REGISTRY.snapshot()
        serving = {name: snap for name, snap in snapshot.items()
                   if name.startswith("serving/")}
        if serving:
            payload["serving"] = serving
        resilience = {name: snap for name, snap in snapshot.items()
                      if name.startswith("resilience/")}
        if resilience:
            payload["resilience"] = resilience
        # the continuous soundness audit at a glance (--soundness-rate):
        # the configured knobs plus what they buy — per-dispatch
        # detection probability and the 99%-confidence dispatch budget
        # (the raw check/mismatch counters already ride the resilience
        # section above)
        soundness = getattr(node, "soundness_backend", None)
        if soundness is not None:
            payload["soundness"] = soundness.describe()
        # the DAS plane at a glance (--da-mode=sampled): published
        # blobs, samples served/fetched/verified, failures, wire bytes
        das = {name: snap for name, snap in snapshot.items()
               if name.startswith("das/")}
        das_service = getattr(node, "das_service", None)
        if das_service is not None:
            # the (samples, proof-bytes, detection) trade-off for both
            # proof modes at this node's sampling shape — what k buys
            # and what it costs on the wire under --da-proofs
            from gethsharding_tpu_torch.das.erasure import MAX_TOTAL_CHUNKS
            from gethsharding_tpu_torch.das.sampler import soundness_table

            n = MAX_TOTAL_CHUNKS
            k_data = max(1, int(n / (1.0 + das_service.parity_ratio)))
            das["proof_mode"] = das_service.proof_mode
            das["samples"] = das_service.samples
            das["soundness"] = soundness_table(
                n, k_data, ks=sorted({4, 8, das_service.samples}))
        if das:
            payload["das"] = das
        # the fleet router at a glance: per-replica state gauges
        # (0 healthy / 1 draining / 2 tripped), routed/failure counters
        # with their EWMA rates, the router's failover / all-draining
        # totals — and, on a federating router, the scraped
        # fleet/replica/<name>/ rollups + fleet aggregates (total
        # in-flight, per-class depth, worst replica p99)
        fleet = {name: snap for name, snap in snapshot.items()
                 if name.startswith("fleet/")}
        if fleet:
            payload["fleet"] = fleet
        # per-class SLOs at a glance: declared objectives, fast/slow
        # burn rates, budget remaining, breach counts, latency ladder
        # (slo/tracker.py) — only once something recorded an event
        from gethsharding_tpu_torch import slo as slo_mod

        if slo_mod.active() is not None:
            payload["slo"] = slo_mod.active().describe()
        # the flight recorder at a glance: events buffered and
        # post-mortem bundles dumped (breaker trips, watchdog fires,
        # soundness violations, SLO breach onsets, hedge storms)
        from gethsharding_tpu_torch.perfwatch import RECORDER

        payload["perf"] = {"recorder": RECORDER.describe()}
        # span-ring health: a nonzero dropped count means the bounded
        # finished-span ring overwrote spans nobody exported — raise
        # --trace-ring or export more often
        from gethsharding_tpu_torch import tracing

        payload["trace"] = {
            "enabled": tracing.TRACER.enabled,
            "spans_recorded": tracing.TRACER.spans_recorded,
            "spans_dropped": tracing.TRACER.spans_dropped,
        }
        return payload

    def metrics_payload(self) -> dict:
        return DEFAULT_REGISTRY.snapshot()

    def trace_payload(self) -> dict:
        """Recent finished traces (root + child spans grouped by trace
        id). `enabled` false means the tracer is collecting nothing —
        call tracing.enable()."""
        from gethsharding_tpu_torch import tracing

        return {"enabled": tracing.TRACER.enabled,
                "spans_recorded": tracing.TRACER.spans_recorded,
                "spans_dropped": tracing.TRACER.spans_dropped,
                "traces": tracing.TRACER.recent_traces(limit=100)}

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        status = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through our logger
                status.log.debug("http %s", fmt % args)

            def _send(self, code, content_type, body):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urlparse(self.path)
                path = parsed.path
                if path == "/":
                    self._send(200, "text/html; charset=utf-8",
                               _DASHBOARD_HTML.encode())
                    return
                if path in ("/profile", "/profile/stacks"):
                    # the profiler's control surface waits for the
                    # port's devscope/
                    body = json.dumps({"error": "the port has no "
                                       "devscope/ yet (ROADMAP.md, "
                                       "queue A)"}).encode()
                    self._send(501, "application/json", body)
                    return
                if path == "/metrics" and "prom" in parse_qs(
                        parsed.query).get("format", []):
                    # Prometheus text exposition: scrape directly. Same
                    # degraded-node-still-answers contract as the JSON
                    # routes: a failing render is a 500 body, not a
                    # dropped connection.
                    try:
                        body, code = prometheus_text().encode(), 200
                    except Exception as exc:  # noqa: BLE001
                        body, code = f"# error: {exc!r}\n".encode(), 500
                    self._send(code,
                               "text/plain; version=0.0.4; charset=utf-8",
                               body)
                    return
                routes = {
                    "/healthz": status.health_payload,
                    "/metrics": status.metrics_payload,
                    "/status": status.status_payload,
                    "/trace": status.trace_payload,
                }
                fn = routes.get(path)
                if fn is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    body = json.dumps(fn()).encode()
                    code = 200
                except Exception as exc:  # degraded node must still answer
                    body = json.dumps({"error": repr(exc)}).encode()
                    code = 500
                self._send(code, "application/json", body)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolved for port=0
        thread = threading.Thread(target=self._httpd.serve_forever,
                                  name="http-status", daemon=True)
        self._threads.append(thread)
        thread.start()
        self.log.info("status endpoint on http://%s:%d", self.host, self.port)

    def on_stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


# The dashboard page (dashboard/dashboard.go role): one self-contained
# HTML file polling /healthz /status /metrics every 2 s. No build step,
# no dependencies; the data endpoints above remain the API surface.
_DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpu-sharding node</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;background:#101418;
      color:#e6e6e6}
 h1{font-size:1.2rem} h2{font-size:1rem;margin:1.2rem 0 .4rem}
 table{border-collapse:collapse;width:100%;max-width:64rem}
 td,th{border-bottom:1px solid #2a3138;padding:.25rem .6rem;
       text-align:left;font-size:.85rem}
 .ok{color:#7bd88f}.bad{color:#ff6b6b}
 code{color:#9ecbff}
</style></head><body>
<h1>tpu-sharding node <span id="health"></span></h1>
<div>actor <code id="actor"></code> · shard <code id="shard"></code> ·
 account <code id="account"></code> · block <code id="block"></code> ·
 period <code id="period"></code></div>
<h2>Services</h2><table id="services"></table>
<h2>Metrics</h2><table id="metrics"></table>
<script>
async function j(p){const r=await fetch(p);return r.json()}
function rows(el,entries,fmt){el.innerHTML=entries.map(fmt).join("")}
async function tick(){
 try{
  const[h,s,m]=await Promise.all([j("/healthz"),j("/status"),j("/metrics")]);
  const ok=h.status==="ok";
  health.innerHTML=`<span class="${ok?"ok":"bad"}">[${h.status}]</span>`;
  actor.textContent=s.actor;shard.textContent=s.shard_id;
  account.textContent=(s.account||"").slice(0,18)+"…";
  block.textContent=s.block_number;period.textContent=s.period;
  rows(services,Object.entries(h.services),([n,st])=>
   `<tr><td>${n}</td><td class="${st==="running"?"ok":"bad"}">${st}</td></tr>`);
  rows(metrics,Object.entries(m),([n,snap])=>
   `<tr><td>${n}</td><td>${Object.entries(snap).map(([k,v])=>
     `${k}=${typeof v==="number"?+v.toPrecision(5):v}`).join(" ")}</td></tr>`);
 }catch(e){health.innerHTML='<span class="bad">[unreachable]</span>'}
}
tick();setInterval(tick,2000);
</script></body></html>
"""
