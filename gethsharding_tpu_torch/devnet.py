"""Devnet orchestrator: spin up a whole sharding network as OS processes
(the port's copy of the JAX package's `devnet.py`).

The reference's answer to "give me a running network" is spread over
`cmd/puppeth` (the network wizard), `p2p/simulations/adapters/exec.go`
(ExecAdapter: every simulated node is its own OS process) and the
README's manual recipe (run geth, then N `geth sharding` actors). This
module is that capability: ONE command builds the reference's process
topology — one chain process (`rpc/chain_server.py`), N actor processes
(`cli sharding --endpoint`) dialing it over RPC
(`sharding/mainchain/utils.go:17-22`) — supervises it, and tears it down.

  python -m gethsharding_tpu_torch.cli devnet --notaries 2 --proposers 1 \
      --sigbackend torch --runtime 30

With `--sigbackend torch` the chain process and every actor run the
port's CUDA kernels on the card (several processes, one CUDA context
each); the first of them to need the kernels builds them, under the
build lock of `utils/filelock.py`. Light clients (`--lights`) verify on
the host and launch nothing.

Child crash handling mirrors the service-restart contract
(`node/service.go:78-83`: restart = fresh instance): a crashed actor is
respawned with the same flags (fresh process, same datadir identity),
rate-limited per child; the chain process is the network's backbone and
its death ends the net (matching the relay/introduction role it plays).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

log = logging.getLogger("sharding.devnet")

RESTART_WINDOW_S = 60.0
MAX_RESTARTS_PER_WINDOW = 3


@dataclass
class Child:
    name: str
    argv: List[str]
    proc: subprocess.Popen
    restarts: List[float] = field(default_factory=list)
    given_up: bool = False


def _spawn(name: str, argv: List[str], log_dir: Optional[str]) -> Child:
    out = subprocess.DEVNULL
    if log_dir:
        out = open(os.path.join(log_dir, f"{name}.log"), "ab")
    proc = subprocess.Popen(argv, stdout=out, stderr=out)
    log.info("spawned %s (pid %d)", name, proc.pid)
    return Child(name=name, argv=argv, proc=proc)


class Devnet:
    """One chain process + N actor processes, supervised."""

    def __init__(self, notaries: int = 1, proposers: int = 1,
                 observers: int = 0, lights: int = 0,
                 base_dir: str = "", blocktime: float = 0.5,
                 quorum: Optional[int] = None,
                 shard_count: Optional[int] = None,
                 sigbackend: str = "torch",
                 http_base: int = 0):
        if http_base:
            raise ValueError("--http-base: the port has no "
                             "node/http_status.py yet (ROADMAP.md, queue A "
                             "item 8)")
        self.counts = {"notary": notaries, "proposer": proposers,
                       "observer": observers, "light": lights}
        if not base_dir:
            # identity must survive respawn (the restart contract is
            # "fresh process, SAME identity"): an in-memory actor would
            # re-deposit as a brand-new account on every respawn,
            # leaving dead notaries in the SMC pool to poison committee
            # sampling — so default to a throwaway datadir
            import tempfile

            base_dir = tempfile.mkdtemp(prefix="tpu-sharding-devnet-")
        self.base_dir = base_dir
        self.blocktime = blocktime
        self.quorum = quorum
        self.shard_count = shard_count
        self.sigbackend = sigbackend
        self.http_base = http_base
        self.chain: Optional[Child] = None
        self.actors: Dict[str, Child] = {}
        self.endpoint: Optional[tuple] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> tuple:
        """Spawn the chain process, wait for its address line, then spawn
        every actor against it. Returns (host, port) of the chain RPC."""
        argv = [sys.executable, "-m", "gethsharding_tpu_torch.rpc.chain_server",
                "--blocktime", str(self.blocktime),
                "--sigbackend", self.sigbackend]
        if self.quorum is not None:
            argv += ["--quorum", str(self.quorum)]
        if self.shard_count is not None:
            argv += ["--shardcount", str(self.shard_count)]
        log_dir = self._log_dir()
        chain = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                 stderr=(open(os.path.join(log_dir,
                                                           "chain.log"), "ab")
                                         if log_dir else subprocess.DEVNULL))
        # track the child BEFORE anything can fail, so stop() reaps it
        # even when startup goes sideways (no orphaned port-holder)
        self.chain = Child(name="chain", argv=argv, proc=chain)
        try:
            # a chain process on the card may build the kernels first
            line = self._read_endpoint_line(chain, timeout=600.0)
            addr = json.loads(line)
            self.endpoint = (addr["host"], addr["port"])
        except Exception:
            self.stop()
            raise
        log.info("chain up at %s:%d (pid %d)", *self.endpoint, chain.pid)

        http = self.http_base
        for role, count in self.counts.items():
            for i in range(count):
                name = f"{role}-{i}"
                self.actors[name] = _spawn(
                    name, self._actor_argv(role, i, http), log_dir)
                if http:
                    http += 1
        return self.endpoint

    @staticmethod
    def _read_endpoint_line(chain: subprocess.Popen,
                            timeout: float) -> bytes:
        """The chain's one-line JSON address, with a deadline (a hung
        backend init must not block the orchestrator forever)."""
        import selectors

        sel = selectors.DefaultSelector()
        sel.register(chain.stdout, selectors.EVENT_READ)
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                if sel.select(timeout=0.5):
                    line = chain.stdout.readline()
                    if not line:
                        raise RuntimeError("chain process died before "
                                           "publishing its endpoint")
                    return line
                if chain.poll() is not None:
                    raise RuntimeError(
                        f"chain process exited ({chain.returncode}) "
                        "before publishing its endpoint")
        finally:
            sel.close()
        raise RuntimeError(f"chain endpoint not published in {timeout:.0f}s")

    def _log_dir(self) -> Optional[str]:
        if not self.base_dir:
            return None
        path = os.path.join(self.base_dir, "logs")
        os.makedirs(path, exist_ok=True)
        return path

    def _actor_argv(self, role: str, index: int, http: int) -> List[str]:
        from gethsharding_tpu_torch.params import DEFAULT_CONFIG

        host, port = self.endpoint
        # proposers/observers/lights spread round-robin over the shard
        # space so a --shardcount N net actually services N shards;
        # notaries watch every shard regardless (notary.go scans all)
        n_shards = (self.shard_count if self.shard_count is not None
                    else DEFAULT_CONFIG.shard_count)
        argv = [sys.executable, "-m", "gethsharding_tpu_torch.cli", "sharding",
                "--actor", role, "--endpoint", f"{host}:{port}",
                "--shardid", str(index % n_shards),
                "--sigbackend", self.sigbackend, "--supervise"]
        if role == "notary":
            argv.append("--deposit")
        datadir = os.path.join(self.base_dir, f"{role}-{index}")
        os.makedirs(datadir, exist_ok=True)
        argv += ["--datadir", datadir, "--password", "devnet"]
        if http:
            argv += ["--http", str(http)]
        return argv

    def poll(self) -> dict:
        """One supervision pass: reap crashed actors, respawn within the
        rate limit, report status (the operator's one-line view)."""
        now = time.monotonic()
        status = {"chain_alive": self.chain.proc.poll() is None,
                  "actors": {}}
        log_dir = self._log_dir()
        for name, child in self.actors.items():
            code = child.proc.poll()
            if code is None:
                status["actors"][name] = "running"
                continue
            if code == 0:
                # a clean exit is an operator's deliberate stop, not a
                # crash — leave it down (the restart contract covers
                # failures only)
                status["actors"][name] = "stopped"
                continue
            if child.given_up:
                status["actors"][name] = f"down (exit {code})"
                continue
            child.restarts = [t for t in child.restarts
                              if now - t < RESTART_WINDOW_S]
            if len(child.restarts) >= MAX_RESTARTS_PER_WINDOW:
                child.given_up = True
                status["actors"][name] = f"gave up (exit {code})"
                log.error("%s crashed %d times in %.0fs window: leaving "
                          "it down", name, len(child.restarts),
                          RESTART_WINDOW_S)
                continue
            child.restarts.append(now)
            fresh = _spawn(name, child.argv, log_dir)
            fresh.restarts = child.restarts
            self.actors[name] = fresh
            status["actors"][name] = f"restarted (exit {code})"
        return status

    def stop(self) -> None:
        """SIGTERM every child in three waves, each waited on: the actors
        that fetch bodies (notaries, observers), then the proposers that
        serve them, then the chain. A head in flight finishes against
        peers and a chain that still answer, so a stop is no fetch
        failure and no revert."""
        actors = list(self.actors.values())
        proposers = [c for c in actors if c.name.startswith("proposer-")]
        for group in ([c for c in actors if c not in proposers], proposers,
                      [self.chain] if self.chain else []):
            for child in group:
                if child.proc.poll() is None:
                    child.proc.terminate()
            deadline = time.monotonic() + 20.0
            for child in group:
                remaining = max(0.1, deadline - time.monotonic())
                try:
                    child.proc.wait(timeout=remaining)
                except subprocess.TimeoutExpired:
                    child.proc.kill()
                    child.proc.wait()


def run_devnet(args) -> int:
    try:
        net = Devnet(notaries=args.notaries, proposers=args.proposers,
                     observers=args.observers, lights=args.lights,
                     base_dir=args.datadir, blocktime=args.blocktime,
                     quorum=args.quorum, shard_count=args.shardcount,
                     sigbackend=args.sigbackend, http_base=args.http_base)
    except ValueError as exc:
        print(f"devnet: {exc}", file=sys.stderr)
        return 2
    stop_requested = []
    previous = signal.signal(signal.SIGINT,
                             lambda *_: stop_requested.append(True))
    try:
        try:
            host, port = net.start()
        except RuntimeError as exc:
            # the chain refused to start: with --sigbackend torch on a host
            # with no card it exits 2, as every entry point of the port does
            print(f"devnet: {exc}", file=sys.stderr)
            return 2
        print(json.dumps({"event": "up", "host": host, "port": port,
                          "actors": sum(net.counts.values())}), flush=True)
        deadline = (time.monotonic() + args.runtime if args.runtime
                    else None)
        from gethsharding_tpu_torch.rpc.client import RemoteMainchain

        chain = RemoteMainchain.dial(host, port)
        try:
            while not stop_requested:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                status = net.poll()
                if not status["chain_alive"]:
                    print(json.dumps({"event": "chain_died"}), flush=True)
                    return 1
                try:
                    status["block"] = chain.block_number
                    status["period"] = chain.current_period()
                except Exception:  # noqa: BLE001 - status probe only
                    pass
                status["event"] = "status"
                print(json.dumps(status), flush=True)
                time.sleep(args.interval)
        finally:
            chain.close()
        print(json.dumps({"event": "shutdown"}), flush=True)
        return 0
    finally:
        signal.signal(signal.SIGINT, previous)
        net.stop()
