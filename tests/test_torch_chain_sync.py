"""The port's follower chain (`gethsharding_tpu_torch/smc/sync.py`,
`ChainFollower`) held against the JAX package's, on the CPU: the cases of
the reference's `tests/test_chain_sync.py`, each run in both packages from
the same seeded actions (each package's follower over its own `RPCServer`),
their outcomes compared:

1. the follower replicates the leader's blocks and its SMC state
   (registry, record, votes, watermarks, balances), the whole SMC equal
   field for field (`convert.smc_fields`) to the reference follower's;
2. it follows the leader's reorg (a rollback and a longer branch);
3. an imported chain whose seal the engine rejects never enters the
   follower (the reference's case on its `DevPoWEngine`; the port's
   engine is the fake one, which rejects a forged hash the same way);
4. a checkpoint whose head does not match is refused;
5. a follower chain process (`rpc/chain_server.py --follow`) serves the
   leader process's blocks.

Blocks are sealed by explicit commits; the follower is waited on through
its own state (`_installed_seq`), never a fixed sleep.
"""

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from gethsharding_tpu_torch import convert

REPO = Path(__file__).resolve().parents[1]


def _pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        root=root, accounts=mod("mainchain.accounts"), params=mod("params"),
        server=mod("rpc.server"), chain=mod("smc.chain"),
        engine=mod("smc.engine"), sync=mod("smc.sync"),
        sm=mod("smc.state_machine"), hexbytes=mod("utils.hexbytes"),
        client=mod("rpc.client"))


PORT = _pkg("gethsharding_tpu_torch")
REF = _pkg("gethsharding_tpu")
BOTH = (PORT, REF)


def _pair(pk, config=None):
    config = config or pk.params.Config(shard_count=4, quorum_size=1)
    leader = pk.chain.SimulatedMainchain(config=config)
    server = pk.server.RPCServer(leader, port=0)
    server.start()
    follower_chain = pk.chain.SimulatedMainchain(config=config)
    follower = pk.sync.ChainFollower(follower_chain, *server.address,
                                     poll_interval=0.05)
    return leader, server, follower_chain, follower


def _wait_sync(leader, follower_chain, follower, timeout=30.0):
    """Heads equal and the leader's state checkpoint installed (header
    import and state install are two steps of one sync round)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if (follower_chain.block_number == leader.block_number
                and bytes(follower_chain.blocks[-1].hash)
                == bytes(leader.blocks[-1].hash)
                and follower._installed_seq == leader.state_seq()):
            return True
        time.sleep(0.02)
    return False


def _replicate(pk):
    leader, server, follower_chain, follower = _pair(pk)
    manager = pk.accounts.AccountManager()
    acct = manager.new_account(seed=b"sync-notary")
    try:
        follower.start()
        leader.fund(acct.address, 2000 * pk.params.ETHER)
        leader.register_notary(
            acct.address, bls_pubkey=acct.bls_pubkey,
            bls_pop=manager.bls_proof_of_possession(acct.address))
        leader.fast_forward(1)
        period = leader.current_period()
        root = pk.hexbytes.Hash32(b"\x42" * 32)
        leader.add_header(acct.address, 2, period, root)
        leader.submit_vote(
            acct.address, 2, period, 0, root,
            bls_sig=manager.bls_sign(
                acct.address, bytes(pk.sm.vote_digest(2, period, root))))
        leader.commit()
        assert _wait_sync(leader, follower_chain, follower)
        assert [bytes(b.hash) for b in follower_chain.blocks] == \
            [bytes(b.hash) for b in leader.blocks]
        entry = follower_chain.notary_registry(acct.address)
        assert entry is not None and entry.deposited
        record = follower_chain.collation_record(2, period)
        assert bytes(record.chunk_root) == bytes(root)
        assert record.vote_count == \
            leader.collation_record(2, period).vote_count
        assert follower_chain.last_approved_collation(2) == \
            leader.last_approved_collation(2)
        assert follower_chain.balance_of(acct.address) == \
            leader.balance_of(acct.address)
        return {"blocks": [bytes(b.hash) for b in follower_chain.blocks],
                "smc": convert.smc_fields(follower_chain.smc),
                "balance": follower_chain.balance_of(acct.address),
                "imported": follower.blocks_imported,
                "errors": list(follower.errors)}
    finally:
        follower.stop()
        server.stop()


def test_follower_replicates_chain_and_smc_state_like_reference():
    port, ref = (_replicate(pk) for pk in BOTH)
    assert port == ref
    assert port["errors"] == [] and port["imported"] == 6


def _reorg(pk):
    leader, server, follower_chain, follower = _pair(pk)
    try:
        follower.start()
        for _ in range(6):
            leader.commit()
        assert _wait_sync(leader, follower_chain, follower)
        before = [bytes(b.hash) for b in follower_chain.blocks]
        # dev blocks hash only on (number, parent): roll back and regrow
        # longer, with a state change as the branch's marker
        leader.set_head(3)
        acct = pk.accounts.AccountManager().new_account(seed=b"forker")
        leader.fund(acct.address, 1 * pk.params.ETHER)
        for _ in range(5):
            leader.commit()
        assert _wait_sync(leader, follower_chain, follower)
        return {"before": before,
                "after": [bytes(b.hash) for b in follower_chain.blocks],
                "balance": follower_chain.balance_of(acct.address),
                "head": follower_chain.block_number,
                "errors": list(follower.errors)}
    finally:
        follower.stop()
        server.stop()


def test_follower_tracks_leader_reorg_like_reference():
    port, ref = (_reorg(pk) for pk in BOTH)
    assert port == ref
    assert port["balance"] == 1 * PORT.params.ETHER and port["head"] == 8
    assert port["errors"] == []


@pytest.mark.parametrize("pk", BOTH, ids=["port", "ref"])
def test_follower_rejects_forged_seals_via_engine(pk):
    """Imported headers pass through the consensus engine: a chain whose
    first block's hash is not its seal's never enters, in either package
    (the reference's test on its PoW engine; both have the fake one)."""
    config = pk.params.Config(shard_count=2)
    leader = pk.chain.SimulatedMainchain(config=config)
    forged = pk.chain.Block(number=1, hash=pk.hexbytes.Hash32(b"\x66" * 32),
                            parent_hash=leader.blocks[0].hash, extra=b"")
    follower_chain = pk.chain.SimulatedMainchain(config=config)
    with pytest.raises(pk.engine.InvalidHeader, match="block 1"):
        follower_chain.import_chain([forged, pk.chain.Block(
            number=2, hash=pk.hexbytes.Hash32(b"\x67" * 32),
            parent_hash=pk.hexbytes.Hash32(b"\x66" * 32), extra=b"")])
    assert follower_chain.block_number == 0
    # the leader's own blocks import: the rule, not the import, refused
    for _ in range(2):
        leader.commit()
    assert follower_chain.import_chain(leader.blocks[1:]) == 2


@pytest.mark.parametrize("pk", BOTH, ids=["port", "ref"])
def test_checkpoint_refuses_mismatched_head(pk):
    config = pk.params.Config(shard_count=2)
    leader = pk.chain.SimulatedMainchain(config=config)
    other = pk.chain.SimulatedMainchain(config=config)
    leader.commit()
    assert other.install_checkpoint(leader.state_checkpoint()) is False


def test_follower_over_real_chain_server_process():
    """A follower chain process (--follow) tracks a leader chain process;
    the follower serves the leader's block 4."""
    def start(*extra):
        return subprocess.Popen(
            [sys.executable, "-m", "gethsharding_tpu_torch.rpc.chain_server",
             "--shardcount", "2", "--runtime", "60", "--sigbackend",
             "python", *extra],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    leader_proc, follower_proc = start(), None
    clients = []
    try:
        lead = json.loads(leader_proc.stdout.readline())
        follower_proc = start("--follow", f"{lead['host']}:{lead['port']}")
        fol = json.loads(follower_proc.stdout.readline())
        leader_rpc = PORT.client.RPCClient(lead["host"], lead["port"])
        follower_rpc = PORT.client.RPCClient(fol["host"], fol["port"])
        clients += [leader_rpc, follower_rpc]
        for _ in range(4):
            leader_rpc.call("shard_commit")
        want = leader_rpc.call("shard_blockByNumber", 4)
        deadline = time.time() + 30
        got = None
        while time.time() < deadline:
            if follower_rpc.call("shard_blockNumber") >= 4:
                got = follower_rpc.call("shard_blockByNumber", 4)
                break
            time.sleep(0.1)
        assert got == want, "the follower did not replicate block 4"
    finally:
        for client in clients:
            client.close()
        for proc in (leader_proc, follower_proc):
            if proc is not None:
                proc.terminate()
                out, err = proc.communicate(timeout=30)
                assert "chain-server at exit" in err
