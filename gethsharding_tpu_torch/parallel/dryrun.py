"""The multi-device dry run: the port's twin of the JAX package's
`__graft_entry__.dryrun_multichip`.

`dryrun_multichip(devices)` runs the period step over a mesh of the slots
it is given (distinct cards, or one device repeated): 2n + 1 shards, so
the shard count is uneven and pads; a committee of 4 at quorum 2, with
2-4 voters a shard and one forged vote. With 4 or more slots, and an even
count, the same step runs over the 2-D ``("dcn", "ici")`` mesh (n/2 hosts
× 2), and the config-5 stress step runs on one device, the 1-D mesh and
the 2-D mesh; every layout must give the same outputs bit for bit. The
reference forces a virtual CPU platform in a subprocess first; the port's
slots are explicit, so it needs neither.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.parallel.mesh import (make_mesh,
                                                  make_multihost_mesh)
from gethsharding_tpu_torch.parallel.period import CommitteePeriodPipeline
from gethsharding_tpu_torch.parallel.stress import (StressOutputs,
                                                    StressPipeline,
                                                    build_stress_inputs)
from gethsharding_tpu_torch.params import Config


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(devices: Sequence) -> dict:
    """Run the dry run over `devices`' slots; raises AssertionError on any
    mismatch. Returns what it checked: shards, the totals, the layouts."""
    mesh = make_mesh(devices=devices)
    n_devices = mesh.size
    n_shards = 2 * n_devices + 1
    config = Config(committee_size=4, quorum_size=2)

    keys = [bls.bls_keygen(bytes([i])) for i in range(4)]
    forged = n_shards - 1
    headers, sig_rows, pk_rows, vote_counts = [], [], [], []
    for s in range(n_shards):
        header = b"collation-%d" % s
        n_votes = 2 + (s % 3)
        voters = keys[:n_votes]
        sigs = [bls.bls_sign(header, sk) for sk, _ in voters]
        if s == forged:
            sigs[0] = bls.bls_sign(b"forged", voters[0][0])
        headers.append(header)
        sig_rows.append(sigs)
        pk_rows.append([pk for _, pk in voters])
        vote_counts.append(n_votes)

    pipe = CommitteePeriodPipeline(config=config, mesh=mesh)
    out = pipe.run(pipe.build_inputs(headers, sig_rows, pk_rows))
    verified = out.verified.cpu().tolist()
    approved = out.approved.cpu().tolist()
    _check(len(verified) == n_shards, "verified has the wrong length")
    _check(not verified[forged], "the forged vote passed")
    _check(all(v for i, v in enumerate(verified) if i != forged),
           "an honest shard failed")
    want_approved = [i != forged and vote_counts[i] >= config.quorum_size
                     for i in range(n_shards)]
    _check(approved == want_approved, "approved differs")
    want_votes = sum(c for i, c in enumerate(vote_counts) if i != forged)
    _check(int(out.total_votes) == want_votes, "total_votes differs")
    _check(int(out.total_approved) == sum(want_approved),
           "total_approved differs")
    summary = {"slots": [str(d) for d in mesh.devices], "shards": n_shards,
               "total_votes": int(out.total_votes),
               "total_approved": int(out.total_approved),
               "layouts": ["1-D"]}

    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = make_multihost_mesh(n_hosts=n_devices // 2,
                                    devices_per_host=2, devices=devices)
        pipe2 = CommitteePeriodPipeline(config=config, mesh=mesh2)
        out2 = pipe2.run(pipe2.build_inputs(headers, sig_rows, pk_rows))
        _check(out2.verified.cpu().tolist() == verified,
               "the 2-D mesh's verified differs")
        _check(out2.approved.cpu().tolist() == approved,
               "the 2-D mesh's approved differs")
        _check(int(out2.total_votes) == int(out.total_votes)
               and int(out2.total_approved) == int(out.total_approved),
               "the 2-D mesh's totals differ")
        summary["layouts"].append("2-D")

        # the stress step (config 5) across the three layouts
        inputs, pool, bh, sample_size, _ = build_stress_inputs(
            n_shards, votes_per_shard=2, txs_per_shard=1, committee_size=4,
            device=mesh.devices[0])
        results = [StressPipeline(config, mesh=m).run(
            inputs, pool, bh, 1, sample_size) for m in (None, mesh, mesh2)]
        single = results[0]
        for name, other in zip(("1-D", "2-D"), results[1:]):
            for field in StressOutputs._fields:
                a = getattr(single, field).cpu()
                b = getattr(other, field).cpu()
                _check(torch.equal(a, b),
                       f"the stress step's {field} differs on the {name} "
                       f"mesh")
        summary["stress"] = {"total_votes": int(single.total_votes),
                             "total_txs": int(single.total_txs)}
    return summary
